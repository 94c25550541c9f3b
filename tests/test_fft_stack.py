"""Batched (stacked-column) 2D transform paths: rfft2_stack /
irfft2_real_corner_stack must equal the per-field transforms exactly.
CPU defaults to the native jnp.fft path, so the matmul/four-step batched
code is exercised here with native=False explicitly."""

import os

import numpy as np
import pytest

from ipde_tpu.ops.cx import Cx
from ipde_tpu.ops.fourier import FourierPlan2D


@pytest.fixture(autouse=True)
def _enable_stack(monkeypatch):
    # the stacked paths are gated off by default; they stay
    # correctness-tested here
    monkeypatch.setenv("IPDE_FFT_STACK", "1")


def test_rfft2_stack_matches_single():
    rng = np.random.default_rng(0)
    nx, ny = 320, 352           # four-step sizes
    plan = FourierPlan2D(nx, ny, native=False)
    xs = [np.asarray(rng.standard_normal((200, 171))) for _ in range(2)]
    singles = [plan.rfft2(x) for x in xs]
    stacked = plan.rfft2_stack(list(xs))
    for s, t in zip(singles, stacked):
        assert np.abs(np.asarray(s.re) - np.asarray(t.re)).max() < 1e-12
        assert np.abs(np.asarray(s.im) - np.asarray(t.im)).max() < 1e-12


def test_irfft2_corner_stack_matches_single():
    rng = np.random.default_rng(1)
    nx, ny = 320, 352
    plan = FourierPlan2D(nx, ny, native=False)
    nk = nx // 2 + 1
    cs = []
    for _ in range(3):
        f = rng.standard_normal((nx, ny))
        z = np.fft.fft(np.fft.rfft(f, axis=0), axis=1)
        cs.append(Cx(np.asarray(z.real), np.asarray(z.imag)))
    nx_out, ny_out, nx0, ny0 = 150, 160, 17, 23
    singles = [plan.irfft2_real_corner(c, nx_out, ny_out, nx0, ny0)
               for c in cs]
    stacked = plan.irfft2_real_corner_stack(cs, nx_out, ny_out, nx0, ny0)
    for s, t in zip(singles, stacked):
        assert np.abs(np.asarray(s) - np.asarray(t)).max() < 1e-12


def test_direct_plan_stack():
    """Small (DirectDFT1D) axis sizes take the same batched code path."""
    rng = np.random.default_rng(2)
    nx, ny = 48, 40
    plan = FourierPlan2D(nx, ny, native=False)
    xs = [np.asarray(rng.standard_normal((nx, ny))) for _ in range(3)]
    singles = [plan.rfft2(x) for x in xs]
    stacked = plan.rfft2_stack(list(xs))
    for s, t in zip(singles, stacked):
        assert np.abs(np.asarray(s.re) - np.asarray(t.re)).max() < 1e-12
        assert np.abs(np.asarray(s.im) - np.asarray(t.im)).max() < 1e-12


def test_fft2_and_ifft2_real_stack():
    rng = np.random.default_rng(3)
    nx, ny = 320, 352
    plan = FourierPlan2D(nx, ny, native=False)
    xs = [np.asarray(rng.standard_normal((nx, ny))) for _ in range(3)]
    singles = [plan.fft2(x) for x in xs]
    stacked = plan.fft2_stack(list(xs))
    for s, t in zip(singles, stacked):
        assert np.abs(np.asarray(s.re) - np.asarray(t.re)).max() < 1e-11
        assert np.abs(np.asarray(s.im) - np.asarray(t.im)).max() < 1e-11
    invs = plan.ifft2_real_stack(stacked)
    for x, xi in zip(xs, invs):
        assert np.abs(np.asarray(xi) - x).max() < 1e-12
