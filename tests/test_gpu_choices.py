"""Choices that depend on the device, checked on the CPU: native FFT by
capability (and the matmul DFT still forced under a mesh), the matmul
precision, and the inside/outside test without optional packages."""

import sys

import jax
import jax.numpy as jnp
import numpy as np


def test_native_fft_selected_on_gpu_backend(monkeypatch):
    from ipde_tpu.ops.fourier import FourierPlan2D
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert FourierPlan2D(24, 34).native
    monkeypatch.setattr(jax, "default_backend", lambda: "other")
    assert not FourierPlan2D(24, 34).native


def test_mesh_forces_matmul_dft():
    from ipde_tpu.ops.fourier import FourierPlan2D
    from ipde_tpu.parallel.sharded import make_mesh
    plan = FourierPlan2D(32, 40)
    assert plan.native
    plan.use_mesh(make_mesh(4))
    assert not plan.native
    rng = np.random.default_rng(0)
    f = rng.standard_normal((32, 40))
    sym = rng.uniform(0.5, 1.0, (32, 40))
    got = np.asarray(plan.solve_symbol(jnp.asarray(f), jnp.asarray(sym)))
    want = np.fft.ifft2(np.fft.fft2(f) * sym).real
    assert np.abs(got - want).max() < 1e-13
    plan.use_mesh(None)
    assert plan.native


def test_highest_matmul_precision_is_default():
    import ipde_tpu  # noqa: F401
    assert jax.config.jax_default_matmul_precision == "highest"
    assert jax.config.jax_enable_x64


def test_points_inside_curve_matches_crossing_count(monkeypatch):
    # an optional plotting package must not be needed (or used)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.path", None)
    from ipde_tpu.geometry.coords import points_inside_curve
    from ipde_tpu.geometry.curve import star
    bdy = star(96, a=0.2, f=5)
    rng = np.random.default_rng(2)
    px, py = rng.uniform(-1.4, 1.4, (2, 3000))
    py[:40] = py[40:80]              # repeated ordinates (sort ties)
    got = points_inside_curve(bdy, px, py)
    ups = bdy.resampled(max(4 * bdy.N, 512))
    xs, ys = ups.x, ups.y
    xe, ye = np.roll(xs, -1), np.roll(ys, -1)
    want = np.zeros(px.size, bool)
    for i in range(px.size):
        for e in range(xs.size):
            if (ys[e] <= py[i]) != (ye[e] <= py[i]):
                x = xs[e] + (py[i] - ys[e]) / (ye[e] - ys[e]) * (xe[e] - xs[e])
                want[i] ^= x > px[i]
    np.testing.assert_array_equal(got, want)
    # the signed coordinate decides near the curve
    near = np.zeros(px.size, bool)
    near[:5] = True
    r = np.where(got, 1.0, -1.0)
    flipped = points_inside_curve(bdy, px, py, near=near, r=r)
    np.testing.assert_array_equal(flipped[:5], ~got[:5])
    np.testing.assert_array_equal(flipped[5:], got[5:])
