"""The four dense layer-potential applies against a plain double loop.

Shapes are odd on purpose: T is not a multiple of the target chunk, and
with a small chunk cap the applies run over several padded chunks."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import k0

from ipde_tpu.ops import kernels
from ipde_tpu.ops import stokes_kernels as sk

MH_K = 7.0


def _loop(kernel, sx, sy, tx, ty, *charges):
    """out[c][i] = sum_j kernel(dx, dy)[c] . charges at (i, j), one pair
    at a time."""
    n_out = len(kernel(1.0, 1.0, *[0.0] * len(charges)))
    out = np.zeros((n_out, tx.size))
    for i in range(tx.size):
        for j in range(sx.size):
            vals = kernel(tx[i] - sx[j], ty[i] - sy[j],
                          *[c[j] for c in charges])
            for c, v in enumerate(vals):
                out[c, i] += v
    return out


def _laplace(dx, dy, q):
    return (-math.log(dx * dx + dy * dy) / (4 * math.pi) * q,)


def _laplace_grad(dx, dy, q):
    r2 = dx * dx + dy * dy
    return (-dx / r2 / (2 * math.pi) * q, -dy / r2 / (2 * math.pi) * q)


def _mh(dx, dy, q):
    return (float(k0(MH_K * math.hypot(dx, dy))) / (2 * math.pi) * q,)


def _stokes(dx, dy, fx, fy):
    r2 = dx * dx + dy * dy
    ilr = -0.5 * math.log(r2)
    return (((ilr + dx * dx / r2) * fx + dx * dy / r2 * fy) / (4 * math.pi),
            (dx * dy / r2 * fx + (ilr + dy * dy / r2) * fy) / (4 * math.pi),
            (dx / r2 * fx + dy / r2 * fy) / (2 * math.pi))


APPLIES = {
    "laplace": (lambda s, q, t: kernels.laplace_slp_apply(*s, q[0], *t),
                _laplace, 1),
    "laplace_grad": (lambda s, q, t: kernels.laplace_slp_grad_apply(
        *s, q[0], *t), _laplace_grad, 1),
    "mh": (lambda s, q, t: kernels.mh_slp_apply(*s, q[0], *t, MH_K),
           _mh, 1),
    "stokes": (lambda s, q, t: sk.stokes_slp_apply(*s, q[0], q[1], *t),
               _stokes, 2),
}


@pytest.mark.parametrize("kind", sorted(APPLIES))
@pytest.mark.parametrize("T, S, chunk_cap", [(257, 31, None),
                                             (601, 45, 256)])
def test_dense_apply_matches_double_loop(kind, T, S, chunk_cap,
                                         monkeypatch):
    if chunk_cap is not None:
        monkeypatch.setattr(kernels, "_CHUNK", chunk_cap)
        assert -(-T // kernels._chunk_size(T, S)) > 1
    rng = np.random.default_rng(T + S)
    th = rng.uniform(0, 2 * np.pi, S)
    sx, sy = 1.4 * np.cos(th), 1.4 * np.sin(th)
    tx, ty = rng.uniform(-0.9, 0.9, (2, T))
    apply, kernel, n_charges = APPLIES[kind]
    charges = [rng.standard_normal(S) for _ in range(n_charges)]
    got = apply([jnp.asarray(sx), jnp.asarray(sy)],
                [jnp.asarray(c) for c in charges],
                [jnp.asarray(tx), jnp.asarray(ty)])
    got = [np.asarray(g) for g in jax.tree_util.tree_leaves(got)]
    want = _loop(kernel, sx, sy, tx, ty, *charges)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (T,)
        assert np.abs(g - w).max() <= 1e-13 * max(1.0, np.abs(w).max())
