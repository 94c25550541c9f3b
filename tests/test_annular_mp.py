"""Mixed-precision annular GMRES (IPDE_ANNULAR_MP=1, ops/gmres.gmres_ir):
f32 inner FGMRES cycles + f64 residual replay must reproduce the all-f64
solve to the requested tolerance, with an HONEST (recomputed) residual.

The default is plain f64 GMRES; these tests force the mixed path on,
pinning the refinement logic.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ipde_tpu.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu.geometry.curve import star
from ipde_tpu.solvers.annular_scalar import (AnnularModifiedHelmholtzSolver,
                                             use_annular_mp)
from ipde_tpu.solvers.annular_stokes import AnnularStokesSolver


def _geometry(nb=128, M=12):
    bdy = star(nb, a=0.15, f=3)
    geom = AnnularGeometry(nb, M, -0.25, 0.0, 1.0)
    metric = AnnularMetric(bdy.speed, bdy.curvature, geom)
    return bdy, geom, metric


def test_mp_flag_gate(monkeypatch):
    # the default names no platform: f64 GMRES unless asked for
    monkeypatch.delenv("IPDE_ANNULAR_MP", raising=False)
    assert not use_annular_mp()
    monkeypatch.setattr("jax.default_backend", lambda: "gpu")
    assert not use_annular_mp()
    monkeypatch.setenv("IPDE_ANNULAR_MP", "1")
    assert use_annular_mp()
    monkeypatch.setenv("IPDE_ANNULAR_MP", "0")
    assert not use_annular_mp()


def test_gmres_ir_dense_matches_direct():
    from ipde_tpu.ops.gmres import gmres_ir
    rng = np.random.default_rng(0)
    n = 120
    A = np.eye(n) * 4.0 + 0.1 * rng.standard_normal((n, n))
    Md = np.diag(1.0 / np.diag(A))
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    A32 = jnp.asarray(A, jnp.float32)
    M32 = jnp.asarray(Md, jnp.float32)
    res = gmres_ir(lambda v: Aj @ v, jnp.asarray(b),
                   lambda v: A32 @ v, lambda v: M32 @ v,
                   tol=1e-13, maxiter=200, restart=25)
    x = np.linalg.solve(A, b)
    assert np.abs(np.asarray(res.x) - x).max() < 1e-11
    # honest residual: recomputed in f64 on the final x
    r = b - A @ np.asarray(res.x)
    assert abs(float(res.residual)
               - np.linalg.norm(r) / np.linalg.norm(b)) < 1e-14


def test_scalar_mp_matches_f64(monkeypatch):
    bdy, geom, metric = _geometry()
    rng = np.random.default_rng(0)
    f = rng.standard_normal((geom.M, geom.n))
    g1 = rng.standard_normal(geom.n)
    g2 = rng.standard_normal(geom.n)

    monkeypatch.setenv("IPDE_ANNULAR_MP", "0")
    s64 = AnnularModifiedHelmholtzSolver(geom, k=2.0)
    u64, st64 = s64.solve_with_stats(metric, f, g1, g2, tol=1e-12)
    monkeypatch.setenv("IPDE_ANNULAR_MP", "1")
    smp = AnnularModifiedHelmholtzSolver(geom, k=2.0)
    ump, stmp = smp.solve_with_stats(metric, f, g1, g2, tol=1e-12)
    scale = np.abs(np.asarray(u64)).max()
    du = np.abs(np.asarray(u64) - np.asarray(ump)).max()
    assert du / scale < 1e-10, du / scale
    assert float(stmp["residual"]) < 1e-11, float(stmp["residual"])


def test_stokes_mp_matches_f64(monkeypatch):
    bdy, geom, metric = _geometry(nb=96, M=10)
    rng = np.random.default_rng(1)
    fr = rng.standard_normal((geom.M, geom.n))
    ft = rng.standard_normal((geom.M, geom.n))
    zb = np.zeros(geom.n)

    monkeypatch.setenv("IPDE_ANNULAR_MP", "0")
    s64 = AnnularStokesSolver(geom)
    (ur0, ut0, p0), _ = s64.solve_with_stats(
        metric, fr, ft, zb, zb, zb, zb, tol=1e-11)
    monkeypatch.setenv("IPDE_ANNULAR_MP", "1")
    smp = AnnularStokesSolver(geom)
    (ur1, ut1, p1), stmp = smp.solve_with_stats(
        metric, fr, ft, zb, zb, zb, zb, tol=1e-11)
    scale = np.abs(np.asarray(ur0)).max() + np.abs(np.asarray(ut0)).max()
    du = max(np.abs(np.asarray(ur0) - np.asarray(ur1)).max(),
             np.abs(np.asarray(ut0) - np.asarray(ut1)).max())
    assert du / scale < 1e-9, du / scale
    assert float(stmp["residual"]) < 1e-10, float(stmp["residual"])
