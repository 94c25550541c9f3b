"""Spectrally accurate scalar solvers on the annular strip.

Solves (helmholtz_k^2 - Lap) u = f on the boundary-fitted annulus with Robin
boundary conditions at both radial edges, using a Chebyshev-tau (radial) x
Fourier (tangential) discretization and preconditioned GMRES.

Reference semantics: ipde/annular/modified_helmholtz.py:90-203 and
ipde/annular/poisson.py.  Redesign for the accelerator:
  * the Krylov iteration runs entirely in REAL space: the matvec is small
    real f64 GEMMs (Chebyshev operators on the left, the spectral tangential
    differentiation circulant on the right) plus elementwise metric products
    -- no complex arithmetic, no FFTs in the hot loop,
  * the preconditioner is the exact inverse of the circle-approximation
    operator: rfft (as f64 matmuls) -> batched (nk, M, M) real inverse apply
    (one einsum) -> irfft; the per-mode inverses are precomputed on
    host with numpy,
  * GMRES is the jitted lax.while_loop implementation in ipde_tpu.ops.gmres.

Residual/unknown layout: u is (M, n) nodal values (row 0 = r=lb side);
residual rows = [PDE rows (M-2) ; lbc row ; ubc row], matching the RHS
[R02 @ f ; g_lb ; g_ub].
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ipde_tpu.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu.ops.cx import Cx
from ipde_tpu.ops.fourier import (TanPlan, make_tan_plan, tan_cast,
                                  tan_deriv, tan_irfft, tan_rfft)
from ipde_tpu.ops.gmres import gmres, gmres_ir

_HIGH = jax.lax.Precision.HIGHEST


def use_annular_mp() -> bool:
    """Mixed-precision annular GMRES (ops/gmres.gmres_ir: f32 inner FGMRES
    cycles + f64 residual replay), on with IPDE_ANNULAR_MP=1.  The default
    is plain f64 GMRES; the solve accuracy is set by the f64 replay either
    way."""
    import os
    return os.environ.get("IPDE_ANNULAR_MP", "").strip() == "1"


def cast_ops_f32(ops):
    """f32 twin of an operator bundle (every f64 leaf cast; the TanPlan
    matrices ride along as pytree leaves)."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if a.dtype == jnp.float64 else a, ops)


class AnnularOps(NamedTuple):
    """Device-side operator bundle (pytree) for the annular scalar solve."""
    D01: jax.Array
    D12: jax.Array
    R01: jax.Array
    R12: jax.Array
    R02: jax.Array
    row_lb: jax.Array      # (1, M) combined Robin row at r=lb
    row_ub: jax.Array      # (1, M) combined Robin row at r=ub
    tan: TanPlan           # last-axis rfft/derivative plan (four-step for
                           # large n: O(n sqrt n) instead of the n^2 matmul)
    Kinv: jax.Array        # (nk, M, M) per-mode preconditioner inverses
    psi1: jax.Array        # (M-1, n) metric
    inv_psi1: jax.Array
    inv_psi2: jax.Array    # (M-2, n)
    helm_k2: jax.Array     # scalar k^2


def _matvec(ops: AnnularOps, u_flat: jax.Array, M: int, n: int) -> jax.Array:
    u = u_flat.reshape(M, n)
    du = jnp.matmul(ops.D01, u, precision=_HIGH)
    term1 = jnp.matmul(ops.D12, ops.psi1 * du, precision=_HIGH)
    ut = tan_deriv(u, ops.tan)
    w = jnp.matmul(ops.R01, ut, precision=_HIGH) * ops.inv_psi1
    term2 = jnp.matmul(ops.R12, tan_deriv(w, ops.tan), precision=_HIGH)
    lu = (term1 + term2) * ops.inv_psi2
    top = ops.helm_k2 * jnp.matmul(ops.R02, u, precision=_HIGH) - lu
    rl = jnp.matmul(ops.row_lb, u, precision=_HIGH)
    ru = jnp.matmul(ops.row_ub, u, precision=_HIGH)
    return jnp.concatenate([top, rl, ru], axis=0).ravel()


def use_f32_precond(tol: float = 0.0) -> bool:
    """IPDE_PRECOND_F32=1 runs the GMRES preconditioner in f32, via FGMRES (an f32 M is not exactly
    linear, so the preconditioned basis must be stored -- ops/gmres.py
    flexible=True).  Accuracy of the CONVERGED solution is unaffected.

    TOLERANCE GATE (r4): each f32 preconditioner application carries
    ~2^-24 relative output noise, so once the target residual sits below
    that floor the per-iteration convergence RATE roughly halves --
    measured on the annular Poisson MMS (nb=400, M=16): identical
    iteration counts at tol=1e-6, then a flat ~+20-iteration overhead
    for every tighter tol (9->28 @ 1e-8, 19->39 @ 1e-14).  The effect is
    UNIFORM in the Helmholtz k (k=0 and k=3 degrade alike; the earlier
    "ill-conditioned k=0 blocks" reading did not survive measurement:
    per-mode condition numbers are ~1.5e7 for every k).  The flag
    therefore auto-falls back to the f64 preconditioner whenever the
    requested tol is tighter than IPDE_PRECOND_F32_MIN_TOL (default
    3e-7), so setting it globally is always safe."""
    import os
    if os.environ.get("IPDE_PRECOND_F32", "") != "1":
        return False
    min_tol = float(os.environ.get("IPDE_PRECOND_F32_MIN_TOL", "3e-7"))
    return float(tol) >= min_tol


def _precond(ops: AnnularOps, r_flat: jax.Array, M: int, n: int,
             f32pc: bool = False) -> jax.Array:
    r = r_flat.reshape(M, n)
    if f32pc:
        tp32 = tan_cast(ops.tan, jnp.float32)
        c = tan_rfft(r.astype(jnp.float32), tp32)
        ore = jnp.einsum('kij,jk->ik', ops.Kinv.astype(jnp.float32), c.re)
        oim = jnp.einsum('kij,jk->ik', ops.Kinv.astype(jnp.float32), c.im)
        out = tan_irfft(Cx(ore, oim), tp32)
        return out.astype(jnp.float64).ravel()
    c = tan_rfft(r, ops.tan)                       # (M, nk)
    ore = jnp.einsum('kij,jk->ik', ops.Kinv, c.re, precision=_HIGH)
    oim = jnp.einsum('kij,jk->ik', ops.Kinv, c.im, precision=_HIGH)
    return tan_irfft(Cx(ore, oim), ops.tan).ravel()


def _run_gmres(ops: AnnularOps, rhs_flat: jax.Array, M: int, n: int,
               maxiter: int, restart: int, tol, f32pc: bool, mp: bool):
    mv = lambda v: _matvec(ops, v, M, n)
    if mp:
        ops32 = cast_ops_f32(ops)
        mv32 = lambda v: _matvec(ops32, v, M, n)
        pc32 = lambda v: _precond(ops32, v, M, n)
        return gmres_ir(mv, rhs_flat, mv32, pc32, tol=tol,
                        maxiter=maxiter, restart=restart)
    pc = lambda v: _precond(ops, v, M, n, f32pc)
    return gmres(mv, rhs_flat, precond=pc, tol=tol, maxiter=maxiter,
                 restart=restart, flexible=f32pc)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 7, 8))
def _solve_jit(ops: AnnularOps, rhs_flat: jax.Array, M: int, n: int,
               maxiter: int, restart: int, tol: jax.Array,
               f32pc: bool = False, mp: bool = False):
    res = _run_gmres(ops, rhs_flat, M, n, maxiter, restart, tol, f32pc, mp)
    return res.x.reshape(M, n), res.iterations, res.residual


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 7, 8))
def _solve_jit_batched(ops_stacked: AnnularOps, rhs_stacked: jax.Array,
                       M: int, n: int, maxiter: int, restart: int,
                       tol: jax.Array, f32pc: bool = False,
                       mp: bool = False):
    """vmapped GMRES over the BOUNDARY axis: one dispatch for B same-shape
    annular solves (SURVEY.md 2.3(b): the per-mode/boundary axes are
    embarrassingly batched).  ops leaves carry a leading B axis."""

    def one(ops, rhs):
        res = _run_gmres(ops, rhs, M, n, maxiter, restart, tol, f32pc, mp)
        return res.x.reshape(M, n), res.iterations, res.residual

    return jax.vmap(one)(ops_stacked, rhs_stacked)


def shard_boundary_axis(mesh, tree, axis: str = "p"):
    """Shard the leading (boundary) axis of every leaf of `tree` over the
    mesh (SURVEY.md 2.3(b): per-boundary annular GMRES distributed over
    ICI).  B is padded to a multiple of the device count by repeating the
    first boundary; callers slice outputs back to B rows.  Returns
    (sharded_tree, padded_B).  No-op (tree, B) without a mesh."""
    leaves = jax.tree_util.tree_leaves(tree)
    B = leaves[0].shape[0]
    if mesh is None:
        return tree, B
    nd = mesh.devices.size
    pad = (-B) % nd
    from jax.sharding import NamedSharding, PartitionSpec

    def put(x):
        if pad:
            x = jnp.concatenate([x] + [x[:1]] * pad, axis=0)
        spec = PartitionSpec(*([axis] + [None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree), B + pad


def batched_annular_solve(solvers, metrics, rhss, tol, maxiter, restart,
                          mesh=None):
    """Solve B same-shape annular problems in ONE device dispatch.

    solvers/metrics are per-boundary; rhss is a list of (M, n) right-hand
    sides ALREADY in residual layout (R02 @ f rows + BC rows).  Returns
    (list of (M, n) solutions, stats dict with per-boundary iterations).
    With a mesh, the boundary axis is sharded over its devices (one lane
    group per device; the vmapped while_loop's convergence test is the
    only cross-device collective).
    """
    ops_list = [s.make_ops(m) for s, m in zip(solvers, metrics)]
    ops_stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ops_list)
    rhs_stacked = jnp.stack([r.ravel() for r in rhss])
    ops_stacked, _ = shard_boundary_axis(mesh, ops_stacked)
    rhs_stacked, _ = shard_boundary_axis(mesh, rhs_stacked)
    M, n = solvers[0].M, solvers[0].n
    u, iters, resid = _solve_jit_batched(ops_stacked, rhs_stacked, M, n,
                                         maxiter, restart, jnp.asarray(tol),
                                         use_f32_precond(tol),
                                         use_annular_mp())
    us = [u[i] for i in range(len(solvers))]
    return us, {"iterations": iters[:len(solvers)],
                "residual": resid[:len(solvers)]}


class AnnularScalarSolver:
    """(k^2 - Lap) u = f on the annulus, Robin BCs at r=lb and r=ub.

    BC convention:  la*u + lb_c*u_r = g_lb at r=lb;  ua*u + ub_c*u_r = g_ub
    at r=ub (u_r is the derivative along the generating curve's outward
    normal, i.e. d/dr of the radial coordinate).
    """

    def __init__(self, geom: AnnularGeometry, helmholtz_k: float = 0.0,
                 la: float = 1.0, lb_c: float = 0.0,
                 ua: float = 1.0, ub_c: float = 0.0):
        self.geom = geom
        self.helmholtz_k = helmholtz_k
        CO = geom.CO
        M, n, nk = geom.M, geom.n, geom.nk
        self.M, self.n = M, n
        row_lb = la * CO.obc_dirichlet + lb_c * CO.obc_neumann  # x=-1 <-> r=lb
        row_ub = ua * CO.ibc_dirichlet + ub_c * CO.ibc_neumann  # x=+1 <-> r=ub
        # --- per-mode preconditioner (circle approximation), host numpy -----
        apsi1 = geom.approx_psi1
        iapsi1 = 1.0 / apsi1
        iapsi2 = 1.0 / geom.approx_psi2
        D01, D12, R01, R12, R02 = CO.D01, CO.D12, CO.R01, CO.R12, CO.R02
        base_rr = iapsi2[:, None] * (D12 @ (apsi1[:, None] * D01))
        base_tt = iapsi2[:, None] * (R12 @ (iapsi1[:, None] * R01))
        k2 = helmholtz_k**2
        Kinv = np.empty((nk, M, M))
        for m in range(nk):
            K = np.empty((M, M))
            K[: M - 2] = k2 * R02 - (base_rr - (m * m) * base_tt)
            K[M - 2] = row_lb[0]
            K[M - 1] = row_ub[0]
            Kinv[m] = np.linalg.inv(K)
        f64 = jnp.asarray
        self.ops_static = dict(
            D01=f64(D01), D12=f64(D12), R01=f64(R01), R12=f64(R12),
            R02=f64(R02), row_lb=f64(row_lb), row_ub=f64(row_ub),
            tan=make_tan_plan(n), Kinv=f64(Kinv), helm_k2=jnp.asarray(k2),
        )
        self.R02_np = R02
        self.iterations_last_call = 0

    def make_ops(self, metric: AnnularMetric) -> AnnularOps:
        """Device operator bundle for this (solver, metric) pair, cached on
        the metric so repeated solves (and planified jit traces) reuse ONE
        set of concrete device arrays instead of re-embedding constants."""
        cache = metric.__dict__.setdefault("_annular_ops_cache", {})
        ops = cache.get(id(self))
        if ops is None:
            ops = AnnularOps(
                psi1=jnp.asarray(metric.psi1),
                inv_psi1=jnp.asarray(metric.inv_psi1),
                inv_psi2=jnp.asarray(metric.inv_psi2),
                **self.ops_static,
            )
            cache[id(self)] = ops
        return ops

    def solve(self, metric: AnnularMetric, f, g_lb, g_ub, tol: float = 1e-14,
              maxiter: int = 200, restart: int = 40, verbose: bool = False):
        """Solve; f is (M, n) (numpy or jnp), g_lb/g_ub are (n,) BC data."""
        u, stats = self.solve_with_stats(metric, f, g_lb, g_ub, tol=tol,
                                         maxiter=maxiter, restart=restart,
                                         verbose=verbose)
        return u

    def build_rhs(self, f, g_lb, g_ub):
        """Residual-layout right-hand side: [R02 @ f ; g_lb ; g_ub]."""
        top = jnp.matmul(self.ops_static["R02"], jnp.asarray(f),
                         precision=_HIGH)
        return jnp.concatenate(
            [top, jnp.asarray(g_lb)[None], jnp.asarray(g_ub)[None]], axis=0)

    def solve_with_stats(self, metric: AnnularMetric, f, g_lb, g_ub,
                         tol: float = 1e-14, maxiter: int = 200,
                         restart: int = 40, verbose: bool = False):
        """Like solve, also returning {'iterations', 'residual'} as device
        scalars (jit-safe: nothing is host-synced here)."""
        ops = self.make_ops(metric)
        rhs = self.build_rhs(f, g_lb, g_ub)
        u, iters, resid = _solve_jit(ops, rhs.ravel(), self.M, self.n,
                                     maxiter, restart, jnp.asarray(tol),
                                     use_f32_precond(tol), use_annular_mp())
        if not isinstance(iters, jax.core.Tracer):
            self.iterations_last_call = int(iters)
            if verbose:
                print(f"annular GMRES: {int(iters)} iters, "
                      f"resid {float(resid):.2e}")
        return u, {"iterations": iters, "residual": resid}


class AnnularModifiedHelmholtzSolver(AnnularScalarSolver):
    """(k^2 - Lap) u = f (reference: ipde/annular/modified_helmholtz.py:90)."""

    def __init__(self, geom: AnnularGeometry, k: float, **bc):
        super().__init__(geom, helmholtz_k=k, **bc)


class AnnularPoissonSolver(AnnularScalarSolver):
    """Lap u = f (reference: ipde/annular/poisson.py:3-21); note the reference
    solves (0 - Lap) u = -f, i.e. negates f; we do the same so 'solve' takes
    the PDE right-hand side of Lap u = f directly."""

    def __init__(self, geom: AnnularGeometry, **bc):
        super().__init__(geom, helmholtz_k=0.0, **bc)

    def build_rhs(self, f, g_lb, g_ub):
        # every entry point (solve, solve_with_stats, the batched path)
        # builds the RHS here, so the sign flip happens exactly once
        return super().build_rhs(-jnp.asarray(f), g_lb, g_ub)
