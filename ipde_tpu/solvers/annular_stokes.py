"""Spectrally accurate Stokes solver on the annular strip.

Solves  -mu lap(u) + grad p = f,  div u = 0  in the boundary-fitted annulus,
velocity (Dirichlet) BCs at both radial edges, unknowns in (r, t) components:
u = ur e_r + ut e_t, pressure on the M-1 Chebyshev grid.

Discretization matches the reference's Chebyshev-tau x Fourier scheme
(reference: ipde/annular/stokes.py:75-541) re-expressed in REAL space:
the GMRES matvec is small f64 GEMMs (Chebyshev operators left, spectral
tangential differentiation right) + elementwise metric products; the
preconditioner is the exact per-Fourier-mode inverse of the circle
approximation (complex (nk, 3M-1, 3M-1) blocks, host-precomputed, applied as
batched einsums on (re, im) pairs).

Vector-Laplacian metric terms for coordinates x = c(t) + r n(t) with
psi = s(1+r kappa), h_r = 1, h_t = psi:
  (lap u)_r = lap(ur) - ur (d_r psi)^2/psi^2 - (2/psi^2) d_r(psi) d_t(ut)
              - (d_t(d_r psi)/psi^3 terms)    [cross term: see reference
              RealAnnularGeometry:87-108 'these are what work']
with d_r psi = s kappa (independent of r).

Unknown vector layout (flat): [ur (M, n) ; ut (M, n) ; p (M-1, n)].
Residual layout: [ur-eq (M-2) ; ur BCs (2) ; ut-eq (M-2) ; ut BCs (2) ;
div-eq (M-1, with the pressure-mean pin added)].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ipde_tpu.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu.ops.cx import Cx
from ipde_tpu.ops.fourier import (TanPlan, make_tan_plan, tan_cast,
                                  tan_deriv, tan_irfft, tan_rfft)
from ipde_tpu.ops.gmres import gmres

_HIGH = jax.lax.Precision.HIGHEST


class StokesOps(NamedTuple):
    D01: jax.Array
    D12: jax.Array
    R01: jax.Array
    R12: jax.Array
    R02: jax.Array
    row_lb: jax.Array
    row_ub: jax.Array
    VI1_row0: jax.Array     # (1, M-1): extracts the 0th Chebyshev coeff
    tan: TanPlan            # last-axis rfft/derivative plan
    Kinv_re: jax.Array      # (nk, 3M-1, 3M-1)
    Kinv_im: jax.Array
    psi0: jax.Array         # (M, n)
    psi1: jax.Array
    inv_psi1: jax.Array
    inv_psi2: jax.Array
    combo1: jax.Array       # 2 dr_psi / psi2^2   (M-2, n)
    combo2: jax.Array       # dr_psi^2 / psi2^2
    cross: jax.Array        # dt_curvature / (s (1+r kappa)^3)  (M-2, n)
    mu: jax.Array


def _matvec(ops: StokesOps, v, M: int, n: int):
    NU = M * n
    ur = v[:NU].reshape(M, n)
    ut = v[NU:2 * NU].reshape(M, n)
    p = v[2 * NU:].reshape(M - 1, n)
    mm = lambda a, b: jnp.matmul(a, b, precision=_HIGH)
    # round 1: one batched transform for (ur, ut, p) tangential derivatives
    d_all = tan_deriv(jnp.concatenate([ur, ut, p], axis=0), ops.tan)
    dur = d_all[:M]
    dut = d_all[M:2 * M]
    dp = d_all[2 * M:]
    # round 2: one batched transform for the two Laplacian inner derivatives
    w_r = mm(ops.R01, dur) * ops.inv_psi1
    w_t = mm(ops.R01, dut) * ops.inv_psi1
    dw = tan_deriv(jnp.concatenate([w_r, w_t], axis=0), ops.tan)
    Mm1 = M - 1

    def scalar_lap(u, dwk):
        t1 = mm(ops.D12, ops.psi1 * mm(ops.D01, u))
        t2 = mm(ops.R12, dwk)
        return (t1 + t2) * ops.inv_psi2

    lap_ur = scalar_lap(ur, dw[:Mm1])
    lap_ut = scalar_lap(ut, dw[Mm1:])
    W1r = mm(ops.R02, ur)
    W1t = mm(ops.R02, ut)
    # ur equation
    fr = (ops.mu * (-lap_ur + mm(ops.R02, dut) * ops.combo1
                    + W1r * ops.combo2 + W1t * ops.cross)
          + mm(ops.D12, p))
    # ut equation
    ft = (ops.mu * (-lap_ut - mm(ops.R02, dur) * ops.combo1
                    + W1t * ops.combo2 - W1r * ops.cross)
          + mm(ops.R12, dp) * ops.inv_psi2)
    # divergence equation
    fp = (mm(ops.D01, ur * ops.psi0)
          + mm(ops.R01, dut)) * ops.inv_psi1
    # pressure pins: the mean (mode 0) AND the tangential Nyquist mode of
    # the constant-in-r pressure are invisible to D12/Dt (Dt zeroes the
    # Nyquist derivative) -- pin both so the system is nonsingular
    pin = jnp.mean(jnp.matmul(ops.VI1_row0, p, precision=_HIGH))
    fp = fp + pin
    # alt's dtype must FOLLOW the data: a f64 literal here silently
    # promotes the whole f32 inner matvec of the mixed-precision path
    # back to f64
    alt = (1 - 2 * (jnp.arange(n) % 2)).astype(p.dtype)
    pin2 = jnp.mean(jnp.matmul(ops.VI1_row0, p * alt, precision=_HIGH))
    fp = fp + pin2 * alt
    # BC rows
    r_bcs = jnp.concatenate([jnp.matmul(ops.row_lb, ur, precision=_HIGH),
                             jnp.matmul(ops.row_ub, ur, precision=_HIGH)], 0)
    t_bcs = jnp.concatenate([jnp.matmul(ops.row_lb, ut, precision=_HIGH),
                             jnp.matmul(ops.row_ub, ut, precision=_HIGH)], 0)
    return jnp.concatenate([fr.ravel(), r_bcs.ravel(),
                            ft.ravel(), t_bcs.ravel(), fp.ravel()])


def _precond(ops: StokesOps, v, M: int, n: int, f32pc: bool = False):
    NU = M * n
    fr = v[:NU].reshape(M, n)
    ft_ = v[NU:2 * NU].reshape(M, n)
    fp = v[2 * NU:].reshape(M - 1, n)
    stacked = jnp.concatenate([fr, ft_, fp], axis=0)   # (3M-1, n)
    if f32pc:
        # f32 preconditioner: valid for right preconditioning (see
        # annular_scalar.use_f32_precond)
        tp32 = tan_cast(ops.tan, jnp.float32)
        c = tan_rfft(stacked.astype(jnp.float32), tp32)
        kre = ops.Kinv_re.astype(jnp.float32)
        kim = ops.Kinv_im.astype(jnp.float32)
        ore = (jnp.einsum("kij,jk->ik", kre, c.re)
               - jnp.einsum("kij,jk->ik", kim, c.im))
        oim = (jnp.einsum("kij,jk->ik", kre, c.im)
               + jnp.einsum("kij,jk->ik", kim, c.re))
        out = tan_irfft(Cx(ore, oim), tp32).astype(jnp.float64)
        return jnp.concatenate([out[:M].ravel(), out[M:2 * M].ravel(),
                                out[2 * M:].ravel()])
    c = tan_rfft(stacked, ops.tan)                     # (3M-1, nk)
    # out = Kinv @ c per mode (complex multiply)
    ore = (jnp.einsum("kij,jk->ik", ops.Kinv_re, c.re, precision=_HIGH)
           - jnp.einsum("kij,jk->ik", ops.Kinv_im, c.im, precision=_HIGH))
    oim = (jnp.einsum("kij,jk->ik", ops.Kinv_re, c.im, precision=_HIGH)
           + jnp.einsum("kij,jk->ik", ops.Kinv_im, c.re, precision=_HIGH))
    out = tan_irfft(Cx(ore, oim), ops.tan)
    return jnp.concatenate([out[:M].ravel(), out[M:2 * M].ravel(),
                            out[2 * M:].ravel()])


def _run_gmres(ops: StokesOps, rhs, M: int, n: int, maxiter: int,
               restart: int, tol, f32pc: bool, mp: bool):
    from ipde_tpu.solvers.annular_scalar import cast_ops_f32
    from ipde_tpu.ops.gmres import gmres_ir
    mv = lambda v: _matvec(ops, v, M, n)
    if mp:
        ops32 = cast_ops_f32(ops)
        mv32 = lambda v: _matvec(ops32, v, M, n)
        pc32 = lambda v: _precond(ops32, v, M, n)
        return gmres_ir(mv, rhs, mv32, pc32, tol=tol, maxiter=maxiter,
                        restart=restart)
    pc = lambda v: _precond(ops, v, M, n, f32pc)
    return gmres(mv, rhs, precond=pc, tol=tol, maxiter=maxiter,
                 restart=restart, flexible=f32pc)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 7, 8))
def _solve_jit(ops: StokesOps, rhs, M: int, n: int, maxiter: int,
               restart: int, tol, f32pc: bool = False, mp: bool = False):
    res = _run_gmres(ops, rhs, M, n, maxiter, restart, tol, f32pc, mp)
    NU = M * n
    x = res.x
    return (x[:NU].reshape(M, n), x[NU:2 * NU].reshape(M, n),
            x[2 * NU:].reshape(M - 1, n), res.iterations, res.residual)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 7, 8))
def _solve_jit_batched(ops_stacked: StokesOps, rhs_stacked, M: int, n: int,
                       maxiter: int, restart: int, tol, f32pc: bool = False,
                       mp: bool = False):
    """vmapped Stokes GMRES over the BOUNDARY axis (SURVEY.md 2.3(b)): one
    dispatch for B same-shape annular Stokes solves; ops leaves carry a
    leading B axis."""

    def one(ops, rhs):
        res = _run_gmres(ops, rhs, M, n, maxiter, restart, tol, f32pc, mp)
        NU = M * n
        x = res.x
        return (x[:NU].reshape(M, n), x[NU:2 * NU].reshape(M, n),
                x[2 * NU:].reshape(M - 1, n), res.iterations, res.residual)

    return jax.vmap(one)(ops_stacked, rhs_stacked)


def batched_stokes_solve(solvers, metrics, rhss, tol, maxiter, restart,
                         mesh=None):
    """Solve B same-shape annular Stokes problems in ONE device dispatch.

    rhss: list of flat RHS vectors from AnnularStokesSolver.build_rhs.
    Returns (list of (ur, ut, p_full) triples, stats dict).  With a mesh,
    the boundary axis is sharded over its devices (SURVEY.md 2.3(b))."""
    ops_list = [s.make_ops(m) for s, m in zip(solvers, metrics)]
    ops_stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ops_list)
    rhs_stacked = jnp.stack(rhss)
    from ipde_tpu.solvers.annular_scalar import (shard_boundary_axis,
                                                 use_annular_mp,
                                                 use_f32_precond)
    ops_stacked, _ = shard_boundary_axis(mesh, ops_stacked)
    rhs_stacked, _ = shard_boundary_axis(mesh, rhs_stacked)
    M, n = solvers[0].M, solvers[0].n
    ur, ut, p, iters, resid = _solve_jit_batched(
        ops_stacked, rhs_stacked, M, n, maxiter, restart, jnp.asarray(tol),
        use_f32_precond(tol), use_annular_mp())
    outs = [(ur[i], ut[i],
             jnp.matmul(s.P10, p[i], precision=_HIGH))
            for i, s in enumerate(solvers)]
    return outs, {"iterations": iters[:len(solvers)],
                  "residual": resid[:len(solvers)]}


class AnnularStokesSolver:
    """Velocity-Dirichlet Stokes solve on the annulus, (r, t) components.

    solve(metric, fr, ft, lbc_r, lbc_t, ubc_r, ubc_t) -> (ur, ut, p) with p
    prolonged to the M-node radial grid.
    """

    def __init__(self, geom: AnnularGeometry, mu: float = 1.0):
        self.geom = geom
        self.mu = float(mu)
        CO = geom.CO
        M, n, nk = geom.M, geom.n, geom.nk
        self.M, self.n = M, n
        D01, D12 = CO.D01, CO.D12
        R01, R12, R02 = CO.R01, CO.R12, CO.R02
        lbc, ubc = CO.obc_dirichlet, CO.ibc_dirichlet  # x=-1 <-> lb
        apsi0 = geom.approx_psi0
        apsi1 = geom.approx_psi1
        iapsi1 = 1.0 / apsi1
        iapsi2 = 1.0 / geom.approx_psi2
        # circle approximation: psi = r (radius), d_r psi = 1, kappa' = 0
        base_rr = iapsi2[:, None] * (D12 @ (apsi1[:, None] * D01))
        base_tt = iapsi2[:, None] * (R12 @ (iapsi1[:, None] * R01))
        c1 = 2.0 / geom.approx_psi2**2      # combo1 on circle (dr_psi = 1)
        c2 = 1.0 / geom.approx_psi2**2      # combo2 on circle
        Kinv = np.empty((nk, 3 * M - 1, 3 * M - 1), dtype=complex)
        for m in range(nk):
            LL = base_rr - (m * m) * base_tt
            K = np.zeros((3 * M - 1, 3 * M - 1), dtype=complex)
            im = 1j * m
            # ur rows
            K[0:M - 2, 0:M] = self.mu * (-LL + c2[:, None] * R02)
            K[0:M - 2, M:2 * M] = self.mu * (c1[:, None] * R02 * im)
            K[0:M - 2, 2 * M:] = D12
            K[M - 2, 0:M] = lbc[0]
            K[M - 1, 0:M] = ubc[0]
            # ut rows
            K[M:2 * M - 2, 0:M] = -self.mu * (c1[:, None] * R02 * im)
            K[M:2 * M - 2, M:2 * M] = self.mu * (-LL + c2[:, None] * R02)
            K[M:2 * M - 2, 2 * M:] = iapsi2[:, None] * R12 * im
            K[2 * M - 2, M:2 * M] = lbc[0]
            K[2 * M - 1, M:2 * M] = ubc[0]
            # div rows
            K[2 * M:, 0:M] = iapsi1[:, None] * (D01 @ np.diag(apsi0))
            K[2 * M:, M:2 * M] = iapsi1[:, None] * R01 * im
            if m == 0 or (n % 2 == 0 and m == nk - 1):
                K[2 * M:, 2 * M:] += CO.VI1[0][None, :]
            if n % 2 == 0 and m == nk - 1:
                # the matvec's Dt zeroes the Nyquist derivative: build the
                # preconditioner block consistently (no m-coupling terms)
                K[0:M - 2, M:2 * M] = 0.0
                K[M:2 * M - 2, 0:M] = 0.0
                K[M:2 * M - 2, 2 * M:] = 0.0
                K[2 * M:, M:2 * M] = 0.0
                LL0 = base_rr
                K[0:M - 2, 0:M] = self.mu * (-LL0 + c2[:, None] * R02)
                K[M:2 * M - 2, M:2 * M] = self.mu * (-LL0 + c2[:, None] * R02)
            Kinv[m] = np.linalg.inv(K)
        f64 = jnp.asarray
        self._static = dict(
            D01=f64(D01), D12=f64(D12), R01=f64(R01), R12=f64(R12),
            R02=f64(R02), row_lb=f64(lbc), row_ub=f64(ubc),
            VI1_row0=f64(CO.VI1[:1]), tan=make_tan_plan(n),
            Kinv_re=f64(Kinv.real), Kinv_im=f64(Kinv.imag),
            mu=jnp.asarray(self.mu),
        )
        self.R02_np = R02
        self.P10 = jnp.asarray(CO.P10)
        self.iterations_last_call = 0

    def make_ops(self, metric: AnnularMetric) -> StokesOps:
        """Device operator bundle, cached on the metric (see the scalar
        solver's make_ops for why)."""
        cache = metric.__dict__.setdefault("_stokes_ops_cache", {})
        ops = cache.get(id(self))
        if ops is not None:
            return ops
        geom = self.geom
        dr_psi = metric.speed * metric.curvature   # (n,)
        ipsi2sq = metric.inv_psi2**2               # (M-2, n)
        cross = (metric.dt_curvature
                 / (metric.speed * (1.0 + geom.rv2[:, None]
                                    * metric.curvature) ** 3))
        ops = StokesOps(
            psi0=jnp.asarray(metric.psi0),
            psi1=jnp.asarray(metric.psi1),
            inv_psi1=jnp.asarray(metric.inv_psi1),
            inv_psi2=jnp.asarray(metric.inv_psi2),
            combo1=jnp.asarray(2.0 * dr_psi * ipsi2sq),
            combo2=jnp.asarray(dr_psi**2 * ipsi2sq),
            cross=jnp.asarray(cross),
            **self._static,
        )
        cache[id(self)] = ops
        return ops

    def solve(self, metric: AnnularMetric, fr, ft, lbc_r, lbc_t, ubc_r,
              ubc_t, tol: float = 1e-14, maxiter: int = 200,
              restart: int = 50, verbose: bool = False):
        (ur, ut, p_full), _ = self.solve_with_stats(
            metric, fr, ft, lbc_r, lbc_t, ubc_r, ubc_t, tol=tol,
            maxiter=maxiter, restart=restart, verbose=verbose)
        return ur, ut, p_full

    def build_rhs(self, fr, ft, lbc_r, lbc_t, ubc_r, ubc_t):
        """Flat RHS in residual layout (for solve or batched_stokes_solve)."""
        R02 = self._static["R02"]
        top_r = jnp.matmul(R02, jnp.asarray(fr), precision=_HIGH)
        top_t = jnp.matmul(R02, jnp.asarray(ft), precision=_HIGH)
        return jnp.concatenate([
            top_r.ravel(), jnp.asarray(lbc_r), jnp.asarray(ubc_r),
            top_t.ravel(), jnp.asarray(lbc_t), jnp.asarray(ubc_t),
            jnp.zeros((self.M - 1) * self.n),
        ])

    def solve_with_stats(self, metric: AnnularMetric, fr, ft, lbc_r, lbc_t,
                         ubc_r, ubc_t, tol: float = 1e-14, maxiter: int = 200,
                         restart: int = 50, verbose: bool = False):
        ops = self.make_ops(metric)
        rhs = self.build_rhs(fr, ft, lbc_r, lbc_t, ubc_r, ubc_t)
        from ipde_tpu.solvers.annular_scalar import (use_annular_mp,
                                                     use_f32_precond)
        ur, ut, p, iters, resid = _solve_jit(ops, rhs, self.M, self.n,
                                             maxiter, restart,
                                             jnp.asarray(tol),
                                             use_f32_precond(tol),
                                             use_annular_mp())
        if not isinstance(iters, jax.core.Tracer):
            self.iterations_last_call = int(iters)
            if verbose:
                print(f"annular Stokes GMRES: {int(iters)} iters, "
                      f"resid {float(resid):.2e}")
        p_full = jnp.matmul(self.P10, p, precision=_HIGH)
        return (ur, ut, p_full), {"iterations": iters, "residual": resid}
