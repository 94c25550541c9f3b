"""Boundary integral equation solvers for the physical boundary conditions.

After the inhomogeneous solve, the PDE residual is a homogeneous solution
determined by a dense BIE on the true boundaries (reference: done in the
example drivers, e.g. examples/interior_poisson.py:84-92).  Here this step is
a first-class component: the BIE matrix is assembled and inverted on host at
setup; the runtime path is matmuls + one on-the-fly layer evaluation.

Dirichlet representation: u_H = sum_j DLP_j[tau_j], collocated on every
boundary with the one-sided limit taken from the physical side.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu.ops import singular as sq
from ipde_tpu.solvers.scalar import (ModifiedHelmholtzSolver, PoissonSolver,
                                     ScalarSolver)

_HIGH = jax.lax.Precision.HIGHEST


def _bie_backend() -> str:
    """BIE build backend: IPDE_BIE_BACKEND=host|device overrides (A/B
    bisection of device-built BIE blocks vs device QFS compose, which
    share IPDE_QFS_BACKEND otherwise), else qfs.auto_backend()."""
    import os
    env = os.environ.get("IPDE_BIE_BACKEND")
    if env in ("host", "device"):
        return env
    from ipde_tpu.qfs.qfs import auto_backend
    return auto_backend()


def _invert_system(blocks, offs, backend: str):
    """Assemble the block BIE matrix and produce (A_dev, Ainv_dev).

    backend='device': blocks are device arrays; the inverse runs as a
    blocked no-pivot LU on the accelerator (ops/device_linalg), and A is
    kept on device so apply_bc can do one exact-matvec refinement step
    (second-kind systems: one step cancels the no-pivot backward error).
    backend='host': numpy blocks, LAPACK inverse, no refinement needed."""
    if backend == "device":
        from ipde_tpu.ops.device_linalg import lu_inverse_blocked
        rows = [jnp.concatenate([jnp.asarray(b) for b in row], axis=1)
                for row in blocks]
        A = jnp.concatenate(rows, axis=0) if len(rows) > 1 else rows[0]
        return A, lu_inverse_blocked(A)
    n = offs[-1]
    A = np.zeros((n, n))
    for i, row in enumerate(blocks):
        for j, b in enumerate(row):
            A[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = np.asarray(b)
    return None, jnp.asarray(np.linalg.inv(A))


def _phys_targets(ebdyc):
    """(phys_flat, phys_x, phys_y, mask) of the physical grid points.

    On a pad_quantum grid (moving-boundary stepping) the COUNT of physical
    points changes every step, which would change these plan-array shapes
    and force a recompile through utils.planify.replan.  Pad to the next
    1024-multiple: padded entries point at flat index 0 with a zero mask,
    so `grid.at[phys_flat].add(mask * vals)` is exact; extra dense-kernel
    targets (duplicates of point 0) cost noise."""
    idx = np.flatnonzero(ebdyc.phys).astype(np.int32)
    px = ebdyc.grid.xg[ebdyc.phys]
    py = ebdyc.grid.yg[ebdyc.phys]
    if getattr(ebdyc, "pad_quantum", None):
        n = idx.size
        cap = -(-n // 1024) * 1024
        pad = cap - n
        idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
        px = np.concatenate([px, np.full(pad, px[0])])
        py = np.concatenate([py, np.full(pad, py[0])])
        mask = np.concatenate([np.ones(n), np.zeros(pad)])
        return (jnp.asarray(idx), jnp.asarray(px), jnp.asarray(py),
                jnp.asarray(mask))
    return jnp.asarray(idx), jnp.asarray(px), jnp.asarray(py), None


def _solve_bie(A_dev, Ainv, rhs):
    """tau = A^{-1} rhs, with one refinement pass on the device path."""
    tau = jnp.matmul(Ainv, rhs, precision=_HIGH)
    if A_dev is not None:
        r = rhs - jnp.matmul(A_dev, tau, precision=_HIGH)
        tau = tau + jnp.matmul(Ainv, r, precision=_HIGH)
    return tau


class DirichletBIE:
    """Dense Dirichlet BIE for a ScalarSolver's boundary collection."""

    def __init__(self, solver: ScalarSolver):
        self.solver = solver
        ebdyc = solver.ebdyc
        self.ebdyc = ebdyc
        backend = _bie_backend()
        Ns = [e.bdy.N for e in ebdyc]
        offs = np.concatenate([[0], np.cumsum(Ns)])
        blocks = [[self._dlp_block(ei, ej, backend) for ej in ebdyc]
                  for ei in ebdyc]
        self.A_dev, self.Ainv = _invert_system(blocks, offs, backend)
        self.offs = offs
        # per-boundary QFS of the DLP, matched from the physical side,
        # effective sources on the far side of the physical region
        self.qfs_list = []
        self.src_list = []
        for e in ebdyc:
            src = e.qfs_source_for_side("bdy", interior_eval=e.interior,
                                        alpha=solver._qfs_alpha(e))
            src.dev()   # warm device mirrors (planified-jit arguments)
            self.src_list.append(src)
            self.qfs_list.append(
                solver._make_qfs(e.bdy, src, e.interior, build_u2s=False))
        self.src_w_dev = [s.dev()["weights"] for s in self.src_list]
        self.radial_targets = [
            (jnp.asarray(e.radial_x.ravel()), jnp.asarray(e.radial_y.ravel()))
            for e in ebdyc]
        # stratified subsampling plans [target ebdy i][source boundary j]
        from ipde_tpu.ops.stratified import StratifiedRadialApply
        self.radial_plans = [
            [StratifiedRadialApply(src, e.radial_x, e.radial_y,
                                   k_density=ej.bdy.N // 2)
             for src, ej in zip(self.src_list, ebdyc)]
            for e in ebdyc]
        # physical grid points (all of them: pna + in-annulus),
        # capacity-padded on moving-boundary grids (see _phys_targets)
        (self.phys_flat, self.phys_x, self.phys_y,
         self.phys_w) = _phys_targets(ebdyc)
        self.phys_mask_dev = jnp.asarray(ebdyc.phys)
        # FFT grid evaluator over the merged effective sources
        self.grid_eval = None
        if getattr(solver, "grid_backend", "dense") == "fft":
            gx = np.concatenate([s_.x for s_ in self.src_list])
            gy = np.concatenate([s_.y for s_ in self.src_list])
            self.grid_eval = solver._make_grid_evaluator(gx, gy)
            self.src_Ns = [s_.N for s_ in self.src_list]

    def _dlp_block(self, ei, ej, backend: str = "host"):
        """Representation: interior boundary -> DLP[tau]; inclusion
        (exterior) boundary -> (DLP + SLP)[tau].  The Laplace exterior DLP
        alone is rank-deficient (DLP of a constant density vanishes outside
        a closed curve); adding the SLP of the SAME density restores full
        rank CONSISTENTLY -- the evaluation uses the identical combination
        (mirrors the Stokes BIE; reference capability analogue:
        examples/multi_stokes_for_paper.py:117-190).  The Yukawa DLP is
        complete for inclusions -- no SLP added there.

        backend='device': Laplace blocks are born on the accelerator
        (ops/forms_dev); Yukawa self blocks stay host-built (banded Kress
        split) and upload -- they are (N, N) per boundary, small next to
        the QFS systems."""
        solver = self.solver
        is_mh = isinstance(solver, ModifiedHelmholtzSolver)
        dev = backend == "device"
        if dev:
            from ipde_tpu.ops import forms_dev as fd
        if ei is ej:
            if is_mh:
                D = jnp.asarray(sq.mh_dlp_self(ej.bdy, solver.k)) if dev \
                    else sq.mh_dlp_self(ej.bdy, solver.k)
            elif dev:
                D = fd.laplace_dlp_self_dev(ej.bdy)
                if not ej.interior:
                    D = D + fd.laplace_slp_self_dev(ej.bdy)
            else:
                D = sq.laplace_dlp_self(ej.bdy)
                if not ej.interior:
                    D = D + sq.laplace_slp_self(ej.bdy)
            jump = -0.5 if ej.interior else 0.5
            eye = jnp.eye(ej.bdy.N) if dev else np.eye(ej.bdy.N)
            return D + jump * eye
        if is_mh:
            if dev:
                return fd.mh_dlp_naive_dev(ej.bdy, ei.bdy.x, ei.bdy.y,
                                           solver.k)
            return sq.mh_dlp_naive(ej.bdy, ei.bdy.x, ei.bdy.y, solver.k)
        if dev:
            D = fd.laplace_dlp_naive_dev(ej.bdy, ei.bdy.x, ei.bdy.y)
            if not ej.interior:
                D = D + fd.laplace_slp_naive_dev(ej.bdy, ei.bdy.x, ei.bdy.y)
            return D
        D = sq.laplace_dlp_naive(ej.bdy, ei.bdy.x, ei.bdy.y)
        if not ej.interior:
            D = D + sq.laplace_slp_naive(ej.bdy, ei.bdy.x, ei.bdy.y)
        return D

    def apply_bc(self, ue: EmbeddedFunction,
                 bc: BoundaryFunction) -> EmbeddedFunction:
        """Correct ue so that it satisfies u = bc on every boundary."""
        solver = self.solver
        if (self.grid_eval is not None
                and self.grid_eval.fft_plan.mesh is not solver._mesh):
            # follow the solver's use_mesh state even when the BIE was
            # built before the mesh was activated (SURVEY.md 2.3(d))
            self.grid_eval.fft_plan.use_mesh(solver._mesh)
        bvs = solver.get_boundary_values(ue)
        rhs = jnp.concatenate([b - v for b, v in
                               zip(bc.values, bvs.values)])
        tau = _solve_bie(self.A_dev, self.Ainv, rhs)
        taus = [tau[self.offs[i]:self.offs[i + 1]]
                for i in range(len(self.ebdyc.ebdys))]
        # effective sources; QFS forms are [slp, dlp].  Laplace inclusions
        # use (SLP + DLP) of the same density (see _dlp_block); everything
        # else is DLP-only.
        is_mh = isinstance(self.solver, ModifiedHelmholtzSolver)
        sigmas = [q([t if (not e.interior and not is_mh)
                     else jnp.zeros_like(t), t])
                  for q, t, e in zip(self.qfs_list, taus, self.ebdyc)]
        # evaluate onto all physical grid points and every radial grid
        radial_vals = [jnp.zeros(e.radial_shape) for e in self.ebdyc]
        if self.grid_eval is not None:
            wq = jnp.concatenate([sig * w for w, sig
                                  in zip(self.src_w_dev, sigmas)])
            phi = self.grid_eval(wq)
            new_grid = ue.grid + jnp.where(self.phys_mask_dev, phi, 0.0)
        else:
            grid_vals = jnp.zeros(self.phys_x.shape[0])
            for src, sig in zip(self.src_list, sigmas):
                grid_vals = grid_vals + solver._apply(src, sig, self.phys_x,
                                                      self.phys_y)
            if self.phys_w is not None:
                grid_vals = grid_vals * self.phys_w
            new_grid = ue.grid.ravel().at[self.phys_flat].add(grid_vals)\
                .reshape(ue.grid.shape)
        for j, (src, sig) in enumerate(zip(self.src_list, sigmas)):
            for i, e in enumerate(self.ebdyc):
                if solver._mesh is None:
                    v = self.radial_plans[i][j].apply(
                        lambda sx, sy, ws, f, tx, ty: solver._apply_raw(
                            sx, sy, sig[::f] * ws, tx, ty))
                    radial_vals[i] = radial_vals[i] + v
                else:
                    rtx, rty = self.radial_targets[i]
                    v = solver._apply(src, sig, rtx, rty)
                    radial_vals[i] = radial_vals[i] + v.reshape(e.radial_shape)
        new_radials = [r + dv for r, dv in zip(ue.radials, radial_vals)]
        return EmbeddedFunction(new_grid, new_radials)


def solve_dirichlet(solver: ScalarSolver, f: EmbeddedFunction,
                    bc: BoundaryFunction, bie: DirichletBIE = None,
                    **kw) -> EmbeddedFunction:
    """Convenience: full inhomogeneous solve + Dirichlet BC in one call."""
    if bie is None:
        bie = DirichletBIE(solver)
    ue = solver(f, **kw)
    return bie.apply_bc(ue, bc)


class StokesDirichletBIE:
    """Dense velocity-Dirichlet BIE for the Stokes solver.

    Representation (reference: examples/multi_stokes_for_paper.py:117-190):
    interior boundary -> DLP[tau] with the normal-flux rank completion;
    exterior (inclusion) boundaries -> (SLP+DLP)[tau]; one-sided limits from
    the physical side.
    """

    def __init__(self, solver):
        from ipde_tpu.ops import stokes_kernels as sk
        self.solver = solver
        ebdyc = solver.ebdyc
        self.ebdyc = ebdyc
        backend = _bie_backend()
        dev = backend == "device"
        if dev:
            from ipde_tpu.ops import forms_dev as fd
        Ns = [e.bdy.N for e in ebdyc]
        offs = np.concatenate([[0], np.cumsum([2 * n for n in Ns])])

        def blk(i, ei, j, ej):
            bi, bj = ei.bdy, ej.bdy
            if i == j:
                if ej.interior:
                    if dev:
                        return (fd.stokes_dlp_self_dev(bj)
                                - 0.5 * jnp.eye(2 * bj.N)
                                + fd.stokes_pressure_fix_dev(
                                    bj, bj.normal_x, bj.normal_y))
                    return (sk.stokes_dlp_self(bj) - 0.5 * np.eye(2 * bj.N)
                            + sk.stokes_pressure_fix(bj, bj.normal_x,
                                                     bj.normal_y))
                if dev:
                    return (fd.stokes_dlp_self_dev(bj)
                            + fd.stokes_slp_self_dev(bj)
                            + 0.5 * jnp.eye(2 * bj.N))
                return (sk.stokes_dlp_self(bj) + sk.stokes_slp_self(bj)
                        + 0.5 * np.eye(2 * bj.N))
            if ej.interior:
                if dev:
                    return (fd.stokes_dlp_naive_dev(bj, bi.x, bi.y)
                            + fd.stokes_pressure_fix_dev(bj, bi.normal_x,
                                                         bi.normal_y))
                return (sk.stokes_dlp_naive(bj, bi.x, bi.y)
                        + sk.stokes_pressure_fix(bj, bi.normal_x,
                                                 bi.normal_y))
            if dev:
                return (fd.stokes_dlp_naive_dev(bj, bi.x, bi.y)
                        + fd.stokes_slp_naive_dev(bj, bi.x, bi.y))
            return (sk.stokes_dlp_naive(bj, bi.x, bi.y)
                    + sk.stokes_slp_naive(bj, bi.x, bi.y))

        blocks = [[blk(i, ei, j, ej) for j, ej in enumerate(ebdyc)]
                  for i, ei in enumerate(ebdyc)]
        self.A_dev, self.Ainv = _invert_system(blocks, offs, backend)
        self.offs = offs
        # per-boundary QFS (forms matched from the physical side)
        from ipde_tpu.solvers.vector import stokes_qfs
        self.qfs_list = []
        self.src_list = []
        for e in ebdyc:
            src = e.qfs_source_for_side("bdy", interior_eval=e.interior)
            src.dev()
            self.src_list.append(src)
            self.qfs_list.append(
                stokes_qfs(e.bdy, src, e.interior,
                           slp=not e.interior, dlp=True, build_u2s=False))
        self.radial_targets = [
            (jnp.asarray(e.radial_x.ravel()), jnp.asarray(e.radial_y.ravel()))
            for e in ebdyc]
        # stratified subsampling plans [target ebdy i][source boundary j]
        from ipde_tpu.ops.stratified import StratifiedRadialApply
        self.radial_plans = [
            [StratifiedRadialApply(src, e.radial_x, e.radial_y,
                                   k_density=ej.bdy.N // 2)
             for src, ej in zip(self.src_list, ebdyc)]
            for e in ebdyc]
        (self.phys_flat, self.phys_x, self.phys_y,
         self.phys_w) = _phys_targets(ebdyc)
        self.phys_mask_dev = jnp.asarray(ebdyc.phys)
        self.grid_eval = None
        if getattr(solver, "grid_backend", "dense") == "fft":
            from ipde_tpu.ops.grid_eval import StokesFreespaceGridEvaluator
            gx = np.concatenate([s_.x for s_ in self.src_list])
            gy = np.concatenate([s_.y for s_ in self.src_list])
            g = ebdyc.grid
            px = g.xg[ebdyc.phys]
            py = g.yg[ebdyc.phys]
            bounds = ((float(px.min()), float(px.max())),
                      (float(py.min()), float(py.max())))
            self.grid_eval = StokesFreespaceGridEvaluator(
                g, gx, gy, target_bounds=bounds,
                target_hull=ebdyc.phys_extremes())

    def apply_bc(self, u, v, p, bc_u, bc_v):
        """Correct (u, v, p) to satisfy the velocity boundary conditions."""
        from ipde_tpu.ops import stokes_kernels as sk
        solver = self.solver
        if (self.grid_eval is not None
                and self.grid_eval.fft_plan.mesh is not solver._mesh):
            self.grid_eval.fft_plan.use_mesh(solver._mesh)
        bu = solver.get_boundary_values(u)
        bv = solver.get_boundary_values(v)
        # -(computed - constant): see DirichletBIE.apply_bc
        rhs = jnp.concatenate([
            jnp.concatenate([-(bu_i - bcu), -(bv_i - bcv)])
            for bcu, bcv, bu_i, bv_i in
            zip(bc_u.values, bc_v.values, bu.values, bv.values)])
        tau = _solve_bie(self.A_dev, self.Ainv, rhs)
        taus = [tau[self.offs[i]:self.offs[i + 1]]
                for i in range(len(self.ebdyc.ebdys))]
        # QFS: interior boundaries have DLP-only forms; exterior SLP+DLP of
        # the same density
        sigmas = []
        for e, q, t in zip(self.ebdyc, self.qfs_list, taus):
            if e.interior:
                sigmas.append(q([t]))
            else:
                sigmas.append(q([t, t]))
        radial_updates = [[jnp.zeros(e.radial_shape) for e in self.ebdyc]
                          for _ in range(3)]
        sh = u.grid.shape
        if self.grid_eval is not None:
            wfx = jnp.concatenate([sig[:src.N] * src.dev()["weights"]
                                   for src, sig in zip(self.src_list, sigmas)])
            wfy = jnp.concatenate([sig[src.N:] * src.dev()["weights"]
                                   for src, sig in zip(self.src_list, sigmas)])
            gu, gv, gp = self.grid_eval(wfx, wfy)
            gnew = [u.grid + jnp.where(self.phys_mask_dev, gu, 0.0),
                    v.grid + jnp.where(self.phys_mask_dev, gv, 0.0),
                    p.grid + jnp.where(self.phys_mask_dev, gp, 0.0)]
        else:
            du = jnp.zeros(self.phys_x.shape[0])
            dv = jnp.zeros_like(du)
            dp = jnp.zeros_like(du)
            for src, sig in zip(self.src_list, sigmas):
                d = src.dev()
                w = d["weights"]
                gu, gv, gp = sk.stokes_slp_apply(
                    d["x"], d["y"], sig[:src.N] * w, sig[src.N:] * w,
                    self.phys_x, self.phys_y)
                du, dv, dp = du + gu, dv + gv, dp + gp
            if self.phys_w is not None:
                du, dv, dp = du * self.phys_w, dv * self.phys_w, \
                    dp * self.phys_w
            gnew = [g.ravel().at[self.phys_flat].add(dd).reshape(sh)
                    for g, dd in zip([u.grid, v.grid, p.grid], [du, dv, dp])]
        for j, (src, sig) in enumerate(zip(self.src_list, sigmas)):
            sN = src.N
            for i, e in enumerate(self.ebdyc):
                ru, rv, rp = self.radial_plans[i][j].apply(
                    lambda sx, sy, ws, f, tx, ty: sk.stokes_slp_apply(
                        sx, sy, sig[:sN][::f] * ws, sig[sN:][::f] * ws,
                        tx, ty),
                    n_out=3)
                radial_updates[0][i] = radial_updates[0][i] + ru
                radial_updates[1][i] = radial_updates[1][i] + rv
                radial_updates[2][i] = radial_updates[2][i] + rp
        u2 = EmbeddedFunction(gnew[0],
                              [a + b for a, b in zip(u.radials, radial_updates[0])])
        v2 = EmbeddedFunction(gnew[1],
                              [a + b for a, b in zip(v.radials, radial_updates[1])])
        p2 = EmbeddedFunction(gnew[2],
                              [a + b for a, b in zip(p.radials, radial_updates[2])])
        return u2, v2, p2


class NeumannBIE:
    """Dense Neumann BIE: u_H = sum_j SLP_j[sigma_j], collocating the normal
    derivative from the physical side (reference:
    examples/interior_modified_helmholtz_using_multi_neumann_bc.py).

    For the modified Helmholtz kernel the system is well posed; for Laplace
    an interior pure-Neumann problem carries the usual compatibility
    condition and the constant nullspace is pinned with a mean constraint.
    """

    def __init__(self, solver: ScalarSolver):
        self.solver = solver
        ebdyc = solver.ebdyc
        self.ebdyc = ebdyc
        is_mh = isinstance(solver, ModifiedHelmholtzSolver)
        backend = _bie_backend()
        dev = backend == "device"
        if dev:
            from ipde_tpu.ops import forms_dev as fd
        Ns = [e.bdy.N for e in ebdyc]
        offs = np.concatenate([[0], np.cumsum(Ns)])

        def blk(i, ei, j, ej):
            bi, bj = ei.bdy, ej.bdy
            if i == j:
                if is_mh:
                    b = sq.mh_slp_normal_self(bj, solver.k)
                    b = jnp.asarray(b) if dev else b
                elif dev:
                    b = fd.laplace_slp_normal_self_dev(bj)
                else:
                    b = sq.laplace_slp_normal_self(bj)
                jump = 0.5 if ej.interior else -0.5
                return b + jump * (jnp.eye(bj.N) if dev else np.eye(bj.N))
            if is_mh:
                if dev:
                    return fd.mh_slp_normal_naive_dev(
                        bj, bi.x, bi.y, bi.normal_x, bi.normal_y, solver.k)
                return sq.mh_slp_normal_naive(bj, bi.x, bi.y, bi.normal_x,
                                              bi.normal_y, solver.k)
            if dev:
                return fd.laplace_slp_normal_naive_dev(
                    bj, bi.x, bi.y, bi.normal_x, bi.normal_y)
            return sq.laplace_slp_normal_naive(bj, bi.x, bi.y, bi.normal_x,
                                               bi.normal_y)

        blocks = [[blk(i, ei, j, ej) for j, ej in enumerate(ebdyc)]
                  for i, ei in enumerate(ebdyc)]
        if not is_mh and len(ebdyc.ebdys) == 1 and ebdyc.ebdys[0].interior:
            # pin the Laplace Neumann nullspace: add mean(sigma) to all rows
            w = ebdyc.ebdys[0].bdy.weights[None, :]
            blocks[0][0] = blocks[0][0] + (jnp.asarray(w) if dev else w)
        self.A_dev, self.Ainv = _invert_system(blocks, offs, backend)
        self.offs = offs
        self.qfs_list = []
        self.src_list = []
        for e in ebdyc:
            src = e.qfs_source_for_side("bdy", interior_eval=e.interior,
                                        alpha=solver._qfs_alpha(e))
            src.dev()
            self.src_list.append(src)
            self.qfs_list.append(
                solver._make_qfs_slp_only(e.bdy, src, e.interior))
        self.src_w_dev = [s.dev()["weights"] for s in self.src_list]
        self.radial_targets = [
            (jnp.asarray(e.radial_x.ravel()), jnp.asarray(e.radial_y.ravel()))
            for e in ebdyc]
        # stratified subsampling plans [target ebdy i][source boundary j]
        from ipde_tpu.ops.stratified import StratifiedRadialApply
        self.radial_plans = [
            [StratifiedRadialApply(src, e.radial_x, e.radial_y,
                                   k_density=ej.bdy.N // 2)
             for src, ej in zip(self.src_list, ebdyc)]
            for e in ebdyc]
        (self.phys_flat, self.phys_x, self.phys_y,
         self.phys_w) = _phys_targets(ebdyc)
        self.phys_mask_dev = jnp.asarray(ebdyc.phys)
        self.grid_eval = None
        if getattr(solver, "grid_backend", "dense") == "fft":
            gx = np.concatenate([s_.x for s_ in self.src_list])
            gy = np.concatenate([s_.y for s_ in self.src_list])
            self.grid_eval = solver._make_grid_evaluator(gx, gy)

    def apply_bc(self, ue: EmbeddedFunction,
                 bc_n: BoundaryFunction) -> EmbeddedFunction:
        """Correct ue so that du/dn = bc_n on every boundary."""
        solver = self.solver
        bns = solver.get_boundary_normal_derivatives(ue)
        # -(computed - constant): see DirichletBIE.apply_bc
        rhs = jnp.concatenate([-(v - b) for b, v in
                               zip(bc_n.values, bns.values)])
        sig = _solve_bie(self.A_dev, self.Ainv, rhs)
        sigs = [sig[self.offs[i]:self.offs[i + 1]]
                for i in range(len(self.ebdyc.ebdys))]
        xis = [q([s]) for q, s in zip(self.qfs_list, sigs)]
        radial_vals = [jnp.zeros(e.radial_shape) for e in self.ebdyc]
        if self.grid_eval is not None:
            wq = jnp.concatenate([xi * w for w, xi
                                  in zip(self.src_w_dev, xis)])
            phi = self.grid_eval(wq)
            new_grid = ue.grid + jnp.where(self.phys_mask_dev, phi, 0.0)
        else:
            grid_vals = jnp.zeros(self.phys_x.shape[0])
            for src, xi in zip(self.src_list, xis):
                grid_vals = grid_vals + solver._apply(src, xi, self.phys_x,
                                                      self.phys_y)
            if self.phys_w is not None:
                grid_vals = grid_vals * self.phys_w
            new_grid = ue.grid.ravel().at[self.phys_flat].add(grid_vals)\
                .reshape(ue.grid.shape)
        for j, (src, xi) in enumerate(zip(self.src_list, xis)):
            for i, e in enumerate(self.ebdyc):
                if solver._mesh is None:
                    v = self.radial_plans[i][j].apply(
                        lambda sx, sy, ws, f, tx, ty: solver._apply_raw(
                            sx, sy, xi[::f] * ws, tx, ty))
                    radial_vals[i] = radial_vals[i] + v
                else:
                    rtx, rty = self.radial_targets[i]
                    v = solver._apply(src, xi, rtx, rty)
                    radial_vals[i] = radial_vals[i] + v.reshape(e.radial_shape)
        new_radials = [r + dv for r, dv in zip(ue.radials, radial_vals)]
        return EmbeddedFunction(new_grid, new_radials)
