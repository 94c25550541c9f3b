"""Multi-boundary inhomogeneous Stokes solver.

Solves  -lap u + grad p = f,  div u = 0  (mu = 1) on the embedded domain.
Reference: ipde/solvers/multi_boundary/vector.py:57-112, stokes.py,
internals/vector.py:63-162, internals/stokes.py.

Same orchestration as the scalar path with vector data:
  1. box solve by spectral pressure projection of the rolled-off forcing,
  2. interpolate (u, v, p, ux, uy, vx, vy) to the interfaces in ONE batched
     mode-space NUFFT; form the grid solution's traction there,
  3. per boundary: annular Stokes solve (zero velocity BCs), interface
     traction of the radial solution; SLP density = traction jump, DLP
     density = grid velocity; QFS -> sigma_g, sigma_r,
  4. one global Stokeslet evaluation (u, v, p) onto pna + interfaces,
  5. per-boundary correction, radial->grid merge.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu.ops import stokes_kernels as sk
from ipde_tpu.ops.cx import Cx
from ipde_tpu.ops.fourier import FourierPlan1D
from ipde_tpu.qfs.qfs import QFSEvaluator
from ipde_tpu.solvers.annular_stokes import AnnularStokesSolver

_HIGH = jax.lax.Precision.HIGHEST


def stokes_qfs(curve, source, interior: bool, slp: bool = True,
               dlp: bool = True, rcond: float = 1e-15,
               build_u2s: bool = True, backend: str = None) -> QFSEvaluator:
    """QFS maps for the Stokes velocity layer potentials (2-vector packed).

    The source-to-curve matrix carries the rank-1 normal-flux completion
    (reference: Fixed_SLP in examples/multi_stokes_for_paper.py) so the
    least-squares match is well posed; matched data is incompressible, so
    the completion component of the solution vanishes."""
    from ipde_tpu.qfs.qfs import auto_backend
    backend = backend or auto_backend()
    jump = -0.5 if interior else 0.5
    forms = []
    if backend == "device":
        from ipde_tpu.ops import forms_dev as fd
        if slp:
            forms.append(fd.stokes_slp_self_dev(curve))
        if dlp:
            forms.append(fd.stokes_dlp_self_dev(curve)
                         + jump * jnp.eye(2 * curve.N))
        A = (fd.stokes_slp_naive_dev(source, curve.x, curve.y)
             + fd.stokes_pressure_fix_dev(source, curve.normal_x,
                                          curve.normal_y))
    else:
        if slp:
            forms.append(sk.stokes_slp_self(curve))
        if dlp:
            forms.append(sk.stokes_dlp_self(curve)
                         + jump * np.eye(2 * curve.N))
        A = (sk.stokes_slp_naive(source, curve.x, curve.y)
             + sk.stokes_pressure_fix(source, curve.normal_x, curve.normal_y))
    return QFSEvaluator(source, curve, forms, A, rcond,
                        build_u2s=build_u2s, backend=backend)


def _stokes_donor(prev_helper, ebdy):
    """Reusable annular Stokes solver from a compatible previous helper
    (see solvers/scalar.py::_annular_donor for the compatibility rules)."""
    if prev_helper is None:
        return None
    a = prev_helper.annular_solver
    g = a.geom
    if (g.n, g.M) != (ebdy.bdy.N, ebdy.M):
        return None
    if abs(g.lb - ebdy.lb) > 1e-12 or abs(g.ub - ebdy.ub) > 1e-12:
        return None
    if not (0.8 <= ebdy.approximate_radius / g.approx_r <= 1.25):
        return None
    return a


class _StokesHelper:
    def __init__(self, solver, ebdy: EmbeddedBoundary, multi: bool = True,
                 shared_annular=None):
        self.ebdy = ebdy
        self.interior = ebdy.interior
        geom = AnnularGeometry(ebdy.bdy.N, ebdy.M, ebdy.lb, ebdy.ub,
                               ebdy.approximate_radius)
        self.annular_solver = (shared_annular if shared_annular is not None
                               else AnnularStokesSolver(geom, mu=1.0))
        self.metric = AnnularMetric(ebdy.bdy.speed, ebdy.bdy.curvature, geom)
        ifc = ebdy.interface
        self.grid_source = ebdy.qfs_source_for_side(
            "interface", interior_eval=self.interior)
        self.radial_source = ebdy.qfs_source_for_side(
            "interface", interior_eval=not self.interior)
        # multi-body-only plans (u2s adjustment + own-source matrix are
        # skipped in the single-boundary correct shortcut: ~1.5 GB of HBM
        # at nb=2700)
        self.qfs_g = stokes_qfs(ifc, self.grid_source, self.interior,
                                build_u2s=False)
        self.qfs_r = stokes_qfs(ifc, self.radial_source, not self.interior,
                                build_u2s=multi)
        if multi:
            from ipde_tpu.qfs.qfs import auto_backend
            if auto_backend() == "device":
                from ipde_tpu.ops import forms_dev as fd
                self.own_src_to_ifc = fd.stokes_slp_naive_dev(
                    self.grid_source, ifc.x, ifc.y)
            else:
                self.own_src_to_ifc = jnp.asarray(
                    sk.stokes_slp_naive(self.grid_source, ifc.x, ifc.y))
        else:
            self.own_src_to_ifc = None
        # estimator rows + radial derivative machinery
        self.f_to_bdy = jnp.asarray(ebdy.interp_f_to_bdy)
        self.f_to_ifc = jnp.asarray(ebdy.interp_f_to_interface)
        self.D00 = jnp.asarray(ebdy.D00)
        self.plan_t = FourierPlan1D(ebdy.bdy.N)
        self.inv_rspeed = jnp.asarray(ebdy.inverse_radial_speed)
        self.rspeed = jnp.asarray(ebdy.radial_speed)
        b = ebdy.bdy
        self.nx = jnp.asarray(b.normal_x)
        self.ny = jnp.asarray(b.normal_y)
        self.tx = jnp.asarray(b.tangent_x)
        self.ty = jnp.asarray(b.tangent_y)
        i = ebdy.interface
        self.ifc_n = (jnp.asarray(i.normal_x), jnp.asarray(i.normal_y))
        # hoisted device mirrors + warmed caches (planified-jit arguments)
        self.radial_tx = jnp.asarray(ebdy.radial_x.ravel())
        self.radial_ty = jnp.asarray(ebdy.radial_y.ravel())
        # stratified source subsampling for the dense radial Stokeslet
        # apply in `correct` (see ops/stratified.py)
        from ipde_tpu.ops.stratified import StratifiedRadialApply
        self.radial_plan = StratifiedRadialApply(
            self.radial_source, ebdy.radial_x, ebdy.radial_y,
            k_density=ebdy.bdy.N // 2)
        self.annular_solver.make_ops(self.metric)
        self.grid_source.dev()
        self.radial_source.dev()
        self.iterations_last_call = 0

    # -- coordinate conversions (reference: embedded_boundary.py:521-530) ----
    def uv_to_rt(self, fu, fv):
        return fu * self.nx + fv * self.ny, fu * self.tx + fv * self.ty

    def rt_to_uv(self, fr, ft):
        return fr * self.nx + ft * self.tx, fr * self.ny + ft * self.ty

    # -- traction on the radial grid (reference: internals/vector.py:87-102) -
    def _traction_rt(self, Ur, Ut, p, row):
        mm = lambda a, b: jnp.matmul(a, b, precision=_HIGH)
        Urr = mm(self.D00, Ur)
        Urt = self.plan_t.tderiv(Ur) * self.inv_rspeed
        Utr = self.rspeed * mm(self.D00, Ut * self.inv_rspeed)
        Tr = 2 * mm(row, Urr) - mm(row, p)
        Tt = mm(row, Utr) + mm(row, Urt)
        return Tr, Tt

    def interface_traction_uv(self, u, v, p):
        Ur, Ut = self.uv_to_rt(u, v)
        Tr, Tt = self._traction_rt(Ur, Ut, p, self.f_to_ifc)
        return self.rt_to_uv(Tr, Tt)

    def boundary_traction_uv(self, u, v, p):
        Ur, Ut = self.uv_to_rt(u, v)
        Tr, Tt = self._traction_rt(Ur, Ut, p, self.f_to_bdy)
        return self.rt_to_uv(Tr, Tt)

    # -- main per-boundary step ----------------------------------------------
    def annular_rhs(self, fur, fvr):
        """Flat zero-BC annular RHS (batched-dispatch path)."""
        fr, ft = self.uv_to_rt(fur, fvr)
        zero = jnp.zeros(self.ebdy.bdy.N)
        return self.annular_solver.build_rhs(fr, ft, zero, zero, zero, zero)

    def densities(self, uvp_rt, bu, bv, btxx, btxy, btyy):
        """QFS effective densities from the (r, t, p) annular solution +
        interface data (the non-GMRES half of solve_and_densities)."""
        rr, tr, pr = uvp_rt
        nix, niy = self.ifc_n
        btx = btxx * nix + btxy * niy
        bty = btxy * nix + btyy * niy
        ur, vr = self.rt_to_uv(rr, tr)
        rtx, rty = self.interface_traction_uv(ur, vr, pr)
        taus = jnp.concatenate([rtx - btx, rty - bty])
        taud = jnp.concatenate([bu, bv])
        if not self.interior:
            taus = -taus
            taud = -taud
        sigma_g = self.qfs_g([taus, taud])
        sigma_r = self.qfs_r([taus, taud])
        return (ur, vr, pr), sigma_g, sigma_r

    def solve_and_densities(self, fur, fvr, bu, bv, btxx, btxy, btyy,
                            tol, maxiter, restart):
        fr, ft = self.uv_to_rt(fur, fvr)
        zero = jnp.zeros(self.ebdy.bdy.N)
        uvp_rt, stats = self.annular_solver.solve_with_stats(
            self.metric, fr, ft, zero, zero, zero, zero, tol=tol,
            maxiter=maxiter, restart=restart)
        self.iterations_last_call = self.annular_solver.iterations_last_call
        uvp, sigma_g, sigma_r = self.densities(uvp_rt, bu, bv, btxx, btxy,
                                               btyy)
        return uvp, sigma_g, sigma_r, stats

    def correct(self, uvp, sigma_g, sigma_r, bu, bv, single: bool):
        ur, vr, pr = uvp
        N = self.ebdy.bdy.N
        if single:
            sigma_r_tot = sigma_r
        else:
            w = jnp.matmul(self.own_src_to_ifc, sigma_g, precision=_HIGH)
            Ub = jnp.concatenate([bu - w[:N], bv - w[N:]])
            sigma_r_tot = sigma_r + self.qfs_r.u2s(Ub)
        sN = self.radial_source.N
        du, dv, dp = self.radial_plan.apply(
            lambda sx, sy, ws, f, tx, ty: sk.stokes_slp_apply(
                sx, sy, sigma_r_tot[:sN][::f] * ws,
                sigma_r_tot[sN:][::f] * ws, tx, ty),
            n_out=3)
        return ur + du, vr + dv, pr + dp


class StokesSolver:
    """(u, v, p) = solver(fu, fv) with fu/fv EmbeddedFunctions.

    grid_backend: 'fft' evaluates the merged sigma_g Stokeslet field on the
    grid with StokesFreespaceGridEvaluator (O(N^2 log N); replaces the
    reference's SFMM, ipde/solvers/internals/stokes.py:26-35); 'dense' uses
    the direct chunked kernel sum (ground truth / small grids).
    """

    def __init__(self, ebdyc: EmbeddedBoundaryCollection,
                 grid_backend: str = "fft", helpers: Optional[List] = None,
                 solver_type: str = "spectral"):
        """helpers: helpers from a previous StokesSolver on compatible
        geometry (same n, M, radial bounds, ~same radius): their annular
        Stokes preconditioners are reused, the dominant per-step setup cost
        of moving-boundary runs (reference analogue:
        ipde/solvers/multi_boundary/modified_helmholtz.py:13-39).

        solver_type: 'spectral' (NUFFT interface data from the mode stack)
        or 'fourth' (4th-order FD grid derivatives + 3rd-order polynomial
        interface interpolation; reference:
        ipde/solvers/multi_boundary/vector.py:7-47)."""
        self.ebdyc = ebdyc
        if ebdyc.grid is None:
            raise ValueError("collection has no registered grid")
        if ebdyc.bumpy is None:
            ebdyc.ready_bump()
        self.grid_backend = grid_backend
        if solver_type not in ("spectral", "fourth"):
            raise ValueError(solver_type)
        self.solver_type = solver_type
        if solver_type == "fourth":
            from ipde_tpu.ops.interp import PolyInterpolator2D
            g = ebdyc.grid
            self.ifc_poly_interp = PolyInterpolator2D(
                g.x_bounds[0], g.y_bounds[0], g.xh, g.yh, g.Nx, g.Ny,
                ebdyc.all_interface_x, ebdyc.all_interface_y, order=3)
        multi = len(ebdyc.ebdys) > 1
        donors = list(helpers) if helpers else [None] * len(ebdyc.ebdys)
        donors += [None] * (len(ebdyc.ebdys) - len(donors))
        self.helpers = [_StokesHelper(self, e, multi=multi,
                                      shared_annular=_stokes_donor(d, e))
                        for e, d in zip(ebdyc, donors)]
        gx = np.concatenate([h.grid_source.x for h in self.helpers])
        gy = np.concatenate([h.grid_source.y for h in self.helpers])
        gw = np.concatenate([h.grid_source.weights for h in self.helpers])
        self.grid_src_x = jnp.asarray(gx)
        self.grid_src_y = jnp.asarray(gy)
        self.grid_src_w = jnp.asarray(gw)
        self.src_Ns = [h.grid_source.N for h in self.helpers]
        lap = ebdyc.lap.copy()
        lap[0, 0] = np.inf
        self.ilap = jnp.asarray(1.0 / lap)
        self.pna_mask_dev = jnp.asarray(ebdyc.phys_not_in_annulus)
        self._mesh = None
        if grid_backend == "fft":
            from ipde_tpu.ops.grid_eval import StokesFreespaceGridEvaluator
            g = ebdyc.grid
            px = g.xg[ebdyc.phys]
            py = g.yg[ebdyc.phys]
            bounds = ((float(px.min()), float(px.max())),
                      (float(py.min()), float(py.max())))
            self.grid_eval = StokesFreespaceGridEvaluator(
                g, gx, gy, target_bounds=bounds,
                target_hull=ebdyc.phys_extremes())
        self.iteration_counts = []

    def use_mesh(self, mesh):
        """Activate multi-chip sharding of the dense Stokeslet applies
        (target-sharded over the mesh; SURVEY.md 2.3(c)), the 2D grid FFT
        passes (box solve + VG evaluator, 2.3(d)), and the boundary axis
        of the batched annular Stokes GMRES (2.3(b))."""
        self._mesh = mesh
        self.ebdyc.fft_plan.use_mesh(mesh)
        ge = getattr(self, "grid_eval", None)
        if ge is not None:
            ge.fft_plan.use_mesh(mesh)

    def _apply_stokes(self, sx, sy, wfx, wfy, tx, ty):
        if self._mesh is not None:
            from ipde_tpu.parallel.sharded import sharded_stokes_slp_apply
            return sharded_stokes_slp_apply(self._mesh, sx, sy, wfx, wfy,
                                            tx, ty)
        return sk.stokes_slp_apply(sx, sy, wfx, wfy, tx, ty)

    def __call__(self, fu: EmbeddedFunction, fv: EmbeddedFunction,
                 tol: float = 1e-13, maxiter: int = 200, restart: int = 50,
                 verbose: bool = False):
        (u, v, p), _ = self.solve_with_stats(fu, fv, tol=tol, maxiter=maxiter,
                                             restart=restart, verbose=verbose)
        return u, v, p

    def solve_with_stats(self, fu: EmbeddedFunction, fv: EmbeddedFunction,
                         tol: float = 1e-13, maxiter: int = 200,
                         restart: int = 50, verbose: bool = False):
        """Full Stokes solve, also returning a jit-safe stats pytree."""
        ebdyc = self.ebdyc
        plan = ebdyc.fft_plan
        kx, ky = ebdyc.kx_dev, ebdyc.ky_dev
        fuc = ebdyc.demean_function(fu.grid * ebdyc.grid_step_dev)
        fvc = ebdyc.demean_function(fv.grid * ebdyc.grid_step_dev)
        fuh, fvh = plan.fft2_stack([fuc, fvc])
        # pressure projection: p = ilap (ikx fu + iky fv); u = ilap(ikx p - fu)
        mul_ik = lambda c, k: Cx(-c.im * k, c.re * k)
        ph = Cx((mul_ik(fuh, kx).re + mul_ik(fvh, ky).re) * self.ilap,
                (mul_ik(fuh, kx).im + mul_ik(fvh, ky).im) * self.ilap)
        uh = Cx((mul_ik(ph, kx).re - fuh.re) * self.ilap,
                (mul_ik(ph, kx).im - fuh.im) * self.ilap)
        vh = Cx((mul_ik(ph, ky).re - fvh.re) * self.ilap,
                (mul_ik(ph, ky).im - fvh.im) * self.ilap)
        uc, vc, pc = plan.ifft2_real_stack([uh, vh, ph])
        if self.solver_type == "fourth":
            # 4th-order FD derivatives + 3rd-order polynomial interface
            # interpolation (reference: multi_boundary/vector.py:7-47)
            from ipde_tpu.ops.fd import fd_x_4, fd_y_4
            g = ebdyc.grid
            pi = self.ifc_poly_interp
            bus, bvs, bps = pi(uc), pi(vc), pi(pc)
            uxs, uys = pi(fd_x_4(uc, g.xh)), pi(fd_y_4(uc, g.yh))
            vxs, vys = pi(fd_x_4(vc, g.xh)), pi(fd_y_4(vc, g.yh))
        else:
            # interface data: u, v, p, ux, uy, vx, vy in one batched NUFFT
            # values + gradients of (u, v, p) in one 3-field pass (window-
            # derivative weights replace the old 7-field ik-mode stack)
            stack3 = Cx(jnp.stack([uh.re, vh.re, ph.re]),
                        jnp.stack([uh.im, vh.im, ph.im]))
            vals, gxs, gys = ebdyc.interface_values_and_grads(stack3)
            bus, bvs, bps = vals[0], vals[1], vals[2]
            uxs, uys, vxs, vys = gxs[0], gys[0], gxs[1], gys[1]
        btxxs = 2 * uxs - bps
        btxys = uys + vxs
        btyys = 2 * vys - bps
        v2l = ebdyc.v2l
        bul_, bvl_ = v2l(bus), v2l(bvs)
        txxl, txyl, tyyl = v2l(btxxs), v2l(btxys), v2l(btyys)
        # per-boundary annular solves + densities.  When every boundary has
        # the same (M, n) the Stokes GMRES runs as ONE vmapped dispatch over
        # the boundary axis (SURVEY.md 2.3(b)); otherwise a Python loop.
        dims = {(h.annular_solver.M, h.annular_solver.n)
                for h in self.helpers}
        uvps, sig_gs, sig_rs = [], [], []
        if len(self.helpers) > 1 and len(dims) == 1:
            from ipde_tpu.solvers.annular_stokes import batched_stokes_solve
            rhss = [h.annular_rhs(fur, fvr)
                    for h, fur, fvr in zip(self.helpers, fu.radials,
                                           fv.radials)]
            uvp_rts, bstats = batched_stokes_solve(
                [h.annular_solver for h in self.helpers],
                [h.metric for h in self.helpers], rhss, tol, maxiter,
                restart, mesh=self._mesh)
            stats = {"annular_iterations": bstats["iterations"],
                     "annular_residuals": bstats["residual"]}
            for h, uvp_rt, bu, bv, txx, txy, tyy in zip(
                    self.helpers, uvp_rts, bul_, bvl_, txxl, txyl, tyyl):
                uvp, sg, sr = h.densities(uvp_rt, bu, bv, txx, txy, tyy)
                uvps.append(uvp)
                sig_gs.append(sg)
                sig_rs.append(sr)
        else:
            stats_list = []
            per = zip(self.helpers, fu.radials, fv.radials, bul_, bvl_,
                      txxl, txyl, tyyl)
            for h, fur, fvr, bu, bv, txx, txy, tyy in per:
                uvp, sg, sr, st = h.solve_and_densities(fur, fvr, bu, bv,
                                                        txx, txy, tyy, tol,
                                                        maxiter, restart)
                uvps.append(uvp)
                sig_gs.append(sg)
                sig_rs.append(sr)
                stats_list.append(st)
            stats = {
                "annular_iterations": jnp.stack(
                    [s["iterations"] for s in stats_list]),
                "annular_residuals": jnp.stack(
                    [s["residual"] for s in stats_list]),
            }
        # NOTE: under jit (stats are tracers) the per-boundary iteration
        # attributes cannot be updated; they are only valid on eager solves.
        it = stats["annular_iterations"]
        if not isinstance(it, jax.core.Tracer):
            self.iteration_counts = [int(v) for v in np.asarray(it)]
            counts = np.atleast_1d(np.asarray(it))
            for h, c in zip(self.helpers, counts):
                h.iterations_last_call = int(c)
        if verbose:
            print("annular Stokes iterations:", self.iteration_counts)
        # merged sigma_g evaluation onto pna + interfaces
        wfx = jnp.concatenate([s[:n] for s, n in zip(sig_gs, self.src_Ns)])
        wfy = jnp.concatenate([s[n:] for s, n in zip(sig_gs, self.src_Ns)])
        if self.grid_backend == "fft":
            gug, gvg, gpg = self.grid_eval(wfx * self.grid_src_w,
                                           wfy * self.grid_src_w)
            uc = uc + jnp.where(self.pna_mask_dev, gug, 0.0)
            vc = vc + jnp.where(self.pna_mask_dev, gvg, 0.0)
            pc = pc + jnp.where(self.pna_mask_dev, gpg, 0.0)
            giu, giv, gip = self._apply_stokes(
                self.grid_src_x, self.grid_src_y, wfx * self.grid_src_w,
                wfy * self.grid_src_w, ebdyc.all_interface_x_dev,
                ebdyc.all_interface_y_dev)
            bul = v2l(giu)
            bvl = v2l(giv)
            bpl = v2l(bps + gip)
        else:
            tx = jnp.concatenate([ebdyc.pna_x_dev, ebdyc.all_interface_x_dev])
            ty = jnp.concatenate([ebdyc.pna_y_dev, ebdyc.all_interface_y_dev])
            gu, gv, gp = self._apply_stokes(self.grid_src_x, self.grid_src_y,
                                            wfx * self.grid_src_w,
                                            wfy * self.grid_src_w, tx, ty)
            n_pna = ebdyc.pna_x.size
            pna_idx = ebdyc.pna_flat_dev
            shape = ebdyc.grid.shape
            uc = uc.ravel().at[pna_idx].add(gu[:n_pna]).reshape(shape)
            vc = vc.ravel().at[pna_idx].add(gv[:n_pna]).reshape(shape)
            pc = pc.ravel().at[pna_idx].add(gp[:n_pna]).reshape(shape)
            bul = v2l(gu[n_pna:])
            bvl = v2l(gv[n_pna:])
            # grid-side pressure at the interfaces (FFT soln + sigma_g field)
            bpl = v2l(bps + gp[n_pna:])
        single = len(self.helpers) == 1
        out = [h.correct(uvp, sg, sr, bu, bv, single)
               for h, uvp, sg, sr, bu, bv in
               zip(self.helpers, uvps, sig_gs, sig_rs, bul, bvl)]
        urs = [o[0] for o in out]
        vrs = [o[1] for o in out]
        prs = [o[2] for o in out]
        # Stokes pressure is only defined up to a constant PER REGION: the
        # annular and grid solves each pin their own; reconcile by matching
        # mean pressure across each interface (goes beyond the reference,
        # which leaves the mismatch: internals/vector.py:134-141 FIXME)
        prs = [pr + jnp.mean(bp - jnp.matmul(h.f_to_ifc, pr, precision=_HIGH))
               for h, pr, bp in zip(self.helpers, prs, bpl)]
        uc, vc, pc = ebdyc.interpolate_radial_to_grid_many(
            [urs, vrs, prs], [uc, vc, pc])
        uc, vc, pc = (uc * ebdyc.phys_dev, vc * ebdyc.phys_dev,
                      pc * ebdyc.phys_dev)
        return (EmbeddedFunction(uc, urs), EmbeddedFunction(vc, vrs),
                EmbeddedFunction(pc, prs)), stats

    def get_boundary_values(self, ue: EmbeddedFunction) -> BoundaryFunction:
        return BoundaryFunction(
            [jnp.matmul(h.f_to_bdy, fr, precision=_HIGH)
             for h, fr in zip(self.helpers, ue.radials)])

    def get_boundary_tractions(self, u, v, p):
        """Per-boundary (tx, ty) traction of (u, v, p) on the true boundary
        (reference: multi_boundary/vector.py get_boundary_tractions)."""
        out = []
        for h, ur, vr, pr in zip(self.helpers, u.radials, v.radials,
                                 p.radials):
            out.append(h.boundary_traction_uv(ur, vr, pr))
        return out
