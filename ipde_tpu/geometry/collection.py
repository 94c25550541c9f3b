"""EmbeddedBoundaryCollection: the multi-boundary embedded domain.

Redesign of the reference's EmbeddedBoundaryCollection
(reference: ipde/ebdy_collection.py:230-829).  Host numpy builds all masks,
index sets and interpolation plans once per (geometry, grid); the device-side
state is a set of fixed-shape jnp arrays + plans that the jitted solvers
consume.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ipde_tpu.functions import EmbeddedFunction
from ipde_tpu.geometry.curve import BoundaryCurve
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary, load_embedded_boundary
from ipde_tpu.geometry.grid import Grid
from ipde_tpu.ops.cx import Cx
from ipde_tpu.ops.fourier import FourierPlan2D
from ipde_tpu.ops.interp import (PeriodicInterpolator2D, PolyInterpolator2D,
                                 make_interpolator)

_HIGH = jax.lax.Precision.HIGHEST


def grid_inside_mask(bdy: BoundaryCurve, grid: Grid) -> np.ndarray:
    """Even-odd inside mask on the full uniform grid via scanline crossings
    of a refined polyline (O(Nx*Ny + n_segments * rows-per-segment))."""
    ups = bdy.resampled(max(8 * bdy.N, 1024))
    xs, ys = ups.x, ups.y
    xe, ye = np.roll(xs, -1), np.roll(ys, -1)
    Nx, Ny = grid.Nx, grid.Ny
    diff = np.zeros((Nx + 1, Ny), dtype=np.int64)
    # rows (y values) each segment crosses
    ylo = np.minimum(ys, ye)
    yhi = np.maximum(ys, ye)
    j0 = np.searchsorted(grid.yv, ylo, side="left")
    j1 = np.searchsorted(grid.yv, yhi, side="left")
    for s in range(xs.size):
        a, b = j0[s], j1[s]
        if a == b:
            continue
        jj = np.arange(a, b)
        yc = grid.yv[jj]
        xc = xs[s] + (yc - ys[s]) * (xe[s] - xs[s]) / (ye[s] - ys[s])
        ii = np.searchsorted(grid.xv, xc, side="right")
        np.add.at(diff, (ii, jj), 1)
    # point (i, j) is inside iff the number of crossings at x > xv[i] is odd
    counts = np.cumsum(diff[::-1], axis=0)[::-1][1:]
    return (counts % 2) == 1


def _cap(n: int, quantum: int) -> int:
    """Smallest multiple of ``quantum`` >= max(n, 1)."""
    return int(-(-max(n, 1) // quantum) * quantum)


def _pad_repeat(a: np.ndarray, pad: int) -> np.ndarray:
    """Pad with repeats of the first element (or 0 when empty)."""
    fill = a[0] if a.size else 0.0
    return np.concatenate([a, np.full(pad, fill, a.dtype)])


class EmbeddedBoundaryCollection:
    def __init__(self, ebdys: Sequence[EmbeddedBoundary]):
        self.ebdys = list(ebdys)
        self.N = len(self.ebdys)
        self.grid = None
        self.bump_location = None
        self.bumpy = None

    def __iter__(self):
        return iter(self.ebdys)

    def __getitem__(self, i):
        return self.ebdys[i]

    def __len__(self):
        return self.N

    # ------------------------------------------------------------------
    def generate_grid(self, h: Optional[float] = None,
                      danger_zone_distance: float = 0.0,
                      pad_quantum: Optional[int] = None) -> Grid:
        """Auto-generate the background box: the first boundary must be the
        interior one; pad by one radial width, plus bump room at the top
        right (reference: ipde/ebdy_collection.py:280-341)."""
        ie = self.ebdys[0]
        if not ie.interior:
            raise ValueError("generate_grid requires the first boundary to "
                             "be interior")
        if h is None:
            h = ie.h
        cheat = ie.radial_width
        xmin = ie.bdy.x.min() - cheat
        ymin = ie.bdy.y.min() - cheat
        xmax = ie.bdy.x.max() + 2 * cheat
        ymax = ie.bdy.y.max() + 2 * cheat
        self.bump_location = (ie.bdy.x.max() + cheat, ie.bdy.y.max() + cheat)
        # round up to multiples of 32: richly factorable
        # for the four-step matmul FFT (extra room just pads the cheat space)
        Nx = int(32 * np.ceil((xmax - xmin) / h / 32))
        Ny = int(32 * np.ceil((ymax - ymin) / h / 32))
        grid = Grid([xmin, xmin + Nx * h], Nx, [ymin, ymin + Ny * h], Ny)
        self.register_grid(grid, danger_zone_distance=danger_zone_distance,
                           pad_quantum=pad_quantum)
        return grid

    # ------------------------------------------------------------------
    def register_grid(self, grid: Grid, danger_zone_distance: float = 0.0,
                      verbose: bool = False,
                      pad_quantum: Optional[int] = None):
        """pad_quantum: when set, every VARIABLE-SIZE point set this
        registration produces (pna = physical-not-in-annulus points, and
        each boundary's in-annulus grid point set) is capacity-padded to
        the next multiple of pad_quantum.  Padded slots carry an
        out-of-range flat index (dropped by XLA scatter, jax's default
        FILL_OR_DROP mode) and a repeat of the first real coordinate.
        Successive registrations of a MOVING boundary then produce plan
        arrays with IDENTICAL shapes, so jitted solves/advections are
        re-executed (utils.planify.replan) instead of recompiled -- the
        difference between a launch and a full recompile per timestep.
        (Reference analogue: none; the reference is eager numpy,
        ipde/advection/fe_advector.py:60-71 rebuilds everything.)"""
        self.grid = grid
        self.pad_quantum = pad_quantum
        regs = [e.register_grid(grid, danger_zone_distance, verbose)
                for e in self.ebdys]
        self.regs = regs

        # physical mask: intersection over boundaries; near-curve points are
        # classified exactly by the sign of their radial coordinate
        phys = np.ones(grid.shape, dtype=bool)
        for e, reg in zip(self.ebdys, regs):
            inside = grid_inside_mask(e.bdy, grid)
            inside[reg.near_ix, reg.near_iy] = reg.near_r < 0
            phys &= inside if e.interior else ~inside
        self.phys = phys
        self.ext = ~phys
        self.phys_n = int(phys.sum())

        # in-annulus mask and phys-not-annulus
        ia = np.zeros(grid.shape, dtype=bool)
        overlap = 0
        for reg in regs:
            overlap += int(ia[reg.ia_ix, reg.ia_iy].sum())
            ia[reg.ia_ix, reg.ia_iy] = True
        if overlap:
            import warnings
            warnings.warn(
                f"{overlap} grid points lie in MORE THAN ONE boundary's "
                "annulus: the radial strips overlap and the solve will be "
                "silently wrong.  Reduce M (strip width = M*h) or separate "
                "the boundaries.")
        self.in_annulus = ia
        self.phys_not_in_annulus = phys & ~ia
        self.pna_flat = np.flatnonzero(self.phys_not_in_annulus)
        self.pna_x = grid.xg[self.phys_not_in_annulus]
        self.pna_y = grid.yg[self.phys_not_in_annulus]
        if pad_quantum:
            sentinel = grid.Nx * grid.Ny   # out of range -> scatter drops
            pad = _cap(self.pna_flat.size, pad_quantum) - self.pna_flat.size
            self.pna_flat = np.concatenate(
                [self.pna_flat, np.full(pad, sentinel, self.pna_flat.dtype)])
            self.pna_x = _pad_repeat(self.pna_x, pad)
            self.pna_y = _pad_repeat(self.pna_y, pad)
        # device mirrors (plan arrays: hoisted here so jitted solves see
        # arguments, not trace-time constants)
        self.pna_flat_dev = jnp.asarray(self.pna_flat, jnp.int32)
        self.pna_x_dev = jnp.asarray(self.pna_x)
        self.pna_y_dev = jnp.asarray(self.pna_y)

        # smoothed step: 1 deep inside, rolls to 0 through each annulus
        gs = phys.astype(np.float64)
        for reg in regs:
            gs[reg.ia_ix, reg.ia_iy] *= reg.grid_to_radial_step
        self.grid_step = gs
        self.grid_step_dev = jnp.asarray(gs)
        self.phys_dev = jnp.asarray(phys)

        # Fourier operators for the box
        self.kx = np.fft.fftfreq(grid.Nx, grid.xh / (2 * np.pi))[:, None]
        self.ky = np.fft.fftfreq(grid.Ny, grid.yh / (2 * np.pi))[None, :]
        self.lap = -self.kx**2 - self.ky**2
        self.fft_plan = FourierPlan2D(grid.Nx, grid.Ny)
        self.kx_dev = jnp.asarray(self.kx)
        self.ky_dev = jnp.asarray(self.ky)

        # transformed coordinates (box -> [0, 2pi)^2) for spectral interp
        def transf(x, y):
            tx = (np.asarray(x) - grid.x_bounds[0]) / grid.x_period * 2 * np.pi
            ty = (np.asarray(y) - grid.y_bounds[0]) / grid.y_period * 2 * np.pi
            return tx, ty
        self.transf = transf

        # interface interpolation plan (all interfaces concatenated)
        ifx = np.concatenate([e.interface.x for e in self.ebdys])
        ify = np.concatenate([e.interface.y for e in self.ebdys])
        self.all_interface_x = ifx
        self.all_interface_y = ify
        self.all_interface_x_dev = jnp.asarray(ifx)
        self.all_interface_y_dev = jnp.asarray(ify)
        tx, ty = transf(ifx, ify)
        self.interface_interp = make_interpolator(grid.Nx, grid.Ny, tx, ty)
        self.bdy_Ns = [e.bdy.N for e in self.ebdys]
        self.splits = np.cumsum(self.bdy_Ns)[:-1].tolist()

        # radial -> grid interpolation plans (Chebyshev reflection NUFFT)
        self.radial_to_grid_plans = []
        self.ia_flat_list = []
        for e, reg in zip(self.ebdys, regs):
            ia_r, ia_t = reg.ia_r, reg.ia_t
            ia_flat = reg.ia_ix * grid.Ny + reg.ia_iy
            if pad_quantum:
                pad = _cap(ia_r.size, pad_quantum) - ia_r.size
                ia_r = _pad_repeat(ia_r, pad)
                ia_t = _pad_repeat(ia_t, pad)
                ia_flat = np.concatenate(
                    [ia_flat,
                     np.full(pad, grid.Nx * grid.Ny, ia_flat.dtype)])
            theta = e.nufft_theta(ia_r)
            plan = make_interpolator(2 * e.M, e.bdy.N, theta, ia_t,
                                     x_offset=np.pi / (2 * e.M))
            self.radial_to_grid_plans.append(plan)
            self.ia_flat_list.append(jnp.asarray(ia_flat, jnp.int32))

        # aggregated point sets (host coordinates) used by the solvers
        self.radial_x_list = [e.radial_x.ravel() for e in self.ebdys]
        self.radial_y_list = [e.radial_y.ravel() for e in self.ebdys]
        self.bumpy = None

    def phys_extremes(self) -> np.ndarray:
        """(K, 2) superset of the physical region's convex-hull vertices
        (per-column extremal phys points; every hull vertex of a gridded
        point set is a column extreme).  Used to compute EXACT maximum
        target-source distances for the free-space evaluators' truncation
        radius -- the bounding-box corners overestimate it by up to ~40%
        for star domains, often costing a whole FFT padding factor."""
        cached = getattr(self, "_phys_extremes", None)
        if cached is not None:
            return cached
        phys = self.phys
        g = self.grid
        cols = np.flatnonzero(phys.any(axis=1))
        iy_min = np.argmax(phys[cols], axis=1)
        iy_max = phys.shape[1] - 1 - np.argmax(phys[cols, ::-1], axis=1)
        pts = np.concatenate([
            np.stack([g.xv[cols], g.yv[iy_min]], axis=1),
            np.stack([g.xv[cols], g.yv[iy_max]], axis=1)])
        try:
            from scipy.spatial import ConvexHull
            pts = pts[ConvexHull(pts).vertices]
        except Exception:
            pass
        self._phys_extremes = pts
        return pts

    # ------------------------------------------------------------------
    # interpolation operations (device)
    # ------------------------------------------------------------------
    def v2l(self, v):
        """Split concatenated boundary-length vector into per-boundary."""
        return jnp.split(v, self.splits)

    def interpolate_grid_to_interface_modes(self, modes: Cx):
        """Interpolate (stacked) fft2 mode arrays to all interface points."""
        return self.interface_interp.from_modes(modes)

    def interface_values_and_grads(self, modes: Cx):
        """Values AND physical-coordinate gradients of the (B, nx, ny) mode
        stack at all interface points.

        Fast path: the interpolation plan's window-derivative evaluation
        (ops/interp.from_modes_grad) -- ONE fine transform + gather per
        field, with the x/y derivatives as two extra weight reductions,
        instead of interpolating three ik-multiplied mode stacks (the 7-
        field Stokes interface stack measured 62.5 ms at tier-1 this way).
        IPDE_IFC_GRAD=0, or a plan without grad support, falls back to the
        ik-mode route.  Returns (vals, ddx, ddy), each (B, T)."""
        import os
        ii = self.interface_interp
        use_grad = (os.environ.get("IPDE_IFC_GRAD", "1").strip() != "0"
                    and hasattr(ii, "from_modes_grad"))
        if use_grad:
            vals, dtx, dty = ii.from_modes_grad(modes)
            sx = 2.0 * np.pi / self.grid.x_period
            sy = 2.0 * np.pi / self.grid.y_period
            return vals, dtx * sx, dty * sy
        kx, ky = self.kx_dev, self.ky_dev
        big = Cx(
            jnp.concatenate([modes.re, -modes.im * kx, -modes.im * ky]),
            jnp.concatenate([modes.im, modes.re * kx, modes.re * ky]))
        out = ii.from_modes(big)
        B = modes.re.shape[0]
        return out[:B], out[B:2 * B], out[2 * B:]

    def interpolate_grid_to_interface(self, f):
        return self.interface_interp(f)

    def interpolate_radial_to_grid(self, radials, grid_vals):
        """Scatter radial-grid functions onto their in-annulus grid points.
        radials: list of (M, N_b) arrays; grid_vals: (Nx, Ny); returns
        updated grid_vals."""
        flat = grid_vals.ravel()
        for e, plan, idx, fr in zip(self.ebdys, self.radial_to_grid_plans,
                                    self.ia_flat_list, radials):
            refl = jnp.concatenate([fr, fr[::-1]], axis=0)
            vals = plan(refl)
            flat = flat.at[idx].set(vals)
        return flat.reshape(grid_vals.shape)

    def interpolate_radial_to_grid_many(self, radials_list, grid_vals_list):
        """Batched interpolate_radial_to_grid for F fields at once.

        radials_list: per-field lists of per-boundary (M, N_b) radials;
        grid_vals_list: F grid arrays.  The per-boundary interpolation
        plans evaluate all F fields in ONE pass (shared row-gathers /
        phase matmuls; see ops/interp._many_from_modes), which measures
        ~3x cheaper than F separate passes at bench sizes."""
        F = len(grid_vals_list)
        flats = [g.ravel() for g in grid_vals_list]
        shapes = [g.shape for g in grid_vals_list]
        for b, (plan, idx) in enumerate(zip(self.radial_to_grid_plans,
                                            self.ia_flat_list)):
            refls = jnp.stack(
                [jnp.concatenate([radials_list[f][b], radials_list[f][b][::-1]],
                                 axis=0) for f in range(F)])
            vals = plan(refls)                      # (F, T)
            flats = [fl.at[idx].set(v) for fl, v in zip(flats, vals)]
        return [fl.reshape(s) for fl, s in zip(flats, shapes)]

    def interpolate_radial_to_boundary(self, radials):
        return [jnp.matmul(jnp.asarray(e.interp_f_to_bdy), fr, precision=_HIGH)
                for e, fr in zip(self.ebdys, radials)]

    # ------------------------------------------------------------------
    # bump de-meaning (Poisson solvability on the periodic box)
    # ------------------------------------------------------------------
    def ready_bump(self, bump_loc=None, bump_width=None):
        """Normalized compactly-supported bump used to remove the mean of
        the extended forcing (reference: ipde/ebdy_collection.py:796-810)."""
        if bump_width is None:
            bump_width = self.ebdys[0].radial_width
        if bump_loc is None:
            bump_loc = self.bump_location
        if bump_loc is None:
            raise ValueError("no bump location available")
        mol = self.ebdys[0].mollifier
        rr = np.hypot(self.grid.xg - bump_loc[0], self.grid.yg - bump_loc[1])
        bumpy = mol.bump(rr / bump_width)
        integral = bumpy.sum() * self.grid.xh * self.grid.yh
        self.bumpy = jnp.asarray(bumpy / integral)

    def demean_function(self, f):
        f_int = jnp.sum(f) * (self.grid.xh * self.grid.yh)
        return f - f_int * self.bumpy

    # ------------------------------------------------------------------
    # calculus on EmbeddedFunctions
    # ------------------------------------------------------------------
    def gradient(self, ef: EmbeddedFunction, derivative_type: str = "spectral"):
        """Gradient: spectral (FFT) or 4th-order FD on the grid; exact
        curvilinear derivatives on the radial grids (reference:
        ipde/ebdy_collection.py:711-753)."""
        fc = ef.grid * self.grid_step_dev
        if derivative_type == "spectral":
            c = self.fft_plan.fft2(fc)
            fx = self.fft_plan.ifft2_real(
                Cx(-c.im * self.kx_dev, c.re * self.kx_dev))
            fy = self.fft_plan.ifft2_real(
                Cx(-c.im * self.ky_dev, c.re * self.ky_dev))
        elif derivative_type == "fourth":
            from ipde_tpu.ops.fd import fd_x_4, fd_y_4
            fx = fd_x_4(fc, self.grid.xh)
            fy = fd_y_4(fc, self.grid.yh)
        else:
            raise ValueError(derivative_type)
        fxrs, fyrs = [], []
        for e, fr in zip(self.ebdys, ef.radials):
            fxr, fyr = self._radial_gradient(e, fr)
            fxrs.append(fxr)
            fyrs.append(fyr)
        fx, fy = self.interpolate_radial_to_grid_many([fxrs, fyrs], [fx, fy])
        fx = fx * self.phys_dev
        fy = fy * self.phys_dev
        return (EmbeddedFunction(fx, fxrs), EmbeddedFunction(fy, fyrs))

    def laplacian(self, ef: EmbeddedFunction,
                  derivative_type: str = "spectral") -> EmbeddedFunction:
        """Laplacian; grid part spectral or 4th-order FD, radial part via the
        curvilinear metric lap u = u_rr + (psi_r/psi) u_r +
        (1/psi) d_t(u_t / psi) (reference: ipde/ebdy_collection.py:754-792,
        embedded_boundary.py:478-517)."""
        fc = ef.grid * self.grid_step_dev
        if derivative_type == "spectral":
            c = self.fft_plan.fft2(fc)
            lap = jnp.asarray(self.lap)
            fl = self.fft_plan.ifft2_real(Cx(c.re * lap, c.im * lap))
        elif derivative_type == "fourth":
            from ipde_tpu.ops.fd import fd_xx_4, fd_yy_4
            fl = fd_xx_4(fc, self.grid.xh) + fd_yy_4(fc, self.grid.yh)
        else:
            raise ValueError(derivative_type)
        flrs = [self._radial_laplacian(e, fr)
                for e, fr in zip(self.ebdys, ef.radials)]
        fl = self.interpolate_radial_to_grid(flrs, fl) * self.phys_dev
        return EmbeddedFunction(fl, flrs)

    def interpolate_grid_to_radial(self, f, order: int = 3):
        """Interpolate a (smooth-everywhere!) grid function onto each radial
        grid by periodic polynomial interpolation (reference:
        ipde/ebdy_collection.py:630-648; useful for initialization only --
        the grid function must be smooth across the boundaries)."""
        from ipde_tpu.ops.interp import PolyInterpolator2D
        g = self.grid
        out = []
        for e in self.ebdys:
            interp = PolyInterpolator2D(
                g.x_bounds[0], g.y_bounds[0], g.xh, g.yh, g.Nx, g.Ny,
                e.radial_x.ravel(), e.radial_y.ravel(), order=order)
            out.append(interp(jnp.asarray(f)).reshape(e.radial_shape))
        return out

    def _radial_gradient(self, e: EmbeddedBoundary, fr):
        from ipde_tpu.ops.fourier import FourierPlan1D
        plan = FourierPlan1D(e.bdy.N)
        ft = plan.tderiv(fr) * jnp.asarray(e.inverse_radial_speed)
        frr = jnp.matmul(jnp.asarray(e.D00), fr, precision=_HIGH)
        nx = jnp.asarray(e.bdy.normal_x)
        ny = jnp.asarray(e.bdy.normal_y)
        tx = jnp.asarray(e.bdy.tangent_x)
        ty = jnp.asarray(e.bdy.tangent_y)
        return frr * nx + ft * tx, frr * ny + ft * ty

    def _radial_laplacian(self, e: EmbeddedBoundary, fr):
        from ipde_tpu.ops.fourier import FourierPlan1D
        plan = FourierPlan1D(e.bdy.N)
        D00 = jnp.asarray(e.D00)
        psi = jnp.asarray(e.radial_speed)            # (M, n)
        ipsi = jnp.asarray(e.inverse_radial_speed)
        psi_r = jnp.asarray(e.bdy.speed * e.bdy.curvature)   # (n,)
        u_r = jnp.matmul(D00, fr, precision=_HIGH)
        u_rr = jnp.matmul(D00, u_r, precision=_HIGH)
        u_t = plan.tderiv(fr)
        return u_rr + psi_r * ipsi * u_r + ipsi * plan.tderiv(u_t * ipsi)

    def volume_integral(self, ef: EmbeddedFunction) -> float:
        val = float(jnp.sum(ef.grid * self.grid_step_dev)
                    * self.grid.xh * self.grid.yh)
        for e, fr in zip(self.ebdys, ef.radials):
            val += e.radial_integral(np.asarray(fr))
        return val

    # ------------------------------------------------------------------
    def save(self) -> dict:
        return {"ebdys": [e.save() for e in self.ebdys]}


def load_collection(d: dict) -> EmbeddedBoundaryCollection:
    return EmbeddedBoundaryCollection(
        [load_embedded_boundary(e) for e in d["ebdys"]])
