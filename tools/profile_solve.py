"""Per-phase timing of the flagship Poisson solve at bench sizes.

Times each device phase separately (each call ends in block_until_ready)
and reports each phase's logical FLOP count (XLA lowered cost analysis --
f64 ops counted once) and the achieved GFLOP/s.

Usage:
    BENCH_NB=2700 BENCH_M=14 python tools/profile_solve.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def timeit(fn, *args, n=3):
    import jax
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3, out


def flops_of(jfn, *args):
    """Logical FLOPs of one call from the LOWERED (pre-optimization) XLA
    cost analysis: no second compile, and it counts f64 ops once each."""
    try:
        if hasattr(jfn, "inner"):
            lowered = jfn.inner.lower(jfn.plans, *args)
        else:
            lowered = jfn.lower(*args)
        ca = lowered.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return float(ca.get("flops", 0.0))
    except Exception as e:                     # pragma: no cover
        print(f"  (cost analysis failed: {type(e).__name__}: {e})",
              file=sys.stderr)
        return float("nan")


_ROWS = []


def report(name, jfn, *args, extra=""):
    ms, out = timeit(jfn, *args)
    fl = flops_of(jfn, *args)
    gfs = fl / (ms * 1e-3) / 1e9 if ms > 0 and fl == fl else float("nan")
    _ROWS.append((name, ms, fl, gfs))
    print(f"{name:<21}{ms:8.1f} ms  {fl/1e9:10.2f} GF {gfs:9.1f} GF/s "
          f"{extra}", flush=True)
    return out


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu.solvers.bie import DirichletBIE
    from ipde_tpu.solvers.scalar import PoissonSolver
    from ipde_tpu.utils.planify import planified

    nb = int(os.environ.get("BENCH_NB", 400))
    M = int(os.environ.get("BENCH_M", 14))
    sol = lambda x, y: -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)
    frc = lambda x, y: ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x)
                         - np.cos(x) ** 3) * np.exp(np.sin(x)) * np.sin(y))
    t0 = time.time()
    bdy = star(nb, a=0.2, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    if os.environ.get("BENCH_GRID"):
        tg = int(os.environ["BENCH_GRID"])
        extent = float(bdy.x.max() - bdy.x.min())
        bh = min(bh, extent / (tg - 3 * M))
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    t_geom = time.time() - t0
    ebdyc = EmbeddedBoundaryCollection([ebdy])
    grid = ebdyc.generate_grid(bh)
    t_reg = time.time() - t0 - t_geom
    f = EmbeddedFunction.from_function(ebdyc, frc)
    bc = BoundaryFunction.from_function(ebdyc, sol)
    t1 = time.time()
    solver = PoissonSolver(ebdyc)
    t_solver = time.time() - t1
    t1 = time.time()
    bie = DirichletBIE(solver)
    t_bie = time.time() - t1
    print(f"setup: geom {t_geom:.1f}s register {t_reg:.1f}s "
          f"solver {t_solver:.1f}s bie {t_bie:.1f}s grid={grid.shape} "
          f"pad={solver.grid_eval.Px // grid.Nx} "
          f"patchP={solver.grid_eval.patch_P} "
          f"device={jax.devices()[0].device_kind}", flush=True)

    h = solver.helpers[0]
    ge = solver.grid_eval
    S = ge.S
    q = jnp.asarray(np.random.default_rng(0).standard_normal(S))

    # 1. VG evaluator: full, fft-only, patches-only
    report("VG full apply", planified(lambda qq: ge(qq), solver), q)

    def fft_only(qq):
        from ipde_tpu.ops.cx import Cx
        spread = ge._spread(qq)
        c = ge.fft_plan.rfft2(spread)
        c = Cx(c.re * ge.mult, c.im * ge.mult)
        return ge.fft_plan.irfft2_real(c)[: grid.Nx, : grid.Ny]
    report("VG fft part", planified(fft_only, solver), q)

    def patches_only(qq):
        # patches are stored FLAT (S, P*P): see _patch_geometry
        return ge._apply_patches(
            [jnp.zeros(grid.shape)], [ge.patches * qq[:, None]])[0]
    report("VG patch scan", planified(patches_only, solver), q)

    # 2. grid fft solve
    def grid_solve(fg):
        from ipde_tpu.ops.cx import Cx
        fc = solver._prepare_grid_rhs(fg * ebdyc.grid_step_dev)
        modes = ebdyc.fft_plan.fft2(fc)
        return ebdyc.fft_plan.ifft2_real(
            Cx(modes.re * solver._symbol, modes.im * solver._symbol))
    report("grid fft solve", planified(grid_solve, solver), f.grid)

    # 3. interface interpolation (3-stack NUFFT)
    def ifc_interp(fg):
        from ipde_tpu.ops.cx import Cx
        modes = ebdyc.fft_plan.fft2(fg)
        kx, ky = ebdyc.kx_dev, ebdyc.ky_dev
        stack = Cx(jnp.stack([modes.re, -modes.im * kx, -modes.im * ky]),
                   jnp.stack([modes.im, modes.re * kx, modes.re * ky]))
        return ebdyc.interpolate_grid_to_interface_modes(stack)
    report("interface interp x3", planified(ifc_interp, solver), f.grid)

    # 3b. interp internals (fine iFFT vs gather+window contraction):
    # decides whether a tile-binned gather kernel is worth building
    def interp_breakdown(name, interp, nmx, nmy):
        from ipde_tpu.ops.interp import (HybridInterp2D,
                                         PeriodicInterpolator2D, _pad_modes,
                                         _pad_modes_half)
        from ipde_tpu.ops.cx import Cx
        if isinstance(interp, HybridInterp2D):
            rng = np.random.default_rng(0)
            mre = jnp.asarray(rng.standard_normal((nmx, nmy)))
            mim = jnp.asarray(rng.standard_normal((nmx, nmy)))
            report(f"{name} hybrid", planified(
                lambda re, im: interp._one_from_modes(Cx(re, im)), solver),
                mre, mim,
                extra=f"(T={interp.T} w={interp.w} nx={interp.nx})")
            return
        if not isinstance(interp, PeriodicInterpolator2D):
            print(f"{name}: exact-interp path (no fine grid)")
            return
        p = interp.plan
        rng = np.random.default_rng(0)
        mre = jnp.asarray(rng.standard_normal((nmx, nmy)))
        mim = jnp.asarray(rng.standard_normal((nmx, nmy)))

        def fine_part(re, im):
            cd = Cx(re * p.deconv, im * p.deconv)
            if p.nx % 2 == 0:
                cp = _pad_modes_half(cd, p.nx, p.ny, p.nfx, p.nfy)
                return interp.fine_plan.irfft2_real(cp)
            cp = _pad_modes(cd, p.nx, p.ny, p.nfx, p.nfy)
            return interp.fine_plan.ifft2_real(cp)

        fine = report(f"{name} fine iFFT", planified(fine_part, solver),
                      mre, mim, extra=f"(fine {p.nfx}x{p.nfy})")

        def gather_part(fg):
            patches = jnp.take(fg.ravel(), p.flat_idx, axis=0)
            patches = patches.reshape(interp.T, interp.w, interp.w)
            return jnp.einsum("tp,tq,tpq->t", p.wx, p.wy, patches,
                              precision=jax.lax.Precision.HIGHEST)

        report(f"{name} gather+win", planified(gather_part, solver), fine, extra=f"(T={interp.T} w={interp.w})")

    interp_breakdown("ifc-interp", ebdyc.interface_interp, grid.Nx, grid.Ny)
    interp_breakdown("radial->grid", ebdyc.radial_to_grid_plans[0],
                     2 * ebdy.M, ebdy.bdy.N)

    # 4. annular solve
    zero = jnp.zeros(ebdy.bdy.N)
    def annular(fr):
        u, st = h.annular_solver.solve_with_stats(
            h.metric, fr, zero, zero, tol=1e-12, maxiter=100, restart=30)
        return u, st
    u_ann, st = report("annular GMRES", planified(annular, solver),
                       f.radials[0])
    print(f"  iters={int(st['iterations'])}")

    # 5. QFS densities (2 matmuls x 2)
    bvals = jnp.asarray(np.random.standard_normal(nb))
    def qfs(bv):
        return h.qfs_g([bv, bv]), h.qfs_r([bv, bv])
    report("QFS g+r apply", planified(qfs, solver), bvals)

    # 6. correct: u2s + radial dense apply
    sg = jnp.asarray(np.random.standard_normal(h.grid_source.N))
    sr = jnp.asarray(np.random.standard_normal(h.radial_source.N))
    def correct(sg_, sr_):
        return h.correct(solver, u_ann, sg_, sr_, bvals)
    report("correct (radial)", planified(correct, solver), sg, sr)

    # 7. radial -> grid merge
    def r2g(fr):
        return ebdyc.interpolate_radial_to_grid([fr], jnp.zeros(grid.shape))
    report("radial->grid", planified(r2g, solver), u_ann)

    # 8. interface dense apply (merged sigma_g -> interfaces)
    def ifc_dense(sg_):
        return solver._apply_merged(sg_, ebdyc.all_interface_x_dev,
                                    ebdyc.all_interface_y_dev)
    report("sigma_g->interfaces", planified(ifc_dense, solver), q)

    # 9. BIE apply_bc
    run_bie = planified(lambda g, r: bie.apply_bc(
        EmbeddedFunction(g, [r]), bc).grid, solver, bie)
    report("BIE apply_bc", run_bie, f.grid, u_ann)

    # full solve for reference
    run = planified(lambda g, r: bie.apply_bc(
        solver(EmbeddedFunction(g, [r]), tol=1e-12, maxiter=100, restart=30),
        bc).grid, solver, bie)
    report("FULL solve", run, f.grid, f.radials[0])


if __name__ == "__main__":
    main()
