"""Per-phase timing of the flagship STOKES solve at bench sizes .

The Stokes twin of tools/profile_solve.py: times the phases of the
bench.py north-star configuration (BENCH_NB/BENCH_M envs); every timed
call ends in block_until_ready.  Coarse phases use public APIs so the tool survives
refactors:
    VG Stokeslet apply / annular Stokes GMRES / solver-only /
    BIE apply_bc / FULL solve
Usage:  BENCH_NB=2700 BENCH_M=20 python tools/profile_stokes.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_solve import timeit  # noqa: E402  (same directory)


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu.solvers.bie import StokesDirichletBIE
    from ipde_tpu.solvers.vector import StokesSolver
    from ipde_tpu.utils.planify import planified

    nb = int(os.environ.get("BENCH_NB", 400))
    M = int(os.environ.get("BENCH_M", 14))
    usol = lambda x, y: np.sin(x) * np.cos(y) + 0.2 * np.cos(2 * y)
    vsol = lambda x, y: -np.cos(x) * np.sin(y) + 0.1 * np.sin(2 * x)
    fuf = lambda x, y: (2 * np.sin(x) * np.cos(y) + 0.8 * np.cos(2 * y)
                        - np.sin(x) * np.sin(y))
    fvf = lambda x, y: (-2 * np.cos(x) * np.sin(y) + 0.4 * np.sin(2 * x)
                        + np.cos(x) * np.cos(y))
    t0 = time.time()
    bdy = star(nb, a=0.2, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    if os.environ.get("BENCH_BH"):
        bh = min(bh, float(os.environ["BENCH_BH"]))
    elif os.environ.get("BENCH_GRID"):
        # same grid-target sizing as bench.py run_config
        tg = int(os.environ["BENCH_GRID"])
        extent = float(bdy.x.max() - bdy.x.min())
        bh = min(bh, extent / (tg - 3 * M))
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    ebdyc = EmbeddedBoundaryCollection([ebdy])
    grid = ebdyc.generate_grid(bh)
    t_geom = time.time() - t0
    fu = EmbeddedFunction.from_function(ebdyc, fuf)
    fv = EmbeddedFunction.from_function(ebdyc, fvf)
    bc_u = BoundaryFunction.from_function(ebdyc, usol)
    bc_v = BoundaryFunction.from_function(ebdyc, vsol)
    t1 = time.time()
    solver = StokesSolver(ebdyc)
    t_solver = time.time() - t1
    t1 = time.time()
    bie = StokesDirichletBIE(solver)
    t_bie = time.time() - t1
    print(f"setup: geom+register {t_geom:.1f}s solver {t_solver:.1f}s "
          f"bie {t_bie:.1f}s grid={grid.shape} "
          f"device={jax.devices()[0].device_kind}", flush=True)


    h = solver.helpers[0]

    # 1. VG Stokeslet evaluator (sigma_g -> grid velocities + pressure)
    ge = solver.grid_eval
    if ge is not None:
        S2 = 2 * solver.src_Ns[0]
        qf = jnp.asarray(np.random.default_rng(0).standard_normal(S2))
        vg = planified(lambda q: ge(q[:S2 // 2], q[S2 // 2:]), solver)
        ms, _ = timeit(vg, qf)
        print(f"VG Stokeslet apply   {ms:8.1f} ms", flush=True)

    # 2. annular Stokes GMRES
    zero = jnp.zeros(ebdy.bdy.N)
    fr = jnp.asarray(fu.radials[0])
    def annular(fr_):
        (ur, ut, p), st = h.annular_solver.solve_with_stats(
            h.metric, fr_, fr_, zero, zero, zero, zero,
            tol=1e-12, maxiter=100, restart=30)
        return ur, st
    ms, (_, st) = timeit(planified(annular, solver), fr)
    print(f"annular Stokes GMRES {ms:8.1f} ms  "
          f"iters={int(st['iterations'])}", flush=True)

    # 2b. finer solver internals: box solve, interface stack, correct,
    # radial->grid merge (the profile's "unaccounted" band)
    from ipde_tpu.ops.cx import Cx
    ebc = ebdyc
    plan = ebc.fft_plan
    kx, ky = ebc.kx_dev, ebc.ky_dev

    def box_solve(g1, g2):
        fuc = ebc.demean_function(g1 * ebc.grid_step_dev)
        fvc = ebc.demean_function(g2 * ebc.grid_step_dev)
        fuh, fvh = plan.fft2_stack([fuc, fvc])
        mul_ik = lambda c, k: Cx(-c.im * k, c.re * k)
        ph = Cx((mul_ik(fuh, kx).re + mul_ik(fvh, ky).re) * solver.ilap,
                (mul_ik(fuh, kx).im + mul_ik(fvh, ky).im) * solver.ilap)
        uh = Cx((mul_ik(ph, kx).re - fuh.re) * solver.ilap,
                (mul_ik(ph, kx).im - fuh.im) * solver.ilap)
        vh = Cx((mul_ik(ph, ky).re - fvh.re) * solver.ilap,
                (mul_ik(ph, ky).im - fvh.im) * solver.ilap)
        outs = plan.ifft2_real_stack([uh, vh, ph])
        return outs[0], uh, vh, ph

    jb = planified(box_solve, solver)
    ms, (_, uh, vh, ph) = timeit(jb, fu.grid, fv.grid)
    print(f"box solve            {ms:8.1f} ms", flush=True)

    def ifc_stack(uhr, uhi, vhr, vhi, phr, phi_):
        stack3 = Cx(jnp.stack([uhr, vhr, phr]),
                    jnp.stack([uhi, vhi, phi_]))
        return ebc.interface_values_and_grads(stack3)

    ji = planified(ifc_stack, solver)
    ms, _ = timeit(ji, uh.re, uh.im, vh.re, vh.im, ph.re, ph.im)
    print(f"interface vals+grad  {ms:8.1f} ms", flush=True)

    # densities (traction + QFS applies) on dummy annular output
    zr = jnp.asarray(
        np.random.default_rng(1).standard_normal(fu.radials[0].shape))
    def dens(rr):
        uvp, sg, sr = h.densities((rr, rr, rr), zero, zero, zero, zero,
                                  zero)
        return sg
    jd = planified(dens, solver)
    ms, _ = timeit(jd, zr)
    print(f"densities+QFS        {ms:8.1f} ms", flush=True)

    # correct: stratified radial apply + u2s
    sgN = 2 * solver.src_Ns[0]
    sg0 = jnp.asarray(np.random.default_rng(2).standard_normal(sgN))
    srN = 2 * h.radial_source.N
    sr0 = jnp.asarray(np.random.default_rng(3).standard_normal(srN))
    def corr(rr, sg, sr):
        return h.correct((rr, rr, rr), sg, sr, zero, zero, True)[0]
    jc = planified(corr, solver)
    ms, _ = timeit(jc, zr, sg0, sr0)
    print(f"correct (radial)     {ms:8.1f} ms", flush=True)

    # radial -> grid merge x3
    def merge(g1, rr):
        a = ebc.interpolate_radial_to_grid([rr], g1)
        b = ebc.interpolate_radial_to_grid([rr], g1)
        c_ = ebc.interpolate_radial_to_grid([rr], g1)
        return a + b + c_
    jm = planified(merge, solver)
    ms, _ = timeit(jm, fu.grid, zr)
    print(f"radial->grid x3      {ms:8.1f} ms", flush=True)

    # 3. solver-only inhomogeneous solve
    def solver_only(g1, r1, g2, r2):
        (u, v, p), st = solver.solve_with_stats(
            EmbeddedFunction(g1, [r1]), EmbeddedFunction(g2, [r2]),
            tol=1e-12, maxiter=100, restart=30)
        return u.grid, st["annular_iterations"]
    ms, _ = timeit(planified(solver_only, solver), fu.grid, fu.radials[0],
                   fv.grid, fv.radials[0])
    print(f"solver only          {ms:8.1f} ms", flush=True)

    # 4. BIE apply_bc on a solved field
    (u0, v0, p0), _ = solver.solve_with_stats(fu, fv, tol=1e-12,
                                              maxiter=100, restart=30)
    run_bie = planified(
        lambda ug, ur, vg, vr, pg, prr: bie.apply_bc(
            EmbeddedFunction(ug, [ur]), EmbeddedFunction(vg, [vr]),
            EmbeddedFunction(pg, [prr]), bc_u, bc_v)[0].grid,
        solver, bie)
    ms, _ = timeit(run_bie, u0.grid, u0.radials[0], v0.grid, v0.radials[0],
                   p0.grid, p0.radials[0])
    print(f"BIE apply_bc         {ms:8.1f} ms", flush=True)

    # 5. FULL solve
    def full(g1, r1, g2, r2):
        (u, v, p), _ = solver.solve_with_stats(
            EmbeddedFunction(g1, [r1]), EmbeddedFunction(g2, [r2]),
            tol=1e-12, maxiter=100, restart=30)
        u, v, p = bie.apply_bc(u, v, p, bc_u, bc_v)
        return u.grid
    ms, _ = timeit(planified(full, solver, bie), fu.grid, fu.radials[0],
                   fv.grid, fv.radials[0])
    print(f"FULL solve           {ms:8.1f} ms", flush=True)


if __name__ == "__main__":
    main()
