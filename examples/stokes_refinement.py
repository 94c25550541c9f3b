"""3-body Stokes refinement study: regenerates the reference's paper
figure/ledger (reference: examples/multi_stokes_for_paper.py:247-249 --
max rel err 2.5864e-01 @ nb=100, 4.8345e-07 @ 400, 3.3441e-10 @ 700,
7.5079e-10 plateau @ 1000).

Geometry: star-shaped outer boundary with two star-shaped inclusions
(same family as the reference's squished-circle + stars; the comparison
is max abs error at matched OUTER boundary resolution, inclusions at
half the points -- strictly fewer dof than the reference's).  Results are
appended to LEDGER.json under "stokes_refinement".

Usage:
    python examples/stokes_refinement.py          # default sweep
    STOKES_NBS="100,8 400,12" python examples/stokes_refinement.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_case(nb, M, tol=1e-12):
    import jax
    import jax.numpy as jnp
    from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu.solvers.bie import StokesDirichletBIE
    from ipde_tpu.solvers.vector import StokesSolver
    from ipde_tpu.utils.planify import planified

    usol = lambda x, y: np.sin(x) * np.cos(y) + 0.2 * np.cos(2 * y)
    vsol = lambda x, y: -np.cos(x) * np.sin(y) + 0.1 * np.sin(2 * x)
    fu = lambda x, y: (2 * np.sin(x) * np.cos(y) + 0.8 * np.cos(2 * y)
                       - np.sin(x) * np.sin(y))
    fv = lambda x, y: (-2 * np.cos(x) * np.sin(y) + 0.4 * np.sin(2 * x)
                       + np.cos(x) * np.cos(y))

    t0 = time.time()
    outer = star(nb, a=0.1, f=3)
    # cap the strip width so the three annuli stay disjoint even at the
    # coarsest nb (inclusion gaps ~0.35; M*bh <= 0.16 keeps them apart)
    bh = min(outer.min_h(), 0.6 / np.abs(outer.curvature).max() / M,
             0.16 / M)
    Mi = max(M // 2 + 2, 6)     # inclusion strips: disjoint annuli
    # inclusion resolution: default half the outer boundary's (strictly
    # fewer dof than the reference's equal-nb bodies); STOKES_NBI_FACTOR=1
    # matches the reference's resolution
    fac = float(os.environ.get("STOKES_NBI_FACTOR", "0.5"))
    nbi = max(int(nb * fac), 64)
    e0 = EmbeddedBoundary(outer, True, M, bh)
    e1 = EmbeddedBoundary(star(nbi, x=0.3, y=0.18, r=0.16, a=0.05, f=4),
                          False, Mi, bh)
    e2 = EmbeddedBoundary(star(nbi, x=-0.28, y=-0.22, r=0.15, a=0.05, f=3),
                          False, Mi, bh)
    ebdyc = EmbeddedBoundaryCollection([e0, e1, e2])
    grid = ebdyc.generate_grid(bh)
    FU = EmbeddedFunction.from_function(ebdyc, fu)
    FV = EmbeddedFunction.from_function(ebdyc, fv)
    ua = EmbeddedFunction.from_function(ebdyc, usol)
    va = EmbeddedFunction.from_function(ebdyc, vsol)
    bu = BoundaryFunction.from_function(ebdyc, usol)
    bv = BoundaryFunction.from_function(ebdyc, vsol)
    solver = StokesSolver(ebdyc)
    bie = StokesDirichletBIE(solver)
    setup_s = time.time() - t0

    def step(fg, gg, *frs):
        k = len(frs) // 2
        u, v, p = solver(EmbeddedFunction(fg, list(frs[:k])),
                         EmbeddedFunction(gg, list(frs[k:])),
                         tol=tol, maxiter=100, restart=30)
        u, v, p = bie.apply_bc(u, v, p, bu, bv)
        return (u.grid, v.grid) + tuple(u.radials) + tuple(v.radials)

    jstep = planified(step, solver, bie)

    def run_once():
        out = jstep(FU.grid, FV.grid, *(FU.radials + FV.radials))
        jax.block_until_ready(out)
        return out

    t0 = time.time()
    out = run_once()
    compile_s = time.time() - t0
    t0 = time.time()
    out = run_once()
    solve_ms = (time.time() - t0) * 1e3

    k = len(ebdyc.ebdys)
    phys = np.asarray(ebdyc.phys)
    ge = max(np.abs(np.asarray(out[0]) - np.asarray(ua.grid))[phys].max(),
             np.abs(np.asarray(out[1]) - np.asarray(va.grid))[phys].max())
    re = max(max(np.abs(np.asarray(out[2 + i])
                        - np.asarray(ua.radials[i])).max() for i in range(k)),
             max(np.abs(np.asarray(out[2 + k + i])
                        - np.asarray(va.radials[i])).max() for i in range(k)))
    dof = int(phys.sum() + sum(np.prod(e.radial_shape) for e in ebdyc))
    return {"nb": nb, "M": M, "err": float(max(ge, re)), "dof": dof,
            "grid": list(grid.shape), "setup_s": round(setup_s, 1),
            "compile_s": round(compile_s, 1), "solve_ms": round(solve_ms, 1)}


# reference ledger (examples/multi_stokes_for_paper.py:249)
REFERENCE_ERR = {100: 2.5864e-01, 400: 4.8345e-07, 700: 3.3441e-10,
                 1000: 7.5079e-10}


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    spec = os.environ.get("STOKES_NBS", "100,8 400,12 700,16")
    cases = [tuple(int(v) for v in c.split(",")) for c in spec.split()]
    rows = []
    print(f"{'nb':>6} {'M':>3} {'dof':>9} {'err':>10} {'ref_err':>10} "
          f"{'setup_s':>8} {'compile_s':>9} {'solve_ms':>9}", flush=True)
    for nb, M in cases:
        row = run_case(nb, M)
        ref = REFERENCE_ERR.get(nb)
        row["ref_err"] = ref
        row["beats_reference"] = (ref is None or row["err"] <= 3 * ref)
        rows.append(row)
        print(f"{nb:>6} {M:>3} {row['dof']:>9} {row['err']:>10.2e} "
              f"{(f'{ref:.2e}' if ref else '-'):>10} {row['setup_s']:>8.1f} "
              f"{row['compile_s']:>9.1f} {row['solve_ms']:>9.1f}", flush=True)
    from ipde_tpu.utils.ledger import record
    record("stokes_refinement", rows, ("nb", "M"))
    bad = [r for r in rows if not r["beats_reference"]]
    print("ledger rows FAILED: " + json.dumps(bad) if bad
          else "all ledger rows met", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
