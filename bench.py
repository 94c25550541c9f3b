"""Benchmark: full interior STOKES (or Poisson) solve on one GPU.

Tier 1 (nb=1200, M=16, 1024^2-class grid) runs first and prints its JSON
line at once; tier 2 (nb=2700, M=20, 2048^2-class grid) runs next if the
elapsed time is under 45% of BENCH_BUDGET_S (default 3000 s) and otherwise
prints a line whose value is "not measured".

Setting any of BENCH_NB / BENCH_M / BENCH_GRID pins a single explicit
configuration instead.  BENCH_PDE=poisson selects the scalar flagship path.
The problems are chip_smoke.py's (bench.py's tier-1 geometry and
manufactured solutions).

The run fails unless JAX's first device is a GPU; JAX_PLATFORMS=cpu pins
the CPU on purpose for a rehearsal at a small BENCH_NB.

Each metric line:
  {"metric": "interior_stokes_solve_ms", "value": ..., "unit": "ms",
   "vs_baseline": ..., "platform": ..., "device_kind": ...,
   "device_count": ...}
plus setup_s, compile_s, err, dof, grid, tier.

Baseline: the reference's CPU record for the inhomogeneous Poisson solve,
891 ms at 309k dof and 3026 ms at 955k dof (reference:
examples/poisson_for_paper.py:128,131), linearly scaled to this problem's
dof count.  vs_baseline > 1 means faster than the reference.
"""

import json
import os
import sys
import time

import numpy as np

_T_START = time.time()
REPO = os.path.dirname(os.path.abspath(__file__))


def device_fields():
    """platform / device_kind / device_count; fails off the GPU unless
    the CPU was pinned explicitly."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(f"bench: no GPU (first device: {dev.platform}); "
                         f"set JAX_PLATFORMS=cpu for a CPU rehearsal")
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def run_config(nb, M, grid_target, pde, tier):
    """Build geometry + solver at one configuration, time the jitted
    solve, and print one JSON metric line.  Returns the parsed record."""
    import jax
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from ipde_tpu.utils.planify import planified
    from ipde_tpu.utils.xla_cache import enable_persistent_cache

    enable_persistent_cache()
    device = device_fields()
    t0 = time.time()
    ebdyc = cs.build_geometry(nb, M, grid_target)
    problem = (cs.stokes_problem if pde == "stokes"
               else cs.poisson_problem)(ebdyc)
    solver, bie, step, inputs, exact = problem
    metric = f"interior_{pde}_solve_ms"
    setup_s = time.time() - t0
    print(f"# [{tier}] setup {setup_s:.1f}s grid={ebdyc.grid.shape} "
          f"pde={pde} nb={nb} M={M} {device}", file=sys.stderr, flush=True)

    jstep = planified(step, solver, bie)
    t0 = time.time()
    out = jax.block_until_ready(jstep(*inputs))
    compile_s = time.time() - t0
    print(f"# compile+first run {compile_s:.1f}s", file=sys.stderr, flush=True)

    times = []
    for _ in range(3):
        t0 = time.time()
        out = jax.block_until_ready(jstep(*inputs))
        times.append(time.time() - t0)
    ms = float(np.median(times) * 1e3)

    err = cs.solution_error(ebdyc, out, exact)
    stats = out[2]
    print(f"# max err {err:.2e}; annular iterations "
          f"{np.asarray(stats['annular_iterations']).ravel().tolist()} "
          f"final residual "
          f"{float(np.abs(np.asarray(stats['annular_residuals'])).max()):.2e}",
          file=sys.stderr, flush=True)

    dof = int(ebdyc.phys.sum() + sum(np.prod(e.radial_shape) for e in ebdyc))
    # reference CPU record: 891 ms inhomogeneous Poisson at 309k dof
    # (poisson_for_paper.py:128,131), linear in dof.  Stokes costs the
    # reference strictly MORE per iteration (BASELINE.md), so the same
    # per-dof scaling is a conservative baseline for the Stokes metric.
    baseline_ms = 891.0 * (dof / 309000.0)
    rec = {
        "metric": metric,
        "value": round(ms, 3),
        "unit": "ms",
        "vs_baseline": round(baseline_ms / ms, 3),
        **device,
        "setup_s": round(setup_s, 1),
        "compile_s": round(compile_s, 1),
        "err": float(f"{err:.3e}"),
        "dof": dof,
        "grid": list(ebdyc.grid.shape),
        "tier": tier,
    }
    print(json.dumps(rec), flush=True)
    return rec


def main():
    pde = os.environ.get("BENCH_PDE", "stokes")
    pinned = any(os.environ.get(k) for k in
                 ("BENCH_NB", "BENCH_M", "BENCH_GRID"))
    if pinned:
        nb = int(os.environ.get("BENCH_NB", 2700))
        M = int(os.environ.get("BENCH_M", 20))
        grid_target = int(os.environ.get("BENCH_GRID", 2048))
        run_config(nb, M, grid_target, pde, "pinned")
        return

    budget = float(os.environ.get("BENCH_BUDGET_S", 3000))
    run_config(1200, 16, 1024, pde, "tier1")
    elapsed = time.time() - _T_START
    if elapsed > budget * 0.45:
        print(f"# tier2 not run: {elapsed:.0f}s elapsed of {budget:.0f}s "
              f"budget", file=sys.stderr, flush=True)
        print(json.dumps({"metric": f"interior_{pde}_solve_ms",
                          "value": "not measured", "unit": "ms",
                          **device_fields(), "tier": "tier2"}), flush=True)
        return
    run_config(2700, 20, 2048, pde, "tier2")


if __name__ == "__main__":
    main()
