"""Time the dense layer-potential applies and the periodic box solve on the
device.

Applies: Laplace SLP, its gradient, Yukawa (k=10) and Stokeslet, each with
the tier-1 QFS source set (chip_smoke.py's geometry: star(1200), M=16,
1024x1088 grid) against every physical grid point.  Box solve:
FourierPlan2D.solve_symbol with the native FFT and with the f64 DFT
matmuls at 1024^2 and 2048^2, in turns.

    python tools/dense_apply_bench.py [--out FILE] [--nb 1200 --M 16 --grid 1024]

Prints one JSON line per measurement (and writes them all to --out,
default chiprun_out/dense_apply_bench.json).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RECORDS = []


def emit(**rec):
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def median_ms(fn, n=5):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3), [t * 1e3 for t in ts]


def time_applies(sx, sy, w, tx, ty):
    import jax
    import jax.numpy as jnp
    from ipde_tpu.ops import kernels
    from ipde_tpu.ops import stokes_kernels as sk
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal(sx.shape[0])) * w
    applies = {
        "laplace": lambda: kernels.laplace_slp_apply(sx, sy, q, tx, ty),
        "laplace_grad": lambda: kernels.laplace_slp_grad_apply(sx, sy, q,
                                                               tx, ty),
        "mh": lambda: kernels.mh_slp_apply(sx, sy, q, tx, ty, 10.0),
        "stokes": lambda: sk.stokes_slp_apply(sx, sy, q, 0.5 * q, tx, ty),
    }
    for kind, f in applies.items():
        ms, all_ms = median_ms(jax.jit(f))
        pairs = int(sx.shape[0]) * int(tx.shape[0])
        emit(what="apply", kind=kind, S=int(sx.shape[0]), T=int(tx.shape[0]),
             ms=ms, all_ms=all_ms, gpairs_per_s=pairs / ms / 1e6)


def time_box_solve():
    import jax
    import jax.numpy as jnp
    from ipde_tpu.ops.fourier import FourierPlan2D
    for n in (1024, 2048):
        rng = np.random.default_rng(0)
        f = jnp.asarray(rng.standard_normal((n, n)))
        sym = jnp.asarray(rng.uniform(0.5, 1.0, (n, n)))
        for native in (True, False, True, False):
            g = jax.jit(FourierPlan2D(n, n, native=native).solve_symbol)
            t0 = time.perf_counter()
            jax.block_until_ready(g(f, sym))
            first = time.perf_counter() - t0
            ms, all_ms = median_ms(lambda: g(f, sym), n=10)
            emit(what="box_solve", n=n, native=native, ms=ms, all_ms=all_ms,
                 compile_s=first)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nb", type=int, default=1200)
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "dense_apply_bench.json"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import ipde_tpu  # noqa: F401
    import chip_smoke as cs
    from ipde_tpu.utils.xla_cache import enable_persistent_cache
    enable_persistent_cache()
    dev = jax.devices()[0]
    card = cs.card_name_and_power() if dev.platform == "gpu" else "n/a"
    emit(what="device", platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()), card=card)

    time_box_solve()
    ebdyc = cs.build_geometry(args.nb, args.M, args.grid)
    solver = cs.poisson_problem(ebdyc)[0]
    phys = np.asarray(ebdyc.phys)
    time_applies(solver.grid_src_x, solver.grid_src_y, solver.grid_src_w,
                 jnp.asarray(np.asarray(ebdyc.grid.xg)[phys]),
                 jnp.asarray(np.asarray(ebdyc.grid.yg)[phys]))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(RECORDS, fh, indent=1)


if __name__ == "__main__":
    main()
