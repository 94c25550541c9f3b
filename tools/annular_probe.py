"""On-chip cost anatomy of the annular Stokes GMRES at bench sizes.

Times (with in-jit repetition; each call ends in block_until_ready):
  matvec / preconditioner / CGS2 orthogonalization, each in f64 and f32,
  plus the full GMRES solve -- to locate where an iteration's time goes
  and what a mixed-precision inner loop can save.

Usage: BENCH_NB=1200 BENCH_M=16 python tools/annular_probe.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from ipde_tpu.geometry.annular import AnnularGeometry, AnnularMetric
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.solvers.annular_stokes import (AnnularStokesSolver, _matvec,
                                                 _precond)
    from ipde_tpu.solvers.annular_stokes import _solve_jit

    nb = int(os.environ.get("BENCH_NB", 1200))
    M = int(os.environ.get("BENCH_M", 16))
    bdy = star(nb, a=0.2, f=5)
    w = min(0.1, 0.5 / np.abs(bdy.curvature).max())
    geom = AnnularGeometry(nb, M, -w, 0.0, 1.0)
    metric = AnnularMetric(bdy.speed, bdy.curvature, geom)
    solver = AnnularStokesSolver(geom, mu=1.0)
    ops = solver.make_ops(metric)
    n = nb
    N = (3 * M - 1) * n
    rng = np.random.default_rng(0)
    v0 = jnp.asarray(rng.standard_normal(N))

    sync = jax.block_until_ready

    print(f"device={jax.devices()[0].device_kind} N={N}", flush=True)

    R = 16

    def timed(fn, tag, *args):
        jf = jax.jit(fn)
        out = jf(*args)
        sync(jax.tree_util.tree_leaves(out)[0])
        ts = []
        for _ in range(3):
            t0 = time.time()
            o = jf(*args)
            sync(jax.tree_util.tree_leaves(o)[0])
            ts.append(time.time() - t0)
        ms = float(np.median(ts)) * 1e3 / R
        print(f"{tag:<26} {ms:8.3f} ms/app", flush=True)
        return out

    def rep(body):
        def f(x):
            acc = x
            for _ in range(R):
                acc = body(acc)
                acc = acc / jnp.max(jnp.abs(acc))
            return acc
        return f

    timed(rep(lambda v: _matvec(ops, v, M, n)), "matvec f64", v0)
    timed(rep(lambda v: _precond(ops, v, M, n, False)), "precond f64", v0)
    timed(rep(lambda v: _precond(ops, v, M, n, True)), "precond f32cast", v0)

    # f32 ops bundle (cast once, like an inner-loop solver would hold)
    from ipde_tpu.ops.fourier import tan_cast
    ops32 = ops._replace(
        tan=tan_cast(ops.tan, jnp.float32),
        **{k: getattr(ops, k).astype(jnp.float32)
           for k in ops._fields if k != "tan"})
    v32 = v0.astype(jnp.float32)
    timed(rep(lambda v: _matvec(ops32, v, M, n)), "matvec f32", v32)
    timed(rep(lambda v: _precond(ops32, v, M, n, False)), "precond f32", v32)

    # CGS2 orthogonalization step at restart=30
    m = 30
    V = jnp.asarray(rng.standard_normal((m + 1, N)))
    HI = jax.lax.Precision.HIGHEST

    def cgs2(w):
        h1 = jnp.matmul(V, w, precision=HI)
        w = w - jnp.matmul(h1, V, precision=HI)
        h2 = jnp.matmul(V, w, precision=HI)
        w = w - jnp.matmul(h2, V, precision=HI)
        return w
    timed(rep(cgs2), "CGS2 f64 (m=30)", v0)
    V32 = V.astype(jnp.float32)

    def cgs2_32(w):
        h1 = jnp.matmul(V32, w)
        w = w - jnp.matmul(h1, V32)
        h2 = jnp.matmul(V32, w)
        w = w - jnp.matmul(h2, V32)
        return w
    timed(rep(cgs2_32), "CGS2 f32 (m=30)", v32)

    # full solve (current production path)
    rhs = solver.build_rhs(jnp.zeros((M, n)) + 1.0, jnp.zeros((M, n)),
                           jnp.zeros(n), jnp.zeros(n), jnp.zeros(n),
                           jnp.zeros(n))
    jf = lambda: _solve_jit(ops, rhs, M, n, 100, 30, jnp.asarray(1e-12),
                            False)
    out = jf()
    sync(out[0])
    ts = []
    for _ in range(3):
        t0 = time.time()
        o = jf()
        sync(o[0])
        ts.append(time.time() - t0)
    iters = int(out[3])
    ms = float(np.median(ts)) * 1e3
    print(f"{'full GMRES solve':<26} {ms:8.1f} ms   ({iters} iters, "
          f"{ms/max(iters,1):.2f} ms/iter)", flush=True)


if __name__ == "__main__":
    main()
