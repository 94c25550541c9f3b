#!/usr/bin/env python3
"""Smoke test of the interior Poisson and Stokes solves on one GPU.

    python chip_smoke.py

Phases (any failure makes the exit code nonzero):
  0. the device: fails unless JAX's first device is a GPU; prints the card
     (nvidia-smi name and power limit), the JAX version and whether the
     native coordinate library loaded.
  1. the dense layer-potential applies and the periodic box solve, compiled
     for the card, against plain numpy float64 references at real widths:
     the full QFS source set of the tier-1 geometry and 4096 of its
     physical grid points.
  2. interior Poisson (star(1200, a=0.2, f=5), M=16, 1024-class grid):
     PoissonSolver + DirichletBIE jitted through `planified`, checked
     against the manufactured solution (max error <= 1e-10).
  3. interior Stokes on the same geometry: StokesSolver +
     StokesDirichletBIE (max error <= 1e-9).
Phases 2 and 3 build their jitted step twice; the second build shows
whether the persistent compile cache (utils/xla_cache.py) was hit.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}},
printed only when every phase passed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

NB, M, GRID = 1200, 16, 1024
N_TARGETS = 4096
MH_K = 10.0
DENSE_RTOL = 1e-12
FFT_RTOL = 1e-12
POISSON_TOL = 1e-10
STOKES_TOL = 1e-9


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def card_name_and_power() -> str:
    """`name, power.limit` from nvidia-smi (a child that never imports
    JAX, so it does not touch the card's memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# plain references (numpy float64, one target row at a time)
# ---------------------------------------------------------------------------

def _rows(tx, ty, sx, sy):
    for i in range(tx.size):
        dx = tx[i] - sx
        dy = ty[i] - sy
        yield i, dx, dy, dx * dx + dy * dy


def ref_laplace(sx, sy, q, tx, ty):
    out, mag = np.empty(tx.size), np.empty(tx.size)
    for i, dx, dy, r2 in _rows(tx, ty, sx, sy):
        t = -np.log(r2) / (4 * np.pi) * q
        out[i], mag[i] = t.sum(), np.abs(t).sum()
    return [out], [mag]


def ref_laplace_grad(sx, sy, q, tx, ty):
    gx, gy, mx, my = (np.empty(tx.size) for _ in range(4))
    for i, dx, dy, r2 in _rows(tx, ty, sx, sy):
        a = -dx / r2 / (2 * np.pi) * q
        b = -dy / r2 / (2 * np.pi) * q
        gx[i], gy[i] = a.sum(), b.sum()
        mx[i], my[i] = np.abs(a).sum(), np.abs(b).sum()
    return [gx, gy], [mx, my]


def ref_mh(sx, sy, q, tx, ty, k):
    from scipy.special import k0
    out, mag = np.empty(tx.size), np.empty(tx.size)
    for i, dx, dy, r2 in _rows(tx, ty, sx, sy):
        t = k0(k * np.sqrt(r2)) / (2 * np.pi) * q
        out[i], mag[i] = t.sum(), np.abs(t).sum()
    return [out], [mag]


def ref_stokes(sx, sy, fx, fy, tx, ty):
    res = [np.empty(tx.size) for _ in range(6)]
    for i, dx, dy, r2 in _rows(tx, ty, sx, sy):
        ilr = -0.5 * np.log(r2)
        terms = (((ilr + dx * dx / r2) * fx + dx * dy / r2 * fy)
                 / (4 * np.pi),
                 (dx * dy / r2 * fx + (ilr + dy * dy / r2) * fy)
                 / (4 * np.pi),
                 (dx / r2 * fx + dy / r2 * fy) / (2 * np.pi))
        for c, t in enumerate(terms):
            res[c][i], res[3 + c][i] = t.sum(), np.abs(t).sum()
    return res[:3], res[3:]


def check_dense_applies(sx, sy, w, tx, ty, seed: int = 0, k: float = MH_K):
    """Each dense apply that the solves use, compiled for the default
    device, against its numpy reference.  Charges are drawn from `seed`
    and folded with the quadrature weights w.  Returns rows
    (name, max|err|, bound) with bound = DENSE_RTOL * max_i sum_j |K_ij q_j|
    (relative to the absolute sum: the device sums in another order)."""
    import jax
    import jax.numpy as jnp
    from ipde_tpu.ops import kernels
    from ipde_tpu.ops import stokes_kernels as sk

    rng = np.random.default_rng(seed)
    sx, sy, w, tx, ty = (np.asarray(a, np.float64) for a in
                         (sx, sy, w, tx, ty))
    q = rng.standard_normal(sx.size) * w
    fx = rng.standard_normal(sx.size) * w
    fy = rng.standard_normal(sx.size) * w
    d = [jnp.asarray(a) for a in (sx, sy, q, tx, ty)]
    cases = [
        ("laplace_slp_apply", jax.jit(kernels.laplace_slp_apply)(*d),
         ref_laplace(sx, sy, q, tx, ty)),
        ("laplace_slp_grad_apply",
         jax.jit(kernels.laplace_slp_grad_apply)(*d),
         ref_laplace_grad(sx, sy, q, tx, ty)),
        ("mh_slp_apply",
         jax.jit(lambda *a: kernels.mh_slp_apply(*a, k))(*d),
         ref_mh(sx, sy, q, tx, ty, k)),
        ("stokes_slp_apply",
         jax.jit(sk.stokes_slp_apply)(d[0], d[1], jnp.asarray(fx),
                                      jnp.asarray(fy), d[3], d[4]),
         ref_stokes(sx, sy, fx, fy, tx, ty)),
    ]
    rows = []
    for name, got, (want, mag) in cases:
        got = got if isinstance(got, (tuple, list)) else [got]
        err = max(float(np.abs(np.asarray(g) - r).max())
                  for g, r in zip(got, want))
        bound = DENSE_RTOL * max(float(m.max()) for m in mag)
        rows.append((name, err, bound))
    return rows


def check_box_solve(nx: int, ny: int, seed: int = 0):
    """FourierPlan2D.solve_symbol against numpy.fft; returns
    (max|err| / max|ref|, native?)."""
    import jax
    import jax.numpy as jnp
    from ipde_tpu.ops.fourier import FourierPlan2D

    rng = np.random.default_rng(seed)
    f = rng.standard_normal((nx, ny))
    kx = np.fft.fftfreq(nx, 1.0 / nx)[:, None]
    ky = np.fft.fftfreq(ny, 1.0 / ny)[None, :]
    lap = -(kx * kx + ky * ky)
    lap[0, 0] = np.inf
    symbol = 1.0 / lap
    plan = FourierPlan2D(nx, ny)
    got = np.asarray(jax.jit(plan.solve_symbol)(jnp.asarray(f),
                                                jnp.asarray(symbol)))
    want = np.fft.ifft2(np.fft.fft2(f) * symbol).real
    return float(np.abs(got - want).max() / np.abs(want).max()), plan.native


# ---------------------------------------------------------------------------
# the solves
# ---------------------------------------------------------------------------

def build_geometry(nb: int = NB, M: int = M, grid_target: int = GRID):
    """bench.py's tier-1 geometry: star(nb, a=0.2, f=5), M radial nodes,
    h chosen so the box lands on a grid_target-class grid."""
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary

    bdy = star(nb, a=0.2, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    extent = float(bdy.x.max() - bdy.x.min())
    bh = min(bh, extent / (grid_target - 3 * M))
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    ebdyc = EmbeddedBoundaryCollection([ebdy])
    ebdyc.generate_grid(bh)
    return ebdyc


def poisson_problem(ebdyc):
    """(solver, bie, step, inputs, exact) for the bench's manufactured
    Poisson solution."""
    from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu.solvers.bie import DirichletBIE
    from ipde_tpu.solvers.scalar import PoissonSolver

    sol = lambda x, y: -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)
    frc = lambda x, y: ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x)
                         - np.cos(x) ** 3) * np.exp(np.sin(x)) * np.sin(y))
    f = EmbeddedFunction.from_function(ebdyc, frc)
    ua = EmbeddedFunction.from_function(ebdyc, sol)
    bc = BoundaryFunction.from_function(ebdyc, sol)
    solver = PoissonSolver(ebdyc)
    bie = DirichletBIE(solver)

    def step(f_grid, f_radial):
        ef = EmbeddedFunction(f_grid, [f_radial])
        ue, stats = solver.solve_with_stats(ef, tol=1e-12, maxiter=100,
                                            restart=30)
        ue = bie.apply_bc(ue, bc)
        return ue.grid, ue.radials[0], stats

    return solver, bie, step, (f.grid, f.radials[0]), ua


def stokes_problem(ebdyc):
    """(solver, bie, step, inputs, exact u) for the bench's manufactured
    Stokes solution."""
    from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu.solvers.bie import StokesDirichletBIE
    from ipde_tpu.solvers.vector import StokesSolver

    usol = lambda x, y: np.sin(x) * np.cos(y) + 0.2 * np.cos(2 * y)
    vsol = lambda x, y: -np.cos(x) * np.sin(y) + 0.1 * np.sin(2 * x)
    fuf = lambda x, y: (2 * np.sin(x) * np.cos(y) + 0.8 * np.cos(2 * y)
                        - np.sin(x) * np.sin(y))
    fvf = lambda x, y: (-2 * np.cos(x) * np.sin(y) + 0.4 * np.sin(2 * x)
                        + np.cos(x) * np.cos(y))
    fu = EmbeddedFunction.from_function(ebdyc, fuf)
    fv = EmbeddedFunction.from_function(ebdyc, fvf)
    ua = EmbeddedFunction.from_function(ebdyc, usol)
    bc_u = BoundaryFunction.from_function(ebdyc, usol)
    bc_v = BoundaryFunction.from_function(ebdyc, vsol)
    solver = StokesSolver(ebdyc)
    bie = StokesDirichletBIE(solver)

    def step(f_grid, f_radial):
        fue = EmbeddedFunction(f_grid, [f_radial])
        (u, v, p), stats = solver.solve_with_stats(fue, fv, tol=1e-12,
                                                   maxiter=100, restart=30)
        u, v, p = bie.apply_bc(u, v, p, bc_u, bc_v)
        return u.grid, u.radials[0], stats

    return solver, bie, step, (fu.grid, fu.radials[0]), ua


def solution_error(ebdyc, out, exact) -> float:
    """Max error over the physical grid points and the radial nodes."""
    grid, radial = np.asarray(out[0]), np.asarray(out[1])
    ge = np.abs(grid - np.asarray(exact.grid))[np.asarray(ebdyc.phys)].max()
    re = np.abs(radial - np.asarray(exact.radials[0])).max()
    return float(max(ge, re))


class CacheHits:
    """Counts persistent compile-cache hits and misses in this process."""

    def __init__(self):
        import jax
        self.hits = self.misses = 0
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1


def run_solve(name: str, problem, ebdyc, cache: CacheHits, n_timed=5):
    """Setup has already run; jit through `planified`, time compile (twice:
    the second build is a fresh jit, so it can only come from the
    persistent cache) and n_timed solves.  Returns (record, error)."""
    import jax
    from ipde_tpu.utils.planify import planified

    solver, bie, step, inputs, exact = problem
    rec = {}
    for attempt in ("compile_s", "recompile_s"):
        h0 = cache.hits
        jstep = planified(step, solver, bie)
        t0 = time.perf_counter()
        out = jax.block_until_ready(jstep(*inputs))
        rec[attempt] = time.perf_counter() - t0
        rec[attempt.replace("_s", "_cache_hits")] = cache.hits - h0
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        out = jax.block_until_ready(jstep(*inputs))
        times.append(time.perf_counter() - t0)
    rec["solve_ms_median"] = float(np.median(times) * 1e3)
    rec["solve_ms_all"] = [t * 1e3 for t in times]
    stats = out[2]
    rec["gmres_iterations"] = np.asarray(
        stats["annular_iterations"]).ravel().tolist()
    rec["gmres_residual"] = float(np.abs(np.asarray(
        stats["annular_residuals"])).max())
    mem = jax.devices()[0].memory_stats() or {}
    rec["peak_bytes_in_use"] = mem.get("peak_bytes_in_use")
    err = solution_error(ebdyc, out, exact)
    rec["max_err"] = err
    log(f"# [{name}] " + json.dumps(rec))
    return rec, err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase0():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX's first device is "
                         f"{dev.platform}: {dev.device_kind})")
    from ipde_tpu.native import get_lib
    log(f"# device_kind {dev.device_kind}, {len(jax.devices())} device(s)")
    log(card_name_and_power())          # "<name>, <power limit>" as is
    log(f"# jax {jax.__version__}, native coordinate library "
        f"{'loaded' if get_lib() is not None else 'NOT loaded'}")
    return dev


def phase1(ebdyc, solver, seed: int = 0) -> bool:
    rng = np.random.default_rng(seed)
    px = np.asarray(ebdyc.grid.xg)[np.asarray(ebdyc.phys)]
    py = np.asarray(ebdyc.grid.yg)[np.asarray(ebdyc.phys)]
    pick = rng.choice(px.size, N_TARGETS, replace=False)
    sx, sy, w = (np.asarray(a) for a in
                 (solver.grid_src_x, solver.grid_src_y, solver.grid_src_w))
    ok = True
    t0 = time.perf_counter()
    for name, err, bound in check_dense_applies(sx, sy, w, px[pick],
                                                py[pick], seed=seed):
        good = err <= bound
        ok &= good
        log(f"# [phase1] {name}: S={sx.size} T={N_TARGETS} "
            f"max|err| {err:.3e} bound {bound:.3e} "
            f"{'ok' if good else 'FAIL'}")
    nx, ny = ebdyc.grid.shape
    rel, native = check_box_solve(nx, ny, seed=seed)
    good = rel <= FFT_RTOL
    ok &= good
    log(f"# [phase1] box solve {nx}x{ny} native_fft={native}: rel err "
        f"{rel:.3e} bound {FFT_RTOL:.0e} {'ok' if good else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")
    return ok


def main() -> int:
    sys.path.insert(0, REPO)
    if not os.path.isdir(os.path.join(REPO, "ipde_tpu")):
        raise SystemExit("chip_smoke: the ipde_tpu package is not beside "
                         "this script")
    import ipde_tpu  # noqa: F401  (x64, matmul precision)
    from ipde_tpu.utils.xla_cache import enable_persistent_cache

    enable_persistent_cache()
    dev = phase0()
    import jax
    cache = CacheHits()
    ok = True

    t0 = time.perf_counter()
    ebdyc = build_geometry()
    geom_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    poisson = poisson_problem(ebdyc)
    setup_s = geom_s + time.perf_counter() - t0
    log(f"# [phase2] setup {setup_s:.1f} s (geometry {geom_s:.1f} s), grid "
        f"{ebdyc.grid.shape}, sources {poisson[0].grid_src_x.shape[0]}")

    if not phase1(ebdyc, poisson[0]):
        log("# [phase1] FAILED")
        ok = False

    _, err = run_solve("phase2 poisson", poisson, ebdyc, cache)
    if not err <= POISSON_TOL:
        log(f"# [phase2] FAILED: err {err:.3e} > {POISSON_TOL:.0e}")
        ok = False
    del poisson

    t0 = time.perf_counter()
    stokes = stokes_problem(ebdyc)
    log(f"# [phase3] setup {time.perf_counter() - t0:.1f} s (+ geometry "
        f"{geom_s:.1f} s)")
    _, err = run_solve("phase3 stokes", stokes, ebdyc, cache)
    if not err <= STOKES_TOL:
        log(f"# [phase3] FAILED: err {err:.3e} > {STOKES_TOL:.0e}")
        ok = False

    log(f"# compile cache: {cache.hits} hits, {cache.misses} misses, dir "
        f"{jax.config.jax_compilation_cache_dir}")
    if not ok:
        return 1
    print(result_line(dev.platform, dev.device_kind, len(jax.devices())),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
