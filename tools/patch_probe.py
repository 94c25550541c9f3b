"""Time the patch-application primitives at tier-1 size on the device.

Variants: serial per-source scan (baseline), pull = permute-gather +
cumsum + segment-diff + small scatter, and the cumsum-by-triangular-matmul
replacement.  Prints per-op times so the pull pipeline's cost is
attributable (gather vs cumsum vs scatter).

Usage: python tools/patch_probe.py   (JAX_PLATFORMS=cpu for a local run)
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

    sync = jax.block_until_ready

    print(f"device={jax.devices()[0].device_kind}", flush=True)

    def timeit(f, *args):
        jf = jax.jit(f)
        sync(jf(*args))
        ts = []
        for _ in range(3):
            t0 = time.time()
            sync(jf(*args))
            ts.append(time.time() - t0)
        return float(np.median(ts)) * 1e3

    S, P = 3600, 45
    Nx, Ny = 1024, 1088
    rng = np.random.default_rng(0)
    # synthetic curve-ordered sources
    th = np.linspace(0, 2 * np.pi, S, endpoint=False)
    r = 0.35 + 0.05 * np.cos(5 * th)
    six = np.clip(((r * np.cos(th) + 0.5) * Nx).astype(int), 0, Nx - 1)
    siy = np.clip(((r * np.sin(th) + 0.5) * Ny).astype(int), 0, Ny - 1)
    m = P // 2
    loc = np.arange(P) - m
    cellx = six[:, None, None] + loc[None, :, None]
    celly = siy[:, None, None] + loc[None, None, :]
    valid = ((cellx >= 0) & (cellx < Nx) & (celly >= 0) & (celly < Ny))
    cell = (cellx * Ny + celly).reshape(S, P * P)
    valid = valid.reshape(S, P * P)
    flat_entry = np.flatnonzero(valid.ravel())
    cells = cell.ravel()[flat_entry]
    order = np.argsort(cells, kind="stable")
    perm = jnp.asarray(flat_entry[order].astype(np.int32))
    cells_sorted = cells[order]
    ucells, starts = np.unique(cells_sorted, return_index=True)
    ends = np.concatenate([starts[1:], [cells_sorted.size]])
    nnz = perm.shape[0]
    print(f"S={S} P={P} nnz={nnz} ncells={ucells.size}")

    vals = jnp.asarray(rng.standard_normal((S, P * P)))
    g = jnp.zeros((Nx, Ny))
    startsj = jnp.asarray(starts.astype(np.int32))
    endsj = jnp.asarray(ends.astype(np.int32))
    ucellsj = jnp.asarray(ucells.astype(np.int32))

    ms = timeit(lambda v: jnp.take(v.ravel(), perm, axis=0), vals)
    print(f"permute gather       {ms:8.1f} ms", flush=True)

    v_sorted = jnp.take(vals.ravel(), perm, axis=0)
    ms = timeit(lambda v: jnp.cumsum(v), v_sorted)
    print(f"cumsum 1d            {ms:8.1f} ms", flush=True)

    C = 2048
    R = -(-nnz // C)
    tri = jnp.asarray(np.tril(np.ones((C, C))))

    def cumsum_mm(v):
        vp = jnp.concatenate([v, jnp.zeros(R * C - nnz, v.dtype)])
        v2 = vp.reshape(R, C)
        pref = jnp.matmul(v2, tri.T, precision=jax.lax.Precision.HIGHEST)
        offs = jnp.concatenate([jnp.zeros((1,), v.dtype),
                                jnp.cumsum(pref[:, -1])[:-1]])
        return (pref + offs[:, None]).ravel()[:nnz]

    ms = timeit(cumsum_mm, v_sorted)
    print(f"cumsum matmul        {ms:8.1f} ms", flush=True)
    # correctness
    a = np.asarray(jnp.cumsum(v_sorted))
    b = np.asarray(cumsum_mm(v_sorted))
    print(f"  cumsum agree: {np.abs(a - b).max():.2e}")

    def segdiff(csum_in):
        cs = jnp.concatenate([jnp.zeros((1,), csum_in.dtype), csum_in])
        seg = jnp.take(cs, endsj, axis=0) - jnp.take(cs, startsj, axis=0)
        return g.ravel().at[ucellsj].add(seg)

    ms = timeit(segdiff, jnp.cumsum(v_sorted))
    print(f"segdiff + scatter    {ms:8.1f} ms", flush=True)

    def full_pull(v):
        vs = jnp.take(v.ravel(), perm, axis=0)
        cs = jnp.concatenate([jnp.zeros((1,), v.dtype), cumsum_mm(vs)])
        seg = jnp.take(cs, endsj, axis=0) - jnp.take(cs, startsj, axis=0)
        return g.ravel().at[ucellsj].add(seg)

    ms = timeit(full_pull, vals)
    print(f"FULL pull (mm csum)  {ms:8.1f} ms", flush=True)

    # baseline serial scan
    x0j = jnp.asarray(six.astype(np.int32))
    y0j = jnp.asarray(siy.astype(np.int32))

    def scan_apply(v):
        ext = jnp.zeros((Nx + 2 * m, Ny + 2 * m))

        def body(acc, inp):
            patch, x0, y0 = inp
            cur = jax.lax.dynamic_slice(acc, (x0, y0), (P, P))
            return jax.lax.dynamic_update_slice(
                acc, cur + patch.reshape(P, P), (x0, y0)), None

        ext, _ = jax.lax.scan(body, ext, (v, x0j, y0j))
        return ext

    ms = timeit(scan_apply, vals)
    print(f"serial scan          {ms:8.1f} ms", flush=True)


if __name__ == "__main__":
    main()
