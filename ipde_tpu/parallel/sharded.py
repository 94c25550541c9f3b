"""Multi-chip sharding of the hot evaluation paths (jax.sharding + shard_map).

The reference is single-process (SURVEY.md 2.3); the natural parallel axes on
a device mesh are:
  (a) the target-point axis of dense layer-potential evaluation -- shard
      targets, replicate sources, no communication (DP-like),
  (b) the source axis -- shard sources, psum partial potentials (TP-like),
  (c) the boundary axis in multi-body problems -- per-boundary annular
      solves are independent until the global sigma_g coupling, which is one
      all-gather (SURVEY.md 2.3(b)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ipde_tpu.ops.kernels import kernel_matvec


def make_mesh(n_devices: int = None, axis: str = "p") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def sharded_laplace_slp_apply(mesh: Mesh, sx, sy, weighted_charge, tx, ty,
                              axis: str = "p"):
    """Target-sharded dense Laplace SLP: each device evaluates its slice of
    targets against replicated sources; result is the gathered vector.

    Targets are padded to a multiple of the mesh size.
    """
    n = mesh.devices.size
    T = tx.shape[0]
    Tp = -(-T // n) * n
    txp = jnp.pad(jnp.asarray(tx), (0, Tp - T))
    typ = jnp.pad(jnp.asarray(ty), (0, Tp - T))

    def local(sx_, sy_, q_, ctx, cty):
        dx = ctx[:, None] - sx_[None, :]
        dy = cty[:, None] - sy_[None, :]
        return kernel_matvec(-jnp.log(dx * dx + dy * dy),
                             q_) / (4 * jnp.pi)

    f = shard_map(local, mesh=mesh,
                  in_specs=(P(), P(), P(), P(axis), P(axis)),
                  out_specs=P(axis), check_vma=False)
    out = f(jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(weighted_charge),
            txp, typ)
    return out[:T]


def sharded_mh_slp_apply(mesh: Mesh, sx, sy, weighted_charge, tx, ty,
                         k: float, axis: str = "p"):
    """Target-sharded dense Yukawa SLP (device K0), replicated sources."""
    from ipde_tpu.ops.kernels import bessel_k0
    n = mesh.devices.size
    T = tx.shape[0]
    Tp = -(-T // n) * n
    txp = jnp.pad(jnp.asarray(tx), (0, Tp - T))
    typ = jnp.pad(jnp.asarray(ty), (0, Tp - T))

    def local(sx_, sy_, q_, ctx, cty):
        dx = ctx[:, None] - sx_[None, :]
        dy = cty[:, None] - sy_[None, :]
        z = k * jnp.sqrt(dx * dx + dy * dy)
        return kernel_matvec(bessel_k0(z), q_) / (2 * jnp.pi)

    f = shard_map(local, mesh=mesh,
                  in_specs=(P(), P(), P(), P(axis), P(axis)),
                  out_specs=P(axis), check_vma=False)
    out = f(jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(weighted_charge),
            txp, typ)
    return out[:T]


def sharded_stokes_slp_apply(mesh: Mesh, sx, sy, wfx, wfy, tx, ty,
                             axis: str = "p"):
    """Target-sharded dense Stokeslet apply -> (u, v, p), replicated
    sources (the multi-chip version of stokes_kernels.stokes_slp_apply)."""
    n = mesh.devices.size
    T = tx.shape[0]
    Tp = -(-T // n) * n
    txp = jnp.pad(jnp.asarray(tx), (0, Tp - T))
    typ = jnp.pad(jnp.asarray(ty), (0, Tp - T))

    def local(sx_, sy_, fx_, fy_, ctx, cty):
        dx = ctx[:, None] - sx_[None, :]
        dy = cty[:, None] - sy_[None, :]
        r2 = dx * dx + dy * dy
        ir2 = 1.0 / r2
        logr = 0.5 * jnp.log(r2)
        u = (kernel_matvec(-logr + dx * dx * ir2, fx_)
             + kernel_matvec(dx * dy * ir2, fy_)) / (4 * jnp.pi)
        v = (kernel_matvec(dx * dy * ir2, fx_)
             + kernel_matvec(-logr + dy * dy * ir2, fy_)) \
            / (4 * jnp.pi)
        p = (kernel_matvec(dx * ir2, fx_)
             + kernel_matvec(dy * ir2, fy_)) / (2 * jnp.pi)
        return u, v, p

    f = shard_map(local, mesh=mesh,
                  in_specs=(P(), P(), P(), P(), P(axis), P(axis)),
                  out_specs=(P(axis), P(axis), P(axis)), check_vma=False)
    u, v, p = f(jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(wfx),
                jnp.asarray(wfy), txp, typ)
    return u[:T], v[:T], p[:T]


def source_sharded_laplace_slp_apply(mesh: Mesh, sx, sy, weighted_charge,
                                     tx, ty, axis: str = "p"):
    """Source-sharded (TP-like) dense Laplace SLP with a psum reduction."""
    n = mesh.devices.size
    S = sx.shape[0]
    Sp = -(-S // n) * n
    sxp = jnp.pad(jnp.asarray(sx), (0, Sp - S))
    syp = jnp.pad(jnp.asarray(sy), (0, Sp - S), constant_values=1e6)
    qp = jnp.pad(jnp.asarray(weighted_charge), (0, Sp - S))

    def local(sx_, sy_, q_, ctx, cty):
        dx = ctx[:, None] - sx_[None, :]
        dy = cty[:, None] - sy_[None, :]
        part = kernel_matvec(-jnp.log(dx * dx + dy * dy),
                             q_) / (4 * jnp.pi)
        return jax.lax.psum(part, axis)

    f = shard_map(local, mesh=mesh,
                  in_specs=(P(axis), P(axis), P(axis), P(), P()),
                  out_specs=P())
    return f(sxp, syp, qp, jnp.asarray(tx), jnp.asarray(ty))
