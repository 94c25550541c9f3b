"""Device-side formation of dense layer-potential matrices.

Twins of the numpy builders in ops/singular.py and ops/stokes_kernels.py
that build the SAME matrices as device arrays from O(nb) curve data.  At
production sizes a Stokes QFS system is (5400 x 16200) f64 = 700 MB, so
only O(nb) coordinate vectors cross from the host.  Used by the
device-backed QFS/BIE setup (qfs.py, solvers/bie.py) together with
ops/device_linalg.py.

Every builder is a thin wrapper around a ``@jax.jit`` CORE: one dispatch
per matrix instead of one per jnp op (10-30 each).  Cores compile once per
shape and persist in the XLA compile cache.

Equality with the numpy builders is asserted in tests/test_forms_dev.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ipde_tpu.geometry.curve import BoundaryCurve
from ipde_tpu.ops.kernels import bessel_k0, bessel_k1
from ipde_tpu.ops.singular import log_quad_circulant

_HIGH = jax.lax.Precision.HIGHEST


def _curve_dev(curve: BoundaryCurve) -> dict:
    """Extended device mirror of curve geometry (cached on the curve)."""
    d = curve.__dict__.get("_dev_full")
    if d is None:
        d = {k: jnp.asarray(getattr(curve, k))
             for k in ("x", "y", "weights", "normal_x", "normal_y",
                       "tangent_x", "tangent_y", "speed", "curvature", "t")}
        curve._dev_full = d
    return d


def _pair(src: dict, tx, ty):
    dx = tx[:, None] - src["x"][None, :]
    dy = ty[:, None] - src["y"][None, :]
    return dx, dy, dx * dx + dy * dy


def _w_circulant(curve: BoundaryCurve):
    """Kress log-quadrature circulant first column (host, cached on the
    curve); the (i - j) mod n expansion happens inside the jitted cores."""
    w = curve.__dict__.get("_kress_col")
    if w is None:
        w = jnp.asarray(log_quad_circulant(curve.N)[:, 0])
        curve._kress_col = w
    return w


def _expand_circulant(col):
    n = col.shape[0]
    i = jnp.arange(n)
    return col[(i[:, None] - i[None, :]) % n]


def _eye_mask(n: int):
    i = jnp.arange(n)
    return (i[:, None] == i[None, :])


def _t(v):
    return jnp.asarray(v).ravel()


# ---------------------------------------------------------------------------
# naive (off-surface) forms
# ---------------------------------------------------------------------------

@jax.jit
def _lap_slp_naive(s, tx, ty):
    _, _, r2 = _pair(s, tx, ty)
    return -jnp.log(r2) / (4 * jnp.pi) * s["weights"][None, :]


def laplace_slp_naive_dev(src: BoundaryCurve, tx, ty):
    return _lap_slp_naive(_curve_dev(src), _t(tx), _t(ty))


@jax.jit
def _lap_dlp_naive(s, tx, ty):
    dx, dy, r2 = _pair(s, tx, ty)
    dot = dx * s["normal_x"][None, :] + dy * s["normal_y"][None, :]
    return dot / (2 * jnp.pi * r2) * s["weights"][None, :]


def laplace_dlp_naive_dev(src: BoundaryCurve, tx, ty):
    return _lap_dlp_naive(_curve_dev(src), _t(tx), _t(ty))


@jax.jit
def _mh_slp_naive(s, tx, ty, k):
    _, _, r2 = _pair(s, tx, ty)
    return bessel_k0(k * jnp.sqrt(r2)) / (2 * jnp.pi) * s["weights"][None, :]


def mh_slp_naive_dev(src: BoundaryCurve, tx, ty, k: float):
    return _mh_slp_naive(_curve_dev(src), _t(tx), _t(ty), jnp.float64(k))


@jax.jit
def _mh_dlp_naive(s, tx, ty, k):
    dx, dy, r2 = _pair(s, tx, ty)
    r = jnp.sqrt(r2)
    dot = dx * s["normal_x"][None, :] + dy * s["normal_y"][None, :]
    return (k * bessel_k1(k * r) * dot / (2 * jnp.pi * r)
            * s["weights"][None, :])


def mh_dlp_naive_dev(src: BoundaryCurve, tx, ty, k: float):
    return _mh_dlp_naive(_curve_dev(src), _t(tx), _t(ty), jnp.float64(k))


@jax.jit
def _lap_slp_normal_naive(s, tx, ty, tnx, tny):
    dx, dy, r2 = _pair(s, tx, ty)
    dot = dx * tnx[:, None] + dy * tny[:, None]
    return -dot / (2 * jnp.pi * r2) * s["weights"][None, :]


def laplace_slp_normal_naive_dev(src: BoundaryCurve, tx, ty, tnx, tny):
    return _lap_slp_normal_naive(_curve_dev(src), _t(tx), _t(ty),
                                 _t(tnx), _t(tny))


@jax.jit
def _mh_slp_normal_naive(s, tx, ty, tnx, tny, k):
    dx, dy, r2 = _pair(s, tx, ty)
    r = jnp.sqrt(r2)
    dot = dx * tnx[:, None] + dy * tny[:, None]
    return (-k * bessel_k1(k * r) * dot / (2 * jnp.pi * r)
            * s["weights"][None, :])


def mh_slp_normal_naive_dev(src: BoundaryCurve, tx, ty, tnx, tny, k: float):
    return _mh_slp_normal_naive(_curve_dev(src), _t(tx), _t(ty),
                                _t(tnx), _t(tny), jnp.float64(k))


@jax.jit
def _stokes_slp_naive(s, tx, ty):
    dx, dy, r2 = _pair(s, tx, ty)
    ilr = -0.5 * jnp.log(r2)
    ir2 = 1.0 / r2
    w = s["weights"][None, :] / (4 * jnp.pi)
    axy = (dx * dy * ir2) * w
    return jnp.concatenate([
        jnp.concatenate([(ilr + dx * dx * ir2) * w, axy], axis=1),
        jnp.concatenate([axy, (ilr + dy * dy * ir2) * w], axis=1)], axis=0)


def stokes_slp_naive_dev(src: BoundaryCurve, tx, ty):
    return _stokes_slp_naive(_curve_dev(src), _t(tx), _t(ty))


@jax.jit
def _stokes_dlp_naive(s, tx, ty):
    dx, dy, r2 = _pair(s, tx, ty)
    rn = dx * s["normal_x"][None, :] + dy * s["normal_y"][None, :]
    c = rn / (r2 * r2) * (s["weights"][None, :] / jnp.pi)
    return jnp.concatenate([
        jnp.concatenate([c * dx * dx, c * dx * dy], axis=1),
        jnp.concatenate([c * dy * dx, c * dy * dy], axis=1)], axis=0)


def stokes_dlp_naive_dev(src: BoundaryCurve, tx, ty):
    return _stokes_dlp_naive(_curve_dev(src), _t(tx), _t(ty))


# ---------------------------------------------------------------------------
# Kress self-evaluation forms (Laplace + Stokes; MH stays host-built)
# ---------------------------------------------------------------------------

def _self_geom(s):
    dx, dy, r2 = _pair(s, s["x"], s["y"])
    t = s["t"]
    s2 = 4.0 * jnp.sin((t[:, None] - t[None, :]) / 2.0) ** 2
    return dx, dy, r2, s2, _eye_mask(s["x"].shape[0])


@jax.jit
def _lap_slp_self(s, wcol, dt):
    dx, dy, r2, s2, eye = _self_geom(s)
    # off-diagonal smooth remainder -log(r2/s2)/(4pi); diagonal -log(speed^2)
    ratio = jnp.where(eye, 1.0, r2 / jnp.where(eye, 1.0, s2))
    K2 = jnp.where(eye, -jnp.log(s["speed"] ** 2)[:, None] * eye,
                   -jnp.log(ratio)) / (4 * jnp.pi)
    K1 = -1.0 / (4 * jnp.pi)
    W = _expand_circulant(wcol)
    return (K1 * W + K2 * dt) * s["speed"][None, :]


def laplace_slp_self_dev(curve: BoundaryCurve):
    return _lap_slp_self(_curve_dev(curve), _w_circulant(curve),
                         jnp.float64(curve.dt))


@jax.jit
def _lap_dlp_self(s):
    dx, dy, r2, _, eye = _self_geom(s)
    dot = dx * s["normal_x"][None, :] + dy * s["normal_y"][None, :]
    K = jnp.where(eye, -s["curvature"][:, None] / (4 * jnp.pi) * eye,
                  dot / (2 * jnp.pi * jnp.where(eye, 1.0, r2)))
    return K * s["weights"][None, :]


def laplace_dlp_self_dev(curve: BoundaryCurve):
    return _lap_dlp_self(_curve_dev(curve))


@jax.jit
def _lap_slp_normal_self(s):
    dx, dy, r2, _, eye = _self_geom(s)
    dot = dx * s["normal_x"][:, None] + dy * s["normal_y"][:, None]
    K = jnp.where(eye, -s["curvature"][:, None] / (4 * jnp.pi) * eye,
                  -dot / (2 * jnp.pi * jnp.where(eye, 1.0, r2)))
    return K * s["weights"][None, :]


def laplace_slp_normal_self_dev(curve: BoundaryCurve):
    return _lap_slp_normal_self(_curve_dev(curve))


@jax.jit
def _stokes_slp_self(s, wcol, dt):
    dx, dy, r2, s2, eye = _self_geom(s)
    W = _expand_circulant(wcol)
    logA = -W / (8 * jnp.pi)
    ratio = jnp.where(eye, 1.0, r2 / jnp.where(eye, 1.0, s2))
    Sd = jnp.where(eye, -jnp.log(s["speed"])[:, None] * eye,
                   -0.5 * jnp.log(ratio)) / (4 * jnp.pi)
    ir2 = jnp.where(eye, 0.0, 1.0 / jnp.where(eye, 1.0, r2))
    rxx = jnp.where(eye, (s["tangent_x"] ** 2)[:, None] * eye, dx * dx * ir2)
    rxy = jnp.where(eye, (s["tangent_x"] * s["tangent_y"])[:, None] * eye,
                    dx * dy * ir2)
    ryy = jnp.where(eye, (s["tangent_y"] ** 2)[:, None] * eye, dy * dy * ir2)
    dtq = dt / (4 * jnp.pi)
    sp = s["speed"][None, :]
    Axx = (logA + (Sd * dt + rxx * dtq)) * sp
    Axy = (rxy * dtq) * sp
    Ayy = (logA + (Sd * dt + ryy * dtq)) * sp
    return jnp.concatenate([
        jnp.concatenate([Axx, Axy], axis=1),
        jnp.concatenate([Axy, Ayy], axis=1)], axis=0)


def stokes_slp_self_dev(curve: BoundaryCurve):
    return _stokes_slp_self(_curve_dev(curve), _w_circulant(curve),
                            jnp.float64(curve.dt))


@jax.jit
def _stokes_dlp_self(s):
    dx, dy, r2, _, eye = _self_geom(s)
    rn = dx * s["normal_x"][None, :] + dy * s["normal_y"][None, :]
    c = jnp.where(eye, 0.0, rn / jnp.where(eye, 1.0, r2 * r2))
    lim = -s["curvature"] / 2.0
    Axx = jnp.where(eye, (lim * s["tangent_x"] ** 2)[:, None] * eye,
                    c * dx * dx)
    Axy = jnp.where(eye, (lim * s["tangent_x"] * s["tangent_y"])[:, None]
                    * eye, c * dx * dy)
    Ayy = jnp.where(eye, (lim * s["tangent_y"] ** 2)[:, None] * eye,
                    c * dy * dy)
    w = s["weights"][None, :] / jnp.pi
    return jnp.concatenate([
        jnp.concatenate([Axx * w, Axy * w], axis=1),
        jnp.concatenate([Axy * w, Ayy * w], axis=1)], axis=0)


def stokes_dlp_self_dev(curve: BoundaryCurve):
    return _stokes_dlp_self(_curve_dev(curve))


@jax.jit
def _stokes_pressure_fix(s, txn, tyn):
    wx = s["normal_x"] * s["weights"]
    wy = s["normal_y"] * s["weights"]
    scale = 1.0 / jnp.sum(s["weights"])
    txn = txn[:, None]
    tyn = tyn[:, None]
    return jnp.concatenate([
        jnp.concatenate([txn * wx[None, :], txn * wy[None, :]], axis=1),
        jnp.concatenate([tyn * wx[None, :], tyn * wy[None, :]], axis=1)],
        axis=0) * scale


def stokes_pressure_fix_dev(src: BoundaryCurve, tx_n, ty_n):
    return _stokes_pressure_fix(_curve_dev(src), _t(tx_n), _t(ty_n))


# ---------------------------------------------------------------------------
# rule-36 spectral filter as a device circulant (per component block)
# ---------------------------------------------------------------------------

def rule36_circulant_dev(n: int):
    """Dense circulant of the rule-36 filter (one n^2 matmul per block)."""
    k = np.abs(np.fft.fftfreq(n, 1.0 / n))
    filt = np.exp(-36.0 * (k / k.max()) ** 36)
    c = np.fft.ifft(filt).real
    cd = jnp.asarray(c)
    i = jnp.arange(n)
    return cd[(i[:, None] - i[None, :]) % n]


def filter_rows_dev(Bmat, ncurve: int):
    """rule-36 filter applied to each ncurve-row component block: F @ B."""
    F = rule36_circulant_dev(ncurve)
    nblocks = Bmat.shape[0] // ncurve
    rows = [jnp.matmul(F, Bmat[c * ncurve:(c + 1) * ncurve],
                       precision=_HIGH)
            for c in range(nblocks)]
    return jnp.concatenate(rows, axis=0) if nblocks > 1 else rows[0]


def filter_cols_dev(Mmat, ncurve: int):
    """M @ F per component block (F symmetric)."""
    F = rule36_circulant_dev(ncurve)
    nblocks = Mmat.shape[1] // ncurve
    cols = [jnp.matmul(Mmat[:, c * ncurve:(c + 1) * ncurve], F,
                       precision=_HIGH)
            for c in range(nblocks)]
    return jnp.concatenate(cols, axis=1) if nblocks > 1 else cols[0]
