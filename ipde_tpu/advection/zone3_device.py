"""Device zone-3 departure-point Newton solves.

The semi-Lagrangian advectors' zone-3 points (newly uncovered by the
moving boundary; reference: ipde/advection/fe_advector.py:107-171 and
second_order_advector.py:172-325) need per-point Newton iterations on
boundary-fitted coordinates whose residual evaluates periodic boundary
fields at arbitrary parameters.  The host version costs ~16 dense
(P x nb) trig matmuls per iteration on one core; here the whole solve is
one jitted fixed-iteration loop with convergence masks:

- fields are carried as real half-spectrum coefficient tables (K, F),
  evaluated for all P points and all F fields with two trig matrices
  cos(s k), sin(s k) per iteration;
- the second-order 4x4 Newton update uses a closed-form 2x2-block Schur
  solve;
- P is padded to power-of-two buckets so jit shapes stay few.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_HIGH = jax.lax.Precision.HIGHEST


def half_spectrum(fields: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(F, nb) real periodic nodal data -> (K, F) cosine/sine coefficient
    tables with the 2/nb scaling folded in:
        v_f(s) = sum_k Cr[k, f] cos(k s) - Ci[k, f] sin(k s).
    """
    F, nb = fields.shape
    vh = np.fft.rfft(fields, axis=1) / nb          # (F, K)
    vh[:, 1:] *= 2.0
    if nb % 2 == 0:
        vh[:, -1] *= 0.5
    return np.ascontiguousarray(vh.real.T), np.ascontiguousarray(vh.imag.T)


def _eval_all(cos_m, sin_m, Cr, Ci, kvec):
    """Values and s-derivatives of every field at every point.

    cos_m/sin_m: (P, K); Cr/Ci: (K, F); kvec: (K,).
    Returns (vals (P, F), ders (P, F)) via multiply+reduce contractions."""
    P = cos_m.shape[0]
    F = Cr.shape[1]
    vals = []
    ders = []
    for f in range(F):
        cr = Cr[:, f]
        ci = Ci[:, f]
        vals.append(jnp.sum(cos_m * cr[None, :], axis=1)
                    - jnp.sum(sin_m * ci[None, :], axis=1))
        ders.append(-jnp.sum(sin_m * (kvec * cr)[None, :], axis=1)
                    - jnp.sum(cos_m * (kvec * ci)[None, :], axis=1))
    return jnp.stack(vals, axis=1), jnp.stack(ders, axis=1)


# field order for the FE solve
_FE_FIELDS = ("bx", "by", "nx", "ny", "ub", "vb", "urb", "vrb")


@functools.partial(jax.jit, static_argnames=("iters",))
def _newton_fe(Cr, Ci, kvec, dt, xo, yo, s0, r0, valid, iters):
    tol = 1e-12

    def body(carry, _):
        s, r = carry
        ang = s[:, None] * kvec[None, :]
        cos_m = jnp.cos(ang)
        sin_m = jnp.sin(ang)
        V, D = _eval_all(cos_m, sin_m, Cr, Ci, kvec)
        Fd = {k: V[:, i] for i, k in enumerate(_FE_FIELDS)}
        Dd = {k: D[:, i] for i, k in enumerate(_FE_FIELDS)}
        f1 = Fd["bx"] + r * Fd["nx"] + dt * (Fd["ub"] + r * Fd["urb"]) - xo
        f2 = Fd["by"] + r * Fd["ny"] + dt * (Fd["vb"] + r * Fd["vrb"]) - yo
        res = jnp.hypot(f1, f2)
        j11 = Dd["bx"] + r * Dd["nx"] + dt * (Dd["ub"] + r * Dd["urb"])
        j21 = Dd["by"] + r * Dd["ny"] + dt * (Dd["vb"] + r * Dd["vrb"])
        j12 = Fd["nx"] + dt * Fd["urb"]
        j22 = Fd["ny"] + dt * Fd["vrb"]
        det = j11 * j22 - j12 * j21
        det = jnp.where(jnp.abs(det) < 1e-300, 1.0, det)
        ds = (j22 * f1 - j12 * f2) / det
        dr = (j11 * f2 - j21 * f1) / det
        act = valid & (res > tol)
        return (jnp.where(act, s - ds, s), jnp.where(act, r - dr, r)), None

    (s, r), _ = jax.lax.scan(body, (s0, r0), None, length=iters)
    # final residual for the host-side convergence check
    ang = s[:, None] * kvec[None, :]
    cos_m = jnp.cos(ang)
    sin_m = jnp.sin(ang)
    V, _ = _eval_all(cos_m, sin_m, Cr, Ci, kvec)
    Fd = {k: V[:, i] for i, k in enumerate(_FE_FIELDS)}
    f1 = Fd["bx"] + r * Fd["nx"] + dt * (Fd["ub"] + r * Fd["urb"]) - xo
    f2 = Fd["by"] + r * Fd["ny"] + dt * (Fd["vb"] + r * Fd["vrb"]) - yo
    res = jnp.where(valid, jnp.hypot(f1, f2), 0.0)
    return s, r, res


def _bucket(n: int) -> int:
    p = 64
    while p < n:
        p *= 2
    return p


def zone3_newton_fe(fields: Dict[str, np.ndarray], dt: float,
                    xo: np.ndarray, yo: np.ndarray,
                    s0: np.ndarray, r0: np.ndarray, iters: int = 40):
    """Device FE zone-3 Newton.  fields: the 8 periodic boundary fields
    (host numpy); returns host (s, r, max residual)."""
    nb = fields["bx"].size
    Cr, Ci = half_spectrum(np.stack([fields[k] for k in _FE_FIELDS]))
    kvec = np.arange(Cr.shape[0], dtype=np.float64)
    P = xo.size
    B = _bucket(P)
    pad = B - P
    pad1 = lambda a: jnp.asarray(np.pad(np.asarray(a, np.float64), (0, pad)))
    valid = jnp.asarray(np.pad(np.ones(P, bool), (0, pad)))
    s, r, res = _newton_fe(jnp.asarray(Cr), jnp.asarray(Ci),
                           jnp.asarray(kvec), dt, pad1(xo), pad1(yo),
                           pad1(s0), pad1(r0), valid, iters)
    s = np.asarray(s)[:P]
    r = np.asarray(r)[:P]
    resm = float(np.asarray(res).max())
    return s, r, resm


# field order for the second-order solve (current level & old level)
_SO_FIELDS = ("bx", "by", "nx", "ny", "ub", "vb", "urb", "vrb",
              "urrb", "vrrb")


def _so_residual(Fd, Dd, Od, DOd, s, r, so, ro, dt, xo, yo):
    tay_u = Fd["ub"] + r * Fd["urb"] + 0.5 * r**2 * Fd["urrb"]
    tay_v = Fd["vb"] + r * Fd["vrb"] + 0.5 * r**2 * Fd["vrrb"]
    otay_u = Od["ub"] + ro * Od["urb"] + 0.5 * ro**2 * Od["urrb"]
    otay_v = Od["vb"] + ro * Od["vrb"] + 0.5 * ro**2 * Od["vrrb"]
    f0 = Od["bx"] + ro * Od["nx"] + 2 * dt * tay_u - xo
    f1 = Od["by"] + ro * Od["ny"] + 2 * dt * tay_v - yo
    f2 = Fd["bx"] + r * Fd["nx"] + 1.5 * dt * tay_u - 0.5 * dt * otay_u - xo
    f3 = Fd["by"] + r * Fd["ny"] + 1.5 * dt * tay_v - 0.5 * dt * otay_v - yo
    return f0, f1, f2, f3, tay_u, tay_v, otay_u, otay_v


def _solve4_block(J, b0, b1, b2, b3):
    """Solve the (P, 4, 4) systems via 2x2-block Schur complement with
    closed-form 2x2 inverses (no device LU needed).  J given as dict of
    entries J[(i, j)] -> (P,)."""
    def inv2(a, b, c, d):
        det = a * d - b * c
        det = jnp.where(jnp.abs(det) < 1e-300, 1e-300, det)
        return d / det, -b / det, -c / det, a / det

    A = (J[(0, 0)], J[(0, 1)], J[(1, 0)], J[(1, 1)])
    B = (J[(0, 2)], J[(0, 3)], J[(1, 2)], J[(1, 3)])
    C = (J[(2, 0)], J[(2, 1)], J[(3, 0)], J[(3, 1)])
    D = (J[(2, 2)], J[(2, 3)], J[(3, 2)], J[(3, 3)])
    ia, ib, ic, id_ = inv2(*A)
    # S = D - C A^-1 B
    ca = C[0] * ia + C[1] * ic
    cb = C[0] * ib + C[1] * id_
    cc = C[2] * ia + C[3] * ic
    cd = C[2] * ib + C[3] * id_
    s00 = D[0] - (ca * B[0] + cb * B[2])
    s01 = D[1] - (ca * B[1] + cb * B[3])
    s10 = D[2] - (cc * B[0] + cd * B[2])
    s11 = D[3] - (cc * B[1] + cd * B[3])
    isa, isb, isc, isd = inv2(s00, s01, s10, s11)
    # y2 = S^-1 (b2' - C A^-1 b01)
    a0 = ia * b0 + ib * b1
    a1 = ic * b0 + id_ * b1
    r2 = b2 - (C[0] * a0 + C[1] * a1)
    r3 = b3 - (C[2] * a0 + C[3] * a1)
    y2 = isa * r2 + isb * r3
    y3 = isc * r2 + isd * r3
    # y0 = A^-1 (b01 - B y23)
    q0 = b0 - (B[0] * y2 + B[1] * y3)
    q1 = b1 - (B[2] * y2 + B[3] * y3)
    y0 = ia * q0 + ib * q1
    y1 = ic * q0 + id_ * q1
    return y0, y1, y2, y3


@functools.partial(jax.jit, static_argnames=("iters",))
def _newton_so(Cr, Ci, Cro, Cio, kvec, dt, xo, yo, s0, r0, so0, ro0,
               valid, iters):
    tol = 1e-12
    idx = {k: i for i, k in enumerate(_SO_FIELDS)}

    def fields_at(Crt, Cit, s):
        ang = s[:, None] * kvec[None, :]
        cos_m = jnp.cos(ang)
        sin_m = jnp.sin(ang)
        V, D = _eval_all(cos_m, sin_m, Crt, Cit, kvec)
        return ({k: V[:, i] for k, i in idx.items()},
                {k: D[:, i] for k, i in idx.items()})

    def body(carry, _):
        s, r, so, ro = carry
        Fd, Dd = fields_at(Cr, Ci, s)
        Od, Do = fields_at(Cro, Cio, so)
        f0, f1, f2, f3, tay_u, tay_v, otay_u, otay_v = _so_residual(
            Fd, Dd, Od, Do, s, r, so, ro, dt, xo, yo)
        res = jnp.maximum(jnp.maximum(jnp.abs(f0), jnp.abs(f1)),
                          jnp.maximum(jnp.abs(f2), jnp.abs(f3)))
        tay_us = Dd["ub"] + r * Dd["urb"] + 0.5 * r**2 * Dd["urrb"]
        tay_vs = Dd["vb"] + r * Dd["vrb"] + 0.5 * r**2 * Dd["vrrb"]
        otay_us = Do["ub"] + ro * Do["urb"] + 0.5 * ro**2 * Do["urrb"]
        otay_vs = Do["vb"] + ro * Do["vrb"] + 0.5 * ro**2 * Do["vrrb"]
        tay_ur = Fd["urb"] + r * Fd["urrb"]
        tay_vr = Fd["vrb"] + r * Fd["vrrb"]
        otay_ur = Od["urb"] + ro * Od["urrb"]
        otay_vr = Od["vrb"] + ro * Od["vrrb"]
        J = {
            (0, 0): 2 * dt * tay_us,
            (1, 0): 2 * dt * tay_vs,
            (2, 0): Dd["bx"] + r * Dd["nx"] + 1.5 * dt * tay_us,
            (3, 0): Dd["by"] + r * Dd["ny"] + 1.5 * dt * tay_vs,
            (0, 1): 2 * dt * tay_ur,
            (1, 1): 2 * dt * tay_vr,
            (2, 1): Fd["nx"] + 1.5 * dt * tay_ur,
            (3, 1): Fd["ny"] + 1.5 * dt * tay_vr,
            (0, 2): Do["bx"] + ro * Do["nx"],
            (1, 2): Do["by"] + ro * Do["ny"],
            (2, 2): -0.5 * dt * otay_us,
            (3, 2): -0.5 * dt * otay_vs,
            (0, 3): Od["nx"],
            (1, 3): Od["ny"],
            (2, 3): -0.5 * dt * otay_ur,
            (3, 3): -0.5 * dt * otay_vr,
        }
        # unknown order matches the host loop: (s, r, so, ro)
        ds, dr, dso, dro = _solve4_block(J, f0, f1, f2, f3)
        act = valid & (res > tol)
        return (jnp.where(act, s - ds, s), jnp.where(act, r - dr, r),
                jnp.where(act, so - dso, so),
                jnp.where(act, ro - dro, ro)), None

    (s, r, so, ro), _ = jax.lax.scan(body, (s0, r0, so0, ro0), None,
                                     length=iters)
    Fd, Dd = fields_at(Cr, Ci, s)
    Od, Do = fields_at(Cro, Cio, so)
    f0, f1, f2, f3, *_ = _so_residual(Fd, Dd, Od, Do, s, r, so, ro, dt,
                                      xo, yo)
    res = jnp.maximum(jnp.maximum(jnp.abs(f0), jnp.abs(f1)),
                      jnp.maximum(jnp.abs(f2), jnp.abs(f3)))
    res = jnp.where(valid, res, 0.0)
    return s, r, so, ro, res


def zone3_newton_so(fields: Dict[str, np.ndarray],
                    old_fields: Dict[str, np.ndarray], dt: float,
                    xo, yo, s0, r0, so0, ro0, iters: int = 60):
    """Device second-order zone-3 Newton; returns host
    (s, r, so, ro, max residual)."""
    Cr, Ci = half_spectrum(np.stack([fields[k] for k in _SO_FIELDS]))
    Cro, Cio = half_spectrum(np.stack([old_fields[k] for k in _SO_FIELDS]))
    # the two levels may have different nb; pad spectra to a common K
    K = max(Cr.shape[0], Cro.shape[0])
    padK = lambda C: np.pad(C, ((0, K - C.shape[0]), (0, 0)))
    Cr, Ci, Cro, Cio = padK(Cr), padK(Ci), padK(Cro), padK(Cio)
    kvec = np.arange(K, dtype=np.float64)
    P = np.asarray(xo).size
    B = _bucket(P)
    pad = B - P
    pad1 = lambda a: jnp.asarray(np.pad(np.asarray(a, np.float64), (0, pad)))
    valid = jnp.asarray(np.pad(np.ones(P, bool), (0, pad)))
    s, r, so, ro, res = _newton_so(
        jnp.asarray(Cr), jnp.asarray(Ci), jnp.asarray(Cro), jnp.asarray(Cio),
        jnp.asarray(kvec), dt, pad1(xo), pad1(yo), pad1(s0), pad1(r0),
        pad1(so0), pad1(ro0), valid, iters)
    take = lambda a: np.asarray(a)[:P]
    return (take(s), take(r), take(so), take(ro),
            float(np.asarray(res).max()))
