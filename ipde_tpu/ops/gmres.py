"""Right-preconditioned restarted GMRES, fully jittable (lax control flow).

Replaces the reference's scipy-based ``right_gmres``
(reference: personal_utilities.scipy_gmres.right_gmres, used by
ipde/annular/modified_helmholtz.py:198 and ipde/annular/stokes.py:533).

Design notes:
  * operates on flat real float64 vectors (complex data is carried as
    (re, im) pairs elsewhere in the package; the annular operators are real
    in real space, so the Krylov space is real),
  * Arnoldi uses classical Gram-Schmidt with reorthogonalization (CGS2):
    two (j x n) matmuls per iteration instead of j sequential dots,
  * Givens rotations maintain the QR of the Hessenberg matrix; the final
    triangular solve is an unrolled-free fori_loop back-substitution,
  * fixed-size Krylov buffers (restart+1, n); early exit via while_loop.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

_HIGH = jax.lax.Precision.HIGHEST


class GmresResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array      # total inner iterations performed
    residual: jax.Array        # final (preconditioned-system) relative residual


def _identity(x):
    return x


def gmres(matvec: Callable, b: jax.Array, precond: Optional[Callable] = None,
          tol: float = 1e-14, maxiter: int = 100, restart: int = 30,
          x0: Optional[jax.Array] = None,
          flexible: bool = False) -> GmresResult:
    """Solve A x = b with right-preconditioned GMRES(restart).

    matvec: x -> A x on flat vectors.  precond: r -> M^{-1} r.  Convergence is
    declared when ||b - A x|| <= tol * ||b||.

    flexible=True stores the preconditioned basis Z (FGMRES, Saad '93) and
    assembles x = x0 + Z y.  REQUIRED whenever precond is not exactly
    linear in floating point (e.g. the f32 preconditioner): plain right
    GMRES assembles x = M(V y), and for an inexactly-linear M that is NOT
    sum_j y_j M(v_j) -- the Arnoldi residual estimate then silently
    diverges from the true residual (measured: reported 3e-13 vs true
    3e-1 with an f32 M).  Costs one extra (restart, n) buffer."""
    if precond is None:
        precond = _identity
    n = b.shape[0]
    m = restart
    dtype = b.dtype
    bnorm = jnp.linalg.norm(b)
    safe_bnorm = jnp.where(bnorm > 0, bnorm, 1.0)
    if x0 is None:
        x0 = jnp.zeros_like(b)

    max_outer = (maxiter + m - 1) // m

    def inner_cycle(x, total_iters):
        """One GMRES(m) cycle starting from x. Returns updated x, iters, resid."""
        r = b - matvec(x)
        beta = jnp.linalg.norm(r)
        safe_beta = jnp.where(beta > 0, beta, 1.0)
        V = jnp.zeros((m + 1, n), dtype)
        V = V.at[0].set(r / safe_beta)
        Z = jnp.zeros((m if flexible else 1, n), dtype)
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def cond(state):
            j, V, Z, H, cs, sn, g, done = state
            return jnp.logical_and(j < m, jnp.logical_not(done))

        def body(state):
            j, V, Z, H, cs, sn, g, done = state
            z = precond(V[j])
            if flexible:
                Z = Z.at[j].set(z)
            w = matvec(z)
            # CGS2 orthogonalization against all m+1 rows (rows > j are zero)
            h1 = jnp.matmul(V, w, precision=_HIGH)
            w = w - jnp.matmul(h1, V, precision=_HIGH)
            h2 = jnp.matmul(V, w, precision=_HIGH)
            w = w - jnp.matmul(h2, V, precision=_HIGH)
            h = h1 + h2
            wnorm = jnp.linalg.norm(w)
            h = h.at[j + 1].add(wnorm)
            V = V.at[j + 1].set(w / jnp.where(wnorm > 0, wnorm, 1.0))

            # apply existing Givens rotations to the new column h[0:j+2]
            def rot_body(i, hcol):
                hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hip = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                return hcol.at[i].set(hi).at[i + 1].set(hip)

            h = jax.lax.fori_loop(0, j, rot_body, h)
            # new rotation annihilating h[j+1]
            denom = jnp.hypot(h[j], h[j + 1])
            safe_denom = jnp.where(denom > 0, denom, 1.0)
            c_new = jnp.where(denom > 0, h[j] / safe_denom, 1.0)
            s_new = jnp.where(denom > 0, h[j + 1] / safe_denom, 0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            h = h.at[j].set(c_new * h[j] + s_new * h[j + 1]).at[j + 1].set(0.0)
            H = H.at[:, j].set(h[: m + 1])
            g_j = g[j]
            g = g.at[j].set(c_new * g_j).at[j + 1].set(-s_new * g_j)
            resid = jnp.abs(g[j + 1]) / safe_bnorm
            done = resid <= tol
            return (j + 1, V, Z, H, cs, sn, g, done)

        init = (0, V, Z, H, cs, sn, g, beta / safe_bnorm <= tol)
        j_fin, V, Z, H, cs, sn, g, done = jax.lax.while_loop(cond, body, init)

        # back substitution: solve H[:j, :j] y = g[:j]  (H upper triangular)
        # pad diagonal with 1 beyond j_fin so the solve is well defined
        diag_mask = jnp.arange(m) >= j_fin
        Hs = H[:m, :] + jnp.diag(jnp.where(diag_mask, 1.0, 0.0))
        gs = jnp.where(jnp.arange(m) < j_fin, g[:m], 0.0)

        def back_body(i_rev, y):
            i = m - 1 - i_rev
            s = gs[i] - jnp.dot(Hs[i], y, precision=_HIGH)
            return y.at[i].set(s / Hs[i, i])

        y = jax.lax.fori_loop(0, m, back_body, jnp.zeros(m, dtype))
        if flexible:
            dx = jnp.matmul(y, Z, precision=_HIGH)
        else:
            dx = precond(jnp.matmul(y, V[:m], precision=_HIGH))
        x_new = x + dx
        resid = jnp.abs(g[jnp.minimum(j_fin, m)]) / safe_bnorm
        return x_new, total_iters + j_fin, resid, done

    def outer_cond(state):
        k, x, iters, resid, done = state
        return jnp.logical_and(k < max_outer, jnp.logical_not(done))

    def outer_body(state):
        k, x, iters, resid, done = state
        x, iters, resid, done = inner_cycle(x, iters)
        return (k + 1, x, iters, resid, done)

    init = (0, x0, jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, dtype),
            jnp.asarray(False))
    _, x, iters, resid, _ = jax.lax.while_loop(outer_cond, outer_body, init)
    return GmresResult(x, iters, resid)


def gmres_ir(matvec: Callable, b: jax.Array, matvec32: Callable,
             precond32: Optional[Callable] = None, tol: float = 1e-14,
             maxiter: int = 100, restart: int = 30,
             inner_tol: float = 1e-4) -> GmresResult:
    """Mixed-precision iterative-refinement GMRES (for devices where f32
    is much cheaper than f64).

    Outer loop (f64): compute the true residual r = b - A x, stop when
    ||r|| <= tol ||b||.  Inner solve (f32): one FGMRES(restart) cycle on the
    NORMALIZED residual with the f32 operator and preconditioner, reducing
    it by ~inner_tol; the f64 correction x += ||r|| * d recovers full
    accuracy.  Standard IR-with-Krylov-correction structure (Turner &
    Walker '92); accuracy is set entirely by the f64 residual replay.

    inner_tol must sit WELL ABOVE the f32 noise floor: the f32
    matvec+preconditioner stall near ~1e-5 relative (measured: inner
    cycles to 3e-6 burn a full restart of iterations where the f64 rate
    predicts ~8), so 1e-4 per cycle x a few cycles is the cheap regime.

    The returned residual is the honestly recomputed f64 relative residual
    of the final x (NOT the inner Arnoldi estimate)."""
    dtype = b.dtype
    bnorm = jnp.linalg.norm(b)
    safe_bnorm = jnp.where(bnorm > 0, bnorm, 1.0)
    x0 = jnp.zeros_like(b)
    max_outer = max(2, (maxiter + restart - 1) // restart)

    def cond(state):
        k, x, tot, resid, done = state
        return jnp.logical_and(k < max_outer, jnp.logical_not(done))

    def body(state):
        k, x, tot, resid, done = state
        r = b - matvec(x)
        rnorm = jnp.linalg.norm(r)
        resid = rnorm / safe_bnorm
        done = resid <= tol

        def refine(arg):
            x, tot = arg
            safe = jnp.where(rnorm > 0, rnorm, 1.0)
            r32 = (r / safe).astype(jnp.float32)
            inner = gmres(matvec32, r32, precond=precond32,
                          tol=inner_tol, maxiter=restart, restart=restart,
                          flexible=precond32 is not None)
            return (x + safe * inner.x.astype(dtype),
                    tot + inner.iterations)

        x, tot = jax.lax.cond(done, lambda a: a, refine, (x, tot))
        return (k + 1, x, tot, resid, done)

    init = (0, x0, jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, dtype),
            jnp.asarray(False))
    _, x, tot, resid, done = jax.lax.while_loop(cond, body, init)
    # honest final residual (resid in-state lags the last correction)
    final = jnp.linalg.norm(b - matvec(x)) / safe_bnorm
    return GmresResult(x, tot, final)
