"""Blocked dense factorizations on the accelerator (setup-time linear algebra).

The reference outsources its setup factorizations to LAPACK on a workstation
(QFS pseudo-inverses via ``scipy.linalg.lstsq``; BIE inverses via
``numpy.linalg.inv`` -- ipde's qfs package and example drivers).  These
routines run the O(n^3) work on the device instead (IPDE_QFS_BACKEND=device,
IPDE_BIE_BACKEND=device).

Design:
  * Each whole factorization is ONE jitted program (fori over blocks,
    in-jit 256x256 diagonal-block Cholesky/LU + triangular inverses).
    Host round trips per factorization: one NaN fetch.
  * No pivoting in the blocked LU: its consumers are second-kind BIE
    systems (I/2 + compact), which are well conditioned; callers can run
    iterative refinement on top.

Factorization quality is validated against LAPACK in
tests/test_device_linalg.py.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

_HIGH = jax.lax.Precision.HIGHEST
BLOCK = 256


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGH)


def _sync(x):
    """Bound the eager dispatch queue.  Buffers are ALLOCATED at dispatch
    time, so an unsynchronized loop of (npad, m) f64 intermediates keeps
    every iteration's arrays resident at once (tens of GB in flight for a
    5400-dof Stokes QFS compose)."""
    return x.block_until_ready()


def _pad_to_blocks(n: int, block: int) -> int:
    return -(-n // block) * block


def _pad_spd(G, npad: int):
    """Pad an SPD matrix to (npad, npad) with an identity tail block."""
    n = G.shape[0]
    if npad == n:
        return G
    Gp = jnp.zeros((npad, npad), G.dtype)
    Gp = jax.lax.dynamic_update_slice(Gp, G, (jnp.int32(0), jnp.int32(0)))
    idx = jnp.arange(npad)
    tail = jnp.where(idx >= n, 1.0, 0.0)
    return Gp + jnp.diag(tail)


class CholFactor:
    """Lower Cholesky factor of a padded SPD matrix, with device mirrors of
    the per-block inverse diagonal factors (consumed by the blocked
    triangular solves).  diag_invs is a stacked (nblk, block, block)
    device array."""

    def __init__(self, L, diag_invs, n: int, block: int):
        self.L = L
        self.diag_invs = diag_invs
        self.n = n
        self.block = block
        self.npad = L.shape[0]


def _chol_unblocked(A):
    """In-jit dense Cholesky of one SPD block (fori over columns with
    masked rank-1 updates; a non-PD pivot produces NaN, which the caller
    detects with one fetch).  O(b^3) work -- trivial on device, and it
    removes a per-block host round trip."""
    n = A.shape[0]
    idx = jnp.arange(n)

    def body(j, W):
        d = jnp.sqrt(W[j, j])
        c_ = W[:, j] / d
        cfull = jnp.where(idx >= j, c_, 0.0)
        cstrict = jnp.where(idx > j, c_, 0.0)
        W = W - cstrict[:, None] * cstrict[None, :]
        return W.at[:, j].set(cfull)

    W = jax.lax.fori_loop(0, n, body, A)
    return jnp.tril(W)


def _tril_inv(L, unit: bool = False):
    """In-jit inverse of a lower-triangular block by row-forward
    substitution on the identity."""
    n = L.shape[0]
    idx = jnp.arange(n)

    def body(j, X):
        row = jnp.where(idx < j, L[j, :], 0.0)
        acc = jnp.matmul(row, X, precision=_HIGH)
        ej = (idx == j).astype(L.dtype)
        piv = 1.0 if unit else L[j, j]
        return X.at[j, :].set((ej - acc) / piv)

    return jax.lax.fori_loop(0, n, body, jnp.zeros_like(L))


def _triu_inv(U):
    """In-jit inverse of an upper-triangular block (backward)."""
    n = U.shape[0]
    idx = jnp.arange(n)

    def body(r, X):
        j = n - 1 - r
        row = jnp.where(idx > j, U[j, :], 0.0)
        acc = jnp.matmul(row, X, precision=_HIGH)
        ej = (idx == j).astype(U.dtype)
        return X.at[j, :].set((ej - acc) / U[j, j])

    return jax.lax.fori_loop(0, n, body, jnp.zeros_like(U))


@functools.partial(jax.jit, static_argnames=("block",))
def _cholesky_blocked_jit(Gp, block: int):
    """Blocked right-looking Cholesky, the WHOLE factorization as one
    compiled program (fori over blocks).
    Returns (L, diag_invs stacked)."""
    npad = Gp.shape[0]
    nblk = npad // block
    ridx = jnp.arange(npad)

    def body(kb, carry):
        work, L, Dinv = carry
        j0 = kb * block
        Gkk = jax.lax.dynamic_slice(work, (j0, j0), (block, block))
        Lkk = _chol_unblocked(Gkk)
        Likk = _tril_inv(Lkk)
        pan = jax.lax.dynamic_slice(work, (0 * j0, j0), (npad, block))
        # exact panel/Schur products: plain-dot noise here lands IN the
        # factor, so the refinement preconditioner quality degrades from
        # cond(G) 2^-48 to cond(G) 2^-24 -- divergent for the cond ~ 1e9
        # QFS Gram systems (measured: dd-compose stuck at 1e-5).
        Lp = _mm(pan, Likk.T)
        below = (ridx >= (kb + 1) * block)[:, None]
        Lbelow = jnp.where(below, Lp, 0.0)
        col = jax.lax.dynamic_update_slice(Lbelow, Lkk, (j0, 0 * j0))
        L = jax.lax.dynamic_update_slice(L, col, (0 * j0, j0))
        work = work - _mm(Lbelow, Lbelow.T)
        Dinv = jax.lax.dynamic_update_slice(Dinv, Likk[None],
                                            (kb, 0 * kb, 0 * kb))
        return (work, L, Dinv)

    init = (Gp, jnp.zeros_like(Gp),
            jnp.zeros((nblk, block, block), Gp.dtype))
    _, L, Dinv = jax.lax.fori_loop(0, nblk, body, init)
    return L, Dinv


def cholesky_blocked(G, block: int = BLOCK) -> CholFactor:
    """Blocked right-looking Cholesky of SPD ``G`` on the device.

    Returns a CholFactor with L lower triangular (padded size).  Raises
    np.linalg.LinAlgError if a diagonal block is not positive definite
    (surface the failure rather than silently regularizing)."""
    n = G.shape[0]
    npad = _pad_to_blocks(n, block)
    work = _pad_spd(jnp.asarray(G), npad)
    L, Dinv = _cholesky_blocked_jit(work, block)
    # non-PD pivots surface as NaN through the sqrt
    if bool(jnp.isnan(jax.lax.slice(L, (0, 0), (npad, 1))).any()) \
            or bool(jnp.isnan(L[-1, -1])):
        raise np.linalg.LinAlgError("cholesky_blocked: block not PD")
    return CholFactor(L, Dinv, n, block)


def _pad_rows(Bmat, npad: int):
    b = jnp.asarray(Bmat)
    if b.ndim == 1:
        b = b[:, None]
    if b.shape[0] == npad:
        return b
    Z = jnp.zeros((npad, b.shape[1]), b.dtype)
    return jax.lax.dynamic_update_slice(Z, b, (jnp.int32(0), jnp.int32(0)))


@functools.partial(jax.jit, static_argnames=("block",))
def _solve_lower_jit(L, Dinv, X, block: int):
    npad = L.shape[0]
    nblk = npad // block
    cidx = jnp.arange(npad)[None, :]

    def body(kb, X):
        j0 = kb * block
        Lrow = jax.lax.dynamic_slice(L, (j0, 0 * j0), (block, npad))
        Lrow = jnp.where(cidx < j0, Lrow, 0.0)
        acc = _mm(Lrow, X)
        Xkb = jax.lax.dynamic_slice(X, (j0, 0 * j0), (block, X.shape[1]))
        Xkb = _mm(Dinv[kb], Xkb - acc)
        return jax.lax.dynamic_update_slice(X, Xkb, (j0, 0 * j0))

    return jax.lax.fori_loop(0, nblk, body, X)


@functools.partial(jax.jit, static_argnames=("block",))
def _solve_lower_t_jit(L, Dinv, X, block: int):
    npad = L.shape[0]
    nblk = npad // block
    cidx = jnp.arange(npad)[None, :]

    def body(r, X):
        kb = nblk - 1 - r
        j0 = kb * block
        # (L^T)[kb-row-panel, :] = L[:, kb-cols]^T; strict part masked to
        # columns >= (kb+1) block
        Lcol = jax.lax.dynamic_slice(L, (0 * j0, j0), (npad, block))
        LrowT = jnp.where(cidx >= (kb + 1) * block, Lcol.T, 0.0)
        acc = _mm(LrowT, X)
        Xkb = jax.lax.dynamic_slice(X, (j0, 0 * j0), (block, X.shape[1]))
        Xkb = _mm(jnp.transpose(Dinv[kb]), Xkb - acc)
        return jax.lax.dynamic_update_slice(X, Xkb, (j0, 0 * j0))

    return jax.lax.fori_loop(0, nblk, body, X)


def solve_lower(F: CholFactor, Bmat):
    """X with L X = B (rows of B beyond F.n are treated as zero)."""
    return _solve_lower_jit(F.L, F.diag_invs, _pad_rows(Bmat, F.npad),
                            F.block)


def solve_lower_t(F: CholFactor, Bmat):
    """X with L^T X = B (backward pass)."""
    return _solve_lower_t_jit(F.L, F.diag_invs, _pad_rows(Bmat, F.npad),
                              F.block)


def spd_solve(F: CholFactor, Bmat):
    """G^{-1} B through the Cholesky factor; output clipped to F.n rows."""
    X = solve_lower_t(F, solve_lower(F, Bmat))
    out = X[: F.n]
    return out[:, 0] if np.ndim(Bmat) == 1 else out


# ---------------------------------------------------------------------------
# blocked LU (no pivoting) + explicit inverse, for second-kind BIE systems
# ---------------------------------------------------------------------------

def _lu_unblocked(A):
    """In-jit dense no-pivot LU of one block: returns combined LU storage
    (unit-lower strict part + upper), as in the classic kij formulation."""
    n = A.shape[0]
    idx = jnp.arange(n)

    def body(j, W):
        piv = W[j, j]
        m = jnp.where(idx > j, W[:, j] / piv, 0.0)
        rowj = jnp.where(idx >= j, W[j, :], 0.0)
        W = W - m[:, None] * rowj[None, :]
        return W.at[:, j].set(jnp.where(idx > j, m, W[:, j]))

    return jax.lax.fori_loop(0, n, body, A)


@functools.partial(jax.jit, static_argnames=("block",))
def _lu_inverse_blocked_jit(work, block: int):
    """Blocked no-pivot LU + explicit inverse as ONE compiled program
    (see cholesky_blocked: the eager per-block host round trips made cold
    setup fetch-latency-bound)."""
    npad = work.shape[0]
    nblk = npad // block
    ridx = jnp.arange(npad)[:, None]
    cidx = jnp.arange(npad)[None, :]

    def factor_body(kb, carry):
        work, L, U, Li, Ui = carry
        j0 = kb * block
        Akk = jax.lax.dynamic_slice(work, (j0, j0), (block, block))
        LU = _lu_unblocked(Akk)
        Lkk = jnp.tril(LU, -1) + jnp.eye(block, dtype=LU.dtype)
        Ukk = jnp.triu(LU)
        Likk = _tril_inv(Lkk, unit=True)
        Uikk = _triu_inv(Ukk)
        # row panel of U: Likk @ A[kb, :] (strict right part)
        Arow = jax.lax.dynamic_slice(work, (j0, 0 * j0), (block, npad))
        Urow = _mm(Likk, Arow)
        Urow = jnp.where(cidx >= (kb + 1) * block, Urow, 0.0)
        # col panel of L: A[:, kb] @ Uikk (strict below part)
        Acol = jax.lax.dynamic_slice(work, (0 * j0, j0), (npad, block))
        Lcol = _mm(Acol, Uikk)
        Lcol = jnp.where(ridx >= (kb + 1) * block, Lcol, 0.0)
        Urow_full = jax.lax.dynamic_update_slice(Urow, Ukk, (0 * j0, j0))
        Lcol_full = jax.lax.dynamic_update_slice(Lcol, Lkk, (j0, 0 * j0))
        L = jax.lax.dynamic_update_slice(L, Lcol_full, (0 * j0, j0))
        U = jax.lax.dynamic_update_slice(U, Urow_full, (j0, 0 * j0))
        work = work - _mm(Lcol, Urow)
        Li = jax.lax.dynamic_update_slice(Li, Likk[None],
                                          (kb, 0 * kb, 0 * kb))
        Ui = jax.lax.dynamic_update_slice(Ui, Uikk[None],
                                          (kb, 0 * kb, 0 * kb))
        return (work, L, U, Li, Ui)

    zeros = jnp.zeros_like(work)
    dzeros = jnp.zeros((nblk, block, block), work.dtype)
    _, L, U, Li, Ui = jax.lax.fori_loop(
        0, nblk, factor_body, (work, zeros, zeros, dzeros, dzeros))

    # Ainv = U^{-1} (L^{-1} I): forward then backward blocked solves
    def fwd_body(kb, X):
        j0 = kb * block
        Lrow = jax.lax.dynamic_slice(L, (j0, 0 * j0), (block, npad))
        Lrow = jnp.where(cidx < j0, Lrow, 0.0)
        acc = _mm(Lrow, X)
        Xkb = jax.lax.dynamic_slice(X, (j0, 0 * j0), (block, npad))
        Xkb = _mm(Li[kb], Xkb - acc)
        return jax.lax.dynamic_update_slice(X, Xkb, (j0, 0 * j0))

    X = jax.lax.fori_loop(0, nblk, fwd_body,
                          jnp.eye(npad, dtype=work.dtype))

    def bwd_body(r, X):
        kb = nblk - 1 - r
        j0 = kb * block
        Urow = jax.lax.dynamic_slice(U, (j0, 0 * j0), (block, npad))
        Urow = jnp.where(cidx >= (kb + 1) * block, Urow, 0.0)
        acc = _mm(Urow, X)
        Xkb = jax.lax.dynamic_slice(X, (j0, 0 * j0), (block, npad))
        Xkb = _mm(Ui[kb], Xkb - acc)
        return jax.lax.dynamic_update_slice(X, Xkb, (j0, 0 * j0))

    return jax.lax.fori_loop(0, nblk, bwd_body, X)


def lu_inverse_blocked(A, block: int = BLOCK):
    """Explicit inverse of a well-conditioned square matrix via blocked
    no-pivot LU on the device.  Intended for second-kind BIE matrices
    (jump/2 + compact operator): diagonal dominance makes no-pivot LU
    stable there; consumers add iterative refinement at apply time."""
    A = jnp.asarray(A)
    n = A.shape[0]
    npad = _pad_to_blocks(n, block)
    work = _pad_spd(A, npad)      # identity tail keeps the LU well posed
    X = _lu_inverse_blocked_jit(work, block)
    return _sync(X)[:n, :n]


# ---------------------------------------------------------------------------
# QFS min-norm pseudo-inverse composition
# ---------------------------------------------------------------------------

def minnorm_compose(A, forms: Sequence, lam_rel: float = 0.0,
                    refine: int = 1, block: int = BLOCK):
    """Maps M_i = A^+ F_i for a WIDE full-row-rank system A (m, n) via
    CholeskyQR2 min-norm on the device.

    With A^T = Q R (Q n x m orthonormal columns, R m x m upper),
    A^+ = Q R^{-T}, so  M = Q L_tot^{-1} F  with L_tot = R^T lower.
    CholeskyQR computes R from the blocked Cholesky of G = A A^T and
    Q^T = L^{-1} A by a blocked forward solve; a second pass on Q^T
    re-orthonormalizes (CholeskyQR2), making the factorization backward
    stable: the map residual is ~ u sigma_max |M| INDEPENDENT of cond(G).

    Why not normal equations + iterative refinement: the production QFS
    systems reach cond(G) ~ 4e13 (measured by spectrum analysis) with genuine form content in the near-null
    directions, so refinement against G diverges there and its noise
    contaminates every direction (residual stuck at 1e-2-scale).
    CholeskyQR2 needs cond(G) u < 1: with f64 products u ~ 2^-53 and
    cond(G) 4e13 gives ~5e-3 -- inside; the shifted retry below covers
    harder geometries (classic shifted CholeskyQR3).

    lam_rel > 0 adds explicit Tikhonov damping lam_rel * mean(diag G) on
    TOP of the structural stability (biases the map; off by default).
    ``refine`` residual-correction passes run on each map (they reduce
    the triangular-solve roundoff carried by maps of norm ~ 1e5).

    A and forms may be numpy or device arrays; returns device maps (n, m).
    """
    import time as _time
    _tmr = os.environ.get("IPDE_COMPOSE_TIME")
    _tt = [_time.time()]

    def _tick(tag, x=None):
        # stage wall-clock WITH a sync barrier, so asynchronous device
        # work attributes to the stage that queued it
        if _tmr:
            if x is not None:
                _sync(x)
            now = _time.time()
            print(f"  compose[{tag}]: {now - _tt[0]:.1f}s", flush=True)
            _tt[0] = now

    A = jnp.asarray(A)
    At = A.T.copy()     # materialize ONCE (each eager _mm(A.T, .) would
                        # re-materialize the transpose as a fresh buffer)
    _tick("inputs", A)
    G = _mm(A, At)
    _tick("gram", G)
    m = G.shape[0]
    if lam_rel:
        lam = lam_rel * float(jnp.trace(G) / m)
        G = G + lam * jnp.eye(m, dtype=G.dtype)
    def _chol_shifted(Gm):
        """Blocked Cholesky with shifted retries (shifted CholeskyQR:
        jitter by multiples of u |G|; later passes remove the shift's
        effect on Q).  Returns (factor, shifted?)."""
        shift = 0.0
        for _ in range(6):
            try:
                return cholesky_blocked(Gm, block=block), bool(shift)
            except np.linalg.LinAlgError:
                shift = (shift or 1e-13 * float(jnp.trace(Gm)
                                                / Gm.shape[0])) * 100.0
                Gm = Gm + shift * jnp.eye(Gm.shape[0], dtype=Gm.dtype)
        raise np.linalg.LinAlgError("minnorm_compose: Gram not PD")

    F1, _ = _chol_shifted(G)
    _tick("chol1", F1.L)
    del G
    # Q^T = L1^{-1} A  (m x n, padded rows clipped by spd-style slicing)
    QT = solve_lower(F1, A)[:m]
    _tick("qt1", QT)
    # CholeskyQR2: re-orthonormalize Q^T rows
    F2, shifted2 = _chol_shifted(_mm(QT, QT.T))
    _tick("chol2", F2.L)
    QT = solve_lower(F2, QT)[:m]
    factors = [F1, F2]
    if shifted2:
        # pass 2 was itself shifted (cond beyond the QR2 envelope):
        # one more pass restores orthonormality (shifted CholeskyQR3)
        F3, _ = _chol_shifted(_mm(QT, QT.T))
        QT = solve_lower(F3, QT)[:m]
        factors.append(F3)
    Q = _sync(QT.T.copy())
    _tick("q")
    dbg = os.environ.get("IPDE_COMPOSE_DEBUG")

    def ltot_solve(Bmat):
        # L_tot = L1 L2 (L3) (R_tot = R3 R2 R1): successive forward solves
        X = Bmat
        for Fk in factors:
            X = solve_lower(Fk, X)[:m]
        return X

    # EXPLICIT pseudo-inverse E = Q L_tot^{-1} (n, m): two-or-three
    # blocked substitutions ONCE (on the identity) + one GEMM, after which
    # every form map and every refinement correction is a single GEMM
    # instead of ~130 eager dispatches per substitution.
    E = _sync(_mm(Q, ltot_solve(jnp.eye(m, dtype=A.dtype))))
    _tick("einv")

    maps = []
    for Bf in forms:
        Bf = jnp.asarray(Bf)
        M = _mm(E, Bf)
        for it in range(refine):
            R = Bf - _mm(A, _sync(M))
            if dbg:
                print(f"  compose refine {it}: |R|_inf = "
                      f"{float(jnp.max(jnp.abs(R))):.3e}", flush=True)
            M = M + _mm(E, R)
        if dbg:
            R = Bf - _mm(A, _sync(M))
            print(f"  compose final : |R|_inf = "
                  f"{float(jnp.max(jnp.abs(R))):.3e}", flush=True)
        maps.append(_sync(M))
        _tick("map")
    return maps
