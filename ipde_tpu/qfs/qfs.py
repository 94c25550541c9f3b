"""QFS: Quadrature by Fundamental Solutions (effective-source maps).

To evaluate a layer potential accurately arbitrarily close to (or on) its
curve, replace it by an equivalent density xi on a source curve shifted to
the far side of the evaluation region, solving

    A xi = B tau      (matched on the original curve)

where B is the spectrally-accurate singular self-evaluation of the layer
potential and A the (smooth) kernel matrix from the shifted sources.  Both
maps are geometry-static dense matrices: the apply is one f64 matmul.

Re-derivation of the reference's external qfs package surface
(QFS_Boundary / QFS_Evaluator / Laplace_QFS / Modified_Helmholtz_QFS /
`u2s`; SURVEY.md 2.2 and ipde/solvers/internals/scalar.py:87-113).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ipde_tpu.geometry.curve import BoundaryCurve
from ipde_tpu.ops import singular as sq

_HIGH = jax.lax.Precision.HIGHEST


def _mv(M, x):
    return jnp.matmul(M, x, precision=_HIGH)


def _reg_pinv(A: np.ndarray, rcond: float) -> np.ndarray:
    """Regularized pseudo-inverse of the exponentially ill-conditioned QFS
    system via rank-revealing pivoted QR (LAPACK gelsy).  ~2x faster than
    the truncated SVD on these shapes and measurably MORE accurate on QFS
    systems (pivoting follows the exponential column grading); SVD kept as
    fallback."""
    import scipy.linalg as sla
    try:
        X, _, _, _ = sla.lstsq(A, np.eye(A.shape[0]), cond=rcond,
                               lapack_driver="gelsy")
        return X
    except Exception:
        U, s, Vt = np.linalg.svd(A, full_matrices=False)
        cut = s > rcond * s[0]
        si = np.where(cut, 1.0 / np.maximum(s, 1e-300), 0.0)
        return (Vt.T * si) @ U.T


def _rule36(n: int) -> np.ndarray:
    """'Rule 36' spectral filter exp(-36 (k/kmax)^36) on the fftfreq grid
    (reference: ipde/utilities.py:126-162): ~1 below 0.8 Nyquist, ~2e-16 at
    Nyquist."""
    k = np.abs(np.fft.fftfreq(n, 1.0 / n))
    return np.exp(-36.0 * (k / k.max()) ** 36)


def _filter_rows(Bmat: np.ndarray, ncurve: int) -> np.ndarray:
    """F @ B applied spectrally per ncurve-sized component block (the
    explicit circulant matmul costs an extra O(n^3) per map at setup)."""
    filt = _rule36(ncurve)
    out = np.empty_like(Bmat)
    for c in range(Bmat.shape[0] // ncurve):
        blk = Bmat[c * ncurve:(c + 1) * ncurve]
        out[c * ncurve:(c + 1) * ncurve] = np.fft.ifft(
            filt[:, None] * np.fft.fft(blk, axis=0), axis=0).real
    return out


def _filter_cols(Mmat: np.ndarray, ncurve: int) -> np.ndarray:
    """M @ F per component block (F is symmetric)."""
    filt = _rule36(ncurve)
    out = np.empty_like(Mmat)
    for c in range(Mmat.shape[1] // ncurve):
        blk = Mmat[:, c * ncurve:(c + 1) * ncurve]
        out[:, c * ncurve:(c + 1) * ncurve] = np.fft.ifft(
            filt[None, :] * np.fft.fft(blk, axis=1), axis=1).real
    return out


_RESAMPLE_CACHE: dict = {}


def resample_dev(n_in: int, n_out: int):
    """Device (n_out, n_in) exact trigonometric-interpolation matrix for
    periodic uniform grids (spectral upsampling).  Built once per size pair
    and cached: QFS evaluators on same-resolution curves all share it (and
    planify dedupes it to ONE jit argument by id)."""
    key = (n_in, n_out)
    got = _RESAMPLE_CACHE.get(key)
    if got is None:
        F = np.fft.fft(np.eye(n_in), axis=0)
        rows = np.mod(np.fft.fftfreq(n_in, 1.0 / n_in).round().astype(int),
                      n_out)
        Fp = np.zeros((n_out, n_in), np.complex128)
        Fp[rows] = F
        # .real of the (one-sided-Nyquist) inverse = the usual split-Nyquist
        # hermitian symmetrization
        got = jnp.asarray(np.fft.ifft(Fp, axis=0).real * (n_out / n_in))
        _RESAMPLE_CACHE[key] = got
    return got


class QFSEvaluator:
    """Maps layer densities on `curve` to an effective density on `source`.

    forms: list of (N x N) self-evaluation matrices (e.g. [SLP_self] or
    [SLP_self, DLP_self]); A: (N x N_src) kernel matrix source -> curve.
    __call__([tau_1, tau_2, ...]) returns xi with
        A xi = sum_i forms[i] tau_i.
    u2s(u) returns xi with A xi = u (values given directly on the curve).

    The composed maps are low-passed with the rule-36 filter: the pinv
    amplifies near-Nyquist input exponentially (exp(shift * k)), and while
    those huge high-mode source densities produce only attenuated fields in
    exact arithmetic, a matmul's roundoff scales with the MATRIX norm, so
    an unfiltered map of norm ~1e6 costs digits in every solve.  Filtering the input
    modes the amplification acts on cuts the composed norm ~100x at a field
    error of order the (converged) density's top-mode content, ~1e-13.

    Band-limited source compression (device backend): the source curve is
    upsampled (N_src = u * N) for quadrature accuracy, but the effective
    density it carries is band-limited to the FILTERED input band (< the
    N-grid Nyquist): the min-norm solve therefore runs in an N-point
    coefficient space eta with xi = U eta (U = spectral upsampling), making
    every stored map (c*N, c*N) instead of (c*N_src, c*N) -- 3x less HBM
    and 3x fewer flops at the default upsampling, with U shared globally.
    """

    def __init__(self, source: BoundaryCurve, curve: BoundaryCurve,
                 forms: Sequence, A, rcond: float = 1e-15,
                 build_u2s: bool = True, backend: str = "host"):
        """build_u2s=False skips the values->source map: it is only
        consumed by multi-body correction passes.

        backend='host': LAPACK gelsy pseudo-inverse (ground truth; numpy
        inputs).  backend='device': blocked min-norm composition on the
        accelerator (ops/device_linalg.minnorm_compose) -- forms/A may be
        device arrays born on the device (ops/forms_dev) so nothing large
        crosses the host link; ~50x faster at nb=2700 on one weak host core.
        """
        self.source = source
        self.curve = curve
        assert (np.shape(A)[0] // curve.N) * curve.N == np.shape(A)[0]
        if backend == "device":
            from ipde_tpu.ops.device_linalg import minnorm_compose
            from ipde_tpu.ops.forms_dev import filter_cols_dev, \
                filter_rows_dev
            import os
            A = jnp.asarray(A)
            S, N = source.N, curve.N
            ncomp = A.shape[1] // S
            if S > N and not os.environ.get("IPDE_QFS_NOCOMPRESS"):
                U = resample_dev(N, S)
                A = jnp.concatenate(
                    [_mv(A[:, c * S:(c + 1) * S], U)
                     for c in range(ncomp)], axis=1)
                self.up = U
            else:
                self.up = None
            self._ncomp = ncomp
            comps = [filter_rows_dev(jnp.asarray(B), curve.N) for B in forms]
            if build_u2s:
                eye = jnp.eye(A.shape[0], dtype=A.dtype)
                comps.append(filter_cols_dev(eye, curve.N))
            if os.environ.get("IPDE_QFS_SAVE"):
                # offline conditioning studies (tools/compose_probe.py)
                import numpy as _np
                pre = os.environ["IPDE_QFS_SAVE"]
                _np.save(pre + "_A.npy", _np.asarray(A))
                _np.save(pre + "_B0.npy", _np.asarray(comps[0]))
            maps = minnorm_compose(
                A, comps,
                refine=int(os.environ.get("IPDE_QFS_REFINE", "2")))
            if build_u2s:
                self.u2s_mat = maps.pop()
            else:
                self.u2s_mat = None
            self.mats = maps
            return
        self.up = None
        self._ncomp = np.shape(A)[1] // source.N
        Apinv = _reg_pinv(np.asarray(A), rcond)
        self.mats = [jnp.asarray(Apinv @ _filter_rows(np.asarray(B), curve.N))
                     for B in forms]
        self.u2s_mat = (jnp.asarray(_filter_cols(Apinv, curve.N))
                        if build_u2s else None)

    def _upsample(self, eta):
        """eta (ncomp * N,) coefficient-space density -> xi (ncomp * N_src,)
        pointwise on the source curve (identity when maps are full-size)."""
        if self.up is None:
            return eta
        N = self.curve.N
        parts = [_mv(self.up, eta[c * N:(c + 1) * N])
                 for c in range(self._ncomp)]
        return jnp.concatenate(parts) if self._ncomp > 1 else parts[0]

    def __call__(self, densities):
        out = None
        for M, tau in zip(self.mats, densities):
            v = _mv(M, jnp.asarray(tau))
            out = v if out is None else out + v
        return self._upsample(out)

    def u2s(self, u):
        if self.u2s_mat is None:
            raise RuntimeError("QFSEvaluator built with build_u2s=False")
        return self._upsample(_mv(self.u2s_mat, jnp.asarray(u)))


# -- kernel-specific constructors --------------------------------------------

def auto_backend() -> str:
    """QFS setup backend: 'host' (LAPACK gelsy ground truth) unless
    IPDE_QFS_BACKEND=device selects the blocked min-norm composition on
    the accelerator."""
    import os
    env = os.environ.get("IPDE_QFS_BACKEND")
    return env if env in ("host", "device") else "host"


def laplace_qfs(curve: BoundaryCurve, source: BoundaryCurve, interior: bool,
                slp: bool = True, dlp: bool = True,
                rcond: float = 1e-15, build_u2s: bool = True,
                backend: str = None) -> QFSEvaluator:
    """Laplace QFS: effective single-layer density on `source` reproducing
    SLP/DLP of densities on `curve`, matched as the one-sided limit on the
    evaluation side (`interior`=True -> limit from inside the curve:
    DLP -> PV - tau/2; from outside: PV + tau/2)."""
    backend = backend or auto_backend()
    jump = -0.5 if interior else 0.5
    N = curve.N
    forms = []
    if backend == "device":
        from ipde_tpu.ops import forms_dev as fd
        if slp:
            forms.append(fd.laplace_slp_self_dev(curve))
        if dlp:
            forms.append(fd.laplace_dlp_self_dev(curve)
                         + jump * jnp.eye(N))
        A = fd.laplace_slp_naive_dev(source, curve.x, curve.y)
    else:
        if slp:
            forms.append(sq.laplace_slp_self(curve))
        if dlp:
            forms.append(sq.laplace_dlp_self(curve) + jump * np.eye(N))
        A = sq.laplace_slp_naive(source, curve.x, curve.y)
    return QFSEvaluator(source, curve, forms, A, rcond,
                        build_u2s=build_u2s, backend=backend)


def mh_qfs(curve: BoundaryCurve, source: BoundaryCurve, interior: bool,
           k: float, slp: bool = True, dlp: bool = True,
           rcond: float = 1e-15, build_u2s: bool = True,
           backend: str = None) -> QFSEvaluator:
    backend = backend or auto_backend()
    jump = -0.5 if interior else 0.5
    N = curve.N
    # Yukawa SELF forms stay host-built (banded Kress split with scipy
    # i0/i1 + trig oversampling); they are (N, N) -- small next to the
    # (N, N_src) naive system, which IS device-born below.
    forms = []
    if slp:
        forms.append(sq.mh_slp_self(curve, k))
    if dlp:
        forms.append(sq.mh_dlp_self(curve, k) + jump * np.eye(N))
    if backend == "device":
        from ipde_tpu.ops import forms_dev as fd
        A = fd.mh_slp_naive_dev(source, curve.x, curve.y, k)
    else:
        A = sq.mh_slp_naive(source, curve.x, curve.y, k)
    return QFSEvaluator(source, curve, forms, A, rcond,
                        build_u2s=build_u2s, backend=backend)
