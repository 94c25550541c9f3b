"""Fourier transforms and spectral operators.

Transforms are built from real float64 matmuls against precomputed DFT
matrices (boundary/annular transforms are n <= ~4096).  The 2D plan uses the
native complex128 ``jnp.fft`` instead on backends that have one
(``config.backend_has_complex128``), except under a mesh.

This module replaces the reference's mkl_fft usage and the Nyquist-handling
helpers (reference: ipde/utilities.py:78-124) with one design: transforms are
exposed as *plans* holding the DFT matrices; spectral differentiation is a
precomputed real circulant matrix applied by matmul.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ipde_tpu.ops.cx import Cx, matmul

_HIGH = jax.lax.Precision.HIGHEST


def _dot(a, b):
    return jnp.matmul(a, b, precision=_HIGH)


# ---------------------------------------------------------------------------
# host-side matrix builders (numpy, float64)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _dft_mats_np(n: int):
    """Forward DFT matrix F = C + iS with F[k, j] = exp(-2i pi k j / n)."""
    kj = np.outer(np.arange(n), np.arange(n)) % n
    ang = -2.0 * np.pi * kj / n
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=64)
def _rdft_mats_np(n: int):
    """Real-input DFT: rows k = 0..n//2 of the DFT matrix."""
    nk = n // 2 + 1
    kj = np.outer(np.arange(nk), np.arange(n)) % n
    ang = -2.0 * np.pi * kj / n
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=64)
def _irdft_mats_np(n: int):
    """Inverse of the real DFT: maps nk=n//2+1 complex coeffs -> n reals.

    x_j = (1/n) sum_k w_k [Re F_k cos(2 pi k j/n) - Im F_k sin(2 pi k j/n)]
    with w_k = 2 except w_0 = 1 and (n even) w_{n/2} = 1.
    """
    nk = n // 2 + 1
    w = np.full(nk, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    jk = np.outer(np.arange(n), np.arange(nk))
    ang = 2.0 * np.pi * jk / n
    cr = np.cos(ang) * w / n
    ci = -np.sin(ang) * w / n
    return cr, ci


def rfftfreq_np(n: int, h: float = 1.0) -> np.ndarray:
    return np.fft.rfftfreq(n, h)


def fftfreq_np(n: int, h: float = 1.0) -> np.ndarray:
    return np.fft.fftfreq(n, h)


@functools.lru_cache(maxsize=64)
def spectral_diff_matrix_np(n: int, order: int = 1, length: float = 2.0 * np.pi):
    """Real n x n Fourier spectral differentiation matrix on a periodic grid.

    Built exactly as D = ifft(diag((ik)^order) fft(I)).real, with the Nyquist
    mode zeroed for odd derivative orders (standard choice; the reference drops
    or zeroes the Nyquist mode throughout, e.g. ipde/utilities.py:78-124).
    """
    k = np.fft.fftfreq(n, 1.0 / n) * (2.0 * np.pi / length)
    ik = (1j * k) ** order
    if order % 2 == 1 and n % 2 == 0:
        ik[n // 2] = 0.0
    D = np.fft.ifft(ik[:, None] * np.fft.fft(np.eye(n), axis=0), axis=0).real
    return D


# ---------------------------------------------------------------------------
# 1D plans
# ---------------------------------------------------------------------------

class FourierPlan1D:
    """Matmul-based 1D DFT along the LAST axis of an array.

    ``rfft`` maps a real array (..., n) to a Cx (..., nk); ``irfft`` inverts.
    ``tderiv`` applies the real spectral differentiation circulant.
    """

    def __init__(self, n: int, length: float = 2.0 * np.pi):
        self.n = n
        self.nk = n // 2 + 1
        self.length = length
        cr, sr = _rdft_mats_np(n)
        self.RC = jnp.asarray(cr.T)   # (n, nk): right-multiply
        self.RS = jnp.asarray(sr.T)
        icr, ici = _irdft_mats_np(n)
        self.IRC = jnp.asarray(icr.T)  # (nk, n)
        self.IRI = jnp.asarray(ici.T)
        self.D1 = jnp.asarray(spectral_diff_matrix_np(n, 1, length).T)
        self.D2 = jnp.asarray(spectral_diff_matrix_np(n, 2, length).T)
        self.k = jnp.asarray(rfftfreq_np(n, length / (2.0 * np.pi * n)))

    def rfft(self, x) -> Cx:
        return Cx(_dot(x, self.RC), _dot(x, self.RS))

    def irfft(self, c: Cx):
        return _dot(c.re, self.IRC) + _dot(c.im, self.IRI)

    def tderiv(self, x):
        """d/dt along the last axis (period ``length``)."""
        return _dot(x, self.D1)

    def tderiv2(self, x):
        return _dot(x, self.D2)


# ---------------------------------------------------------------------------
# 2D plan
# ---------------------------------------------------------------------------

class FourierPlan2D:
    """2D DFT on real (nx, ny) arrays, complex output as Cx.

    fft2(x) = Fx @ x @ Fy^T computed with real f64 matmuls.  ``native=True``
    uses jnp.fft (requires a complex128 FFT; auto-selected where the
    backend has one).

    The flagship use is the periodic box solve
    (reference: ipde/solvers/multi_boundary/poisson.py:30-37):
        u = ifft2(fft2(f) * symbol)   with a real, even symbol.
    ``solve_symbol`` fuses that path.
    """

    # use the four-step (matmul Cooley-Tukey) path for axes at least this
    # long with a nontrivial factorization
    FOURSTEP_MIN = 256

    def __init__(self, nx: int, ny: int, native=None):
        self.nx, self.ny = nx, ny
        if native is None:
            from ipde_tpu.config import backend_has_complex128
            native = backend_has_complex128()
        self.native = native
        # multi-chip: when use_mesh is set, each DFT pass runs with its
        # BATCH axis sharded over the mesh (the transform axis stays local)
        # and the inter-pass transpose becomes one all-to-all (SURVEY.md
        # 2.3(d): pjit-sharded 2D grid FFT; no reference analogue).
        self.mesh = None
        self.mesh_axis = "p"
        if not native:
            self._tx = self._make_axis_transform(nx)
            self._ty = self._make_axis_transform(ny)

    def use_mesh(self, mesh, axis: str = "p"):
        """Activate sharded transforms: axis-0 passes run with columns
        sharded over `mesh` (XLA inserts the all-to-all at the transpose).

        With a mesh the MATMUL path is forced even where native jnp.fft
        is the single-device default: the matmul passes are the
        sharded implementation, and sharding constraints around the CPU
        fft thunk trip an XLA layout RET_CHECK when the whole step is
        jitted (measured: dryrun_multichip 2026-08-21)."""
        self.mesh = mesh
        self.mesh_axis = axis
        if mesh is not None and self.native:
            self._native_saved = True
            self.native = False
            if not hasattr(self, "_tx"):
                self._tx = self._make_axis_transform(self.nx)
                self._ty = self._make_axis_transform(self.ny)
        elif mesh is None and getattr(self, "_native_saved", False):
            self.native = True
            self._native_saved = False

    def _shard_axis(self, x, axis_idx: int):
        """Constrain axis `axis_idx` of x (array or Cx) sharded over the
        mesh, everything else replicated; no-op without a mesh.  Used on
        the BATCH axis of each DFT pass so the transform axis stays local
        and the inter-pass reshard lowers to one all-to-all."""
        if self.mesh is None:
            return x
        arr = x.re if isinstance(x, Cx) else x
        nd = int(self.mesh.devices.size)
        if arr.shape[axis_idx] % nd != 0:
            # GSPMD requires divisibility; leave this pass's layout to XLA
            # (e.g. the (nx//2 + 1)-row half-spectrum axis)
            return x
        from jax.sharding import NamedSharding, PartitionSpec
        spec = [None] * arr.ndim
        spec[axis_idx] = self.mesh_axis
        ns = NamedSharding(self.mesh, PartitionSpec(*spec))
        wsc = lambda a: jax.lax.with_sharding_constraint(a, ns)
        return Cx(wsc(x.re), wsc(x.im)) if isinstance(x, Cx) else wsc(x)

    def _shard_cols(self, x):
        return self._shard_axis(x, -1)

    def _make_axis_transform(self, n):
        """Axis-0 DFT plan object (attributes hold the matrices so planify
        can swap them; no closure-captured device arrays)."""
        if n >= self.FOURSTEP_MIN and _best_factor(n)[0] > 1:
            return FourStepFFT1D(n)
        return DirectDFT1D(n)

    def fft2(self, x) -> Cx:
        if self.native:
            if self.mesh is None:
                z = jnp.fft.fft2(x)
            else:
                z = jnp.fft.fft(self._shard_axis(x, 0), axis=1)
                z = jnp.fft.fft(self._shard_axis(z, 1), axis=0)
            return Cx(jnp.real(z), jnp.imag(z))
        c = self._tx.fft_real(self._shard_cols(x))
        c = self._ty.fft(self._shard_cols(Cx(c.re.T, c.im.T)))
        return Cx(c.re.T, c.im.T)

    def fft2_cx(self, c: Cx) -> Cx:
        """2D DFT of a complex (Cx) array."""
        if self.native:
            z = jax.lax.complex(c.re, c.im)
            if self.mesh is None:
                z = jnp.fft.fft2(z)
            else:
                z = jnp.fft.fft(self._shard_axis(z, 0), axis=1)
                z = jnp.fft.fft(self._shard_axis(z, 1), axis=0)
            return Cx(jnp.real(z), jnp.imag(z))
        c = self._tx.fft(self._shard_cols(c))
        c = self._ty.fft(self._shard_cols(Cx(c.re.T, c.im.T)))
        return Cx(c.re.T, c.im.T)

    def ifft2_real(self, c: Cx):
        """Real part of the inverse 2D DFT of c."""
        if self.native:
            z = jax.lax.complex(c.re, c.im)
            if self.mesh is None:
                return jnp.real(jnp.fft.ifft2(z))
            z = jnp.fft.ifft(self._shard_axis(z, 0), axis=1)
            z = jnp.fft.ifft(self._shard_axis(z, 1), axis=0)
            return jnp.real(z)
        c = self._tx.ifft(self._shard_cols(c))
        c = self._ty.ifft(self._shard_cols(Cx(c.re.T, c.im.T)))
        return c.re.T

    def rfft2(self, x) -> Cx:
        """Half-spectrum DFT of REAL (nx, ny) input: Cx of shape
        (nx//2 + 1, ny) holding rows kx = 0..nx/2 (the rest follows from
        Hermitian symmetry).  Costs ~half of fft2: the x-pass packs column
        pairs into one complex transform, and the y-pass only sees the
        retained rows.

        x may have FEWER than (nx, ny) rows/columns: the missing tail is
        treated as zeros and skipped by the prefix transforms (the padded
        free-space evaluators spread sources into the nonzero corner only)."""
        if self.native:
            if x.shape != (self.nx, self.ny):
                x = jnp.pad(x, ((0, self.nx - x.shape[0]),
                                (0, self.ny - x.shape[1])))
            z = jnp.fft.rfft(self._shard_cols(x), axis=0)
            if self.mesh is not None:
                z = self._shard_axis(z, 0)
            z = jnp.fft.fft(z, axis=1)
            return Cx(jnp.real(z), jnp.imag(z))
        c = self._tx.rfft_packed(self._shard_cols(x))
        c = self._ty.fft(self._shard_cols(Cx(c.re.T, c.im.T)))
        return Cx(c.re.T, c.im.T)

    def irfft2_real(self, c: Cx):
        """Inverse of rfft2: (nx//2+1, ny) half-spectrum of a REAL field ->
        real (nx, ny).  The input must be (numerically) the half-spectrum of
        a real field; the missing rows are reconstructed by symmetry after
        the y-pass and the x-pass packs column pairs."""
        if self.native:
            z = jnp.fft.ifft(self._shard_axis(jax.lax.complex(c.re, c.im),
                                              0), axis=1)
            return jnp.fft.irfft(self._shard_cols(z), n=self.nx, axis=0)
        d = self._ty.ifft(self._shard_cols(Cx(c.re.T, c.im.T)))
        return self._tx.irfft_packed(self._shard_cols(Cx(d.re.T, d.im.T)))

    def solve_symbol_r(self, f, symbol_h):
        """ifft2(fft2(f) * symbol).real via the half-spectrum path;
        symbol_h is the REAL symbol restricted to rows [0, nx//2]."""
        c = self.rfft2(f)
        return self.irfft2_real(Cx(c.re * symbol_h, c.im * symbol_h))

    @staticmethod
    def _stack_on() -> bool:
        """Field-stacked matmul transforms are kept behind IPDE_FFT_STACK=1
        (off by default: the mid-pass concatenations/transposes can cost
        more than the wider matmuls save)."""
        import os
        return os.environ.get("IPDE_FFT_STACK", "").strip() == "1"

    def fft2_stack(self, xs):
        """fft2 of B same-shape real arrays, both passes batched over the
        fields (see rfft2_stack)."""
        B = len(xs)
        if B == 1 or self.native or not self._stack_on():
            return [self.fft2(x) for x in xs]
        m = xs[0].shape[1]
        c = self._tx.fft_real(jnp.concatenate(xs, axis=1))
        tr = jnp.concatenate([c.re[:, i * m:(i + 1) * m].T
                              for i in range(B)], axis=1)
        ti = jnp.concatenate([c.im[:, i * m:(i + 1) * m].T
                              for i in range(B)], axis=1)
        d = self._ty.fft(Cx(tr, ti))
        nx = self.nx
        return [Cx(d.re[:, i * nx:(i + 1) * nx].T,
                   d.im[:, i * nx:(i + 1) * nx].T) for i in range(B)]

    def ifft2_real_stack(self, cs):
        """Real parts of the inverse fft2 of B same-shape spectra, both
        passes batched over the fields."""
        B = len(cs)
        if B == 1 or self.native or not self._stack_on():
            return [self.ifft2_real(c) for c in cs]
        m = cs[0].re.shape[1]
        c = self._tx.ifft(Cx(jnp.concatenate([c.re for c in cs], axis=1),
                             jnp.concatenate([c.im for c in cs], axis=1)))
        tr = jnp.concatenate([c.re[:, i * m:(i + 1) * m].T
                              for i in range(B)], axis=1)
        ti = jnp.concatenate([c.im[:, i * m:(i + 1) * m].T
                              for i in range(B)], axis=1)
        d = self._ty.ifft(Cx(tr, ti))
        nx = self.nx
        return [d.re[:, i * nx:(i + 1) * nx].T for i in range(B)]

    def rfft2_stack(self, xs):
        """rfft2 of B same-shape real arrays with BOTH matmul passes batched
        over the fields (stacked columns: wider m per DFT matmul, one pass
        instead of B).  Returns a list of B Cx half-spectra."""
        B = len(xs)
        if B == 1 or self.native or not self._stack_on():
            return [self.rfft2(x) for x in xs]
        m = xs[0].shape[1]
        c = self._tx.rfft_packed(jnp.concatenate(xs, axis=1))
        nk = c.re.shape[0]
        tr = jnp.concatenate([c.re[:, i * m:(i + 1) * m].T
                              for i in range(B)], axis=1)
        ti = jnp.concatenate([c.im[:, i * m:(i + 1) * m].T
                              for i in range(B)], axis=1)
        d = self._ty.fft(Cx(tr, ti))
        return [Cx(d.re[:, i * nk:(i + 1) * nk].T,
                   d.im[:, i * nk:(i + 1) * nk].T) for i in range(B)]

    def irfft2_real_corner_stack(self, cs, nx_out: int, ny_out: int,
                                 nx0: int = 0, ny0: int = 0):
        """irfft2_real_corner of B same-shape half-spectra, batched like
        rfft2_stack.  Returns a list of B real (nx_out, ny_out) windows."""
        B = len(cs)
        if B == 1 or self.native or not self._stack_on():
            return [self.irfft2_real_corner(c, nx_out, ny_out, nx0, ny0)
                    for c in cs]
        nk = cs[0].re.shape[0]
        tr = jnp.concatenate([c.re.T for c in cs], axis=1)
        ti = jnp.concatenate([c.im.T for c in cs], axis=1)
        d = self._ty.ifft_trunc(Cx(tr, ti), ny0 + ny_out)
        d = Cx(d.re[ny0:ny0 + ny_out], d.im[ny0:ny0 + ny_out])
        pr = jnp.concatenate([d.re[:, i * nk:(i + 1) * nk].T
                              for i in range(B)], axis=1)
        pi = jnp.concatenate([d.im[:, i * nk:(i + 1) * nk].T
                              for i in range(B)], axis=1)
        out = self._tx.irfft_packed(Cx(pr, pi), n_out=nx_out, n0=nx0)
        return [out[:, i * ny_out:(i + 1) * ny_out] for i in range(B)]

    def irfft2_real_corner(self, c: Cx, nx_out: int, ny_out: int,
                           nx0: int = 0, ny0: int = 0):
        """irfft2_real(c)[nx0:nx0+nx_out, ny0:ny0+ny_out] computed with
        output-truncated passes: on a 2x-padded evaluator grid only the
        unpadded window is used, and truncating the y-pass halves the
        x-pass's width."""
        if self.native:
            z = jnp.fft.ifft(self._shard_axis(jax.lax.complex(c.re, c.im),
                                              0), axis=1)
            return jnp.fft.irfft(self._shard_cols(z[:, ny0:ny0 + ny_out]),
                                 n=self.nx, axis=0)[nx0:nx0 + nx_out]
        d = self._ty.ifft_trunc(self._shard_cols(Cx(c.re.T, c.im.T)),
                                ny0 + ny_out)
        # four-step ifft_trunc returns ceil(n/n1)*n1 rows; slice to exactly
        # the requested window before the x-pass
        d = Cx(d.re[ny0:ny0 + ny_out], d.im[ny0:ny0 + ny_out])
        return self._tx.irfft_packed(self._shard_cols(Cx(d.re.T, d.im.T)),
                                     n_out=nx_out, n0=nx0)

    def solve_symbol(self, f, symbol):
        """ifft2(fft2(f) * symbol).real for real f and real symbol."""
        c = self.fft2(f)
        return self.ifft2_real(Cx(c.re * symbol, c.im * symbol))

    def deriv_x(self, f, kx):
        """Spectral x-derivative of real f; kx is fftfreq column (nx, 1)."""
        c = self.fft2(f)
        return self.ifft2_real(Cx(-c.im * kx, c.re * kx))

    def deriv_y(self, f, ky):
        c = self.fft2(f)
        return self.ifft2_real(Cx(-c.im * ky, c.re * ky))


class TanPlan(NamedTuple):
    """Last-axis real FFT plan as a pytree of arrays (jit-argument friendly:
    the annular GMRES matvec/preconditioner receive it inside their ops
    bundle, so planify passes every matrix as an argument).

    Mode is encoded in the (static) shapes: direct mode fills RC/RS/IRC/IRI
    with the right-multiply DFT matrices and leaves the four-step fields
    empty; four-step mode (large factorable n) does the reverse.  The
    four-step path turns the O(n^2) tangential-derivative matmuls of the
    annular solvers (reference analogue: mfft/mifft in
    ipde/annular/stokes.py:321-385) into O(n(n1+n2)) two-stage GEMMs --
    ~13x fewer flops at nb=2700 -- while keeping everything f64 matmuls.
    """
    k: jax.Array     # (nk,) derivative wavenumbers, Nyquist zeroed
    RC: jax.Array    # (n, nk) direct right-multiply rfft, or (0, 0)
    RS: jax.Array
    IRC: jax.Array   # (nk, n)
    IRI: jax.Array
    C1: jax.Array    # four-step stage matrices, or (0, 0)
    S1: jax.Array
    C2T: jax.Array
    S2T: jax.Array
    TWC: jax.Array
    TWS: jax.Array


def make_tan_plan(n: int, length: float = 2.0 * np.pi,
                  min_fourstep: int = 256) -> TanPlan:
    nk = n // 2 + 1
    k = rfftfreq_np(n, length / (2.0 * np.pi * n)).copy()
    if n % 2 == 0:
        k[-1] = 0.0                      # odd-derivative Nyquist convention
    e = jnp.zeros((0, 0))
    if n >= min_fourstep and _best_factor(n)[0] > 1:
        n1, n2, c1, s1, c2, s2, twc, tws = _fourstep_mats_np(n)
        return TanPlan(k=jnp.asarray(k), RC=e, RS=e, IRC=e, IRI=e,
                       C1=jnp.asarray(c1), S1=jnp.asarray(s1),
                       C2T=jnp.asarray(c2.T), S2T=jnp.asarray(s2.T),
                       TWC=jnp.asarray(twc), TWS=jnp.asarray(tws))
    rc, rs = _rdft_mats_np(n)
    icr, ici = _irdft_mats_np(n)
    return TanPlan(k=jnp.asarray(k), RC=jnp.asarray(rc.T),
                   RS=jnp.asarray(rs.T), IRC=jnp.asarray(icr.T),
                   IRI=jnp.asarray(ici.T), C1=e, S1=e, C2T=e, S2T=e,
                   TWC=e, TWS=e)


def _tan_dims(tp: TanPlan):
    """(n, nk, fourstep?) from static leaf shapes."""
    nk = tp.k.shape[0]
    if tp.RC.shape[0] > 0:
        return tp.RC.shape[0], nk, False
    n1, n2 = tp.C1.shape[0], tp.C2T.shape[0]
    return n1 * n2, nk, True


def _fs_fft_tp(tp: TanPlan, c: Cx) -> Cx:
    """Four-step complex FFT along axis 0 using TanPlan arrays."""
    n1, n2 = tp.C1.shape[0], tp.C2T.shape[0]
    n = n1 * n2
    m = c.re.shape[1]
    xr = c.re.reshape(n1, n2 * m)
    xi = c.im.reshape(n1, n2 * m)
    ar = (_dot(tp.C1, xr) - _dot(tp.S1, xi)).reshape(n1, n2, m)
    ai = (_dot(tp.S1, xr) + _dot(tp.C1, xi)).reshape(n1, n2, m)
    tr = tp.TWC[:, :, None]
    ti = tp.TWS[:, :, None]
    br = ar * tr - ai * ti
    bi = ar * ti + ai * tr
    C2 = tp.C2T.T
    S2 = tp.S2T.T
    br2 = jnp.einsum("ajm,cj->acm", br, C2, precision=_HIGH) \
        - jnp.einsum("ajm,cj->acm", bi, S2, precision=_HIGH)
    bi2 = jnp.einsum("ajm,cj->acm", br, S2, precision=_HIGH) \
        + jnp.einsum("ajm,cj->acm", bi, C2, precision=_HIGH)
    out_r = jnp.transpose(br2, (1, 0, 2)).reshape(n, m)
    out_i = jnp.transpose(bi2, (1, 0, 2)).reshape(n, m)
    return Cx(out_r, out_i)


def tan_rfft(x, tp: TanPlan) -> Cx:
    """rfft along the LAST axis of real x (m, n) -> Cx (m, nk)."""
    n, nk, fourstep = _tan_dims(tp)
    if not fourstep:
        return Cx(_dot(x, tp.RC), _dot(x, tp.RS))
    xt = x.T                                  # (n, m)
    m = xt.shape[1]
    if m % 2 == 1:
        xt = jnp.concatenate([xt, jnp.zeros((xt.shape[0], 1), xt.dtype)],
                             axis=1)
    # column-packing: one complex four-step pass transforms two real columns
    Z = _fs_fft_tp(tp, Cx(xt[:, 0::2], xt[:, 1::2]))
    zr_rev = jnp.concatenate([Z.re[:1], Z.re[:0:-1][: nk - 1]], axis=0)
    zi_rev = jnp.concatenate([Z.im[:1], Z.im[:0:-1][: nk - 1]], axis=0)
    zr, zi = Z.re[:nk], Z.im[:nk]
    er, ei = 0.5 * (zr + zr_rev), 0.5 * (zi - zi_rev)
    our, oui = 0.5 * (zi + zi_rev), 0.5 * (zr_rev - zr)
    out_r = jnp.stack([er, our], axis=2).reshape(nk, -1)[:, :m]
    out_i = jnp.stack([ei, oui], axis=2).reshape(nk, -1)[:, :m]
    return Cx(out_r.T, out_i.T)


def tan_irfft(c: Cx, tp: TanPlan):
    """Inverse of tan_rfft: Cx (m, nk) -> real (m, n)."""
    n, nk, fourstep = _tan_dims(tp)
    if not fourstep:
        return _dot(c.re, tp.IRC) + _dot(c.im, tp.IRI)
    cr, ci = c.re.T, c.im.T                   # (nk, m)
    m = cr.shape[1]
    tr_ = cr[1: n - nk + 1][::-1]
    ti_ = -ci[1: n - nk + 1][::-1]
    fr = jnp.concatenate([cr, tr_], axis=0)
    fi = jnp.concatenate([ci, ti_], axis=0)
    if m % 2 == 1:
        fr = jnp.concatenate([fr, jnp.zeros((n, 1), fr.dtype)], axis=1)
        fi = jnp.concatenate([fi, jnp.zeros((n, 1), fi.dtype)], axis=1)
    packed = Cx(fr[:, 0::2] - fi[:, 1::2], fi[:, 0::2] + fr[:, 1::2])
    z = _fs_fft_tp(tp, Cx(packed.re, -packed.im))
    z = Cx(z.re / n, -z.im / n)
    out = jnp.stack([z.re, z.im], axis=2).reshape(n, -1)[:, :m]
    return out.T


def tan_deriv(x, tp: TanPlan):
    """d/dt along the last axis via rfft -> ik -> irfft."""
    c = tan_rfft(x, tp)
    return tan_irfft(Cx(-c.im * tp.k, c.re * tp.k), tp)


def tan_cast(tp: TanPlan, dtype) -> TanPlan:
    return TanPlan(*(a.astype(dtype) for a in tp))


class SimpleFourierFilter:
    """Fourier-space filter on periodic 1D data (reference: ipde/utilities.py:126-162)."""

    def __init__(self, n: int, filter_type: str = "fraction", **kwargs):
        self.plan = FourierPlan1D(n)
        k = np.abs(rfftfreq_np(n, 1.0 / n))
        max_k = k.max()
        if filter_type == "fraction":
            filt = np.ones_like(k)
            filt[k > max_k * kwargs["fraction"]] = 0.0
        elif filter_type == "rule 36":
            p = kwargs.get("power", 36)
            filt = np.exp(-p * (k / max_k) ** p)
        else:
            raise ValueError(f"unknown filter type {filter_type}")
        self.filt = jnp.asarray(filt)

    def __call__(self, f):
        c = self.plan.rfft(f)
        return self.plan.irfft(Cx(c.re * self.filt, c.im * self.filt))


class DirectDFT1D:
    """Single-matmul DFT along axis 0 of an (n, m) complex pair.

    All forward entry points accept inputs with FEWER than n rows: missing
    rows are treated as zeros (a "prefix transform") by slicing the DFT
    matrix columns -- the padded-convolution evaluators exploit this to
    skip the zero half of their 2x-padded grids without materializing it."""

    def __init__(self, n: int):
        c_, s_ = _dft_mats_np(n)
        self.n = n
        self.nk = n // 2 + 1
        self.C = jnp.asarray(c_)
        self.S = jnp.asarray(s_)
        rc, rs = _rdft_mats_np(n)
        self.RC = jnp.asarray(rc)     # (nk, n)
        self.RS = jnp.asarray(rs)
        icr, ici = _irdft_mats_np(n)
        self.ICR = jnp.asarray(icr)   # (n, nk)
        self.ICI = jnp.asarray(ici)

    def fft(self, c: Cx) -> Cx:
        nz = c.re.shape[0]
        C, S = self.C[:, :nz], self.S[:, :nz]
        return Cx(_dot(C, c.re) - _dot(S, c.im),
                  _dot(S, c.re) + _dot(C, c.im))

    def fft_real(self, x) -> Cx:
        """DFT of REAL input: half the matmuls of the complex path."""
        nz = x.shape[0]
        return Cx(_dot(self.C[:, :nz], x), _dot(self.S[:, :nz], x))

    def rfft_packed(self, x) -> Cx:
        """DFT of REAL input, rows 0..n//2 only (half-matrix matmuls)."""
        nz = x.shape[0]
        return Cx(_dot(self.RC[:, :nz], x), _dot(self.RS[:, :nz], x))

    def irfft_packed(self, c: Cx, n_out: int = None, n0: int = 0):
        """Real inverse from the half-spectrum rows (Hermitian input);
        n_out/n0 keep only output rows [n0, n0 + n_out)."""
        if n_out is None:
            return _dot(self.ICR, c.re) + _dot(self.ICI, c.im)
        return (_dot(self.ICR[n0:n0 + n_out], c.re)
                + _dot(self.ICI[n0:n0 + n_out], c.im))

    def ifft(self, c: Cx) -> Cx:
        o = self.fft(Cx(c.re, -c.im))
        return Cx(o.re / self.n, -o.im / self.n)

    def ifft_trunc(self, c: Cx, n_out: int) -> Cx:
        """Inverse DFT keeping only output rows [0, n_out)."""
        o = Cx(_dot(self.C[:n_out], c.re) + _dot(self.S[:n_out], c.im),
               _dot(self.S[:n_out], c.re) - _dot(self.C[:n_out], c.im))
        return Cx(o.re / self.n, -o.im / self.n)


# ---------------------------------------------------------------------------
# four-step (matmul Cooley-Tukey) FFT for large n
# ---------------------------------------------------------------------------

def _best_factor(n: int):
    """Factor n = n1 * n2 with n1 as close to sqrt(n) as possible."""
    best = (1, n)
    f = 1
    for n1 in range(2, int(np.sqrt(n)) + 1):
        if n % n1 == 0:
            best = (n1, n // n1)
    return best


@functools.lru_cache(maxsize=64)
def _fourstep_mats_np(n: int):
    n1, n2 = _best_factor(n)
    c1, s1 = _dft_mats_np(n1)
    c2, s2 = _dft_mats_np(n2)
    k1 = np.arange(n1)[:, None]
    j2 = np.arange(n2)[None, :]
    ang = -2.0 * np.pi * k1 * j2 / n
    return n1, n2, c1, s1, c2, s2, np.cos(ang), np.sin(ang)


class FourStepFFT1D:
    """fft along axis 0 of a (n, m) complex pair via two matmul stages.

    X[k1 + n1 k2] = sum_{j2} w_n^{j2 k1} (sum_{j1} x[j1 n2 + j2] w_{n1}^{j1 k1})
                    w_{n2}^{j2 k2}
    Cost ~ 8 n (n1 + n2) flops per column instead of 8 n^2.
    """

    def __init__(self, n: int):
        n1, n2, c1, s1, c2, s2, twc, tws = _fourstep_mats_np(n)
        self.n, self.n1, self.n2 = n, n1, n2
        self.C1, self.S1 = jnp.asarray(c1), jnp.asarray(s1)
        # stage-2 right-multiplies: B[k1, k2] = sum_j2 A[k1, j2] F2[k2, j2]
        self.C2T, self.S2T = jnp.asarray(c2.T), jnp.asarray(s2.T)
        self.TWC, self.TWS = jnp.asarray(twc), jnp.asarray(tws)

    def _prefix(self, a):
        """Pad rows to a j1-block multiple; rows beyond the input are zero
        (prefix transform, see DirectDFT1D): returns (a_padded, j1max)."""
        nz = a.shape[0]
        n2 = self.n2
        j1max = -(-nz // n2)
        pad = j1max * n2 - nz
        if pad:
            a = jnp.concatenate(
                [a, jnp.zeros((pad, a.shape[1]), a.dtype)], axis=0)
        return a, j1max

    def fft(self, c: Cx) -> Cx:
        """c: (nz <= n, m) complex pair -> (n, m) DFT along axis 0 (rows
        beyond nz treated as zero)."""
        n1, n2 = self.n1, self.n2
        m = c.re.shape[1]
        xr, j1max = self._prefix(c.re)
        xi, _ = self._prefix(c.im)
        C1, S1 = self.C1[:, :j1max], self.S1[:, :j1max]
        xr = xr.reshape(j1max, n2 * m)
        xi = xi.reshape(j1max, n2 * m)
        ar = (_dot(C1, xr) - _dot(S1, xi)).reshape(n1, n2, m)
        ai = (_dot(S1, xr) + _dot(C1, xi)).reshape(n1, n2, m)
        return self._finish(ar, ai, m)

    def fft_real(self, x) -> Cx:
        """DFT of REAL (nz <= n, m) input: stage 1 costs half."""
        n1, n2 = self.n1, self.n2
        m = x.shape[1]
        xr, j1max = self._prefix(x)
        xr = xr.reshape(j1max, n2 * m)
        ar = _dot(self.C1[:, :j1max], xr).reshape(n1, n2, m)
        ai = _dot(self.S1[:, :j1max], xr).reshape(n1, n2, m)
        return self._finish(ar, ai, m)

    def _finish(self, ar, ai, m):
        n1, n2 = self.n1, self.n2
        # twiddle (n1, n2) broadcast over m
        tr = self.TWC[:, :, None]
        ti = self.TWS[:, :, None]
        br = ar * tr - ai * ti
        bi = ar * ti + ai * tr
        # stage 2 along j2: result (n1, n2->k2, m)
        br2 = jnp.einsum("ajm,cj->acm", br, self.C2T.T, precision=_HIGH) \
            - jnp.einsum("ajm,cj->acm", bi, self.S2T.T, precision=_HIGH)
        bi2 = jnp.einsum("ajm,cj->acm", br, self.S2T.T, precision=_HIGH) \
            + jnp.einsum("ajm,cj->acm", bi, self.C2T.T, precision=_HIGH)
        # k = k1 + n1 k2 -> arrange (k2, k1, m) then flatten
        out_r = jnp.transpose(br2, (1, 0, 2)).reshape(self.n, m)
        out_i = jnp.transpose(bi2, (1, 0, 2)).reshape(self.n, m)
        return Cx(out_r, out_i)

    def ifft(self, c: Cx) -> Cx:
        """Inverse: conj -> fft -> conj / n."""
        out = self.fft(Cx(c.re, -c.im))
        return Cx(out.re / self.n, -out.im / self.n)

    def rfft_packed(self, x) -> Cx:
        """DFT of REAL (n, m) input, rows 0..n//2 only.

        Column-packing trick: z = x[:, 0::2] + i x[:, 1::2] is transformed
        with ONE complex four-step pass (half the work), then the two
        columns' spectra are separated by Hermitian symmetry
        E(k) = (Z(k) + conj(Z(-k)))/2, O(k) = (Z(k) - conj(Z(-k)))/(2i)."""
        n, nk = self.n, self.n // 2 + 1
        m = x.shape[1]
        if m % 2 == 1:
            # x may be a prefix (nz < n rows); pad the column, not the rows
            x = jnp.concatenate([x, jnp.zeros((x.shape[0], 1), x.dtype)],
                                axis=1)
        Z = self.fft(Cx(x[:, 0::2], x[:, 1::2]))
        # rows of Z(-k) for k = 0..nk-1: [0, n-1, n-2, ..., n-nk+1]
        zr_rev = jnp.concatenate([Z.re[:1], Z.re[:0:-1][: nk - 1]], axis=0)
        zi_rev = jnp.concatenate([Z.im[:1], Z.im[:0:-1][: nk - 1]], axis=0)
        zr, zi = Z.re[:nk], Z.im[:nk]
        er, ei = 0.5 * (zr + zr_rev), 0.5 * (zi - zi_rev)
        our, oui = 0.5 * (zi + zi_rev), 0.5 * (zr_rev - zr)
        out_r = jnp.stack([er, our], axis=2).reshape(nk, -1)[:, :m]
        out_i = jnp.stack([ei, oui], axis=2).reshape(nk, -1)[:, :m]
        return Cx(out_r, out_i)

    def irfft_packed(self, c: Cx, n_out: int = None, n0: int = 0):
        """Real inverse from half-spectrum rows 0..n//2 (Hermitian input):
        rebuild the mirrored rows by symmetry, then invert column PAIRS as
        one complex four-step pass (z = u_even + i u_odd).  n_out/n0 keep
        only output rows [n0, n0 + n_out) (stage-2 computes only the
        covering k2 range)."""
        n = self.n
        nk = c.re.shape[0]
        m = c.re.shape[1]
        tr = c.re[1: n - nk + 1][::-1]
        ti = -c.im[1: n - nk + 1][::-1]
        fr = jnp.concatenate([c.re, tr], axis=0)
        fi = jnp.concatenate([c.im, ti], axis=0)
        if m % 2 == 1:
            fr = jnp.concatenate([fr, jnp.zeros((n, 1), fr.dtype)], axis=1)
            fi = jnp.concatenate([fi, jnp.zeros((n, 1), fi.dtype)], axis=1)
        packed = Cx(fr[:, 0::2] - fi[:, 1::2], fi[:, 0::2] + fr[:, 1::2])
        if n_out is None:
            z = self.ifft(packed)
            rows = n
        else:
            z = self.ifft_trunc(packed, n0 + n_out)
            rows = z.re.shape[0]
        out = jnp.stack([z.re, z.im], axis=2).reshape(rows, -1)[:, :m]
        return out if n_out is None else out[n0:n0 + n_out]

    def ifft_trunc(self, c: Cx, n_out: int) -> Cx:
        """Inverse keeping only output rows [0, n_out): output index
        k = k1 + n1 k2, so stage 2 runs over k2 < ceil(n_out / n1)."""
        n1 = self.n1
        n2t = -(-n_out // n1)
        out = self._fft_k2range(Cx(c.re, -c.im), n2t)
        return Cx(out.re / self.n, -out.im / self.n)

    def _fft_k2range(self, c: Cx, n2t: int) -> Cx:
        n1, n2 = self.n1, self.n2
        m = c.re.shape[1]
        xr = c.re.reshape(n1, n2 * m)
        xi = c.im.reshape(n1, n2 * m)
        ar = (_dot(self.C1, xr) - _dot(self.S1, xi)).reshape(n1, n2, m)
        ai = (_dot(self.S1, xr) + _dot(self.C1, xi)).reshape(n1, n2, m)
        tr = self.TWC[:, :, None]
        ti = self.TWS[:, :, None]
        br = ar * tr - ai * ti
        bi = ar * ti + ai * tr
        C2 = self.C2T.T[:n2t]
        S2 = self.S2T.T[:n2t]
        br2 = jnp.einsum("ajm,cj->acm", br, C2, precision=_HIGH) \
            - jnp.einsum("ajm,cj->acm", bi, S2, precision=_HIGH)
        bi2 = jnp.einsum("ajm,cj->acm", br, S2, precision=_HIGH) \
            + jnp.einsum("ajm,cj->acm", bi, C2, precision=_HIGH)
        out_r = jnp.transpose(br2, (1, 0, 2)).reshape(n2t * n1, m)
        out_i = jnp.transpose(bi2, (1, 0, 2)).reshape(n2t * n1, m)
        return Cx(out_r, out_i)
