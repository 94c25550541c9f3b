"""Free-space layer-potential evaluation on ALL grid points via FFT.

The dense O(T*S) kernel sum is replaced, for uniform-grid targets, by a
Vico-Greengard truncated-Green's-function convolution on a 2x-padded grid
plus exact local corrections near the sources:

    phi(x) = ifft2( Ghat_L(k) * rho_hat(k) ) / A
           + sum_{|x - s_j| < r_cut} [G(x - s_j) - T(x - s_j)] q_j

where rho_hat is the type-1 (spreading) NUFFT of the point sources,
Ghat_L the analytic Fourier transform of the radially TRUNCATED kernel
(exact free-space convolution for all distances < L: no periodic images),
and T the band-limited kernel the FFT actually applied (evaluated exactly
at the static near-pair offsets during host setup).

Reference analogue: the Ewald-style grid evaluators
(ipde/grid_evaluators/scalar_grid_evaluator.py:130-307,
laplace_grid_evaluator.py:21-33).  Design: sources are geometry-static,
so spreading indices/weights and the near-correction sparse matrix are host
precomputes; the device path is one scatter-add, one padded FFT round trip,
and one gather-scatter.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from scipy.special import j0, j1, jv, k0 as K0, k1 as K1

from ipde_tpu.geometry.grid import Grid
from ipde_tpu.ops.cx import Cx
from ipde_tpu.ops.fourier import FourierPlan2D
from ipde_tpu.ops.interp import _es_kernel, _es_kernel_ft_table, \
    _lagrange_weights
from ipde_tpu.ops.kernels import bessel_j0, bessel_j1, bessel_j2, bessel_k0

_HIGH = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# device symbol evaluation (setup): the padded-grid symbol arrays are a few
# 10^6 Bessel evaluations -- 30-60 s of scipy on one host core at bench
# sizes, ~ms on the device.
#
# Accuracy design: the closed Bessel formulas amplify J-roundoff
# catastrophically at small z (numerators are O(z^2) term-wise but O(z^4)
# in sum for the biharmonic).  Eager setup therefore evaluates J
# by order-10 barycentric interpolation of host scipy tables (pure mul/add
# on device: ~1e-16, no transcendentals) and switches to cancellation-free
# q = (z/2)^2 power series below z = 8.  Traced calls (no concrete zmax)
# fall back to the device J path.
# ---------------------------------------------------------------------------

_JTAB_CACHE: dict = {}


def _bessel_j_tab(nu: int, zmax: float):
    """Cached order-10 uniform-node table evaluator of J_nu on [0, zmax
    rounded up to 500]: host scipy values, device barycentric apply."""
    b = max(1, int(np.ceil(zmax / 500.0)))
    key = (nu, b)
    t = _JTAB_CACHE.get(key)
    if t is None:
        zm = 500.0 * b
        n = int(zm / 0.05) + 11
        zn = np.linspace(0.0, zm, n)
        t = RadialTableDev(zn, jv(nu, zn), order=10)
        _JTAB_CACHE[key] = t
    return t


def _dev_j(nu: int, z):
    """J_nu(z) for device arrays: table path when z is concrete (setup),
    device series/asymptotic path under tracing."""
    if isinstance(z, jax.core.Tracer):
        return (bessel_j0, bessel_j1, bessel_j2)[nu](z)
    return _bessel_j_tab(nu, float(jnp.max(z)))(z)


@functools.lru_cache(maxsize=1)
def _symbol_series_coeffs(nterms: int = 26):
    """Exact-rational small-z series coefficients (in q = z^2/4) for the
    Laplace and biharmonic truncated symbols (see the formulas below):
      laplace:    Ghat = L^2 [ sum aL[m] q^m  - log(L)/2 * sum bL[m] q^m ]
      biharmonic: Bhat = (L^4/64) [ (log L - 1) sum c1[m] q^m
                                    + sum c2[m] q^m ]
    """
    import math
    from fractions import Fraction as Fr
    f = math.factorial
    aL = [Fr((-1) ** j, 4 * f(j + 1) ** 2) for j in range(nterms)]
    bL = [Fr((-1) ** j, f(j) * f(j + 1)) for j in range(nterms)]
    c1 = [8 * Fr((-1) ** m) * (m + 1) / (f(m) * f(m + 2))
          for m in range(nterms)]
    c2 = []
    for mm in range(2, nterms + 2):
        v = (-4 * Fr((-1) ** mm, f(mm - 2) * f(mm))
             - 4 * Fr((-1) ** mm, f(mm) * f(mm))
             + 4 * Fr((-1) ** mm, f(mm - 1) * f(mm)))
        c2.append(v)
    tof = lambda cs: tuple(float(c) for c in cs)
    return tof(aL), tof(bL), tof(c1), tof(c2)


def _horner(coeffs, q):
    acc = jnp.full_like(q, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * q + c
    return acc


_Z_SWITCH = 6.0


def laplace_truncated_symbol_dev(kk, L: float):
    """Ghat_L(k) = [(1 - J0(z)) - z log(L) J1(z)] / k^2, z = kL (host twin:
    laplace_truncated_symbol); series below z = 8, table-J above."""
    kk = jnp.asarray(kk)
    z = kk * L
    aL, bL, _, _ = _symbol_series_coeffs()
    q = 0.25 * z * z
    small_val = L * L * (_horner(aL, q) - (np.log(L) / 2.0) * _horner(bL, q))
    ks = jnp.where(kk > 0, kk, 1.0)
    zs = jnp.maximum(z, _Z_SWITCH)
    large_val = ((1.0 - _dev_j(0, zs)) - zs * np.log(L) * _dev_j(1, zs)) \
        / (ks * ks)
    return jnp.where(z < _Z_SWITCH, small_val, large_val)


def yukawa_truncated_symbol_dev(kk, L: float, kappa: float):
    from scipy.special import k0 as K0h, k1 as K1h
    kk = jnp.asarray(kk)
    z = kk * L
    k0L = float(K0h(kappa * L))
    k1L = float(K1h(kappa * L))
    return ((1.0 + z * _dev_j(1, z) * k0L
             - kappa * L * _dev_j(0, z) * k1L) / (kk**2 + kappa**2))


def biharmonic_truncated_symbol_dev(kk, L: float):
    """Bhat_L(k) (host twin: biharmonic_truncated_symbol); series below
    z = 8 (the closed form loses ~8 digits there to cancellation),
    table-J above."""
    kk = jnp.asarray(kk)
    z = kk * L
    _, _, c1, c2 = _symbol_series_coeffs()
    q = 0.25 * z * z
    small_val = (L**4 / 64.0) * ((np.log(L) - 1.0) * _horner(c1, q)
                                 + _horner(c2, q))
    ks = jnp.where(kk > 0, kk, 1.0)
    zs = jnp.maximum(z, _Z_SWITCH)
    J0z, J1z, J2z = _dev_j(0, zs), _dev_j(1, zs), _dev_j(2, zs)
    large_val = ((np.log(L) - 1.0) * (zs**3 * J1z - 2.0 * zs**2 * J2z)
                 - zs**2 * J2z + 4.0 * (1.0 - J0z) - 2.0 * zs * J1z) \
        / (4.0 * ks**4)
    return jnp.where(z < _Z_SWITCH, small_val, large_val)


def laplace_truncated_symbol(kk: np.ndarray, L: float) -> np.ndarray:
    """FT of G_L = -log(r)/(2pi) * 1_{r<L}:
    Ghat_L(k) = [(1 - J0(kL)) - kL log(L) J1(kL)] / k^2, k != 0;
    Ghat_L(0) = -(L^2/2)(log L - 1/2)."""
    kk = np.asarray(kk, np.float64)
    out = np.empty_like(kk)
    nz = kk > 0
    z = kk[nz] * L
    out[nz] = ((1.0 - j0(z)) - z * np.log(L) * j1(z)) / kk[nz] ** 2
    out[~nz] = -(L**2 / 2.0) * (np.log(L) - 0.5)
    return out


def yukawa_truncated_symbol(kk: np.ndarray, L: float, kappa: float) -> np.ndarray:
    """FT of G_L = K0(kappa r)/(2pi) * 1_{r<L} (Lommel integral):
    Ghat_L(k) = [1 + kL J1(kL) K0(kappa L)
                   - kappa L J0(kL) K1(kappa L)] / (k^2 + kappa^2)."""
    z = kk * L
    return ((1.0 + z * j1(z) * K0(kappa * L)
             - kappa * L * j0(z) * K1(kappa * L)) / (kk**2 + kappa**2))


def biharmonic_truncated_symbol(kk: np.ndarray, L: float) -> np.ndarray:
    """FT of B_L = r^2 (log r - 1)/(8 pi) * 1_{r<L}  (2D biharmonic Green's
    function, lap^2 B = delta).  With z = kL:

      Bhat_L(k) = [(log L - 1)(z^3 J1(z) - 2 z^2 J2(z)) - z^2 J2(z)
                   + 4 (1 - J0(z)) - 2 z J1(z)] / (4 k^4)
      Bhat_L(0) = L^4 (4 log L - 5) / 64.

    Derived by the same Bessel antiderivative identities the Laplace symbol
    uses (int t J0 = z J1; int t^3 J0 = z^3 J1 - 2 z^2 J2; log factors by
    parts).  The Stokeslet's truncated symbol follows as
    Ghat_ij = (delta_ij k^2 - k_i k_j) Bhat_L, since
    G = (grad grad - delta lap) B  (reference capability analogue: the SFMM
    Stokes velocity evaluation at ipde/solvers/internals/stokes.py:26-35)."""
    kk = np.asarray(kk, np.float64)
    out = np.empty_like(kk)
    nz = kk > 0
    z = kk[nz] * L
    J0z, J1z, J2z = j0(z), j1(z), jv(2, z)
    out[nz] = ((np.log(L) - 1.0) * (z**3 * J1z - 2.0 * z**2 * J2z)
               - z**2 * J2z + 4.0 * (1.0 - J0z) - 2.0 * z * J1z) \
        / (4.0 * kk[nz] ** 4)
    out[~nz] = L**4 * (4.0 * np.log(L) - 5.0) / 64.0
    return out


# ---------------------------------------------------------------------------
# radial tables of band-limited (screened) kernels
# ---------------------------------------------------------------------------

def _composite_gl(a: float, b: float, npanels: int, deg: int = 12):
    """Composite Gauss-Legendre nodes/weights on [a, b]."""
    xg, wg = np.polynomial.legendre.leggauss(deg)
    edges = np.linspace(a, b, npanels + 1)
    mid = 0.5 * (edges[:-1] + edges[1:])
    half = 0.5 * (edges[1] - edges[0])
    k = (mid[:, None] + half * xg[None, :]).ravel()
    w = np.broadcast_to(half * wg[None, :], (npanels, deg)).ravel()
    return k, w


@functools.partial(jax.jit, static_argnums=(4,))
def _radial_table_eval(t, j, tab, lam, k: int):
    d = (t - j)[:, None] - jnp.arange(k)[None, :]
    # sign-preserving clamp: a point on a node gets weight ~1e12 x the
    # rest, reproducing the node value to ~1e-12 without an exact-hit branch
    d = jnp.where(jnp.abs(d) < 1e-12,
                  jnp.where(d >= 0, 1e-12, -1e-12), d)
    w = lam / d
    fv = tab[j[:, None] + jnp.arange(k)[None, :]]
    return (w * fv).sum(axis=1) / w.sum(axis=1)


class RadialTable:
    """T(r) tabulated on a uniform grid; order-p interpolation via the
    second barycentric form (uniform-node weights (-1)^j C(p-1, j)), which
    costs O(p) passes instead of the O(p^2) Lagrange-product construction.
    The evaluation runs over MILLIONS of near-pair offsets per evaluator
    setup (and per regenerate in moving-boundary runs), so it executes on
    the accelerator when one is attached -- the single weak host core takes
    ~10 us/point for the same numpy sweep."""

    def __init__(self, r_nodes: np.ndarray, values: np.ndarray,
                 order: int = 8):
        self.r0 = float(r_nodes[0])
        self.dr = float(r_nodes[1] - r_nodes[0])
        self.tab = np.asarray(values)
        self.order = order
        from scipy.special import comb
        j = np.arange(order)
        self.lam = ((-1.0) ** j) * comb(order - 1, j)

    def __call__(self, r: np.ndarray) -> np.ndarray:
        r = np.asarray(r, np.float64).ravel()
        k = self.order
        half = (k - 1) // 2
        t = (r - self.r0) / self.dr
        j = np.clip(np.floor(t).astype(np.int64) - half, 0, self.tab.size - k)
        # run on the host CPU backend: a small setup sweep that needs no
        # accelerator (~0.2 s per million points).  Pad to powers of two
        # so repeated setups reuse the compiled executable.
        n = t.size
        npad = 1 << max(int(np.ceil(np.log2(max(n, 1024)))), 0)
        tp = np.pad(t, (0, npad - n))
        jp = np.pad(j, (0, npad - n))
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            out = _radial_table_eval(jnp.asarray(tp), jnp.asarray(jp),
                                     jnp.asarray(self.tab),
                                     jnp.asarray(self.lam), k)
        return np.asarray(out)[:n]


def _radial_hankel_tables(symfn, kmax: float, L_eff: float, r_max: float,
                          moments, ntab: int = 2048):
    """Tables of (1/2pi) int_0^kmax sym(k) k * m(kr) dk for each requested
    moment m in ``moments`` (each a callable of (k, r) -> kernel values):

    This is the 1D replacement of the 2D host NUFFT used to evaluate the
    band-limited kernel at near-pair offsets: the screened symbol is RADIAL
    and decays far below the lattice Nyquist, so its inverse FT is a radial
    function given by a Hankel-type integral (the lattice/continuum
    difference is the negligible periodization of an exponentially-localized
    kernel).  ~1e3x cheaper than the NUFFT for millions of offsets."""
    # panels resolve both the symbol's 2pi/L oscillation and J's 2pi/r_max
    npanels = int(np.ceil(kmax * (L_eff + r_max) / (2.0 * np.pi))) + 64
    k, w = _composite_gl(0.0, kmax, npanels)
    base = symfn(k) * k * w / (2.0 * np.pi)
    r_nodes = np.linspace(0.0, r_max, ntab)
    out = []
    for m in moments:
        vals = np.empty(ntab)
        chunk = max(1, (1 << 22) // max(k.size, 1))
        for s in range(0, ntab, chunk):
            rr = r_nodes[s:s + chunk]
            vals[s:s + chunk] = m(k[None, :], rr[:, None]) @ base
        out.append(RadialTable(r_nodes, vals))
    return out


class RadialTableDev:
    """Device twin of RadialTable: order-p barycentric evaluation of a
    uniformly tabulated radial function, as eager jnp ops (gather + O(p)
    passes).  Table values live on the device; millions of offsets evaluate
    in ~ms with no per-shape jit compile."""

    def __init__(self, r_nodes: np.ndarray, values, order: int = 8):
        self.r0 = float(r_nodes[0])
        self.dr = float(r_nodes[1] - r_nodes[0])
        self.tab = jnp.asarray(values)
        self.order = order
        from scipy.special import comb
        j = np.arange(order)
        self.lam = jnp.asarray(((-1.0) ** j) * comb(order - 1, j))

    def __call__(self, r):
        # Loop over the k stencil offsets with [N]-shaped intermediates
        # only: a single [N, k] gather/divided-difference array costs k
        # times the memory at bench sizes (N ~ 1.8e7).
        r = jnp.asarray(r)
        shape = r.shape
        r = r.ravel()
        k = self.order
        half = (k - 1) // 2
        t = (r - self.r0) / self.dr
        j = jnp.clip(jnp.floor(t).astype(jnp.int32) - half, 0,
                     self.tab.shape[0] - k)
        tj = t - j
        num = jnp.zeros_like(t)
        den = jnp.zeros_like(t)
        for i in range(k):
            d = tj - i
            d = jnp.where(jnp.abs(d) < 1e-12,
                          jnp.where(d >= 0, 1e-12, -1e-12), d)
            w = self.lam[i] / d
            num = num + w * self.tab[j + i]
            den = den + w
        return (num / den).reshape(shape)


_TABLE_CACHE: dict = {}


def _radial_hankel_tables_dev(symfn_dev, kmax: float, L_eff: float,
                              r_max: float, moments_dev, ntab: int = 2048,
                              cache_key: tuple = None):
    """Device twin of _radial_hankel_tables: the (ntab x K) moment
    contraction runs on the accelerator with the device Bessel J
    implementations (the host version costs 30+ s of scipy at bench sizes).

    cache_key: when given, the computed tables are memoized process-wide
    under (cache_key, kmax, L_eff, r_max, ntab).  The tables depend only
    on the symbol parameters -- with the truncation radius L quantized
    (_setup_box) the key repeats across moving-boundary timesteps, and
    rebuilding a grid evaluator skips its dominant setup cost.  Shared
    table arrays also dedupe to ONE jit argument under planify."""
    if cache_key is not None:
        full_key = (cache_key, float(kmax), float(L_eff), float(r_max), ntab)
        got = _TABLE_CACHE.get(full_key)
        if got is not None:
            return got
    npanels = int(np.ceil(kmax * (L_eff + r_max) / (2.0 * np.pi))) + 64
    k, w = _composite_gl(0.0, kmax, npanels)
    kd = jnp.asarray(k)
    base = symfn_dev(kd) * kd * jnp.asarray(w) / (2.0 * np.pi)
    r_nodes = np.linspace(0.0, r_max, ntab)
    rd = jnp.asarray(r_nodes)
    out = []
    for m in moments_dev:
        # chunk rows so the (ntab, K) intermediate stays modest
        chunk = max(1, (1 << 22) // max(k.size, 1))
        vals = []
        for s in range(0, ntab, chunk):
            rr = rd[s:s + chunk]
            vals.append(jnp.sum(m(kd[None, :], rr[:, None]) * base[None, :],
                                axis=1))
        out.append(RadialTableDev(r_nodes, jnp.concatenate(vals)))
    if cache_key is not None:
        _TABLE_CACHE[full_key] = out
    return out


def _m_j0_dev(k, r):
    return _dev_j(0, k * r)


def _m_j1_over_z_dev(k, r):
    z = k * r
    small = z < 1e-8
    zz = jnp.where(small, 1.0, z)
    return k * k * jnp.where(small, 0.5 - z * z / 16.0,
                             _dev_j(1, zz) / zz)


def _m_k2_j0_dev(k, r):
    return k * k * _dev_j(0, k * r)


def _m_j0(k, r):
    return j0(k * r)


def _m_j1_over_z(k, r):
    """k^2 * J1(kr)/(kr), finite at r=0 (-> k^2/2)."""
    z = k * r
    small = z < 1e-8
    zz = np.where(small, 1.0, z)
    return k * k * np.where(small, 0.5 - z * z / 16.0, j1(zz) / zz)


def _m_k2_j0(k, r):
    return k * k * j0(k * r)


def _host_nufft2(modes: np.ndarray, gx: np.ndarray, gy: np.ndarray,
                 Px: int, Py: int, sigma: int = 2, w: int = 16) -> np.ndarray:
    """Host (numpy) type-2 evaluation of sum_k modes[k] e^{i k.x} at targets
    given in grid-index units (gx, gy) of the (Px, Py) mode grid."""
    beta = 2.30 * w
    half_w = w / 2.0
    nfx, nfy = sigma * Px, sigma * Py
    # deconvolve with the window FT on the mode grid (index-unit coordinates:
    # wavenumbers are 2 pi k / P, window half-width half_w fine-cells = half_w/sigma
    # index units -> use the same normalized machinery as build_nufft_plan)
    kx = np.abs(np.fft.fftfreq(Px, 1.0 / Px)).astype(int)
    ky = np.abs(np.fft.fftfreq(Py, 1.0 / Py)).astype(int)
    phx = _es_kernel_ft_table(w, beta, (2 * np.pi / nfx) * half_w, int(kx.max()) + 1)
    phy = _es_kernel_ft_table(w, beta, (2 * np.pi / nfy) * half_w, int(ky.max()) + 1)
    hx_a, hy_a = 2 * np.pi / nfx, 2 * np.pi / nfy
    deconv = (hx_a / phx[kx])[:, None] * (hy_a / phy[ky])[None, :]
    padded = np.zeros((nfx, nfy), dtype=complex)
    hxm, hym = Px // 2, Py // 2
    m = modes * deconv
    padded[:hxm, :hym] = m[:hxm, :hym]
    padded[:hxm, nfy - (Py - hym):] = m[:hxm, hym:]
    padded[nfx - (Px - hxm):, :hym] = m[hxm:, :hym]
    padded[nfx - (Px - hxm):, nfy - (Py - hym):] = m[hxm:, hym:]
    fine = np.fft.ifft2(padded).real * (nfx * nfy)
    # window weights at the targets (fine-grid index units)
    fx = np.mod(gx, Px) * sigma
    fy = np.mod(gy, Py) * sigma
    jx = np.floor(fx).astype(np.int64) - (w // 2 - 1)
    jy = np.floor(fy).astype(np.int64) - (w // 2 - 1)
    offs = np.arange(w)
    out = np.empty(gx.size)
    chunk = 200000
    fine_flat = fine.ravel()
    for s0 in range(0, gx.size, chunk):
        sl = slice(s0, min(s0 + chunk, gx.size))
        px_ = jx[sl, None] + offs
        py_ = jy[sl, None] + offs
        wx_ = _es_kernel((fx[sl, None] - px_) / half_w, beta)
        wy_ = _es_kernel((fy[sl, None] - py_) / half_w, beta)
        flat = (np.mod(px_, nfx)[:, :, None] * nfy
                + np.mod(py_, nfy)[:, None, :])
        patches = fine_flat[flat]
        out[sl] = np.einsum("tp,tq,tpq->t", wx_, wy_, patches)
    return out


class _EvaluatorBase:
    """Shared machinery: box/padding layout, spreading plan, window
    deconvolution, Gaussian screen, and vectorized near-patch geometry."""

    # truncation margin between the farthest used pair distance and the
    # symbol's cutoff L, in units of h/pi: must exceed the Gaussian screen's
    # blur reach.  Tensor (Hasimoto-screened) kernels get a larger margin --
    # their complementary kernel carries eta^2-amplified polynomial factors.
    MARGIN_H = 60.0

    def _setup_box(self, grid: Grid, src_x, src_y, pad, target_bounds,
                   target_hull=None):
        self.grid = grid
        Nx, Ny = grid.Nx, grid.Ny
        hx, hy = grid.xh, grid.yh
        Lx, Ly = Nx * hx, Ny * hy
        # maximum USED-target-to-source distance.  target_hull (K, 2) gives
        # the exact extreme target points (e.g. convex hull of the physical
        # region); the bounding-box corners overestimate the Euclidean
        # distance by up to ~40% for star-shaped domains, often costing a
        # whole padding factor.
        if target_bounds is None:
            target_bounds = (grid.x_bounds, grid.y_bounds)
        (tx0, tx1), (ty0, ty1) = target_bounds
        if target_hull is not None:
            th = np.asarray(target_hull, np.float64)
            maxdist = float(np.hypot(th[:, None, 0] - src_x[None, :],
                                     th[:, None, 1] - src_y[None, :]).max())
        else:
            corners = [(tx0, ty0), (tx0, ty1), (tx1, ty0), (tx1, ty1)]
            maxdist = max(np.hypot(src_x - cx, src_y - cy).max()
                          for cx, cy in corners)
        # per-axis spans (aliasing is per image-shift direction: the nearest
        # image of s at t is offset by a full padded period along ONE axis,
        # so the pair distance is >= pad*Lx - |t_x - s_x|)
        span_x = max(tx1 - src_x.min(), src_x.max() - tx0)
        span_y = max(ty1 - src_y.min(), src_y.max() - ty0)
        # truncation radius must cover every pair WITH margin for the
        # Gaussian screen's blur width (several 1/eta), AND the nearest
        # periodic image pair must be beyond L plus the same blur margin:
        # pad_x*Lx >= L + span_x + margin (and same in y)
        marg = self.MARGIN_H * max(hx, hy) / np.pi
        # quantize the truncation radius UP in 1.5% relative steps: L only
        # needs to EXCEED every used pair distance, and a step-stable L
        # keys the radial-table cache across moving-boundary timesteps
        # (the tables were the dominant per-step evaluator-rebuild cost)
        L = maxdist + marg
        L = float(np.exp(np.ceil(np.log(L) / 0.015) * 0.015))
        if pad is None:
            pad_x = max(int(np.ceil((L + span_x + marg) / Lx)), 2)
            pad_y = max(int(np.ceil((L + span_y + marg) / Ly)), 2)
        else:
            pad_x = pad_y = pad
        if (pad_x * Lx < L + span_x + marg - 1e-12
                or pad_y * Ly < L + span_y + marg - 1e-12):
            raise ValueError("padding insufficient to exclude periodic images")
        self.Px, self.Py = pad_x * Nx, pad_y * Ny
        self.L = L
        self.A = (pad_x * Lx) * (pad_y * Ly)
        # Gaussian screen width: kills the truncated symbol's Gibbs tail by
        # the lattice Nyquist (exp(-32.5) there); the complementary near
        # field is folded into the local corrections (classical
        # particle-mesh structure; reference analogue:
        # ipde/grid_evaluators/scalar_grid_evaluator.py)
        self.eta = np.pi / (11.4 * max(hx, hy))

    def _setup_spreading(self, src_x, src_y, w, wrap: bool = True):
        grid, Px, Py = self.grid, self.Px, self.Py
        hx, hy = grid.xh, grid.yh
        beta = 2.30 * w
        half_w = w / 2.0
        gx = (src_x - grid.x_bounds[0]) / hx
        gy = (src_y - grid.y_bounds[0]) / hy
        jx = np.floor(gx).astype(np.int64) - (w // 2 - 1)
        jy = np.floor(gy).astype(np.int64) - (w // 2 - 1)
        px = jx[:, None] + np.arange(w)[None, :]
        py = jy[:, None] + np.arange(w)[None, :]
        wx = _es_kernel((gx[:, None] - px) / half_w, beta)
        wy = _es_kernel((gy[:, None] - py) / half_w, beta)
        if wrap:
            # periodic evaluators: windows legitimately wrap the torus
            flat = (np.mod(px, Px)[:, :, None] * Py
                    + np.mod(py, Py)[:, None, :])
            self.sx_cells = self.sy_cells = 0
            self.spread_shape = (Px, Py)
        else:
            # free-space (padded) evaluators: all sources live in the
            # unpadded corner, so shift the padded-box origin instead of
            # wrapping.  The spread array then has support ONLY in a
            # (nzx, nzy) ~ unpadded-size prefix block: the forward
            # transforms skip the zero padding entirely (prefix transforms
            # in ops/fourier.py), and the convolution's translation
            # invariance moves the shift into the inverse-transform window
            # (irfft2_real_corner nx0/ny0) -- no phase factors anywhere.
            sx = int(max(0, -px.min()))
            sy = int(max(0, -py.min()))
            pxs = px + sx
            pys = py + sy
            nzx = int(pxs.max()) + 1
            nzy = int(pys.max()) + 1
            if nzx > Px or nzy > Py:
                raise ValueError("source windows exceed the padded box")
            # round the nonzero block up to 32-multiples: the block extent
            # follows the source curve, so without rounding every
            # moving-boundary step changes the spread/W shapes and
            # RECOMPILES the solve;
            # the extra zero rows cost ~nothing in the prefix transforms
            nzx = min(Px, -(-nzx // 32) * 32)
            nzy = min(Py, -(-nzy // 32) * 32)
            flat = pxs[:, :, None] * nzy + pys[:, None, :]
            self.sx_cells, self.sy_cells = sx, sy
            self.spread_shape = (nzx, nzy)
        self.spread_idx = jnp.asarray(flat.reshape(self.S, w * w), jnp.int32)
        self.spread_w = jnp.asarray((wx[:, :, None] * wy[:, None, :])
                                    .reshape(self.S, w * w))
        # MATMUL spreading: the separable window factorizes the whole
        # type-1 spread as  spread[a, b] = sum_s (q_s Wx[s, a]) Wy[s, b]
        #                               = Wx^T @ (q[:, None] * Wy),
        # one matmul instead of a (S, w^2) scatter-add.  Dense W
        # factors cost S*(nzx+nzy) f64; fall back to the scatter when
        # that exceeds IPDE_SPREAD_MB (default 384 MB) or when
        # IPDE_SPREAD=scatter.
        import os
        nzx, nzy = self.spread_shape
        mb = (src_x.size * (nzx + nzy) * 8) / 2**20
        mode = os.environ.get("IPDE_SPREAD", "").strip().lower()
        limit = float(os.environ.get("IPDE_SPREAD_MB", 384))
        use_mm = (mode != "scatter") and (mode == "matmul" or mb <= limit)
        self._spread_mm = None
        if use_mm:
            Wx = np.zeros((self.S, nzx))
            Wy = np.zeros((self.S, nzy))
            rows = np.arange(self.S)[:, None]
            if wrap:
                np.add.at(Wx, (rows, np.mod(px, Px)), wx)
                np.add.at(Wy, (rows, np.mod(py, Py)), wy)
            else:
                np.add.at(Wx, (rows, pxs), wx)
                np.add.at(Wy, (rows, pys), wy)
            self._spread_mm = (jnp.asarray(Wx.T), jnp.asarray(Wy))
        # window deconvolution (continuous FT at the padded wavenumbers)
        kx = 2 * np.pi * np.fft.fftfreq(Px, hx)
        ky = 2 * np.pi * np.fft.fftfreq(Py, hy)
        xq, wq = np.polynomial.legendre.leggauss(max(200, 4 * w))
        ax, ay = half_w * hx, half_w * hy
        ker = _es_kernel(xq, beta)
        phx = (np.cos(np.outer(kx, ax * xq)) * (ker * ax * wq)).sum(1)
        phy = (np.cos(np.outer(ky, ay * xq)) * (ker * ay * wq)).sum(1)
        # device transforms run on the HALF spectrum (rows kx = 0..Px/2);
        # symbols are real and even so the Hermitian half determines all.
        # The 2D symbol/deconv arrays are built ON DEVICE from these 1D host
        # vectors ((nkx, Py) ~ 10^7 entries at bench sizes: neither a host
        # sweep nor a large upload).
        self.nkx = Px // 2 + 1
        # (hx hy / (phx phy)) [type-1 deconv] / A [continuous FT norm]
        # * (Px Py) [our ifft2 is unnormalized-sum / (Px Py)]
        self.deconv_half = (jnp.asarray(hx * hy / phx[: self.nkx])[:, None]
                            / jnp.asarray(phy)[None, :]
                            / self.A * (Px * Py))
        # deconv CLIPPING: at the padded-spectrum corners the ES window FT
        # has decayed by up to e^{-2 beta} ~ 1e-32, so 1/(phx phy) amplifies
        # transform roundoff (~1e-16) into O(1e16)-scale spectral noise that
        # the k-weighted Stokes symbols turn into a GLOBAL ~1e-9-relative
        # velocity floor (measured tier-2, tools/vg_probe.py 2026-08-21;
        # pressure, one k-power lower, sat at 4e-12).  Modes attenuated
        # below IPDE_VG_CLIP (default 1e-13) carry no representable signal:
        # zero their deconv instead of inverting it (standard NUFFT
        # practice).  IPDE_VG_CLIP=0 disables.
        clip = float(os.environ.get("IPDE_VG_CLIP", "1e-13"))
        if clip > 0.0:
            ax_rel = np.abs(phx[: self.nkx]) / np.abs(phx).max()
            ay_rel = np.abs(phy) / np.abs(phy).max()
            keep = (jnp.asarray(ax_rel)[:, None]
                    * jnp.asarray(ay_rel)[None, :]) >= clip
            self.deconv_half = jnp.where(keep, self.deconv_half, 0.0)
        self.kx_half = jnp.asarray(kx[: self.nkx])[:, None]
        self.ky_row = jnp.asarray(ky)[None, :]
        self.kk_half = jnp.sqrt(self.kx_half ** 2 + self.ky_row ** 2)
        self.fft_plan = FourierPlan2D(Px, Py)

    def _spread(self, q):
        if self._spread_mm is not None:
            WxT, Wy = self._spread_mm
            return jnp.matmul(WxT, q[:, None] * Wy,
                              precision=jax.lax.Precision.HIGHEST)
        nzx, nzy = self.spread_shape
        spread = jnp.zeros(nzx * nzy)
        vals = (self.spread_w * q[:, None]).ravel()
        return spread.at[self.spread_idx.ravel()].add(vals)\
            .reshape(nzx, nzy)

    def _spread_pair(self, qa, qb):
        """Spread two source vectors; in matmul mode both ride ONE
        contraction (stacked columns)."""
        if self._spread_mm is not None:
            WxT, Wy = self._spread_mm
            nzy = Wy.shape[1]
            rhs = jnp.concatenate([qa[:, None] * Wy, qb[:, None] * Wy],
                                  axis=1)
            out = jnp.matmul(WxT, rhs, precision=jax.lax.Precision.HIGHEST)
            return out[:, :nzy], out[:, nzy:]
        return self._spread(qa), self._spread(qb)

    def _patch_geometry(self, src_x, src_y, r_cut):
        """Vectorized near-pair geometry ON DEVICE: every source gets one
        fixed-size P x P patch of grid offsets around its nearest node;
        cells outside r_cut are masked.  Returns device (S, P, 1), (S, 1, P)
        offsets + (S, P, P) distances/mask; only the O(S) nearest-node
        integers are computed on host."""
        grid = self.grid
        hx, hy = grid.xh, grid.yh
        wc = int(np.ceil(r_cut / min(hx, hy))) + 1
        P = 2 * wc + 1
        self.patch_P = P
        self.margin = wc
        # analytic table bound: source-to-patch-cell distance is at most
        # (wc + 1/2) h per axis (sources live inside the grid)
        self.r_tab_max = float(np.hypot((wc + 1.0) * hx, (wc + 1.0) * hy))
        six = np.clip(np.round((src_x - grid.x_bounds[0]) / hx).astype(int),
                      0, grid.Nx - 1)
        siy = np.clip(np.round((src_y - grid.y_bounds[0]) / hy).astype(int),
                      0, grid.Ny - 1)
        loc = np.arange(P) - wc
        # patch origin in the EXTENDED (margin-padded) grid
        self.patch_x0 = jnp.asarray(six, jnp.int32)
        self.patch_y0 = jnp.asarray(siy, jnp.int32)
        locx = jnp.asarray(loc * hx)
        locy = jnp.asarray(loc * hy)
        nodex = jnp.asarray(six * hx + grid.x_bounds[0] - src_x)
        nodey = jnp.asarray(siy * hy + grid.y_bounds[0] - src_y)
        # O(S)+O(P) pieces from which per-source offsets are rebuilt at
        # apply time (dx = nodex[:,None]+locx row-major-repeated): storing
        # the offsets as (S, P*P) arrays costs 143 MB each at bench size
        self.patch_nodex = nodex
        self.patch_nodey = nodey
        self.patch_locx = locx
        self.patch_locy = locy
        self._plan_patch_chunks(six, siy)
        dx = nodex[:, None] + locx[None, :]            # (S, P)
        dy = nodey[:, None] + locy[None, :]
        # FLAT (S, P*P) layout throughout: a (S, P, P) f64 array is tiled
        # (8, 128) on its last two dims, so P = 47 pads to (48, 128) -- a
        # 2.7x memory blowup that OOMs at bench sizes (several such arrays
        # per evaluator, solver + BIE each hold one evaluator).  The flat
        # minor dim P*P ~ 2209 pads to 2304 (4% waste).
        dxf = jnp.repeat(dx, P, axis=1)                # (S, P*P), x varies slow
        dyf = jnp.tile(dy, (1, P))                     # (S, P*P), y varies fast
        rr = jnp.sqrt(dxf ** 2 + dyf ** 2)
        mask = (rr <= r_cut) & (rr > 1e-13)
        return dxf, dyf, rr, mask

    def _plan_patch_chunks(self, six, siy):
        """Host plan for the PULL (overlap-add) patch application.

        The per-source serial scan is latency-bound: S sequential
        dynamic-slice round trips.  Pull instead:
        sort every (source, patch-cell) pair by its GRID cell on host;
        the device apply is then one permutation gather of the patch
        values, one cumulative sum, a segment difference at the
        (precomputed) cell boundaries, and one scatter-add of ~1e5
        per-cell sums -- everything wide and parallel.

        IPDE_PATCH=pull enables the pull path (tools/patch_probe.py times
        both); default is the serial scan."""
        import os
        self._patch_pull = None
        # ORIGIN-MERGE plan for the serial scan: the QFS source spacing is
        # ~h/3.5, so ~3-4 consecutive sources share the same nearest grid
        # node -- their patches occupy the SAME window and can be summed
        # (a few row-gather adds) before the scan, cutting the scan's
        # latency-bound step count by the same factor (42 -> ~14 ms at
        # tier-1).  IPDE_PATCH_MERGE=0 disables.
        self._patch_merge = None
        S = six.size
        if os.environ.get("IPDE_PATCH_MERGE", "1").strip() != "0" and S > 8:
            key = six.astype(np.int64) * (self.grid.Ny + 2 * self.margin
                                          + self.patch_P) + siy
            uniq, inv, counts = np.unique(key, return_inverse=True,
                                          return_counts=True)
            K = int(counts.max())
            nk = uniq.size
            if nk < S:   # something to merge
                order = np.argsort(inv, kind="stable")
                posw = np.concatenate([np.arange(c) for c in counts])
                tbl = np.full((nk, K), S, np.int64)
                tbl[inv[order], posw] = order
                first = order[np.concatenate([[0], np.cumsum(counts)[:-1]])]
                self._patch_merge = dict(
                    tbl=[jnp.asarray(tbl[:, k], jnp.int32)
                         for k in range(K)],
                    x0=jnp.asarray(six[first], jnp.int32),
                    y0=jnp.asarray(siy[first], jnp.int32),
                )
        if os.environ.get("IPDE_PATCH", "scan").strip().lower() != "pull":
            return
        P = self.patch_P
        S = six.size
        Nx, Ny = self.grid.Nx, self.grid.Ny
        # flat grid cell of every (source, patch-cell) pair; patch (a, b)
        # of source i sits at grid cell (six[i] + a - m, siy[i] + b - m)
        loc = np.arange(P) - self.margin
        cellx = six[:, None, None] + loc[None, :, None]        # (S, P, 1)
        celly = siy[:, None, None] + loc[None, None, :]        # (S, 1, P)
        valid = ((cellx >= 0) & (cellx < Nx)
                 & (celly >= 0) & (celly < Ny))                # (S, P, P)
        cell = (cellx * Ny + celly).reshape(S, P * P)
        valid = valid.reshape(S, P * P)
        flat_entry = np.flatnonzero(valid.ravel())             # into (S*P*P)
        cells = cell.ravel()[flat_entry]
        order = np.argsort(cells, kind="stable")
        perm = flat_entry[order].astype(np.int32)
        cells_sorted = cells[order]
        ucells, starts = np.unique(cells_sorted, return_index=True)
        ends = np.concatenate([starts[1:], [cells_sorted.size]])
        self._patch_pull = dict(
            perm=jnp.asarray(perm),
            # csum is inclusive: segment sum = csum[end-1] - csum[start-1]
            # (start-1 = -1 wraps to the last element; subtracting the
            # TOTAL there would be wrong, so prepend a virtual zero by
            # indexing into csum shifted by one)
            starts=jnp.asarray(starts.astype(np.int32)),
            ends=jnp.asarray(ends.astype(np.int32)),
            ucells=jnp.asarray(ucells.astype(np.int32)),
            nnz=perm.size,
        )

    def _apply_patches(self, grids, patch_stacks):
        """Add per-source P x P patches to each grid in ``grids``.
        patch_stacks: list of (S, P*P) arrays aligned with ``grids``
        (row-major patch layout, see _patch_geometry)."""
        pp = self._patch_pull
        if pp is not None:
            out = []
            for g, vals in zip(grids, patch_stacks):
                v = jnp.take(vals.ravel(), pp["perm"], axis=0)
                csum = jnp.concatenate([jnp.zeros((1,), v.dtype),
                                        jnp.cumsum(v)])
                seg = (jnp.take(csum, pp["ends"], axis=0)
                       - jnp.take(csum, pp["starts"], axis=0))
                out.append(g.ravel().at[pp["ucells"]].add(seg)
                           .reshape(g.shape))
            return out
        # serial scan (patches overlap, so updates must compose); stacking
        # the G grids into one (G, ext, ext) array does ONE
        # dynamic_update_slice per step instead of G
        m = self.margin
        Pp = self.patch_P
        G = len(grids)
        ext = jnp.zeros((G, self.grid.Nx + 2 * m, self.grid.Ny + 2 * m))
        stack = jnp.stack(patch_stacks, axis=1)          # (S, G, P*P)

        def body(acc, inp):
            patch, x0, y0 = inp
            z = jnp.zeros((), x0.dtype)
            cur = jax.lax.dynamic_slice(acc, (z, x0, y0), (G, Pp, Pp))
            return jax.lax.dynamic_update_slice(
                acc, cur + patch.reshape(G, Pp, Pp), (z, x0, y0)), None

        pm = self._patch_merge
        if pm is not None:
            # sum same-origin sources' patches (row gathers, zero pad row),
            # then scan over the merged groups only
            padded = jnp.concatenate(
                [stack, jnp.zeros((1,) + stack.shape[1:], stack.dtype)])
            merged = jnp.take(padded, pm["tbl"][0], axis=0)
            for t in pm["tbl"][1:]:
                merged = merged + jnp.take(padded, t, axis=0)
            ext, _ = jax.lax.scan(body, ext, (merged, pm["x0"], pm["y0"]))
        else:
            ext, _ = jax.lax.scan(body, ext,
                                  (stack, self.patch_x0, self.patch_y0))
        return [g + ext[i, m:-m, m:-m] for i, g in enumerate(grids)]


class FreespaceGridEvaluator(_EvaluatorBase):
    """phi(grid) = sum_j G(x - s_j) q_j for fixed sources s_j inside the box.

    kernel: 'laplace' (G = -log r / 2pi) or 'yukawa' (G = K0(kappa r)/2pi).
    Returned values live on the full (Nx, Ny) grid.

    Structure: Vico-Greengard truncated-symbol convolution on a padded grid
    (exact free-space field for all pair distances < L), Gaussian-screened
    so the symbol is effectively band-limited, plus per-source local patches
    adding (exact kernel - band-limited kernel) at the static near offsets.
    The band-limited kernel is RADIAL, so the patch values come from a 1D
    Hankel-quadrature table (no 2D NUFFT in setup).
    """

    def __init__(self, grid: Grid, src_x, src_y, kernel: str = "laplace",
                 kappa: float = 1.0, pad: int = None, w: int = 16,
                 r_cut_h: float = 22.0, target_bounds=None,
                 target_hull=None):
        """target_bounds: ((x0, x1), (y0, y1)) bounding box of the grid
        points whose values are actually USED (e.g. the physical region);
        target_hull: (K, 2) extreme target points (tighter truncation radius
        -> often one less padding factor -> 2x faster FFTs)."""
        src_x = np.asarray(src_x, np.float64).ravel()
        src_y = np.asarray(src_y, np.float64).ravel()
        self.S = src_x.size
        self.kernel = kernel
        self._setup_box(grid, src_x, src_y, pad, target_bounds, target_hull)
        self._setup_spreading(src_x, src_y, w, wrap=False)
        L, eta = self.L, self.eta
        kap2 = kappa**2 if kernel == "yukawa" else 0.0
        if kernel == "laplace":
            symf = lambda k: (laplace_truncated_symbol_dev(k, L)
                              * jnp.exp(-(k**2) / (4 * eta**2)))
            gfun = lambda r: -jnp.log(r) / (2 * np.pi)
        elif kernel == "yukawa":
            # exact Ewald screen for the Yukawa operator: the complementary
            # near part is then exponentially localized (a plain Gaussian
            # blur is exact only for HARMONIC kernels)
            symf = lambda k: (yukawa_truncated_symbol_dev(k, L, kappa)
                              * jnp.exp(-(k**2 + kap2) / (4 * eta**2)))
            gfun = lambda r: bessel_k0(kappa * r) / (2 * np.pi)
        else:
            raise ValueError(kernel)
        self.mult = symf(self.kk_half) * self.deconv_half
        # ---- near corrections (radial table of the band-limited kernel,
        # everything device: geometry, table, exact kernel, mask) ----------
        hx, hy = grid.xh, grid.yh
        r_cut = r_cut_h * max(hx, hy)
        dx, dy, rr, mask = self._patch_geometry(src_x, src_y, r_cut)
        kmax = 12.0 * eta
        (T,) = _radial_hankel_tables_dev(
            symf, kmax, L, self.r_tab_max, [_m_j0_dev],
            cache_key=("fs", kernel, float(kappa), float(eta)))
        rs = jnp.where(mask, rr, 1.0)
        self.patches = jnp.where(mask, gfun(rs) - T(rs), 0.0)

    def __call__(self, q):
        """q: (S,) weighted charges -> (Nx, Ny) potential grid."""
        spread = self._spread(q)
        c = self.fft_plan.rfft2(spread)
        c = Cx(c.re * self.mult, c.im * self.mult)
        phi = self.fft_plan.irfft2_real_corner(c, self.grid.Nx, self.grid.Ny,
                                               self.sx_cells, self.sy_cells)
        (phi,) = self._apply_patches(
            [phi], [self.patches * q[:, None]])
        return phi


class PeriodicGridEvaluator(_EvaluatorBase):
    """phi(grid) = sum over periodic images of G(x - s_j) q_j, the
    box-PERIODIC counterpart of FreespaceGridEvaluator (reference:
    ipde/grid_evaluators/scalar_grid_evaluator.py:246-264, the
    'periodic' branch evaluating the far field with the inverse symbol on
    the unpadded grid).

    Ewald structure: the far field applies the CONTINUOUS screened symbol
    on the periodic k-lattice (= the periodic sum of the band-limited
    kernel T); the near correction adds (G - T)(r) at the static near
    offsets.  G - T is Gaussian-localized (reach ~ several/eta << box), so
    only the m=0 image needs correcting -- the same 1D radial table as the
    free-space evaluator, with the UNtruncated symbol.

    For the Laplace kernel the k=0 mode is pinned to zero: the result is
    the zero-mean periodic potential, defined when sum(q) = 0 (otherwise
    it is the standard neutralizing-background convention).
    """

    def __init__(self, grid: Grid, src_x, src_y, kernel: str = "laplace",
                 kappa: float = 1.0, w: int = 16, r_cut_h: float = 22.0):
        src_x = np.asarray(src_x, np.float64).ravel()
        src_y = np.asarray(src_y, np.float64).ravel()
        self.S = src_x.size
        self.kernel = kernel
        self.grid = grid
        hx, hy = grid.xh, grid.yh
        # unpadded periodic box
        self.Px, self.Py = grid.Nx, grid.Ny
        self.A = (grid.Nx * hx) * (grid.Ny * hy)
        self.eta = np.pi / (11.4 * max(hx, hy))
        self._setup_spreading(src_x, src_y, w)
        eta = self.eta
        r_cut = r_cut_h * max(hx, hy)
        if 2 * r_cut > min(grid.Nx * hx, grid.Ny * hy):
            raise ValueError("near-correction radius exceeds half the box")
        dx, dy, rr, mask = self._patch_geometry(src_x, src_y, r_cut)
        rs = jnp.where(mask, rr, 1.0)
        if kernel == "laplace":
            # k=0 is pinned: applied = e^{-k^2/4eta^2}/k^2 over k != 0.
            # The complement (1 - screen)/k^2 on the k != 0 lattice equals,
            # by Poisson summation, sum_images Dc(|x + mL|) - Dc_hat(0)/A
            # with Dc(r) = E1(eta^2 r^2)/(4 pi) (derived from
            # Dc'(r) = -e^{-eta^2 r^2}/(2 pi r)) and Dc_hat(0) = 1/(4 eta^2).
            # Images beyond m=0 are e^{-(eta L/2)^2} ~ 0.
            def symf(k):
                k = jnp.asarray(k)
                nzk = jnp.where(k > 0, k, 1.0)
                return jnp.where(k > 0,
                                 jnp.exp(-(k**2) / (4 * eta**2)) / nzk**2,
                                 0.0)
            from ipde_tpu.ops.kernels import expint_e1
            corr = expint_e1(eta**2 * rs**2) / (4 * np.pi)
            self.mean_shift = 1.0 / (4 * eta**2 * self.A)
        elif kernel == "yukawa":
            # k=0 is finite: the applied operator is the periodic sum of
            # the band-limited kernel T; correction = (K0/2pi - T)(r),
            # Gaussian-localized, via the usual 1D Hankel table.
            kap2 = kappa**2
            symf = lambda k: (jnp.exp(-(k**2 + kap2) / (4 * eta**2))
                              / (k**2 + kap2))
            kmax = 12.0 * eta
            (T,) = _radial_hankel_tables_dev(
                symf, kmax, 0.0, self.r_tab_max, [_m_j0_dev],
                cache_key=("per-yukawa", float(kappa), float(eta)))
            corr = bessel_k0(kappa * rs) / (2 * np.pi) - T(rs)
            self.mean_shift = 0.0
        else:
            raise ValueError(kernel)
        self.mult = symf(self.kk_half) * self.deconv_half
        self.patches = jnp.where(mask, corr, 0.0)

    def __call__(self, q):
        """q: (S,) weighted charges -> (Nx, Ny) zero-mean periodic
        potential (laplace; exact when sum(q) = 0, neutralizing-background
        convention otherwise) / periodic Yukawa potential."""
        spread = self._spread(q)
        c = self.fft_plan.rfft2(spread)
        c = Cx(c.re * self.mult, c.im * self.mult)
        phi = self.fft_plan.irfft2_real(c)[: self.grid.Nx, : self.grid.Ny]
        (phi,) = self._apply_patches(
            [phi], [self.patches * q[:, None]])
        return phi - self.mean_shift * jnp.sum(q)


class StokesFreespaceGridEvaluator(_EvaluatorBase):
    """(u, v, p)(grid) from fixed Stokeslets: the Stokes analogue of
    FreespaceGridEvaluator (the reference evaluates this with an O(N) FMM,
    ipde/solvers/internals/stokes.py:26-35; here dense and FFT).

    Velocity symbol via the truncated biharmonic:
        uhat = Bhat_L * ky (ky fx - kx fy),  vhat = -Bhat_L * kx (ky fx - kx fy)
    (G = (grad grad - delta lap) B).  Pressure via the truncated Laplace
    symbol:  phat = -i (kx fx + ky fy) * Qhat_L,  Q = -G_lap.

    __call__(wfx, wfy) takes quadrature-weighted force components and
    returns (u, v, p) on the full grid.
    """

    MARGIN_H = 80.0   # Hasimoto screen reaches further (see _EvaluatorBase)

    def __init__(self, grid: Grid, src_x, src_y, pad: int = None, w: int = 16,
                 r_cut_h: float = 22.0, target_bounds=None, target_hull=None):
        src_x = np.asarray(src_x, np.float64).ravel()
        src_y = np.asarray(src_y, np.float64).ravel()
        self.S = src_x.size
        self._setup_box(grid, src_x, src_y, pad, target_bounds, target_hull)
        self._setup_spreading(src_x, src_y, w, wrap=False)
        L, eta = self.L, self.eta
        # velocity screen: the Hasimoto/Ewald factor (1 + k^2/4eta^2) gauss.
        # A plain Gaussian leaves (1 - gauss) k_i k_j / k^4 terms that are
        # NON-smooth at k = 0 (algebraic ~1e-4 far-field tails); with the
        # Hasimoto factor every complementary term is entire in k and the
        # residual near field is Gaussian-localized (classical 2D spectral
        # Ewald for Stokes).
        screen_v = lambda k: ((1.0 + k**2 / (4 * eta**2))
                              * jnp.exp(-(k**2) / (4 * eta**2)))
        screen = lambda k: jnp.exp(-(k**2) / (4 * eta**2))
        bsym = lambda k: biharmonic_truncated_symbol_dev(k, L) * screen_v(k)
        qsym = lambda k: laplace_truncated_symbol_dev(k, L) * screen(k)
        self.multB = bsym(self.kk_half) * self.deconv_half
        self.multQ = qsym(self.kk_half) * self.deconv_half
        self.kx_dev = self.kx_half
        self.ky_dev = self.ky_row
        # ---- near corrections --------------------------------------------
        # The band-limited velocity kernel is derivatives of the RADIAL
        # band-limited biharmonic Bs:  T_xx = -(A2 dy^2 + A1 dx^2)/r^2,
        # T_xy = (A2 - A1) dx dy / r^2, T_yy = -(A2 dx^2 + A1 dy^2)/r^2 with
        # A1 = Bs'/r, A2 = Bs''; pressure T_pj = -Gs' d_j / r with Gs the
        # band-limited -G_lap... (Q = -G_lap so T_pj = -Qs' d_j / r).
        hx, hy = grid.xh, grid.yh
        r_cut = r_cut_h * max(hx, hy)
        dx, dy, rr, mask = self._patch_geometry(src_x, src_y, r_cut)
        kmax = 12.0 * eta
        # A1 = Bs'/r = -(1/2pi) int Bhat k^2 (J1(z)/z) k dk -> moment
        # _m_j1_over_z gives k^2 J1/z; Ta = (1/2pi) int Bhat k^3 J0;
        # A2 = Bs'' = -Ta + Tb where Tb = (1/2pi) int Bhat k^2 (J1/z) k dk
        Tb_t, Ta_t = _radial_hankel_tables_dev(
            bsym, kmax, L, self.r_tab_max, [_m_j1_over_z_dev, _m_k2_j0_dev],
            cache_key=("stokesB", float(eta)))
        (Qb_t,) = _radial_hankel_tables_dev(
            qsym, kmax, L, self.r_tab_max, [_m_j1_over_z_dev],
            cache_key=("stokesQ", float(eta)))
        # full-patch device evaluation, masked afterwards (the weak host
        # core took ~40 s for the equivalent masked sweep at bench sizes)
        rs = jnp.where(mask, rr, 1.0)
        Tb = Tb_t(rs)
        A1 = -Tb
        A2 = -Ta_t(rs) + Tb
        # Qs'(r)/r table: -(1/2pi) int qsym k^2 (J1/z) k dk = -Qb;
        # T_pj = -Qs' d_j/r = +Qb * d_j
        Qb = Qb_t(rs)
        r2 = rs**2
        # Tensor-compressed correction storage: both the exact Stokeslet and
        # the band-limited kernel are radial-isotropic tensors,
        #     K_ij = KA(r) delta_ij + KB(r) d_i d_j / r^2,
        # (T_xx = -(A2 dy^2 + A1 dx^2)/r^2 = -A2 + (A2-A1) dx^2/r^2 via
        # dy^2 = r^2 - dx^2), so the correction needs THREE (S, P*P) arrays
        #     CA = G_A - T_A,  CB2 = (G_B - T_B)/r^2,  CP (pressure),
        # instead of five (Cxx/Cxy/Cyy/Cpx/Cpy): 2 x 143 MB less HBM per
        # evaluator at bench size; the d_i d_j contraction is rebuilt at
        # apply time from the O(S)+O(P) patch geometry.
        #
        # Exact kernels (mu = 1 Stokeslet + its pressure).  The real-space
        # identity is G_ij = (grad grad - delta lap) B + delta_ij/(8 pi):
        # the constant comes from the distributional k=0 part of B's FT
        # (r^2 log r grows), so the FFT pipeline applies G - 1/(8 pi) on the
        # diagonal.  We match the corrections to that effective kernel and
        # add sum(f)/(8 pi) back once in __call__.
        logr = jnp.log(r2) * 0.5
        G_A = -logr / (4 * np.pi) - 1.0 / (8 * np.pi)   # delta_ij part
        G_B = 1.0 / (4 * np.pi)                          # d_i d_j / r^2 part
        T_A = -A2
        T_B = A2 - A1

        def masked(vals):
            return jnp.where(mask, vals, 0.0)

        self.CA = masked(G_A - T_A)
        self.CB2 = masked((G_B - T_B) / r2)
        self.CP = masked(1.0 / (2 * np.pi * r2) - Qb)

    def __call__(self, wfx, wfy):
        """(S,) weighted force components -> (u, v, p) on the (Nx, Ny) grid."""
        sx_, sy_ = self._spread_pair(wfx, wfy)
        Fx, Fy = self.fft_plan.rfft2_stack([sx_, sy_])
        kx, ky = self.kx_dev, self.ky_dev
        # w = Bhat (ky Fx - kx Fy);  u = ky w;  v = -kx w
        wre = self.multB * (ky * Fx.re - kx * Fy.re)
        wim = self.multB * (ky * Fx.im - kx * Fy.im)
        Nx, Ny = self.grid.Nx, self.grid.Ny
        # p = ifft[-i (kx Fx + ky Fy) Qhat]
        sre = kx * Fx.re + ky * Fy.re
        sim = kx * Fx.im + ky * Fy.im
        u, v, p = self.fft_plan.irfft2_real_corner_stack(
            [Cx(ky * wre, ky * wim), Cx(-kx * wre, -kx * wim),
             Cx(self.multQ * sim, -self.multQ * sre)],
            Nx, Ny, self.sx_cells, self.sy_cells)
        # restore the constant the (grad grad - delta lap) B form drops
        u = u + jnp.sum(wfx) / (8 * jnp.pi)
        v = v + jnp.sum(wfy) / (8 * jnp.pi)
        # rebuild flat (S, P*P) offsets from O(S)+O(P) geometry (see
        # _patch_geometry: x varies slow, y varies fast in the flat layout)
        Pp = self.patch_P
        dxs = jnp.repeat(self.patch_nodex[:, None] + self.patch_locx[None, :],
                         Pp, axis=1)
        dys = jnp.tile(self.patch_nodey[:, None] + self.patch_locy[None, :],
                       (1, Pp))
        rdot = dxs * wfx[:, None] + dys * wfy[:, None]
        pu = self.CA * wfx[:, None] + self.CB2 * dxs * rdot
        pv = self.CA * wfy[:, None] + self.CB2 * dys * rdot
        pp = self.CP * rdot
        return tuple(self._apply_patches([u, v, p], [pu, pv, pp]))
