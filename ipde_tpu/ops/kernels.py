"""On-the-fly dense layer-potential applies (device, f64).

The FMM replacement (SURVEY.md 2.2: pyfmmlib2d/fmm2dpy/flexmm rows): source
counts in this framework are small (10^3-10^4 effective QFS sources) while
target counts are large (grid points), so dense quadrature evaluated on the
fly is the right tool.  Targets are processed in fixed-size chunks via
lax.map so peak memory is bounded by chunk x sources; within a chunk the
kernel evaluation and the contraction with the charges are one elementwise
chain ending in a row sum, which XLA fuses into a single reduction.

All applies take sources as precomputed weighted charges (charge * quadrature
weight already folded in by the caller when appropriate -- here we fold
weights inside, matching the naive forms in ops/singular.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_CHUNK = 32768
# cap on chunk*sources: a chunk body may materialize (chunk, S) f64
# intermediates, and XLA may keep a few loop iterations live at once --
# bound the per-iteration footprint (5e7 elements = 400 MB per array)
_CHUNK_ELEMS = 5 * 10**7


def _chunk_size(T: int, S: int = 0) -> int:
    """Power-of-two chunk bounded by _CHUNK and by _CHUNK_ELEMS / S:
    keeps padding waste < 2x for small target sets AND the per-chunk
    (chunk, S) intermediate footprint bounded for big source sets."""
    cap = _CHUNK
    if S > 0:
        while cap > 256 and cap * S > _CHUNK_ELEMS:
            cap //= 2
    c = 256
    while c < T and c < cap:
        c *= 2
    return c


def _chunked(eval_chunk, tx, ty, S: int = 0):
    """Apply eval_chunk over fixed-size target chunks with padding."""
    T = tx.shape[0]
    chunk = _chunk_size(T, S)
    nchunks = -(-T // chunk)
    pad = nchunks * chunk - T
    txc = jnp.pad(tx, (0, pad)).reshape(nchunks, chunk)
    tyc = jnp.pad(ty, (0, pad)).reshape(nchunks, chunk)
    out = jax.lax.map(lambda ab: eval_chunk(ab[0], ab[1]), (txc, tyc))
    return jax.tree_util.tree_map(lambda o: o.reshape(-1)[:T], out)


def kernel_matvec(A, q):
    """A @ q for a kernel matrix A built elementwise in the same program.

    Written as multiply + row sum so that XLA fuses the producer of A into
    the reduction: A is never written to device memory.  Stored matrices
    (QFS maps, preconditioner blocks) use jnp.matmul instead."""
    return jnp.sum(A * q[None, :], axis=1)


def laplace_slp_apply(sx, sy, weighted_charge, tx, ty):
    """sum_j -log|x - s_j| / (2 pi) * q_j at each target."""
    def chunk(cx, cy):
        dx = cx[:, None] - sx[None, :]
        dy = cy[:, None] - sy[None, :]
        r2 = dx * dx + dy * dy
        return kernel_matvec(-jnp.log(r2), weighted_charge) / (4 * jnp.pi)
    return _chunked(chunk, jnp.asarray(tx), jnp.asarray(ty), S=sx.shape[0])


def laplace_slp_grad_apply(sx, sy, weighted_charge, tx, ty):
    """(d/dx, d/dy) of the Laplace SLP at targets."""
    def chunk(cx, cy):
        dx = cx[:, None] - sx[None, :]
        dy = cy[:, None] - sy[None, :]
        ir2 = 1.0 / (dx * dx + dy * dy)
        gx = kernel_matvec(-dx * ir2, weighted_charge) / (2 * jnp.pi)
        gy = kernel_matvec(-dy * ir2, weighted_charge) / (2 * jnp.pi)
        return gx, gy
    return _chunked(chunk, jnp.asarray(tx), jnp.asarray(ty), S=sx.shape[0])


def mh_slp_apply(sx, sy, weighted_charge, tx, ty, k: float):
    """sum_j K0(k |x - s_j|) / (2 pi) * q_j (Yukawa potential).

    K0 evaluated on device via a rational/series split (jax has no K0):
    small z: K0 = -log(z/2) I0(z) + poly(z^2);  large z: asymptotic
    sqrt(pi/(2z)) e^{-z} poly(1/z).  Accuracy ~1e-14 (tested against scipy).
    """
    def chunk(cx, cy):
        dx = cx[:, None] - sx[None, :]
        dy = cy[:, None] - sy[None, :]
        z = k * jnp.sqrt(dx * dx + dy * dy)
        return kernel_matvec(bessel_k0(z), weighted_charge) / (2 * jnp.pi)
    return _chunked(chunk, jnp.asarray(tx), jnp.asarray(ty), S=sx.shape[0])


# ---------------------------------------------------------------------------
# device Bessel functions (f64): series + asymptotic, branch via where
# ---------------------------------------------------------------------------

def _i0_series(z):
    """I0 via its power series (used for z <= 2; 12 terms reach ~1e-16)."""
    q = 0.25 * z * z
    term = jnp.ones_like(z)
    acc = jnp.ones_like(z)
    for m in range(1, 13):
        term = term * q / (m * m)
        acc = acc + term
    return acc


def _k0_small(z):
    """K0 = -(log(z/2) + gamma) I0(z) + sum_{m>=1} H_m q^m / (m!)^2."""
    gamma = 0.5772156649015328606
    q = 0.25 * z * z
    term = jnp.ones_like(z)
    acc = jnp.zeros_like(z)
    H = 0.0
    for m in range(1, 13):
        term = term * q / (m * m)
        H = H + 1.0 / m
        acc = acc + term * H
    zs = jnp.maximum(z, 1e-30)   # f32-representable: masked z=0 lanes stay finite
    return -(jnp.log(0.5 * zs) + gamma) * _i0_series(z) + acc


def _k0_large(z):
    """Asymptotic: K0(z) = sqrt(pi/(2z)) e^{-z} sum a_m / z^m  (z >= 12;
    truncation error ~ e^{-2z} relative, far below the kernel's own size)."""
    zs = jnp.maximum(z, 12.0)
    u = 1.0 / (8.0 * zs)
    s = jnp.ones_like(zs)
    term = jnp.ones_like(zs)
    for m in range(1, 12):
        term = term * (-(2 * m - 1) ** 2) * u / m
        s = s + term
    return jnp.sqrt(jnp.pi / (2.0 * zs)) * jnp.exp(-zs) * s


@functools.lru_cache(maxsize=4)
def _cheb_fit_scaled(which: str, lo: float = 2.0, hi: float = 12.0,
                     deg: int = 28):
    """Host-side Chebyshev fit of K_nu(z) e^z sqrt(z) on [lo, hi] (smooth,
    cancellation-free); coefficients feed a device Clenshaw evaluation."""
    from scipy.special import k0 as _sk0, k1 as _sk1
    import numpy as _np
    f = _sk0 if which == "k0" else _sk1
    xc = _np.cos(_np.pi * (_np.arange(deg) + 0.5) / deg)
    zc = 0.5 * (hi + lo) + 0.5 * (hi - lo) * xc
    vals = f(zc) * _np.exp(zc) * _np.sqrt(zc)
    c = _np.polynomial.chebyshev.chebfit(xc, vals, deg - 1)
    # return host numpy (a cached jnp array could leak tracers across traces)
    return tuple(float(v) for v in c), lo, hi


def _cheb_mid(z, which: str):
    c, lo, hi = _cheb_fit_scaled(which)
    x = (2.0 * z - (hi + lo)) / (hi - lo)
    # Clenshaw recurrence for sum c_k T_k(x)
    b1 = jnp.zeros_like(z)
    b2 = jnp.zeros_like(z)
    n = len(c)
    for k in range(n - 1, 0, -1):
        b1, b2 = 2.0 * x * b1 - b2 + c[k], b1
    val = x * b1 - b2 + c[0]
    zs = jnp.maximum(z, 1e-3)
    return val * jnp.exp(-zs) / jnp.sqrt(zs)


def bessel_k0(z):
    z = jnp.asarray(z)
    small = z < 2.0
    large = z > 12.0
    zs = jnp.where(small, z, 0.0)
    zm = jnp.clip(z, 2.0, 12.0)
    zl = jnp.where(large, z, 15.0)
    return jnp.where(small, _k0_small(zs),
                     jnp.where(large, _k0_large(zl), _cheb_mid(zm, "k0")))


def expint_e1(x):
    """E1(x) for x > 0 on device (f64, ~1e-14): series below 1, Chebyshev
    fit of x e^x E1(x) on [1, 44] (E1(44) ~ 2e-21: callers' arguments are
    eta^2 r^2 <= ~40)."""
    x = jnp.asarray(x)
    gamma = 0.5772156649015328606
    small = x < 1.0
    xs = jnp.where(small, jnp.maximum(x, 1e-300), 1.0)
    term = jnp.ones_like(x)
    acc = jnp.zeros_like(x)
    for m in range(1, 18):
        term = term * (-xs) / m
        acc = acc - term / m
    e1_small = -gamma - jnp.log(xs) + acc
    xm = jnp.clip(x, 1.0, 44.0)
    e1_mid = _cheb_e1(xm)
    return jnp.where(small, e1_small, e1_mid)


@functools.lru_cache(maxsize=1)
def _cheb_e1_coeffs(lo: float = 1.0, hi: float = 44.0, deg: int = 48):
    from scipy.special import exp1
    import numpy as _np
    xc = _np.cos(_np.pi * (_np.arange(deg) + 0.5) / deg)
    zc = 0.5 * (hi + lo) + 0.5 * (hi - lo) * xc
    vals = exp1(zc) * zc * _np.exp(zc)
    c = _np.polynomial.chebyshev.chebfit(xc, vals, deg - 1)
    return tuple(float(v) for v in c), lo, hi


def _cheb_e1(z):
    c, lo, hi = _cheb_e1_coeffs()
    x = (2.0 * z - (hi + lo)) / (hi - lo)
    b1 = jnp.zeros_like(z)
    b2 = jnp.zeros_like(z)
    for k in range(len(c) - 1, 0, -1):
        b1, b2 = 2.0 * x * b1 - b2 + c[k], b1
    val = x * b1 - b2 + c[0]
    return val * jnp.exp(-z) / z


# -- Bessel J (device, f64): series z<4 / Chebyshev [4,40] / Hankel z>40 ----

@functools.lru_cache(maxsize=8)
def _cheb_fit_j(nu: int, lo: float = 4.0, hi: float = 40.0, deg: int = 96):
    """Host Chebyshev fit of J_nu on [lo, hi] for the device mid-range."""
    from scipy.special import jv as _jv
    import numpy as _np
    xc = _np.cos(_np.pi * (_np.arange(deg) + 0.5) / deg)
    zc = 0.5 * (hi + lo) + 0.5 * (hi - lo) * xc
    c = _np.polynomial.chebyshev.chebfit(xc, _jv(nu, zc), deg - 1)
    return tuple(float(v) for v in c), lo, hi


def _cheb_eval_j(z, nu: int):
    c, lo, hi = _cheb_fit_j(nu)
    x = (2.0 * z - (hi + lo)) / (hi - lo)
    b1 = jnp.zeros_like(z)
    b2 = jnp.zeros_like(z)
    for k in range(len(c) - 1, 0, -1):
        b1, b2 = 2.0 * x * b1 - b2 + c[k], b1
    return x * b1 - b2 + c[0]


def _j_series(z, nu: int, terms: int = 24):
    """Power series sum_m (-1)^m q^m / (m! (m+nu)!) * (z/2)^nu, q = z^2/4
    (used for z <= 4: alternating, <=1 digit of cancellation)."""
    q = 0.25 * z * z
    term = jnp.ones_like(z)
    acc = jnp.ones_like(z)
    for m in range(1, terms):
        term = term * (-q) / (m * (m + nu))
        acc = acc + term
    import math
    pref = (0.5 * z) ** nu / math.factorial(nu)
    return pref * acc


def _j_asym(z, nu: int, terms: int = 11):
    """Hankel asymptotic expansion (z >= 40: truncation ~1e-14)."""
    zs = jnp.maximum(z, 40.0)
    mu = 4.0 * nu * nu
    inv8z = 1.0 / (8.0 * zs)
    a = jnp.ones_like(zs)
    P = jnp.ones_like(zs)
    Q = jnp.zeros_like(zs)
    sp = 1.0
    sq = 1.0
    for k in range(1, terms):
        a = a * (mu - (2 * k - 1) ** 2) * inv8z / k
        if k % 2 == 0:
            sp = -sp
            P = P + sp * a
        else:
            Q = Q + sq * a
            sq = -sq
    # J_nu = sqrt(2/(pi z)) [P cos(w) - Q sin(w)], w = z - (2 nu + 1) pi/4
    w = zs - (2 * nu + 1) * (jnp.pi / 4.0)
    return jnp.sqrt(2.0 / (jnp.pi * zs)) * (P * jnp.cos(w)
                                            - Q * jnp.sin(w))


def _bessel_j(z, nu: int):
    z = jnp.asarray(z, jnp.float64)
    small = z < 4.0
    large = z > 40.0
    zs = jnp.where(small, z, 0.0)
    zm = jnp.clip(z, 4.0, 40.0)
    return jnp.where(small, _j_series(zs, nu),
                     jnp.where(large, _j_asym(z, nu), _cheb_eval_j(zm, nu)))


def bessel_j0(z):
    return _bessel_j(z, 0)


def bessel_j1(z):
    return _bessel_j(z, 1)


def bessel_j2(z):
    return _bessel_j(z, 2)


def _k1_small(z):
    """K1(z) = 1/z + log(z/2) I1(z) - (1/2) sum_{m>=0} [H_m + H_{m+1}]
               q^m z / (2 m! (m+1)!) ... standard series."""
    gamma = 0.5772156649015328606
    q = 0.25 * z * z
    zs = jnp.maximum(z, 1e-30)
    # I1(z) = (z/2) sum q^m / (m! (m+1)!)
    term = jnp.ones_like(z)
    i1_acc = jnp.ones_like(z)
    for m in range(1, 13):
        term = term * q / (m * (m + 1))
        i1_acc = i1_acc + term
    i1 = 0.5 * z * i1_acc
    # correction sum: (z/4) sum_{m>=0} (H_m + H_{m+1}) q^m / (m!(m+1)!)
    term = jnp.ones_like(z)
    Hm, Hm1 = 0.0, 1.0
    acc = (Hm + Hm1) * term
    for m in range(1, 13):
        term = term * q / (m * (m + 1))
        Hm = Hm + 1.0 / m
        Hm1 = Hm1 + 1.0 / (m + 1)
        acc = acc + (Hm + Hm1) * term
    corr = 0.25 * z * acc
    return 1.0 / zs + (jnp.log(0.5 * zs) + gamma) * i1 - corr


def _k1_large(z):
    zs = jnp.maximum(z, 12.0)
    u = 1.0 / (8.0 * zs)
    mu = 4.0  # nu^2 * 4 = 4 for K1
    s = jnp.ones_like(zs)
    term = jnp.ones_like(zs)
    for m in range(1, 12):
        term = term * (mu - (2 * m - 1) ** 2) * u / m
        s = s + term
    return jnp.sqrt(jnp.pi / (2.0 * zs)) * jnp.exp(-zs) * s


def bessel_k1(z):
    z = jnp.asarray(z)
    small = z < 2.0
    large = z > 12.0
    zs = jnp.where(small, z, 0.0)
    zm = jnp.clip(z, 2.0, 12.0)
    zl = jnp.where(large, z, 15.0)
    return jnp.where(small, _k1_small(zs),
                     jnp.where(large, _k1_large(zl), _cheb_mid(zm, "k1")))
