"""Device special functions (Bessel J) vs scipy."""

import numpy as np

from ipde_tpu.ops.kernels import bessel_j0, bessel_j1, bessel_j2


def test_bessel_j():
    from scipy.special import j0, j1, jv
    rng = np.random.default_rng(1)
    z = np.concatenate([rng.uniform(0, 4, 2000), rng.uniform(4, 40, 2000),
                        rng.uniform(40, 9000, 2000),
                        [0.0, 3.9999, 4.0, 40.0, 40.0001]])
    import jax.numpy as jnp
    zd = jnp.asarray(z)
    for fn, ref, nu in [(bessel_j0, j0, 0), (bessel_j1, j1, 1),
                        (bessel_j2, None, 2)]:
        want = ref(z) if ref is not None else jv(2, z)
        got = np.asarray(fn(zd))
        err = np.abs(got - want).max()
        assert err < 2e-14, (nu, err)
