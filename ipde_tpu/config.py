"""Global configuration for ipde_tpu.

The framework targets spectral accuracy (1e-10 .. 1e-14 relative error), which
requires float64 arithmetic on the device.  Importing the package enables x64
and makes "highest" the default matmul precision, so that no f32 product
(f32 GMRES inner cycles, the f32 preconditioner) runs in TF32 on a GPU.

Complex data is carried as explicit (re, im) pairs (see ``ipde_tpu.ops.cx``);
2D transforms use the native complex128 FFT where the backend has one
(``backend_has_complex128``) and f64 DFT matmuls otherwise.

Reference parity: the reference package (dbstein/ipde) relies on MKL/numba
float64 throughout; see SURVEY.md section 2.
"""

from __future__ import annotations

import jax

# Enable x64 before anything else in the package touches jax.
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# Default floating point type for all device compute.
default_dtype = jnp.float64
default_np_dtype = np.float64


def backend_has_complex128() -> bool:
    """True when the active backend has a complex128 FFT (XLA's CPU
    backend and cuFFT on the GPU)."""
    return jax.default_backend() in ("cpu", "gpu")
