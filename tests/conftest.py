import os

# Tests run on CPU with 8 virtual devices so multi-chip sharding logic is
# exercised without accelerator hardware.  The on-chip checks are marked
# `chip` and skip on the CPU; IPDE_CHIP_TESTS=1 leaves the platform to JAX
# so that they can run on a GPU:
#     IPDE_CHIP_TESTS=1 python -m pytest tests/test_chip.py -m chip
ON_CHIP = os.environ.get("IPDE_CHIP_TESTS") == "1"
if not ON_CHIP:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault(
        "XLA_FLAGS",
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8",
    )
# no persistent compile cache: parallel test workers would share one
# directory inside the checkout (tests/test_xla_cache.py covers the cache)
os.environ.setdefault("IPDE_XLA_CACHE", "0")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
if not ON_CHIP:
    jax.config.update("jax_platforms", "cpu")
