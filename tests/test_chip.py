"""On-chip checks: the phases of chip_smoke.py as tests.

Marked `chip`; each skips unless JAX's first device is a GPU (decided in
the fixture, never at import).  Run on the card with
    IPDE_CHIP_TESTS=1 python -m pytest tests/test_chip.py -m chip
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.chip


@pytest.fixture(scope="module")
def gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (first device: {dev.platform})")
    return dev


@pytest.fixture(scope="module")
def tier1(gpu):
    return chip_smoke.build_geometry()


def test_dense_applies_and_box_solve(tier1):
    problem = chip_smoke.poisson_problem(tier1)
    assert chip_smoke.phase1(tier1, problem[0])


def test_interior_poisson(tier1):
    problem = chip_smoke.poisson_problem(tier1)
    _, err = chip_smoke.run_solve("poisson", problem, tier1,
                                  chip_smoke.CacheHits(), n_timed=1)
    assert err <= chip_smoke.POISSON_TOL


def test_interior_stokes(tier1):
    problem = chip_smoke.stokes_problem(tier1)
    _, err = chip_smoke.run_solve("stokes", problem, tier1,
                                  chip_smoke.CacheHits(), n_timed=1)
    assert err <= chip_smoke.STOKES_TOL
