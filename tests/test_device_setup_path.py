"""The device setup path (forms_dev + device_linalg QFS/BIE) must solve to
the same accuracy as the host LAPACK path.  Runs on CPU with auto_backend
patched to 'device', so the algorithms are exercised with exact matmuls."""

import numpy as np
import pytest

import ipde_tpu.qfs.qfs as qfs_mod
from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu.geometry.curve import star
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary


@pytest.fixture
def device_backend(monkeypatch):
    monkeypatch.setattr(qfs_mod, "auto_backend",
                        lambda: "device")


def _geometry(nb=300, M=12):
    bdy = star(nb, a=0.2, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    ebdyc = EmbeddedBoundaryCollection([ebdy])
    ebdyc.generate_grid(bh)
    return ebdyc


def test_poisson_device_setup(device_backend):
    from ipde_tpu.solvers.bie import DirichletBIE
    from ipde_tpu.solvers.scalar import PoissonSolver
    ebdyc = _geometry()
    sol = lambda x, y: -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)
    frc = lambda x, y: ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x)
                         - np.cos(x) ** 3) * np.exp(np.sin(x)) * np.sin(y))
    f = EmbeddedFunction.from_function(ebdyc, frc)
    ua = EmbeddedFunction.from_function(ebdyc, sol)
    bc = BoundaryFunction.from_function(ebdyc, sol)
    solver = PoissonSolver(ebdyc)
    bie = DirichletBIE(solver)
    assert bie.A_dev is not None        # the device path was actually taken
    ue = bie.apply_bc(solver(f, tol=1e-13), bc)
    ge = np.abs(np.asarray(ue.grid) - np.asarray(ua.grid))[
        np.asarray(ebdyc.phys)].max()
    re = np.abs(np.asarray(ue.radials[0]) - np.asarray(ua.radials[0])).max()
    assert max(ge, re) < 2e-10, (ge, re)


def test_stokes_device_setup(device_backend):
    from ipde_tpu.solvers.bie import StokesDirichletBIE
    from ipde_tpu.solvers.vector import StokesSolver
    ebdyc = _geometry()
    usol = lambda x, y: np.sin(x) * np.cos(y) + 0.2 * np.cos(2 * y)
    vsol = lambda x, y: -np.cos(x) * np.sin(y) + 0.1 * np.sin(2 * x)
    fuf = lambda x, y: (2 * np.sin(x) * np.cos(y) + 0.8 * np.cos(2 * y)
                        - np.sin(x) * np.sin(y))
    fvf = lambda x, y: (-2 * np.cos(x) * np.sin(y) + 0.4 * np.sin(2 * x)
                        + np.cos(x) * np.cos(y))
    fu = EmbeddedFunction.from_function(ebdyc, fuf)
    fv = EmbeddedFunction.from_function(ebdyc, fvf)
    ua = EmbeddedFunction.from_function(ebdyc, usol)
    bc_u = BoundaryFunction.from_function(ebdyc, usol)
    bc_v = BoundaryFunction.from_function(ebdyc, vsol)
    solver = StokesSolver(ebdyc)
    bie = StokesDirichletBIE(solver)
    assert bie.A_dev is not None
    (u, v, p) = solver(fu, fv, tol=1e-12)
    u, v, p = bie.apply_bc(u, v, p, bc_u, bc_v)
    ge = np.abs(np.asarray(u.grid) - np.asarray(ua.grid))[
        np.asarray(ebdyc.phys)].max()
    re = np.abs(np.asarray(u.radials[0]) - np.asarray(ua.radials[0])).max()
    # 3.8e-9 is this config's discretization floor: the host-gelsy path
    # measures the identical value (tools bisect, round 3)
    assert max(ge, re) < 5e-9, (ge, re)


def test_neumann_device_setup(device_backend):
    from ipde_tpu.solvers.bie import NeumannBIE
    from ipde_tpu.solvers.scalar import ModifiedHelmholtzSolver
    ebdyc = _geometry()
    k = 2.0
    sol = lambda x, y: np.exp(np.sin(x)) * np.sin(2 * y)
    # (k^2 - lap) u = f
    frc = lambda x, y: ((k**2 + 4) * np.exp(np.sin(x)) * np.sin(2 * y)
                        - (np.cos(x) ** 2 - np.sin(x))
                        * np.exp(np.sin(x)) * np.sin(2 * y))
    f = EmbeddedFunction.from_function(ebdyc, frc)
    ua = EmbeddedFunction.from_function(ebdyc, sol)
    e = ebdyc.ebdys[0]
    dudx = lambda x, y: np.cos(x) * np.exp(np.sin(x)) * np.sin(2 * y)
    dudy = lambda x, y: 2 * np.exp(np.sin(x)) * np.cos(2 * y)
    bn = BoundaryFunction(
        [dudx(e.bdy.x, e.bdy.y) * e.bdy.normal_x
         + dudy(e.bdy.x, e.bdy.y) * e.bdy.normal_y])
    solver = ModifiedHelmholtzSolver(ebdyc, k=k)
    bie = NeumannBIE(solver)
    assert bie.A_dev is not None
    ue = bie.apply_bc(solver(f, tol=1e-13), bn)
    ge = np.abs(np.asarray(ue.grid) - np.asarray(ua.grid))[
        np.asarray(ebdyc.phys)].max()
    assert ge < 5e-9, ge
