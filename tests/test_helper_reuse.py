"""Solver/helper reuse for moving-boundary runs.

When geometry is regenerated with the same (n, M, radial bounds) and a
nearby radius, a new solver built with helpers= must REUSE the previous
annular solvers (the per-mode preconditioner is the dominant per-step
rebuild cost) and still solve to discretization accuracy.
Reference analogue: ipde/solvers/multi_boundary/modified_helmholtz.py:13-39.
"""

import numpy as np

from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu.geometry.curve import star
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary


def _setup(a, bh, nb=200, M=10):
    bdy = star(nb, a=a, f=5)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    ebdyc = EmbeddedBoundaryCollection([ebdy])
    ebdyc.generate_grid(bh)
    return ebdyc


def test_scalar_helper_reuse():
    from ipde_tpu.solvers.scalar import ModifiedHelmholtzSolver
    nb, M = 200, 10
    bdy0 = star(nb, a=0.2, f=5)
    bh = min(bdy0.min_h(), 0.6 / np.abs(bdy0.curvature).max() / M)
    ebdyc0 = _setup(0.2, bh, nb, M)
    ebdyc1 = _setup(0.205, bh, nb, M)     # the "moved" geometry
    s0 = ModifiedHelmholtzSolver(ebdyc0, k=2.0)
    s1 = ModifiedHelmholtzSolver(ebdyc1, k=2.0, helpers=s0.helpers)
    assert s1.helpers[0].annular_solver is s0.helpers[0].annular_solver
    # different k must NOT reuse
    s2 = ModifiedHelmholtzSolver(ebdyc1, k=3.0, helpers=s0.helpers)
    assert s2.helpers[0].annular_solver is not s0.helpers[0].annular_solver
    # the reused-preconditioner solve still reaches discretization accuracy
    k = 2.0
    sol = lambda x, y: np.exp(np.sin(x)) * np.sin(2 * y)
    frc = lambda x, y: ((k**2 + 4) * np.exp(np.sin(x)) * np.sin(2 * y)
                        - (np.cos(x) ** 2 - np.sin(x))
                        * np.exp(np.sin(x)) * np.sin(2 * y))
    f = EmbeddedFunction.from_function(ebdyc1, frc)
    ua = EmbeddedFunction.from_function(ebdyc1, sol)
    from ipde_tpu.solvers.bie import DirichletBIE
    bc = BoundaryFunction.from_function(ebdyc1, sol)
    bie = DirichletBIE(s1)
    ue = bie.apply_bc(s1(f, tol=1e-13), bc)
    ge = np.abs(np.asarray(ue.grid) - np.asarray(ua.grid))[
        np.asarray(ebdyc1.phys)].max()
    fresh = ModifiedHelmholtzSolver(ebdyc1, k=2.0)
    bie_f = DirichletBIE(fresh)
    uf = bie_f.apply_bc(fresh(f, tol=1e-13), bc)
    gf = np.abs(np.asarray(uf.grid) - np.asarray(ua.grid))[
        np.asarray(ebdyc1.phys)].max()
    assert ge < max(3 * gf, 1e-9), (ge, gf)


def test_stokes_helper_reuse_donor():
    from ipde_tpu.solvers.vector import StokesSolver
    nb, M = 200, 10
    bdy0 = star(nb, a=0.2, f=5)
    bh = min(bdy0.min_h(), 0.6 / np.abs(bdy0.curvature).max() / M)
    ebdyc0 = _setup(0.2, bh, nb, M)
    ebdyc1 = _setup(0.205, bh, nb, M)
    s0 = StokesSolver(ebdyc0)
    s1 = StokesSolver(ebdyc1, helpers=s0.helpers)
    assert s1.helpers[0].annular_solver is s0.helpers[0].annular_solver
    # incompatible M: no reuse
    bdy2 = star(nb, a=0.2, f=5)
    ebdy2 = EmbeddedBoundary(bdy2, True, M + 2, bh, qfs_tolerance=1e-14)
    c2 = EmbeddedBoundaryCollection([ebdy2])
    c2.generate_grid(bh)
    s2 = StokesSolver(c2, helpers=s0.helpers)
    assert s2.helpers[0].annular_solver is not s0.helpers[0].annular_solver
