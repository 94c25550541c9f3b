"""Exterior-domain end-to-end coverage.

The reference exercises interior=False geometry in
examples/embedded_boundary.py:17; its exterior SOLVES appear as inclusion
boundaries in multi-body configs.  Here: (1) exterior geometry operator
checks, (2) a full periodic-box Poisson solve with a single inclusion
(exterior) boundary, Dirichlet BC on the inclusion.
"""

import numpy as np

from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu.geometry.curve import star
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu.geometry.grid import Grid


def test_exterior_geometry_ops():
    nb, M = 300, 10
    bdy = star(nb, x=np.pi, y=np.pi, a=0.1, f=3, r=0.9)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    e = EmbeddedBoundary(bdy, False, M, bh)
    assert e.lb == 0.0 and e.ub > 0.0
    F = lambda x, y: np.sin(x) * np.cos(y)
    fr = F(e.radial_x, e.radial_y)
    # radial -> boundary / interface interpolation rows
    fb = np.asarray(e.interpolate_radial_to_boundary(fr))
    assert np.abs(fb - F(bdy.x, bdy.y)).max() < 1e-10
    fi = np.asarray(e.interpolate_radial_to_interface(fr))
    assert np.abs(fi - F(e.interface.x, e.interface.y)).max() < 1e-10
    # normal derivative at the boundary (outward normal = +r direction)
    FX = lambda x, y: np.cos(x) * np.cos(y)
    FY = lambda x, y: -np.sin(x) * np.sin(y)
    fn = np.asarray(e.interpolate_radial_to_boundary_normal_derivative(fr))
    exact = FX(bdy.x, bdy.y) * bdy.normal_x + FY(bdy.x, bdy.y) * bdy.normal_y
    assert np.abs(fn - exact).max() < 1e-7


def test_exterior_boundary_poisson_solve():
    """Full Poisson solve on a doubly-connected domain: the inclusion is an
    interior=False EmbeddedBoundary, exercising every exterior-side path
    (annular solve with r in [0, w], sign-flipped QFS densities, the BIE's
    rank completion for the inclusion's Laplace DLP).

    A PERIODIC-box exterior solve (no enclosing boundary) is intentionally
    not covered: the reference's exterior_periodic/laplace.py is a stub and
    the free-space BIE representation does not apply there.
    """
    from ipde_tpu.solvers.bie import DirichletBIE
    from ipde_tpu.solvers.scalar import PoissonSolver

    sol = lambda x, y: -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)
    frc = lambda x, y: ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x)
                         - np.cos(x) ** 3) * np.exp(np.sin(x)) * np.sin(y))

    nb, M = 300, 10
    outer = star(nb, a=0.1, f=3)
    bh = min(outer.min_h(), 0.6 / np.abs(outer.curvature).max() / M)
    e0 = EmbeddedBoundary(outer, True, M, bh)
    inner = star(200, x=0.15, y=-0.1, r=0.35, a=0.08, f=4)
    e1 = EmbeddedBoundary(inner, False, M, bh)
    assert not e1.interior
    ebdyc = EmbeddedBoundaryCollection([e0, e1])
    ebdyc.generate_grid(bh)

    f = EmbeddedFunction.from_function(ebdyc, frc)
    ua = EmbeddedFunction.from_function(ebdyc, sol)
    bc = BoundaryFunction.from_function(ebdyc, sol)
    solver = PoissonSolver(ebdyc)
    ue = DirichletBIE(solver).apply_bc(solver(f, tol=1e-13), bc)
    err = float(abs(ue - ua).max_on(ebdyc))
    assert err < 5e-8, f"2-body (inclusion) Poisson: err {err:.2e}"
