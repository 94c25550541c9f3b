"""Planified-jit solve must match the eager path, leak no tracers, and
report jit-safe solve stats."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def problem():
    from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu.solvers.bie import DirichletBIE
    from ipde_tpu.solvers.scalar import PoissonSolver

    sol = lambda x, y: -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)
    frc = lambda x, y: ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x)
                         - np.cos(x) ** 3) * np.exp(np.sin(x)) * np.sin(y))
    bdy = star(96, a=0.1, f=3)
    M = 6
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)
    ebdyc = EmbeddedBoundaryCollection([ebdy])
    ebdyc.generate_grid(bh)
    f = EmbeddedFunction.from_function(ebdyc, frc)
    bc = BoundaryFunction.from_function(ebdyc, sol)
    solver = PoissonSolver(ebdyc)
    bie = DirichletBIE(solver)
    return solver, bie, f, bc


def test_planified_matches_plain(problem):
    import jax
    from ipde_tpu.functions import EmbeddedFunction
    from ipde_tpu.utils.planify import planified

    solver, bie, f, bc = problem
    plain = bie.apply_bc(solver(f, tol=1e-12), bc)

    def step(fg, frad):
        ef = EmbeddedFunction(fg, [frad])
        ue, st = solver.solve_with_stats(ef, tol=1e-12)
        return bie.apply_bc(ue, bc).grid, st

    run = planified(step, solver, bie)
    assert run.store.n_arrays > 20
    g, stats = run(f.grid, f.radials[0])
    diff = float(np.abs(np.asarray(g) - np.asarray(plain.grid)).max())
    assert diff < 1e-10, diff
    # stats are concrete device values after the call
    assert int(stats["annular_iterations"][0]) > 0
    assert float(stats["annular_residuals"][0]) < 1e-10
    # objects must be restored to concrete arrays (no tracer leaks)
    assert not isinstance(solver._symbol, jax.core.Tracer)
    assert not isinstance(solver.helpers[0].f_to_bdy, jax.core.Tracer)
    # eager path still functional after tracing
    again = bie.apply_bc(solver(f, tol=1e-12), bc)
    d2 = float(np.abs(np.asarray(again.grid) - np.asarray(plain.grid)).max())
    assert d2 < 1e-13


def test_entry_planified():
    """__graft_entry__.entry must return a function whose plans are args."""
    import sys
    sys.path.insert(0, "/root/repo")
    import jax
    from __graft_entry__ import entry

    fn, args = entry()
    plans = args[0]
    assert isinstance(plans, list) and len(plans) > 20
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()
