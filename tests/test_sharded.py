"""Mesh-sharded applies and the first-class use_mesh solve path must agree
with the single-device path to roundoff (conftest forces
an 8-virtual-device CPU backend)."""

import numpy as np
import jax.numpy as jnp

from ipde_tpu.parallel.sharded import (make_mesh, sharded_laplace_slp_apply,
                                       sharded_mh_slp_apply,
                                       sharded_stokes_slp_apply,
                                       source_sharded_laplace_slp_apply)
from ipde_tpu.ops import kernels
from ipde_tpu.ops import stokes_kernels as sk


def _pts(S=37, T=101):
    rng = np.random.default_rng(7)
    th = np.linspace(0, 2 * np.pi, S, endpoint=False)
    sx = np.cos(th)
    sy = np.sin(th)
    q = rng.standard_normal(S)
    tx = 0.4 * rng.standard_normal(T)
    ty = 0.4 * rng.standard_normal(T)
    return sx, sy, q, tx, ty


def test_sharded_applies_match_dense():
    mesh = make_mesh(8)
    sx, sy, q, tx, ty = _pts()
    ref = np.asarray(kernels.laplace_slp_apply(sx, sy, q, tx, ty))
    out = np.asarray(sharded_laplace_slp_apply(mesh, sx, sy, q, tx, ty))
    assert np.abs(out - ref).max() < 1e-13
    out2 = np.asarray(source_sharded_laplace_slp_apply(mesh, sx, sy, q,
                                                       tx, ty))
    assert np.abs(out2 - ref).max() < 1e-12
    refm = np.asarray(kernels.mh_slp_apply(sx, sy, q, tx, ty, 3.0))
    outm = np.asarray(sharded_mh_slp_apply(mesh, sx, sy, q, tx, ty, 3.0))
    assert np.abs(outm - refm).max() < 1e-13
    q2 = np.roll(q, 3)
    ru, rv, rp = [np.asarray(a) for a in
                  sk.stokes_slp_apply(sx, sy, q, q2, tx, ty)]
    su, sv, sp = [np.asarray(a) for a in
                  sharded_stokes_slp_apply(mesh, sx, sy, q, q2, tx, ty)]
    assert np.abs(su - ru).max() < 1e-13
    assert np.abs(sv - rv).max() < 1e-13
    assert np.abs(sp - rp).max() < 1e-13


def test_use_mesh_solve_matches_single_device():
    from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu.solvers.bie import DirichletBIE
    from ipde_tpu.solvers.scalar import PoissonSolver

    sol = lambda x, y: -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)
    frc = lambda x, y: ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x)
                         - np.cos(x) ** 3) * np.exp(np.sin(x)) * np.sin(y))
    bdy = star(64, a=0.1, f=3)
    M = 6
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)
    ebdyc = EmbeddedBoundaryCollection([ebdy])
    ebdyc.generate_grid(bh)
    f = EmbeddedFunction.from_function(ebdyc, frc)
    bc = BoundaryFunction.from_function(ebdyc, sol)
    solver = PoissonSolver(ebdyc)
    bie = DirichletBIE(solver)
    base = np.asarray(bie.apply_bc(solver(f, tol=1e-12), bc).grid)
    mesh = make_mesh(8)
    solver.use_mesh(mesh)
    with mesh:
        sharded = np.asarray(bie.apply_bc(solver(f, tol=1e-12), bc).grid)
    solver.use_mesh(None)
    # chunking differences (lax.map 256-chunks vs shard_map slices) reorder
    # sums feeding the GMRES; agreement is at accumulated-roundoff level
    assert np.abs(sharded - base).max() < 5e-12


def test_use_mesh_two_body_sharded_fft_and_boundary_axis():
    """Multi-boundary use_mesh solve: exercises the SHARDED 2D grid FFT
    (per-pass sharding constraints + the all-to-all between passes) and
    the boundary-axis-sharded batched annular GMRES (SURVEY.md
    2.3(b)(d)); must agree with the single-device solve."""
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from __graft_entry__ import _build_problem

    solver, bie, f, bc = _build_problem(nb=64, M=6, two_body=True)
    base = np.asarray(bie.apply_bc(solver(f, tol=1e-12), bc).grid)
    mesh = make_mesh(8)
    solver.use_mesh(mesh)
    # the box-solve / VG / BIE fft plans must now carry the mesh
    assert solver.ebdyc.fft_plan.mesh is mesh
    if solver.grid_eval is not None:
        assert solver.grid_eval.fft_plan.mesh is mesh
    with mesh:
        sharded = np.asarray(bie.apply_bc(solver(f, tol=1e-12), bc).grid)
    solver.use_mesh(None)
    assert solver.ebdyc.fft_plan.mesh is None
    assert np.abs(sharded - base).max() < 1e-12
