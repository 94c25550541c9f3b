"""Capacity padding (pad_quantum): moving-geometry plan arrays keep
step-invariant shapes so compiled programs are reused across timesteps
(utils.planify.replan), and padded solves/advections are EXACTLY
equivalent to unpadded ones (padded scatter slots carry out-of-range
indices, dropped by jax's default FILL_OR_DROP mode).

Reference analogue: none -- the reference is eager numpy and rebuilds
everything per step (ipde/advection/fe_advector.py:60-71); fixed shapes
are what jit needs to reuse a compiled program (SURVEY.md section 7).
"""

import numpy as np
import pytest

from ipde_tpu.functions import EmbeddedFunction
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu.geometry.curve import star
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu.geometry.partition import PointPartition


def _make(nb=100, M=8, pad_quantum=None):
    bdy = star(nb, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)
    ebdyc = EmbeddedBoundaryCollection([ebdy])
    ebdyc.generate_grid(bh, pad_quantum=pad_quantum)
    return ebdyc


def test_padded_solve_matches_unpadded():
    sol = lambda x, y: np.sin(x) * np.cos(y)
    frc = lambda x, y: -2.0 * np.sin(x) * np.cos(y)
    from ipde_tpu.solvers.bie import DirichletBIE
    from ipde_tpu.solvers.scalar import PoissonSolver
    from ipde_tpu.functions import BoundaryFunction

    outs = []
    for pq in (None, 512):
        ebdyc = _make(pad_quantum=pq)
        f = EmbeddedFunction.from_function(ebdyc, frc)
        bc = BoundaryFunction.from_function(ebdyc, sol)
        solver = PoissonSolver(ebdyc)
        ue = DirichletBIE(solver).apply_bc(solver(f, tol=1e-13), bc)
        outs.append((np.asarray(ue.grid), np.asarray(ue.radials[0]),
                     np.asarray(ebdyc.phys)))
    (g0, r0, phys), (g1, r1, _) = outs
    assert np.abs((g1 - g0)[phys]).max() < 1e-13
    assert np.abs(r1 - r0).max() < 1e-13


def test_padded_partition_shapes_step_invariant():
    """Rotated geometry -> same plan shapes (the replan precondition)."""
    ebdyc = _make(pad_quantum=512)
    rng = np.random.default_rng(0)
    n_pts = 3000
    t = rng.uniform(0, 2 * np.pi, n_pts)
    rr = rng.uniform(0, 0.9, n_pts)
    shapes = []
    for ang in (0.0, 0.13):
        e0 = ebdyc[0]
        c, s = np.cos(ang), np.sin(ang)
        bx = c * e0.bdy.x - s * e0.bdy.y
        by = s * e0.bdy.x + c * e0.bdy.y
        e = e0.regenerate(bx, by)
        ec = EmbeddedBoundaryCollection([e])
        ec.register_grid(ebdyc.grid, pad_quantum=512)
        px = rr * np.cos(t) * 0.9
        py = rr * np.sin(t) * 0.9
        part = PointPartition(ec, px, py, pad_quantum=512)
        shapes.append((
            part.zone1_dev.shape,
            tuple(z.shape for z in part.zone2_dev),
            ec.pna_flat_dev.shape,
            tuple(a.shape for a in ec.ia_flat_list),
        ))
    assert shapes[0] == shapes[1]


def test_interpolate_many_matches_single():
    ebdyc = _make()
    fns = [lambda x, y: np.sin(x) * np.cos(y),
           lambda x, y: np.cos(2 * x) + y,
           lambda x, y: x * y]
    efs = [EmbeddedFunction.from_function(ebdyc, fn) for fn in fns]
    rng = np.random.default_rng(1)
    t = rng.uniform(0, 2 * np.pi, 500)
    rr = rng.uniform(0, 0.95, 500)
    px = rr * np.cos(t)
    py = rr * np.sin(t)
    part = PointPartition(ebdyc, px, py, pad_quantum=128)
    many = np.asarray(part.interpolate_many(efs))
    for i, ef in enumerate(efs):
        one = np.asarray(part.interpolate(ef))
        sel = ~np.isnan(one)
        assert np.abs(many[i][sel] - one[sel]).max() < 1e-14
        assert np.array_equal(np.isnan(many[i]), ~sel)


def test_padded_advection_matches_unpadded():
    from ipde_tpu.advection.semi_lagrangian import SemiLagrangianAdvector
    u_f = lambda x, y: -y
    v_f = lambda x, y: x
    c_f = lambda x, y: np.exp(-(x * x + y * y) / 0.3)
    outs = []
    for pq in (None, 512):
        ebdyc = _make(pad_quantum=pq)
        u = EmbeddedFunction.from_function(ebdyc, u_f)
        v = EmbeddedFunction.from_function(ebdyc, v_f)
        c = EmbeddedFunction.from_function(ebdyc, c_f)
        adv = SemiLagrangianAdvector(ebdyc, u, v)
        new_ebdyc = adv.generate(0.04, fixed_grid=True)
        cn = adv(c)
        outs.append((np.asarray(cn.grid), np.asarray(cn.radials[0]),
                     np.asarray(new_ebdyc.phys)))
    (g0, r0, phys), (g1, r1, _) = outs
    assert np.abs((g1 - g0)[phys]).max() < 1e-13
    assert np.abs(r1 - r0).max() < 1e-13
