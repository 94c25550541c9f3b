"""Device-resident moving-boundary timestepping.

The eager per-step recipe (examples/coupled_advection_diffusion.py,
reference: examples/semi_lagrangian_experiments/coupled_simplify*.py)
costs 10-20 s/step: each step re-jits or eagerly dispatches every device
op because the rebuilt geometry produces new plan-array SHAPES and new
Python objects.  This module makes a timestep cost

    host geometry rebuild (numpy)  +  TWO compiled-program launches

by combining three ingredients:
  - pad_quantum capacity padding (geometry/collection.py,
    geometry/partition.py): moving-geometry plan arrays keep
    step-invariant shapes;
  - utils.planify.replan: a rebuilt solver/advector's plan arrays are
    swapped into the step-1 compiled program (no retrace, no recompile);
  - helper reuse (solvers' ``helpers=`` donor path): annular
    preconditioners survive regeneration at fixed (n, M).

Reference analogue: none -- the reference rebuilds and re-runs eager
numpy/numba each step (ipde/advection/fe_advector.py:20-171).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import numpy as np

from ipde_tpu.advection.semi_lagrangian import SemiLagrangianAdvector
from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu.utils.planify import planified, replan


class CoupledAdvectionDiffusionStepper:
    """FE semi-Lagrangian advection + backward-Euler diffusion:
        c_t + u . grad(c) = nu lap(c),   boundary moving with u,
        (I - dt nu lap) c^{n+1} = c^n(x_d)  -- an MH solve, k^2 = 1/(dt nu).

    velocity: callable (ebdyc) -> (u, v) EmbeddedFunctions for the current
    geometry (prescribed velocity; a flow solved from a PDE can be fed the
    same way).  The background grid is FIXED (generate it once, roomy
    enough for the whole trajectory) so every step reuses the same box.
    """

    def __init__(self, ebdyc, velocity: Callable, nu: float, dt: float,
                 tol: float = 1e-12, maxiter: int = 100, restart: int = 30,
                 bc: str = "neumann"):
        if getattr(ebdyc, "pad_quantum", None) is None:
            raise ValueError(
                "stepper requires a pad_quantum-registered grid "
                "(generate_grid(..., pad_quantum=...)): without capacity "
                "padding every step recompiles the solve")
        self.ebdyc = ebdyc
        self.velocity = velocity
        self.nu = nu
        self.dt = dt
        self.k = float(np.sqrt(1.0 / (dt * nu)))
        self.tol, self.maxiter, self.restart = tol, maxiter, restart
        if bc != "neumann":
            raise NotImplementedError("only no-flux (neumann) BC wired up")
        self.helpers = None
        self._jadvect = None
        self._jsolve = None
        self.last_times = {}
        self.recompiles = 0   # replan shape misses (should stay 0)
        self.miss_log = []    # messages of every shape miss

    # -- internals -----------------------------------------------------------
    def _advect_program(self, adv):
        def apply_(cg, *cr):
            out = adv(EmbeddedFunction(cg, list(cr)))
            return (out.grid, *out.radials)
        return apply_

    def _solve_program(self, solver, bie, bcn):
        k2 = self.k ** 2
        tol, maxiter, restart = self.tol, self.maxiter, self.restart

        def apply_(cg, *cr):
            f = EmbeddedFunction(cg * k2, [r * k2 for r in cr])
            ue, _ = solver.solve_with_stats(f, tol=tol, maxiter=maxiter,
                                            restart=restart)
            ue = bie.apply_bc(ue, bcn)
            return (ue.grid, *ue.radials)
        return apply_

    # -- one step --------------------------------------------------------------
    def step(self, c: EmbeddedFunction) -> EmbeddedFunction:
        """Advance c one dt on a moving geometry; self.ebdyc is updated to
        the new geometry.  Returns c^{n+1}."""
        import time
        from ipde_tpu.solvers.bie import NeumannBIE
        from ipde_tpu.solvers.scalar import ModifiedHelmholtzSolver

        ebdyc = self.ebdyc
        t0 = time.time()
        u, v = self.velocity(ebdyc)
        adv = SemiLagrangianAdvector(ebdyc, u, v)
        new_ebdyc = adv.generate(self.dt, fixed_grid=True)
        t_gen = time.time() - t0

        t0 = time.time()
        if self._jadvect is None:
            self._jadvect = planified(self._advect_program(adv), adv)
        else:
            try:
                replan(self._jadvect, adv)
            except ValueError as e:
                # a zone count crossed its capacity quantum: recompile once
                # at the new capacity
                self.recompiles += 1
                self.miss_log.append(f"advect: {e}")
                self._jadvect = planified(self._advect_program(adv), adv)
        out = self._jadvect(c.grid, *c.radials)
        c_star = EmbeddedFunction(out[0], list(out[1:]))
        t_adv = time.time() - t0

        t0 = time.time()
        solver = ModifiedHelmholtzSolver(new_ebdyc, k=self.k,
                                         helpers=self.helpers)
        self.helpers = solver.helpers
        bie = NeumannBIE(solver)
        t_setup = time.time() - t0

        t0 = time.time()
        if self._jsolve is None:
            self._bcn = BoundaryFunction(
                [np.zeros(e.bdy.N) for e in new_ebdyc])
            self._jsolve = planified(
                self._solve_program(solver, bie, self._bcn), solver, bie)
        else:
            try:
                replan(self._jsolve, solver, bie)
            except ValueError as e:
                self.recompiles += 1
                self.miss_log.append(f"solve: {e}")
                self._jsolve = planified(
                    self._solve_program(solver, bie, self._bcn), solver, bie)
        out = self._jsolve(c_star.grid, *c_star.radials)
        c_new = EmbeddedFunction(out[0], list(out[1:]))
        jax.block_until_ready(out)
        t_solve = time.time() - t0

        self.ebdyc = new_ebdyc
        self.last_times = {"generate_s": round(t_gen, 3),
                           "advect_s": round(t_adv, 3),
                           "setup_s": round(t_setup, 3),
                           "solve_s": round(t_solve, 3)}
        return c_new
