"""Coupled advection-diffusion with a moving boundary (reference:
examples/semi_lagrangian_experiments/coupled_simplify*.py):
  c_t + u . grad(c) = nu lap(c),  boundary moves with u.
Scheme: FE semi-Lagrangian advection + backward-Euler diffusion:
  (I - dt nu lap) c^{n+1} = c^n(x_d)   i.e. an MH solve with k^2 = 1/(dt nu)
Test: rigid rotation (boundary rotates, shape preserved) with a diffusing
Gaussian blob; compare against the exact rotating-diffusing solution.

Runs through the DEVICE-RESIDENT stepper (advection/stepper.py): the grid
is fixed and capacity-padded, so after step 1 every step is a host
geometry rebuild plus two compiled-program launches (no recompiles).
"""
import os, sys, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from ipde_tpu.geometry.curve import star
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu.functions import EmbeddedFunction
from ipde_tpu.advection.stepper import CoupledAdvectionDiffusionStepper

nu = 0.05
u_f = lambda x, y: -y
v_f = lambda x, y: x
# exact: rotating frame leaves a centered isotropic Gaussian invariant under
# rotation; diffusion: c = 1/(4 pi nu (t+t0)) exp(-r^2/(4 nu (t+t0)))
t0_ = 0.5
def c_exact(x, y, T):
    s = 4*nu*(T + t0_)
    return np.exp(-(x*x + y*y)/s)/(np.pi*s)

nb = int(os.environ.get("ADV_NB", 200))
M = int(os.environ.get("ADV_M", 10))
steps = int(os.environ.get("ADV_STEPS", 4))
bdy = star(nb, a=0.1, f=3)
bh = min(bdy.min_h(), 0.6/np.abs(bdy.curvature).max()/M)
ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)
ebdyc = EmbeddedBoundaryCollection([ebdy])
ebdyc.generate_grid(bh, pad_quantum=2048)
c = EmbeddedFunction.from_function(ebdyc, lambda x, y: c_exact(x, y, 0.0))
dt = 0.05

def velocity(ec):
    return (EmbeddedFunction.from_function(ec, u_f),
            EmbeddedFunction.from_function(ec, v_f))

stepper = CoupledAdvectionDiffusionStepper(ebdyc, velocity, nu, dt,
                                           tol=1e-12)
T = 0.0
t_start = time.time()
step_rows = []
for n in range(steps):
    c = stepper.step(c)
    T += dt
    row = dict(stepper.last_times)
    step_rows.append(row)
    print(f"step {n+1}/{steps}: generate {row['generate_s']:.2f}s  advect "
          f"{row['advect_s']:.2f}s  setup {row['setup_s']:.2f}s  solve "
          f"{row['solve_s']:.2f}s  (total {time.time()-t_start:.0f}s)",
          flush=True)
ebdyc = stepper.ebdyc
ca = EmbeddedFunction.from_function(ebdyc, lambda x, y: c_exact(x, y, T))
err = abs(c - ca)
phys = np.asarray(ebdyc.phys)
ge = float(np.asarray(err.grid)[phys].max())
re = max(float(np.abs(np.asarray(r)).max()) for r in err.radials)
scale = float(np.asarray(ca.grid)[phys].max())
print(f"coupled adv-diff: rel err {max(ge, re)/scale:.2e} after T={T} "
      f"(replan shape misses: {stepper.recompiles})", flush=True)
print("final mass:", ebdyc.volume_integral(c), flush=True)

# per-step cost table (device-resident timestep --
# step 1 pays the compiles, later steps are replan + executable launches)
import jax
from ipde_tpu.utils.ledger import record
record("coupled_advection_diffusion",
       [{"nb": nb, "M": M, "dt": dt, "steps": steps,
         "rel_err": float(f"{max(ge, re)/scale:.3e}"),
         "backend": jax.default_backend(),
         "step_rows": step_rows}],
       ("nb", "M", "dt", "steps", "backend"))
