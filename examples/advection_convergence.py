"""Semi-Lagrangian accuracy-order study: FE vs BDF2 under dt refinement on
a rigidly rotating flow with a MOVING boundary (the boundary is advected,
reparametrized, and the geometry regenerated every step).

Reference analogue: the examples/semi_lagrangian_experiments/* drivers
(e.g. unsteady_semi_experiment.py:28-58,233-236) which verify the
accuracy order of the FE / AB2 / BDF advector family against fine-dt
truth runs.  Here the rotation has a closed-form solution, so each run is
compared against the exact transported field directly.

Results are printed as a table and appended to LEDGER.json under
"advection_convergence" so the claimed orders are machine-checkable.

Usage:
    python examples/advection_convergence.py            # default sweep
    ADV_DTS="0.1 0.05" ADV_NB=150 python examples/advection_convergence.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_case(dt, steps, order2, nb, M):
    import jax
    from ipde_tpu.advection.semi_lagrangian import (SecondOrderAdvector,
                                                    SemiLagrangianAdvector)
    from ipde_tpu.functions import EmbeddedFunction
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary

    u_f = lambda x, y: -y
    v_f = lambda x, y: x
    f0 = lambda x, y: np.exp(np.sin(x)) * np.cos(y + 0.3)

    def exact(x, y, T):
        c, s = np.cos(T), np.sin(T)
        return f0(c * x + s * y, -s * x + c * y)

    bdy = star(nb, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)
    ebdyc = EmbeddedBoundaryCollection([ebdy])
    ebdyc.generate_grid(bh)
    f = EmbeddedFunction.from_function(ebdyc, f0)
    f_prev = adv_prev = None
    T = 0.0
    t0 = time.time()
    for _ in range(steps):
        u = EmbeddedFunction.from_function(ebdyc, u_f)
        v = EmbeddedFunction.from_function(ebdyc, v_f)
        if order2 and adv_prev is not None:
            adv = SecondOrderAdvector(ebdyc, u, v, adv_prev)
            new_ebdyc = adv.generate(dt)
            fn = adv.advect_bdf2(f, f_prev)
        else:
            adv = SemiLagrangianAdvector(ebdyc, u, v)
            new_ebdyc = adv.generate(dt)
            fn = adv(f)
        f_prev, adv_prev = f, adv
        f, ebdyc = fn, new_ebdyc
        T += dt
    step_s = (time.time() - t0) / steps
    fa = EmbeddedFunction.from_function(
        ebdyc, lambda x, y: exact(x, y, T))
    err = abs(f - fa)
    ge = float(np.asarray(err.grid)[np.asarray(ebdyc.phys)].max())
    re = max(float(np.abs(np.asarray(r)).max()) for r in err.radials)
    return max(ge, re), step_s


def main():
    import jax
    jax.config.update("jax_enable_x64", True)

    nb = int(os.environ.get("ADV_NB", 200))
    M = int(os.environ.get("ADV_M", 10))
    dts = [float(s) for s in
           os.environ.get("ADV_DTS", "0.1 0.05 0.025").split()]
    T_final = float(os.environ.get("ADV_T", 0.2))

    rows = []
    print(f"{'dt':>8} {'err_FE':>10} {'ord':>5} {'err_BDF2':>10} {'ord':>5} "
          f"{'s/step':>7}")
    prev = {}
    for dt in dts:
        steps = max(int(round(T_final / dt)), 1)
        e1, s1 = run_case(dt, steps, False, nb, M)
        e2, s2 = run_case(dt, steps, True, nb, M)
        o1 = (np.log2(prev["e1"] / e1) / np.log2(prev["dt"] / dt)
              if prev else float("nan"))
        o2 = (np.log2(prev["e2"] / e2) / np.log2(prev["dt"] / dt)
              if prev else float("nan"))
        print(f"{dt:8.4f} {e1:10.2e} {o1:5.2f} {e2:10.2e} {o2:5.2f} "
              f"{0.5 * (s1 + s2):7.1f}")
        rows.append({"dt": dt, "err_fe": e1, "err_bdf2": e2,
                     "order_fe": None if np.isnan(o1) else round(o1, 2),
                     "order_bdf2": None if np.isnan(o2) else round(o2, 2)})
        prev = {"dt": dt, "e1": e1, "e2": e2}

    ok = True
    if len(rows) >= 2:
        ok = (rows[-1]["order_fe"] > 0.7 and rows[-1]["order_bdf2"] > 1.6)
        print("orders OK" if ok else "ORDER CHECK FAILED")

    from ipde_tpu.utils.ledger import record
    record("advection_convergence",
           [{"nb": nb, "M": M, "T": T_final, "rows": rows,
             "orders_ok": bool(ok)}],
           ("nb", "M", "T"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
