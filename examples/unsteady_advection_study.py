"""Unsteady-velocity semi-Lagrangian order study: FE vs BDF2 vs BDF3.

Mirrors the reference's unsteady experiment driver
(examples/semi_lagrangian_experiments/unsteady_semi_experiment.py:28-58,
233-236), which compares the FE/AB2/BDF advector family on a
time-dependent flow against truth.  Here the flow is a rotation with
time-varying rate w(t) = 1 + 0.5 sin(2t) on a CIRCLE boundary (a
streamline, so all three advectors run in stationary-boundary mode and
the exact transported field is available in closed form for every dt --
stronger than the reference's fine-dt-truth comparison).

History for the multistep schemes is initialized from the exact solution
(standard convergence-study setup).

Results are appended to LEDGER.json under "unsteady_advection".

Usage:
    python examples/unsteady_advection_study.py
    ADV_DTS="0.1 0.05 0.025" ADV_NB=150 ADV_M=12 python examples/...
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OMEGA = lambda t: 1.0 + 0.5 * np.sin(2.0 * t)
ALPHA = lambda t: t + 0.25 * (1.0 - np.cos(2.0 * t))
F0 = lambda x, y: np.exp(np.sin(x)) * np.cos(y + 0.3)


def exact(x, y, t):
    a = ALPHA(t)
    c, s = np.cos(a), np.sin(a)
    return F0(c * x + s * y, -s * x + c * y)


class _Hist:
    def __init__(self, u, v, uo, vo):
        self.u, self.v, self.uo, self.vo = u, v, uo, vo


def run_case(scheme, dt, steps, ebdyc):
    from ipde_tpu.advection.semi_lagrangian import (SecondOrderAdvector,
                                                    SemiLagrangianAdvector,
                                                    ThirdOrderAdvector)
    from ipde_tpu.functions import EmbeddedFunction

    def vel(t):
        w = OMEGA(t)
        u = EmbeddedFunction.from_function(ebdyc, lambda x, y: -w * y)
        v = EmbeddedFunction.from_function(ebdyc, lambda x, y: w * x)
        return u, v

    ex = lambda t: EmbeddedFunction.from_function(
        ebdyc, lambda x, y: exact(x, y, t))
    f = ex(0.0)
    fm1, fm2 = ex(-dt), ex(-2 * dt)
    t = 0.0
    prev_adv = None
    t0 = time.time()
    for _ in range(steps):
        u, v = vel(t)
        if scheme == "fe":
            adv = SemiLagrangianAdvector(ebdyc, u, v)
            adv.generate(dt, fixed_boundary=True)
            fn = adv(f)
        elif scheme == "bdf2":
            if prev_adv is None:
                prev_adv = SemiLagrangianAdvector(ebdyc, *vel(t - dt))
                prev_adv.generate(dt, fixed_boundary=True)
            adv = SecondOrderAdvector(ebdyc, u, v, prev_adv)
            adv.generate(dt, fixed_boundary=True)
            fn = adv.advect_bdf2(f, fm1)
        else:  # bdf3
            uo, vo = vel(t - dt)
            uoo, voo = vel(t - 2 * dt)
            adv = ThirdOrderAdvector(ebdyc, u, v, _Hist(uo, vo, uoo, voo))
            adv.generate(dt)
            fn = adv(f, fm1, fm2)
        prev_adv = adv
        fm2, fm1, f = fm1, f, fn
        t += dt
    step_s = (time.time() - t0) / steps
    fa = ex(t)
    err = abs(f - fa)
    ge = float(np.asarray(err.grid)[np.asarray(ebdyc.phys)].max())
    re = max(float(np.abs(np.asarray(r)).max()) for r in err.radials)
    return max(ge, re), step_s


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    from ipde_tpu.functions import EmbeddedFunction
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import circle
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary

    nb = int(os.environ.get("ADV_NB", 150))
    # zone-1 spectral interpolation has a ~4e-7 floor at M=8 from the
    # Slepian rolloff band-limit: use M >= 12 for order studies
    M = int(os.environ.get("ADV_M", 12))
    dts = [float(s) for s in
           os.environ.get("ADV_DTS", "0.1 0.05 0.025").split()]
    T_final = float(os.environ.get("ADV_T", 0.4))

    bdy = circle(nb, r=1.0)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)
    ebdyc = EmbeddedBoundaryCollection([ebdy])
    ebdyc.generate_grid(bh)

    schemes = ("fe", "bdf2", "bdf3")
    rows = []
    prev = {}
    print(f"{'dt':>8} " + " ".join(f"{'err_' + s:>10} {'ord':>5}"
                                   for s in schemes))
    for dt in dts:
        steps = max(int(round(T_final / dt)), 1)
        errs = {}
        for s in schemes:
            errs[s], _ = run_case(s, dt, steps, ebdyc)
        line = f"{dt:8.4f} "
        row = {"dt": dt}
        for s in schemes:
            o = (np.log2(prev[s] / errs[s]) / np.log2(prev["dt"] / dt)
                 if prev else float("nan"))
            line += f"{errs[s]:10.2e} {o:5.2f} "
            row[f"err_{s}"] = errs[s]
            row[f"order_{s}"] = None if np.isnan(o) else round(o, 2)
        print(line)
        rows.append(row)
        prev = dict(errs, dt=dt)

    ok = True
    if len(rows) >= 2:
        last = rows[-1]
        ok = (last["order_fe"] > 0.7 and last["order_bdf2"] > 1.6
              and last["order_bdf3"] > 2.5)
        print("orders OK" if ok else "ORDER CHECK FAILED")

    from ipde_tpu.utils.ledger import record
    record("unsteady_advection",
           [{"nb": nb, "M": M, "T": T_final, "rows": rows,
             "orders_ok": bool(ok)}],
           ("nb", "M", "T"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
