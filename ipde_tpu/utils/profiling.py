"""Phase timers and device tracing (aux subsystem; reference analogue: the
ad-hoc time.time() blocks in examples/poisson_for_paper.py:60-104).

JAX dispatch is asynchronous; Timer waits for the device
(``block_until_ready``) so phases are honestly attributed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax


def sync(x=None):
    """Wait until every array in x is computed."""
    if x is not None:
        jax.block_until_ready(x)


class Timer:
    """Accumulating phase timer.

    with timer("annular"):
        ur = solver.solve(...)
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        sync(result)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{k}: {v*1e3:.1f} ms ({self.counts[k]}x)"
                 for k, v in sorted(self.totals.items(),
                                    key=lambda kv: -kv[1])]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(path: str = "/tmp/ipde_tpu_trace"):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
