"""Planify: jit a solver's orchestration with plan arrays as ARGUMENTS.

The solvers keep their device operators (DFT matrices, QFS maps, NUFFT
plans, preconditioner blocks, masks, ...) as object attributes.  Tracing a
full solve with ``jax.jit`` would bake every one of those arrays into the
program as a CONSTANT — hundreds of MB of HLO at production grid sizes,
which blows compile memory/transport limits and forbids buffer donation.

``PlanStore`` walks an object graph (any ``ipde_tpu`` objects plus
list/tuple/dict/NamedTuple containers hanging off them), collects every
concrete ``jax.Array`` leaf, and can temporarily swap traced stand-ins into
the exact attribute slots they came from.  ``planified`` wraps a function of
the captured objects so that the jitted program receives all plan arrays as
one flat pytree argument:

    run = planified(lambda f: bie.apply_bc(solver(f), bc), solver, bie)
    u = run(f)          # compiled once; plans are runtime inputs

No behavioural change: the un-jitted Python path is untouched, and the
original concrete arrays are restored after tracing.

This replaces the reference's implicit "operators live in module state"
model (the reference is eager numpy/numba and has no tracing concern;
see SURVEY.md section 7 'precompute on host, apply on device').
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Sequence, Tuple

import jax
import jax.tree_util as jtu


def _is_container(x) -> bool:
    return isinstance(x, (list, tuple, dict))


def _is_ours(obj) -> bool:
    mod = type(obj).__module__
    return mod is not None and mod.split(".")[0] == "ipde_tpu"


def _not_container(x) -> bool:
    return not _is_container(x)


class PlanStore:
    """Collects and swaps the device-array leaves of an object graph."""

    def __init__(self, *roots):
        # each slot: (container, key, treedef, leaf_spec) where leaf_spec is
        # a list of either ('arr', plan_index) or ('static', value)
        self._slots: List[Tuple[Any, Any, Any, list]] = []
        self._slot_names: List[str] = []
        self._arrays: List[jax.Array] = []
        self._by_id = {}
        seen = set()
        for r in roots:
            self._walk(r, seen, type(r).__name__)

    # -- construction ------------------------------------------------------
    def _walk(self, obj, seen, name):
        if id(obj) in seen:
            return
        seen.add(id(obj))
        if isinstance(obj, dict):
            container, keys = obj, list(obj.keys())
        elif isinstance(obj, list):
            container, keys = obj, range(len(obj))
        elif _is_ours(obj) and hasattr(obj, "__dict__"):
            container, keys = obj.__dict__, list(obj.__dict__.keys())
            name = type(obj).__name__
        elif isinstance(obj, tuple):
            # immutable at this level; recurse into items for nested objects
            for item in obj:
                self._walk(item, seen, name)
            return
        else:
            return
        for k in keys:
            self._process_slot(container, k, container[k], seen, name)

    def _plan_index(self, arr) -> int:
        idx = self._by_id.get(id(arr))
        if idx is None:
            idx = len(self._arrays)
            self._arrays.append(arr)
            self._by_id[id(arr)] = idx
        return idx

    def _process_slot(self, container, key, value, seen, name):
        leaves, treedef = jtu.tree_flatten(value, is_leaf=_not_container)
        spec = []
        n_arr = 0
        for leaf in leaves:
            if isinstance(leaf, jax.Array):
                spec.append(("arr", self._plan_index(leaf)))
                n_arr += 1
            else:
                spec.append(("static", leaf))
        if n_arr:
            self._slots.append((container, key, treedef, spec))
            self._slot_names.append(f"{name}.{key}")
        # recurse into non-array leaves (ipde_tpu objects, nested dicts the
        # flatten treated as leaves never occur: dicts are containers)
        for leaf in leaves:
            if not isinstance(leaf, jax.Array):
                self._walk(leaf, seen, f"{name}.{key}")

    # -- use -----------------------------------------------------------------
    @property
    def n_arrays(self) -> int:
        return len(self._arrays)

    def slot_owner(self, plan_index: int) -> str:
        """Human-readable owner path for a plan-array index (used by
        replan's shape-mismatch diagnostics)."""
        for (c, k, _td, spec), nm in zip(self._slots, self._slot_names):
            if any(s[0] == "arr" and s[1] == plan_index for s in spec):
                return nm
        return "<unknown>"

    def name_occurrences(self):
        """{owner-path: [plan indices in walk order]} — the key for
        name-based replan matching.  An array shared by several slots
        appears under each owner's name (positional within a name)."""
        groups = {}
        for (_c, _k, _td, spec), nm in zip(self._slots, self._slot_names):
            for s in spec:
                if s[0] == "arr":
                    groups.setdefault(nm, []).append(s[1])
        return groups

    def snapshot(self) -> list:
        """The current concrete plan arrays (the jit-call operand)."""
        return list(self._arrays)

    def refresh(self):
        """Re-read the concrete arrays from the object graph (after a host
        update of some plan attribute, e.g. a regenerated geometry piece)."""
        for container, key, treedef, spec in self._slots:
            leaves = jtu.tree_leaves(container[key], is_leaf=_not_container)
            for leaf, s in zip(leaves, spec):
                if s[0] == "arr":
                    self._arrays[s[1]] = leaf

    @contextlib.contextmanager
    def installed(self, arrays: Sequence):
        """Temporarily replace every captured array slot with ``arrays``."""
        originals = []
        try:
            for container, key, treedef, spec in self._slots:
                originals.append((container, key, container[key]))
                leaves = [arrays[s[1]] if s[0] == "arr" else s[1]
                          for s in spec]
                container[key] = jtu.tree_unflatten(treedef, leaves)
            yield
        finally:
            for container, key, orig in originals:
                container[key] = orig


def planified(fn: Callable, *roots, jit: bool = True):
    """Wrap ``fn`` so every device array reachable from ``roots`` becomes a
    jit argument.  Returns a callable with the same signature as ``fn``; the
    plan pytree is threaded automatically.  ``.store`` / ``.plans`` expose
    the machinery (e.g. ``.plans = .store.snapshot()`` after host updates).
    """
    store = PlanStore(*roots)

    def with_plans(plan_arrays, *args):
        with store.installed(plan_arrays):
            return fn(*args)

    inner = jax.jit(with_plans) if jit else with_plans

    def call(*args):
        return inner(call.plans, *args)

    call.store = store
    call.plans = store.snapshot()
    call.inner = inner
    return call


def replan(call, *roots):
    """Point a planified callable at a NEW object graph with the same
    structure — e.g. this timestep's solver rebuilt on moved geometry.

    Collects the new graph's plan arrays and swaps them into ``call.plans``;
    because the jitted program receives plans as arguments, the compiled
    executable is REUSED (no retrace, no recompile) as long as every array
    keeps its shape and dtype.  This is what makes a moving-boundary
    timestep cheap: the per-step solve costs one executable launch, not a
    recompile (reference analogue: the reference is
    eager numpy and re-runs everything each step,
    ipde/advection/fe_advector.py:20-171).

    Walk order is deterministic for identically-constructed objects
    (attribute insertion order), so slot i of the new graph corresponds to
    slot i of the old one; shapes/dtypes are checked defensively.
    """
    store = PlanStore(*roots)
    new = store.snapshot()
    old = call.plans
    if len(new) != len(old):
        raise ValueError(
            f"replan: new graph has {len(new)} plan arrays, compiled "
            f"program expects {len(old)} (structure changed?)")
    bad = [f"slot {i} ({store.slot_owner(i)}): {a.shape}/{a.dtype} vs "
           f"compiled {b.shape}/{b.dtype}"
           for i, (a, b) in enumerate(zip(new, old))
           if a.shape != b.shape or a.dtype != b.dtype]
    if bad:
        raise ValueError("replan: plan shape mismatch — " + "; ".join(bad))
    call.store = store
    call.plans = new
    return call
