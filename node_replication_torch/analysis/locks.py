"""Lock factory for the port's subsystem locks: the runtime half of
nrcheck.

Subsystem locks are constructed through `make_lock` / `make_rlock` /
`make_condition` with a NAME that matches the static lock-order
graph's node naming (`<Class>.<attr>` for instance locks,
`<module_tail>.<var>` for module-level locks — see
`analysis/concurrency.py`, which machine-checks the name at each
construction site). In production the factory is a zero-cost
passthrough to the plain `threading` primitives; with
`NR_TPU_LOCKCHECK=1` (read when a lock is BUILT, so set it before the
package is imported to check module-level locks too) every
acquisition is checked against the per-thread held-lock set:

- every observed edge `held -> acquired` is recorded FIRST, then
  checked, so a raised cycle stays visible in the dumped graph;
- a *blocking* acquisition whose new ordering edge closes a cycle in
  the so-far-observed lock-order graph raises `LockOrderError` BEFORE
  blocking — the interleaving that would deadlock under an adversarial
  schedule fails fast and loud instead of hanging;
- a blocking re-acquisition of a held non-reentrant lock (guaranteed
  self-deadlock) raises the same way;
- a trylock probe (`acquire(blocking=False)`) records its edge and
  never raises (it cannot deadlock), and RLock re-entry adds no edge;
- `NR_TPU_LOCKGRAPH=<path>` dumps the union as JSON at interpreter
  exit (`{"edges": [...], "nodes": [...]}`: every lock acquired at
  least once is a node, nested or not), merging atomically with an
  existing file, so several runs accumulate one graph. `analysis.lint --check-dynamic <path>`
  asserts the dump is a subgraph of the static lock-order graph — the
  static analysis and the runtime check validate each other.

This module must stay dependency-free (stdlib only): it is imported
by core/, serve/, repl/, shard/, fault/ and obs/ at module-import
time.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading

__all__ = [
    "LockOrderError",
    "make_lock",
    "make_rlock",
    "make_condition",
    "lockcheck_enabled",
    "dump_lockgraph",
    "current_edges",
    "current_nodes",
    "current_violations",
    "fresh_state",
]


class LockOrderError(RuntimeError):
    """A lock acquisition would deadlock under some schedule: either
    the new ordering edge closes a cycle in the observed lock-order
    graph, or a non-reentrant lock is being re-acquired by its own
    holder. Raised BEFORE the acquisition blocks."""


def lockcheck_enabled() -> bool:
    """True when `NR_TPU_LOCKCHECK=1` (checked at construction time,
    so a test may flip the env var before building its fixtures)."""
    return os.environ.get("NR_TPU_LOCKCHECK", "") == "1"


class LockCheckState:
    """Observed lock-order graph + per-thread held stacks.

    One process-global instance backs the factory; tests build private
    instances (`fresh_state`) so fixture edges never pollute the
    process graph that CI compares against the static one.
    """

    def __init__(self):
        # plain, uninstrumented lock: guards the edge graph (it is a
        # leaf by construction — nothing is acquired under it)
        self._meta = threading.Lock()
        #: observed edges: held-name -> {acquired-name, ...}
        self.edges: dict[str, set[str]] = {}
        #: every lock name acquired at least once (GIL-atomic adds)
        self.nodes: set[str] = set()
        #: LockOrderErrors raised so far
        self.violations = 0
        self._tls = threading.local()

    # ------------------------------------------------------- held stack

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st  # list of [name, count] in acquisition order

    def held(self) -> list[str]:
        """Names this thread currently holds, outermost first."""
        return [name for name, _ in self._stack()]

    # ---------------------------------------------------------- checks

    def _reaches(self, src: str, dst: str) -> bool:
        """Path src ->* dst in the observed graph (caller holds _meta)."""
        seen = {src}
        frontier = [src]
        while frontier:
            nxt = []
            for n in frontier:
                for m in self.edges.get(n, ()):
                    if m == dst:
                        return True
                    if m not in seen:
                        seen.add(m)
                        nxt.append(m)
            frontier = nxt
        return False

    def before_acquire(self, name: str, blocking: bool,
                       reentrant: bool) -> None:
        stack = self._stack()
        for ent in stack:
            if ent[0] == name:
                if reentrant or not blocking:
                    # RLock re-entry, or a trylock probe that will
                    # simply return False: no new edges, no deadlock
                    return
                with self._meta:
                    self.violations += 1
                raise LockOrderError(
                    f"self-deadlock: thread "
                    f"{threading.current_thread().name!r} already "
                    f"holds non-reentrant lock {name!r}"
                )
        if not stack:
            return
        held = [ent[0] for ent in stack]
        with self._meta:
            # record FIRST, then check: a raised cycle stays visible
            # in the dumped graph for the post-mortem
            for h in held:
                if h != name:
                    self.edges.setdefault(h, set()).add(name)
            if blocking:
                for h in held:
                    if h != name and self._reaches(name, h):
                        self.violations += 1
                        raise LockOrderError(
                            f"lock-order cycle: acquiring {name!r} "
                            f"while holding {held!r} closes a cycle "
                            f"({name} ->* {h} -> {name}) in the "
                            f"observed lock-order graph — this "
                            f"interleaving can deadlock"
                        )

    def after_acquire(self, name: str) -> None:
        stack = self._stack()
        for ent in stack:
            if ent[0] == name:
                ent[1] += 1
                return
        stack.append([name, 1])
        self.nodes.add(name)

    def after_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                stack[i][1] -= 1
                if stack[i][1] <= 0:
                    del stack[i]
                return

    # ------------------------------------------------------------ dump

    def edge_list(self) -> list[list[str]]:
        with self._meta:
            return sorted(
                [a, b] for a, bs in self.edges.items() for b in bs
            )

    def node_list(self) -> list[str]:
        return sorted(set(self.nodes))


_state = LockCheckState()


@contextlib.contextmanager
def fresh_state():
    """Swap in a private `LockCheckState` (test isolation: fixture
    locks must not contribute edges to the process graph)."""
    global _state
    prev = _state
    _state = LockCheckState()
    try:
        yield _state
    finally:
        _state = prev


def current_edges() -> list[list[str]]:
    """Observed `[held, acquired]` edges so far (checked mode only)."""
    return _state.edge_list()


def current_nodes() -> list[str]:
    """Every lock name acquired so far (checked mode only)."""
    return _state.node_list()


def current_violations() -> int:
    """`LockOrderError`s raised so far (checked mode only)."""
    return _state.violations


class _CheckedLock:
    """Order-checking wrapper satisfying the `threading.Lock` protocol
    (acquire/release/locked/context manager), so `threading.Condition`
    can be built directly on top of one — `Condition.wait`'s
    release/re-acquire then flows through the held-stack bookkeeping."""

    _reentrant = False

    def __init__(self, name: str, state: LockCheckState | None = None):
        self.name = name
        self._state = state if state is not None else _state
        self._lock = self._make()

    def _make(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._state.before_acquire(self.name, blocking, self._reentrant)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._state.after_acquire(self.name)
        return ok

    def release(self):
        self._lock.release()
        self._state.after_release(self.name)

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class _CheckedRLock(_CheckedLock):
    _reentrant = True

    def _make(self):
        return threading.RLock()

    # threading.Condition uses these when present so a reentrantly
    # held lock is FULLY released around wait(); count bookkeeping
    # must follow the saved state through the round-trip
    def _release_save(self):
        stack = self._state._stack()
        count = 0
        for ent in stack:
            if ent[0] == self.name:
                count = ent[1]
                break
        saved = self._lock._release_save()
        for _ in range(max(count, 1)):
            self._state.after_release(self.name)
        return (saved, count)

    def _acquire_restore(self, state):
        saved, count = state
        self._state.before_acquire(self.name, True, True)
        self._lock._acquire_restore(saved)
        for _ in range(max(count, 1)):
            self._state.after_acquire(self.name)

    def _is_owned(self):
        return self._lock._is_owned()


def make_lock(name: str):
    """A `threading.Lock` (or its order-checking twin under
    `NR_TPU_LOCKCHECK=1`). `name` must match the static graph node:
    `<Class>.<attr>` / `<module_tail>.<var>`."""
    if lockcheck_enabled():
        return _CheckedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of `make_lock` (re-entry adds no edges)."""
    if lockcheck_enabled():
        return _CheckedRLock(name)
    return threading.RLock()


def make_condition(name: str, lock=None):
    """A `threading.Condition`. Pass `lock` to share an existing
    factory-made lock (the paired `_lock`/`_cond` idiom — the pair is
    then ONE node in the lock-order graph); otherwise the condition
    owns a private lock registered under `name`."""
    if lock is not None:
        return threading.Condition(lock)
    if lockcheck_enabled():
        return threading.Condition(_CheckedLock(name))
    return threading.Condition()


# ------------------------------------------------------------------ dump


def dump_lockgraph(path: str) -> None:
    """Write (merging with any existing dump at `path`) the observed
    graph as `{"edges": [[held, acquired], ...], "nodes": [...]}`,
    atomically (written aside, then renamed)."""
    edges = {tuple(e) for e in _state.edge_list()}
    nodes = set(_state.node_list())
    try:
        with open(path) as f:
            prev = json.load(f)
        edges |= {tuple(e) for e in prev.get("edges", [])}
        nodes |= set(prev.get("nodes", []))
    except (OSError, ValueError):
        pass
    nodes |= {n for e in edges for n in e}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"edges": sorted(list(e) for e in edges),
                   "nodes": sorted(nodes)}, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _atexit_dump() -> None:
    path = os.environ.get("NR_TPU_LOCKGRAPH", "")
    if path and lockcheck_enabled():
        dump_lockgraph(path)


atexit.register(_atexit_dump)
