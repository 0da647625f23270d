"""Host-side defensive invariants (the port of the checkify debug mode).

The reference compiles `jax.experimental.checkify` checks into its
programs at the reference's panic points (a local tail ahead of the
global tail, `nr/src/log.rs:487-489`; a replay window behind GC head;
an append overrunning unconsumed entries). PyTorch runs eagerly, so the
port evaluates the same predicates on the host, and only while armed:

- `NR_TPU_DEBUG=1` flips the default of `NodeReplicated(debug=...)`;
- `debug_checks(True)` (context manager, context-local) arms `check()`
  for calls made inside it — `NodeReplicated(debug=True)` wraps its
  append and replay calls in it.

Disarmed, `check()` is one context-variable read: the predicate is a
callable and is never evaluated, so no kernel is launched and no value
is read back. Armed, the predicate is read back (a host sync) and a
false one raises `CheckError`.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

_ctx_enabled: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "nr_torch_debug_checks", default=False
)


class CheckError(RuntimeError):
    """A debug-mode invariant failed."""


def debug_default() -> bool:
    """Default for `NodeReplicated(debug=...)` (the NR_TPU_DEBUG env)."""
    return os.environ.get("NR_TPU_DEBUG", "") == "1"


def debug_checks_enabled() -> bool:
    return _ctx_enabled.get()


@contextlib.contextmanager
def debug_checks(on: bool = True):
    """Arm `check()` for calls made within (context-local: arming here
    never affects other threads)."""
    token = _ctx_enabled.set(on)
    try:
        yield
    finally:
        _ctx_enabled.reset(token)


def check(pred, msg: str, **fmt) -> None:
    """Raise `CheckError(msg.format(**fmt))` when armed and `pred()` is
    false. `pred` and each `fmt` value are callables (or values), read
    only when armed."""
    if not _ctx_enabled.get():
        return
    ok = pred() if callable(pred) else pred
    if not bool(ok):
        vals = {k: _host(v() if callable(v) else v) for k, v in fmt.items()}
        raise CheckError(msg.format(**vals))


def _host(v):
    try:
        return v.tolist()
    except AttributeError:
        return v
