"""nrlint rule registry + every shipped rule.

Each rule is a function `(mod: ModuleInfo, project: Project) ->
Iterable[Diagnostic]` registered with `@rule(id, severity, summary)`.
Rule ids are kebab-case and stable: they are the suppression currency
(`# nrlint: disable=<id>`), so renaming one invalidates suppressions.
The ids are the reference package's, so a suppression, `--list-rules`
and the docs read the same in both packages; the nine rules that the
reference seeds from JAX tracing read their torch counterpart here, on
the device path (`astutil.py`).

The rules encode PROJECT invariants, not general Python style — each
docstring says which convention it machine-checks and where that
convention is documented.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Iterable, Iterator

from node_replication_torch.analysis.astutil import (
    Diagnostic,
    ModuleInfo,
    PROJECT_PACKAGE,
    Project,
)

ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITY_ORDER = {INFO: 0, WARNING: 1, ERROR: 2}


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    summary: str
    check: Callable[[ModuleInfo, Project], Iterable[Diagnostic]]


RULES: dict[str, Rule] = {}


def rule(rule_id: str, severity: str, summary: str):
    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULES[rule_id] = Rule(rule_id, severity, summary, fn)
        return fn

    return deco


def _diag(mod: ModuleInfo, node: ast.AST, rule_id: str,
          message: str) -> Diagnostic:
    return Diagnostic(
        path=mod.path,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0) + 1,
        rule_id=rule_id,
        severity=RULES[rule_id].severity,
        message=message,
    )


def _receiver_tail(expr: ast.AST) -> str | None:
    """Last component of a receiver expression: `self._m_batch` ->
    `_m_batch`, `tracer` -> `tracer`. A ternary receiver reports
    whichever arm matches ((_m_a if c else _m_b).inc())."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.IfExp):
        return _receiver_tail(expr.body) or _receiver_tail(expr.orelse)
    return None


def _base_name(expr: ast.AST) -> str | None:
    """Innermost Name of an attribute/subscript chain."""
    cur = expr
    while isinstance(cur, (ast.Attribute, ast.Subscript)):
        cur = cur.value
    return cur.id if isinstance(cur, ast.Name) else None


#: tensor methods that return a VIEW of their receiver's storage
_VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "transpose", "permute", "narrow",
    "select", "squeeze", "unsqueeze", "flatten", "unflatten", "expand",
    "expand_as", "as_strided", "diagonal", "t", "detach", "unbind",
    "split", "chunk", "movedim", "swapaxes", "unfold",
})


def _storage_root(expr: ast.AST) -> str | None:
    """Innermost Name of an attribute/subscript chain, walking through
    view methods too (`x.view(-1)[0]` -> `x`): the tensor whose
    storage the expression aliases. A method that makes a new tensor
    (`x.clone()`) ends the chain (None)."""
    cur = expr
    while True:
        if isinstance(cur, (ast.Attribute, ast.Subscript)):
            cur = cur.value
        elif (isinstance(cur, ast.Call)
              and isinstance(cur.func, ast.Attribute)
              and cur.func.attr in _VIEW_METHODS):
            cur = cur.func.value
        else:
            break
    return cur.id if isinstance(cur, ast.Name) else None


# --------------------------------------------------------------------------
# tensor-valued expressions (the torch readings of the device-path rules)
# --------------------------------------------------------------------------

#: `torch.*` functions that return no tensor
_TORCH_NON_TENSOR = frozenset({
    "device", "Size", "is_tensor", "numel", "is_floating_point",
    "get_default_dtype", "manual_seed", "set_grad_enabled", "no_grad",
    "inference_mode", "iinfo", "finfo", "dtype", "Generator",
})
#: tensor attributes / methods whose value lives on the host already
_HOST_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "layout",
    "requires_grad",
})
_HOST_METHODS = frozenset({
    "size", "numel", "dim", "element_size", "stride", "data_ptr",
    "storage_offset", "is_contiguous", "get_device", "nelement",
    "item", "tolist",
})
#: parameter annotations that name a tensor
_TENSOR_ANNOTATIONS = frozenset({"Tensor", "torch.Tensor"})


def _params(fn: ast.AST) -> dict[str, ast.AST | None]:
    """Parameter name -> annotation for a def or lambda."""
    args = fn.args
    out: dict[str, ast.AST | None] = {}
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)):
        out[a.arg] = a.annotation
    for a in (args.vararg, args.kwarg):
        if a is not None:
            out[a.arg] = a.annotation
    return out


def _tensorish(mod: ModuleInfo, expr: ast.AST,
               _depth: int = 0) -> bool:
    """`expr` evaluates to a torch tensor, as far as the syntax shows:
    a `torch.*` call, a method or arithmetic on a tensor, a subscript
    of one, a parameter of the enclosing device-path function that is
    not annotated with a non-tensor type (`n: int`, `spec: LogSpec`),
    or a local bound to one of those. Host-valued reads (`.shape`,
    `.size()`, `len(...)`, constants) never count, and an unresolved
    name does not either: the rules built on this stay silent rather
    than guess."""
    if _depth > 8:
        return False
    rec = lambda e: _tensorish(mod, e, _depth + 1)  # noqa: E731
    if isinstance(expr, ast.Constant):
        return False
    if isinstance(expr, ast.Name):
        if _not_a_tensor_here(mod, expr):
            return False
        for fn in mod.enclosing_functions(expr):
            params = _params(fn)
            if expr.id in params:
                ann = params[expr.id]
                if ann is None:
                    return expr.id not in ("self", "cls")
                return ast.unparse(ann) in _TENSOR_ANNOTATIONS
            body = fn.body if isinstance(fn.body, list) else [fn.body]
            for stmt in body:
                for n in ast.walk(stmt):
                    if (isinstance(n, ast.Assign)
                            and len(n.targets) == 1
                            and isinstance(n.targets[0], ast.Name)
                            and n.targets[0].id == expr.id
                            and n.value is not expr):
                        return rec(n.value)
        return False
    if isinstance(expr, ast.Attribute):
        if expr.attr in _HOST_ATTRS:
            return False
        base = expr.value
        return (isinstance(base, ast.Name) and base.id not in (
            "self", "cls") and base.id not in mod.imports
            and rec(base))
    if isinstance(expr, ast.Subscript):
        return rec(expr.value)
    if isinstance(expr, ast.Call):
        d = mod.dotted(expr.func)
        if d is not None:
            parts = d.split(".")
            return (parts[0] == "torch" and parts[1:2] != ["cuda"]
                    and parts[-1] not in _TORCH_NON_TENSOR)
        f = expr.func
        if isinstance(f, ast.Attribute):
            if f.attr in _HOST_METHODS:
                return False
            return rec(f.value)
        return False
    if isinstance(expr, ast.BinOp):
        return rec(expr.left) or rec(expr.right)
    if isinstance(expr, ast.UnaryOp):
        return rec(expr.operand)
    if isinstance(expr, ast.Compare):
        return rec(expr.left) or any(rec(c) for c in expr.comparators)
    if isinstance(expr, ast.BoolOp):
        return any(rec(v) for v in expr.values)
    if isinstance(expr, ast.IfExp):
        return rec(expr.body) or rec(expr.orelse)
    return False


def _isinstance_tensor_test(test: ast.AST, name: str) -> bool | None:
    """`isinstance(name, <...Tensor>)` -> True, its `not` -> False,
    anything else -> None."""
    neg = False
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        neg, test = True, test.operand
    if (isinstance(test, ast.Call) and isinstance(test.func, ast.Name)
            and test.func.id == "isinstance" and len(test.args) == 2
            and isinstance(test.args[0], ast.Name)
            and test.args[0].id == name
            and "Tensor" in ast.unparse(test.args[1])):
        return not neg
    return None


def _not_a_tensor_here(mod: ModuleInfo, node: ast.Name) -> bool:
    """`node` sits on the branch of an `isinstance(<name>, torch.Tensor)`
    test where the name is NOT a tensor."""
    child, cur = node, mod.parent(node)
    while cur is not None:
        if isinstance(cur, ast.If):
            pos = _isinstance_tensor_test(cur.test, node.id)
            if pos is not None:
                in_body = child in cur.body
                in_else = child in cur.orelse
                if (pos and in_else) or (not pos and in_body):
                    return True
        child, cur = cur, mod.parent(cur)
    return False


# --------------------------------------------------------------------------
# host-sync-in-jit
# --------------------------------------------------------------------------

_HOST_SYNC_DOTTED = {
    "torch.cuda.synchronize": "torch.cuda.synchronize() waits for every "
                              "queued kernel",
}
_HOST_SYNC_ON_TENSOR = {
    "numpy.asarray": "np.asarray copies the tensor to the host",
    "numpy.array": "np.array copies the tensor to the host",
}
_HOST_SYNC_METHODS = {
    "item": ".item() is a device->host scalar readback",
    "tolist": ".tolist() copies the tensor to the host",
    "cpu": ".cpu() copies the tensor to the host",
    "numpy": ".numpy() needs the tensor on the host",
}


@rule(
    "host-sync-in-jit", ERROR,
    "device->host sync on the device path (Dispatch fns, step/round "
    "closures, kernel wrappers)",
)
def host_sync_in_jit(mod: ModuleInfo,
                     project: Project) -> Iterator[Diagnostic]:
    """The hot-path contract (`utils/fence.py`): the device path only
    ENQUEUES work; the host waits for the card at the round's one
    readback (`core/replica.py:_readback`) and at a timed region's
    barrier (`fence`), never inside a transition, a step or round
    closure, or a kernel wrapper. `.item()`, `.tolist()`, `.cpu()`,
    `.numpy()`, `torch.cuda.synchronize()` and `np.asarray` /
    `np.array` of a tensor each stall the host until every queued
    kernel has finished — the launch pipeline drains once per call
    and the card idles while the host catches up. Hoist the read to
    the host loop, or keep the value a tensor."""
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        if project.device_context(mod, node) is None:
            continue
        d = mod.dotted(node.func)
        if d in _HOST_SYNC_DOTTED:
            yield _diag(
                mod, node, "host-sync-in-jit",
                f"{d}() on the device path: {_HOST_SYNC_DOTTED[d]}; "
                f"wait at the round's readback or a fence instead",
            )
        elif d in _HOST_SYNC_ON_TENSOR:
            if node.args and _tensorish(mod, node.args[0]):
                yield _diag(
                    mod, node, "host-sync-in-jit",
                    f"{d}() of a tensor on the device path: "
                    f"{_HOST_SYNC_ON_TENSOR[d]}; keep it a tensor (or "
                    f"hoist to the host loop)",
                )
        elif (
            d is None
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_SYNC_METHODS
            and not node.args
        ):
            yield _diag(
                mod, node, "host-sync-in-jit",
                f".{node.func.attr}() on the device path: "
                f"{_HOST_SYNC_METHODS[node.func.attr]}; hoist to the "
                f"host loop or keep the value a tensor",
            )


# --------------------------------------------------------------------------
# scalar-cast-in-jit
# --------------------------------------------------------------------------


@rule(
    "scalar-cast-in-jit", ERROR,
    "int()/float()/bool() on a tensor on the device path",
)
def scalar_cast_in_jit(mod: ModuleInfo,
                       project: Project) -> Iterator[Diagnostic]:
    """`int(t)` / `float(t)` / `bool(t)` on a tensor is a hidden
    `.item()`: the host blocks until the card has computed `t`, and
    with it every kernel queued before. On the device path (a
    transition, a step or round closure, a kernel wrapper) keep the
    value a tensor (`t.to(torch.int32)`, `torch.where`) or hoist the
    read to the host loop. Casts of host values — constants, shapes,
    `len()`, parameters annotated `int` — are fine."""
    for node in mod.walk():
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in ("int", "float", "bool")
            and node.args
        ):
            continue
        if project.device_context(mod, node) is None:
            continue
        if not _tensorish(mod, node.args[0]):
            continue
        yield _diag(
            mod, node, "scalar-cast-in-jit",
            f"{node.func.id}() of a tensor on the device path is a "
            f"hidden .item() (the host waits for the card); keep it a "
            f"tensor or hoist to the host loop",
        )


# --------------------------------------------------------------------------
# raw-checkify-check
# --------------------------------------------------------------------------

_RAW_CHECK_DOTTED = frozenset({
    "torch._assert", "torch._assert_async",
    "torch.testing.assert_close",
})


@rule(
    "raw-checkify-check", ERROR,
    "raw device check used directly instead of utils.checks.check",
)
def raw_checkify_check(mod: ModuleInfo,
                       project: Project) -> Iterator[Diagnostic]:
    """The project's invariant checks go through `utils/checks.py:
    check`, which is armed only inside `debug_checks(True)` and reads
    its predicate (a host sync) only then, so a release run pays
    nothing for them. A raw `torch._assert` / `torch._assert_async`,
    a `torch.testing.assert_close`, or a `CheckError` raised by hand
    outside `utils/checks.py` bypasses that zero-cost-off contract:
    it always syncs, and it cannot be disarmed."""
    if mod.path.replace("\\", "/").endswith("utils/checks.py"):
        return
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        d = mod.dotted(node.func)
        name = d or (node.func.id if isinstance(node.func, ast.Name)
                     else None)
        if d in _RAW_CHECK_DOTTED or (
            name is not None and name.rsplit(".", 1)[-1] == "CheckError"
        ):
            yield _diag(
                mod, node, "raw-checkify-check",
                f"raw {name.rsplit('.', 1)[-1]}() bypasses the "
                f"debug_checks() arming contract; use "
                f"node_replication_torch.utils.checks.check (zero cost "
                f"when disarmed)",
            )


# --------------------------------------------------------------------------
# obs-in-traced
# --------------------------------------------------------------------------

_OBS_FACTORIES = ("get_tracer", "get_registry", "span")
_OBS_METHODS = ("emit", "inc", "observe")
_OBS_RECEIVER_RE = re.compile(r"(^_?m_|_m_|tracer|metric|recorder)",
                              re.IGNORECASE)


@rule(
    "obs-in-traced", ERROR,
    "tracer/metrics call reachable from the device path",
)
def obs_in_traced(mod: ModuleInfo,
                  project: Project) -> Iterator[Diagnostic]:
    """Tracer and metrics calls (`obs.*`) are host-side bookkeeping
    with locks and IO of their own: on the device path (transitions,
    step and round closures, kernel wrappers) they run once per
    replica or per chunk instead of once per round, take a lock in
    the middle of the launch sequence, and count the wrong unit.
    Instrument the host loops (`_exec_round`, `combine`). Deliberate
    per-call counters carry justified suppressions."""
    if f"{PROJECT_PACKAGE}.obs" in mod.module_name:
        return  # the obs layer itself is host-side by construction
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        if project.device_context(mod, node) is None:
            continue
        d = mod.dotted(node.func)
        if d and d.startswith(PROJECT_PACKAGE) and (
            d.rsplit(".", 1)[-1] in _OBS_FACTORIES
        ):
            yield _diag(
                mod, node, "obs-in-traced",
                f"{d.rsplit('.', 1)[-1]}() on the device path runs per "
                f"transition call, not per round; move it to the host "
                f"loop",
            )
            continue
        if not (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _OBS_METHODS
        ):
            continue
        recv = node.func.value
        tail = _receiver_tail(recv)
        if isinstance(recv, ast.Call):
            rd = mod.dotted(recv.func)
            if rd and rd.rsplit(".", 1)[-1] in _OBS_FACTORIES:
                tail = "tracer"
        if tail and _OBS_RECEIVER_RE.search(tail):
            yield _diag(
                mod, node, "obs-in-traced",
                f"{tail}.{node.func.attr}() on the device path counts "
                f"per transition call, not per round; hoist to the "
                f"host loop (or suppress with the per-call rationale)",
            )


# --------------------------------------------------------------------------
# mutable-capture-in-dispatch
# --------------------------------------------------------------------------

_MUTATORS = frozenset({
    "append", "extend", "insert", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "add", "clear", "sort", "reverse",
})


def _inplace_method(attr: str) -> bool:
    """torch's in-place method naming: a trailing `_` (`index_put_`,
    `scatter_`, `copy_`, `add_`), dunders excluded."""
    return attr.endswith("_") and not attr.startswith("__") \
        and attr.strip("_") != ""


def _view_aliases(body: list) -> dict[str, ast.AST]:
    """Local name -> the expression it was bound to, for plain and
    tuple-unpacking assignments (`values, present = states["values"],
    states["present"]`): a local bound to a view of an argument is
    that argument's storage."""
    out: dict[str, ast.AST] = {}
    for stmt in body:
        for n in ast.walk(stmt):
            if not (isinstance(n, ast.Assign) and len(n.targets) == 1):
                continue
            t, v = n.targets[0], n.value
            if isinstance(t, ast.Name):
                out.setdefault(t.id, v)
            elif (isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple)
                  and len(t.elts) == len(v.elts)):
                for te, ve in zip(t.elts, v.elts):
                    if isinstance(te, ast.Name):
                        out.setdefault(te.id, ve)
    return out


@rule(
    "mutable-capture-in-dispatch", ERROR,
    "in-place mutation of an argument or captured object in a Dispatch "
    "transition",
)
def mutable_capture_in_dispatch(
    mod: ModuleInfo, project: Project
) -> Iterator[Diagnostic]:
    """`Dispatch` transitions have a fixed side-effect contract
    (`ops/encoding.py`): a write op applies to its `states` argument
    IN PLACE on its lanes, and NOTHING else — read ops and the window
    functions (`window_plan` / `window_merge` / `window_apply`) are
    pure. Every replica replays the same log through them, and the
    combined paths plan once and merge into every replica, so an
    in-place write anywhere else — to a read op's or window
    function's state, to the `args` / `lanes` / plan arguments, or to
    a captured tensor — leaks one replica's replay into another's, or
    into the plan the next round reads: replicas silently diverge from
    the replayed log. In-place writes are trailing-`_` methods
    (`index_put_`, `scatter_`, `copy_`), `out=` arguments and
    subscript stores, also through a local bound to a view of the
    argument (`values = states["values"]; values[k] = v`); Python
    containers (`.append`, a closure dict) count too. Build new
    tensors. A module function (`torch.sort(...)`) mutates nothing and
    never fires."""
    for fn in mod.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
            continue
        if not project.is_dispatch_fn(fn):
            continue
        name = getattr(fn, "name", "<lambda>")
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ordered = [a.arg for a in (list(fn.args.posonlyargs)
                                       + list(fn.args.args))]
            params = set(ordered) | {a.arg for a in fn.args.kwonlyargs}
            for default in (
                list(fn.args.defaults) + list(fn.args.kw_defaults)
            ):
                if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                    yield _diag(
                        mod, default, "mutable-capture-in-dispatch",
                        f"{name}: mutable default argument is shared "
                        f"across every call of a pure transition",
                    )
        else:
            ordered = [a.arg for a in fn.args.args]
            params = set(ordered)
        # the one object a write op may mutate: its `states` argument
        writable = (
            {ordered[0]} if ordered and project.is_dispatch_write_fn(fn)
            else set()
        )
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        aliases = _view_aliases(body)
        # Names REBOUND in the body (plain Name-store targets: fresh
        # locals, loop vars, and `state = dict(state)`-style parameter
        # rebinds to a fresh copy — the pure idiom must not be
        # flagged) are local unless bound to a view of a non-local.
        assigned: set[str] = set()
        for stmt in body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Name) and isinstance(
                    n.ctx, ast.Store
                ):
                    assigned.add(n.id)

        def target_of(expr):
            base = _storage_root(expr)
            seen: set[str] = set()
            while base in assigned and base not in seen:
                seen.add(base)
                src = aliases.get(base)
                base = None if src is None else _storage_root(src)
            if base is None or base in assigned or base in mod.imports:
                return None  # local, or a module (`torch.sort`)
            if base in writable:
                return None  # a write op's own `states`
            return ("its argument '" + base + "'" if base in params
                    else f"captured/global '{base}'")

        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    yield _diag(
                        mod, node, "mutable-capture-in-dispatch",
                        f"{name}: {'global' if isinstance(node, ast.Global) else 'nonlocal'}"
                        f" rebinds state outside the transition",
                    )
                elif isinstance(node, (ast.Subscript, ast.Attribute)) \
                        and isinstance(node.ctx, ast.Store):
                    what = target_of(node.value)
                    if what is None:
                        continue
                    yield _diag(
                        mod, node, "mutable-capture-in-dispatch",
                        f"{name}: mutates {what} in place; only a write "
                        f"op's own states may change (a replica's "
                        f"replay leaks into every other => replica "
                        f"divergence)",
                    )
                elif isinstance(node, ast.Call):
                    for kw in node.keywords:
                        target = (target_of(kw.value) if kw.arg == "out"
                                  else None)
                        if target is not None:
                            yield _diag(
                                mod, node, "mutable-capture-in-dispatch",
                                f"{name}: out= writes into {target}; "
                                f"transitions must return new tensors",
                            )
                    if not (
                        isinstance(node.func, ast.Attribute)
                        and (node.func.attr in _MUTATORS
                             or _inplace_method(node.func.attr))
                    ):
                        continue
                    target = target_of(node.func.value)
                    if target is None:
                        continue
                    yield _diag(
                        mod, node, "mutable-capture-in-dispatch",
                        f"{name}: .{node.func.attr}() mutates "
                        f"{target}; transitions must not mutate "
                        f"non-local objects",
                    )


# --------------------------------------------------------------------------
# wall-clock-time
# --------------------------------------------------------------------------


@rule(
    "wall-clock-time", WARNING,
    "time.time() where a monotonic clock is required",
)
def wall_clock_time(mod: ModuleInfo,
                    project: Project) -> Iterator[Diagnostic]:
    """Recorder/watchdog paths order and difference timestamps; wall
    clocks step (NTP, suspend) and make durations negative and stall
    detection lie. Use `time.monotonic()` for ordering and
    `time.perf_counter()` for durations (`obs/recorder.py` module
    docstring). The one legitimate wall-clock use — a correlation
    field next to a monotonic stamp — carries a justified
    suppression."""
    for node in mod.walk():
        if isinstance(node, ast.Call) and (
            mod.dotted(node.func) == "time.time"
        ):
            yield _diag(
                mod, node, "wall-clock-time",
                "time.time() steps with the wall clock; use "
                "time.monotonic()/time.perf_counter() for ordering "
                "and durations (wall-clock correlation fields need a "
                "justified suppression)",
            )


# --------------------------------------------------------------------------
# ring-index-unmasked
# --------------------------------------------------------------------------

_CURSOR_TOKENS = ("tail", "head", "ltail", "ctail", "pos", "start")
_RING_BASES = ("log", "ml")
_RING_ATTRS = ("opcodes", "args")


def _mentions_cursor(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        ident = None
        if isinstance(n, ast.Name):
            ident = n.id
        elif isinstance(n, ast.Attribute):
            ident = n.attr
        if ident and any(tok in ident for tok in _CURSOR_TOKENS):
            return True
    return False


def _is_masked(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.BinOp) and isinstance(
            n.op, (ast.BitAnd, ast.Mod)
        ):
            return True
    return False


def _local_aliases(mod: ModuleInfo, node: ast.AST) -> dict[str, ast.AST]:
    """name -> value expr for simple single-target assignments in the
    innermost enclosing function (one-level dataflow for index vars)."""
    for fn in mod.enclosing_functions(node):
        out: dict[str, ast.AST] = {}
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for n in ast.walk(stmt):
                if (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                ):
                    out[n.targets[0].id] = n.value
        return out
    return {}


@rule(
    "ring-index-unmasked", WARNING,
    "ring-buffer subscript from cursor math without & mask / % capacity",
)
def ring_index_unmasked(mod: ModuleInfo,
                        project: Project) -> Iterator[Diagnostic]:
    """Logical log positions are monotone int64 cursors; the physical
    slot is ALWAYS `pos & (L-1)` (`core/log.py` module docstring,
    `nr/src/log.rs:194-196`). Indexing `log.opcodes`/`log.args` (or a
    `*_ring` array) with unmasked cursor math reads the wrong slot as
    soon as the ring wraps — a bug no test with a small op count can
    see. `jnp.where`/`lax.cond` selection on cursor validity does not
    substitute for masking the slot index itself."""
    for node in mod.walk():
        if not isinstance(node, ast.Subscript):
            continue
        target = node.value
        if isinstance(target, ast.Attribute) and target.attr == "at":
            target = target.value  # x.at[idx] scatter/gather form
        is_ring = False
        if isinstance(target, ast.Attribute) and (
            target.attr in _RING_ATTRS
        ):
            base = _base_name(target.value)
            if base in _RING_BASES or (
                base is not None and base.endswith("_ring")
            ):
                is_ring = True
        elif isinstance(target, ast.Name) and (
            target.id.endswith("_ring")
        ):
            is_ring = True
        if not is_ring:
            continue
        idx = node.slice
        aliases = _local_aliases(mod, node)
        exprs: list[ast.AST] = [idx]
        for n in ast.walk(idx):
            if isinstance(n, ast.Name) and n.id in aliases:
                exprs.append(aliases[n.id])
        if any(_mentions_cursor(e) for e in exprs) and not any(
            _is_masked(e) for e in exprs
        ):
            yield _diag(
                mod, node, "ring-index-unmasked",
                "ring subscript derived from cursor math without "
                "`& mask` / `% capacity`: wrong slot after the ring "
                "wraps (mask the physical index, cf. core/log.py)",
            )


# --------------------------------------------------------------------------
# lock-discipline
# --------------------------------------------------------------------------


def _is_locked_method(method: ast.AST) -> bool:
    """Decorated with `@_locked` (or any `*locked*` wrapper): the whole
    method body is one `with self._lock` region (`core/replica._locked`)."""
    for dec in getattr(method, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = None
        if isinstance(target, ast.Name):
            name = target.id
        elif isinstance(target, ast.Attribute):
            name = target.attr
        if name and "locked" in name:
            return True
    return False


def _lock_withs(method: ast.AST, lock_attrs: set[str]) -> list[ast.With]:
    out = []
    for node in ast.walk(method):
        if isinstance(node, ast.With):
            for item in node.items:
                ce = item.context_expr
                if (
                    isinstance(ce, ast.Attribute)
                    and ce.attr in lock_attrs
                    and isinstance(ce.value, ast.Name)
                    and ce.value.id == "self"
                ):
                    out.append(node)
    return out


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _is_effective_store(mod: ModuleInfo, node: ast.Attribute) -> bool:
    if isinstance(node.ctx, ast.Store):
        return True
    parent = mod.parent(node)
    # self.x[i] = v  /  self.x[i] += v: the Subscript is the store
    # target, the Attribute itself is a Load
    return (
        isinstance(parent, ast.Subscript)
        and parent.value is node
        and isinstance(parent.ctx, ast.Store)
    )


@rule(
    "lock-discipline", ERROR,
    "guarded shared attribute accessed outside the instance lock",
)
def lock_discipline(mod: ModuleInfo,
                    project: Project) -> Iterator[Diagnostic]:
    """Lockset inference over `with self._lock` regions: any `self.X`
    WRITTEN under a class's lock somewhere is a guarded attribute; a
    write to it outside the lock (in any method but `__init__`), or a
    read outside the lock in a method that also takes the lock
    (check-then-act race), is a combiner-discipline violation. This is
    the threaded combiner/reader contract of `core/replica.py` and
    `core/cnr.py` (one combiner at a time — the flat-combining lock),
    and the same pass covers `obs/`. Intentional lock-free fast paths
    (e.g. a racy-but-benign enabled check) carry justified
    suppressions."""
    for cls in mod.walk():
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        lock_attrs: set[str] = set()
        for m in methods:
            for node in mod.walk(m):
                attr = _self_attr(node)
                if (
                    attr
                    and attr.endswith("_lock")
                    and isinstance(node.ctx, ast.Store)
                ):
                    lock_attrs.add(attr)
        if not lock_attrs:
            continue
        guarded: set[str] = set()
        for m in methods:
            regions = (
                [m] if _is_locked_method(m)
                else _lock_withs(m, lock_attrs)
            )
            for region in regions:
                for node in mod.walk(region):
                    attr = _self_attr(node)
                    if attr and attr not in lock_attrs and (
                        _is_effective_store(mod, node)
                    ):
                        guarded.add(attr)
        if not guarded:
            continue
        for m in methods:
            if m.name == "__init__" or _is_locked_method(m):
                continue
            regions = _lock_withs(m, lock_attrs)
            region_ids = {id(r) for r in regions}
            for node in mod.walk(m):
                attr = _self_attr(node)
                if attr not in guarded:
                    continue
                inside = False
                cur = mod.parent(node)
                while cur is not None and cur is not m:
                    if id(cur) in region_ids:
                        inside = True
                        break
                    cur = mod.parent(cur)
                if inside:
                    continue
                if _is_effective_store(mod, node):
                    yield _diag(
                        mod, node, "lock-discipline",
                        f"{cls.name}.{m.name}: self.{attr} is written "
                        f"under the lock elsewhere but written here "
                        f"without it",
                    )
                elif regions:
                    yield _diag(
                        mod, node, "lock-discipline",
                        f"{cls.name}.{m.name}: self.{attr} read "
                        f"outside the lock in a method that takes it "
                        f"(check-then-act race)",
                    )


# --------------------------------------------------------------------------
# blocking-in-handler
# --------------------------------------------------------------------------

_HANDLER_KWARGS = ("callback", "on_done", "on_response")
_HANDLER_REGISTRARS = ("add_done_callback",)
# kwarg-based registration counts only on serve-shaped calls
# (frontend.submit/call): an unscoped `callback=` match would drag
# third-party callback APIs (scipy's `minimize(..., callback=)`,
# timers, ...) under an ERROR-severity serve rule
_HANDLER_KWARG_METHODS = ("submit", "call")
_BLOCKING_DOTTED = {
    "time.sleep": "time.sleep() stalls the batch worker",
    "torch.cuda.synchronize": "host sync stalls the batch worker",
    "numpy.asarray": "host materialization stalls the batch worker",
    "numpy.array": "host materialization stalls the batch worker",
}
_BLOCKING_METHODS = {
    "synchronize": "host sync stalls the batch worker",
    "item": "device->host scalar readback stalls the batch worker",
    "cpu": "device->host copy stalls the batch worker",
    "result": "waiting on a future from the worker thread that must "
              "resolve it is a deadlock",
    "wait": "a blocking wait stalls the batch worker",
    "sleep": "sleeping stalls the batch worker",
}


def _handler_functions(mod: ModuleInfo) -> dict[str, ast.AST]:
    """name/id -> function node for every serve handler in the module:
    arguments to `<x>.add_done_callback(...)` and values of
    `callback=`/`on_done=`/`on_response=` kwargs, resolved to same-
    module defs (or inline lambdas) — `self._on_done`-style bound
    methods resolve by their method name — CLOSED transitively over
    same-module calls (plain `helper()` and `self._helper()` alike):
    a handler that delegates its sleep to a helper is still a firing
    handler."""
    defs: dict[str, ast.AST] = {}
    for node in mod.walk():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
        elif isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Lambda
        ):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    defs[tgt.id] = node.value
    roots: list[ast.AST] = []
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _HANDLER_REGISTRARS
            and node.args
        ):
            roots.append(node.args[0])
        fname = None
        if isinstance(node.func, ast.Attribute):
            fname = node.func.attr
        elif isinstance(node.func, ast.Name):
            fname = node.func.id
        if fname in _HANDLER_KWARG_METHODS:
            for kw in node.keywords:
                if kw.arg in _HANDLER_KWARGS:
                    roots.append(kw.value)
    handlers: dict[str, ast.AST] = {}
    queue: list[tuple[str, ast.AST]] = []
    for i, r in enumerate(roots):
        if isinstance(r, ast.Lambda):
            queue.append((f"<lambda#{i}>", r))
        elif isinstance(r, ast.Name) and r.id in defs:
            queue.append((r.id, defs[r.id]))
        elif isinstance(r, ast.Attribute) and r.attr in defs:
            # bound method: frontend.submit(cb=self._on_done) — match
            # by method name (the linter's usual name-based precision)
            queue.append((r.attr, defs[r.attr]))
    while queue:
        name, fn = queue.pop()
        if name in handlers:
            continue
        handlers[name] = fn
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for n in ast.walk(stmt):
                if not isinstance(n, ast.Call):
                    continue
                callee = None
                if isinstance(n.func, ast.Name):
                    callee = n.func.id
                elif (
                    isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in ("self", "cls")
                ):
                    callee = n.func.attr
                if callee is not None and callee in defs:
                    queue.append((callee, defs[callee]))
    return handlers


def _first_own_param(fn: ast.AST) -> str | None:
    """The handler's own-future parameter (first arg, `self`/`cls`
    skipped): `.result()` on IT is non-blocking by construction —
    callbacks run only after resolution — and is exempt."""
    args = fn.args
    params = [a.arg for a in
              (list(getattr(args, "posonlyargs", [])) + list(args.args))]
    if params and params[0] in ("self", "cls"):
        params = params[1:]
    return params[0] if params else None


@rule(
    "blocking-in-handler", ERROR,
    "blocking call (sleep/host-sync/future-wait) in a serve handler",
)
def blocking_in_handler(mod: ModuleInfo,
                        project: Project) -> Iterator[Diagnostic]:
    """Serve done-callbacks run ON the batch worker thread that
    resolves the future (`serve/future.py`): a handler that sleeps,
    host-syncs, or waits on ANOTHER future stalls — or deadlocks —
    the combiner loop for EVERY queued request on that replica.
    Handlers must only hand work off (append to a queue, set an
    event, update a counter). Covers functions registered via
    `add_done_callback(fn)` or passed as `callback=`/`on_done=`/
    `on_response=` kwargs of serve-shaped calls (`submit`/`call`),
    including same-module helpers they call. `.result()` on the
    handler's OWN future argument is the sanctioned read-the-response
    idiom (already resolved, returns instantly) and does not fire."""
    for name, fn in sorted(_handler_functions(mod).items()):
        label = getattr(fn, "name", name)
        own = _first_own_param(fn)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "result"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == own
                ):
                    continue  # own-future read: non-blocking
                d = mod.dotted(node.func)
                if d in _BLOCKING_DOTTED:
                    yield _diag(
                        mod, node, "blocking-in-handler",
                        f"{label}: {d}() in a serve handler body — "
                        f"{_BLOCKING_DOTTED[d]}; hand off to a queue "
                        f"instead",
                    )
                elif (
                    d is None
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _BLOCKING_METHODS
                ):
                    yield _diag(
                        mod, node, "blocking-in-handler",
                        f"{label}: .{node.func.attr}() in a serve "
                        f"handler body — "
                        f"{_BLOCKING_METHODS[node.func.attr]}; hand "
                        f"off to a queue instead",
                    )


# --------------------------------------------------------------------------
# swallowed-worker-exception
# --------------------------------------------------------------------------

# Sinks that legitimately RECORD a worker exception instead of eating
# it: future/queue delivery methods and the fault/ health-report API.
_EXC_SINK_ATTRS = frozenset({
    "_reject", "_resolve", "set_exception", "set_result",
    "put", "put_nowait", "append", "appendleft", "add",
    "enqueue_resps", "record",
})
_EXC_HEALTH_ATTRS = frozenset({
    "report_worker_exception", "report_exception", "report_stall",
    "report_failure", "quarantine", "transition",
    "_fail_replica", "fail_replica", "on_replica_failed",
    # repl/ worker threads (shipper ship loop, follower apply loop,
    # promotion watch): `_record_failure` is their sanctioned report
    # path — it stores the error for barrier/read callers AND calls
    # the health API, so a handler routing through it has surfaced
    # the failure
    "_record_failure", "record_failure",
})
_BROAD_EXC_NAMES = frozenset({"Exception", "BaseException"})


def _thread_target_functions(mod: ModuleInfo,
                             project: Project) -> dict[str, ast.AST]:
    # three rules ask per module: computed once
    cached = getattr(mod, "_nrl_thread_targets", None)
    if cached is None:
        cached = _find_thread_targets(mod, project)
        mod._nrl_thread_targets = cached  # type: ignore[attr-defined]
    return cached


def _find_thread_targets(mod: ModuleInfo,
                         project: Project) -> dict[str, ast.AST]:
    """name -> function node for every thread-target in the module —
    `target=` arguments of `threading.Thread(...)` calls (plain names
    resolved through enclosing scopes and aliases, `self._worker_loop`
    bound methods by method name, inline lambdas) — closed transitively
    over same-module calls (`helper()` / `self._helper()`): a worker
    loop that delegates its batch to a helper still runs that helper on
    the worker thread."""
    defs: dict[str, ast.AST] = {}
    for node in mod.walk():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
    roots: list[ast.AST] = []
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        d = mod.dotted(node.func)
        is_thread = d == "threading.Thread" or (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "Thread"
        )
        if not is_thread:
            continue
        for kw in node.keywords:
            if kw.arg == "target":
                roots.append(kw.value)
    targets: dict[str, ast.AST] = {}
    queue: list[tuple[str, ast.AST]] = []
    for i, r in enumerate(roots):
        if isinstance(r, ast.Lambda):
            queue.append((f"<lambda#{i}>", r))
        elif isinstance(r, ast.Name):
            for fn in project._resolve_callable_name(mod, r, r.id):
                queue.append((getattr(fn, "name", r.id), fn))
        elif isinstance(r, ast.Attribute) and r.attr in defs:
            queue.append((r.attr, defs[r.attr]))
    while queue:
        name, fn = queue.pop()
        if name in targets:
            continue
        targets[name] = fn
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for n in ast.walk(stmt):
                if not isinstance(n, ast.Call):
                    continue
                callee = None
                if isinstance(n.func, ast.Name):
                    callee = n.func.id
                elif (
                    isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in ("self", "cls")
                ):
                    callee = n.func.attr
                if callee is not None and callee in defs:
                    queue.append((callee, defs[callee]))
    return targets


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    """`except:`, `except Exception:`, `except BaseException:` (alone
    or in a tuple)."""
    t = handler.type
    if t is None:
        return True
    exprs = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in exprs:
        name = None
        if isinstance(e, ast.Name):
            name = e.id
        elif isinstance(e, ast.Attribute):
            name = e.attr
        if name in _BROAD_EXC_NAMES:
            return True
    return False


def _handler_records_failure(handler: ast.ExceptHandler) -> bool:
    """The handler body re-raises, records to a future/queue sink, or
    calls a health-report API — any of which surfaces the failure."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            attr = None
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
            elif isinstance(node.func, ast.Name):
                attr = node.func.id
            if attr in _EXC_SINK_ATTRS or attr in _EXC_HEALTH_ATTRS:
                return True
    return False


@rule(
    "swallowed-worker-exception", ERROR,
    "broad except in a thread-target/worker-loop swallows the failure",
)
def swallowed_worker_exception(mod: ModuleInfo,
                               project: Project) -> Iterator[Diagnostic]:
    """A `threading.Thread` target (or a helper it calls on the worker
    thread) that catches `except:` / `except Exception:` and neither
    re-raises, records to a future/sink (`_reject`, `set_exception`,
    `put`, ...), nor reports to the health API
    (`report_worker_exception`, `_fail_replica`, ...) eats the replica
    failure silently — the exact pattern that turns a dead serve
    worker into an unexplained hang (`serve/frontend.py` worker
    contract; `fault/health.py` is the sanctioned report path).
    Logging alone does not count: a log line resolves no future and
    quarantines no replica."""
    for name, fn in sorted(_thread_target_functions(mod,
                                                    project).items()):
        label = getattr(fn, "name", name)
        for node in ast.walk(fn):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad_handler(node):
                continue
            if _handler_records_failure(node):
                continue
            yield _diag(
                mod, node, "swallowed-worker-exception",
                f"{label}: broad except in a worker-thread function "
                f"neither re-raises, records to a future/sink, nor "
                f"reports replica health — the failure is silently "
                f"swallowed; reject the futures or call a "
                f"health-report API",
            )


# --------------------------------------------------------------------------
# time-in-traced
# --------------------------------------------------------------------------


@rule(
    "time-in-traced", ERROR,
    "clock read on the device path (times the enqueue, not the work)",
)
def time_in_traced(mod: ModuleInfo,
                   project: Project) -> Iterator[Diagnostic]:
    """A `time.*()` read on the device path (a transition, a step or
    round closure, a kernel wrapper) brackets the kernel LAUNCH, which
    returns as soon as the work is queued: the stamp says nothing
    about when the card ran it, and per-call timing there costs a
    clock read per transition. Timing belongs in the host loop, around
    (and fencing) the round (`obs/recorder.py` spans,
    `utils/fence.py`)."""
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        d = mod.dotted(node.func)
        if not d or not d.startswith("time."):
            continue
        if project.device_context(mod, node) is None:
            continue
        yield _diag(
            mod, node, "time-in-traced",
            f"{d}() on the device path times the enqueue, not the "
            f"work (kernels run after the call returns); time on the "
            f"host side of the round, fenced",
        )


# --------------------------------------------------------------------------
# non-durable-publish
# --------------------------------------------------------------------------

_PUBLISH_FNS = ("os.replace", "os.rename")
_SAVEZ_FNS = ("numpy.savez", "numpy.savez_compressed")


def _binary_write_mode(call: ast.Call) -> bool:
    """`open(...)` whose mode constant creates/truncates a BINARY file
    (`wb`, `xb`, `w+b`, ...) — the write half of a publish sequence."""
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return (
        isinstance(mode, str)
        and "b" in mode
        and any(c in mode for c in "wx")
    )


def _walk_scope(node: ast.AST, _root: bool = True):
    """Walk a scope WITHOUT descending into nested function scopes
    (each function is analyzed as its own publish sequence)."""
    if not _root and isinstance(
        node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
    ):
        return
    yield node
    for child in ast.iter_child_nodes(node):
        yield from _walk_scope(child, _root=False)


@rule(
    "non-durable-publish", WARNING,
    "atomic-rename publish of a written file with no fsync between",
)
def non_durable_publish(mod: ModuleInfo,
                        project: Project) -> Iterator[Diagnostic]:
    """The durable-publish convention (`core/checkpoint.py:
    save_snapshot`, `durable/wal.py`): a file published by atomic
    rename must be fsynced FIRST — `os.replace` orders the directory
    entry, not the data blocks, so a crash between rename and
    writeback publishes a name that points at a torn or empty file
    (exactly the published-but-empty snapshot failure recovery cannot
    distinguish from corruption). Flags, per function scope:

    - a binary-create `open(..., "wb"/"xb"/...)` followed by
      `os.replace`/`os.rename` with no `os.fsync` between them;
    - a bare `np.savez`/`np.savez_compressed` straight to a path
      (anything but a handle bound from `open()` in the same scope):
      writing the final name directly has no atomic publish at all —
      write to an fsynced tmp file and rename it in.

    Text-mode rewrites (CSV upgrades) and append-only handles are out
    of scope: they are not publish points for recovery-critical state.
    """
    scopes = [mod.tree] + [
        n for n in mod.walk()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for scope in scopes:
        open_lines: list[int] = []
        open_bound: set[str] = set()
        fsync_lines: list[int] = []
        publishes: list[ast.Call] = []
        savez_calls: list[tuple[ast.Call, str]] = []
        for node in _walk_scope(scope):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if (isinstance(fn, ast.Name) and fn.id == "open"
                    and _binary_write_mode(node)):
                open_lines.append(node.lineno)
                parent = mod.parent(node)
                if (isinstance(parent, ast.withitem)
                        and isinstance(parent.optional_vars,
                                       ast.Name)):
                    open_bound.add(parent.optional_vars.id)
                elif (isinstance(parent, ast.Assign)
                      and len(parent.targets) == 1
                      and isinstance(parent.targets[0], ast.Name)):
                    open_bound.add(parent.targets[0].id)
            dotted = mod.dotted(fn)
            if dotted == "os.fsync":
                fsync_lines.append(node.lineno)
            elif dotted in _PUBLISH_FNS:
                publishes.append(node)
            elif dotted in _SAVEZ_FNS:
                savez_calls.append((node, dotted.split(".")[-1]))
        for node in publishes:
            prior = [lo for lo in open_lines if lo < node.lineno]
            if not prior:
                continue
            lo = max(prior)
            if any(lo <= lf < node.lineno for lf in fsync_lines):
                continue
            yield _diag(
                mod, node, "non-durable-publish",
                "os.replace/os.rename publishes a file written at "
                f"line {lo} with no os.fsync between write and "
                "rename; a crash can publish a torn/empty file — "
                "fsync the handle before renaming (and the directory "
                "after, for the entry itself)",
            )
        for node, name in savez_calls:
            first = node.args[0] if node.args else None
            if first is None or (
                isinstance(first, ast.Name) and first.id in open_bound
            ):
                continue
            yield _diag(
                mod, node, "non-durable-publish",
                f"np.{name} writes directly to its final path (no "
                "atomic publish, no fsync): write into an open tmp-"
                "file handle, fsync it, then os.replace into place "
                "(core/checkpoint.py:save_snapshot is the template)",
            )


# --------------------------------------------------------------------------
# raw-clock-in-subsystem
# --------------------------------------------------------------------------

#: package directories whose timed waits must route through the
#: injectable clock (the simulation contract, `utils/clock.py`)
_CLOCKED_SUBSYSTEMS = ("serve", "fault", "repl", "durable", "shard")

_RAW_CLOCK_CALLS = {
    "time.monotonic": "time.monotonic() reads the OS clock directly",
    "time.sleep": "time.sleep() blocks on the OS clock directly",
    # the old blanket perf_counter exemption is narrowed to ops/bench
    # paths (outside this rule's scope anyway): inside a clock-routed
    # subsystem even a pure duration probe must follow the injected
    # clock, or a simulated run's durations (batch times, repair
    # latencies, fsync spans) are measured against the WRONG clock —
    # the sim-flavor bug this rule exists to prevent
    "time.perf_counter": "time.perf_counter() measures against the "
                         "OS clock directly",
}

#: receiver tails that denote a threading.Condition in this codebase
#: (`self._cond`, `self._lock`-as-Condition, a local `cond`); `clock`
#: receivers are the sanctioned routing and never match
_CONDITION_TOKENS = ("cond", "lock")


def _clocked_subsystem(path: str) -> str | None:
    parts = re.split(r"[\\/]+", path)
    for name in _CLOCKED_SUBSYSTEMS:
        if name in parts[:-1]:
            return name
    return None


@rule(
    "raw-clock-in-subsystem", WARNING,
    "direct time.monotonic/time.sleep/Condition.wait in a "
    "clock-routed subsystem (serve/, fault/, repl/, durable/, "
    "shard/)",
)
def raw_clock_in_subsystem(mod: ModuleInfo,
                           project: Project) -> Iterator[Diagnostic]:
    """The simulation contract (`utils/clock.py`, `sim/`): every timed
    wait in serve/, fault/, repl/, and durable/ routes through the
    process-global injectable clock — `get_clock().now()/.sleep()/
    .wait(cond, timeout)` — so `SimClock` can substitute virtual time
    and a seeded schedule fully determines which timeouts fire. A
    direct `time.monotonic()`, `time.sleep()`, or `Condition.wait()`
    in those packages is invisible to the simulator: the component
    would block on (or stamp with) real time mid-simulation, and the
    deterministic-replay property dies silently. `time.perf_counter()`
    is flagged too — a duration probe inside a clocked subsystem
    measures simulated work against the wrong clock (its exemption is
    narrowed to ops/bench paths, which sit outside this rule's path
    scope anyway). `Thread.join` and `Event.wait` stay exempt
    (real-thread barriers). The raw clock legitimately lives in
    `utils/clock.py` itself and in obs/ (whose wall/mono stamps are
    correlation fields) — both outside this rule's path scope."""
    sub = _clocked_subsystem(mod.path)
    if sub is None:
        return
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        dotted = mod.dotted(node.func)
        if dotted in _RAW_CLOCK_CALLS:
            yield _diag(
                mod, node, "raw-clock-in-subsystem",
                f"{_RAW_CLOCK_CALLS[dotted]} inside {sub}/; route "
                "through the injectable clock "
                "(utils/clock.py:get_clock) so simulated runs stay "
                "deterministic",
            )
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "wait"):
            continue
        tail = _receiver_tail(fn.value)
        if tail is None:
            continue
        low = tail.lower()
        if any(tok in low for tok in _CONDITION_TOKENS) and (
            "clock" not in low
        ):
            yield _diag(
                mod, node, "raw-clock-in-subsystem",
                f"direct Condition.wait on `{tail}` inside {sub}/; "
                "use get_clock().wait(cond, timeout) so SimClock can "
                "wake the waiter when virtual time passes its "
                "deadline",
            )


# --------------------------------------------------------------------------
# unbounded-growth-in-subsystem
# --------------------------------------------------------------------------

#: package directories whose worker loops must bound every accumulator
#: (the overload-plane memory contract: per-replica memory is
#: O(queue_depth + batch), never load-proportional)
_GROWTH_SUBSYSTEMS = ("serve", "repl")

_APPEND_METHODS = ("append", "appendleft", "extend", "extendleft")
_DRAIN_METHODS = ("pop", "popleft", "clear", "popitem")

#: identifier fragments that mark a bound/watermark comparison
_BOUND_TOKENS = ("depth", "maxlen", "watermark", "bound", "limit",
                 "capacity", "max_")


def _unbounded_init_attrs(cls_node: ast.ClassDef) -> set[str]:
    """`self.X` attributes a class's `__init__` binds to an unbounded
    container: `[]`, `list()`, or `deque()` without `maxlen`."""
    attrs: set[str] = set()
    for item in cls_node.body:
        if not (isinstance(item, ast.FunctionDef)
                and item.name == "__init__"):
            continue
        for node in ast.walk(item):
            if not isinstance(node, ast.Assign):
                continue
            names = [a for a in map(_self_attr, node.targets)
                     if a is not None]
            if not names:
                continue
            v = node.value
            unbounded = isinstance(v, ast.List) and not v.elts
            if isinstance(v, ast.Call):
                fn = v.func
                callee = (
                    fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute)
                    else None
                )
                if callee in ("deque", "list") and not any(
                        kw.arg == "maxlen" for kw in v.keywords):
                    unbounded = True
            if unbounded:
                attrs.update(names)
    return attrs


def _drained_attrs(cls_node: ast.ClassDef) -> set[str]:
    """Attributes the class pops/clears SOMEWHERE — a drained
    container is a queue, not an accumulator."""
    out: set[str] = set()
    for node in ast.walk(cls_node):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute)
                and fn.attr in _DRAIN_METHODS):
            continue
        attr = _self_attr(fn.value)
        if attr is not None:
            out.add(attr)
    return out


def _has_bound_check(fn: ast.AST) -> bool:
    """A comparison over `len(...)` or over a bound/watermark-named
    value anywhere in the function — the shape every honest
    depth/watermark check takes."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id == "len"):
                return True
            name = None
            if isinstance(sub, ast.Name):
                name = sub.id
            elif isinstance(sub, ast.Attribute):
                name = sub.attr
            if name is not None and any(
                    tok in name.lower() for tok in _BOUND_TOKENS):
                return True
    return False


@rule(
    "unbounded-growth-in-subsystem", WARNING,
    "worker-loop accumulator in serve//repl/ grows without a bound "
    "or watermark check",
)
def unbounded_growth_in_subsystem(
        mod: ModuleInfo, project: Project) -> Iterator[Diagnostic]:
    """The overload-plane memory contract (`serve/overload.py`):
    per-replica memory is O(queue_depth + batch), never
    load-proportional — so every container a serve/ or repl/ WORKER
    LOOP appends to must be bounded. Fires on `self.X.append/extend`
    inside a thread-target function (or a helper it calls on the
    worker thread, the `swallowed-worker-exception` closure) when `X`
    was initialized as a bare `[]`/`list()`/`deque()` (no `maxlen`)
    and neither (a) the enclosing function compares a `len(...)` or a
    bound/watermark-named value (an admission/depth check), nor (b)
    the class drains the container somewhere (`pop`/`popleft`/
    `clear` — a queue, not an accumulator). An unbounded worker-side
    accumulator is exactly how apply lag, ship backlog, or a retry
    queue eats the heap under sustained overload — bound it, or wire
    it to a watermark the admission controller can see."""
    parts = re.split(r"[\\/]+", mod.path)
    if not any(s in parts[:-1] for s in _GROWTH_SUBSYSTEMS):
        return
    unbounded: set[str] = set()
    drained: set[str] = set()
    for node in mod.walk():
        if isinstance(node, ast.ClassDef):
            unbounded |= _unbounded_init_attrs(node)
            drained |= _drained_attrs(node)
    growers = unbounded - drained
    if not growers:
        return
    for name, fn in sorted(_thread_target_functions(mod,
                                                    project).items()):
        if _has_bound_check(fn):
            continue
        label = getattr(fn, "name", name)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            call_fn = node.func
            if not (isinstance(call_fn, ast.Attribute)
                    and call_fn.attr in _APPEND_METHODS):
                continue
            attr = _self_attr(call_fn.value)
            if attr is None or attr not in growers:
                continue
            yield _diag(
                mod, node, "unbounded-growth-in-subsystem",
                f"{label}: self.{attr}.{call_fn.attr}() on the worker "
                f"thread with no bound or watermark check and no "
                f"drain path — under sustained overload this "
                f"accumulator grows with load; cap it (deque(maxlen=)"
                f"), drain it, or gate the append on a depth/"
                f"watermark the admission controller enforces",
            )


# --------------------------------------------------------------------------
# host-transfer-in-sharded-path
# --------------------------------------------------------------------------

#: package directories whose exec paths run over mesh-placed state
#: (the replica axis lives across devices there — parallel/mesh.py)
_SHARDED_PATH_DIRS = ("core", "parallel")

#: function names that ARE the exec path: replay rounds, catch-up
#: loops, fused steps, and the explicit-collective programs
_SHARDED_FN_RE = re.compile(r"(exec|catchup|replay|shmap|step)")

#: identifier fragments that denote mesh-placed state: replica states,
#: the log's ring planes and the placed fleet's shards. Cursor
#: readbacks (ltails/tail/head/ctail — a few hundred bytes) are the
#: sanctioned host syncs of the exec loop and never match.
_SHARDED_STATE_TOKENS = ("states", "opcodes", "placed", "shards")

_TRANSFER_DOTTED = {
    "numpy.asarray": "np.asarray copies the placed tensor to the host",
    "numpy.array": "np.array copies the placed tensor to the host",
}
_TRANSFER_METHODS = {
    "item": "a cross-device readback per call",
    "cpu": "a copy of the placed state to the host",
    "numpy": "a copy of the placed state to the host",
    "tolist": "a copy of the placed state to the host",
}


def _mentions_sharded_state(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name and any(tok in name for tok in _SHARDED_STATE_TOKENS):
            return True
    return False


def _to_host_device(call: ast.Call) -> bool:
    """`.to("cpu")` / `.to(device="cpu")` / `.to(torch.device("cpu"))`."""
    args = list(call.args) + [k.value for k in call.keywords
                              if k.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and a.args:
            a = a.args[0]
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


@rule(
    "host-transfer-in-sharded-path", WARNING,
    "np.asarray/.cpu()/.to('cpu')/.item() on mesh-placed state in a "
    "core//parallel/ exec path",
)
def host_transfer_in_sharded_path(
        mod: ModuleInfo, project: Project) -> Iterator[Diagnostic]:
    """The mesh-fleet placement contract (`parallel/mesh.py:place`):
    replica states and the log's ring planes live split across the
    mesh's devices (`Placed.shards`), so a host copy of them inside an
    exec path (`_exec_round`, catch-up loops, the shmap/ring programs,
    the fused steps) is a GATHER of the whole fleet through the host —
    O(R x state) bytes over PCIe per round, exactly the transfer the
    placement exists to avoid, and silently correct so no test catches
    it. Scoped to core/ and parallel/ functions whose name marks them
    as exec-path (exec/catchup/replay/shmap/step); flags
    `np.asarray`/`np.array` calls, `.cpu()`/`.numpy()`/`.tolist()`/
    `.item()` and `.to("cpu")` whose operand mentions placed state
    (`states`, `opcodes`, `placed`, `shards`). Cursor readbacks
    (`ltails`/`tail`/`head`/`ctail`) are the exec loop's sanctioned
    host syncs and stay clean; deliberate host bridges (`ring_slice`,
    checkpointing, `verify`) live outside the scoped function
    names."""
    parts = re.split(r"[\\/]+", mod.path)
    if not any(d in parts[:-1] for d in _SHARDED_PATH_DIRS):
        return
    for fn_node in mod.walk():
        if not isinstance(fn_node,
                          (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _SHARDED_FN_RE.search(fn_node.name):
            continue
        for node in mod.walk(fn_node):
            if not isinstance(node, ast.Call):
                continue
            d = mod.dotted(node.func)
            if d in _TRANSFER_DOTTED:
                if not (node.args
                        and _mentions_sharded_state(node.args[0])):
                    continue
                yield _diag(
                    mod, node, "host-transfer-in-sharded-path",
                    f"{fn_node.name}: {_TRANSFER_DOTTED[d]} inside an "
                    f"exec path — on a mesh fleet this gathers every "
                    f"device's shard through the host each round; keep "
                    f"the state on its device (cursor readbacks are "
                    f"fine)",
                )
                continue
            f = node.func
            if not (d is None and isinstance(f, ast.Attribute)
                    and _mentions_sharded_state(f.value)):
                continue
            what = _TRANSFER_METHODS.get(f.attr)
            if f.attr == "to" and _to_host_device(node):
                what = "a copy of the placed state to the host"
            if what is None:
                continue
            yield _diag(
                mod, node, "host-transfer-in-sharded-path",
                f"{fn_node.name}: .{f.attr}() on mesh-placed state "
                f"inside an exec path — {what}; keep the state on its "
                f"device or read back cursors instead",
            )


# --------------------------------------------------------------------------
# aliased-pallas-planes
# --------------------------------------------------------------------------

#: a declaration in a kernel source that a launch's plane is written in
#: place: `// in-place: <param>[, <param>]`
_INPLACE_DECL_RE = re.compile(r"//\s*in-place:\s*([\w,\s]+)")
_C_FN_RE = r"\b{name}\s*\(([^)]*)\)\s*\{{"


def _package_root(path: str) -> str | None:
    """The top package directory holding `path` (walking up through
    `__init__.py` files), or None outside a package."""
    d = os.path.dirname(os.path.abspath(path))
    root = None
    while os.path.isfile(os.path.join(d, "__init__.py")):
        root = d
        d = os.path.dirname(d)
    return root


def _kernel_inplace_params(mod: ModuleInfo,
                           symbol: str) -> tuple[list[str], set[str]]:
    """`(parameter names, in-place parameter names)` of the C entry
    point `symbol` in the package's `csrc/*.cu` sources ([], set())
    when no source defines it."""
    cache = getattr(mod, "_nrl_csrc", None)
    if cache is None:
        cache = {}
        root = _package_root(mod.path)
        csrc = os.path.join(root, "csrc") if root else None
        if csrc and os.path.isdir(csrc):
            for f in sorted(os.listdir(csrc)):
                if f.endswith((".cu", ".cuh")):
                    with open(os.path.join(csrc, f),
                              encoding="utf-8") as fh:
                        cache[f] = fh.read()
        mod._nrl_csrc = cache  # type: ignore[attr-defined]
    for text in cache.values():
        m = re.search(_C_FN_RE.format(name=re.escape(symbol)), text)
        if not m:
            continue
        names = []
        for p in m.group(1).split(","):
            toks = re.findall(r"[A-Za-z_]\w*", p)
            if toks:
                names.append(toks[-1])
        inplace = {
            n.strip()
            for decl in _INPLACE_DECL_RE.findall(text)
            for n in decl.split(",") if n.strip()
        }
        return names, inplace
    return [], set()


_CONTAINERS = (ast.List, ast.Tuple, ast.Set, ast.ListComp,
               ast.GeneratorExp)


def _data_ptr_root(mod: ModuleInfo, arg: ast.AST,
                   aliases: dict[str, ast.AST]) -> str | None:
    """The tensor a launch argument hands the kernel a pointer into:
    `x.data_ptr()` (or `x.view(...)[i].data_ptr() + off`) -> `x`,
    resolved through the enclosing functions' view aliases
    (`xt = x.T`). An element of a Python list or tuple of tensors
    (`outs = [torch.empty_like(t) for t in ...]`) is its own tensor:
    `outs[0]` and `outs[1]` are two roots."""
    for node in ast.walk(arg):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "data_ptr"):
            continue
        chain = node.func.value
        seen: set[str] = set()
        while True:
            root = _storage_root(chain)
            if root is None:
                return None
            if isinstance(aliases.get(root), _CONTAINERS):
                # the subscript taken directly off the container
                cur, elem = chain, None
                while isinstance(cur, (ast.Attribute, ast.Subscript,
                                       ast.Call)):
                    if isinstance(cur, ast.Subscript) and isinstance(
                            cur.value, ast.Name):
                        elem = cur
                    cur = (cur.func.value if isinstance(cur, ast.Call)
                           else cur.value)
                return ast.unparse(elem) if elem is not None else root
            if root not in aliases or root in seen:
                return root
            seen.add(root)
            nxt = aliases[root]
            if _storage_root(nxt) is None:
                return root
            chain = nxt
    return None


def _closure_aliases(mod: ModuleInfo,
                     node: ast.AST) -> dict[str, ast.AST]:
    """`_local_aliases` extended through the WHOLE lexical closure:
    name -> value expr from every enclosing function, innermost scope
    shadowing outermost, so a view bound in an enclosing function
    (`vals_t = states["values"].T`) still resolves at a launch made in
    a nested round closure. Within one function the LAST assignment
    in source order wins (`_local_aliases` parity), and nested
    function bodies are skipped when scanning an enclosing scope: a
    sibling inner def's bindings are its own, not the closure's."""
    def scope_assigns(fn) -> dict[str, ast.AST]:
        local: dict[str, ast.AST] = {}

        def visit(children) -> None:
            for n in children:
                if isinstance(n, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                    continue  # inner scopes bind their own names
                if (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                ):
                    local[n.targets[0].id] = n.value
                visit(ast.iter_child_nodes(n))

        body = fn.body if isinstance(fn.body, list) else [fn.body]
        visit(body)
        return local

    out: dict[str, ast.AST] = {}
    for fn in mod.enclosing_functions(node):
        for k, v in scope_assigns(fn).items():
            out.setdefault(k, v)  # innermost scope wins
    return out


@rule(
    "aliased-pallas-planes", ERROR,
    "one tensor's storage passed as two planes of one kernel launch",
)
def aliased_pallas_planes(mod: ModuleInfo,
                          project: Project) -> Iterator[Diagnostic]:
    """The reference's silent-corruption pattern, read for the port's
    launches: the reference aliased a BLOCKED state plane in->out and
    the grid's prefetch raced the write-back; here every kernel takes
    its planes as raw pointers through the C ABI (`ops/kernel_lib.py`),
    and a kernel that reads plane `a` while other threads write plane
    `b` assumes `a` and `b` do not overlap. Passing one tensor — or two
    views of one storage — as two distinct planes of one launch in an
    ops/ wrapper makes threads read half-written rows, silently, and
    only once blocks run concurrently (never in the plain version on
    the CPU). The sanctioned shapes stay clean: fresh output planes
    (`torch.empty_like`), and a plane the kernel's source declares
    written in place (`// in-place: <param>` in its `csrc/*.cu`,
    matched against the C entry point's parameter names). Scoped to
    ops/, where every launch lives."""
    parts = re.split(r"[\\/]+", mod.path)
    if "ops" not in parts[:-1]:
        return
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        if sum(1 for a in node.args for n in ast.walk(a)
               if isinstance(n, ast.Attribute)
               and n.attr == "data_ptr") < 2:
            continue
        aliases = _closure_aliases(mod, node)
        roots: dict[str, int] = {}
        params: list[str] | None = None
        inplace: set[str] = set()
        for i, arg in enumerate(node.args):
            root = _data_ptr_root(mod, arg, aliases)
            if root is None:
                continue
            if root not in roots:
                roots[root] = i
                continue
            if params is None:
                params, inplace = _kernel_inplace_params(
                    mod, node.func.attr)
            first = roots[root]
            names = {params[j] for j in (first, i) if j < len(params)}
            if names & inplace:
                continue
            yield _diag(
                mod, arg, "aliased-pallas-planes",
                f"{node.func.attr}: `{root}` is passed as planes "
                f"{first} and {i} of one launch — threads reading one "
                f"plane race the writes to the other; give the kernel "
                f"a fresh output plane, or declare the plane "
                f"`// in-place:` in its csrc source",
            )


# --------------------------------------------------------------------------
# raw-socket-in-worker
# --------------------------------------------------------------------------

#: socket calls that block forever without a configured timeout
_BLOCKING_SOCKET_METHODS = frozenset({
    "accept", "recv", "recv_into", "recvfrom", "recvmsg",
})


def _timeout_sanctioned_tails(mod: ModuleInfo) -> set[str]:
    """Receiver tails with a visible timeout configuration anywhere in
    the module: a `.settimeout(...)` call on that tail. Module-wide on
    purpose — sockets are typically configured once at their
    construction site (`__init__`, an accept loop) and blocked on in
    a different function, and a per-function scope would force
    re-asserting the timeout at every blocking site."""
    sanctioned: set[str] = set()
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "settimeout":
            tail = _receiver_tail(f.value)
            if tail is not None:
                sanctioned.add(tail)
    return sanctioned


@rule(
    "raw-socket-in-worker", ERROR,
    "blocking socket accept/recv without a timeout in a repl/ worker "
    "thread",
)
def raw_socket_in_worker(mod: ModuleInfo,
                         project: Project) -> Iterator[Diagnostic]:
    """A `accept()`/`recv()` on a timeout-less socket inside a repl/
    thread target blocks FOREVER on a half-open connection: the worker
    can never observe its stop flag, `close()` hangs on the join, and
    a partitioned peer wedges the node instead of degrading it
    (`repl/transport.py`'s liveness discipline). Every socket a repl/
    worker loop blocks on must carry a `settimeout(...)` — visible on
    the same receiver name somewhere in the module (construction-site
    configuration counts) — or route its deadline through the
    injectable clock. Scoped to repl/ thread targets (the same
    transitive thread-target closure `swallowed-worker-exception`
    walks): request/response helpers on caller threads time out into
    the CALLER's error handling and are its business."""
    parts = re.split(r"[\\/]+", mod.path)
    if "repl" not in parts[:-1]:
        return
    sanctioned = _timeout_sanctioned_tails(mod)
    for name, fn in sorted(_thread_target_functions(mod,
                                                    project).items()):
        label = getattr(fn, "name", name)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr in _BLOCKING_SOCKET_METHODS):
                continue
            tail = _receiver_tail(f.value)
            if tail is None:
                continue
            low = tail.lower()
            if not any(tok in low for tok in
                       ("sock", "conn", "listener", "client")):
                continue  # not socket-shaped (e.g. a queue's recv)
            if tail in sanctioned:
                continue
            yield _diag(
                mod, node, "raw-socket-in-worker",
                f"{label}: blocking .{f.attr}() on `{tail}` with no "
                f"settimeout anywhere in the module — a half-open "
                f"peer wedges this repl/ worker thread forever; "
                f"configure a socket timeout (or an injected-clock "
                f"deadline) so the loop can observe its stop flag",
            )


# --------------------------------------------------------------------------
# unbounded-metric-cardinality
# --------------------------------------------------------------------------

#: the registry's instrument factories (obs/metrics.py)
_METRIC_FACTORIES = frozenset({"counter", "gauge", "histogram"})

#: receiver names that denote the metrics registry at a call site
#: (`reg.counter(...)`, `registry.gauge(...)`, `self._registry...`,
#: plus the direct `get_registry().counter(...)` chain)
_REGISTRY_TAILS = frozenset({"reg", "registry", "_reg", "_registry"})

#: identifier shapes that carry PER-RECORD data: log positions,
#: request/trace/sequence ids. Interpolating one into a metric NAME
#: mints a new instrument per record. Deliberately absent: `rid`
#: (replica id — fleet-bounded), `log_idx` (log count), `tid`
#: excluded? no — a thread-context tid is per-client-thread and
#: unbounded across a process lifetime, so it matches too.
_PER_RECORD_TOKENS = re.compile(
    r"(?:^|_)(?:pos0?|tid|seq(?:no)?|req(?:uest)?(?:_?id)?|"
    r"op_?id|record|trace_?id)(?:$|\d*$)",
    re.IGNORECASE,
)


def _is_registry_call(node: ast.Call) -> bool:
    f = node.func
    if not (isinstance(f, ast.Attribute)
            and f.attr in _METRIC_FACTORIES):
        return False
    recv = f.value
    if isinstance(recv, ast.Call):  # get_registry().counter(...)
        g = recv.func
        name = g.id if isinstance(g, ast.Name) else (
            g.attr if isinstance(g, ast.Attribute) else None
        )
        return name == "get_registry"
    tail = _receiver_tail(recv)
    return tail is not None and tail.lower() in _REGISTRY_TAILS


def _interp_exprs(name_arg: ast.AST) -> Iterator[ast.AST]:
    """Expressions interpolated into a metric-name argument: f-string
    holes, `.format(...)` arguments, `%` right-hand operands."""
    if isinstance(name_arg, ast.JoinedStr):
        for part in name_arg.values:
            if isinstance(part, ast.FormattedValue):
                yield part.value
    elif isinstance(name_arg, ast.Call) and isinstance(
            name_arg.func, ast.Attribute
    ) and name_arg.func.attr == "format":
        yield from name_arg.args
        for kw in name_arg.keywords:
            yield kw.value
    elif isinstance(name_arg, ast.BinOp) and isinstance(
            name_arg.op, ast.Mod):
        right = name_arg.right
        if isinstance(right, ast.Tuple):
            yield from right.elts
        else:
            yield right


def _per_record_ident(expr: ast.AST) -> str | None:
    """The per-record identifier an interpolated expression exposes,
    or None. Walks the whole expression so `rec.pos`, `self._seq`,
    and `int(pos0)` all surface their tell-tale name."""
    for node in ast.walk(expr):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name and _PER_RECORD_TOKENS.search(name):
            return name
    return None


@rule(
    "unbounded-metric-cardinality", WARNING,
    "per-record value (pos / request id / seq) interpolated into a "
    "metric name",
)
def unbounded_metric_cardinality(
        mod: ModuleInfo, project: Project) -> Iterator[Diagnostic]:
    """The registry's obs discipline (`obs/metrics.py`): instruments
    are created once and cached; names are a FIXED vocabulary, with at
    most fleet-bounded dimensions baked in (`serve.queue_depth.r<rid>`
    — one per replica, retired with the replica). Interpolating
    per-record data — a log position, a request/trace id, a sequence
    number — into `counter(f"...{pos}...")` mints a new instrument
    per record: the registry (and every exporter scrape) grows without
    bound, which is a memory leak wearing a metrics costume. Emit the
    per-record value as a trace EVENT field instead (`obs/recorder`,
    sampled under NR_TPU_TRACE_SAMPLE); keep metric names closed over
    the code, not the data. Scoped outside obs/ — the registry's own
    implementation and fixtures legitimately build names from
    variables."""
    parts = re.split(r"[\\/]+", mod.path)
    if "obs" in parts[:-1]:
        return
    for node in mod.walk():
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if not _is_registry_call(node):
            continue
        for expr in _interp_exprs(node.args[0]):
            ident = _per_record_ident(expr)
            if ident is None:
                continue
            kind = node.func.attr
            yield _diag(
                mod, node, "unbounded-metric-cardinality",
                f"`{ident}` interpolated into a {kind}() name mints "
                f"one instrument per record — the registry (and every "
                f"exporter scrape) grows without bound; emit it as a "
                f"trace event field instead and keep metric names a "
                f"fixed vocabulary",
            )
            break


# --------------------------------------------------------------------------
# device-sync-in-assembly
# --------------------------------------------------------------------------

#: host-sync calls that would re-serialize the serve pipeline if they
#: ran on the assembly stage (the whole point of the split is that the
#: assembly thread never waits on the device or on another round)
_ASSEMBLY_BLOCKING_DOTTED = {
    "torch.cuda.synchronize": "host sync re-serializes the pipeline",
}
_ASSEMBLY_BLOCKING_METHODS = {
    "synchronize": "host sync re-serializes the pipeline",
    "item": "device->host scalar readback re-serializes the pipeline",
    "tolist": "device->host copy re-serializes the pipeline",
    "cpu": "device->host copy re-serializes the pipeline",
    "numpy": "device->host copy re-serializes the pipeline",
    "result": "waiting on a future blocks assembly behind the very "
              "round it should overlap",
}
#: the assembly-stage entry point (`ServeFrontend._assemble`); the
#: rule roots its transitive closure here
_ASSEMBLY_ENTRY = "_assemble"


def _assembly_functions(mod: ModuleInfo) -> dict[str, ast.AST]:
    """name -> function node for the assembly-stage call graph: the
    `_assemble` entry point closed transitively over same-module
    calls (plain `helper()` and `self._helper()` alike) — the
    `blocking-in-handler` closure machinery re-rooted at the serve
    pipeline's assembly stage."""
    defs: dict[str, ast.AST] = {}
    for node in mod.walk():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
    if _ASSEMBLY_ENTRY not in defs:
        return {}
    closure: dict[str, ast.AST] = {}
    queue: list[tuple[str, ast.AST]] = [
        (_ASSEMBLY_ENTRY, defs[_ASSEMBLY_ENTRY])
    ]
    while queue:
        name, fn = queue.pop()
        if name in closure:
            continue
        closure[name] = fn
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for n in ast.walk(stmt):
                if not isinstance(n, ast.Call):
                    continue
                callee = None
                if isinstance(n.func, ast.Name):
                    callee = n.func.id
                elif (
                    isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in ("self", "cls")
                ):
                    callee = n.func.attr
                if callee is not None and callee in defs:
                    queue.append((callee, defs[callee]))
    return closure


@rule(
    "device-sync-in-assembly", ERROR,
    "host-sync / future-wait on the serve pipeline's assembly stage",
)
def device_sync_in_assembly(mod: ModuleInfo,
                            project: Project) -> Iterator[Diagnostic]:
    """The pipelined serve worker (`ServeFrontend._assemble`,
    `ServeConfig.pipeline_depth`) exists to overlap round N+1's host
    work with round N's device work: the assembly stage drains the
    queue, sweeps deadlines, and `begin_mut_batch`es WITHOUT ever
    waiting on the device. A `torch.cuda.synchronize()`, a stream's
    `.synchronize()`, `.item()` / `.tolist()` / `.cpu()` / `.numpy()`,
    or `future.result()` anywhere in the assembly-stage
    call graph (the `_assemble` entry, closed transitively over
    same-module helpers like `blocking-in-handler`) silently
    re-serializes the pipeline — the overlap knob would still read 1
    while every round pays the full serial latency. Host syncs belong
    on the completion stage, which is the half DESIGNED to wait."""
    for name, fn in sorted(_assembly_functions(mod).items()):
        label = getattr(fn, "name", name)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                d = mod.dotted(node.func)
                if d in _ASSEMBLY_BLOCKING_DOTTED:
                    yield _diag(
                        mod, node, "device-sync-in-assembly",
                        f"{label}: {d}() on the assembly stage — "
                        f"{_ASSEMBLY_BLOCKING_DOTTED[d]}; move the "
                        f"sync to the completion stage",
                    )
                elif (
                    d is None
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _ASSEMBLY_BLOCKING_METHODS
                ):
                    yield _diag(
                        mod, node, "device-sync-in-assembly",
                        f"{label}: .{node.func.attr}() on the "
                        f"assembly stage — "
                        f"{_ASSEMBLY_BLOCKING_METHODS[node.func.attr]}"
                        f"; move the sync to the completion stage",
                    )


# --------------------------------------------------------------------------
# unnamed-worker-thread
# --------------------------------------------------------------------------

_THREAD_NAMED_SUBSYSTEMS = frozenset(
    {"serve", "repl", "fault", "durable", "obs", "shard"}
)


@rule(
    "unnamed-worker-thread", WARNING,
    "threading.Thread(...) without name= in a subsystem module",
)
def unnamed_worker_thread(mod: ModuleInfo,
                          project: Project) -> Iterator[Diagnostic]:
    """The sampling profiler (`obs/profile.py`) attributes host CPU
    time by THREAD NAME: `serve-worker-r0` buckets under the
    serve-worker role, an anonymous `Thread-7` collapses into `other`
    and defeats the whole per-role budget (and `ServeFrontend.threads()`
    / stack dumps go equally blind). Every thread spawned inside the
    serve/, repl/, fault/, durable/, obs/ subsystems must carry a
    `name=` kwarg following the role-prefix contract
    (`obs/profile._ROLE_PREFIXES`). Scratch threads in tests, benches,
    and examples are out of scope — only subsystem code feeds the
    profiler's role table."""
    parts = re.split(r"[\\/]+", mod.path)
    if not _THREAD_NAMED_SUBSYSTEMS.intersection(parts[:-1]):
        return
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        d = mod.dotted(node.func)
        is_thread = d == "threading.Thread" or (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "Thread"
        )
        if not is_thread:
            continue
        # name= kwarg, positional name (3rd arg: group/target/name),
        # or an opaque **kwargs splat all count as named
        if any(kw.arg == "name" or kw.arg is None
               for kw in node.keywords) or len(node.args) >= 3:
            continue
        yield _diag(
            mod, node, "unnamed-worker-thread",
            "threading.Thread without name= — anonymous threads "
            "collapse into the profiler's 'other' role bucket; name "
            "it with the subsystem's role prefix "
            "(obs/profile._ROLE_PREFIXES)",
        )

# --------------------------------------------------------------------------
# unrouted-key-in-shard-path
# --------------------------------------------------------------------------

#: submit surfaces of the serve frontend a shard/ function may only
#: reach AFTER a ShardMap lookup proved (or verified) the key's owner
_SHARD_SUBMIT_METHODS = frozenset({"submit", "execute_mut_batch"})

#: ShardMap lookups that constitute the routing step (`shard/ring.py`)
_SHARD_LOOKUP_CALLS = frozenset(
    {"shard_of", "shard_of_op", "split_batch"}
)


@rule(
    "unrouted-key-in-shard-path", ERROR,
    "frontend submit in shard/ with no ShardMap lookup in the same "
    "function",
)
def unrouted_key_in_shard_path(mod: ModuleInfo,
                               project: Project) -> Iterator[Diagnostic]:
    """The fleet-level LogMapper invariant, machine-checked like the
    in-process one: every write that reaches a `ServeFrontend` inside
    shard/ must have been routed — or re-verified — through the
    `ShardMap` congruence lookup (`shard_of` / `shard_of_op` /
    `split_batch`, `shard/ring.py`). A direct `.submit(...)` /
    `.execute_mut_batch(...)` in a shard/ function with NO lookup in
    that function is a path that can write a key into the wrong
    keyspace slice — silently, because the frontend itself has no idea
    shards exist; the mis-route would only surface as a cross-shard
    isolation violation later (the exact bug class `WrongShard` exists
    to make typed and immediate). Scoped per function: the lookup and
    the submit belong in the same routing step, not "somewhere in the
    module" — a verified sub-batch handed to a helper that submits
    blind is still one stale-map refactor away from a mis-route.
    Reads are exempt (any replica of any shard serves a read of ITS
    slice; a mis-routed read returns a typed miss, not corruption)."""
    parts = re.split(r"[\\/]+", mod.path)
    if "shard" not in parts[:-1]:
        return
    for node in mod.walk():
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            continue
        submits = []
        routed = False
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if not isinstance(f, ast.Attribute):
                continue
            if f.attr in _SHARD_SUBMIT_METHODS:
                submits.append(sub)
            elif f.attr in _SHARD_LOOKUP_CALLS:
                routed = True
        if routed:
            continue
        for sub in submits:
            yield _diag(
                mod, sub, "unrouted-key-in-shard-path",
                f"{node.name}: .{sub.func.attr}() on a frontend "
                f"inside shard/ with no ShardMap lookup "
                f"(shard_of/shard_of_op/split_batch) in the same "
                f"function — an unrouted key can land in the wrong "
                f"keyspace slice; route (or re-verify) through the "
                f"map before submitting",
            )


# --------------------------------------------------------------------------
# txn-ack-before-decision
# --------------------------------------------------------------------------

#: the prepare step of the 2PC protocol (`shard/txn.py`): an attribute
#: call `.prepare(...)` or a verb string handed to a dispatch helper
#: (`_verb_rehomed(s, "prepare", ...)`, `txn_verb("prepare", ...)`)
_TXN_PREPARE_ATTRS = frozenset({"prepare"})

#: sites that resolve the CALLER's view of the transaction — a future
#: resolution or an ok-frame reply. `set_exception` is exempt: failing
#: the caller never claims the transaction decided.
_TXN_ACK_ATTRS = frozenset({"set_result", "send_ok", "reply_ok"})

#: the durable decision point (`durable/txnlog.py DecisionLog.publish`
#: via `durable_publish`): the only thing allowed to dominate an ack
_TXN_DECISION_NAMES = frozenset(
    {"publish", "publish_decision", "durable_publish", "decide"}
)


@rule(
    "txn-ack-before-decision", ERROR,
    "txn path acks the caller with no durable decision publish "
    "dominating it in the same function",
)
def txn_ack_before_decision(mod: ModuleInfo,
                            project: Project) -> Iterator[Diagnostic]:
    """The 2PC commit point is the DURABLE DECISION RECORD, nothing
    else (`shard/txn.py`): once a coordinator tells its caller the
    transaction committed, a crash one instruction later must leave
    behind a decision document that recovery can re-drive — otherwise
    the prepared participants presumed-abort a transaction the caller
    was told succeeded, which is precisely the half-committed state
    the whole layer exists to rule out. Machine-checked shape: a
    shard/ function that drives a prepare verb AND resolves the
    caller's future (`.set_result`) or sends an ok frame must have a
    decision publish (`DecisionLog.publish` / `durable_publish`) at an
    earlier line of the same function. `set_exception` is exempt —
    reporting failure never claims a decision. Scoped per function
    for the same reason as `unrouted-key-in-shard-path`: the decision
    and the ack belong in the same protocol step, not "somewhere in
    the module"."""
    parts = re.split(r"[\\/]+", mod.path)
    if "shard" not in parts[:-1]:
        return
    for node in mod.walk():
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            continue
        prepare_line = None
        decision_lines = []
        acks = []
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            attr = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None
            )
            if attr is None:
                continue
            if attr in _TXN_PREPARE_ATTRS or any(
                isinstance(a, ast.Constant) and a.value == "prepare"
                for a in sub.args
            ):
                if prepare_line is None or sub.lineno < prepare_line:
                    prepare_line = sub.lineno
            elif attr in _TXN_ACK_ATTRS:
                acks.append(sub)
            elif attr in _TXN_DECISION_NAMES:
                decision_lines.append(sub.lineno)
        if prepare_line is None:
            continue
        for ack in acks:
            if any(dl < ack.lineno for dl in decision_lines):
                continue
            yield _diag(
                mod, ack, "txn-ack-before-decision",
                f"{node.name}: .{ack.func.attr if isinstance(ack.func, ast.Attribute) else ack.func.id}"
                f"() acks the transaction to the caller with no "
                f"durable decision publish (DecisionLog.publish / "
                f"durable_publish) at an earlier line of the same "
                f"function — a crash after this ack presumed-aborts "
                f"a transaction the caller was told committed",
            )
