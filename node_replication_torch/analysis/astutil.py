"""AST infrastructure shared by every nrlint rule.

Three pieces of project knowledge live here so the rules stay small:

1. **Suppressions** — `# nrlint: disable=<rule>[,<rule>]` comments,
   parsed with `tokenize` so string literals can't spoof them. A
   suppression covers its own line and the line directly below it (for
   a standalone comment above a long statement).

2. **Name resolution** — per-module import maps plus simple local-alias
   tracking (`exec_fn = log_catchup_all if ... else log_exec_all`), so
   rules can ask "what does this expression denote?" in dotted form
   (`torch.cuda.synchronize`, `numpy.asarray`,
   `node_replication_torch.core.log.log_exec_all`).

3. **Device-path inference** — the set of function scopes that run on
   the device path: code that enqueues work on the card and must not
   wait for it. Nothing in this package is traced, so the seeds are
   the structural contracts of the port:

   - every transition/window function registered on a `Dispatch(...)`
     constructor (`DISPATCH_FN_KWARGS` / `DISPATCH_FN_POSARGS`);
   - the closures returned by the step and round makers
     (`DEVICE_PATH_MAKERS`: `core/step.py:make_step`,
     `core/multilog.py:make_multilog_step`, the fused engines'
     `round_fn`);
   - the kernel wrappers: module-level functions of `ops/replay.py`,
     `ops/vspace.py` and `ops/oahashmap.py` that count a kernel launch
     (`<KERNEL>.launches += 1`).

   The closure then propagates through the project call graph to a
   fixpoint, across modules, so e.g. a helper called by a step closure
   is on the device path without any annotation.

Host-side exits: the round's one device-to-host read
(`core/replica.py:_readback`) and the timed-region barrier
(`utils/fence.py:fence`) are the sanctioned places where the host
waits for the card, with the armed-only debug check
(`utils/checks.py:check`, `SANCTIONED_HOST_EXITS`): none is ever
marked, the closure does not propagate into them, and a lambda handed
to one runs where the exit runs it. They take the place of the
reference package's `isinstance(..., jax.core.Tracer)` guard. The
plain-version branch of a kernel wrapper (`if route(...) == "cpu":`,
taken only for CPU tensors) is not device path either.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize

# The project package: imports under this root resolve cross-module.
PROJECT_PACKAGE = "node_replication_torch"

# Makers (project-relative dotted names; methods as `Class.method`)
# whose NESTED defs — the closures they return — run on the device
# path. The maker's own body runs once, at build time, on the host.
DEVICE_PATH_MAKERS = frozenset({
    "core.step.make_step",
    "core.multilog.make_multilog_step",
    "ops.replay.FusedHashmapEngine.round_fn",
    "ops.vspace.FusedVspaceEngine.round_fn",
    "parallel.collectives.MeshFusedEngine.round_fn",
})

# Modules whose launch-counting module functions are kernel wrappers.
KERNEL_WRAPPER_MODULES = frozenset({
    "ops.replay", "ops.vspace", "ops.oahashmap",
})

# The sanctioned host exits: never device path, never propagated into,
# and neither is a lambda handed to one. `utils.checks.check` reads its
# predicate (a host sync) only when `debug_checks()` arms it, so a
# release run never waits there.
SANCTIONED_HOST_EXITS = frozenset({
    "core.replica._readback",
    "utils.fence.fence",
    "utils.checks.check",
})

# `Dispatch(...)` keyword args whose values are device-path transition
# or window functions (`make_state` runs once at init and is excluded).
DISPATCH_FN_KWARGS = frozenset({
    "write_ops", "read_ops", "window_apply", "window_plan",
    "window_merge",
})
DISPATCH_FN_POSARGS = (2, 3)  # (name, make_state, write_ops, read_ops)

_SUPPRESS_RE = re.compile(
    r"#\s*nrlint:\s*disable\s*=\s*"
    r"([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
)
_SUPPRESS_MENTION_RE = re.compile(r"#\s*nrlint\b")


def parse_suppressions(
    source: str,
) -> tuple[dict[int, frozenset[str]], list[int]]:
    """Parse suppression comments.

    Returns `(suppressions, malformed)`: line number -> rule ids
    suppressed there, plus the lines of malformed `# nrlint` comments.
    ONLY the exact `# nrlint: disable=<rule>[,<rule>]` form suppresses —
    a typo (`disable host-sync-in-jit`, `nrlint disable=...`) must not
    silently disarm every rule on the line, so any other `# nrlint`
    mention is reported as malformed instead."""
    out: dict[int, frozenset[str]] = {}
    malformed: list[int] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            line = tok.start[0]
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                rules = frozenset(
                    r.strip() for r in m.group(1).split(",")
                )
                out[line] = out.get(line, frozenset()) | rules
            elif _SUPPRESS_MENTION_RE.search(tok.string):
                malformed.append(line)
    except (tokenize.TokenError, SyntaxError):
        pass
    return out, malformed


def _module_name_for(path: str) -> str:
    """Dotted module name, walking up through __init__.py packages."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    if parts[0] == "__init__":
        parts = parts[1:] or parts
    return ".".join(reversed(parts))


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


class ModuleInfo:
    """One parsed file: tree with parent links, imports, defs, aliases."""

    def __init__(self, path: str, source: str | None = None):
        self.path = path
        if source is None:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.module_name = _module_name_for(path)
        self.suppressions, self.malformed_suppressions = (
            parse_suppressions(source)
        )
        # parent links (NodeVisitor-free: one walk, kept: every rule
        # walks every module, so the walks are computed once — `walk`)
        self._walks: dict[int, list] = {}
        self.tree._nrl_parent = None  # type: ignore[attr-defined]
        for node in self.walk():
            for child in ast.iter_child_nodes(node):
                child._nrl_parent = node  # type: ignore[attr-defined]
        # imports: local name -> dotted target
        self.imports: dict[str, str] = {}
        for node in self.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports[a.asname] = a.name
                    else:
                        # `import torch.nn.functional` binds the root `torch`
                        root = a.name.split(".")[0]
                        self.imports[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.imports[a.asname or a.name] = (
                        f"{node.module}.{a.name}"
                    )
        # module-level function defs by name
        self.top_defs: dict[str, ast.AST] = {
            n.name: n
            for n in self.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }

    # -------------------------------------------------- tree navigation

    def walk(self, node: ast.AST | None = None) -> list:
        """`ast.walk(node)` (default: the whole module) as a list,
        computed once per node; the tree is never mutated."""
        node = self.tree if node is None else node
        out = self._walks.get(id(node))
        if out is None:
            out = self._walks[id(node)] = list(ast.walk(node))
        return out

    def parent(self, node: ast.AST) -> ast.AST | None:
        return getattr(node, "_nrl_parent", None)

    def enclosing_functions(self, node: ast.AST):
        """Innermost-first chain of enclosing function-like scopes."""
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, _FUNC_NODES):
                yield cur
            cur = self.parent(cur)

    def enclosing_class(self, node: ast.AST) -> ast.ClassDef | None:
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            if isinstance(cur, _FUNC_NODES):
                return None
            cur = self.parent(cur)
        return None

    def in_cpu_route(self, node: ast.AST) -> bool:
        """Inside the body of an `if route(...) == "cpu":` branch —
        a kernel wrapper's plain-version route, taken only because the
        tensors lie on the CPU (`ops/kernel_lib.py:route`). On the card
        that branch never runs, so it is not device path."""
        child, cur = node, self.parent(node)
        while cur is not None:
            if isinstance(cur, ast.If) and child in cur.body \
                    and _is_cpu_route_test(cur.test):
                return True
            child, cur = cur, self.parent(cur)
        return False

    # ----------------------------------------------------- name lookup

    def dotted(self, node: ast.AST) -> str | None:
        """Resolve `Name`/`Attribute` chains to a dotted external name
        through the import map (`F.pad` -> `torch.nn.functional.pad`)."""
        parts: list[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        base = self.imports.get(cur.id)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts))


@dataclasses.dataclass
class Diagnostic:
    path: str
    line: int
    col: int
    rule_id: str
    severity: str
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule_id} {self.severity}: {self.message}{tag}"
        )


class Project:
    """All analyzed modules + the cross-module device-path closure."""

    def __init__(self, modules: list[ModuleInfo]):
        self.modules = modules
        self.by_name = {m.module_name: m for m in modules}
        # project symbol table: dotted name -> (module, def node);
        # methods enter as `module.Class.method`
        self.symbols: dict[str, tuple[ModuleInfo, ast.AST]] = {}
        self.methods: dict[str, tuple[ModuleInfo, ast.AST]] = {}
        for m in modules:
            for name, node in m.top_defs.items():
                self.symbols[f"{m.module_name}.{name}"] = (m, node)
            for cls in m.tree.body:
                if not isinstance(cls, ast.ClassDef):
                    continue
                for node in cls.body:
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.methods[
                            f"{m.module_name}.{cls.name}.{node.name}"
                        ] = (m, node)
        self.host_exits: set[int] = {
            id(self.symbols[f"{PROJECT_PACKAGE}.{name}"][1])
            for name in SANCTIONED_HOST_EXITS
            if f"{PROJECT_PACKAGE}.{name}" in self.symbols
        }
        self.dispatch_fns: set[int] = set()  # id() of def nodes
        self.dispatch_write_fns: set[int] = set()
        self._device: set[int] = set()       # id() of function scopes
        # id(scope) -> name -> [("def"|"alias", node), ...] in walk
        # order; built lazily so each scope body is walked ONCE no
        # matter how many names resolve inside it (the naive re-walk
        # was quadratic and dominated whole-package build time)
        self._scope_index: dict[int, dict[str, list]] = {}
        self._infer()

    # ------------------------------------------------------- queries

    def is_device_scope(self, fn: ast.AST) -> bool:
        return id(fn) in self._device

    def device_context(self, mod: ModuleInfo, node: ast.AST):
        """The innermost device-path function scope enclosing `node`,
        or None. Any enclosing device-path scope counts: a nested def
        inside a device-path function runs there when called."""
        if mod.in_cpu_route(node):
            return None
        for fn in mod.enclosing_functions(node):
            if self._handed_to_host_exit(mod, fn):
                return None
            if id(fn) in self._device:
                return fn
        return None

    def _handed_to_host_exit(self, mod: ModuleInfo, fn: ast.AST) -> bool:
        """`fn` is a lambda passed to a sanctioned host exit
        (`check(lambda: ...)`): it runs where the exit runs it."""
        call = mod.parent(fn)
        if not (isinstance(fn, ast.Lambda) and isinstance(call, ast.Call)
                and call.func is not fn):
            return False
        if isinstance(call.func, ast.Name):
            cands = self._resolve_callable_name(mod, call, call.func.id)
        else:
            hit = self.symbols.get(mod.dotted(call.func) or "")
            cands = [hit[1]] if hit else []
        return any(id(c) in self.host_exits for c in cands)

    def is_dispatch_fn(self, fn: ast.AST) -> bool:
        return id(fn) in self.dispatch_fns

    # ------------------------------------------------------ inference

    def _mark(self, fn: ast.AST, worklist: list) -> None:
        if id(fn) in self.host_exits:
            return  # a sanctioned host exit: the host waits here
        if id(fn) not in self._device:
            self._device.add(id(fn))
            worklist.append(fn)

    def _scope_names(self, scope: ast.AST) -> dict[str, list]:
        """Name -> [(kind, node)] for defs and single-Name-target
        assigns anywhere under `scope`, in the same statement-major
        walk order the resolver historically observed."""
        idx = self._scope_index.get(id(scope))
        if idx is None:
            idx = {}
            body = scope.body if isinstance(scope.body, list) else []
            for stmt in body:
                for node in ast.walk(stmt):
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        idx.setdefault(node.name, []).append(
                            ("def", node)
                        )
                    elif (
                        isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                    ):
                        idx.setdefault(node.targets[0].id, []).append(
                            ("alias", node)
                        )
            self._scope_index[id(scope)] = idx
        return idx

    def _resolve_callable_name(
        self, mod: ModuleInfo, at: ast.AST, name: str,
        seen: set[str] | None = None,
    ) -> list[ast.AST]:
        """Candidate def nodes a bare name may denote at `at`: local
        defs and simple aliases in enclosing scopes, module-level defs,
        then project imports."""
        seen = seen if seen is not None else set()
        if name in seen:
            return []
        seen.add(name)
        out: list[ast.AST] = []
        scopes = list(mod.enclosing_functions(at))
        for scope in scopes:
            for kind, node in self._scope_names(scope).get(name, ()):
                if kind == "def":
                    out.append(node)
                else:
                    # alias: union every name its value mentions.
                    # A name being CALLED in the value
                    # (`replay = make_replay(...)`) is a maker run
                    # at setup time: the alias denotes whatever it
                    # RETURNS, so contribute the maker's nested
                    # defs, not the maker's own host-side body.
                    called = {
                        id(c.func)
                        for c in ast.walk(node.value)
                        if isinstance(c, ast.Call)
                        and isinstance(c.func, ast.Name)
                    }
                    for sub in ast.walk(node.value):
                        if isinstance(sub, ast.Name) and isinstance(
                            sub.ctx, ast.Load
                        ):
                            hits = self._resolve_callable_name(
                                mod, at, sub.id, seen
                            )
                            if id(sub) in called:
                                for fn in hits:
                                    out.extend(
                                        s for s in ast.walk(fn)
                                        if s is not fn
                                        and isinstance(
                                            s, _FUNC_NODES
                                        )
                                    )
                            else:
                                out.extend(hits)
                        elif isinstance(sub, ast.Lambda):
                            out.append(sub)
            if out:
                return out
        if name in mod.top_defs:
            return [mod.top_defs[name]]
        target = mod.imports.get(name)
        if target and target.startswith(PROJECT_PACKAGE):
            hit = self.symbols.get(target)
            if hit:
                return [hit[1]]
        return out

    def _mark_nested(self, fn: ast.AST, worklist: list) -> None:
        """Mark the functions a maker defines (and returns): its own
        body runs once, on the host, when the closure is built."""
        for sub in ast.walk(fn):
            if sub is not fn and isinstance(sub, _FUNC_NODES):
                self._mark(sub, worklist)

    def _seed(self, worklist: list) -> None:
        for name in sorted(DEVICE_PATH_MAKERS):
            hit = (self.symbols.get(f"{PROJECT_PACKAGE}.{name}")
                   or self.methods.get(f"{PROJECT_PACKAGE}.{name}"))
            if hit:
                self._mark_nested(hit[1], worklist)
        wrapper_mods = {f"{PROJECT_PACKAGE}.{m}"
                        for m in KERNEL_WRAPPER_MODULES}
        for mod in self.modules:
            if mod.module_name in wrapper_mods:
                for fn in mod.top_defs.values():
                    if _counts_launch(fn):
                        self._mark(fn, worklist)
            for node in mod.walk():
                if not isinstance(node, ast.Call):
                    continue
                d = mod.dotted(node.func)
                if d is not None and (
                    d == f"{PROJECT_PACKAGE}.ops.encoding.Dispatch"
                    or d.endswith(".Dispatch")
                    or d == "Dispatch"
                ):
                    self._seed_dispatch(mod, node, worklist)

    def is_dispatch_write_fn(self, fn: ast.AST) -> bool:
        """Registered as a write op: the port's write transitions apply
        to their `states` argument IN PLACE, by contract
        (`ops/encoding.py`)."""
        return id(fn) in self.dispatch_write_fns

    def _seed_dispatch(
        self, mod: ModuleInfo, call: ast.Call, worklist: list
    ) -> None:
        exprs: list[tuple[ast.AST, bool]] = []
        for i in DISPATCH_FN_POSARGS:
            if i < len(call.args):
                exprs.append((call.args[i], i == DISPATCH_FN_POSARGS[0]))
        for kw in call.keywords:
            if kw.arg in DISPATCH_FN_KWARGS:
                exprs.append((kw.value, kw.arg == "write_ops"))
        for expr, is_write in exprs:
            for node in ast.walk(expr):
                fns: list[ast.AST] = []
                if isinstance(node, ast.Lambda):
                    fns = [node]
                elif isinstance(node, ast.Name) and isinstance(
                    node.ctx, ast.Load
                ):
                    fns = self._resolve_callable_name(
                        mod, expr, node.id
                    )
                for fn in fns:
                    self.dispatch_fns.add(id(fn))
                    if is_write:
                        self.dispatch_write_fns.add(id(fn))
                    self._mark(fn, worklist)

    def _infer(self) -> None:
        worklist: list = []
        self._seed(worklist)
        # propagate through the call graph: calls made inside a
        # device-path scope (by bare name or project-dotted name) mark
        # their defs
        owner: dict[int, ModuleInfo] = {}
        for mod in self.modules:
            for node in mod.walk():
                if isinstance(node, _FUNC_NODES):
                    owner[id(node)] = mod
        while worklist:
            fn = worklist.pop()
            mod = owner.get(id(fn))
            if mod is None:
                continue
            body = fn.body if isinstance(fn.body, list) else [fn.body]
            for stmt in body:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    if mod.in_cpu_route(node) or any(
                        self._handed_to_host_exit(mod, f)
                        for f in mod.enclosing_functions(node)
                        if f is not fn
                    ):
                        continue
                    if isinstance(node.func, ast.Name):
                        for cand in self._resolve_callable_name(
                            mod, node, node.func.id
                        ):
                            self._mark(cand, worklist)
                    else:
                        d = mod.dotted(node.func)
                        if d and d.startswith(PROJECT_PACKAGE):
                            hit = self.symbols.get(d)
                            if hit:
                                self._mark(hit[1], worklist)


def _counts_launch(fn: ast.AST) -> bool:
    """The body bumps a kernel's launch count (`K.launches += 1`): the
    function is a kernel wrapper."""
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Attribute)
            and node.target.attr == "launches"
        ):
            return True
    return False


def _is_cpu_route_test(test: ast.AST) -> bool:
    """`route(...) == "cpu"` (either operand order)."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)):
        return False
    sides = [test.left, test.comparators[0]]
    has_route = any(
        isinstance(x, ast.Call) and (
            (isinstance(x.func, ast.Name) and x.func.id == "route")
            or (isinstance(x.func, ast.Attribute)
                and x.func.attr == "route"))
        for x in sides)
    has_cpu = any(isinstance(x, ast.Constant) and x.value == "cpu"
                  for x in sides)
    return has_route and has_cpu
