"""nrcheck: whole-program lock-discipline analysis.

Three rules over the `astutil.Project` graph, plus two single-module
concurrency rules. The whole-program pass runs ONCE per project
(cached) and answers the two questions `nrlint`'s per-file rules
cannot:

- **guarded-by inference** (`nrcheck-guarded-by`): for every class the
  thread-role oracle marks as shared, infer which lock guards each
  `self._attr` — an attribute whose every store (outside `__init__`)
  happens under lock L is guarded by L — and flag reads outside L
  (and stores outside any lock for mixed-discipline attributes).
  Escape hatches, in declaration order of preference:
  `# guarded-by: <lock_attr>` on a `def` line (caller-holds-lock
  contract: the whole method body is an L region), `# guarded-by:`
  on an access line (this one access is known to run under L), and
  `# nrcheck: unshared` on an access line or on the attribute's
  `__init__` assignment (single-writer / racy-but-benign by design —
  the comment must say why).

- **lock-order graph** (`nrcheck-lock-order`): every nested
  acquisition — `with self._a:` inside `with self._b:`, directly or
  through calls resolved across modules — is an edge `b -> a`. A
  cycle is a potential deadlock. Graph nodes are named
  `<Class>.<attr>` / `<module_tail>.<var>`, the SAME names the
  runtime factory (`analysis/locks.py`) records, so the dynamic graph
  a `NR_TPU_LOCKCHECK=1` run dumps can be checked to be a subgraph of
  this one (`lint --check-dynamic`). `# nrcheck: lock-order A -> B`
  declares an edge the resolver cannot see (e.g. through a stored
  callback).

- **annotation hygiene** (`nrcheck-annotation`): malformed `# nrcheck:`
  / `# guarded-by:` comments, and factory construction sites whose
  name string does not match the static node name (name drift would
  silently disarm the dynamic-vs-static cross-check).

Single-module rules: `condition-wait-without-predicate-loop` (a bare
no-timeout `cond.wait()` outside a `while` misses spurious wakeups)
and `lock-held-across-blocking-call` (fsync / socket I/O / a device
sync — `torch.cuda.synchronize`, `.item()`, `.cpu()` — / `.result()`
under a held subsystem lock).

The pass is deliberately an under-approximating call resolver (typed
receivers via `__init__` assignments, parameter and return
annotations, module globals) glued to an over-approximating region
walker (a manually released lock still counts as held) — both err
toward the safe side of the dynamic-subgraph gate.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Iterator

from node_replication_torch.analysis.astutil import (
    Diagnostic,
    ModuleInfo,
    Project,
)
from node_replication_torch.analysis.rules import (
    ERROR,
    RULES,
    WARNING,
    _MUTATORS,
    _diag,
    _is_locked_method,
    _receiver_tail,
    _self_attr,
    rule,
)

# Thread-name prefix -> role. MUST mirror `obs/profile.py:
# _ROLE_PREFIXES` (the thread-name contract); a unit test asserts the
# two tables agree so the oracle cannot drift. Kept as a copy because
# the analyzer must import without the runtime deps obs/ pulls in.
ROLE_PREFIXES: tuple[tuple[str, str], ...] = (
    ("serve-worker-", "serve-worker"),
    ("serve-asm-", "serve-assembly"),
    ("serve-cpl-", "serve-completion"),
    ("serve-client-", "serve-client"),
    ("repl-shipper", "repl-shipper"),
    ("repl-relay-", "repl-relay"),
    ("repl-apply-", "repl-apply"),
    ("repl-feed-", "repl-feed"),
    ("repl-promotion-watch", "repl-promote"),
    ("fault-medic-", "fault-medic"),
    ("obs-export-", "obs-export"),
    ("obs-device-trace-", "obs-export"),
    ("obs-fleet-collector", "obs-collect"),
    ("obs-profiler", "obs-profiler"),
    ("MainThread", "main"),
)

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*(.*)$")
_NRCHECK_RE = re.compile(r"#\s*nrcheck:\s*(.*)$")
_LOCK_ORDER_RE = re.compile(
    r"^lock-order\s+([\w.]+)\s*->\s*([\w.]+)\s*(?:—.*|--.*)?$"
)
_ATTR_RE = re.compile(r"^[A-Za-z_]\w*$")

_LOCK_FACTORIES = {"make_lock", "make_rlock", "make_condition"}
_THREADING_LOCKS = {"Lock", "RLock", "Condition"}


# --------------------------------------------------------------------------
# annotations
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Annotations:
    guarded_by: dict[int, str]          # line -> lock attr name
    unshared: set[int]                  # lines carrying `nrcheck: unshared`
    lock_order: list[tuple[int, str, str]]  # declared edges
    malformed: list[tuple[int, str]]    # line, offending text


def _comment_tokens(source: str) -> list[tuple[int, str]]:
    """(line, text) for every real COMMENT token — a directive-shaped
    string inside a docstring must not count as an annotation."""
    out: list[tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(
                io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError):
        pass
    return out


def _parse_annotations(mod: ModuleInfo) -> _Annotations:
    ann = _Annotations({}, set(), [], [])
    for i, line in _comment_tokens(mod.source):
        m = _GUARDED_RE.search(line)
        if m:
            arg = m.group(1).split("—")[0].split("--")[0].strip()
            if _ATTR_RE.match(arg):
                ann.guarded_by[i] = arg
            else:
                ann.malformed.append(
                    (i, f"guarded-by wants one lock attribute name, "
                        f"got {m.group(1).strip()!r}"))
        m = _NRCHECK_RE.search(line)
        if not m:
            continue
        body = m.group(1).strip()
        if body == "unshared" or body.startswith(("unshared —",
                                                  "unshared --")):
            ann.unshared.add(i)
            continue
        lo = _LOCK_ORDER_RE.match(body)
        if lo:
            ann.lock_order.append((i, lo.group(1), lo.group(2)))
            continue
        ann.malformed.append(
            (i, f"unknown nrcheck directive {body!r} (forms: "
                f"`unshared — why`, `lock-order A -> B — why`)"))
    return ann


def _annotated(ann: _Annotations, line: int, *, unshared=False,
               guarded: str | None = None) -> bool:
    """Annotation applies on the access line or the line above (the
    same two-line scope nrlint suppressions use)."""
    for ln in (line, line - 1):
        if unshared and ln in ann.unshared:
            return True
        if guarded is not None and ann.guarded_by.get(ln) == guarded:
            return True
    return False


# --------------------------------------------------------------------------
# per-class model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _ClassInfo:
    mod: ModuleInfo
    node: ast.ClassDef
    name: str
    bases: list[str]
    methods: dict[str, ast.FunctionDef]
    lock_attrs: dict[str, str]   # attr -> lock-graph node name
    attr_types: dict[str, str]   # attr -> class name (typed receivers)
    spawns_thread: bool = False


def _ann_tail(node: ast.AST | None) -> str | None:
    """Class name out of an annotation expression (`Counter`,
    `metrics.Counter`, `"Counter"`, `Counter | None`)."""
    if node is None:
        return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(".")[-1].strip()
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _ann_tail(node.left) or _ann_tail(node.right)
    if isinstance(node, ast.Subscript):  # Optional[X]
        return _ann_tail(node.slice)
    return None


def _call_name(call: ast.Call, mod: ModuleInfo) -> str | None:
    """Dotted (via imports) or tail name of a call's callee."""
    dotted = mod.dotted(call.func)
    if dotted:
        return dotted
    return _receiver_tail(call.func)


class _Analysis:
    """The cached whole-program pass (one per `Project`)."""

    def __init__(self, project: Project):
        self.project = project
        self.mods: list[ModuleInfo] = list(project.modules)
        # thread-spawn sites: (resolved target key, role-or-None)
        self._spawn_sites: list[tuple[tuple, str | None]] = []
        self.ann: dict[str, _Annotations] = {
            m.path: _parse_annotations(m) for m in self.mods
        }
        self.classes: dict[str, _ClassInfo] = {}
        self.dup_classes: set[str] = set()
        self.subclasses: dict[str, set[str]] = {}
        # module-level lock vars: (module_name, var) -> node name
        self.module_locks: dict[tuple[str, str], str] = {}
        self.module_global_types: dict[tuple[str, str], str] = {}
        # factory-name mismatches: (mod, line, msg)
        self.name_mismatches: list[tuple[ModuleInfo, int, str]] = []
        # fn key -> list of events; key forms:
        #   ("M", class_name, method)   ("F", dotted_module_fn)
        self.events: dict[tuple, list[tuple]] = {}
        self.fn_mod: dict[tuple, ModuleInfo] = {}
        self.fn_def: dict[tuple, ast.AST] = {}
        self.direct_acquires: dict[tuple, set[str]] = {}
        self.callees: dict[tuple, set[tuple]] = {}
        self.trans_acquires: dict[tuple, set[str]] = {}
        self.dom_held: dict[tuple, frozenset[str]] = {}
        # lock-order graph
        self.edges: dict[str, set[str]] = {}
        self.edge_sites: dict[tuple[str, str], tuple[str, int]] = {}
        self.declared_edges: set[tuple[str, str]] = set()
        self.cycles: list[list[str]] = []
        # thread roles
        self.class_roles: dict[str, set[str]] = {}
        # findings / diags, grouped by module path
        self.findings: dict[str, list[Diagnostic]] = {}
        self.annot_diags: dict[str, list[Diagnostic]] = {}
        self.cycle_diags: dict[str, list[Diagnostic]] = {}

        self._collect_classes()
        self._collect_module_globals()
        self._walk_all_functions()
        self._infer_dominated_methods()
        self._summarize_acquires()
        self._build_edges()
        self._find_cycles()
        self._infer_roles()
        self._guarded_by_findings()
        self._annotation_diags()

    # ------------------------------------------------------- class table

    def _collect_classes(self):
        for mod in self.mods:
            for node in mod.tree.body:
                if not isinstance(node, ast.ClassDef):
                    continue
                if node.name in self.classes:
                    self.dup_classes.add(node.name)
                    continue
                methods = {
                    n.name: n for n in node.body
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                }
                bases = [b for b in
                         (_receiver_tail(x) for x in node.bases) if b]
                self.classes[node.name] = _ClassInfo(
                    mod, node, node.name, bases, methods, {}, {})
        for ci in self.classes.values():
            for b in ci.bases:
                self.subclasses.setdefault(b, set()).add(ci.name)
        for ci in self.classes.values():
            self._collect_class_attrs(ci)

    def _all_subclasses(self, name: str) -> set[str]:
        out, frontier = set(), [name]
        while frontier:
            n = frontier.pop()
            for s in self.subclasses.get(n, ()):
                if s not in out:
                    out.add(s)
                    frontier.append(s)
        return out

    def _lock_ctor_kind(self, call: ast.Call,
                        mod: ModuleInfo) -> str | None:
        name = _call_name(call, mod)
        if not name:
            return None
        tail = name.split(".")[-1]
        if tail in _THREADING_LOCKS and (
            "." not in name or name.startswith("threading.")
        ):
            return tail
        if tail in _LOCK_FACTORIES:
            return tail
        return None

    def _collect_class_attrs(self, ci: _ClassInfo):
        # two passes: Condition(self._lock) aliases may reference an
        # attr assigned on a later line
        targets: list[tuple[str, ast.Call, int]] = []
        # one walk of the class node covers class-level assignments
        # AND method bodies (walking methods separately would collect
        # every method-body assignment twice)
        for scope in [ci.node.body]:
            for stmt in ast.walk(ast.Module(body=scope,
                                            type_ignores=[])):
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                tgts = (stmt.targets if isinstance(stmt, ast.Assign)
                        else [stmt.target])
                val = stmt.value
                for t in tgts:
                    attr = _self_attr(t)
                    if attr is None and isinstance(t, ast.Name):
                        attr = t.id  # class-level assignment
                    if attr is None or val is None:
                        continue
                    if isinstance(val, ast.Call):
                        kind = self._lock_ctor_kind(val, ci.mod)
                        if kind:
                            targets.append((attr, val, stmt.lineno))
                            continue
                        tname = self._call_type(ci.mod, ci, val, {})
                        if tname:
                            ci.attr_types.setdefault(attr, tname)
        for attr, call, lineno in targets:
            ci.lock_attrs.setdefault(
                attr, f"{ci.name}.{attr}")
        # alias + factory-name checks need lock_attrs complete
        for attr, call, lineno in targets:
            kind = self._lock_ctor_kind(call, ci.mod)
            alias_of = None
            if kind in ("Condition", "make_condition"):
                lock_arg = None
                if kind == "Condition" and call.args:
                    lock_arg = call.args[0]
                for kw in call.keywords:
                    if kw.arg == "lock":
                        lock_arg = kw.value
                la = _self_attr(lock_arg) if lock_arg is not None \
                    else None
                if la and la in ci.lock_attrs:
                    alias_of = ci.lock_attrs[la]
            if alias_of:
                ci.lock_attrs[attr] = alias_of
            if kind in _LOCK_FACTORIES:
                want = ci.lock_attrs[attr]
                got = (call.args[0].value
                       if call.args
                       and isinstance(call.args[0], ast.Constant)
                       else None)
                if got != want:
                    self.name_mismatches.append((
                        ci.mod, lineno,
                        f"{kind}({got!r}) assigned to "
                        f"{ci.name}.{attr}: the lock name must be "
                        f"{want!r} to match the static lock-order "
                        f"graph node",
                    ))

    def _collect_module_globals(self):
        for mod in self.mods:
            tail = mod.module_name.split(".")[-1]
            for stmt in mod.tree.body:
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                tgts = (stmt.targets if isinstance(stmt, ast.Assign)
                        else [stmt.target])
                val = stmt.value
                if val is None or not isinstance(val, ast.Call):
                    if isinstance(stmt, ast.AnnAssign) and isinstance(
                            stmt.target, ast.Name):
                        t = _ann_tail(stmt.annotation)
                        if t in self.classes:
                            self.module_global_types[
                                (mod.module_name, stmt.target.id)] = t
                    continue
                for t in tgts:
                    if not isinstance(t, ast.Name):
                        continue
                    kind = self._lock_ctor_kind(val, mod)
                    if kind:
                        node = f"{tail}.{t.id}"
                        self.module_locks[
                            (mod.module_name, t.id)] = node
                        if kind in _LOCK_FACTORIES:
                            got = (val.args[0].value
                                   if val.args and isinstance(
                                       val.args[0], ast.Constant)
                                   else None)
                            if got != node:
                                self.name_mismatches.append((
                                    mod, stmt.lineno,
                                    f"{kind}({got!r}) assigned to "
                                    f"module var {t.id}: name must "
                                    f"be {node!r}"))
                    else:
                        tname = self._call_type(mod, None, val, {})
                        if tname:
                            self.module_global_types.setdefault(
                                (mod.module_name, t.id), tname)

    # ---------------------------------------------------- type inference

    def _resolve_def(self, mod: ModuleInfo,
                     call: ast.Call) -> ast.AST | None:
        """A call's target def when it is a plain module function
        (local or imported project symbol)."""
        f = call.func
        if isinstance(f, ast.Name) and f.id in mod.top_defs:
            return mod.top_defs[f.id]
        dotted = mod.dotted(f)
        if dotted and dotted in self.project.symbols:
            _, node = self.project.symbols[dotted]
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                return node
        return None

    def _call_type(self, mod: ModuleInfo, ci: _ClassInfo | None,
                   call: ast.Call, local_types: dict) -> str | None:
        """Class name a call evaluates to: a constructor, or a
        function/method with a class-valued return annotation."""
        f = call.func
        tail = _receiver_tail(f)
        if tail in self.classes and tail not in self.dup_classes:
            if isinstance(f, ast.Name) or (
                isinstance(f, ast.Attribute)
                and not isinstance(f.value, ast.Call)
            ):
                return tail
        d = self._resolve_def(mod, call)
        if d is not None:
            t = _ann_tail(d.returns)
            if t in self.classes:
                return t
        # method call with annotated return: type the receiver first
        if isinstance(f, ast.Attribute):
            rtype = self._type_of(mod, ci, f.value, local_types)
            if rtype:
                for key in self._method_keys(rtype, f.attr):
                    mdef = self.classes[key[1]].methods[key[2]]
                    t = _ann_tail(mdef.returns)
                    if t in self.classes:
                        return t
        return None

    def _type_of(self, mod: ModuleInfo, ci: _ClassInfo | None,
                 expr: ast.AST, local_types: dict) -> str | None:
        if isinstance(expr, ast.Name):
            if expr.id in local_types:
                return local_types[expr.id]
            if expr.id == "self" and ci is not None:
                return ci.name
            return self.module_global_types.get(
                (mod.module_name, expr.id))
        attr = _self_attr(expr)
        if attr and ci is not None:
            return ci.attr_types.get(attr)
        if isinstance(expr, ast.Call):
            return self._call_type(mod, ci, expr, local_types)
        return None

    def _local_types(self, mod: ModuleInfo, ci: _ClassInfo | None,
                     fn: ast.AST) -> dict[str, str]:
        out: dict[str, str] = {}
        args = getattr(fn, "args", None)
        if args is not None:
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                t = _ann_tail(a.annotation)
                if t in self.classes:
                    out[a.arg] = t
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                t = self._type_of(mod, ci, node.value, out)
                if t:
                    out[node.targets[0].id] = t
        return out

    # ------------------------------------------------------ call targets

    def _method_keys(self, cls_name: str,
                     mname: str) -> list[tuple]:
        """Resolved method keys for `obj.m()` where type(obj) is
        `cls_name`: the inherited definition plus every subclass
        override (virtual dispatch — the acquire summary must cover
        whichever implementation runs)."""
        out: list[tuple] = []
        seen: set[str] = set()
        c: str | None = cls_name
        while c in self.classes and c not in seen:
            seen.add(c)
            if mname in self.classes[c].methods:
                out.append(("M", c, mname))
                break
            bases = self.classes[c].bases
            c = bases[0] if bases else None
        for s in self._all_subclasses(cls_name):
            if s in self.classes and mname in self.classes[s].methods:
                key = ("M", s, mname)
                if key not in out:
                    out.append(key)
        return out

    def _resolve_call(self, mod: ModuleInfo, ci: _ClassInfo | None,
                      call: ast.Call,
                      local_types: dict) -> list[tuple]:
        f = call.func
        if isinstance(f, ast.Attribute):
            rtype = self._type_of(mod, ci, f.value, local_types)
            if rtype:
                return self._method_keys(rtype, f.attr)
            return []
        if isinstance(f, ast.Name):
            if f.id in mod.top_defs:
                return [("F", f"{mod.module_name}.{f.id}")]
            dotted = mod.dotted(f)
            if dotted and dotted in self.project.symbols:
                sm, node = self.project.symbols[dotted]
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    return [("F", dotted)]
        return []

    def _lock_node_of(self, mod: ModuleInfo, ci: _ClassInfo | None,
                      expr: ast.AST, local_types: dict) -> str | None:
        attr = _self_attr(expr)
        if attr and ci is not None and attr in ci.lock_attrs:
            return ci.lock_attrs[attr]
        if isinstance(expr, ast.Attribute):
            rtype = self._type_of(mod, ci, expr.value, local_types)
            if rtype in self.classes:
                return self.classes[rtype].lock_attrs.get(expr.attr)
        if isinstance(expr, ast.Name):
            node = self.module_locks.get((mod.module_name, expr.id))
            if node:
                return node
            t = local_types.get(expr.id)
            # `lk = self._lock` style aliases are not tracked; a lock
            # attr typed as its own class never occurs
        return None

    # ----------------------------------------------------- event walker

    def _walk_all_functions(self):
        for mod in self.mods:
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    key = ("F", f"{mod.module_name}.{node.name}")
                    self._walk_fn(mod, None, key, node)
                elif isinstance(node, ast.ClassDef) and \
                        node.name in self.classes and \
                        node.name not in self.dup_classes:
                    ci = self.classes[node.name]
                    for mname, mdef in ci.methods.items():
                        self._walk_fn(mod, ci, ("M", ci.name, mname),
                                      mdef)

    def _walk_fn(self, mod: ModuleInfo, ci: _ClassInfo | None,
                 key: tuple, fn: ast.AST):
        ann = self.ann[mod.path]
        local_types = self._local_types(mod, ci, fn)
        initial: list[str] = []
        if ci is not None and _is_locked_method(fn) and \
                "_lock" in ci.lock_attrs:
            initial.append(ci.lock_attrs["_lock"])
        g = ann.guarded_by.get(fn.lineno) or \
            ann.guarded_by.get(fn.lineno - 1)
        if g is None:
            for dec in getattr(fn, "decorator_list", []):
                g = ann.guarded_by.get(dec.lineno) or g
        if g and ci is not None and g in ci.lock_attrs:
            initial.append(ci.lock_attrs[g])
        events: list[tuple] = []

        def visit(node: ast.AST, held: tuple[str, ...]):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                cur = held
                for item in node.items:
                    ln = self._lock_node_of(mod, ci, item.context_expr,
                                            local_types)
                    if ln is not None:
                        events.append(("acq", ln, cur,
                                       item.context_expr.lineno,
                                       item.context_expr.col_offset))
                        if ln not in cur:
                            cur = cur + (ln,)
                    else:
                        visit(item.context_expr, cur)
                    if item.optional_vars is not None:
                        visit(item.optional_vars, cur)
                for stmt in node.body:
                    visit(stmt, cur)
                return
            if isinstance(node, ast.Call):
                keys = self._resolve_call(mod, ci, node, local_types)
                if keys:
                    events.append(("call", tuple(keys), held,
                                   node.lineno, node.col_offset))
                # detect thread spawns for the role oracle
                cname = _call_name(node, mod) or ""
                if cname.split(".")[-1] == "Thread":
                    self._note_spawn(mod, ci, node, local_types)
            if isinstance(node, ast.Attribute):
                attr = _self_attr(node)
                if attr is not None and ci is not None:
                    store = self._is_store(mod, node)
                    events.append(("access", attr, store, held,
                                   node.lineno, node.col_offset))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                # a nested def's body does not run at definition point;
                # analyzed separately only if it is a top-level symbol
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, tuple(initial))
        self.events[key] = events
        self.fn_mod[key] = mod
        self.fn_def[key] = fn

    def _is_store(self, mod: ModuleInfo, node: ast.Attribute) -> bool:
        if isinstance(node.ctx, ast.Store):
            return True
        parent = mod.parent(node)
        if (isinstance(parent, ast.Subscript) and parent.value is node
                and isinstance(parent.ctx, ast.Store)):
            return True
        if (isinstance(parent, ast.Attribute)
                and parent.value is node
                and isinstance(parent.ctx, ast.Store)):
            return True
        # mutator method call: self.x.append(...) mutates self.x
        if (isinstance(parent, ast.Attribute) and parent.value is node
                and parent.attr in _MUTATORS):
            gp = mod.parent(parent)
            if isinstance(gp, ast.Call) and gp.func is parent:
                return True
        return False

    # ------------------------------------------------------ thread roles

    def _note_spawn(self, mod: ModuleInfo, ci: _ClassInfo | None,
                    call: ast.Call, local_types: dict):
        if ci is not None:
            ci.spawns_thread = True
        target_keys: list[tuple] = []
        tname: str | None = None
        for kw in call.keywords:
            if kw.arg == "target":
                v = kw.value
                attr = _self_attr(v)
                if attr and ci is not None and attr in ci.methods:
                    target_keys = [("M", ci.name, attr)]
                elif isinstance(v, ast.Attribute):
                    rtype = self._type_of(mod, ci, v.value, local_types)
                    if rtype:
                        target_keys = self._method_keys(rtype, v.attr)
                elif isinstance(v, ast.Name):
                    if v.id in mod.top_defs:
                        target_keys = [
                            ("F", f"{mod.module_name}.{v.id}")]
            elif kw.arg == "name":
                v = kw.value
                if isinstance(v, ast.Constant) and isinstance(
                        v.value, str):
                    tname = v.value
                elif isinstance(v, ast.JoinedStr) and v.values and \
                        isinstance(v.values[0], ast.Constant):
                    tname = str(v.values[0].value)
        role = None
        if tname:
            for prefix, r in ROLE_PREFIXES:
                if tname.startswith(prefix):
                    role = r
                    break
        for k in target_keys:
            self._spawn_sites.append((k, role))

    def _infer_roles(self):
        reached: dict[tuple, set[str]] = {}
        frontier = []
        for key, role in self._spawn_sites:
            r = role or "worker"
            if r not in reached.setdefault(key, set()):
                reached[key].add(r)
                frontier.append((key, r))
        while frontier:
            key, r = frontier.pop()
            for callee in self.callees.get(key, ()):
                if r not in reached.setdefault(callee, set()):
                    reached[callee].add(r)
                    frontier.append((callee, r))
        for key, roles in reached.items():
            if key[0] == "M":
                self.class_roles.setdefault(key[1], set()).update(roles)

    def _class_is_shared(self, ci: _ClassInfo) -> bool:
        """Spawns a thread itself, or a worker role reaches one of its
        methods (the main thread reaches everything, so one worker
        role means two roles can interleave on the instance)."""
        return ci.spawns_thread or bool(self.class_roles.get(ci.name))

    # ------------------------------------------------- dominance fixpoint

    def _non_call_refs(self) -> set[str]:
        """Method names referenced as bare attributes (callbacks,
        thread targets): their bodies can run from anywhere, so
        call-site lock dominance must not apply to them."""
        out: set[str] = set()
        for mod in self.mods:
            for node in mod.walk():
                if not isinstance(node, ast.Attribute):
                    continue
                parent = mod.parent(node)
                if isinstance(parent, ast.Call) and \
                        parent.func is node:
                    continue
                out.add(node.attr)
        return out

    def _infer_dominated_methods(self):
        """A private method whose EVERY resolved call site runs with
        lock L held is itself an L region (`frontend._store_replica`
        idiom: helpers factored out of a critical section)."""
        escaped = self._non_call_refs()
        # call sites per method key: (caller_key, held)
        sites: dict[tuple, list[tuple[tuple, tuple]]] = {}
        for caller, events in self.events.items():
            for ev in events:
                if ev[0] != "call":
                    continue
                for k in ev[1]:
                    sites.setdefault(k, []).append((caller, ev[2]))
        eligible = [
            ("M", ci.name, m)
            for ci in self.classes.values()
            for m in ci.methods
            if m.startswith("_") and not m.startswith("__")
            and m not in escaped and not _is_locked_method(
                ci.methods[m])
        ]
        changed = True
        while changed:
            changed = False
            for key in eligible:
                ss = sites.get(key)
                if not ss:
                    continue
                inter: set[str] | None = None
                for caller, held in ss:
                    h = set(held) | set(self.dom_held.get(
                        caller, frozenset()))
                    inter = h if inter is None else (inter & h)
                new = frozenset(inter or ())
                if new != self.dom_held.get(key, frozenset()):
                    self.dom_held[key] = new
                    changed = True

    def _held_at(self, key: tuple, held: tuple[str, ...]) -> set[str]:
        return set(held) | set(self.dom_held.get(key, frozenset()))

    # ------------------------------------------------------- lock order

    def _summarize_acquires(self):
        for key, events in self.events.items():
            acq, callees = set(), set()
            for ev in events:
                if ev[0] == "acq":
                    acq.add(ev[1])
                elif ev[0] == "call":
                    callees.update(ev[1])
            self.direct_acquires[key] = acq
            self.callees[key] = callees
        self.trans_acquires = {
            k: set(v) for k, v in self.direct_acquires.items()
        }
        changed = True
        while changed:
            changed = False
            for key, cs in self.callees.items():
                mine = self.trans_acquires[key]
                before = len(mine)
                for c in cs:
                    mine |= self.trans_acquires.get(c, set())
                if len(mine) != before:
                    changed = True

    def _add_edge(self, a: str, b: str, path: str, line: int):
        if a == b:
            return
        if b not in self.edges.setdefault(a, set()):
            self.edges[a].add(b)
            self.edge_sites[(a, b)] = (path, line)

    def _build_edges(self):
        for key, events in self.events.items():
            mod = self.fn_mod[key]
            for ev in events:
                if ev[0] == "acq":
                    _, node, held, line, _col = ev
                    for h in self._held_at(key, held):
                        self._add_edge(h, node, mod.path, line)
                elif ev[0] == "call":
                    _, keys, held, line, _col = ev
                    hset = self._held_at(key, held)
                    if not hset:
                        continue
                    targets: set[str] = set()
                    for k in keys:
                        targets |= self.trans_acquires.get(k, set())
                    for h in hset:
                        for t in targets:
                            self._add_edge(h, t, mod.path, line)
        for mod in self.mods:
            for line, a, b in self.ann[mod.path].lock_order:
                self.declared_edges.add((a, b))
                self._add_edge(a, b, mod.path, line)

    def _find_cycles(self):
        # Tarjan SCC, iterative
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on: set[str] = set()
        stack: list[str] = []
        counter = [0]
        sccs: list[list[str]] = []
        nodes = set(self.edges) | {
            b for bs in self.edges.values() for b in bs}

        for root in sorted(nodes):
            if root in index:
                continue
            work = [(root, iter(sorted(self.edges.get(root, ()))))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on.add(w)
                        work.append(
                            (w, iter(sorted(self.edges.get(w, ())))))
                        advanced = True
                        break
                    elif w in on:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    if len(comp) > 1:
                        sccs.append(sorted(comp))
        for comp in sccs:
            cyc = self._cycle_path(comp)
            self.cycles.append(cyc)
            # anchor the diagnostic at the first edge of the cycle
            # that has a known site
            site = None
            for a, b in zip(cyc, cyc[1:] + cyc[:1]):
                site = self.edge_sites.get((a, b))
                if site:
                    break
            path, line = site if site else (self.mods[0].path, 1)
            self.cycle_diags.setdefault(path, []).append(Diagnostic(
                path=path, line=line, col=1,
                rule_id="nrcheck-lock-order",
                severity=RULES["nrcheck-lock-order"].severity,
                message=(
                    "lock-order cycle (potential deadlock): "
                    + " -> ".join(cyc + [cyc[0]])
                    + " — break the cycle or restructure so one "
                      "order is global"
                ),
            ))

    def _cycle_path(self, comp: list[str]) -> list[str]:
        comp_set = set(comp)
        start = comp[0]
        # BFS back to start constrained to the SCC
        prev: dict[str, str] = {}
        frontier = [start]
        seen = {start}
        while frontier:
            nxt = []
            for n in frontier:
                for m in sorted(self.edges.get(n, ())):
                    if m == start:
                        path = [n]
                        while path[-1] != start:
                            path.append(prev[path[-1]])
                        return list(reversed(path))
                    if m in comp_set and m not in seen:
                        seen.add(m)
                        prev[m] = n
                        nxt.append(m)
            frontier = nxt
        return comp

    # ------------------------------------------------ guarded-by findings

    def _guarded_by_findings(self):
        for ci in self.classes.values():
            if not ci.lock_attrs or not self._class_is_shared(ci):
                continue
            ann = self.ann[ci.mod.path]
            # per-attr access sites across the class's methods
            stores: dict[str, list[tuple]] = {}
            reads: dict[str, list[tuple]] = {}
            unshared_attrs: set[str] = set()
            for mname, mdef in ci.methods.items():
                key = ("M", ci.name, mname)
                for ev in self.events.get(key, ()):
                    if ev[0] != "access":
                        continue
                    _, attr, is_store, held, line, col = ev
                    if attr in ci.lock_attrs:
                        continue
                    if mname == "__init__":
                        if is_store and _annotated(ann, line,
                                                   unshared=True):
                            unshared_attrs.add(attr)
                        continue
                    h = self._held_at(key, held)
                    site = (mname, h, line, col)
                    (stores if is_store else reads).setdefault(
                        attr, []).append(site)
            roles = sorted(self.class_roles.get(ci.name, set()))
            role_note = (
                f" (reached by thread role(s): {', '.join(roles)})"
                if roles else ""
            )
            for attr, ss in sorted(stores.items()):
                if attr in unshared_attrs:
                    continue
                union_g: set[str] = set()
                inter_g: set[str] | None = None
                for _m, h, _l, _c in ss:
                    union_g |= h
                    inter_g = set(h) if inter_g is None else (
                        inter_g & h)
                if not union_g:
                    continue  # never written under any lock: unshared
                              # by inference (single-writer / config)
                own = {n for n in (inter_g or set())}
                if own:
                    lock = sorted(own)[0]
                    lock_attr = lock.split(".")[-1]
                    for _m, h, line, col in sorted(
                            reads.get(attr, []),
                            key=lambda s: (s[2], s[3])):
                        if h & own:
                            continue
                        if _annotated(ann, line, unshared=True) or \
                                _annotated(ann, line,
                                           guarded=lock_attr):
                            continue
                        self.findings.setdefault(
                            ci.mod.path, []).append(Diagnostic(
                                path=ci.mod.path, line=line, col=col+1,
                                rule_id="nrcheck-guarded-by",
                                severity=RULES[
                                    "nrcheck-guarded-by"].severity,
                                message=(
                                    f"{ci.name}.{attr} is guarded by "
                                    f"{lock} (every store holds it) "
                                    f"but this read runs outside the "
                                    f"lock{role_note} — take the "
                                    f"lock, or annotate `# nrcheck: "
                                    f"unshared — why` / `# guarded-"
                                    f"by: {lock_attr}`"
                                ),
                            ))
                else:
                    # mixed discipline: stores both inside and outside
                    for _m, h, line, col in sorted(
                            ss, key=lambda s: (s[2], s[3])):
                        if h:
                            continue
                        if _annotated(ann, line, unshared=True):
                            continue
                        locks = ", ".join(sorted(union_g))
                        self.findings.setdefault(
                            ci.mod.path, []).append(Diagnostic(
                                path=ci.mod.path, line=line, col=col+1,
                                rule_id="nrcheck-guarded-by",
                                severity=RULES[
                                    "nrcheck-guarded-by"].severity,
                                message=(
                                    f"{ci.name}.{attr} is written "
                                    f"under {locks} elsewhere but "
                                    f"written here with no lock held"
                                    f"{role_note} — inconsistent "
                                    f"guard discipline"
                                ),
                            ))

    # -------------------------------------------------- annotation diags

    def _annotation_diags(self):
        for mod in self.mods:
            ann = self.ann[mod.path]
            out = self.annot_diags.setdefault(mod.path, [])
            for line, msg in ann.malformed:
                out.append(Diagnostic(
                    path=mod.path, line=line, col=1,
                    rule_id="nrcheck-annotation",
                    severity=RULES["nrcheck-annotation"].severity,
                    message=msg))
        for mod, line, msg in self.name_mismatches:
            self.annot_diags.setdefault(mod.path, []).append(
                Diagnostic(
                    path=mod.path, line=line, col=1,
                    rule_id="nrcheck-annotation",
                    severity=RULES["nrcheck-annotation"].severity,
                    message=msg))

    # ---------------------------------------------------------- exports

    def edge_list(self) -> list[list[str]]:
        return sorted(
            [a, b] for a, bs in self.edges.items() for b in bs)

    def graph_json(self) -> dict:
        nodes = set(self.edges) | {
            b for bs in self.edges.values() for b in bs}
        for ci in self.classes.values():
            nodes.update(ci.lock_attrs.values())
        nodes.update(self.module_locks.values())
        return {
            "nodes": sorted(nodes),
            "edges": self.edge_list(),
            "cycles": self.cycles,
        }

    def check_dynamic(self, dynamic_edges) -> list[str]:
        """Violations in a runtime lockgraph dump: every observed edge
        must already be in the static graph."""
        static = {(a, b) for a, bs in self.edges.items() for b in bs}
        out = []
        for e in dynamic_edges:
            a, b = e[0], e[1]
            if (a, b) not in static:
                out.append(
                    f"dynamic lock-order edge {a} -> {b} is missing "
                    f"from the static graph (the analyzer cannot see "
                    f"this nesting — fix the resolver or declare "
                    f"`# nrcheck: lock-order {a} -> {b} — why`)")
        return out


def analyze(project: Project) -> _Analysis:
    """The cached whole-program pass for `project`."""
    cached = getattr(project, "_nrcheck_analysis", None)
    if cached is None:
        cached = _Analysis(project)
        project._nrcheck_analysis = cached
    return cached


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------


@rule(
    "nrcheck-guarded-by", ERROR,
    "shared attribute accessed outside its inferred guarding lock",
)
def nrcheck_guarded_by(mod: ModuleInfo,
                       project: Project) -> Iterator[Diagnostic]:
    """Whole-program guarded-by inference (module docstring): in every
    thread-shared class, an attribute whose stores all hold lock L is
    guarded by L; reads outside L (and stores outside any lock for
    mixed-discipline attributes) are flagged. `# guarded-by:` /
    `# nrcheck: unshared` annotations are the reviewed escape hatch."""
    yield from analyze(project).findings.get(mod.path, [])


@rule(
    "nrcheck-lock-order", ERROR,
    "cycle in the global lock-order graph (potential deadlock)",
)
def nrcheck_lock_order(mod: ModuleInfo,
                       project: Project) -> Iterator[Diagnostic]:
    """Nested acquisitions — direct `with` nesting and nestings
    reached through resolved calls — form the global lock-order
    graph; a cycle means two threads can deadlock under some
    schedule. The runtime twin (`analysis/locks.py`) fails fast on
    the same condition dynamically."""
    yield from analyze(project).cycle_diags.get(mod.path, [])


@rule(
    "nrcheck-annotation", WARNING,
    "malformed nrcheck annotation or lock-factory name drift",
)
def nrcheck_annotation(mod: ModuleInfo,
                       project: Project) -> Iterator[Diagnostic]:
    """A typo'd `# nrcheck:` / `# guarded-by:` comment silently
    disarms the analysis, and a `make_lock` name that drifts from the
    static node name silently disarms the dynamic-vs-static subgraph
    gate — both are diagnosed."""
    yield from analyze(project).annot_diags.get(mod.path, [])


@rule(
    "condition-wait-without-predicate-loop", WARNING,
    "bare no-timeout condition wait outside a while loop",
)
def condition_wait_without_predicate_loop(
        mod: ModuleInfo, project: Project) -> Iterator[Diagnostic]:
    """`Condition.wait()` can wake spuriously; without a timeout the
    ONLY correct shape is `while not predicate: cond.wait()` — a bare
    `if`-guarded or unguarded wait can hang or proceed on a stale
    predicate. Timed waits (`wait(t)` / `clock.wait(cond, t)`) are a
    pacing idiom and exempt (the caller re-checks on a schedule)."""
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr == "wait"):
            continue
        if node.keywords:
            continue
        recv_tail = _receiver_tail(f.value) or ""
        condish = "cond" in recv_tail.lower()
        if len(node.args) == 0 and condish:
            pass  # bare cond.wait()
        elif len(node.args) == 1 and not condish and \
                "cond" in (_receiver_tail(node.args[0]) or "").lower():
            pass  # clock.wait(cond) with no timeout
        else:
            continue
        cur = mod.parent(node)
        in_while = False
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                      ast.Lambda)):
            if isinstance(cur, ast.While):
                in_while = True
                break
            cur = mod.parent(cur)
        if not in_while:
            yield _diag(
                mod, node, "condition-wait-without-predicate-loop",
                "no-timeout condition wait outside a `while "
                "predicate` loop: a spurious wakeup (or a missed "
                "notify before the wait) hangs or proceeds on a "
                "stale predicate — wrap in `while not <predicate>:`",
            )


_BLOCKING_METHOD_TAILS = {
    "sendall": "socket send",
    "sendto": "socket send",
    "recv": "socket receive",
    "recvfrom": "socket receive",
    "recv_into": "socket receive",
    "accept": "socket accept",
    "item": "device sync",
    "cpu": "device sync",
    "result": "future wait",
}
_BLOCKING_FUNC_DOTTED = {
    "os.fsync": "fsync",
    "torch.cuda.synchronize": "device sync",
}


@rule(
    "lock-held-across-blocking-call", WARNING,
    "blocking I/O or device sync under a held subsystem lock",
)
def lock_held_across_blocking_call(
        mod: ModuleInfo, project: Project) -> Iterator[Diagnostic]:
    """A socket round-trip, an fsync, a device sync
    (`torch.cuda.synchronize()`, `.item()`, `.cpu()`: the host waits
    for every kernel queued on the card), or a future wait under a
    held lock stalls every thread queued on that
    lock for the full I/O latency (and a future wait can deadlock
    outright if resolving it needs the same lock). Hoist the blocking
    call out of the critical section; the WAL's group-commit fsync is
    the one sanctioned exception and carries a justified
    suppression."""
    lockish = re.compile(r"(_lock|_cond|_mu)$")

    def lock_regions(fn):
        regions = []
        if _is_locked_method(fn):
            regions.append(fn)
        for node in mod.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr and lockish.search(attr):
                        regions.append(node)
        return regions

    for fn in mod.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        regions = lock_regions(fn)
        if not regions:
            continue
        region_ids = {id(r) for r in regions}
        for node in mod.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            what = None
            f = node.func
            dotted = mod.dotted(f)
            if dotted in _BLOCKING_FUNC_DOTTED:
                what = _BLOCKING_FUNC_DOTTED[dotted]
            elif isinstance(f, ast.Attribute) and \
                    f.attr in _BLOCKING_METHOD_TAILS:
                # skip module-qualified calls (`sqlite3.connect`
                # style): only instance methods block a held lock
                if not (isinstance(f.value, ast.Name)
                        and f.value.id in mod.imports):
                    what = _BLOCKING_METHOD_TAILS[f.attr]
            if what is None:
                continue
            cur = mod.parent(node)
            inside = _is_locked_method(fn)
            while cur is not None and cur is not fn:
                if id(cur) in region_ids:
                    inside = True
                    break
                cur = mod.parent(cur)
            if inside:
                yield _diag(
                    mod, node, "lock-held-across-blocking-call",
                    f"{what} ({ast.unparse(f)}) inside a held-lock "
                    f"region: every thread queued on the lock stalls "
                    f"for the full call — hoist it out of the "
                    f"critical section",
                )
