"""nrlint engine + CLI.

    python -m node_replication_torch.analysis.lint <paths> [options]

Parses every `.py` under the given paths, builds the project-wide
context (device-path closure, Dispatch registrations — `astutil.py`),
runs every registered rule (`rules.py`, `concurrency.py`), and prints
`file:line:col: rule-id severity: message` diagnostics.

Exit status: 0 when no unsuppressed diagnostic at or above
`--min-severity` (default `warning`) remains, 1 otherwise — the CI
gate. Suppressions (`# nrlint: disable=<rule>[,<rule>]` on the
diagnostic's line or the line directly above) keep the diagnostic
visible with `--show-suppressed` but never fail the run; a suppression
naming an unknown rule id is itself a `unknown-suppression` warning so
typos cannot disarm the gate.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Iterable

from node_replication_torch.analysis.astutil import (
    Diagnostic,
    ModuleInfo,
    Project,
)
from node_replication_torch.analysis.rules import (
    RULES,
    SEVERITY_ORDER,
    WARNING,
)
from node_replication_torch.analysis import concurrency  # registers the
#   nrcheck-* and concurrency rules as an import side effect


def collect_files(paths: Iterable[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if not d.startswith(".") and d != "__pycache__"
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
    return out


def _suppressed_by(mod: ModuleInfo, diag: Diagnostic) -> bool:
    for line in (diag.line, diag.line - 1):
        rules = mod.suppressions.get(line)
        if rules and diag.rule_id in rules:
            return True
    return False


def build_project(
    paths: Iterable[str],
) -> tuple[list[ModuleInfo], Project, list[str]]:
    """Parse every file under `paths` into one analyzable Project."""
    errors: list[str] = []
    modules: list[ModuleInfo] = []
    for path in collect_files(paths):
        try:
            modules.append(ModuleInfo(path))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{path}: {e}")
    return modules, Project(modules), errors


def run_lint(
    paths: Iterable[str],
    select: set[str] | None = None,
    project: Project | None = None,
) -> tuple[list[Diagnostic], list[str]]:
    """Run every (or the selected) rule over `paths`.

    Returns `(diagnostics, errors)`: diagnostics carry a `suppressed`
    flag already resolved against the source comments; `errors` are
    files that failed to parse (themselves a gate failure).
    """
    if project is None:
        modules, project, errors = build_project(paths)
    else:
        modules, errors = project.modules, []
    diags: list[Diagnostic] = []
    for mod in modules:
        for rule in RULES.values():
            if select and rule.id not in select:
                continue
            for d in rule.check(mod, project):
                d.suppressed = _suppressed_by(mod, d)
                diags.append(d)
        # meta-checks: a typo'd suppression must never silently disarm
        # the gate — unknown rule names and malformed suppression
        # comments are both diagnosed
        for line, names in sorted(mod.suppressions.items()):
            for name in sorted(names):
                if name not in RULES:
                    diags.append(Diagnostic(
                        path=mod.path, line=line, col=1,
                        rule_id="unknown-suppression",
                        severity=WARNING,
                        message=(
                            f"suppression names unknown rule "
                            f"{name!r} (known: "
                            f"{', '.join(sorted(RULES))})"
                        ),
                    ))
        for line in mod.malformed_suppressions:
            diags.append(Diagnostic(
                path=mod.path, line=line, col=1,
                rule_id="unknown-suppression",
                severity=WARNING,
                message=(
                    "malformed nrlint comment (suppresses nothing); "
                    "the only recognized form is "
                    "`# nrlint: disable=<rule>[,<rule>]`"
                ),
            ))
    diags.sort(key=lambda d: (d.path, d.line, d.col, d.rule_id))
    return diags, errors


_SUPPRESS_LINE_RE = re.compile(
    r"#\s*nrlint:\s*disable\s*=\s*"
    r"([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)(.*)$"
)


def audit_suppressions(paths: Iterable[str]) -> int:
    """`--suppressions`: list every `# nrlint: disable=` with file:line,
    flag STALE entries (the named rule no longer fires on the covered
    lines) and UNJUSTIFIED entries (no trailing `— why` text and no
    explanatory comment on the line above). Exit 1 when either class
    is non-empty — a suppression must stay load-bearing and reviewed.
    """
    files = collect_files(paths)
    diags, errors = run_lint(files)
    for e in errors:
        print(f"parse error: {e}")
    # every diagnostic (suppressed or not) a rule produced, keyed so a
    # suppression at line L is "used" by a firing at L or L+1
    fired: set[tuple[str, str, int]] = set()
    for d in diags:
        fired.add((d.path, d.rule_id, d.line))
    n_stale = n_unjust = n_total = 0
    for path in files:
        try:
            with open(path, encoding="utf-8") as fh:
                lines = fh.read().splitlines()
        except OSError:
            continue
        for i, text in enumerate(lines, start=1):
            m = _SUPPRESS_LINE_RE.search(text)
            if not m:
                continue
            ids = [s.strip() for s in m.group(1).split(",")]
            trailing = m.group(2).strip(" -—:\t")
            above = lines[i - 2].strip() if i >= 2 else ""
            justified = bool(trailing) or (
                above.startswith("#")
                and not _SUPPRESS_LINE_RE.search(above)
            )
            for rid in ids:
                n_total += 1
                notes = []
                if rid in RULES and not (
                    (path, rid, i) in fired or (path, rid, i + 1) in fired
                ):
                    notes.append("STALE: rule no longer fires here")
                    n_stale += 1
                if not justified:
                    notes.append(
                        "UNJUSTIFIED: add `— why` or a comment above")
                    n_unjust += 1
                note = f"  [{'; '.join(notes)}]" if notes else ""
                print(f"{path}:{i}: disable={rid}{note}")
    print(
        f"nrlint --suppressions: {n_total} suppression(s), "
        f"{n_stale} stale, {n_unjust} unjustified"
    )
    return 1 if n_stale or n_unjust or errors else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m node_replication_torch.analysis.lint",
        description=(
            "nrlint: project-native static analysis (device-path "
            "hygiene, combiner lock discipline, ring-cursor safety)"
        ),
    )
    ap.add_argument("paths", nargs="*",
                    default=["node_replication_torch"],
                    help="files or directories (default: the package)")
    ap.add_argument("--min-severity", default=WARNING,
                    choices=sorted(SEVERITY_ORDER, key=SEVERITY_ORDER.get),
                    help="fail threshold (default: warning)")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed diagnostics")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--suppressions", action="store_true",
                    help="audit mode: list every suppression, flag "
                         "stale and unjustified ones")
    ap.add_argument("--lockgraph-out", default=None, metavar="PATH",
                    help="write the static lock-order graph "
                         "(nodes/edges/cycles) as JSON")
    ap.add_argument("--check-dynamic", default=None, metavar="PATH",
                    help="verify a runtime lockgraph dump "
                         "(NR_TPU_LOCKGRAPH) is a subgraph of the "
                         "static graph")
    args = ap.parse_args(argv)

    if args.list_rules:
        width = max(len(r) for r in RULES)
        for rid, r in sorted(RULES.items()):
            print(f"{rid:<{width}}  {r.severity:<7}  {r.summary}")
        return 0

    if args.suppressions:
        return audit_suppressions(args.paths)

    select = (
        {s.strip() for s in args.select.split(",") if s.strip()}
        if args.select else None
    )
    if select:
        unknown = select - set(RULES)
        if unknown:
            print(f"nrlint: unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    files = collect_files(args.paths)
    modules, project, errors = build_project(files)
    diags, _ = run_lint(files, select=select, project=project)
    for e in errors:
        print(f"parse error: {e}")

    graph_rc = 0
    if args.lockgraph_out or args.check_dynamic:
        analysis = concurrency.analyze(project)
        if args.lockgraph_out:
            with open(args.lockgraph_out, "w") as f:
                json.dump(analysis.graph_json(), f, indent=1,
                          sort_keys=True)
                f.write("\n")
            print(f"nrlint: static lock-order graph "
                  f"({len(analysis.edge_list())} edge(s)) -> "
                  f"{args.lockgraph_out}")
        if args.check_dynamic:
            try:
                with open(args.check_dynamic) as f:
                    dyn = json.load(f).get("edges", [])
            except (OSError, ValueError) as e:
                print(f"nrlint: cannot read dynamic lockgraph "
                      f"{args.check_dynamic}: {e}")
                return 2
            violations = analysis.check_dynamic(dyn)
            for v in violations:
                print(f"nrlint: {v}")
            print(
                f"nrlint --check-dynamic: {len(dyn)} dynamic edge(s), "
                f"{len(violations)} missing from the static graph, "
                f"{len(analysis.cycles)} static cycle(s)"
            )
            if violations or analysis.cycles:
                graph_rc = 1

    threshold = SEVERITY_ORDER[args.min_severity]
    failing = [
        d for d in diags
        if not d.suppressed and SEVERITY_ORDER[d.severity] >= threshold
    ]
    shown = failing if not args.show_suppressed else [
        d for d in diags if SEVERITY_ORDER[d.severity] >= threshold
    ]
    for d in shown:
        print(d.format())

    n_suppressed = sum(1 for d in diags if d.suppressed)
    print(
        f"nrlint: {len(failing)} failing diagnostic(s), "
        f"{n_suppressed} suppressed, {len(diags)} total "
        f"across {len(files)} file(s)"
    )
    return 1 if failing or errors or graph_rc else 0


if __name__ == "__main__":
    raise SystemExit(main())
