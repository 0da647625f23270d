"""nrlint and nrcheck: project-native static analysis for the port.

The port's invariants are conventions — "no host sync on the device
path" (`utils/fence.py`), "checks through `utils/checks.py:check`",
"ring indices are masked", "one combiner at a time", "an acyclic
lock order" — that nothing would enforce otherwise. This package is
the machine-checked gate: an AST-based lint over the project's own
idioms, plus the checked lock factory whose runtime lock-order graph
must fit inside the static one.

    python -m node_replication_torch.analysis.lint node_replication_torch

Layout:

- `astutil.py` — parsing, suppression comments, import/alias
  resolution, and the device-path inference (which functions run on
  the device path: `Dispatch` transitions, the step and round
  closures, the kernel wrappers — directly or through the project
  call graph).
- `rules.py` — the rule registry and every shipped rule.
- `concurrency.py` — nrcheck: guarded-by inference, the static
  lock-order graph, annotation hygiene, and two concurrency rules.
- `locks.py` — the lock factory (`NR_TPU_LOCKCHECK=1`: the checked
  mode).
- `lint.py` — the engine + CLI (`file:line:col: rule-id severity:
  message` diagnostics, `--min-severity`, `--list-rules`,
  `--lockgraph-out`, `--check-dynamic`, `--suppressions`).

Suppress a diagnostic with a trailing (or immediately-preceding-line)
comment: `# nrlint: disable=<rule-id>[,<rule-id>...] — justification`.
That exact form is the ONLY one that suppresses: unknown rule ids and
malformed `# nrlint` comments are themselves diagnosed
(`unknown-suppression`) so typos cannot silently disarm the gate.

Stdlib only: imports neither torch nor jax, nor the reference package.
"""

__all__ = ["run_lint"]


def __getattr__(name):
    # lazy: `python -m node_replication_torch.analysis.lint` would warn
    # about double-import if the package eagerly imported the submodule
    if name == "run_lint":
        from node_replication_torch.analysis.lint import run_lint

        return run_lint
    raise AttributeError(name)
