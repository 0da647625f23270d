"""One run of one cell: set-up, the measured window, the judgement of
what the window produced, and the result line.

`run_cell` finds everything by name: the cell in `BENCHMARK.json`, its
configuration's file and model adapter (`models/<model>.py`), its
traffic mix (`traffic/<name>.json`) and driver (`drivers/<driver>.py`),
and a reader for each of the cell's metrics (`metrics/<name>.py`, a
`read(run)` that gives a number, or None where it finds nothing).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import reference, traffic as traffic_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "node_replication_tpu")
PREFILL_STREAM = 1 << 21
#: a traced run's device trace covers the window's first this many
#: seconds (a trace of every host operation of a longer window is too
#: large to read back in a run's time)
TRACE_S = 10.0
#: the response a driver records for an op that raised or never came
UNANSWERED = -(1 << 40)


class NoChip(RuntimeError):
    """The cell asks for more CUDA devices than this process has."""


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_model(cfg: dict):
    mod = importlib.import_module(f"portbench.models.{cfg['model']}")
    return mod.Model(cfg)


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def load_reader(name: str):
    """`metrics/<name>.py`'s `read` (names may hold dots, so the file is
    loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its `workloads` take the cell
    in (or everywhere, without the key)."""
    pool = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in pool if cell in m.get("workloads", [cell])]


def quantile(values, q: float) -> float:
    """The nearest-rank q-quantile: the smallest value with at least q of
    all values at or below it (an infinite value counts too)."""
    v = sorted(values)
    if not v:
        return float("nan")
    return v[max(0, math.ceil(q * len(v) - 1e-9) - 1)]


def power_limit() -> str | None:
    """The card's power limit, as `nvidia-smi` gives it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


class Run:
    """What one run knows: the cell, its sizes, the program's fleet, the
    window's bounds, and after it the outcome, the trace's summary and
    the registry's snapshot that the metric readers read."""

    def __init__(self, bench: dict, cell: dict, cfg: dict, traffic: dict,
                 seed: int, seconds: float, trace: bool, device,
                 t_start: float):
        self.bench, self.cell, self.cfg, self.traffic = (
            bench, cell, cfg, traffic)
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.model = load_model(cfg)
        self.fleet = None
        self.capture = None
        self.traced = False
        self.t0 = None
        self.setup_s = None
        self.outcome = None
        self.summary = None
        self.registry = None
        self.device_kind = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        self.peaks = load_json(HERE / "peaks.json").get(self.device_kind)

    def _registry(self):
        from node_replication_torch.obs.metrics import get_registry

        return get_registry()

    def open_window(self) -> float:
        """Starts the window's instruments (traced runs only) and its
        clock: the first timed operation follows."""
        # what set-up made stays: the collector need not walk it again
        gc.collect()
        gc.freeze()
        if self.trace:
            reg = self._registry()
            reg.reset()
            reg.enable()
            if self.device.type == "cuda":
                from portbench.trace import Capture

                self.capture = Capture()
                self.capture.open()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.t_start
        return self.t0

    def log_slices(self, what: str, times) -> None:
        """Standard error: how many of `what` ended in each second of the
        window (`times` in seconds from its opening)."""
        n = max(1, int(math.ceil(self.seconds)))
        counts = np.bincount(np.minimum(np.asarray(times, np.float64),
                                        n - 1e-9).astype(int), minlength=n)
        log(f"{what} a second of the window: {counts.tolist()}")

    def trace_due(self) -> bool:
        """Whether the trace is still open and its span has passed."""
        return (self.capture is not None and not self.traced
                and time.perf_counter() >= self.t0 + TRACE_S)

    def end_trace(self) -> None:
        """Closes the device trace (once): its span ends here."""
        if self.capture is not None and not self.traced:
            self.capture.close()
            self.traced = True

    def close_window(self) -> None:
        gc.unfreeze()
        self.end_trace()
        if self.trace:
            reg = self._registry()
            reg.disable()
            self.registry = reg.snapshot()


def compare(model, planes: dict, ops: list, resps: list, state: dict,
            unanswered: int = 0) -> dict:
    """The answers `resps` (one array per entry of `ops`, each a
    `(opc, args, write)` in the order it ran) and the fleet's final
    `state` against the reference's replay of the same ops from
    `planes` (changed in place into the reference's final planes):
    `{check: (number, limit)}`. An answer of `UNANSWERED` is counted by
    `unanswered`, not here."""
    def cat(i):
        return torch.from_numpy(np.concatenate([o[i] for o in ops]))

    want = reference.replay(model, planes, cat(0), cat(1), cat(2)).cpu()
    got = torch.from_numpy(np.concatenate(resps))
    answered = got != UNANSWERED
    return {
        "wrong_answers": (int(((want != got) & answered).sum()), 0),
        "unanswered": (int(unanswered), 0),
        "wrong_state_cells": (model.mismatch(state, planes), 0),
    }


def initial_planes(model, seed: int, device) -> dict:
    """The state every replica starts from, made on `device` from the
    seed; the reference starts from the same."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63) ^ PREFILL_STREAM)
    return model.initial(gen, device)


def load_cell(name: str, root: Path = ROOT,
              overrides: dict | None = None) -> tuple:
    """`(bench, cell, cfg, traffic)` of cell `name`, the sizes
    changed by `overrides` ({"config": {...}, "traffic": {...}})."""
    overrides = overrides or {}
    bench = load_bench(root)
    cell = find(bench["workloads"], name, "workload")
    entry = find(bench["configs"], cell["config"], "config")
    cfg = {**load_json(root / entry["file"]), **overrides.get("config", {})}
    spec = {**traffic_mod.load(cell["traffic"]),
            **overrides.get("traffic", {})}
    return bench, cell, cfg, spec


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, root: Path = ROOT, overrides: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run of cell `name`: the result object the run prints.

    `device=None` takes the card and raises `NoChip` where the cell's
    chips are not there; the tests pass `device="cpu"` and small sizes
    through `overrides` ({"config": {...}, "traffic": {...}})."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, cfg, spec = load_cell(name, root, overrides)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            raise NoChip(f"cell {name} needs {cell['chips']} CUDA "
                         f"device(s); this process has "
                         f"{torch.cuda.device_count()}")
        device = "cuda:0"
    run = Run(bench, cell, cfg, spec, seed, seconds, bool(trace), device,
              t_start)
    run._registry().disable()
    dev = run.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    planes = initial_planes(run.model, seed, dev)
    run.fleet = run.model.build(
        {k: v.clone() for k, v in planes.items()}, dev)
    run.outcome = load_driver(spec["driver"]).run(run)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    state = run.model.fleet_state(run.fleet)
    run.fleet = None
    gc.collect()
    t = time.perf_counter()
    if run.capture is not None:
        run.summary = run.capture.summary()
        run.capture = None
        log(f"trace read in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    checks = compare(run.model, planes, run.outcome["ops"],
                     run.outcome["resps"], state,
                     run.outcome.get("unanswered", 0))
    del state
    log(f"judged in {time.perf_counter() - t:.1f} s")
    metrics = {}
    for m in cell_metrics(bench, name, run.trace):
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": run.device_kind,
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power_limit"] = power_limit()
    result = {"correct": correct,
              "attempted": int(run.outcome["attempted"]),
              "failed": int(run.outcome["failed"]),
              "metrics": metrics, "device": device_info}
    if run.summary is not None:
        s = run.summary
        device_info["busy_s"] = s["busy_s"]
        device_info["window_s"] = s["window_s"]
        ops = sorted(s["by_name"].items(), key=lambda kv: -kv[1][0])
        result["breakdown"] = {
            "device_ops": [[n[:120], t] for n, (t, _) in ops[:10]],
            "idle_gaps": [[n[:120], t] for n, t in s["gaps"][:10]],
        }
    for err in run.outcome.get("errors", []):
        log("error:", err)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def forbidden_modules() -> list[str]:
    """Modules held by this process whose top-level name, whole, is one
    of `FORBIDDEN`."""
    return sorted(m for m in list(sys.modules)
                  if m.partition(".")[0] in FORBIDDEN)
