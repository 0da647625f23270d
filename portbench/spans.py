"""The program's spans in a traced run: the combiner round's spans read
round by round, and the device trace's idle time put down to them.

Inside `execute_mut_batch` the port records one `mut-batch` span a
round and, under it, `encode`, `d2h` (every read of device memory),
`fused-round` (the launch) and `deliver`, each with `t0_ns`/`t1_ns` on
`time.perf_counter_ns()`, its `parent` and the round's `round`
(`node_replication_torch/obs/recorder.py`). The readers of the span
metrics (`metrics/round_encode_ms.py` and its kin) read them from
`run.spans` and find nothing where a run has none.

The harness turns on the metrics registry in a traced run, not the
tracer, and keeps no clock stamp beside its window mark, so its runs
carry no spans. This module's command runs one traced run of a cell
with both added, as the harness would hold them, and prints the result
line with the span metrics in it:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

It enables the tracer in memory as the window opens and moves its
events into `run.spans` as it closes, and reads `perf_counter_ns` next
to entering and leaving the window mark (`clock`). On the H100's hosts
the two clocks part by 0.16-4.4 ms over a 10 s trace, too far to map
spans of a few µs by one offset, and a line through the two readings
still left reads 11 µs (median) outside their spans. So each round's
`mut-batch` enters a profiler record while the profiler records
(`obs/recorder.py`), and `align` moves each round's spans by the offset
of its own record; `misfit` checks the result: every `aten::to` of a
read or an encode has to fall inside its `d2h` or `encode` span. The
idle time is then put down to the spans (`attribute_idle`). Standard
error gets the residual at the close, the alignment's checks, and the
idle seconds by span.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time

from portbench.trace import DEVICE_CATS, HOST_CATS, WINDOW, _spans

ROOT_SPAN = "mut-batch"
#: what `attribute_idle` names idle time in which no program span is open
NO_SPAN = "(none)"
#: the metrics this module's runs add to the result line
SPAN_METRICS = ("round_encode_ms", "round_d2h_wait_ms", "round_deliver_ms",
                "round_launch_ms", "idle_unspanned_pct")


def rounds_of(spans: list) -> dict:
    """`{round: [its events]}` of the rounds whose `mut-batch` closed in
    `spans`, each round's `mut-batch` event included."""
    roots = {e["round"] for e in spans if e.get("event") == ROOT_SPAN}
    out: dict = {r: [] for r in roots}
    for e in spans:
        r = e.get("round")
        if r in out:
            out[r].append(e)
    return out


def self_ns(event: dict, events: list) -> int:
    """`event`'s duration less that of its children in `events` (spans
    of one thread nest, so the children do not overlap)."""
    kids = sum(e["t1_ns"] - e["t0_ns"] for e in events
               if e.get("parent") == event["id"])
    return event["t1_ns"] - event["t0_ns"] - kids


def per_round_ms(run, name: str, self_time: bool = False,
                 since_ns: int | None = None):
    """The mean over the window's rounds (those that began at `since_ns`
    or later, where given) of the time spent in spans `name` a round
    (their self time with `self_time`), in ms; None where the run
    carries no rounds' spans."""
    spans = getattr(run, "spans", None)
    rounds = rounds_of(spans) if spans else {}
    if since_ns is not None:
        rounds = {r: ev for r, ev in rounds.items()
                  if min(e["t0_ns"] for e in ev) >= since_ns}
    if not rounds:
        return None
    total = 0
    for events in rounds.values():
        for e in events:
            if e.get("event") == name:
                total += (self_ns(e, events) if self_time
                          else e["t1_ns"] - e["t0_ns"])
    return total / len(rounds) * 1e-6


def clock(events: list, stamps: tuple) -> dict:
    """The host's `perf_counter_ns` against the chrome trace's clock,
    from the host's readings `stamps` next to entering and leaving the
    window mark: `offset_ns` (trace less host at the entry) and
    `residual_ns` (where the mark's end falls against the second reading
    under that offset: how far the clocks parted over the trace)."""
    marks = [s for s in _spans(events, HOST_CATS) if s[2] == WINDOW]
    if not marks:
        raise ValueError(f"no {WINDOW} mark in the trace")
    a, b, _ = marks[0]
    offset = a * 1e3 - stamps[0]
    return {"offset_ns": offset, "residual_ns": b * 1e3 - offset - stamps[1]}


def align(events: list, spans: list) -> tuple:
    """The spans of the rounds the trace holds, moved onto its clock
    (ns) round by round: the k-th `mut-batch` record of the trace is the
    k-th round's, and the round's spans move by the record's offset from
    its `mut-batch` span. `(spans, paired, worst_us)`: the rounds paired,
    and the largest difference between a record's length and its
    span's."""
    recs = sorted((a, b) for a, b, n in _spans(events, HOST_CATS)
                  if n == ROOT_SPAN)
    roots = sorted((e for e in spans if e.get("event") == ROOT_SPAN),
                   key=lambda e: e["t0_ns"])[:len(recs)]
    shift, worst = {}, 0.0
    for (a, b), e in zip(recs, roots):
        shift[e["round"]] = a * 1e3 - e["t0_ns"]
        worst = max(worst, abs((b - a) - (e["t1_ns"] - e["t0_ns"]) * 1e-3))
    out = [{"event": e["event"], "t0_ns": e["t0_ns"] + shift[e["round"]],
            "t1_ns": e["t1_ns"] + shift[e["round"]]}
           for e in spans if e.get("round") in shift]
    return out, len(shift), worst


def misfit(events: list, spans: list, op: str = "aten::to",
           names=("d2h", "encode")) -> list:
    """For each host op `op` inside the window mark, how far (µs) it
    falls outside the nearest of the spans (on the trace's clock, as
    `align` gives them) named `names`, sorted: 0 where one holds it."""
    host = _spans(events, HOST_CATS)
    marks = [s for s in host if s[2] == WINDOW]
    if not marks:
        return []
    w0, w1 = marks[0][0], marks[0][1]
    iv = sorted((e["t0_ns"] * 1e-3, e["t1_ns"] * 1e-3) for e in spans
                if e["event"] in names)
    starts = [a for a, _ in iv]
    out = []
    for a, b, n in host:
        if n != op or a < w0 or b > w1 or not iv:
            continue
        i = bisect.bisect_right(starts, a)
        near = iv[max(0, i - 1):i + 1]
        out.append(min(max(0.0, s0 - a, b - s1) for s0, s1 in near))
    return sorted(out)


def idle_gaps(events: list) -> list:
    """The device's idle intervals `(a, b)` (µs) inside the window mark,
    by `trace.reduce`'s rules: a kernel, copy or set makes it busy."""
    marks = [s for s in _spans(events, HOST_CATS) if s[2] == WINDOW]
    if not marks:
        return []
    w0, w1 = marks[0][0], marks[0][1]
    merged: list[list[float]] = []
    for a, b, _ in sorted(_spans(events, DEVICE_CATS)):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [w0] + [x for m in merged for x in m] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def attribute_idle(events: list, spans: list, offset: float) -> dict:
    """Each idle gap of the device trace's window put down to the
    innermost program span open at its middle (`NO_SPAN` where none
    is), and the share of the idle time during which no `mut-batch` was
    open: `{idle_s, by_span {name: seconds}, unspanned_s,
    idle_unspanned_pct}`. `events` are the chrome trace's, `spans` the
    program's, `offset` what moves their `t0_ns`/`t1_ns` onto the
    trace's clock in ns (0 for spans `align` gives)."""
    iv = sorted(((e["t0_ns"] + offset) * 1e-3, (e["t1_ns"] + offset) * 1e-3,
                 e["event"]) for e in spans if "t0_ns" in e)
    starts = [s[0] for s in iv]
    longest = max((b - a for a, b, _ in iv), default=0.0)
    roots = [(a, b) for a, b, n in iv if n == ROOT_SPAN]
    root_starts = [a for a, _ in roots]
    by_span: dict[str, float] = {}
    idle = unspanned = 0.0
    for a, b in idle_gaps(events):
        idle += b - a
        mid = (a + b) / 2
        hi = bisect.bisect_right(starts, mid)
        lo = bisect.bisect_left(starts, mid - longest)
        inner = [s for s in iv[lo:hi] if s[1] >= mid]
        name = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                else NO_SPAN)
        by_span[name] = by_span.get(name, 0.0) + (b - a) * 1e-6
        covered = 0.0
        i = max(0, bisect.bisect_right(root_starts, a) - 1)
        while i < len(roots) and roots[i][0] < b:
            covered += max(0.0, min(b, roots[i][1]) - max(a, roots[i][0]))
            i += 1
        unspanned += (b - a) - covered
    return {"idle_s": idle * 1e-6, "by_span": by_span,
            "unspanned_s": unspanned * 1e-6,
            "idle_unspanned_pct": (100 * unspanned / idle if idle
                                   else None)}


def _stamped_capture():
    """`trace.Capture` with the host's clock read next to the window
    mark's entry and exit, keeping the trace's events after `summary`."""
    import torch

    from portbench import trace

    class StampedCapture(trace.Capture):
        def open(self) -> None:
            torch.cuda.synchronize()
            self.prof.__enter__()
            self.mark = torch.profiler.record_function(WINDOW)
            self.mark.__enter__()
            self.stamps = [time.perf_counter_ns()]

        def close(self) -> None:
            self.stamps.append(time.perf_counter_ns())
            self.mark.__exit__(None, None, None)
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)

        def summary(self) -> dict:
            import os
            import tempfile

            fd, path = tempfile.mkstemp(prefix="portbench-trace-",
                                        suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    self.events = json.load(f)["traceEvents"]
            finally:
                os.unlink(path)
            self.prof = None
            return trace.reduce(self.events)

    return StampedCapture


def traced_run(name: str, seed: int, seconds: float, device=None,
               overrides: dict | None = None) -> tuple:
    """One traced run of cell `name` with the program's spans:
    `(result, run)`, the result holding the span metrics beside the
    cell's own."""
    from node_replication_torch.obs.recorder import get_tracer

    from portbench import harness, trace

    tracer = get_tracer()
    seen: dict = {}
    opened, closed = harness.Run.open_window, harness.Run.close_window
    capture = trace.Capture

    def open_window(self):
        seen["run"] = self
        tracer.enable(None)
        return opened(self)

    def close_window(self):
        cap = self.capture
        closed(self)
        self.spans = tracer.events()
        tracer.disable()
        seen["capture"] = cap

    harness.Run.open_window, harness.Run.close_window = (open_window,
                                                         close_window)
    trace.Capture = _stamped_capture()
    try:
        result = harness.run_cell(name, seed, seconds, True, device=device,
                                  overrides=overrides)
    finally:
        harness.Run.open_window, harness.Run.close_window = opened, closed
        trace.Capture = capture
        tracer.disable()
    run, cap = seen["run"], seen.get("capture")
    if cap is not None:
        clk = clock(cap.events, cap.stamps)
        mapped, clk["rounds_paired"], clk["worst_length_us"] = align(
            cap.events, run.spans)
        off = misfit(cap.events, mapped)
        clk["misfit_us"] = {"ops": len(off), **{
            k: harness.quantile(off, p) for k, p in (
                ("p50", 0.5), ("p99", 0.99), ("max", 1.0))}}
        run.clock = clk
        run.idle = attribute_idle(cap.events, mapped, 0.0)
        cap.events = None
        harness.log(f"clock residual at the window's close: "
                    f"{clk['residual_ns'] / 1e3:.3f} us; rounds aligned "
                    f"by their records: {clk['rounds_paired']} (lengths "
                    f"within {clk['worst_length_us']:.3f} us); aten::to "
                    f"outside its span by (us): "
                    f"{json.dumps(clk['misfit_us'])}")
        for k, v in sorted(run.idle["by_span"].items(),
                           key=lambda kv: -kv[1]):
            harness.log(f"idle under {k}: {v:.6f} s")
        # the rounds after the device trace closed ran without the
        # profiler's cost on every host operation
        late = {n: per_round_ms(run, n, since_ns=cap.stamps[1])
                for n in (ROOT_SPAN, "encode", "d2h", "deliver")}
        for n in (ROOT_SPAN, "fused-round"):
            late[n + " self"] = per_round_ms(run, n, True, cap.stamps[1])
        harness.log("ms a round after the trace closed: "
                    + json.dumps(late))
    for m in SPAN_METRICS:
        v = harness.load_reader(m)(run)
        if v is not None:
            result["metrics"][m] = {"value": v, "unit": (
                "%" if m.endswith("_pct") else "ms")}
    checks = result.pop("checks")
    result["checks"] = checks
    return result, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    result, run = traced_run(a.workload, a.seed, a.seconds)
    if getattr(run, "clock", None):
        result["clock"] = run.clock
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
