"""Trace-report CLI: summarize a flight-recorder JSONL trace.

    python -m node_replication_torch.obs.report trace.jsonl [--json]

The port's copy of `node_replication_tpu/obs/report.py`: on the same
events, `analyze()` gives the same JSON and `render()` the same text,
so a trace or `fleet.jsonl` from either package reads in both.

Sections:

- **events** — per-event-name counts.
- **spans** — p50/p95/p99/max durations for every event that carries
  `duration_s` (append, combine-replay, exec-round, checkpoint-*, …),
  with a `fenced` marker when the spans were fence-accurate
  (NR_TPU_TRACE_FENCE=1; an unfenced span around CUDA work measures
  the enqueue, not the execution).
- **throughput** — ops/sec timeline from `throughput` events (the
  harness's per-second capture, `benches/mkbench.rs:755-761`); when a
  trace has none (e.g. one recorded from examples/nr_hashmap.py), the
  timeline is derived from `append` events (appended ops bucketed by
  second), so any runtime trace yields a timeline.
- **stalls** — watchdog report: stall sites grouped by (where, log),
  with fire counts, max fruitless rounds, and the dormant replicas seen.
- **serve** (when the trace has `serve-*` events, `serve/frontend.py`)
  — queue-depth timeline (max observed depth per second), batch-size
  histogram (power-of-two buckets), and the admission-control counts:
  shed (`Overloaded`) and deadline-missed requests.
- **fault** (when the trace has `fault-*` / `serve-rehome` events,
  `fault/`) — per-replica lifecycle-transition timeline
  (HEALTHY -> SUSPECT -> QUARANTINED -> REPAIRING -> HEALTHY),
  repair-duration histogram (power-of-two millisecond buckets) with
  p50/p95, and the counts the chaos gates watch: injected faults,
  quarantines, completed repairs, re-homed requests.
- **durability** (when the trace has `wal-*` / `recovery*` /
  `durable-snapshot` events, `durable/`) — fsync count and latency
  p50/p95/p99 (`wal-sync` spans), torn-tail truncations, segment
  reclamations, snapshots taken, and the recovery timeline: every
  durability-plane event in order with its `t+` offset, so a
  crash-restart reads as a story (open → truncate → replay → attach).
- **replication** (when the trace has `repl-*` events, `repl/`) —
  shipped vs applied record/op counts, the delivery edge cases the
  feed defines (duplicates skipped, gaps, zombie-fenced records,
  stale reads), an apply-lag timeline (max positions behind the feed
  tail per second, from `repl-apply` events), and every promotion
  with its measured detect/promote/RTO split (`repl-promote` /
  `repl-rto`).
- **fleet** (when the trace is a COLLECTOR merge, `obs/collect.py`:
  events stamped with `node_id`, plus `fleet-scrape` summaries) —
  the node inventory (role, lag, last scrape), and per-record
  CROSS-PROCESS hop timelines: events joined on the record's log
  position `pos` (submit→append→wal-sync→ship→wire→relay-forward→
  apply, with ack closing the loop), ordered causally and placed on
  the collector's timeline via each event's `t_fleet` stamp — NEVER
  by raw `mono`, which does not compare across processes — with
  per-edge latency p50/p95 aggregated over every sampled record.

Pure stdlib on purpose: on a machine without torch, copy this file
next to the trace and run it directly (`python report.py trace.jsonl`).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter, defaultdict


def _percentile(sorted_vals: list[float], p: float) -> float:
    """Nearest-rank percentile on raw values (exact, not bucketed —
    the trace carries every duration)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(p * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def load_events(path: str) -> list[dict]:
    events = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                print(f"# skipping malformed line {i}", file=sys.stderr)
    return events


def _event_time(e: dict, mono0: float | None,
                ts0: float | None) -> float:
    """Seconds since trace start. Monotonic and wall-clock stamps live
    on different epochs, so each is measured against its OWN baseline —
    mixing them (e.g. a legacy ts-only event next to upgraded events in
    an appended-to trace file) would produce garbage offsets."""
    if "mono" in e and mono0 is not None:
        return float(e["mono"]) - mono0
    if "ts" in e and ts0 is not None:
        return float(e["ts"]) - ts0
    return 0.0


# per-record hop chain: causal rank of each hop event in a record's
# submit→ack life. `serve-batch` expands into BOTH ends (submit at
# rank 0 reconstructed from its delay fields, ack at the top); ties
# within a rank order by fleet time.
_HOP_RANK = {
    "submit": 0,
    "append": 1,        # `append` / `fused-round` events (pos0)
    "wal-sync": 2,      # first sync whose `synced_to` covers pos
    "ship": 3,          # repl-ship
    "wire": 4,          # transport-poll (record served downstream)
    "relay-forward": 5,
    "apply": 6,         # repl-apply
    "ack": 7,           # serve-batch (futures resolved)
}
_HOP_OF_EVENT = {
    "append": "append",
    "fused-round": "append",
    "repl-ship": "ship",
    "transport-poll": "wire",
    "relay-forward": "relay-forward",
    "repl-apply": "apply",
}


def _analyze_fleet(events: list[dict]) -> dict | None:
    """The cross-process section: only a COLLECTOR-merged trace
    (`obs/collect.py`) has it — detected by `node_id`-stamped events
    and/or `fleet-scrape` summaries. Joins per-record hop events on
    the record's `pos` across processes; orders them by causal hop
    rank, then by the collector-aligned `t_fleet` stamp (raw `mono`
    never compares across processes)."""
    scrapes = [e for e in events if e.get("event") == "fleet-scrape"]
    tagged = [e for e in events if e.get("node_id") is not None]
    if not scrapes and not tagged:
        return None

    def _t(e):
        v = e.get("t_fleet", e.get("ts"))
        return float(v) if v is not None else None

    # ---- node inventory: the LAST scrape summary per node ----------
    nodes: dict[str, dict] = {}
    for e in scrapes:
        nid = str(e.get("node_id", "?"))
        metrics = e.get("metrics") or {}
        stats = e.get("stats") or {}

        def _num(d, *path, default=None):
            cur = d
            for k in path:
                if not isinstance(cur, dict) or k not in cur:
                    return default
                cur = cur[k]
            return cur if isinstance(cur, (int, float)) else default

        nodes[nid] = {
            "node_id": nid,
            "role": str(e.get("role", "?")),
            "last_t": e.get("t"),
            "applied": _num(stats, "follower", "applied",
                            default=_num(stats, "relay", "cursor")),
            "ship_lag": _num(metrics, "repl.ship_lag_pos"),
            "apply_lag": _num(metrics, "repl.apply_lag_pos"),
            "relay_lag": _num(metrics, "repl.relay.lag_pos"),
            "completed": _num(stats, "serve", "completed"),
            "queued": _num(stats, "serve", "queued"),
            "shed": _num(stats, "serve", "shed"),
            "scrapes": nodes.get(nid, {}).get("scrapes", 0) + 1,
        }
    for e in tagged:  # nodes that emitted events but no summary yet
        nid = str(e["node_id"])
        if nid not in nodes:
            nodes[nid] = {"node_id": nid,
                          "role": str(e.get("role", "?")),
                          "scrapes": 0}

    # ---- per-record hop chains keyed by pos ------------------------
    chains: dict[int, list] = defaultdict(list)
    syncs_by_node: dict[str, list] = defaultdict(list)
    for e in tagged:
        name = e.get("event")
        nid = str(e["node_id"])
        t = _t(e)
        if t is None:
            continue
        if name == "wal-sync":
            syncs_by_node[nid].append(
                (int(e.get("synced_to", -1)), t)
            )
            continue
        if name == "serve-batch":
            pos = e.get("pos")
            if pos is None:
                continue
            pos = int(pos)
            chains[pos].append((_HOP_RANK["ack"], "ack", nid, t))
            # the submit stamp is reconstructable: the ack event
            # carries queue delay (admission→assembly) and round
            # duration (assembly→ack)
            back = (float(e.get("queue_delay_s", 0.0))
                    + float(e.get("duration_s", 0.0)))
            chains[pos].append(
                (_HOP_RANK["submit"], "submit", nid, t - back)
            )
            continue
        hop = _HOP_OF_EVENT.get(name)
        if hop is None:
            continue
        pos = e.get("pos", e.get("pos0"))
        if pos is None:
            continue
        chains[int(pos)].append((_HOP_RANK[hop], hop, nid, t))
    # wal-sync joins by coverage: the first sync on the appending
    # node whose durable boundary passed the record's position
    for nid in syncs_by_node:
        syncs_by_node[nid].sort()
    for pos, hops in chains.items():
        for nid in {n for _, h, n, _ in hops if h == "append"}:
            for synced_to, t in syncs_by_node.get(nid, ()):
                if synced_to > pos:
                    hops.append(
                        (_HOP_RANK["wal-sync"], "wal-sync", nid, t)
                    )
                    break

    # ---- order, dedup, measure edges -------------------------------
    timelines = []
    edge_samples: dict[str, list] = defaultdict(list)
    for pos in sorted(chains):
        raw = sorted(chains[pos])
        # one entry per (hop, node): re-served records (reconnects,
        # duplicate delivery) re-emit hops; the FIRST occurrence is
        # the causal one
        seen = set()
        hops = []
        for rank, hop, nid, t in raw:
            if (hop, nid) in seen:
                continue
            seen.add((hop, nid))
            hops.append({"hop": hop, "node": nid,
                         "t": round(t, 6)})
        if not hops:
            continue
        # origin discipline: followers replay records through the
        # SAME combiner protocol the primary used, so every follower
        # re-emits `append`/`wal-sync` for the record — those are
        # apply-side details (already narrated by the apply hop), not
        # the record's origin. Keep append/wal-sync only on the node
        # that served the submit/ack.
        origin = next((h["node"] for h in hops
                       if h["hop"] in ("submit", "ack")), None)
        if origin is not None:
            hops = [h for h in hops
                    if h["hop"] not in ("append", "wal-sync")
                    or h["node"] == origin]
        procs = {h["node"] for h in hops}
        names = [h["hop"] for h in hops]
        complete = "submit" in names and "ack" in names
        t0 = hops[0]["t"]
        # per-edge samples over the CAUSAL path only (submit→...→
        # apply), between the EARLIEST occurrence of each hop — a hop
        # can occur on several nodes (two relays forwarding, N
        # followers applying, a record re-served over a reconnect)
        # and pairing across those occurrences would manufacture
        # negative "latencies". Earliest by TIME, not list order: the
        # hop list is (rank, node)-sorted, so "first in list" would
        # pick the alphabetically-first node. ack is concurrent with
        # the downstream hops (ship-before-ack puts it after ship but
        # racing the relays), so the client-visible edge is measured
        # separately as submit->ack.
        first: dict[str, float] = {}
        for h in hops:
            if h["hop"] == "ack":
                continue
            cur = first.get(h["hop"])
            if cur is None or h["t"] < cur:
                first[h["hop"]] = h["t"]
        labels = sorted(first, key=lambda k: _HOP_RANK[k])
        for a, b in zip(labels, labels[1:]):
            edge_samples[f"{a}->{b}"].append(first[b] - first[a])
        if complete:
            t_sub = min(h["t"] for h in hops
                        if h["hop"] == "submit")
            t_ack = max(h["t"] for h in hops if h["hop"] == "ack")
            edge_samples["submit->ack"].append(t_ack - t_sub)
        timelines.append({
            "pos": pos,
            "processes": len(procs),
            "complete": complete,
            "hops": [{**h, "t": round(h["t"] - t0, 6)}
                     for h in hops],
        })
    edges = {}
    for label, vals in sorted(edge_samples.items()):
        vals = sorted(vals)
        edges[label] = {
            "count": len(vals),
            "p50_s": _percentile(vals, 0.50),
            "p95_s": _percentile(vals, 0.95),
            "max_s": vals[-1],
        }
    complete_multi = [
        tl for tl in timelines
        if tl["complete"] and tl["processes"] >= 3
    ]
    return {
        "nodes": [nodes[k] for k in sorted(nodes)],
        "scrapes": len(scrapes),
        "scrape_errors": sum(
            1 for e in events
            if e.get("event") == "fleet-scrape-error"
        ),
        "records": len(timelines),
        "complete_records": sum(
            1 for tl in timelines if tl["complete"]
        ),
        "complete_multiprocess_records": len(complete_multi),
        "edges": edges,
        # the renderable exemplars: widest-spanning complete chains
        # first (the --json consumer gets every chain's summary via
        # records/edges; full per-hop dumps stay bounded)
        "timelines": sorted(
            timelines,
            key=lambda tl: (-int(tl["complete"]), -tl["processes"],
                            tl["pos"]),
        )[:8],
    }


def analyze(events: list[dict]) -> dict:
    """Reduce a trace to the report's structured form (the --json
    payload; the text renderer consumes the same dict)."""
    counts = Counter(e.get("event", "?") for e in events)

    spans: dict[str, list[float]] = defaultdict(list)
    fenced: dict[str, bool] = {}
    for e in events:
        if "duration_s" in e:
            name = e.get("event", "?")
            spans[name].append(float(e["duration_s"]))
            fenced[name] = fenced.get(name, True) and bool(
                e.get("fenced", False)
            )
    span_stats = {}
    for name, vals in spans.items():
        vals = sorted(vals)
        span_stats[name] = {
            "count": len(vals),
            "total_s": sum(vals),
            "p50_s": _percentile(vals, 0.50),
            "p95_s": _percentile(vals, 0.95),
            "p99_s": _percentile(vals, 0.99),
            "max_s": vals[-1],
            "fenced": fenced[name],
        }

    # throughput timeline: explicit per-second samples, else derive one
    # from append events so every runtime trace has a timeline
    monos = [float(e["mono"]) for e in events if "mono" in e]
    tss = [float(e["ts"]) for e in events if "ts" in e]
    mono0 = min(monos) if monos else None
    ts0 = min(tss) if tss else None
    timeline: dict[int, int] = defaultdict(int)
    source = None
    tp = [e for e in events if e.get("event") == "throughput"]
    if tp:
        source = "throughput"
        for e in tp:
            sec = e.get("second")
            if sec is None or sec < 0:
                sec = int(_event_time(e, mono0, ts0))
            timeline[int(sec)] += int(e.get("ops", 0))
    else:
        appends = [e for e in events
                   if e.get("event") == "append" and "n" in e]
        if appends:
            source = "append"
            for e in appends:
                timeline[int(_event_time(e, mono0, ts0))] += int(e["n"])

    stalls: dict[tuple, dict] = {}
    for e in events:
        if e.get("event") != "watchdog":
            continue
        key = (e.get("where", "?"), e.get("log", None))
        s = stalls.setdefault(
            key, {"count": 0, "max_rounds": 0, "dormant": set(),
                  "last_ltail": None, "last_tail": None}
        )
        s["count"] += 1
        s["max_rounds"] = max(s["max_rounds"], int(e.get("rounds", 0)))
        if "dormant" in e:
            s["dormant"].add(int(e["dormant"]))
        s["last_ltail"] = e.get("ltail", s["last_ltail"])
        s["last_tail"] = e.get("tail", s["last_tail"])

    # serve section: batch shape + admission control from serve-*
    # events, incl. the overload plane (adaptive limit, priority
    # sheds/evictions, brownout, per-cause client retries, breaker)
    serve = None
    batches = [e for e in events if e.get("event") == "serve-batch"]
    assembles = [e for e in events
                 if e.get("event") == "serve-assemble"]
    sheds = [e for e in events if e.get("event") == "serve-shed"]
    misses = [e for e in events
              if e.get("event") == "serve-deadline-miss"]
    evicts = [e for e in events if e.get("event") == "serve-evict"]
    retries = [e for e in events if e.get("event") == "serve-retry"]
    limits = [e for e in events
              if e.get("event") == "serve-admit-limit"]
    brownouts = [e for e in events
                 if e.get("event") == "serve-brownout"]
    brownout_reads = [e for e in events
                      if e.get("event") == "serve-brownout-read"]
    circuits = [e for e in events if e.get("event") == "serve-circuit"]
    if (batches or assembles or sheds or misses or evicts or retries
            or limits or brownouts or circuits):
        sizes = sorted(int(e.get("n", 0)) for e in batches)
        size_hist: dict[int, int] = defaultdict(int)
        for n in sizes:
            # power-of-two upper-bound buckets: 1, 2, 4, 8, ...
            size_hist[1 << max(0, n - 1).bit_length()] += 1
        qdepth: dict[int, int] = {}
        for e in batches:
            sec = int(_event_time(e, mono0, ts0))
            qdepth[sec] = max(qdepth.get(sec, 0),
                              int(e.get("queue_depth", 0)))
        shed_by_prio: dict[str, int] = defaultdict(int)
        for e in sheds:
            shed_by_prio[str(e.get("prio", "?"))] += 1
        retry_by_cause: dict[str, int] = defaultdict(int)
        for e in retries:
            retry_by_cause[str(e.get("cause", "?"))] += 1
        # adaptive-admission timeline: min limit observed per second
        # (the controller's most constrained moment of that second)
        limit_tl: dict[int, int] = {}
        for e in limits:
            sec = int(_event_time(e, mono0, ts0))
            lim = int(e.get("limit", 0))
            limit_tl[sec] = min(limit_tl.get(sec, 1 << 30), lim)
        # pipelined-serving overlap picture: the
        # serve-batch span is the round's device+completion half, the
        # serve-assemble event the host assembly half — their busy
        # fractions over the serve window show how much of the host
        # work the pipeline actually hid (serial traces have no
        # serve-assemble events and skip the line)
        pipe = None
        if assembles:
            times = [_event_time(e, mono0, ts0)
                     for e in batches + assembles]
            window = max(times) - min(times) if len(times) > 1 else 0.0
            device_s = sum(
                float(e.get("duration_s", 0.0)) for e in batches
            )
            asm_s = sum(
                float(e.get("duration_s", 0.0)) for e in assembles
            )
            pipe = {
                "assemble_events": len(assembles),
                "assembly_busy_s": asm_s,
                "device_busy_s": device_s,
                "window_s": window,
                "assembly_busy_frac": (
                    asm_s / window if window > 0 else 0.0
                ),
                "device_busy_frac": (
                    device_s / window if window > 0 else 0.0
                ),
            }
        serve = {
            "batches": len(batches),
            "ops": sum(sizes),
            "late_success": sum(
                int(e.get("late_success", 0) or 0) for e in batches
            ),
            "pipeline": pipe,
            "p50_batch": _percentile([float(s) for s in sizes], 0.50),
            "max_batch": sizes[-1] if sizes else 0,
            "batch_size_hist": dict(sorted(size_hist.items())),
            "queue_depth_timeline": dict(sorted(qdepth.items())),
            "shed": len(sheds),
            "shed_by_priority": dict(sorted(shed_by_prio.items())),
            "evicted": len(evicts),
            "deadline_miss": sum(int(e.get("n", 1)) for e in misses),
            "swept_at_admission": sum(
                int(e.get("n", 1)) for e in misses
                if e.get("swept")
            ),
            "retries_by_cause": dict(sorted(retry_by_cause.items())),
            "admit_limit_timeline": dict(sorted(limit_tl.items())),
            "brownout_transitions": [
                {"t": round(_event_time(e, mono0, ts0), 3),
                 "on": int(e.get("on", 0))}
                for e in brownouts
            ],
            "brownout_reads": len(brownout_reads),
            "max_brownout_lag": max(
                (int(e.get("lag", 0)) for e in brownout_reads),
                default=0,
            ),
            "circuit_transitions": sum(
                1 for e in circuits if e.get("state") == "open"
            ),
        }

    # fault section: lifecycle transitions + repair latencies from
    # fault-* events (fault/health.py, fault/repair.py)
    fault = None
    transitions = [e for e in events
                   if e.get("event") == "fault-transition"]
    repairs = [e for e in events if e.get("event") == "fault-repair"]
    injects = [e for e in events if e.get("event") == "fault-inject"]
    rehomes = [e for e in events if e.get("event") == "serve-rehome"]
    if transitions or repairs or injects or rehomes:
        per_rid: dict[int, list] = defaultdict(list)
        for e in transitions:
            per_rid[int(e.get("rid", -1))].append((
                round(_event_time(e, mono0, ts0), 3),
                e.get("frm", "?"), e.get("to", "?"),
            ))
        durs = sorted(float(e.get("duration_s", 0.0)) for e in repairs)
        repair_hist: dict[int, int] = defaultdict(int)
        for d in durs:
            # power-of-two millisecond upper-bound buckets: 1, 2, 4...
            ms = max(1, int(d * 1e3))
            repair_hist[1 << max(0, ms - 1).bit_length()] += 1
        fault = {
            "injected": len(injects),
            "quarantines": sum(
                1 for e in transitions if e.get("to") == "quarantined"
            ),
            "repairs": len(repairs),
            "rehomed": sum(int(e.get("n", 1)) for e in rehomes),
            "repair_p50_s": _percentile(durs, 0.50),
            "repair_p95_s": _percentile(durs, 0.95),
            "repair_max_s": durs[-1] if durs else 0.0,
            "repair_hist_ms": dict(sorted(repair_hist.items())),
            "timeline": {
                rid: trs for rid, trs in sorted(per_rid.items())
            },
        }

    # durability section: fsync shape + the recovery timeline from
    # wal-*/recovery*/durable-snapshot events (durable/)
    durability = None
    _DUR_EVENTS = ("wal-open", "wal-truncate", "wal-sync", "wal-attach",
                   "wal-reclaim", "durable-snapshot", "recovery",
                   "recovery-done")
    dur_evts = [e for e in events if e.get("event") in _DUR_EVENTS]
    if dur_evts:
        syncs = sorted(float(e.get("duration_s", 0.0))
                       for e in dur_evts
                       if e.get("event") == "wal-sync")
        timeline_d = []
        for e in sorted(dur_evts,
                        key=lambda e: _event_time(e, mono0, ts0)):
            name = e["event"]
            if name == "wal-sync":
                continue  # histogrammed, not narrated (too many)
            detail = {k: v for k, v in e.items()
                      if k not in ("event", "ts", "mono", "tid")}
            timeline_d.append({
                "t": round(_event_time(e, mono0, ts0), 3),
                "event": name,
                **detail,
            })
        recs = [e for e in dur_evts if e.get("event") == "recovery-done"]
        durability = {
            "fsyncs": len(syncs),
            "fsync_p50_s": _percentile(syncs, 0.50),
            "fsync_p95_s": _percentile(syncs, 0.95),
            "fsync_p99_s": _percentile(syncs, 0.99),
            "truncations": sum(1 for e in dur_evts
                               if e.get("event") == "wal-truncate"),
            "reclaimed_segments": sum(
                int(e.get("deleted", 0)) for e in dur_evts
                if e.get("event") == "wal-reclaim"
            ),
            "snapshots": sum(1 for e in dur_evts
                             if e.get("event") == "durable-snapshot"),
            "recoveries": len(recs),
            "replayed_ops": sum(int(e.get("ops", 0)) for e in recs),
            "timeline": timeline_d,
        }

    # replication section: ship/apply volume, delivery edge cases,
    # apply-lag timeline, promotions with RTO split (repl/)
    repl = None
    ships = [e for e in events if e.get("event") == "repl-ship"]
    applies = [e for e in events if e.get("event") == "repl-apply"]
    repl_other = [e for e in events
                  if str(e.get("event", "")).startswith("repl-")
                  and e.get("event") not in ("repl-ship", "repl-apply")]
    # transport lane events count toward section presence too: a
    # relay-only process emits transport-*/relay-* but no repl-*
    transport_events = [e for e in events
                        if str(e.get("event", ""))
                        .startswith(("transport-", "relay-"))]
    if ships or applies or repl_other or transport_events:
        lag_tl: dict[int, int] = {}
        for e in applies:
            sec = int(_event_time(e, mono0, ts0))
            lag_tl[sec] = max(lag_tl.get(sec, 0), int(e.get("lag", 0)))
        promotions = []
        rtos = {e.get("follower"): e for e in events
                if e.get("event") == "repl-rto"}
        for e in events:
            if e.get("event") != "repl-promote":
                continue
            rto = rtos.get(e.get("name"), {})
            promotions.append({
                "t": round(_event_time(e, mono0, ts0), 3),
                "follower": e.get("name", "?"),
                "epoch": e.get("epoch"),
                "applied": e.get("applied"),
                "drained_records": e.get("drained_records", 0),
                "promote_s": float(e.get("duration_s", 0.0)),
                "detect_s": float(rto.get("detect_s", 0.0)),
                "rto_s": float(rto.get("rto_s",
                                       e.get("duration_s", 0.0))),
            })

        def _count(name):
            return sum(1 for e in repl_other if e.get("event") == name)

        # transport lane (repl/transport.py + repl/relay.py): wire
        # lifecycle, relay forwarding/fencing, snapshot bootstraps
        def _tcount(name):
            return sum(1 for e in transport_events
                       if e.get("event") == name)

        repl = {
            "shipped_records": len(ships),
            "shipped_ops": sum(int(e.get("n", 0)) for e in ships),
            "applied_records": len(applies),
            "applied_ops": sum(int(e.get("n", 0)) for e in applies),
            "duplicates": _count("repl-dup"),
            "fenced_records": _count("repl-fenced-record"),
            "fenced_publishes": _count("repl-fenced-publish"),
            "stale_reads": _count("repl-stale-read"),
            "ship_errors": _count("repl-ship-error"),
            "apply_errors": _count("repl-apply-error"),
            "fences": _count("repl-fence"),
            "transport_connects": _tcount("transport-connect"),
            "transport_reconnects": _tcount("transport-reconnect"),
            "transport_errors": _tcount("transport-error"),
            "relay_fenced": _tcount("relay-fenced"),
            "relay_errors": _tcount("relay-error"),
            "snapshots_served": _tcount("transport-snapshot-served"),
            "snapshots_fetched": _tcount("transport-snapshot-fetched"),
            "bootstraps": _count("repl-bootstrap"),
            "bootstrap_failures": _count("repl-bootstrap-failed"),
            "apply_lag_timeline": dict(sorted(lag_tl.items())),
            "promotions": promotions,
        }

    # fleet section: cross-process merge (obs/collect.py output) —
    # node inventory from fleet-scrape summaries + per-record hop
    # timelines joined on (pos, node_id)
    fleet = _analyze_fleet(events)

    # mesh section: placement, rounds by collective tier, collective
    # time, cross-device sync bytes, ring catch-up passes (parallel/)
    mesh = None
    places = [e for e in events if e.get("event") == "mesh-place"]
    mesh_rounds = [e for e in events
                   if e.get("event") == "exec-round"
                   and e.get("mesh_tier")]
    rings = [e for e in events if e.get("event") == "ring-exec"]
    if places or mesh_rounds or rings:
        by_tier: dict[str, int] = defaultdict(int)
        durs = []
        sync_bytes = 0
        for e in mesh_rounds:
            by_tier[str(e["mesh_tier"])] += 1
            durs.append(float(e.get("duration_s", 0.0)))
            sync_bytes += int(e.get("sync_bytes", 0))
        durs.sort()
        mesh = {
            "placements": [
                {"wrapper": e.get("wrapper", "?"),
                 "devices": int(e.get("devices", 0)),
                 "replicas": int(e.get("replicas", 0)),
                 "per_device": int(e.get("per_device", 0)),
                 "tier": e.get("tier", "?")}
                for e in places
            ],
            "rounds_by_tier": dict(sorted(by_tier.items())),
            "collective_time_s": sum(durs),
            "round_p50_s": _percentile(durs, 0.50),
            "round_p95_s": _percentile(durs, 0.95),
            "sync_bytes": sync_bytes,
            "ring_execs": len(rings),
            "ring_ops": sum(int(e.get("window", 0)) for e in rings),
        }

    # kernels section: fused-round launches by tier, window-size
    # histogram, per-launch duration percentiles (kernel-launch events,
    # ops/ring.py), plus serve batches by combiner engine (the
    # serve-batch `engine` stamp) and the winner-selection verdicts
    # (fused-calibration events, core/replica._FusedTier)
    kernels = None
    klaunches = [e for e in events if e.get("event") == "kernel-launch"]
    serve_engines = [e.get("engine") for e in events
                     if e.get("event") == "serve-batch"
                     and e.get("engine")]
    cals = [e for e in events
            if e.get("event") == "fused-calibration"]
    if klaunches or serve_engines or cals:
        launch_by_tier: dict[str, int] = defaultdict(int)
        window_hist: dict[int, int] = defaultdict(int)
        kdurs = []
        for e in klaunches:
            launch_by_tier[str(e.get("tier", "?"))] += int(
                e.get("launches", 1)
            )
            window_hist[int(e.get("window", 0))] += 1
            kdurs.append(float(e.get("duration_s", 0.0)))
        kdurs.sort()
        batches_by_engine: dict[str, int] = defaultdict(int)
        for eng in serve_engines:
            batches_by_engine[str(eng)] += 1
        kernels = {
            "rounds": len(klaunches),
            "launches_by_tier": dict(sorted(launch_by_tier.items())),
            "window_hist": dict(sorted(window_hist.items())),
            "fused_ops": sum(int(e.get("count", 0)) for e in klaunches),
            "launch_p50_s": _percentile(kdurs, 0.50),
            "launch_p95_s": _percentile(kdurs, 0.95),
            "serve_batches_by_engine": dict(
                sorted(batches_by_engine.items())
            ),
            "calibrations": [
                {"winner": e.get("winner", "?"),
                 "window": int(e.get("window", 0)),
                 # mesh-aware + fence-keyed verdicts:
                 # absent on pre-mesh traces, defaults keep old
                 # artifacts renderable
                 "devices": int(e.get("devices", 1) or 1),
                 "fenced": list(e.get("fenced", []) or []),
                 "fused_s": float(e.get("fused_s", 0.0)),
                 "chain_s": float(e.get("chain_s", 0.0))}
                for e in cals
            ],
        }

    # sharding section: routing-tier map adoptions + typed refusals
    # from serve-reroute / shard-refused events (shard/router.py) —
    # the keyspace-sharded fleet's re-home + zombie-fence story
    sharding = None
    reroutes = [e for e in events if e.get("event") == "serve-reroute"]
    refusals = [e for e in events if e.get("event") == "shard-refused"]
    if reroutes or refusals:
        ref_by_shard: dict[int, int] = defaultdict(int)
        ref_by_error: dict[str, int] = defaultdict(int)
        for e in refusals:
            ref_by_shard[int(e.get("shard", -1))] += 1
            ref_by_error[str(e.get("error", "?"))] += 1
        sharding = {
            "map_adoptions": len(reroutes),
            "final_map_version": max(
                (int(e.get("map_version", 0)) for e in reroutes),
                default=0,
            ),
            "adoptions": [
                {"t": round(_event_time(e, mono0, ts0), 3),
                 "reason": e.get("reason", "?"),
                 "from_version": int(e.get("from_version", 0)),
                 "map_version": int(e.get("map_version", 0)),
                 "shards": list(e.get("shards", []) or [])}
                for e in sorted(
                    reroutes,
                    key=lambda e: _event_time(e, mono0, ts0),
                )
            ],
            "refused": len(refusals),
            "refused_by_shard": dict(sorted(ref_by_shard.items())),
            "refused_by_error": dict(sorted(ref_by_error.items())),
        }

    # host budget section: per-stage host-CPU attribution from
    # profile-summary events (obs/profile.SamplingProfiler.emit_summary)
    # joined with the spans the profiler's stages mirror — where a
    # served round's host time goes
    host_budget = None
    psums = [e for e in events if e.get("event") == "profile-summary"]
    if psums:
        stage_samples: dict[str, int] = defaultdict(int)
        role_samples: dict[str, int] = defaultdict(int)
        total = 0
        busy_weighted = 0.0
        for e in psums:
            n = int(e.get("thread_samples", 0))
            total += n
            busy_weighted += float(e.get("busy_frac", 0.0)) * n
            for stage, s in (e.get("stages") or {}).items():
                stage_samples[str(stage)] += int(s)
            for role, s in (e.get("roles") or {}).items():
                role_samples[str(role)] += int(s)
        other = stage_samples.get("other", 0)
        # join each budget stage with the wall-clock spans that time
        # the same work, so "fraction of host samples" sits next to
        # "seconds of span time" for the stages both planes cover
        _span_of_stage = {
            "append": ("append", "fused-round", "serve-batch"),
            "encode": ("serve-assemble",),
            "fsync": ("wal-sync",),
        }
        stages = {}
        for stage, n in sorted(stage_samples.items(),
                               key=lambda kv: -kv[1]):
            row = {"samples": n,
                   "frac": n / total if total else 0.0}
            span_total = sum(
                span_stats[s]["total_s"]
                for s in _span_of_stage.get(stage, ())
                if s in span_stats
            )
            if span_total:
                row["span_total_s"] = span_total
            stages[stage] = row
        host_budget = {
            "profiles": len(psums),
            "thread_samples": total,
            "hz": max(float(e.get("hz", 0.0)) for e in psums),
            "duty_cycle": max(float(e.get("duty_cycle", 0.0))
                              for e in psums),
            "busy_frac": busy_weighted / total if total else 0.0,
            "overflow_drops": sum(int(e.get("overflow_drops", 0))
                                  for e in psums),
            "stages": stages,
            "roles": dict(sorted(role_samples.items(),
                                 key=lambda kv: -kv[1])),
            "attributed_frac": (
                (total - other) / total if total else 0.0
            ),
        }

    return {
        "n_events": len(events),
        "event_counts": dict(counts),
        "spans": span_stats,
        "throughput": {
            "source": source,
            "timeline": dict(sorted(timeline.items())),
        },
        "serve": serve,
        "fault": fault,
        "durability": durability,
        "replication": repl,
        "sharding": sharding,
        "fleet": fleet,
        "mesh": mesh,
        "kernels": kernels,
        "host_budget": host_budget,
        "stalls": [
            {"where": where, "log": log, **{k: (sorted(v)
                                               if isinstance(v, set)
                                               else v)
                                            for k, v in s.items()}}
            for (where, log), s in sorted(stalls.items())
        ],
    }


def render(report: dict, out=None) -> None:
    # resolve sys.stdout at call time (an import-time default would pin
    # whatever stream was active when the module first loaded)
    w = (out if out is not None else sys.stdout).write
    w(f"trace: {report.get('n_events', 0)} events\n")
    # explicit per-section data statement up front: a section absent
    # below is absent because the trace holds none of its events, not
    # because the report crashed on partial data
    _sections = ("serve", "fault", "durability", "replication",
                 "sharding", "fleet", "mesh", "kernels",
                 "host_budget")
    present = [s for s in _sections if report.get(s)]
    absent = [s for s in _sections if not report.get(s)]
    w(f"sections: {', '.join(present) if present else '(core only)'}"
      + (f"   [no data: {', '.join(absent)}]" if absent else "")
      + "\n")

    w("\n== event counts ==\n")
    for name, n in sorted(report["event_counts"].items(),
                          key=lambda kv: (-kv[1], kv[0])):
        w(f"  {name:<20} {n}\n")

    w("\n== span durations ==\n")
    if not report["spans"]:
        w("  (no spans recorded)\n")
    else:
        w(f"  {'span':<20} {'count':>6} {'p50':>10} {'p95':>10} "
          f"{'p99':>10} {'max':>10} {'total':>10}  fenced\n")
        for name, s in sorted(report["spans"].items(),
                              key=lambda kv: -kv[1]["total_s"]):
            w(f"  {name:<20} {s['count']:>6} {_fmt_s(s['p50_s']):>10} "
              f"{_fmt_s(s['p95_s']):>10} {_fmt_s(s['p99_s']):>10} "
              f"{_fmt_s(s['max_s']):>10} {_fmt_s(s['total_s']):>10}  "
              f"{'yes' if s['fenced'] else 'NO'}\n")

    w("\n== throughput timeline ==\n")
    tl = report["throughput"]["timeline"]
    if not tl:
        w("  (no throughput samples and no append events)\n")
    else:
        src = report["throughput"]["source"]
        if src == "append":
            w("  (derived from append events: appended ops per second)\n")
        peak = max(tl.values()) or 1
        total = 0
        for sec in sorted(int(s) for s in tl):
            ops = tl[sec] if sec in tl else tl[str(sec)]
            total += ops
            bar = "#" * max(1, round(40 * ops / peak))
            w(f"  t+{sec:>4}s {ops:>12} ops  {bar}\n")
        w(f"  total {total} ops over {len(tl)} sampled second(s), "
          f"peak {peak} ops/s\n")

    serve = report.get("serve")
    if serve:
        w("\n== serve ==\n")
        w(f"  {serve['batches']} batch(es), {serve['ops']} ops, "
          f"p50 batch {serve['p50_batch']:.0f}, "
          f"max batch {serve['max_batch']}\n")
        prio = serve.get("shed_by_priority") or {}
        prio_s = (
            " (" + " ".join(f"{k}={v}"
                            for k, v in sorted(prio.items())) + ")"
            if prio else ""
        )
        w(f"  shed (Overloaded): {serve['shed']}{prio_s}   "
          f"evicted: {serve.get('evicted', 0)}   "
          f"deadline-missed: {serve['deadline_miss']}"
          + (f" ({serve['swept_at_admission']} swept at admission)"
             if serve.get("swept_at_admission") else "")
          + (f"   late successes: {serve['late_success']}"
             if serve.get("late_success") else "") + "\n")
        pipe = serve.get("pipeline")
        if pipe:
            w(f"  pipeline overlap: assembly busy "
              f"{100.0 * pipe['assembly_busy_frac']:.0f}% / device "
              f"busy {100.0 * pipe['device_busy_frac']:.0f}% over "
              f"{pipe['window_s']:.1f}s "
              f"({pipe['assemble_events']} assembled round(s))\n")
        retries = serve.get("retries_by_cause") or {}
        if retries:
            w("  client retries by cause: "
              + "   ".join(f"{k}={v}"
                           for k, v in sorted(retries.items()))
              + "\n")
        if serve.get("circuit_transitions"):
            w(f"  circuit-breaker opens: "
              f"{serve['circuit_transitions']}\n")
        if serve.get("brownout_reads") or serve.get(
                "brownout_transitions"):
            trans = " ".join(
                f"{'on' if t['on'] else 'off'}@t+{t['t']}s"
                for t in serve.get("brownout_transitions", [])
            )
            w(f"  brownout: {serve.get('brownout_reads', 0)} "
              f"degraded read(s), max lag "
              f"{serve.get('max_brownout_lag', 0)} pos"
              + (f"   transitions: {trans}" if trans else "") + "\n")
        ltl = serve.get("admit_limit_timeline") or {}
        if ltl:
            w("  adaptive admission limit (min per second):\n")
            peak = max(ltl.values()) or 1
            for sec in sorted(int(s) for s in ltl):
                d = ltl.get(sec, ltl.get(str(sec), 0))
                bar = "#" * max(1, round(30 * d / peak))
                w(f"    t+{sec:>4}s limit {d:>6}  {bar}\n")
        hist = serve["batch_size_hist"]
        if hist:
            w("  batch-size histogram (<= bucket):\n")
            peak = max(hist.values()) or 1
            for bound in sorted(int(b) for b in hist):
                n = hist.get(bound, hist.get(str(bound), 0))
                bar = "#" * max(1, round(30 * n / peak))
                w(f"    <={bound:>5} {n:>8}  {bar}\n")
        tl = serve["queue_depth_timeline"]
        if tl:
            w("  queue-depth timeline (max observed per second):\n")
            peak = max(tl.values()) or 1
            for sec in sorted(int(s) for s in tl):
                d = tl.get(sec, tl.get(str(sec), 0))
                bar = "#" * max(1, round(30 * d / peak))
                w(f"    t+{sec:>4}s depth {d:>6}  {bar}\n")

    fault = report.get("fault")
    if fault:
        w("\n== fault ==\n")
        w(f"  injected: {fault['injected']}   "
          f"quarantines: {fault['quarantines']}   "
          f"repairs: {fault['repairs']}   "
          f"re-homed requests: {fault['rehomed']}\n")
        if fault["repairs"]:
            w(f"  repair duration p50 {_fmt_s(fault['repair_p50_s'])} "
              f"p95 {_fmt_s(fault['repair_p95_s'])} "
              f"max {_fmt_s(fault['repair_max_s'])}\n")
            hist = fault["repair_hist_ms"]
            if hist:
                w("  repair-duration histogram (<= ms bucket):\n")
                peak = max(hist.values()) or 1
                for bound in sorted(int(b) for b in hist):
                    n = hist.get(bound, hist.get(str(bound), 0))
                    bar = "#" * max(1, round(30 * n / peak))
                    w(f"    <={bound:>6}ms {n:>6}  {bar}\n")
        tl = fault["timeline"]
        if tl:
            w("  lifecycle timeline (per replica):\n")
            for rid in sorted(tl, key=int):
                steps = " -> ".join(
                    f"{to}@t+{t}s" for t, _frm, to in tl[rid]
                )
                w(f"    r{rid}: {steps}\n")

    dur = report.get("durability")
    if dur:
        w("\n== durability ==\n")
        w(f"  fsyncs: {dur['fsyncs']}"
          + (f" (p50 {_fmt_s(dur['fsync_p50_s'])} "
             f"p95 {_fmt_s(dur['fsync_p95_s'])} "
             f"p99 {_fmt_s(dur['fsync_p99_s'])})"
             if dur["fsyncs"] else "")
          + f"   torn-tail truncations: {dur['truncations']}   "
            f"reclaimed segments: {dur['reclaimed_segments']}\n")
        w(f"  snapshots: {dur['snapshots']}   "
          f"recoveries: {dur['recoveries']}"
          + (f" ({dur['replayed_ops']} op(s) replayed from WAL)"
             if dur["recoveries"] else "") + "\n")
        if dur["timeline"]:
            w("  timeline:\n")
            for e in dur["timeline"]:
                detail = " ".join(
                    f"{k}={v}" for k, v in e.items()
                    if k not in ("t", "event")
                )
                w(f"    t+{e['t']:>8.3f}s {e['event']:<17} {detail}\n")

    repl = report.get("replication")
    if repl:
        w("\n== replication ==\n")
        w(f"  shipped: {repl['shipped_records']} record(s) / "
          f"{repl['shipped_ops']} op(s)   applied: "
          f"{repl['applied_records']} record(s) / "
          f"{repl['applied_ops']} op(s)\n")
        w(f"  duplicates skipped: {repl['duplicates']}   "
          f"fenced records: {repl['fenced_records']}   "
          f"fenced publishes: {repl['fenced_publishes']}   "
          f"stale reads: {repl['stale_reads']}\n")
        if repl["ship_errors"] or repl["apply_errors"]:
            w(f"  ship errors: {repl['ship_errors']}   "
              f"apply errors: {repl['apply_errors']}\n")
        if repl.get("transport_connects") or repl.get("relay_fenced") \
                or repl.get("transport_errors"):
            w(f"  transport: {repl['transport_connects']} connect(s), "
              f"{repl['transport_reconnects']} reconnect(s), "
              f"{repl['transport_errors']} server error(s)   "
              f"relay fenced: {repl['relay_fenced']}   "
              f"relay errors: {repl['relay_errors']}\n")
        if repl.get("bootstraps") or repl.get("snapshots_served") \
                or repl.get("bootstrap_failures"):
            w(f"  snapshot bootstrap: {repl['bootstraps']} "
              f"bootstrap(s) ({repl['bootstrap_failures']} fell back "
              f"to full replay), {repl['snapshots_served']} "
              f"served / {repl['snapshots_fetched']} fetched\n")
        tl = repl["apply_lag_timeline"]
        if tl:
            w("  apply-lag timeline (max positions behind feed tail "
              "per second):\n")
            peak = max(tl.values()) or 1
            for sec in sorted(int(s) for s in tl):
                lag = tl.get(sec, tl.get(str(sec), 0))
                bar = "#" * max(1, round(30 * lag / peak))
                w(f"    t+{sec:>4}s lag {lag:>8}  {bar}\n")
        for p in repl["promotions"]:
            w(f"  promotion t+{p['t']}s: {p['follower']} -> epoch "
              f"{p['epoch']} at {p['applied']} "
              f"({p['drained_records']} drained); detect "
              f"{_fmt_s(p['detect_s'])} + promote "
              f"{_fmt_s(p['promote_s'])} = RTO {_fmt_s(p['rto_s'])}\n")

    shd = report.get("sharding")
    if shd:
        w("\n== sharding ==\n")
        w(f"  map adoptions: {shd['map_adoptions']} (final version "
          f"{shd['final_map_version']})   refused submits: "
          f"{shd['refused']}\n")
        for a in shd["adoptions"]:
            moved = (",".join(f"s{s}" for s in a["shards"])
                     if a["shards"] else "none")
            w(f"  adoption t+{a['t']}s [{a['reason']}]: "
              f"v{a['from_version']} -> v{a['map_version']}, "
              f"re-homed: {moved}\n")
        if shd["refused"]:
            by_err = "   ".join(
                f"{k}={v}"
                for k, v in sorted(shd["refused_by_error"].items())
            )
            by_shard = "   ".join(
                f"s{k}={v}"
                for k, v in sorted(shd["refused_by_shard"].items())
            )
            w(f"  refusals by error: {by_err}\n")
            w(f"  refusals by shard: {by_shard}\n")

    fleet = report.get("fleet")
    if fleet:
        w("\n== fleet ==\n")
        nds = fleet.get("nodes") or []
        if not nds:
            w("  (no node summaries — events were node-tagged but no "
              "fleet-scrape lines landed)\n")
        for nd in nds:
            parts = [f"{nd.get('node_id', '?'):<18} "
                     f"role={nd.get('role', '?'):<9}"]
            for key, label in (("applied", "applied"),
                               ("ship_lag", "ship-lag"),
                               ("apply_lag", "apply-lag"),
                               ("relay_lag", "relay-lag"),
                               ("completed", "completed"),
                               ("queued", "queued"),
                               ("shed", "shed")):
                v = nd.get(key)
                if v is not None:
                    parts.append(f"{label}={v:g}")
            w("  " + " ".join(parts) + "\n")
        w(f"  {fleet.get('records', 0)} traced record(s), "
          f"{fleet.get('complete_records', 0)} with a full "
          f"submit->ack chain, "
          f"{fleet.get('complete_multiprocess_records', 0)} spanning "
          f">=3 processes   ({fleet.get('scrapes', 0)} scrape(s)"
          + (f", {fleet['scrape_errors']} scrape error(s)"
             if fleet.get("scrape_errors") else "") + ")\n")
        edges = fleet.get("edges") or {}
        if edges:
            w("  per-edge latency:\n")
            for label, s in edges.items():
                w(f"    {label:<24} x{s.get('count', 0):<5} "
                  f"p50 {_fmt_s(s.get('p50_s', 0.0)):>9} "
                  f"p95 {_fmt_s(s.get('p95_s', 0.0)):>9} "
                  f"max {_fmt_s(s.get('max_s', 0.0)):>9}\n")
        else:
            w("  (no joinable per-record hops — enable tracing on "
              "every node and check NR_TPU_TRACE_SAMPLE)\n")
        for tl in (fleet.get("timelines") or [])[:2]:
            w(f"  record @pos {tl.get('pos')} "
              f"({tl.get('processes', 0)} process(es)"
              + (", complete" if tl.get("complete") else "")
              + "):\n")
            for h in tl.get("hops") or []:
                w(f"    t+{float(h.get('t', 0.0)) * 1e3:9.3f}ms "
                  f"{h.get('hop', '?'):<14} @{h.get('node', '?')}\n")

    mesh = report.get("mesh")
    if mesh:
        w("\n== mesh ==\n")
        for pl in mesh["placements"]:
            w(f"  {pl['wrapper']}: {pl['replicas']} replica(s) over "
              f"{pl['devices']} device(s) "
              f"({pl['per_device']}/device), tier {pl['tier']}\n")
        tiers = mesh["rounds_by_tier"]
        if tiers:
            w("  rounds by tier: "
              + "   ".join(f"{k}={v}" for k, v in sorted(tiers.items()))
              + f"   collective time {_fmt_s(mesh['collective_time_s'])}"
                f" (p50 {_fmt_s(mesh['round_p50_s'])} "
                f"p95 {_fmt_s(mesh['round_p95_s'])})\n")
        w(f"  cross-device sync: {mesh['sync_bytes']} byte(s)\n")
        if mesh["ring_execs"]:
            w(f"  ring catch-up: {mesh['ring_execs']} pass(es), "
              f"{mesh['ring_ops']} op(s) rotated over ICI\n")

    kernels = report.get("kernels")
    if kernels:
        w("\n== kernels ==\n")
        lbt = kernels["launches_by_tier"]
        if lbt:
            w("  launches by tier: "
              + "   ".join(f"{k}={v}" for k, v in sorted(lbt.items()))
              + f"   ({kernels['rounds']} fused round(s), "
                f"{kernels['fused_ops']} window op(s))\n")
            w(f"  launch time p50 {_fmt_s(kernels['launch_p50_s'])} "
              f"p95 {_fmt_s(kernels['launch_p95_s'])}\n")
        wh = kernels["window_hist"]
        if wh:
            w("  window sizes: "
              + "   ".join(f"{k}x{v}" for k, v in sorted(wh.items()))
              + "\n")
        sbe = kernels["serve_batches_by_engine"]
        if sbe:
            w("  serve batches by engine: "
              + "   ".join(f"{k}={v}" for k, v in sorted(sbe.items()))
              + "\n")
        for c in kernels["calibrations"]:
            w(f"  winner selection @ window {c['window']}: "
              f"{c['winner']} (fused {_fmt_s(c['fused_s'])} vs chain "
              f"{_fmt_s(c['chain_s'])})\n")

    hb = report.get("host_budget")
    if hb:
        w("\n== host budget ==\n")
        w(f"  {hb['thread_samples']} thread-sample(s) from "
          f"{hb['profiles']} profile(s) at {hb['hz']:g} Hz   "
          f"host busy {100.0 * hb['busy_frac']:.0f}%   "
          f"profiler duty {100.0 * hb['duty_cycle']:.2f}%"
          + (f"   ({hb['overflow_drops']} overflow drop(s))"
             if hb.get("overflow_drops") else "") + "\n")
        w(f"  {'stage':<16} {'samples':>8} {'share':>7} {'span total':>11}\n")
        for stage, s in hb["stages"].items():
            bar = "#" * max(1, round(30 * s["frac"]))
            span_s = (_fmt_s(s["span_total_s"])
                      if "span_total_s" in s else "-")
            w(f"  {stage:<16} {s['samples']:>8} "
              f"{100.0 * s['frac']:>6.1f}% {span_s:>11}  {bar}\n")
        w(f"  attributed to named stages: "
          f"{100.0 * hb['attributed_frac']:.1f}%\n")
        roles = hb.get("roles") or {}
        if roles:
            w("  samples by role: "
              + "   ".join(f"{r}={n}" for r, n in roles.items())
              + "\n")

    w("\n== stall report ==\n")
    if not report["stalls"]:
        w("  (no watchdog events — no replay stalls observed)\n")
    else:
        for s in report["stalls"]:
            where = s["where"] + (
                f" [log {s['log']}]" if s["log"] is not None else ""
            )
            w(f"  {where}: {s['count']} warning(s), up to "
              f"{s['max_rounds']} fruitless rounds; dormant replicas "
              f"{s['dormant']}; last ltail/tail "
              f"{s['last_ltail']}/{s['last_tail']}\n")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m node_replication_torch.obs.report",
        description="Summarize a flight-recorder JSONL trace.",
    )
    p.add_argument("trace", help="path to a JSONL trace "
                                 "(NR_TPU_TRACE=<path> output)")
    p.add_argument("--json", action="store_true",
                   help="emit the report as one JSON object instead of "
                        "the text rendering")
    args = p.parse_args(argv)
    events = load_events(args.trace)
    report = analyze(events)
    try:
        if args.json:
            json.dump(report, sys.stdout, indent=2)
            sys.stdout.write("\n")
        else:
            render(report)
        sys.stdout.flush()
    except BrokenPipeError:
        # downstream pager/head closed the pipe: exit quietly, routing
        # the interpreter-shutdown flush at devnull
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())
