"""Fleet collector: scrape N exporters into one merged view.

The port's copy of `node_replication_tpu/obs/collect.py`: the same
series, the same merged `fleet.jsonl` lines, and targets of either
package (the scrape frames are the same).

The cross-process half of the observability layer: a `FleetCollector`
polls every node's `obs/export.py:MetricsExporter` on an interval and
maintains

- a **time-series ring** per `(node_id, series)` — the congestion/lag
  signal plane (`repl.apply_lag_pos`, `serve.queue_depth.*`, admission
  limits, applied positions) a future `Autoscaler` consumes via
  `series()`, bounded at `history` samples per series;
- a **merged trace** (`fleet.jsonl` when `out_path` is given): every
  node's flight-recorder events, each stamped with the node's
  `node_id`/`role` and a fleet-aligned timestamp `t_fleet`, plus one
  `fleet-scrape` summary line per node per cycle. `obs/report.py`'s
  Fleet section joins this file on `(pos, node_id)` into per-record
  cross-process hop timelines.

Clock discipline: monotonic clocks do NOT compare across processes,
so events are never ordered by their raw `mono` stamps. Instead each
scrape response carries the node's wall clock (`now_ts`), the
collector differences it against its OWN wall clock at receive time
(`offset = t_recv - now_ts`, network latency folded in — honest to
within one RTT), and `t_fleet = event.ts + offset` places every
node's events on the collector's single timeline. Within one node,
`pos` causality (submit before append before ship...) breaks the
remaining ties.

Incremental scraping: the collector passes each node its last `seq`
cursor, so a scrape returns only events the collector has not seen
(`Tracer.events_since`) — a ring-mode tracer under load loses only
what the ring evicted between scrapes, and nothing is merged twice.

CLI:

    python -m node_replication_torch.obs.collect \\
        --targets host:p1,host:p2 --out fleet.jsonl --seconds 10

Stdlib plus `obs/export.py`'s client only.
"""

from __future__ import annotations

import collections
import json
import threading
import time

from node_replication_torch.analysis.locks import make_lock
from node_replication_torch.obs.export import (
    ExportError,
    profile_fetch,
    profile_start,
    profile_stop,
    scrape,
)

#: default samples kept per (node, series) ring
DEFAULT_HISTORY = 720


class _Target:
    """One scrape endpoint and its per-node cursor/offset state."""

    __slots__ = ("host", "port", "exporter", "seq", "node_id", "role",
                 "offset", "errors", "last_doc")

    def __init__(self, spec):
        self.exporter = None
        self.host = self.port = None
        self.node_id = None
        self.role = None
        if isinstance(spec, str):
            host, port = spec.rsplit(":", 1)
            self.host, self.port = host, int(port)
        elif isinstance(spec, tuple):
            self.host, self.port = spec[0], int(spec[1])
        else:  # in-process exporter: loopback fast path, no socket —
            # and its identity is known BEFORE the first scrape, so
            # component re-attribution covers events the node emitted
            # before the collector's first cycle
            self.exporter = spec
            self.node_id = spec.node_id
            self.role = spec.role
        self.seq = 0
        self.offset = 0.0
        self.errors = 0
        self.last_doc = None

    def describe(self) -> str:
        if self.exporter is not None:
            return f"in-process:{self.exporter.node_id}"
        return f"{self.host}:{self.port}"

    def fetch(self, timeout_s: float) -> dict:
        if self.exporter is not None:
            return self.exporter.scrape_doc(since=self.seq)
        return scrape(self.host, self.port, since=self.seq,
                      timeout_s=timeout_s)

    def profile_cmd(self, cmd: str, timeout_s: float, **kw) -> dict:
        """Route one remote-capture command to this target (loopback
        fast path for in-process exporters, socket otherwise)."""
        if self.exporter is not None:
            if cmd == "start":
                return self.exporter.profile_start(
                    hz=kw.get("hz"), max_stacks=kw.get("max_stacks"))
            if cmd == "stop":
                return self.exporter.profile_stop()
            return self.exporter.profile_fetch(
                stop=bool(kw.get("stop")))
        if cmd == "start":
            return profile_start(self.host, self.port,
                                 hz=kw.get("hz"),
                                 max_stacks=kw.get("max_stacks"),
                                 timeout_s=timeout_s)
        if cmd == "stop":
            return profile_stop(self.host, self.port,
                                timeout_s=timeout_s)
        return profile_fetch(self.host, self.port,
                             stop=bool(kw.get("stop")),
                             timeout_s=max(timeout_s, 10.0))


class FleetCollector:
    """Scrapes a fleet of exporters on an interval.

        coll = FleetCollector(["127.0.0.1:9101", "127.0.0.1:9102"],
                              interval_s=0.5, out_path="fleet.jsonl")
        coll.start()
        ...
        coll.stop()
        coll.series(node_id, "repl.apply_lag_pos")  # [(t, v), ...]

    Targets may be `"host:port"` strings, `(host, port)` tuples, or
    in-process `MetricsExporter` instances (scraped via `scrape_doc`,
    no socket — deterministic tests and single-process trees). An
    unreachable node is counted and retried next cycle — a flaky
    exporter reads as a stale node, never a dead collector.
    """

    def __init__(
        self,
        targets,
        interval_s: float = 0.5,
        out_path: str | None = None,
        history: int = DEFAULT_HISTORY,
        timeout_s: float = 2.0,
    ):
        self._targets = [_Target(t) for t in targets]
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.out_path = out_path
        self._history = int(history)
        self._lock = make_lock("FleetCollector._lock")
        self._series: dict[tuple[str, str], collections.deque] = {}
        self._latest: dict[str, dict] = {}
        # several exporters can live in ONE process (in-process relay
        # topologies, the follower's frontend exporter next to a
        # relay's) and they all serve the same process-wide tracer —
        # merge each process's event stream exactly once, through the
        # first target that reported its pid
        self._pid_owner: dict[int, str] = {}
        self._t0 = time.monotonic()
        self._cycles = 0
        self._merged_events = 0
        self._fh = open(out_path, "a", buffering=1) if out_path else None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="obs-fleet-collector", daemon=True,
        )

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        if not self._thread.is_alive() and not self._thread.ident:
            self._thread.start()

    def stop(self, final_cycle: bool = True) -> None:
        """Stop the scrape loop; by default run one last cycle so the
        merged trace holds every event emitted before the stop."""
        self._stop.set()
        if self._thread.ident:
            self._thread.join(max(5.0, 2 * self.timeout_s))
        if final_cycle:
            self.collect_once()

    def close(self) -> None:
        self.stop(final_cycle=False)
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "FleetCollector":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.collect_once()
            self._stop.wait(self.interval_s)

    def add_target(self, spec) -> None:
        """Add a scrape endpoint to a live collector (elastic fleets:
        leaves join mid-run). A target that later dies just counts
        scrape errors each cycle — it never stops the loop."""
        with self._lock:
            self._targets.append(_Target(spec))

    # ---------------------------------------------------------- scrape

    def collect_once(self) -> int:
        """One scrape cycle over every target; returns how many nodes
        answered. Callable directly when the loop is not running
        (tests, `--once` tools)."""
        answered = 0
        with self._lock:
            targets = list(self._targets)
        for tgt in targets:
            try:
                doc = tgt.fetch(self.timeout_s)
            except (ExportError, RuntimeError, OSError,
                    ValueError) as e:
                tgt.errors += 1
                self._release_pid_ownership(tgt)
                self._write_line({
                    "event": "fleet-scrape-error",
                    "target": tgt.describe(),
                    "ts": time.time(),  # nrlint: disable=wall-clock-time — merged-trace correlation stamp (module docstring)
                    "cause": f"{type(e).__name__}: {e}",
                })
                continue
            answered += 1
            self._absorb(tgt, doc)
        self._cycles += 1
        return answered

    def _absorb(self, tgt: _Target, doc: dict) -> None:
        t_recv_wall = time.time()  # nrlint: disable=wall-clock-time — cross-process offset estimation (module docstring)
        t_rel = time.monotonic() - self._t0
        tgt.node_id = node = str(doc.get("node_id", tgt.describe()))
        tgt.role = role = str(doc.get("role", "?"))
        tgt.last_doc = doc
        # per-node wall-clock offset onto the collector's timeline
        # (recomputed every cycle: cheap, and it tracks slew)
        now_ts = doc.get("now_ts")
        if now_ts is not None:
            tgt.offset = t_recv_wall - float(now_ts)

        metrics = doc.get("metrics") or {}
        stats = doc.get("stats") or {}
        with self._lock:
            for mname, val in metrics.items():
                if isinstance(val, dict):
                    continue  # histograms are not series points
                self._point(node, mname, t_rel, val)
            for sub, blob in stats.items():
                if not isinstance(blob, dict):
                    continue
                for k, v in blob.items():
                    if isinstance(v, bool) or not isinstance(
                            v, (int, float)):
                        continue
                    self._point(node, f"stats.{sub}.{k}", t_rel, v)
            self._latest[node] = {
                "node_id": node,
                "role": role,
                "t": t_rel,
                "offset": tgt.offset,
                "errors": tgt.errors,
                "metrics": metrics,
                "stats": stats,
            }

        events = doc.get("events") or []
        pid = doc.get("pid")
        owner = True
        if pid is not None:
            with self._lock:
                owner = self._pid_owner.setdefault(
                    int(pid), tgt.describe()
                ) == tgt.describe()
        # only the pid's event owner advances its trace cursor: a
        # non-owner that later inherits ownership (the owner's
        # exporter died) then re-reads the ring from its last MERGED
        # point instead of resuming past events it had been
        # discarding — duplicate hop events are deduped by the report
        # join; silently dropped ones would leave chains incomplete
        if owner:
            tgt.seq = int(doc.get("seq", tgt.seq))
        if owner:
            with self._lock:
                roles = {n: s.get("role", "?")
                         for n, s in self._latest.items()}
                for t in self._targets:
                    if t.node_id and t.node_id not in roles:
                        roles[t.node_id] = t.role or "?"
            for ev in events:
                out = dict(ev)
                # component re-attribution: a shared-process event
                # that names a known node (a relay's `relay-forward`,
                # a follower's stamp) belongs to THAT node in the
                # fleet view, not to whichever co-resident exporter
                # happened to be the pid's canonical event source.
                # A relay's FeedServer stamps `<node>-server`
                # (repl/relay.py) — its wire events belong to the
                # relay too.
                ev_name = ev.get("name")
                if isinstance(ev_name, str) \
                        and ev_name.endswith("-server") \
                        and ev_name[:-len("-server")] in roles:
                    ev_name = ev_name[:-len("-server")]
                if isinstance(ev_name, str) and ev_name in roles:
                    out["node_id"] = ev_name
                    out["role"] = roles[ev_name]
                else:
                    out["node_id"] = node
                    out["role"] = role
                if "ts" in ev:
                    out["t_fleet"] = float(ev["ts"]) + tgt.offset
                self._write_line(out)
            with self._lock:
                self._merged_events += len(events)
        self._write_line({
            "event": "fleet-scrape",
            "node_id": node,
            "role": role,
            "ts": t_recv_wall,
            "t_fleet": t_recv_wall,
            "t": round(t_rel, 3),
            "offset": round(tgt.offset, 6),
            "metrics": metrics,
            "stats": stats,
        })

    # -------------------------------------------------- remote capture

    def _profile_sweep(self, cmd: str, **kw) -> dict[str, dict]:
        """One remote-capture command across every target; a node that
        fails answers as `{"error": ...}` under its name — profiling a
        fleet with one sick node still profiles the rest."""
        out: dict[str, dict] = {}
        with self._lock:
            targets = list(self._targets)
        for tgt in targets:
            key = tgt.node_id or tgt.describe()
            try:
                doc = tgt.profile_cmd(cmd, self.timeout_s, **kw)
            except (ExportError, RuntimeError, OSError,
                    ValueError) as e:
                tgt.errors += 1
                doc = {"error": f"{type(e).__name__}: {e}"}
            out[str(doc.get("node_id", key))] = doc
        return out

    def start_profiles(self, hz: float | None = None,
                       max_stacks: int | None = None) -> dict:
        """Start the sampling profiler on every node
        (`obs/export.py:profile_start` per target)."""
        return self._profile_sweep("start", hz=hz,
                                   max_stacks=max_stacks)

    def stop_profiles(self) -> dict:
        return self._profile_sweep("stop")

    def fetch_profiles(self, stop: bool = True) -> dict[str, dict]:
        """Pull every node's profile document (snapshot + host budget
        + folded stacks), by default stopping the samplers — the
        fleet-wide capture `python -m ...obs.collect --profile` and
        the autoscaler's host-budget input ride on."""
        return self._profile_sweep("fetch", stop=stop)

    def _release_pid_ownership(self, tgt: _Target) -> None:
        """A failing target stops being its process's event-merge
        owner: a surviving co-resident exporter (same pid) takes over
        on its next scrape, so a dead exporter never silences the
        whole process's trace stream."""
        doc = tgt.last_doc
        pid = doc.get("pid") if isinstance(doc, dict) else None
        if pid is None:
            return
        with self._lock:
            if self._pid_owner.get(int(pid)) == tgt.describe():
                del self._pid_owner[int(pid)]

    def _write_line(self, rec: dict) -> None:
        if self._fh is None:
            return
        with self._lock:
            self._fh.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------ state

    def _point(self, node: str, name: str, t: float, v) -> None:
        key = (node, name)
        ring = self._series.get(key)
        if ring is None:
            ring = self._series[key] = collections.deque(
                maxlen=self._history
            )
        ring.append((round(t, 3), v))

    def series(self, node_id: str, name: str) -> list[tuple]:
        """Sampled `(t_seconds, value)` history for one node's series
        (registry scalars plus flattened `stats.<sub>.<key>` numbers) —
        the Autoscaler's input surface."""
        with self._lock:
            return list(self._series.get((str(node_id), str(name)), ()))

    def series_names(self, node_id: str) -> list[str]:
        with self._lock:
            return sorted(n for (nid, n) in self._series
                          if nid == str(node_id))

    def latest(self) -> dict[str, dict]:
        """node_id -> most recent scrape summary (the dashboard's
        input surface)."""
        with self._lock:
            return {k: dict(v) for k, v in self._latest.items()}

    def nodes(self) -> list[str]:
        with self._lock:
            return sorted(self._latest)

    def uptime_s(self) -> float:
        """Seconds on the collector-relative clock every series point
        and `latest()['t']` stamp is measured on."""
        return time.monotonic() - self._t0

    def stats(self) -> dict:
        with self._lock:
            return {
                "targets": [t.describe() for t in self._targets],
                "cycles": self._cycles,
                "nodes": sorted(self._latest),
                "merged_events": self._merged_events,
                "errors": {t.describe(): t.errors
                           for t in self._targets if t.errors},
            }


def main(argv: list[str] | None = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m node_replication_torch.obs.collect",
        description="Scrape a fleet of exporters into a merged "
                    "fleet.jsonl trace + time-series rings.",
    )
    p.add_argument("--targets", required=True,
                   help="comma-separated host:port exporter list")
    p.add_argument("--out", default="fleet.jsonl",
                   help="merged JSONL output path")
    p.add_argument("--interval", type=float, default=0.5)
    p.add_argument("--seconds", type=float, default=10.0,
                   help="how long to collect (0 = one cycle)")
    p.add_argument("--profile", type=float, default=0.0,
                   metavar="SECONDS",
                   help="also run every node's sampling profiler for "
                        "SECONDS and write the fetched profiles to "
                        "<out>.profile.json")
    p.add_argument("--profile-hz", type=float, default=None)
    args = p.parse_args(argv)
    targets = [t.strip() for t in args.targets.split(",") if t.strip()]
    coll = FleetCollector(targets, interval_s=args.interval,
                          out_path=args.out)
    if args.profile > 0:
        coll.start_profiles(hz=args.profile_hz)
    if args.seconds <= 0:
        n = coll.collect_once()
        if args.profile > 0:
            time.sleep(args.profile)
    else:
        coll.start()
        try:
            time.sleep(max(args.seconds, args.profile))
        finally:
            coll.stop()
        n = len(coll.nodes())
    if args.profile > 0:
        profiles = coll.fetch_profiles(stop=True)
        ppath = f"{args.out}.profile.json"
        with open(ppath, "w") as fh:
            json.dump(profiles, fh)
        print(f"# fleet profiles ({len(profiles)} node(s)) -> {ppath}",
              file=sys.stderr)
    st = coll.stats()
    print(f"# collected {st['merged_events']} event(s) from "
          f"{len(st['nodes'])}/{len(st['targets'])} node(s) over "
          f"{st['cycles']} cycle(s) -> {args.out}", file=sys.stderr)
    coll.close()
    return 0 if n else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
