"""Live fleet dashboard: a refreshing tree view over exporter scrapes.

The port's copy of `node_replication_tpu/obs/top.py`.

    python -m node_replication_torch.obs.top \\
        --targets host:p1,host:p2,host:p3

Runs a `FleetCollector` (`obs/collect.py`) against the given
exporters and redraws one frame per interval: a row per node —
role, applied position, ship/apply/relay lag, adaptive admission
limit, shed count and SLO burn (shed + deadline-missed over
accepted), host-busy % (the sampling profiler's
`obs.host.busy_frac` gauge, "-" on unprofiled nodes),
brownout/circuit state — ordered primary → relays →
followers so the table reads as the tree.

Rendering is a PURE function (`render_frame(latest) -> str`), so the
dashboard is testable without a terminal and scriptable:

- `--once`: print a single frame and exit (CI smoke, cron capture);
- `--frames N`: stop after N redraws;
- default: run until interrupted, using curses when stdout is a
  terminal (falls back to ANSI clear + reprint anywhere else).

Stdlib plus the fleet tooling's own modules (`obs/collect.py`,
`obs/export.py`), so the dashboard runs from any box that can reach
the exporter ports.
"""

from __future__ import annotations

import time

from node_replication_torch.obs.collect import FleetCollector

_ROLE_ORDER = {"router": 0, "primary": 1, "shard": 1, "relay": 2,
               "follower": 3}

_COLUMNS = ("node", "role", "applied", "ship-lag", "apply-lag",
            "limit", "shed", "burn", "host", "p99", "state")


def _num(d, *path):
    cur = d
    for k in path:
        if not isinstance(cur, dict) or k not in cur:
            return None
        cur = cur[k]
    return cur if isinstance(cur, (int, float)) else None


def _fmt(v, pct=False) -> str:
    if v is None:
        return "-"
    if pct:
        return f"{100.0 * v:.1f}%"
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.3g}"
    return f"{int(v)}"


def node_row(summary: dict) -> dict:
    """One dashboard row from one node's latest scrape summary
    (`FleetCollector.latest()` values)."""
    metrics = summary.get("metrics") or {}
    stats = summary.get("stats") or {}
    role = str(summary.get("role", "?"))
    serve = stats.get("serve") if isinstance(stats.get("serve"),
                                             dict) else {}
    overload = serve.get("overload") if isinstance(
        serve.get("overload"), dict) else {}
    limits = overload.get("limits") if isinstance(
        overload.get("limits"), dict) else {}
    limit = min((v for v in limits.values()
                 if isinstance(v, (int, float))), default=None)
    accepted = _num(serve, "accepted")
    shed = _num(serve, "shed")
    missed = _num(serve, "deadline_missed")
    burn = None
    if accepted is not None and (shed or missed):
        burn = ((shed or 0) + (missed or 0)) / max(1, accepted)
    lat = metrics.get("serve.request.latency_s")
    p99 = lat.get("p99") if isinstance(lat, dict) else None
    # host-busy %: published by the node's sampling profiler
    # (obs/profile.py `obs.host.busy_frac` gauge); "-" when the node
    # isn't profiled — the gauge, like the profiler, does not exist
    busy = metrics.get("obs.host.busy_frac")
    if not isinstance(busy, (int, float)):
        busy = None
    state = []
    if overload.get("brownout"):
        state.append("BROWNOUT")
    if (_num(overload, "backpressure") or 0) >= 1:
        state.append("BACKPRESSURE")
    if summary.get("stale"):
        state.append("STALE")
    applied = _num(stats, "follower", "applied")
    if applied is None:
        applied = _num(stats, "relay", "cursor")
    if applied is None:
        applied = _num(stats, "serve", "completed")
    return {
        "node": str(summary.get("node_id", "?")),
        "role": role,
        "order": (_ROLE_ORDER.get(role, 4),
                  str(summary.get("node_id", "?"))),
        "applied": _fmt(applied),
        "ship-lag": _fmt(metrics.get("repl.ship_lag_pos")),
        "apply-lag": _fmt(
            metrics.get("repl.apply_lag_pos")
            if metrics.get("repl.apply_lag_pos") is not None
            else metrics.get("repl.relay.lag_pos")
        ),
        "limit": _fmt(limit),
        "shed": _fmt(shed),
        "burn": _fmt(burn, pct=True) if burn is not None else "-",
        "host": _fmt(busy, pct=True) if busy is not None else "-",
        "p99": (f"{float(p99) * 1e3:.1f}ms"
                if isinstance(p99, (int, float)) else "-"),
        "state": " ".join(state) or "ok",
    }


def render_frame(latest: dict[str, dict], now_s: float | None = None,
                 stale_after_s: float = 5.0) -> str:
    """One dashboard frame from `FleetCollector.latest()`. `now_s` is
    the collector-relative clock (`latest[*]['t']` epoch) used to mark
    nodes whose last scrape is older than `stale_after_s`."""
    rows = []
    for nid in sorted(latest):
        summary = dict(latest[nid])
        if now_s is not None and summary.get("t") is not None:
            summary["stale"] = (now_s - float(summary["t"])
                                > stale_after_s)
        rows.append(node_row(summary))
    rows.sort(key=lambda r: r["order"])
    widths = {c: len(c) for c in _COLUMNS}
    for r in rows:
        for c in _COLUMNS:
            widths[c] = max(widths[c], len(str(r[c])))
    lines = [
        "fleet: "
        + (f"{len(rows)} node(s)" if rows
           else "no nodes answered yet")
    ]
    header = "  ".join(f"{c:<{widths[c]}}" for c in _COLUMNS)
    lines.append(header)
    lines.append("-" * len(header))
    for r in rows:
        # tree shape: indent by role depth so primary -> relay ->
        # follower reads as the topology
        pad = " " * (2 * r["order"][0])
        cells = "  ".join(f"{str(r[c]):<{widths[c]}}"
                          for c in _COLUMNS)
        lines.append((pad + cells)[:200])
    return "\n".join(lines) + "\n"


def _run_plain(coll: FleetCollector, interval_s: float,
               frames: int | None, out) -> None:
    n = 0
    try:
        while frames is None or n < frames:
            coll.collect_once()
            frame = render_frame(coll.latest(), now_s=coll.uptime_s())
            if n and frames is None:
                out.write("\x1b[2J\x1b[H")  # ANSI clear + home
            out.write(frame)
            out.flush()
            n += 1
            if frames is not None and n >= frames:
                break
            time.sleep(interval_s)
    except KeyboardInterrupt:
        pass


def _run_curses(coll: FleetCollector, interval_s: float) -> None:
    import curses

    def loop(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        while True:
            coll.collect_once()
            frame = render_frame(coll.latest(), now_s=coll.uptime_s())
            scr.erase()
            maxy, maxx = scr.getmaxyx()
            for i, line in enumerate(frame.split("\n")[:maxy - 1]):
                scr.addnstr(i, 0, line, maxx - 1)
            scr.refresh()
            t_end = time.monotonic() + interval_s
            while time.monotonic() < t_end:
                if scr.getch() in (ord("q"), 27):
                    return
                time.sleep(0.05)

    curses.wrapper(loop)


def main(argv: list[str] | None = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m node_replication_torch.obs.top",
        description="Live fleet dashboard over metrics-exporter "
                    "scrapes.",
    )
    p.add_argument("--targets", required=True,
                   help="comma-separated host:port exporter list")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit")
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (plain renderer)")
    p.add_argument("--plain", action="store_true",
                   help="never use curses (clear+reprint instead)")
    args = p.parse_args(argv)
    targets = [t.strip() for t in args.targets.split(",") if t.strip()]
    coll = FleetCollector(targets, interval_s=args.interval)
    try:
        if args.once:
            _run_plain(coll, args.interval, frames=1, out=sys.stdout)
            return 0 if coll.nodes() else 1
        if args.frames is not None:
            _run_plain(coll, args.interval, frames=args.frames,
                       out=sys.stdout)
            return 0 if coll.nodes() else 1
        if args.plain or not sys.stdout.isatty():
            _run_plain(coll, args.interval, frames=None,
                       out=sys.stdout)
            return 0
        _run_curses(coll, args.interval)
        return 0
    finally:
        coll.close()


if __name__ == "__main__":
    import sys

    sys.exit(main())
