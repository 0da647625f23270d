"""Metrics exporter: serve one process's observability state on a side
port.

The port's copy of `node_replication_tpu/obs/export.py`: the same
scrape document, the same length+CRC frames and the same Prometheus
text, so either package's client scrapes the other's exporter. A
`MetricsExporter` runs inside every process of a replication tree
(primary frontend, relay, leaf follower: `ServeConfig(obs_port=...)`,
`RelayNode(obs_port=...)`, `Follower(obs_port=...)`) and answers
scrapes with one JSON document:

- the metrics registry `snapshot()` (`obs/metrics.py`),
- the flight recorder's recent trace tail (memory/ring mode,
  incremental via the scraper's cursor: `Tracer.events_since`),
- structured `stats()` blobs registered by the process's subsystems
  (`add_stats`),
- identity: a `node_id` + `role` label every consumer stamps onto
  merged data, and the node's wall clock (`now_ts`) so the collector
  can align per-process clocks without comparing monotonic stamps
  across processes.

Wire format: every message is one frame `u32 length | u32
crc32(payload) | payload`, request and response payloads JSON. Request
kinds: `{"cmd": "scrape"}`, plus the remote-capture plane
(`obs/profile.py`): `profile-start` / `profile-stop` / `profile-fetch`
drive this process's host sampling profiler, and `device-trace` arms
an on-demand `torch.profiler` capture of the CPU and the card, written
as a chrome trace (answered as skipped without a CUDA device, so the
command is safe to broadcast fleet-wide). A torn frame means
"reconnect and re-ask", never bad data.

Scrape it three ways:

- `python -m node_replication_torch.obs.export --scrape host:port`:
  Prometheus-style text exposition on stdout (counters/gauges as
  `nr_tpu_<name>{node=...,role=...}`, the reference's series names;
  histograms as `_count`/`_sum` + quantile series);
- the same CLI with `--json`: the raw scrape document;
- `obs/collect.py:FleetCollector`, the programmatic consumer that
  merges N exporters into one fleet view.

Cost contract: an exporter exists only when a port was asked for
(`obs_port=None` is the default everywhere), so the disabled path adds
no per-operation work; enabled, all cost is on the scrape path.
Stdlib only, apart from `device-trace`, which imports torch when it
is asked for.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
import time
import zlib

from node_replication_torch.analysis.locks import make_lock

logger = logging.getLogger("node_replication_torch")

_FRAME = struct.Struct("<II")  # payload length, crc32(payload)

#: scrape payloads are JSON metric documents, not data-plane streams;
#: anything bigger than this is a framing error, not a big fleet
MAX_FRAME_BYTES = 1 << 24


class ExportError(RuntimeError):
    """A scrape failed (connect, torn frame, bad CRC, closed server)."""


#: `torch.profiler` is one per process, so device captures are too:
#: the live capture thread of any exporter in this process
_capture_lock = make_lock("export._capture_lock")
_capture: dict = {"thread": None, "seq": 0}


# ==========================================================================
# framing (the WAL/transport idiom, self-contained)
# ==========================================================================


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except (TimeoutError, socket.timeout) as e:
            raise ExportError(f"socket timeout mid-frame: {e}") from e
        except OSError as e:
            raise ExportError(f"socket error: {e}") from e
        if not chunk:
            raise ExportError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, payload: bytes) -> None:
    try:
        sock.sendall(
            _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        )
    except (TimeoutError, socket.timeout) as e:
        raise ExportError(f"socket timeout on send: {e}") from e
    except OSError as e:
        raise ExportError(f"socket error on send: {e}") from e


def recv_frame(sock: socket.socket) -> bytes:
    hdr = _recv_exact(sock, _FRAME.size)
    length, crc = _FRAME.unpack(hdr)
    if length > MAX_FRAME_BYTES:
        raise ExportError(f"implausible frame length {length}")
    payload = _recv_exact(sock, length)
    if zlib.crc32(payload) != crc:
        raise ExportError("frame CRC mismatch (torn stream)")
    return payload


# ==========================================================================
# server
# ==========================================================================


class MetricsExporter:
    """Serves this process's registry/tracer/stats over a side port.

        exporter = MetricsExporter(role="primary", port=0)
        host, port = exporter.address         # hand to the collector
        exporter.add_stats("serve", frontend.stats)

    `port=0` binds an ephemeral port (the normal case — publish
    `address` through whatever channel the deployment already has);
    `node_id` defaults to `$NR_TPU_NODE_ID` or `<role>-<pid>` so every
    scrape is attributable without configuration. One exporter per
    process is the natural grain (the registry and tracer are
    process-wide); multiple exporters in one process are legal and
    serve the same registry under their own identities (the in-process
    relay/test topology).
    """

    def __init__(
        self,
        node_id: str | None = None,
        role: str = "node",
        host: str = "127.0.0.1",
        port: int = 0,
        registry=None,
        tracer=None,
        stats_fns: dict | None = None,
        accept_timeout_s: float = 0.2,
        io_timeout_s: float = 5.0,
        auto_start: bool = True,
    ):
        from node_replication_torch.obs.metrics import get_registry
        from node_replication_torch.obs.recorder import get_tracer

        self.role = str(role)
        self.node_id = str(
            node_id
            or os.environ.get("NR_TPU_NODE_ID")
            or f"{self.role}-{os.getpid()}"
        )
        self._registry = registry if registry is not None else get_registry()
        self._tracer = tracer if tracer is not None else get_tracer()
        self.accept_timeout_s = float(accept_timeout_s)
        self.io_timeout_s = float(io_timeout_s)

        # profile_start builds the profiler under this lock, and the
        # profiler get-or-creates its gauges in the registry:
        # nrcheck: lock-order MetricsExporter._lock -> MetricsRegistry._lock — the profiler's gauges are created under the exporter lock
        self._lock = make_lock("MetricsExporter._lock")
        self._stats_fns: dict[str, object] = dict(stats_fns or {})
        self._stop = False
        self._conns: dict[int, socket.socket] = {}
        self._conn_seq = 0
        self._threads: list[threading.Thread] = []
        self._scrapes = 0
        self._scrape_errors = 0
        # remote-capture plane (`obs/profile.py`): the profiler this
        # exporter serves. None until a `profile-start` command (or an
        # owner's `attach_profiler`) creates one — the object-does-
        # not-exist discipline survives remote control: a node nobody
        # profiles never holds a sampler.
        self._profiler = None
        self._profiler_owned = False

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self._sock.settimeout(self.accept_timeout_s)
        self.address: tuple[str, int] = self._sock.getsockname()[:2]

        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"obs-export-{self.node_id}",
            daemon=True,
        )
        if auto_start:
            self.start()

    # -------------------------------------------------------- lifecycle

    @property
    def accept_thread(self) -> threading.Thread:
        """The accept-loop thread — for thread introspection
        (`ServeFrontend.threads()`), not lifecycle."""
        return self._accept_thread

    def start(self) -> None:
        if not self._accept_thread.is_alive() \
                and not self._accept_thread.ident:
            self._accept_thread.start()
            self._tracer.emit("obs-export-serve", node=self.node_id,
                              role=self.role, host=self.address[0],
                              port=self.address[1])

    def close(self) -> None:
        with self._lock:
            if self._stop:
                return
            self._stop = True
            conns = list(self._conns.values())
            threads = list(self._threads)
            prof = self._profiler if self._profiler_owned else None
            self._profiler = None
        if prof is not None:
            prof.stop()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread.ident:
            self._accept_thread.join(5.0)
        for t in threads:
            if t.ident:
                t.join(5.0)

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ stats

    def add_stats(self, name: str, fn) -> None:
        """Register a `() -> dict` provider under `name`; its result is
        embedded in every scrape as `stats[name]`. A provider that
        raises is reported as `{"error": ...}` for that scrape — one
        sick subsystem never takes down the node's whole export."""
        with self._lock:
            self._stats_fns[str(name)] = fn

    def scrape_count(self) -> int:
        # nrcheck: unshared — lock-free poll; one int load
        return self._scrapes

    # ------------------------------------------------- remote capture

    def attach_profiler(self, profiler) -> None:
        """Serve an externally owned `SamplingProfiler` (e.g. the one
        `ServeConfig(profile_hz=...)` builds) instead of creating one
        on the first `profile-start`. Lifecycle stays with the owner:
        `close()` does not stop an attached profiler."""
        with self._lock:
            self._profiler = profiler
            self._profiler_owned = False

    def profile_start(self, hz: float | None = None,
                      max_stacks: int | None = None) -> dict:
        """Start (or resume) this process's sampling profiler — the
        `profile-start` command body, also callable in-process."""
        from node_replication_torch.obs.profile import (
            DEFAULT_HZ,
            DEFAULT_MAX_STACKS,
            SamplingProfiler,
        )

        with self._lock:
            prof = self._profiler
            if prof is None:
                prof = SamplingProfiler(
                    hz=float(hz) if hz else DEFAULT_HZ,
                    max_stacks=(int(max_stacks) if max_stacks
                                else DEFAULT_MAX_STACKS),
                )
                self._profiler = prof
                self._profiler_owned = True
        already = prof.running
        if not already:
            prof.start()
        return {"ok": True, "running": True, "already": already,
                "hz": prof.hz, "node_id": self.node_id}

    def profile_stop(self) -> dict:
        """Stop sampling; the aggregate stays fetchable."""
        with self._lock:
            prof = self._profiler
        if prof is not None:
            prof.stop()
        return {"ok": True, "running": False,
                "had_profiler": prof is not None,
                "node_id": self.node_id}

    def profile_fetch(self, stop: bool = False) -> dict:
        """The profile document: snapshot + folded text, stamped with
        this node's identity (the `profile-fetch` command body)."""
        from node_replication_torch.obs.profile import (
            folded_from_snapshot,
            host_budget,
        )

        with self._lock:
            prof = self._profiler
        if prof is None:
            raise ValueError(
                "no profiler on this node (send profile-start first, "
                "or attach one in-process)"
            )
        if stop:
            prof.stop()
        snap = prof.snapshot()
        return {
            "node_id": self.node_id,
            "role": self.role,
            "pid": os.getpid(),
            "profile": snap,
            "budget": host_budget(snap),
            "folded": folded_from_snapshot(snap),
        }

    def device_trace(self, out_dir: str,
                     duration_s: float = 3.0,
                     force: bool = False) -> dict:
        """Arm an on-demand `torch.profiler` capture (CPU and CUDA
        activities) for `duration_s` (the `device-trace` command body).
        A capture thread profiles for the duration, then writes the
        chrome trace to `path` (in the answer) under `out_dir`; the
        file appears, whole, when the capture ends. Guarded off the
        card: without a CUDA device it answers `{"ok": False,
        "skipped": ...}` unless `force` (which captures the CPU alone),
        so the command is safe to broadcast across a mixed fleet. Only one
        `torch.profiler` can run in a process: a request while any
        exporter of this process captures answers "capture in
        progress"."""
        if not out_dir:
            raise ValueError("device-trace needs a 'dir' to write to")
        try:
            import torch
        except ImportError as e:  # torch-less box: obs/ stays stdlib
            return {"ok": False,
                    "skipped": f"torch unavailable: {type(e).__name__}"}
        backend = "cuda" if torch.cuda.is_available() else "cpu"
        if backend != "cuda" and not force:
            return {"ok": False, "backend": backend,
                    "skipped": f"device trace requires a CUDA device "
                               f"(have {backend!r}); pass force to "
                               f"capture anyway"}
        with _capture_lock:
            t = _capture["thread"]
            if t is not None and t.is_alive():
                return {"ok": False, "skipped": "capture in progress"}
            _capture["seq"] += 1
            path = os.path.join(
                str(out_dir), f"{self.node_id}-{os.getpid()}-"
                              f"{_capture['seq']}.trace.json")
            t = threading.Thread(
                target=self._capture,
                args=(path, float(duration_s), backend),
                name=f"obs-device-trace-{self.node_id}",
                daemon=True,
            )
            _capture["thread"] = t
            # started under the lock: a racing request sees it alive
            t.start()
        return {"ok": True, "dir": str(out_dir),
                "duration_s": float(duration_s), "backend": backend,
                "path": path}

    def _capture(self, path: str, duration_s: float,
                 backend: str) -> None:
        """The capture thread: profile for `duration_s`, emit
        `obs-device-trace` (the capture's window), then publish the chrome
        trace at `path`, written aside and renamed so a reader never
        sees half a file. A failure is logged and emitted as
        `obs-device-trace` with `ok: false`."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if backend == "cuda":
            acts.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with profile(activities=acts) as prof:
                t_start = time.monotonic()
                time.sleep(duration_s)
                t_stop = time.monotonic()
            # the capture window, on this process's monotonic clock
            self._tracer.emit("obs-device-trace", node=self.node_id,
                              ok=True, path=path, backend=backend,
                              duration_s=duration_s,
                              mono_start=t_start, mono_stop=t_stop)
            tmp = path + ".part"
            prof.export_chrome_trace(tmp)
            os.replace(tmp, path)
        # the capture thread serves no future and no replica: its
        # failure is logged and emitted as `obs-device-trace ok: false`
        # nrlint: disable=swallowed-worker-exception — reported on the trace, which the report and the requester read
        except Exception as e:
            logger.exception("obs exporter %s: device trace failed",
                             self.node_id)
            self._tracer.emit("obs-device-trace", node=self.node_id,
                              ok=False,
                              cause=f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------ serve

    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
            try:
                conn, _addr = self._sock.accept()
            except (TimeoutError, socket.timeout):
                continue  # the periodic stop-flag check
            except OSError:
                with self._lock:
                    stopping = self._stop
                if stopping:
                    return
                continue
            conn.settimeout(self.io_timeout_s)
            with self._lock:
                if self._stop:
                    conn.close()
                    return
                cid = self._conn_seq
                self._conn_seq += 1
                self._conns[cid] = conn
                t = threading.Thread(
                    target=self._serve_conn, args=(cid, conn),
                    name=f"obs-export-conn-{self.node_id}-{cid}",
                    daemon=True,
                )
                self._threads.append(t)
                self._threads = [x for x in self._threads
                                 if x.is_alive() or not x.ident]
            t.start()

    def _serve_conn(self, cid: int, conn: socket.socket) -> None:
        try:
            while True:
                with self._lock:
                    if self._stop:
                        return
                try:
                    req = recv_frame(conn)
                except ExportError:
                    return  # scraper went away; it re-asks on reconnect
                try:
                    payload = self._handle(req)
                except Exception as e:
                    # answered, never swallowed: the failure is
                    # counted/logged and the scraper sees it as a
                    # typed JSON error document
                    self._record_failure(e, cid)
                    payload = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    ).encode()
                send_frame(conn, payload)
        except ExportError:
            return
        finally:
            with self._lock:
                self._conns.pop(cid, None)
            try:
                conn.close()
            except OSError:
                pass

    def _record_failure(self, exc: Exception, cid: int) -> None:
        """Count + log a scrape-handling failure (the sanctioned
        worker-exception path: the error is also RETURNED to the
        scraper as a typed JSON document by the caller)."""
        with self._lock:
            self._scrape_errors += 1
        logger.exception("obs exporter %s: scrape failed on conn %d",
                         self.node_id, cid)

    def _handle(self, req: bytes) -> bytes:
        msg = json.loads(req.decode("utf-8"))
        cmd = msg.get("cmd")
        if cmd == "scrape":
            doc = self.scrape_doc(since=int(msg.get("since", 0)))
            with self._lock:
                self._scrapes += 1
        elif cmd == "profile-start":
            doc = self.profile_start(hz=msg.get("hz"),
                                     max_stacks=msg.get("max_stacks"))
        elif cmd == "profile-stop":
            doc = self.profile_stop()
        elif cmd == "profile-fetch":
            doc = self.profile_fetch(stop=bool(msg.get("stop")))
        elif cmd == "device-trace":
            doc = self.device_trace(
                msg.get("dir"),
                duration_s=float(msg.get("duration_s", 3.0)),
                force=bool(msg.get("force")),
            )
        else:
            raise ValueError(f"unknown command {cmd!r}")
        return json.dumps(doc).encode()

    def scrape_doc(self, since: int = 0) -> dict:
        """One scrape document (also callable in-process — the
        collector's loopback fast path and the tests' ground truth)."""
        seq, events = self._tracer.events_since(since)
        stats: dict[str, object] = {}
        with self._lock:
            fns = list(self._stats_fns.items())
        for name, fn in fns:
            try:
                stats[name] = fn()
            # the failure IS recorded — into the scrape document the
            # caller returns to the scraper, keyed under the sick
            # provider's name — so nothing is swallowed; the usual
            # future/health sinks do not exist on a scrape path
            # nrlint: disable=swallowed-worker-exception
            except Exception as e:
                stats[name] = {"error": f"{type(e).__name__}: {e}"}
        return {
            "node_id": self.node_id,
            "role": self.role,
            "pid": os.getpid(),
            # wall clock as the CROSS-PROCESS correlation stamp: the
            # collector differences it against its own wall clock at
            # receive time to estimate a per-node offset; monotonic
            # stamps never compare across processes
            "now_ts": time.time(),  # nrlint: disable=wall-clock-time — cross-process correlation field (module docstring)
            "now_mono": time.monotonic(),
            "seq": seq,
            "metrics": self._registry.snapshot(),
            "stats": stats,
            "events": events,
        }


# ==========================================================================
# client
# ==========================================================================


def request(host: str, port: int, msg: dict,
            timeout_s: float = 5.0) -> dict:
    """One framed JSON command round-trip against an exporter. Raises
    `ExportError` on any transport failure and `RuntimeError` on a
    server-side error document."""
    try:
        sock = socket.create_connection((host, int(port)),
                                        timeout=timeout_s)
    except OSError as e:
        raise ExportError(
            f"cannot connect to exporter {host}:{port}: {e}"
        ) from e
    try:
        sock.settimeout(timeout_s)
        send_frame(sock, json.dumps(msg).encode())
        doc = json.loads(recv_frame(sock).decode("utf-8"))
    finally:
        try:
            sock.close()
        except OSError:
            pass
    if "error" in doc and "node_id" not in doc:
        raise RuntimeError(f"exporter error: {doc['error']}")
    return doc


def scrape(host: str, port: int, since: int = 0,
           timeout_s: float = 5.0) -> dict:
    """One scrape round-trip (see `request` for the error contract)."""
    return request(host, port,
                   {"cmd": "scrape", "since": int(since)},
                   timeout_s=timeout_s)


def profile_start(host: str, port: int, hz: float | None = None,
                  max_stacks: int | None = None,
                  timeout_s: float = 5.0) -> dict:
    """Start the remote node's sampling profiler (`obs/profile.py`)."""
    msg: dict = {"cmd": "profile-start"}
    if hz is not None:
        msg["hz"] = float(hz)
    if max_stacks is not None:
        msg["max_stacks"] = int(max_stacks)
    return request(host, port, msg, timeout_s=timeout_s)


def profile_stop(host: str, port: int,
                 timeout_s: float = 5.0) -> dict:
    """Stop the remote node's sampling profiler (aggregate survives)."""
    return request(host, port, {"cmd": "profile-stop"},
                   timeout_s=timeout_s)


def profile_fetch(host: str, port: int, stop: bool = False,
                  timeout_s: float = 10.0) -> dict:
    """Fetch the remote node's profile document (snapshot + host
    budget + folded stacks); `stop=True` halts sampling first."""
    return request(host, port,
                   {"cmd": "profile-fetch", "stop": bool(stop)},
                   timeout_s=timeout_s)


def device_trace(host: str, port: int, out_dir: str,
                 duration_s: float = 3.0, force: bool = False,
                 timeout_s: float = 5.0) -> dict:
    """Arm a `torch.profiler` device capture on the remote node
    (answered as skipped without a CUDA device unless `force`)."""
    return request(host, port,
                   {"cmd": "device-trace", "dir": str(out_dir),
                    "duration_s": float(duration_s),
                    "force": bool(force)},
                   timeout_s=timeout_s)


# ==========================================================================
# Prometheus-style text exposition
# ==========================================================================


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() else "_")
    s = "".join(out)
    return s if s[:1].isalpha() else f"m_{s}"


def _prom_escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def to_prometheus(doc: dict) -> str:
    """Render a scrape document as Prometheus text exposition. Every
    series carries the node's identity labels; histograms expose
    `_count`/`_sum` plus the snapshot's precomputed quantiles (the
    summary shape — the registry keeps fixed buckets internally but
    snapshots percentile estimates, `obs/metrics.py`)."""
    labels = (f'node="{_prom_escape(doc.get("node_id", "?"))}",'
              f'role="{_prom_escape(doc.get("role", "?"))}"')
    lines = [
        f'# scrape of node_id={doc.get("node_id", "?")} '
        f'role={doc.get("role", "?")} pid={doc.get("pid", "?")}',
    ]
    for name, val in sorted((doc.get("metrics") or {}).items()):
        pname = "nr_tpu_" + _prom_name(name)
        if isinstance(val, dict):  # histogram snapshot
            lines.append(f"# TYPE {pname} summary")
            lines.append(
                f'{pname}_count{{{labels}}} {int(val.get("count", 0))}'
            )
            lines.append(
                f'{pname}_sum{{{labels}}} {float(val.get("sum", 0.0))}'
            )
            for q, key in (("0.5", "p50"), ("0.95", "p95"),
                           ("0.99", "p99")):
                if key in val:
                    lines.append(
                        f'{pname}{{{labels},quantile="{q}"}} '
                        f'{float(val[key])}'
                    )
        else:
            # registry counters snapshot as int, gauges as float —
            # a distinction JSON round-trips faithfully
            kind = "gauge" if isinstance(val, float) else "counter"
            lines.append(f"# TYPE {pname} {kind}")
            lines.append(f"{pname}{{{labels}}} {val}")
    lines.append(
        f'nr_tpu_trace_events_total{{{labels}}} '
        f'{int(doc.get("seq", 0))}'
    )
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m node_replication_torch.obs.export",
        description="Scrape a MetricsExporter and print its state.",
    )
    p.add_argument("--scrape", required=True, metavar="HOST:PORT",
                   help="exporter address to scrape once")
    p.add_argument("--json", action="store_true",
                   help="print the raw scrape document instead of "
                        "Prometheus text exposition")
    p.add_argument("--timeout", type=float, default=5.0)
    args = p.parse_args(argv)
    host, port = args.scrape.rsplit(":", 1)
    try:
        doc = scrape(host, int(port), timeout_s=args.timeout)
    except (ExportError, RuntimeError, ValueError) as e:
        print(f"# scrape failed: {e}", file=sys.stderr)
        return 1
    if args.json:
        json.dump(doc, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(to_prometheus(doc))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
