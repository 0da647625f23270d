"""Closed-loop clients of a `ServeFrontend`: each of `clients` threads
sends one op, waits for its answer and sends the next, writes through
`ServeFrontend.submit` and reads through `ServeFrontend.read`, on
served rid `client % rids`, until the window has passed.

Each client first sends `warmup_ops` ops in set-up; the window opens
when every client has. An op sent in the window counts in the tail
with its whole wait, also if its answer comes after the close; an op
that raises counts as never answered. Answers are awaited up to
`answer_timeout_s` past the close.

Each client's keys are its own (`scope` `client`), so every answer
follows from that client's history alone, whatever the interleaving.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from portbench.harness import TRACE_S, UNANSWERED
from portbench.traffic import Stream, tuples

CHUNK = 4096
#: the longest a client or the main thread waits for the others at a barrier
BARRIER_S = 300.0


def run(run) -> dict:
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    spec, model, nr = run.traffic, run.model, run.fleet
    if spec["keys"]["scope"] != "client":
        raise ValueError("served answers are judged against each client's "
                         "own history: the mix needs keys of scope client")
    n_clients, n_rids = int(spec["clients"]), int(spec["rids"])
    cfg = ServeConfig(queue_depth=int(spec["queue_depth"]),
                      batch_max_ops=int(spec["batch_max_ops"]),
                      batch_linger_s=float(spec["batch_linger_s"]),
                      pipeline_depth=int(spec["pipeline_depth"]))
    warm = int(spec["warmup_ops"])
    timeout = float(spec["answer_timeout_s"])
    streams = [Stream(spec, model, run.seed, c) for c in range(n_clients)]
    drawn = [[s.draw(CHUNK)] for s in streams]
    batches = [[tuples(model, *d)] for d in (x[0] for x in drawn)]
    recs = [[] for _ in range(n_clients)]  # (t_sent, t_answered, resp)
    errors: list[str] = []
    warmed = threading.Barrier(n_clients + 1)
    start = threading.Barrier(n_clients + 1)
    bounds = {}

    def client(c: int) -> None:
        rid = c % n_rids
        rec = recs[c]
        i = 0

        def one(op_i: int) -> None:
            chunk, j = divmod(op_i, CHUNK)
            while chunk >= len(batches[c]):
                d = streams[c].draw(CHUNK)
                drawn[c].append(d)
                batches[c].append(tuples(model, *d))
            op = batches[c][chunk][j]
            write = bool(drawn[c][chunk][2][j])
            t = time.perf_counter()
            try:
                if write:
                    r = fe.submit(op, rid=rid).result(timeout=timeout)
                else:
                    r = fe.read(op, rid=rid)
            except Exception as e:  # an op that never answers: recorded
                errors.append(f"client {c} op {op_i}: "
                              f"{type(e).__name__}: {e}")
                r = None
            rec.append((t, time.perf_counter(), r))

        while i < warm:
            one(i)
            i += 1
        warmed.wait(timeout=BARRIER_S)
        start.wait(timeout=BARRIER_S)
        t_end = bounds["t_end"]
        while time.perf_counter() < t_end:
            one(i)
            i += 1

    fe = ServeFrontend(nr, cfg, rids=range(n_rids))
    try:
        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"portbench-client-{c}")
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        warmed.wait(timeout=BARRIER_S)
        t0 = run.open_window()
        t_end = t0 + run.seconds
        bounds["t_end"] = t_end
        start.wait(timeout=BARRIER_S)
        if run.capture is not None:
            time.sleep(max(0.0, min(t_end, t0 + TRACE_S)
                           - time.perf_counter()))
            run.end_trace()
        deadline = time.monotonic() + run.seconds + timeout + 5
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        hung = sum(t.is_alive() for t in threads)
        run.close_window()
    finally:
        fe.close()
    if hung:
        errors.append(f"{hung} client threads still waiting after "
                      f"{timeout} s past the close")

    lat, acked, attempted, failed = [], 0, 0, 0
    ops, resps = [], []
    for c in range(n_clients):
        rec = recs[c]
        n = len(rec)
        opc = np.concatenate([d[0] for d in drawn[c]])[:n]
        args = np.concatenate([d[1] for d in drawn[c]])[:n]
        write = np.concatenate([d[2] for d in drawn[c]])[:n]
        ops.append((opc, args, write))
        resps.append(np.array([UNANSWERED if r is None else r
                               for _, _, r in rec], np.int64))
        for t_s, t_a, r in rec[warm:]:
            attempted += 1
            if r is None:
                failed += 1
                lat.append(float("inf"))
                continue
            lat.append(t_a - t_s)
            if t_a <= t_end:
                acked += 1
    done = [t_a - t0 for rec in recs for _, t_a, r in rec[warm:]
            if r is not None and t_a <= t_end]
    run.log_slices("acks", done)
    return {
        "driver": "served", "window_s": t_end - t0, "acked": acked,
        "latency_s": lat, "attempted": attempted, "failed": failed,
        "unanswered": failed + (hung > 0), "errors": errors[:10],
        "ops": ops, "resps": resps,
    }
