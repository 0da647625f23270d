"""Back-to-back combiner rounds: one thread calls
`NodeReplicated.execute_mut_batch` with `window` ops a round, each
round on a replica drawn from the seed, until the window has passed.

Set-up draws `pool_rounds` distinct rounds from the seed, each with its
ops as the program takes them and its replica, and the rounds run
through that pool in order, from its start again once it is spent. So
the window holds the calls and little else: standard error gives the
share of the window spent outside them (keeping each round's answers,
the loop). The first `warmup_rounds` rounds of the pool run in set-up.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import log
from portbench.traffic import Stream, seed_words, tuples

RID_STREAM = 1 << 20


def draw_pool(spec: dict, model, seed: int) -> list[tuple]:
    """The pool's rounds, each `(opc, args, write)` of `window` ops."""
    w, n_pool = int(spec["window"]), int(spec["pool_rounds"])
    opc, args, write = Stream(spec, model, seed).draw(n_pool * w)
    return [(opc[i * w:(i + 1) * w], args[i * w:(i + 1) * w],
             write[i * w:(i + 1) * w]) for i in range(n_pool)]


def run(run) -> dict:
    spec, model, nr = run.traffic, run.model, run.fleet
    w, n_pool = int(spec["window"]), int(spec["pool_rounds"])
    drawn = draw_pool(spec, model, run.seed)
    batch = tuples(model, *(np.concatenate(x) for x in zip(*drawn)))
    rids = np.random.default_rng(seed_words(run.seed, RID_STREAM)).integers(
        model.n_replicas, size=n_pool).tolist()
    pool = [(drawn[i], batch[i * w:(i + 1) * w], rids[i])
            for i in range(n_pool)]
    del batch
    ops, resps, walls, ends = [], [], [], []

    def one_round(timed: bool):
        drawn, batch, rid = pool[len(ops) % n_pool]
        t = time.perf_counter()
        got = nr.execute_mut_batch(batch, rid)
        if timed:
            end = time.perf_counter()
            walls.append(end - t)
            ends.append(end)
        ops.append(drawn)
        resps.append(got)

    for _ in range(int(spec["warmup_rounds"])):
        one_round(False)
    warm = len(ops)
    t0 = run.open_window()
    t_end = t0 + run.seconds
    traced = None  # rounds inside the device trace's span
    while time.perf_counter() < t_end:
        one_round(True)
        if run.trace_due():
            run.end_trace()
            traced = len(walls)
    t1 = time.perf_counter()
    run.close_window()
    resps = [np.asarray(r, np.int64) for r in resps]
    rounds = len(walls)
    traced = rounds if traced is None else traced
    run.log_slices("rounds", np.asarray(ends) - t0)
    outside = (t1 - t0) - float(np.sum(walls))
    log(f"outside execute_mut_batch: {outside:.4f} s of the window's "
        f"{t1 - t0:.4f} s ({100 * outside / (t1 - t0):.2f}%), "
        f"{1e3 * outside / max(rounds, 1):.4f} ms a round")
    return {
        "driver": "rounds", "window_s": t1 - t0, "rounds": rounds,
        "window": w, "round_wall_s": walls,
        "attempted": rounds * w, "failed": 0,
        "ops": ops, "resps": resps,
        "traced_ops": ops[warm:warm + traced], "traced_rounds": traced,
    }
