"""The benchmark's tests: the plain reference on hand-worked sequences,
its sorted replay against the loop, the int16 control, the needed-work
byte functions, the lookup of cells and metrics by name, the JAX check,
the trace's reduction, and whole runs on the CPU at small sizes, sound
and with the timed path broken. The `cuda` ones run on the card.

    python -m pytest portbench -q
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, harness, reference, roofline, trace
from portbench.models import hashmap, vspace_flat
from portbench.traffic import Stream

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 77

#: each cell at a size the CPU holds: the same traffic, a few replicas
SMALL = {
    "hashmap-served": {
        "config": {"n_keys": 64, "n_replicas": 4, "log_entries": 1024},
        "traffic": {"clients": 4, "rids": 2, "warmup_ops": 4}},
    "hashmap-rounds": {
        "config": {"n_keys": 64, "n_replicas": 4, "log_entries": 1024},
        "traffic": {"window": 16, "warmup_rounds": 2}},
    "vspace-rounds": {
        "config": {"n_pages": 4096, "n_replicas": 4, "log_entries": 1024},
        "traffic": {"window": 32, "warmup_rounds": 2}},
    "vspace-served": {
        "config": {"n_pages": 4096, "n_replicas": 4, "log_entries": 1024},
        "traffic": {"clients": 4, "rids": 2, "warmup_ops": 4}},
}

#: the served cells and their metrics, which `BENCHMARK.json` leaves out
#: for now (their runs spread wider than a bound may be): their files
#: stay, and these tests run them through the same harness
SERVED = {
    "workloads": [
        {"name": "hashmap-served", "config": "hashmap-r4096",
         "traffic": "served-c16-get-put", "chips": 1, "why": "served"},
        {"name": "vspace-served", "config": "vspace-flat-r256",
         "traffic": "served-c16-identify-map-unmap", "chips": 1,
         "why": "served"}],
    "end_to_end": [
        {"name": n, "unit": u, "better": b, "bound": 0.25,
         "source": "host_clock",
         "workloads": ["hashmap-served", "vspace-served"]}
        for n, u, b in (("acked_ops_s", "ops/s", "higher"),
                        ("ack_p99_ms", "ms", "lower"))],
    "per_layer": [
        {"name": n, "unit": u, "better": "higher", "source": src,
         "layer": layer, "moves": "acked_ops_s",
         "workloads": ["hashmap-served", "vspace-served"]}
        for n, u, src, layer in (
            ("serve_batch_mean", "ops", "program_counter", "serve"),
            ("lock_wait_ms", "ms", "program_counter", "wrapper"),
            ("device_idle_pct.served", "%", "device_trace", "device"))],
}


@pytest.fixture
def served(monkeypatch):
    """`BENCHMARK.json` with the served cells and metrics put back."""
    bench = harness.load_bench()
    for k, extra in SERVED.items():
        bench[k] = bench[k] + extra
    monkeypatch.setattr(harness, "load_bench", lambda root=ROOT: bench)
    return bench


HM = hashmap.Model({"n_keys": 4, "n_replicas": 3})
VS = vspace_flat.Model({"n_pages": 16, "max_span": 4, "n_replicas": 2})


def _ops(rows):
    """`(opc, args, write)` from `(opcode, write, a0, a1, a2)` rows."""
    a = np.array(rows, np.int64)
    return (a[:, 0].astype(np.int32), a[:, 2:].astype(np.int32),
            a[:, 1].astype(bool))


def _both(model, planes, ops):
    """The loop's and the sorted replay's answers and final planes."""
    opc, args, write = ops
    loop = {k: v.numpy().copy() for k, v in planes.items()}
    want = [model.step(loop, int(o), a, bool(w))
            for o, a, w in zip(opc, args, write)]
    sort = {k: v.clone() for k, v in planes.items()}
    got = reference.replay(model, sort, torch.from_numpy(opc),
                           torch.from_numpy(args), torch.from_numpy(write),
                           chunk=3)
    return want, got.tolist(), loop, sort


# ---------------------------------------------------------- reference


def test_hashmap_reference_hand_worked():
    planes = {"val": torch.tensor([10, 20, 30, 40], dtype=torch.int32),
              "pres": torch.ones(4, dtype=torch.bool)}
    P, R, G = hashmap.PUT, hashmap.REMOVE, hashmap.GET
    ops = _ops([(G, 0, 1, 0, 0), (P, 1, 1, 99, 0), (G, 0, 1, 0, 0),
                (R, 1, 1, 0, 0), (R, 1, 1, 0, 0), (G, 0, 1, 0, 0),
                (G, 0, 5, 0, 0), (P, 1, -3, 7, 0), (G, 0, 1, 0, 0),
                (P, 1, 2, 2**31 - 1, 0), (G, 0, 6, 0, 0)])
    want, got, loop, sort = _both(HM, planes, ops)
    expect = [20, 0, 99, 1, 0, -1, -1, 0, 7, 0, 2**31 - 1]
    assert want == expect and got == expect
    for p in (loop, {k: v.numpy() for k, v in sort.items()}):
        assert p["val"].tolist() == [10, 7, 2**31 - 1, 40]
        assert p["pres"].tolist() == [True] * 4


def test_vspace_reference_hand_worked():
    planes = {"val": torch.zeros(16, dtype=torch.int32),
              "pres": torch.zeros(16, dtype=torch.bool)}
    M, U, I = vspace_flat.MAP, vspace_flat.UNMAP, vspace_flat.IDENTIFY
    top = 2**31 - 1
    ops = _ops([
        (M, 1, 2, 100, 3),      # pages 2-4 <- 100-102, all were unmapped
        (I, 0, 3, 0, 0),        # 101
        (M, 1, 3, 200, 4),      # pages 3-6 <- 200-203; 5, 6 were unmapped
        (U, 1, 1, 3, 0),        # pages 1-3: 2 and 3 were mapped
        (I, 0, 2, 0, 0),        # -1
        (M, 1, 14, top - 1, 4),  # pages 14, 15 only: the table ends
        (M, 1, 15, top, 2),     # page 15 again, mapped: 0
        (I, 0, 15, 0, 0),       # 2^31 - 1
        (M, 1, 0, top, 2),      # page 1 <- the int32 wrap of 2^31
        (I, 0, 17, 0, 0),       # page 17 mod 16 = 1: -2^31
        (M, 1, 8, -1, 2),       # page 9 <- 0, reads as unmapped
        (I, 0, 9, 0, 0),        # -1
        (U, 1, 8, 2, 0),        # page 8 mapped, page 9 not: 1
        (M, 1, 10, 5, 9),       # npages clips to max_span 4: pages 10-13
        (U, 1, 12, -3, 0),      # npages below 0: nothing
    ])
    want, got, loop, sort = _both(VS, planes, ops)
    expect = [3, 101, 2, 2, -1, 2, 0, top, 2, -2**31, 2, -1, 1, 4, 0]
    assert want == expect and got == expect
    frames = [top, -2**31, 0, 0, 201, 202, 203, 0, 0, 0, 5, 6, 7, 8,
              top - 1, top]
    assert loop["val"].tolist() == frames
    assert sort["val"].tolist() == frames


def test_vspace_mix_draws_the_sources_spans():
    """As `benches/vspace.py --flat` draws them: MAP's npages is 1 +
    pframe % max_span, UNMAP's npages is the raw 31-bit draw, which
    the model clips to max_span; a client's spans end inside its slice."""
    spec = harness.traffic_mod.load("rounds-w1024-map-unmap")
    model = vspace_flat.Model({"n_pages": 1 << 18, "max_span": 64,
                               "n_replicas": 4})
    opc, args, write = Stream(spec, model, SEED).draw(4000)
    is_map = opc == vspace_flat.MAP
    assert write.all() and 0.7 < is_map.mean() < 0.8
    assert np.array_equal(args[is_map, 2], 1 + args[is_map, 1] % 64)
    unmap = args[~is_map]
    assert (unmap[:, 2] == 0).all() and unmap[:, 1].max() > 1 << 24
    assert (np.minimum(unmap[:, 1], 64) == 64).mean() > 0.99
    served = {**harness.traffic_mod.load("served-c16-identify-map-unmap"),
              "clients": 16}
    opc, args, write = Stream(served, model, SEED, 5).draw(4000)
    span = np.minimum(np.where(opc == vspace_flat.MAP, args[:, 2],
                               args[:, 1]), 64)
    end = args[:, 0].astype(np.int64) + np.where(write, span, 1)
    assert (args[:, 0] >= 5 << 14).all() and (end <= 6 << 14).all()


@pytest.mark.parametrize("cell", ["hashmap-rounds", "vspace-served",
                                  "hashmap-served", "vspace-rounds"])
@pytest.mark.parametrize("seed", [1, SEED])
def test_sorted_replay_equals_loop(cell, seed, served):
    _, _, cfg, spec = harness.load_cell(cell, overrides=SMALL[cell])
    model = harness.load_model(cfg)
    planes = harness.initial_planes(model, seed, "cpu")
    ops = control.control_ops(model, spec, seed, 24)
    cat = [np.concatenate([o[i] for o in ops]) for i in range(3)]
    want, got, loop, sort = _both(model, planes, cat)
    assert want == got
    assert np.array_equal(loop["val"], sort["val"].numpy())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_int16_store_fails_the_comparison(cell, served):
    """The control: the reference in the program's place, kept in
    int16, is judged not correct."""
    checks = control.run_control(cell, SEED, 40, "cpu",
                                 overrides=SMALL[cell])
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def test_exact_reference_passes_its_own_comparison(served):
    _, _, cfg, spec = harness.load_cell("vspace-served",
                                        overrides=SMALL["vspace-served"])
    model = harness.load_model(cfg)
    planes = harness.initial_planes(model, SEED, "cpu")
    ops = control.control_ops(model, spec, SEED, 40)
    ref = {k: v.clone() for k, v in planes.items()}
    resps = [reference.replay(model, ref, *map(torch.from_numpy, o)).numpy()
             for o in ops]
    state = {k: v.expand(4, v.shape[0]) for k, v in ref.items()}
    checks = harness.compare(model, planes, ops, resps, state)
    assert all(v == 0 for v, _ in checks.values())


# ------------------------------------------------------------ rooflines


def test_needed_bytes_hashmap_by_hand():
    # keys 1, 1, 2, 5 (= 1 mod 4): 2 distinct cells; R = 3, W = 4
    ops = _ops([(1, 1, 1, 7, 0), (2, 1, 1, 0, 0), (1, 1, 2, 8, 0),
                (2, 1, 5, 0, 0)])
    b, n = roofline.window_work(HM, [ops], 3)
    # 4 entries x 16 B read, 4 ring slots x 16 B written, 4 answers x 4
    # B, 2 cells x 3 replicas x 5 B read and written
    assert b == 4 * 16 + 4 * 16 + 4 * 4 + 2 * 2 * 3 * 5
    assert n == 4 * 3


def test_needed_bytes_vspace_by_hand():
    # MAP pages 0-2, UNMAP pages 2-3: 4 distinct pages; R = 2, W = 2
    ops = _ops([(1, 1, 0, 9, 3), (2, 1, 2, 2, 0)])
    b, n = roofline.window_work(VS, [ops, ops], 2)
    one = 2 * 16 + 2 * 16 + 2 * 4 + 2 * 4 * 2 * 4
    assert b == 2 * one
    assert n == 2 * 5 * 2


# -------------------------------------------------------- the harness


def test_cells_and_metrics_found_by_name(served):
    bench = harness.load_bench()
    for cell in bench["workloads"]:
        _, _, cfg, spec = harness.load_cell(cell["name"])
        model = harness.load_model(cfg)
        assert harness.load_driver(spec["driver"]).run
        Stream(spec, model, 0).draw(8)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_metrics_per_cell(served):
    bench = harness.load_bench()
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(bench, cell["name"],
                                                        False)}
        per = harness.cell_metrics(bench, cell["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:
            assert m["moves"] in e2e


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    for p in b["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert (ROOT / c["file"]).is_file()
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert w["name"] not in cells and len(w["why"]) <= 200
        cells.add(w["name"])
    metrics = set()
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in metrics and m["better"] in ("lower",
                                                            "higher")
        metrics.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("jax", "jax.numpy", "node_replication_tpu.core",
                 "jaxlib", "flax.linen", "jaxtyping",
                 "node_replication_tpux", "node_replication_t"):
        monkeypatch.setitem(sys.modules, name, object())
    found = harness.forbidden_modules()
    for name in ("jax", "jax.numpy", "node_replication_tpu.core", "jaxlib",
                 "flax.linen"):
        assert name in found
    for name in ("jaxtyping", "node_replication_tpux", "node_replication_t",
                 "node_replication_torch"):
        assert name not in found


def test_quantile_is_nearest_rank():
    assert harness.quantile(range(1, 101), 0.99) == 99
    assert harness.quantile(range(1, 1001), 0.99) == 990
    assert harness.quantile([3.0, float("inf")], 0.99) == float("inf")


def test_trace_reduce_busy_idle_and_gaps():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 40,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": -10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 70,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 95, "dur": 10},
    ]
    s = trace.reduce(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    # device on [0, 30) and [70, 80) and [95, 100): 45 us
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["device_s"] == pytest.approx(20e-6 + 20e-6 + 10e-6 + 5e-6)
    assert trace.kernel_time(s, ("k_a",)) == (pytest.approx(40e-6), 2)
    assert s["gaps"][0] == ("host: aten::copy_", pytest.approx(40e-6))
    assert s["gaps"][1] == ("host: python", pytest.approx(15e-6))


# ------------------------------------------------------- whole runs


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_run_on_the_cpu_is_correct(cell, served):
    r = harness.run_cell(cell, SEED, 1.0, False, device="cpu",
                         overrides=SMALL[cell])
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(served, cell, False)}
    assert "setup_s" in want and set(r["metrics"]) == want
    assert list(r)[-1] == "checks"
    if cell.endswith("served"):
        t = harness.run_cell(cell, SEED, 1.0, True, device="cpu",
                             overrides=SMALL[cell])
        assert t["correct"]
        assert {"serve_batch_mean", "lock_wait_ms"} <= set(t["metrics"])


def _broken(kind):
    """`round_fn` of a fused engine, with the timed path broken."""
    def wrap(orig):
        def round_fn(self, window, fenced=False):
            fn = orig(self, window, fenced)

            def g(log, states, opcodes, args, count, fenced_vec=None):
                if kind == "half":  # the batch's second half left out
                    opcodes = opcodes.clone()
                    opcodes[count // 2:count] = 0
                out = fn(log, states, opcodes, args, count, fenced_vec)
                log2, states2, resps = out
                if kind == "unchanged":  # the state returned as it came
                    states2 = states
                if kind == "answer":  # an answer altered where made
                    resps = resps.clone()
                    resps[:, 0] += 1
                return log2, states2, resps
            return g
        return round_fn
    return wrap


@pytest.mark.parametrize("kind", ["unchanged", "half", "answer"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(cell, kind, monkeypatch, served):
    from node_replication_torch.ops.replay import FusedHashmapEngine
    from node_replication_torch.ops.vspace import FusedVspaceEngine

    for eng in (FusedHashmapEngine, FusedVspaceEngine):
        monkeypatch.setattr(eng, "round_fn", _broken(kind)(eng.round_fn))
    r = harness.run_cell(cell, SEED, 1.0, False, device="cpu",
                         overrides=SMALL[cell])
    assert not r["correct"], r["checks"]


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "hashmap-served", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


# ------------------------------------------------------------ the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,ops", [("hashmap-rounds", 18000),
                                      ("vspace-rounds", 20000)])
def test_control_on_the_card_at_the_cells_size(cell, ops):
    """The int16 control at the cell's own sizes, with about as many
    rounds as a 51 s run of the cell makes, on three seeds: it is never
    judged correct."""
    _need_card()
    for seed in (11, 2**31 + 12, 3 * 10**9 + 13):
        checks = control.run_control(cell, seed, ops, "cuda")
        print(cell, seed, json.dumps(checks))
        assert any(c["value"] > c["limit"] for c in checks.values())

