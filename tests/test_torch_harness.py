"""The port's harness (`node_replication_torch/harness/`) on the CPU.

Twins of `tests/test_harness.py` (workloads, runners, sweeps and CSVs,
the sharded runners on device lists of `cpu` entries, the mesh curve),
of `tests/test_partitioned.py::TestRunnerRekey`, and of the three obs
tests that need the harness (`tests/test_obs.py::TestHarnessTraceThroughput`,
`TestCsvSchemaUpgrade`, `tests/test_trace.py::TestHarnessMeasureEvents`);
then differential checks against the reference harness in the same
process, all exact (integer data, tolerance 0): workloads for the same
seed, every runner's state, ltails and tail after the same batches, the
CSV schemas and row builders, and `measure_kernel`'s tiers against the
reference's scan tier. Durations are 0.1 s or less.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

import node_replication_tpu.harness.mkbench as j_mk
import node_replication_tpu.harness.trait as j_trait
from node_replication_tpu.core.log import log_append as j_log_append
from node_replication_tpu.core.log import log_exec_all as j_log_exec_all
from node_replication_tpu.core.log import log_init as j_log_init
from node_replication_tpu.core.replica import replicate_state as j_replicate
from node_replication_tpu.harness.workloads import (
    generate_batches as j_generate_batches,
)
from node_replication_tpu.harness.workloads import zipf_keys as j_zipf_keys
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.models import (
    make_partitioned_hashmap as j_make_partitioned_hashmap,
)

import node_replication_torch.harness.mkbench as mk
from node_replication_torch.harness import (
    ConcurrentDsRunner,
    MultiLogRunner,
    PartitionedRunner,
    ReplicatedRunner,
    ScaleBenchBuilder,
    ShardedRunner,
    WorkloadSpec,
    baseline_comparison,
    generate_batches,
    zipf_keys,
)
from node_replication_torch.harness.mkbench import measure_step_runner
from node_replication_torch.harness.trait import ShardedCnrRunner
from node_replication_torch.harness.workloads import split_write_read
from node_replication_torch.models import (
    HM_GET,
    HM_PUT,
    make_hashmap,
    make_partitioned_hashmap,
)
from node_replication_torch.parallel.mesh import (
    ReplicaStrategy,
    strategy_devices,
)
from node_replication_torch.parallel.topology import MachineTopology
from node_replication_torch.utils.trace import get_tracer

CPU = "cpu"
CPUS8 = [CPU] * 8


def _leaves_eq(a, b, what=""):
    """A reference tree (jax arrays) equals a port tree (tensors or
    numpy), leaf for leaf, dtype and value."""
    ja = [np.asarray(x) for x in jax.tree.leaves(a)]
    tb = [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
          for x in jax.tree.leaves(b)]
    assert len(ja) == len(tb), what
    for x, y in zip(ja, tb):
        assert x.dtype == y.dtype, (what, x.dtype, y.dtype)
        assert np.array_equal(x, y), what


class TestWorkloads:
    def test_shapes_and_determinism(self):
        spec = WorkloadSpec(keyspace=100, seed=3)
        a = generate_batches(spec, 4, 2, 3, 5)
        b = generate_batches(spec, 4, 2, 3, 5)
        assert a[0].shape == (4, 2, 3)
        assert a[1].shape == (4, 2, 3, 3)
        assert a[2].shape == (4, 2, 5)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert a[1][..., 0].max() < 100

    def test_zipf_skew(self):
        rng = np.random.default_rng(0)
        ks = zipf_keys(rng, 20_000, 1000, theta=1.2)
        assert ks.min() >= 0 and ks.max() < 1000
        # zipf: the hottest key dominates a uniform draw's share
        hot_share = np.bincount(ks, minlength=1000).max() / len(ks)
        assert hot_share > 0.05

    def test_split_write_read(self):
        assert split_write_read(10, 0) == (0, 10)
        assert split_write_read(10, 100) == (10, 0)
        bw, br = split_write_read(10, 50)
        assert bw + br == 10 and bw >= 1 and br >= 1


class TestRunnerCorrectness:
    def test_nr_matches_concurrent_baseline(self):
        # Same op stream: NR fleet replicas must converge to exactly the
        # state of the single un-replicated structure
        spec = WorkloadSpec(keyspace=64, seed=11)
        gen = generate_batches(spec, 6, 2, 4, 2)
        nr = ReplicatedRunner(make_hashmap(64), 2, 4, 2,
                              log_capacity=1 << 10, device=CPU)
        cc = ConcurrentDsRunner(make_hashmap(64), 2, 4, 2, device=CPU)
        nr.prepare(*gen)
        cc.prepare(*gen)
        for s in range(6):
            nr.run_step(s)
            cc.run_step(s)
        nr.block()
        cc.block()
        assert nr.replicas_equal()
        a, b = nr.state_dump(0), cc.state_dump()
        np.testing.assert_array_equal(a["values"], b["values"])
        np.testing.assert_array_equal(a["present"], b["present"])

    def test_partitioned_applies_own_batch_only(self):
        spec = WorkloadSpec(keyspace=32, seed=5)
        gen = generate_batches(spec, 2, 2, 3, 1)
        pr = PartitionedRunner(make_hashmap(32), 2, 3, 1, device=CPU)
        pr.prepare(*gen)
        for s in range(2):
            pr.run_step(s)
        pr.block()
        own_keys = set(gen[1][:, 0, :, 0].reshape(-1).tolist())
        st0 = pr.state_dump(0)
        present_keys = set(np.nonzero(st0["present"])[0].tolist())
        assert present_keys == {k % 32 for k in own_keys}

    def test_multilog_runner_runs_and_converges(self):
        spec = WorkloadSpec(keyspace=64, seed=7)
        gen = generate_batches(spec, 4, 2, 4, 2)
        ml = MultiLogRunner(make_hashmap(64), 2, 4, 4, 2, device=CPU)
        ml.prepare(*gen)
        for s in range(4):
            ml.run_step(s)
        ml.block()
        # skew-faithful hash routing: per-log depths differ, but the
        # whole stream (4 steps x 2 replicas x 4 writes) was appended
        st = ml.stats()
        assert st["appended_total"] == 4 * 2 * 4
        assert ml.ml.tail.tolist() == st["per_log_tail"]
        sa = ml.state_dump(0)
        sb = ml.state_dump(1)
        np.testing.assert_array_equal(sa["values"], sb["values"])

    def test_multilog_runner_zipf_imbalance_is_visible(self):
        # a zipf-hot stream concentrates its conflict class on one log;
        # the runner must NOT launder it into balanced buckets
        spec = WorkloadSpec(keyspace=64, seed=3, distribution="skewed",
                            zipf_theta=1.5)
        gen = generate_batches(spec, 4, 4, 8, 1)
        ml = MultiLogRunner(make_hashmap(64), 4, 4, 8, 1, device=CPU)
        ml.prepare(*gen)
        for s in range(4):
            ml.run_step(s)
        ml.block()
        st = ml.stats()
        assert st["appended_total"] == 4 * 4 * 8
        assert st["imbalance"] > 1.2, st
        counts = ml._counts.numpy()
        assert counts.shape == (4, 4)
        assert counts.sum() == 4 * 4 * 8
        assert counts.max() > counts.min()

    def test_multilog_rekey_respects_congruence(self):
        spec = WorkloadSpec(keyspace=64, seed=9)
        gen = generate_batches(spec, 2, 2, 4, 1)
        ml = MultiLogRunner(make_hashmap(64), 2, 4, 4, 1, device=CPU)
        ml.prepare(*gen)
        args = ml._w[1].numpy()
        for log in range(4):
            assert np.all(args[:, log, :, 0] % 4 == log)


class TestSweepAndCsv:
    def test_scalebench_sweep_writes_csv(self, tmp_path):
        res = (
            ScaleBenchBuilder(
                lambda: make_hashmap(64), "t", WorkloadSpec(keyspace=64),
                device=CPU,
            )
            .replicas([2, 4])
            .log_strategies([1])
            .batches([8])
            .systems(["nr", "partitioned"])
            .duration(0.1)
            .out_dir(str(tmp_path))
            .run()
        )
        assert len(res) == 4  # 2 replica counts x 2 systems
        path = tmp_path / "scaleout_benchmarks.csv"
        assert path.exists()
        with open(path) as f:
            rows = list(csv.DictReader(f))
        assert {r["rs"] for r in rows} == {"2", "4"}
        assert all(int(r["ops"]) > 0 for r in rows)
        # wr=50 at batch 8 is exactly 4/8
        assert all(float(r["wr_eff"]) == 50.0 for r in rows)

    def test_csv_schema_upgrade_pads_old_rows(self, tmp_path):
        from node_replication_torch.harness.mkbench import (
            _CSV_FIELDS,
            _append_csv,
        )

        path = tmp_path / "scaleout_benchmarks.csv"
        old_fields = [f for f in _CSV_FIELDS if f != "wr_eff"]
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=old_fields)
            w.writeheader()
            w.writerow({k: "1" for k in old_fields})
        _append_csv(str(path), _CSV_FIELDS,
                    [dict({k: "2" for k in old_fields}, wr_eff=9.4)])
        with open(path) as f:
            rows = list(csv.DictReader(f))
        assert rows[0]["wr_eff"] == ""
        assert rows[1]["wr_eff"] == "9.4"
        assert [r["name"] for r in rows] == ["1", "2"]

    def test_baseline_comparison_writes_csv(self, tmp_path):
        res = baseline_comparison(
            lambda: make_hashmap(64), "hm", WorkloadSpec(keyspace=64),
            batch_sizes=[8], duration_s=0.1, out_dir=str(tmp_path),
            device=CPU,
        )
        assert len(res) == 2
        assert (tmp_path / "baseline_comparison.csv").exists()
        assert {r.name for r in res} == {"hm-direct", "hm-log"}

    def test_cnr_sweep_runs(self, tmp_path):
        res = (
            ScaleBenchBuilder(
                lambda: make_hashmap(64), "t2", WorkloadSpec(keyspace=64),
                device=CPU,
            )
            .replicas([2])
            .log_strategies([2])
            .batches([8])
            .systems(["cnr"])
            .duration(0.1)
            .out_dir(str(tmp_path))
            .run()
        )
        assert len(res) == 1 and res[0].total_dispatches > 0


class TestShardedRunner:
    def test_matches_single_device_runner(self):
        # 8 `cpu` shards: the same workload through the sharded fleet
        # and the single-device fleet must agree exactly
        spec = WorkloadSpec(keyspace=64, seed=21)
        gen = generate_batches(spec, 4, 16, 2, 2)
        a = ReplicatedRunner(make_hashmap(64), 16, 2, 2,
                             log_capacity=1 << 10, device=CPU)
        b = ShardedRunner(make_hashmap(64), 16, 2, 2, n_devices=CPUS8,
                          log_capacity=1 << 10)
        a.prepare(*gen)
        b.prepare(*gen)
        for s in range(4):
            a.run_step(s)
            b.run_step(s)
        a.block()
        b.block()
        assert b.replicas_equal()
        sa, sb = a.state_dump(3), b.state_dump(3)
        np.testing.assert_array_equal(sa["values"], sb["values"])
        np.testing.assert_array_equal(sa["present"], sb["present"])

    def test_sweep_includes_sharded_system(self, tmp_path):
        res = (
            ScaleBenchBuilder(
                lambda: make_hashmap(64), "sh", WorkloadSpec(keyspace=64),
                device=CPU, devices=CPUS8,
            )
            .replicas([8])
            .batches([4])
            .systems(["sharded"])
            .duration(0.1)
            .out_dir(str(tmp_path))
            .run()
        )
        assert len(res) == 1 and res[0].total_dispatches > 0

    def test_indivisible_replica_count_raises(self):
        with pytest.raises(ValueError, match="not divisible"):
            ShardedRunner(make_hashmap(64), 6, 1, 1, n_devices=[CPU] * 4)


class TestReplicaStrategy:
    def test_strategy_devices_granularities(self):
        topo = MachineTopology(CPUS8)
        assert len(strategy_devices(ReplicaStrategy.ONE, topo)) == 1
        # one process: PER_HOST collapses to one device
        assert len(strategy_devices(ReplicaStrategy.PER_HOST, topo)) == 1
        assert len(strategy_devices(ReplicaStrategy.PER_DEVICE,
                                    topo)) == 8

    def test_sharded_runner_strategy_placement(self):
        topo = MachineTopology(CPUS8)
        r = ShardedRunner(make_hashmap(64), 16, 2, 2, n_devices=topo,
                          log_capacity=1 << 10,
                          strategy=ReplicaStrategy.PER_DEVICE)
        assert r.mesh.devices.size == 8
        assert r.name == "nr-mesh8-per_device"
        r1 = ShardedRunner(make_hashmap(64), 16, 2, 2, n_devices=topo,
                           log_capacity=1 << 10,
                           strategy=ReplicaStrategy.ONE)
        assert r1.mesh.devices.size == 1

    def test_sweep_over_strategies(self, tmp_path):
        res = (
            ScaleBenchBuilder(
                lambda: make_hashmap(64), "strat", WorkloadSpec(keyspace=64),
                device=CPU, devices=MachineTopology(CPUS8),
            )
            .replicas([8])
            .batches([4])
            .systems(["sharded"])
            .replica_strategies(
                [ReplicaStrategy.ONE, ReplicaStrategy.PER_DEVICE]
            )
            .duration(0.1)
            .out_dir(str(tmp_path))
            .run()
        )
        assert len(res) == 2
        assert {r.name for r in res} == {"nr-mesh1-one",
                                         "nr-mesh8-per_device"}
        # tm column carries the strategy
        with open(tmp_path / "scaleout_benchmarks.csv") as f:
            tms = {row["tm"] for row in csv.DictReader(f)}
        assert tms == {"one", "per_device"}


class TestMeshCurve:
    def test_measure_mesh_curve_and_csv(self, tmp_path):
        # bit-identity verified per point, scaling/efficiency relative to
        # the 1-device base, CSV schema
        from node_replication_torch.harness.mkbench import (
            MESH_CSV,
            append_mesh_csv,
            measure_mesh,
            mesh_rows,
        )

        points = measure_mesh(
            lambda: make_hashmap(64), [1, [CPU, CPU]], 8,
            writes_per_replica=2, reads_per_replica=2, keyspace=64,
            duration_s=0.1, verify_steps=3, wr_opcode=HM_PUT,
            rd_opcode=HM_GET, device=CPU,
        )
        assert [p.devices for p in points] == [1, 2]
        assert all(p.bit_identical for p in points)
        rows = mesh_rows("test", points, batch=4, keys=64, replicas=8)
        assert rows[0]["scaling_x"] == 1.0
        assert rows[0]["efficiency"] == 1.0
        assert all(r["bit_identical"] == 1 for r in rows)
        append_mesh_csv(str(tmp_path), rows)
        with open(os.path.join(str(tmp_path), MESH_CSV)) as f:
            got = list(csv.DictReader(f))
        assert len(got) == 2
        assert got[1]["devices"] == "2"
        assert float(got[1]["throughput_mdps"]) > 0


class TestRunnerRekey:
    """Twins of `tests/test_partitioned.py::TestRunnerRekey`."""

    @staticmethod
    def _puts(K, S, R, Bw, Br, seed, vals=False):
        rng = np.random.default_rng(seed)
        wr_opc = np.full((S, R, Bw), HM_PUT, np.int32)
        wr_args = np.zeros((S, R, Bw, 3), np.int32)
        wr_args[..., 0] = rng.integers(0, K, (S, R, Bw))
        if vals:
            wr_args[..., 1] = rng.integers(0, 999, (S, R, Bw))
        rd_opc = np.full((S, R, Br), HM_GET, np.int32)
        rd_args = np.zeros((S, R, Br, 3), np.int32)
        if vals:
            rd_args[..., 0] = rng.integers(0, K, (S, R, Br))
        return wr_opc, wr_args, rd_opc, rd_args

    def test_rekey_stays_in_keyspace_and_congruent(self):
        # re-keying must not produce keys >= keyspace nor alias dense
        # cells across logs
        K, nlogs = 30, 4  # keyspace NOT a multiple of nlogs
        r = MultiLogRunner(make_hashmap(K), 2, nlogs, 8, 2, keyspace=K,
                           device=CPU)
        r.prepare(*self._puts(K, 3, 2, 8, 2, 0))
        keys = r._w[1].numpy()[..., 0]  # [S, L, B]
        assert keys.max() < K
        for l in range(nlogs):
            assert (keys[:, l, :] % nlogs == l).all()

    def test_rebalance_rekey_stays_in_keyspace_and_congruent(self):
        K, nlogs = 30, 4
        r = MultiLogRunner(make_hashmap(K), 2, nlogs, 8, 2, keyspace=K,
                           rebalance=True, device=CPU)
        r.prepare(*self._puts(K, 3, 2, 8, 2, 0))
        keys = r._w[1].numpy()[..., 0]
        assert keys.max() < K
        for l in range(nlogs):
            assert (keys[:, l, :] % nlogs == l).all()
        # buckets are exactly equal — the whole point of the opt-in
        counts = r._counts.numpy()
        assert (counts == counts[0, 0]).all()
        # accounting follows the ACTUAL appended (tiled) count, which may
        # exceed the client stream size N=16: L * ceil(N/L)
        appended = int(counts[0].sum())
        assert appended == nlogs * -(-16 // nlogs)
        assert r.client_ops_per_step == appended + 2 * 2

    def test_rebalance_rejects_keyspace_smaller_than_nlogs(self):
        r = MultiLogRunner(make_hashmap(2), 1, 4, 4, 0, keyspace=2,
                           rebalance=True, device=CPU)
        wr_opc = np.full((1, 1, 4), HM_PUT, np.int32)
        wr_args = np.zeros((1, 1, 4, 3), np.int32)
        with pytest.raises(ValueError, match="keyspace"):
            r.prepare(wr_opc, wr_args,
                      np.zeros((1, 1, 0), np.int32),
                      np.zeros((1, 1, 0, 3), np.int32))

    def test_partitioned_runner_matches_fold_runner(self):
        K, nlogs, R = 32, 4, 2
        pm = make_partitioned_hashmap(K, nlogs)
        r_fold = MultiLogRunner(make_hashmap(K), R, nlogs, 8, 2,
                                keyspace=K, device=CPU)
        r_part = MultiLogRunner(make_hashmap(K), R, nlogs, 8, 2,
                                partitioned=pm, keyspace=K, device=CPU)
        streams = self._puts(K, 4, R, 8, 2, 1, vals=True)
        for r in (r_fold, r_part):
            r.prepare(*streams)
            for s in range(4):
                r.run_step(s)
            r.block()
        a = r_fold.state_dump()
        b = r_part.state_dump()
        assert (a["values"] == b["values"]).all()
        assert (a["present"] == b["present"]).all()


class TestHarnessTraceThroughput:
    """Twin of `tests/test_obs.py::TestHarnessTraceThroughput`."""

    def test_measure_emits_per_second_samples(self):
        t = get_tracer()
        t.enable(None)
        try:
            gen = generate_batches(WorkloadSpec(keyspace=32), 4, 2, 2, 2)
            res = measure_step_runner(
                ReplicatedRunner(make_hashmap(32), 2, 2, 2, device=CPU),
                *gen, duration_s=0.1,
            )
            tp = [e for e in t.events() if e["event"] == "throughput"]
        finally:
            t.disable()
        assert tp, "measure_step_runner emitted no throughput samples"
        assert sum(e["ops"] for e in tp) == res.total_client_ops
        assert all(e["second"] >= 0 for e in tp)


class TestCsvSchemaUpgrade:
    """Twin of `tests/test_obs.py::TestCsvSchemaUpgrade`."""

    FIELDS = ["a", "b", "c"]

    def _read(self, path):
        with open(path, newline="") as f:
            r = csv.reader(f)
            return next(r), [row for row in r]

    def _seed(self, path, header, row):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerow(row)

    def test_reordered_same_set_header_rewritten(self, tmp_path):
        path = str(tmp_path / "x.csv")
        self._seed(path, ["b", "a", "c"], [2, 1, 3])  # same set, reordered
        mk._append_csv(path, self.FIELDS, [{"a": 4, "b": 5, "c": 6}])
        header, rows = self._read(path)
        assert header == self.FIELDS
        assert rows == [["1", "2", "3"], ["4", "5", "6"]]

    def test_removed_column_dropped_on_rewrite(self, tmp_path):
        path = str(tmp_path / "x.csv")
        self._seed(path, ["a", "b", "zz"], [1, 2, 9])  # zz left the schema
        mk._append_csv(path, self.FIELDS, [{"a": 4, "b": 5, "c": 6}])
        header, rows = self._read(path)
        assert header == self.FIELDS
        assert rows == [["1", "2", ""], ["4", "5", "6"]]

    def test_subset_header_upgraded(self, tmp_path):
        path = str(tmp_path / "x.csv")
        self._seed(path, ["a", "b"], [1, 2])
        mk._append_csv(path, self.FIELDS, [{"a": 4, "b": 5, "c": 6}])
        header, rows = self._read(path)
        assert header == self.FIELDS
        assert rows == [["1", "2", ""], ["4", "5", "6"]]

    def test_matching_header_appends_in_place(self, tmp_path):
        path = str(tmp_path / "x.csv")
        mk._append_csv(path, self.FIELDS, [{"a": 1, "b": 2, "c": 3}])
        mk._append_csv(path, self.FIELDS, [{"a": 4, "b": 5, "c": 6}])
        header, rows = self._read(path)
        assert header == self.FIELDS
        assert rows == [["1", "2", "3"], ["4", "5", "6"]]


class TestHarnessMeasureEvents:
    """Twin of `tests/test_trace.py::TestHarnessMeasureEvents`."""

    def test_measure_step_runner_emits_record(self):
        t = get_tracer()
        t.enable(None)
        try:
            gen = generate_batches(WorkloadSpec(keyspace=32), 4, 2, 2, 2)
            res = measure_step_runner(
                ReplicatedRunner(make_hashmap(32), 2, 2, 2, device=CPU),
                *gen, duration_s=0.1,
            )
            m = [e for e in t.events() if e["event"] == "measure"]
        finally:
            t.disable()
        assert len(m) == 1
        assert m[0]["client_ops"] == res.total_client_ops
        assert m[0]["dispatches"] == res.total_dispatches
        assert res.total_dispatches > res.total_client_ops  # R=2 replay


# ------------------------------------------------------- differential


@pytest.mark.parametrize("dist", ["uniform", "skewed"])
@pytest.mark.parametrize("wr_opcode", [1, (1, 2)])
def test_generate_batches_bit_identical(dist, wr_opcode):
    spec = WorkloadSpec(keyspace=97, write_ratio=30, distribution=dist,
                        zipf_theta=1.2, seed=5)
    from node_replication_tpu.harness.workloads import (
        WorkloadSpec as JSpec,
    )

    jspec = JSpec(keyspace=97, write_ratio=30, distribution=dist,
                  zipf_theta=1.2, seed=5)
    got = generate_batches(spec, 5, 3, 4, 2, wr_opcode=wr_opcode,
                           rd_opcode=(0, 1))
    want = j_generate_batches(jspec, 5, 3, 4, 2, wr_opcode=wr_opcode,
                              rd_opcode=(0, 1))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    z = zipf_keys(np.random.default_rng(4), 5000, 333, 1.1)
    zj = j_zipf_keys(np.random.default_rng(4), 5000, 333, 1.1)
    assert z.dtype == zj.dtype and np.array_equal(z, zj)


def _drive(runner, gen, steps):
    runner.prepare(*gen)
    for s in range(steps):
        runner.run_step(s)
    runner.block()
    return runner


@pytest.mark.parametrize("combined", [None, False])
def test_replicated_runner_matches_reference(combined):
    K, R, Bw, Br, S = 37, 4, 3, 2, 6
    gen = generate_batches(WorkloadSpec(keyspace=K, seed=8), S, R, Bw, Br,
                           wr_opcode=(1, 2))
    j = _drive(j_trait.ReplicatedRunner(j_make_hashmap(K), R, Bw, Br,
                                        log_capacity=256, track_resp=1,
                                        combined=combined), gen, S)
    t = _drive(ReplicatedRunner(make_hashmap(K), R, Bw, Br,
                                log_capacity=256, track_resp=1,
                                combined=combined, device=CPU), gen, S)
    _leaves_eq(j.states, t.states, "states")
    _leaves_eq(j.log, t.log, "log")
    _leaves_eq(j._last, t._last, "reads")
    assert j.tracked_rate() == t.tracked_rate()
    assert (j.dispatches_per_step, j.client_ops_per_step) == (
        t.dispatches_per_step, t.client_ops_per_step)
    # grow one replica and keep stepping: still the reference's fleet
    j.grow(1)
    t.grow(1)
    gen2 = generate_batches(WorkloadSpec(keyspace=K, seed=9), 3, R + 1, Bw,
                            Br)
    _drive(j, gen2, 3)
    _drive(t, gen2, 3)
    _leaves_eq(j.states, t.states, "grown states")
    _leaves_eq(j.log, t.log, "grown log")
    assert t.replicas_equal()
    for r in (0, R):
        _leaves_eq(j.state_dump(r), t.state_dump(r), f"dump {r}")


@pytest.mark.parametrize("mode", ["hash", "rebalance", "partitioned"])
def test_multilog_runner_matches_reference(mode):
    K, L, R, Bw, Br, S = 32, 4, 2, 6, 2, 5
    gen = generate_batches(WorkloadSpec(keyspace=K, seed=2,
                                        distribution="skewed"),
                           S, R, Bw, Br, wr_opcode=(1, 2))
    kw = {"keyspace": K, "rebalance": mode == "rebalance"}
    j = _drive(j_trait.MultiLogRunner(
        j_make_hashmap(K), R, L, Bw, Br,
        partitioned=(j_make_partitioned_hashmap(K, L)
                     if mode == "partitioned" else None), **kw), gen, S)
    t = _drive(MultiLogRunner(
        make_hashmap(K), R, L, Bw, Br,
        partitioned=(make_partitioned_hashmap(K, L)
                     if mode == "partitioned" else None), device=CPU,
        **kw), gen, S)
    _leaves_eq(j.states, t.states, "states")
    _leaves_eq(j.ml, t.ml, "multilog")
    _leaves_eq(j._w, t._w, "routed writes")
    _leaves_eq(j._counts, t._counts, "counts")
    _leaves_eq(j._last, t._last, "reads")
    assert j.stats() == t.stats()
    assert (j.dispatches_per_step, j.client_ops_per_step) == (
        t.dispatches_per_step, t.client_ops_per_step)


@pytest.mark.parametrize("which", ["partitioned", "concurrent"])
def test_baseline_runners_match_reference(which):
    K, R, Bw, Br, S = 29, 3, 4, 3, 4
    gen = generate_batches(WorkloadSpec(keyspace=K, seed=6), S, R, Bw, Br,
                           wr_opcode=(1, 2))
    jcls, tcls = {
        "partitioned": (j_trait.PartitionedRunner, PartitionedRunner),
        "concurrent": (j_trait.ConcurrentDsRunner, ConcurrentDsRunner),
    }[which]
    j = _drive(jcls(j_make_hashmap(K), R, Bw, Br), gen, S)
    t = _drive(tcls(make_hashmap(K), R, Bw, Br, device=CPU), gen, S)
    for r in range(R if which == "partitioned" else 1):
        _leaves_eq(j.state_dump(r), t.state_dump(r), f"replica {r}")
    _leaves_eq(j._last, t._last, "reads")
    assert (j.dispatches_per_step, j.client_ops_per_step) == (
        t.dispatches_per_step, t.client_ops_per_step)


def test_sharded_runners_match_reference():
    # the reference shards over the 8 virtual XLA devices (conftest),
    # the port over 8 `cpu` entries
    K, R, S = 64, 16, 3
    gen = generate_batches(WorkloadSpec(keyspace=K, seed=21), S, R, 2, 2)
    j = _drive(j_trait.ShardedRunner(j_make_hashmap(K), R, 2, 2,
                                     n_devices=8, log_capacity=1 << 10),
               gen, S)
    t = _drive(ShardedRunner(make_hashmap(K), R, 2, 2, n_devices=CPUS8,
                             log_capacity=1 << 10), gen, S)
    assert j.name == t.name == "nr-mesh8"
    _leaves_eq(j.states, t.states, "sharded states")
    _leaves_eq(j.log, t.log, "sharded log")
    L, Bw = 4, 6
    gen = generate_batches(WorkloadSpec(keyspace=K, seed=3), S, 8, Bw, 1,
                           wr_opcode=(0, 1, 2))
    j = _drive(j_trait.ShardedCnrRunner(j_make_hashmap(K), 8, L, Bw, 1,
                                        keyspace=K), gen, S)
    t = _drive(ShardedCnrRunner(make_hashmap(K), 8, L, Bw, 1, keyspace=K,
                                devices=CPUS8), gen, S)
    assert j.name == t.name == "sharded-cnr4-mesh2x4"
    assert dict(t.mesh.shape) == {"replica": 2, "log": 4}
    _leaves_eq(j.states, t.states, "sharded-cnr states")
    _leaves_eq(j.ml, t.ml, "sharded-cnr multilog")
    _leaves_eq(j._last, t._last, "sharded-cnr reads")
    assert j.stats() == t.stats()


def test_sharded_cnr_runner_matches_unsharded_and_sweeps(tmp_path):
    # the twin of tests/test_mesh.py::TestShardedCnrRunner: placement
    # changes nothing, the mesh shape follows the reference's rule, and
    # the sweep drives it
    K, L, R, S, Bw, Br = 64, 4, 8, 5, 6, 2
    gen = generate_batches(WorkloadSpec(keyspace=K, seed=3), S, R, Bw, Br,
                           wr_opcode=(0, 1, 2))
    a = MultiLogRunner(make_hashmap(K), R, L, Bw, Br, keyspace=K,
                       device=CPU)
    b = ShardedCnrRunner(make_hashmap(K), R, L, Bw, Br, keyspace=K,
                         devices=CPUS8)
    for r in (a, b):
        r.prepare(*gen)
    for s in range(S):
        a.run_step(s)
        b.run_step(s)
        assert torch.equal(a._last, b._last)
    a.block()
    b.block()
    _leaves_eq(a.states, b.states, "states")
    _leaves_eq(a.ml, b.ml, "multilog")
    assert a.stats() == b.stats()
    r8 = ShardedCnrRunner(make_hashmap(32), 8, 8, 4, 1, keyspace=32,
                          devices=CPUS8)
    assert dict(r8.mesh.shape) == {"replica": 1, "log": 8}
    with pytest.raises(ValueError, match="cannot shard"):
        ShardedCnrRunner(make_hashmap(32), 8, 4, 4, 1, keyspace=32,
                         n_log_shards=3, devices=CPUS8)
    res = (
        ScaleBenchBuilder(lambda: make_hashmap(64), "shardedcnr-smoke",
                          WorkloadSpec(keyspace=64), devices=CPUS8)
        .replicas([8]).log_strategies([4]).batches([8])
        .systems(["sharded-cnr"]).duration(0.1)
        .out_dir(str(tmp_path)).run()
    )
    assert len(res) == 1 and res[0].total_dispatches > 0
    assert res[0].name == "sharded-cnr4-mesh2x4"


def test_csv_schemas_match_reference():
    names = [n for n in dir(j_mk)
             if n.endswith(("_CSV", "_FIELDS")) and n.isupper()]
    assert len(names) == 23
    for n in names:
        assert getattr(mk, n) == getattr(j_mk, n), n


def _row_inputs(m):
    """The same synthetic measurements, built with package `m`'s own
    result classes, for every row builder."""
    res = m.MeasureResult("r", 1200, 1.5, [(0, 300), (1, 500)], 800)
    serve = m.ServeResult(
        name="s", mode="closed", clients=4, rate=None, duration_s=2.0,
        latencies_s=[0.001 * i for i in range(1, 40)], attempts=42,
        accepted=40, completed=39, shed=2, deadline_missed=1, errors=[],
        transport_errors=[], pipeline_overlap=1)
    chaos = m.ChaosResult(serve=serve, fired=[1], repairs=[
        {"duration_s": 0.2}, {"duration_s": 0.5}], rehomed=3,
        health={})
    mesh = [m.MeshPoint(devices=n, result=m.MeasureResult(
        "r", 1000 * n, 1.0, [(0, 10)], 10), bit_identical=True,
        spread_pct=1.5) for n in (1, 2)]
    kern = [m.KernelPoint(
        tier=t, n_replicas=8, n_keys=64, window=16, capacity=512,
        rounds=9, duration_s=0.25, dispatches_per_sec=123456.789,
        launches_per_round=n, p50_ms=0.123456, p95_ms=0.2345678,
        bit_identical=True, interpret=True, devices=d)
        for t, n, d in (("pallas_fused", 1, 1), ("mesh_fused", 4, 4))]
    run = {k: 1.23456 for k in (
        "capacity_ops", "rate", "deadline_s", "duration_s", "goodput",
        "p50_ms", "p99_ms", "agg_reads_ops", "single_reads_ops",
        "read_scaling_x", "primary_tput_hold", "bootstrap_s",
        "full_replay_s", "bootstrap_speedup_x", "detect_s", "promote_s",
        "rto_s", "duration", "baseline_ops", "aggregate_ops", "scaling_x",
        "survivor_hold", "txn_parity", "fence_s", "moved_unavail_s")}
    run.update({k: 7 for k in (
        "clients", "arrivals", "accepted", "completed", "good", "shed",
        "evicted", "circuit_open", "deadline_miss", "brownout_reads",
        "max_brownout_lag", "priority_inversions", "lost", "duplicated",
        "relays", "followers", "acked", "bootstrap_pos",
        "post_restart_ops", "n_shards", "victim_shard", "victim_acked",
        "post_promote_ops", "txn_rounds", "txn_acked", "txn_in_doubt",
        "txn_resolved", "txn_half_committed", "moved_keys",
        "reshard_lost", "reshard_dup")})
    run.update(mode="adaptive", shed_by_priority={"critical": 1, "bulk": 2})

    class Report:
        snapshot_pos, wal_records, wal_ops, wal_truncated_bytes = 5, 6, 7, 8
        duration_s, tail, applied_pos, new_epoch = 0.123456, 9, 10, 2
        drained_records, detect_s, promote_s, rto_s = 3, 0.5, 0.25, 0.75

    return {
        "sweep": m.sweep_rows("n", "nr", res, 4, 1, 8, tm="one",
                              wr_eff=50.0),
        "serve": m.serve_rows("n", serve, {"hz": 97, "samples": 3}),
        "chaos": m.chaos_rows("n", chaos),
        "mesh": m.mesh_rows("n", mesh, batch=4, keys=64, replicas=8),
        "mesh_tier": m.mesh_tier_rows("n", 16, kern),
        "kernel": m.kernel_rows("n", kern),
        "recovery": m.recovery_rows(
            "n", Report, clients=4, durability="batch", acked=10,
            kill_after=5, lost=0, duplicated=0, post_restart_ops=3),
        "replication": m.replication_rows(
            "n", Report, clients=4, acked=10, kill_after=5, max_lag_pos=64,
            reads=9, stale_reads=1, lost=0, duplicated=0,
            post_restart_ops=3),
        "overload": m.overload_rows("n", run),
        "tree": m.tree_rows("n", run),
        "sharded": m.sharded_rows("n", run),
        "txn": m.txn_rows("n", run),
        "reshard": m.reshard_rows("n", run),
        "effective": [m.effective_write_pct(3, 5),
                      m.effective_write_pct(0, 0)],
        "chaos_availability": [chaos.availability, chaos.repair_ms(50)],
    }


def test_row_builders_match_reference():
    got, want = _row_inputs(mk), _row_inputs(j_mk)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
        if isinstance(want[k][0], dict):  # the column order too
            assert [list(r) for r in got[k]] == [list(r) for r in want[k]]


def test_measure_kernel_matches_reference_scan(monkeypatch):
    # every tier bit-identical to the port's scan chain, and the states
    # and logs each tier ends with equal to the REFERENCE's scan chain
    # on the same seeded batches
    K, R, W, rounds = 64, 8, 16, 4
    seen = []
    real = mk._host_leaves

    def spy(tree):
        out = real(tree)
        seen.append(out)
        return out

    monkeypatch.setattr(mk, "_host_leaves", spy)
    pts = mk.measure_kernel(K, R, W, duration_s=0.02, verify_rounds=rounds,
                            device=CPU)
    assert [p.tier for p in pts] == ["pallas_fused", "combined", "scan"]
    assert all(p.bit_identical and p.interpret for p in pts)
    assert [p.launches_per_round for p in pts] == [1, 2, 2]
    # the reference's scan chain (un-jitted) over its own batches
    from node_replication_tpu.core.log import LogSpec as JSpec

    spec = JSpec(capacity=512, n_replicas=R, arg_width=3, gc_slack=W)
    d = j_make_hashmap(K)
    log, states = j_log_init(spec), j_replicate(d.init_state(), R)
    batches = j_mk._kernel_batches(K, W, 3, 0)
    for i in range(rounds):
        log = j_log_append(spec, log, *batches[i], W)
        log, states, _ = j_log_exec_all(spec, d, log, states, window=W)
    want_states = [np.asarray(a) for a in jax.tree.leaves(states)]
    want_log = [np.asarray(a) for a in jax.tree.leaves(log)]
    # the spy saw (states, log) of the port's reference, then of each tier
    assert len(seen) == 2 * (1 + len(pts))
    for states_seen, log_seen in zip(seen[::2], seen[1::2]):
        for a, b in zip(want_states, states_seen):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(want_log, log_seen):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_measure_kernel_mesh_tiers_on_cpu_shards():
    pts = mk.measure_kernel(64, 8, 16, duration_s=0.02, verify_rounds=3,
                            devices=[CPU] * 4)
    assert [(p.tier, p.devices, p.launches_per_round) for p in pts] == [
        ("mesh_fused", 4, 4), ("shmap", 4, 2)]
    assert all(p.bit_identical for p in pts)
    with pytest.raises(ValueError, match="not divisible"):
        mk.measure_kernel(64, 6, 16, devices=4)


def test_measure_serve_and_chaos_on_seqreg(tmp_path):
    # bench.py --chaos's verifier through the port: every response the
    # client's previous value, a serve-batch kill of the last replica
    # repaired with availability 1.0, and the CSV rows written
    from node_replication_torch.core.replica import NodeReplicated
    from node_replication_torch.fault import (
        HEALTHY,
        FaultPlan,
        FaultSpec,
        ReplicaLifecycleManager,
    )
    from node_replication_torch.models import SR_SET, make_seqreg
    from node_replication_torch.serve import (
        RetryPolicy,
        ServeConfig,
        ServeFrontend,
    )

    clients, per = 4, 12
    nr = NodeReplicated(make_seqreg(clients), n_replicas=2,
                        log_entries=512, gc_slack=64, exec_window=64,
                        device=CPU)
    op_of = lambda c, i: (SR_SET, c, i + 1)  # noqa: E731
    check = lambda c, i, r: None if r == i else f"{c}/{i}: {r}"  # noqa
    cfg = ServeConfig(batch_max_ops=8, batch_linger_s=0.001, failover=True)
    plan = FaultPlan([FaultSpec(site="serve-batch", action="raise", rid=1,
                                after=2, count=1)], seed=0)
    with ServeFrontend(nr, cfg) as fe:
        res = mk.measure_serve(fe, op_of, clients * per, clients,
                               check=check, name="seqreg")
        manager = ReplicaLifecycleManager(nr, fe)
        op2 = lambda c, i: (SR_SET, c, per + i + 1)  # noqa: E731
        chk2 = lambda c, i, r: (None if r == per + i  # noqa: E731
                                else f"{c}/{i}: {r}")
        chaos = mk.measure_chaos(
            fe, manager, plan, op2, clients * per, clients,
            retry=RetryPolicy(max_attempts=64, base_backoff_s=0.001,
                              max_backoff_s=0.05),
            check=chk2, name="seqreg-chaos")
    assert not res.errors and not res.transport_errors
    assert res.completed == res.attempts == clients * per
    assert res.throughput > 0 and res.percentile_ms(99) > 0
    assert chaos.fired and len(chaos.repairs) >= len(chaos.fired)
    assert not chaos.serve.errors and not chaos.serve.transport_errors
    assert chaos.availability == 1.0
    assert chaos.health["states"].count(HEALTHY) == 2
    nr.sync()
    assert nr.replicas_equal()
    mk.append_serve_csv(str(tmp_path), mk.serve_rows("t", res))
    mk.append_chaos_csv(str(tmp_path), mk.chaos_rows("t", chaos))
    for name, fields in ((mk.SERVE_CSV, mk._SERVE_FIELDS),
                         (mk.CHAOS_CSV, mk._CHAOS_FIELDS)):
        with open(tmp_path / name) as f:
            assert next(csv.reader(f)) == fields


def test_measure_native_rows_from_real_bins(tmp_path):
    from node_replication_torch.harness import NativeRunner
    from node_replication_torch.native import MODEL_HASHMAP

    r = NativeRunner(MODEL_HASHMAP, 256, n_replicas=2,
                     threads_per_replica=2, write_pct=50, keyspace=256)
    try:
        res = mk.measure_native(r, duration_s=0.1)
        assert r.replicas_equal()
    finally:
        r.close()
    assert r.name == "native"
    assert res.total_client_ops == res.total_dispatches > 0
    rows = mk.native_rows(r, res, "hm", 32, wr_eff=50)
    assert len(rows) == 4 * r.last_per_sec.shape[1]
    assert sum(row["ops"] for row in rows) == res.total_client_ops
    assert {row["thread_id"] for row in rows} == {0, 1, 2, 3}
