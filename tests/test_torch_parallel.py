"""The port's `parallel/` (topology, mesh placement, collectives) against
the reference's.

Twins of `tests/test_mesh.py::TestTopology` and `TestShardedStep` and of
`tests/test_collectives.py`: the shmap step against `make_step` and
against the reference's `make_shmap_step` on its eight-device mesh, the
ring replay against in-order sequential replay and against the
reference's `make_ring_exec`, on an order-sensitive stream. The port's
meshes are eight `cpu` entries (a mesh device may repeat).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_replication_tpu.core.log import LogSpec as JLogSpec
from node_replication_tpu.core.log import log_init as j_log_init
from node_replication_tpu.core.replica import replicate_state as j_replicate
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.parallel import make_mesh as j_make_mesh
from node_replication_tpu.parallel.collectives import (
    make_ring_exec as j_make_ring_exec,
)
from node_replication_tpu.parallel.collectives import (
    make_shmap_step as j_make_shmap_step,
)

import node_replication_torch as T
from node_replication_torch.core.log import LogSpec, log_init
from node_replication_torch.core.replica import replicate_state
from node_replication_torch.core.step import make_step
from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
from node_replication_torch.ops.encoding import apply_write
from node_replication_torch.parallel import (
    MachineTopology,
    ReplicaStrategy,
    make_mesh,
    make_ring_exec,
    make_shmap_exec,
    make_shmap_step,
    place,
    replica_mesh,
    shard_step,
)
from node_replication_torch.parallel.mesh import strategy_devices
from node_replication_torch.parallel.topology import ThreadMapping
from node_replication_torch.utils.device import NoCudaDeviceError
from node_replication_torch.utils.tree import tree_map

CPU8 = ["cpu"] * 8


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _batches(R, Bw, Br, K, seed=0):
    """Numpy batches: puts from every replica, gets of random keys."""
    rng = np.random.default_rng(seed)
    wr_opc = np.full((R, Bw), HM_PUT, np.int32)
    wr_args = np.stack([rng.integers(0, K, (R, Bw)),
                        rng.integers(0, 1000, (R, Bw)),
                        np.zeros((R, Bw))], axis=-1).astype(np.int32)
    rd_opc = np.full((R, Br), HM_GET, np.int32)
    rd_args = np.zeros((R, Br, 3), np.int32)
    rd_args[..., 0] = rng.integers(0, K, (R, Br))
    return wr_opc, wr_args, rd_opc, rd_args


def _t(batches):
    return [torch.from_numpy(b) for b in batches]


def _j(batches):
    return [jnp.asarray(b) for b in batches]


class TestTopology:
    def test_walk_and_allocate(self):
        topo = MachineTopology(CPU8)
        assert topo.n_devices() == 8 and topo.n_hosts() == 1
        seq = topo.allocate(ThreadMapping.SEQUENTIAL, 4)
        inter = topo.allocate(ThreadMapping.INTERLEAVE, 4)
        assert len(seq) == 4 and len(inter) == 4
        assert all(d == torch.device("cpu") for d in seq + inter)

    def test_allocate_too_many(self):
        topo = MachineTopology(CPU8)
        with pytest.raises(ValueError):
            topo.allocate(ThreadMapping.NONE, 9)

    def test_strategies_over_explicit_devices(self):
        topo = MachineTopology(["cpu"] * 3)
        assert len(strategy_devices(ReplicaStrategy.ONE, topo)) == 1
        assert len(strategy_devices(ReplicaStrategy.PER_HOST, topo)) == 1
        assert len(strategy_devices(ReplicaStrategy.PER_DEVICE, topo)) == 3

    @pytest.mark.skipif(torch.cuda.is_available(), reason="has a card")
    def test_default_devices_are_the_cards(self):
        # no fallback: with no card the default mesh raises, never
        # lands on the CPU
        with pytest.raises(NoCudaDeviceError):
            MachineTopology()
        with pytest.raises(NoCudaDeviceError):
            replica_mesh(4)
        with pytest.raises(NoCudaDeviceError):
            T.NodeReplicated(make_hashmap(8), n_replicas=4, mesh=4)


class TestShardedStep:
    def test_sharded_matches_single_device(self):
        R, Bw, Br, K = 16, 2, 2, 64
        spec = LogSpec(capacity=1 << 10, n_replicas=R, arg_width=3,
                       gc_slack=32)
        d = make_hashmap(K)
        fn = make_step(d, spec, Bw, Br)
        batches = _t(_batches(R, Bw, Br, K, seed=3))
        ref = fn(log_init(spec, "cpu"),
                 replicate_state(d.init_state("cpu"), R), *batches)
        mesh = make_mesh(4, 2, devices=CPU8)
        fleet = place(log_init(spec, "cpu"),
                      replicate_state(d.init_state("cpu"), R), mesh)
        assert fleet.n_shards == 4
        sharded = shard_step(fn, mesh, fleet.log, fleet.states)
        got = sharded(fleet, None, *batches)
        for a, b in zip(T.LogState(*ref[0]), T.LogState(*got[0])):
            assert torch.equal(a, b)
        for k in ref[1]:
            assert torch.equal(ref[1][k], got[1][k])
        assert torch.equal(ref[2], got[2]) and torch.equal(ref[3], got[3])

    def test_mesh_shape_validation(self):
        with pytest.raises(ValueError):
            make_mesh(3, 2, devices=CPU8)
        mesh = make_mesh(4, 2, devices=CPU8)
        assert mesh.shape == {"replica": 4, "log": 2}
        assert mesh.axis_names == ("replica", "log")
        assert mesh.devices.shape == (4, 2)
        with pytest.raises(ValueError):  # R=6 over 4 rows
            place(log_init(LogSpec(n_replicas=6, gc_slack=32), "cpu"),
                  replicate_state(make_hashmap(8).init_state("cpu"), 6),
                  mesh)

    def test_place_gather_round_trip(self):
        R, K = 8, 16
        spec = LogSpec(capacity=256, n_replicas=R, gc_slack=16)
        d = make_hashmap(K)
        log = log_init(spec, "cpu")._replace(
            ltails=torch.arange(R, dtype=torch.int64))
        st = replicate_state(d.init_state("cpu"), R)
        st["values"][:, 0] = torch.arange(R, dtype=torch.int32)
        fleet = place(log, st, replica_mesh(4, devices=["cpu"] * 4))
        assert [sh.rows for sh in fleet.shards] == [
            slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
        assert fleet.shard_of(5) == (2, 1)
        assert fleet.shards[2].log.ltails.tolist() == [4, 5]
        # each shard owns its cursors: no view of the input
        fleet.shards[1].log.ltails[0] = 99
        assert int(log.ltails[2]) == 2
        fresh = fleet.with_shards([sh.log for sh in fleet.shards],
                                  [sh.states for sh in fleet.shards])
        assert fresh.log.ltails.tolist() == [0, 1, 99, 3, 4, 5, 6, 7]
        assert torch.equal(fresh.states["values"], st["values"])


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return j_make_mesh(8, 1)


class TestShmapStep:
    def test_matches_make_step_and_reference(self, jmesh):
        R, Bw, Br, K = 16, 2, 2, 64
        spec = LogSpec(capacity=1 << 10, n_replicas=R, gc_slack=32)
        d = make_hashmap(K)
        ref_step = make_step(d, spec, Bw, Br)
        sh_step = make_shmap_step(d, spec, make_mesh(8, 1, devices=CPU8),
                                  Bw, Br)
        jspec = JLogSpec(capacity=1 << 10, n_replicas=R, gc_slack=32)
        jd = j_make_hashmap(K)
        j_step = j_make_shmap_step(jd, jspec, jmesh, Bw, Br)
        log_a = log_init(spec, "cpu")
        states_a = replicate_state(d.init_state("cpu"), R)
        fleet = place(log_init(spec, "cpu"),
                      replicate_state(d.init_state("cpu"), R),
                      make_mesh(8, 1, devices=CPU8))
        jlog, jstates = j_log_init(jspec), j_replicate(jd.init_state(), R)
        for s in range(3):
            b = _batches(R, Bw, Br, K, seed=s)
            log_a, states_a, wa, ra = ref_step(log_a, states_a, *_t(b))
            fleet, wb, rb = sh_step(fleet, *_t(b))
            jlog, jstates, wj, rj = j_step(jlog, jstates, *_j(b))
            assert np.array_equal(_np(wa), _np(wb))
            assert np.array_equal(_np(ra), _np(rb))
            assert np.array_equal(_np(wj), _np(wb))
            assert np.array_equal(_np(rj), _np(rb))
        log_b = fleet.log
        for f in T.LogState._fields:
            assert np.array_equal(_np(getattr(log_a, f)),
                                  _np(getattr(log_b, f))), f
            assert np.array_equal(_np(getattr(jlog, f)),
                                  _np(getattr(log_b, f))), f
        for k in states_a:
            assert torch.equal(states_a[k], fleet.states[k])
            assert np.array_equal(_np(jstates[k]), _np(fleet.states[k]))

    def test_read_your_writes_across_shards(self):
        R, K = 8, 32
        spec = LogSpec(capacity=1 << 10, n_replicas=R, gc_slack=32)
        d = make_hashmap(K)
        mesh = make_mesh(8, 1, devices=CPU8)
        sh_step = make_shmap_step(d, spec, mesh, 1, 1)
        fleet = place(log_init(spec, "cpu"),
                      replicate_state(d.init_state("cpu"), R), mesh)
        # replica r writes key r; every replica reads key 0 (written by
        # replica 0, on another shard for r > 0)
        wr_opc = torch.full((R, 1), HM_PUT, dtype=torch.int32)
        wr_args = torch.zeros((R, 1, 3), dtype=torch.int32)
        wr_args[:, 0, 0] = torch.arange(R, dtype=torch.int32)
        wr_args[:, 0, 1] = 100 + torch.arange(R, dtype=torch.int32)
        rd_opc = torch.full((R, 1), HM_GET, dtype=torch.int32)
        rd_args = torch.zeros((R, 1, 3), dtype=torch.int32)
        _, _, rd = sh_step(fleet, wr_opc, wr_args, rd_opc, rd_args)
        assert rd.reshape(-1).tolist() == [100] * R

    @pytest.mark.parametrize("fenced", [False, True])
    def test_shmap_exec_matches_log_exec_all(self, fenced):
        # the exec tier alone, with cursors diverged across shards and
        # a fenced replica on a shard other than shard 0
        from node_replication_torch.core.log import log_append, log_exec_all

        R, K, W = 8, 32, 16
        spec = LogSpec(capacity=256, n_replicas=R, gc_slack=16)
        d = make_hashmap(K)
        rng = np.random.default_rng(4)
        n = 40
        opc = torch.from_numpy(rng.choice([1, 2], n).astype(np.int32))
        args = torch.from_numpy(np.stack(
            [rng.integers(0, K, n), rng.integers(0, 99, n), np.zeros(n)],
            -1).astype(np.int32))
        log = log_append(spec, log_init(spec, "cpu"), opc, args, n)
        log = log._replace(ltails=torch.tensor(
            [0, 3, 5, 5, 9, 12, 12, 20], dtype=torch.int64))
        states = replicate_state(d.init_state("cpu"), R)
        fen = (np.array([0, 0, 0, 0, 0, 1, 0, 0], bool) if fenced
               else None)
        want = log_exec_all(spec, d, log, states, W, fenced=fen)
        mesh = make_mesh(4, 1, devices=["cpu"] * 4)
        ex = make_shmap_exec(d, spec, mesh, W, fenced=fenced)
        fleet, resps = ex(place(log, states, mesh),
                          *((fen,) if fenced else ()))
        for f in T.LogState._fields:
            assert torch.equal(getattr(want[0], f),
                               getattr(fleet.log, f)), f
        for k in want[1]:
            assert torch.equal(want[1][k], fleet.states[k])
        assert torch.equal(want[2], resps)


def _sequential(d, opc, args, states):
    """In-order replay of the whole window into every replica."""
    states = tree_map(lambda x: x.clone(), states)
    R = states["values"].shape[0]
    for j in range(opc.shape[0]):
        apply_write(d, states, opc[j].expand(R), args[j].expand(R, 3))
    return states


def _stream(W, K, seed=3):
    rng = np.random.default_rng(seed)
    opc = rng.choice([HM_PUT, 2], W).astype(np.int32)
    args = np.stack([rng.integers(0, K, W), rng.integers(0, 1000, W),
                     np.zeros(W)], axis=-1).astype(np.int32)
    return opc, args


class TestRingExec:
    def test_matches_sequential_and_reference(self, jmesh):
        W, R, K = 64, 8, 32
        d = make_hashmap(K)
        opc, args = _stream(W, K)
        spec = LogSpec(capacity=256, n_replicas=R, gc_slack=16)
        states = replicate_state(d.init_state("cpu"), R)
        mesh = make_mesh(8, 1, devices=CPU8)
        ring = make_ring_exec(d, mesh)
        fleet = ring(torch.from_numpy(opc), torch.from_numpy(args),
                     place(log_init(spec, "cpu"), states, mesh))
        want = _sequential(d, torch.from_numpy(opc),
                           torch.from_numpy(args), states)
        jd = j_make_hashmap(K)
        jgot = j_make_ring_exec(jd, jmesh)(
            jnp.asarray(opc), jnp.asarray(args),
            j_replicate(jd.init_state(), R))
        for k in ("values", "present"):
            assert torch.equal(fleet.states[k], want[k])
            assert np.array_equal(np.asarray(jgot[k]), _np(want[k]))
        # the ring writes no cursor: the log is as placed
        assert fleet.log.ltails.tolist() == [0] * R

    def test_order_sensitivity_is_real(self):
        # the stream above must be order-sensitive, or the ring
        # schedule test proves nothing: reversed, it ends elsewhere
        W, K = 64, 8
        d = make_hashmap(K)
        rng = np.random.default_rng(3)
        opc = torch.from_numpy(rng.choice([1, 2], W).astype(np.int32))
        args = torch.from_numpy(np.stack(
            [rng.integers(0, K, W), rng.integers(0, 1000, W),
             np.zeros(W)], axis=-1).astype(np.int32))
        states = replicate_state(d.init_state("cpu"), 1)
        fwd = _sequential(d, opc, args, states)
        rev = _sequential(d, opc.flip(0), args.flip(0), states)
        assert not torch.equal(fwd["values"], rev["values"])

    def test_schedule_runs_masked_bubbles(self):
        # the 2P - 1 round schedule: every shard applies a chunk each
        # round, P of them live and the rest masked to NOOP
        import node_replication_torch.parallel.collectives as col

        W, R, K = 32, 4, 8
        d = make_hashmap(K)
        opc, args = _stream(W, K, seed=5)
        spec = LogSpec(capacity=256, n_replicas=R, gc_slack=16)
        states = replicate_state(d.init_state("cpu"), R)
        mesh = make_mesh(4, 1, devices=["cpu"] * 4)
        want = _sequential(d, torch.from_numpy(opc),
                           torch.from_numpy(args), states)
        applied = []
        orig = col._apply_chunk

        def record(dd, st, o, a):
            applied.append(o)
            return orig(dd, st, o, a)

        col._apply_chunk = record
        try:
            fleet = make_ring_exec(d, mesh)(
                torch.from_numpy(opc), torch.from_numpy(args),
                place(log_init(spec, "cpu"), states, mesh))
        finally:
            col._apply_chunk = orig
        assert torch.equal(fleet.states["values"], want["values"])
        # 2P - 1 rounds on each of P shards, P of them live on each
        assert len(applied) == 4 * 7
        noop = sum(bool((o == 0).all()) for o in applied)
        assert noop == 4 * 7 - 4 * 4


def test_fleet_crosses_onto_a_mesh_and_back(jmesh):
    # a reference meshed fleet's global view, carried onto the port's
    # mesh, continues bit-identically under the port's shmap exec
    from node_replication_tpu.core.replica import NodeReplicated as JNR
    from node_replication_tpu.models import make_seqreg as j_make_seqreg

    from node_replication_torch import interop
    from node_replication_torch.models import make_seqreg

    jn = JNR(j_make_seqreg(8), n_replicas=8, log_entries=256, gc_slack=16,
             exec_window=16, mesh=j_replica_mesh8())
    t = jn.register(3)
    for i in range(40):
        jn.execute_mut((1, i % 8, i), t)
    mesh = make_mesh(8, 1, devices=CPU8)
    fleet = interop.fleet_from_numpy(jn.log, jn.states, mesh,
                                     states_from=_seqreg_states)
    log_np, states_np = interop.fleet_to_numpy(fleet)
    for f in T.LogState._fields:
        assert np.array_equal(np.asarray(getattr(jn.log, f)), log_np[f])
    for k in states_np:
        assert np.array_equal(np.asarray(jn.states[k]), states_np[k])
    assert fleet.shards[3].log.ltails.tolist() == [
        int(np.asarray(jn.log.ltails)[3])]
    d = make_seqreg(8)
    ex = make_shmap_exec(d, LogSpec(capacity=256, n_replicas=8,
                                    gc_slack=16), mesh, 16)
    fleet, _ = ex(fleet)
    assert fleet.log.ltails.tolist() == [int(jn.log.tail)] * 8


def j_replica_mesh8():
    from node_replication_tpu.parallel import replica_mesh as jrm

    return jrm(8)


def _seqreg_states(states, device):
    return {k: torch.from_numpy(np.array(np.asarray(v))).to(device)
            for k, v in states.items()}
