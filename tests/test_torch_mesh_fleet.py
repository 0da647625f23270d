"""The port's mesh-sharded fleet against the reference's.

Twins of every case of `tests/test_mesh_fleet.py`
(`TestNodeReplicatedMesh`, `TestMeshFused`, `TestCnrMesh`). Each drives
one op stream through three fleets: the reference's meshed wrapper (on
the conftest's eight virtual devices), the port's meshed wrapper (eight
`cpu` shards: a mesh device may repeat) and the port's un-meshed
wrapper. They must agree bit for bit: responses, ring planes, the int64
cursors, every replica's state, `replica_device`'s shard index and the
wrappers' `stats()`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_replication_tpu.core.cnr import MultiLogReplicated as JMulti
from node_replication_tpu.core.log import log_append as j_log_append
from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.models import make_seqreg as j_make_seqreg
from node_replication_tpu.models.vspace import make_vspace as j_make_vspace
from node_replication_tpu.parallel import make_mesh as j_make_mesh
from node_replication_tpu.parallel import replica_mesh as j_replica_mesh

from node_replication_torch import interop
from node_replication_torch.core.cnr import MultiLogReplicated
from node_replication_torch.core.log import log_append
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.models import (
    HM_GET,
    HM_PUT,
    SR_GET,
    SR_SET,
    make_hashmap,
    make_seqreg,
)
from node_replication_torch.models.vspace import make_vspace
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.parallel import make_mesh, replica_mesh
from node_replication_torch.utils.checks import debug_checks
from node_replication_torch.utils.trace import get_tracer

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return j_replica_mesh(8)


def _tmesh(n=8):
    return replica_mesh(n, devices=["cpu"] * n)


def _same_fleet(ref, got):
    """Reference (or port) fleet `ref` bit-identical to port fleet
    `got`: ring planes, cursors, states."""
    want_log = (interop.log_to_numpy(ref.log)
                if isinstance(ref.log.tail, torch.Tensor) else ref.log)
    got_log = interop.log_to_numpy(got.log)
    for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
        w = np.asarray(want_log[f] if isinstance(want_log, dict)
                       else getattr(want_log, f))
        assert w.dtype == got_log[f].dtype, f
        assert np.array_equal(w, got_log[f]), f
    for f, leaf in got.states.items():
        w = ref.states[f]
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert np.array_equal(w, leaf.numpy()), f


def _three(ref, got, un):
    _same_fleet(ref, got)
    _same_fleet(un, got)
    assert ref.stats() == got.stats()


def _shard_index(nr, rid):
    """Which mesh shard holds replica `rid` (either package)."""
    dev = nr.replica_device(rid)
    if isinstance(dev, torch.device):
        return nr._placed.shard_of(rid)[0]
    return list(nr.mesh.devices.flat).index(dev)


def _seqreg(mesh=None, jax_side=False, **kw):
    if jax_side:
        return JNR(j_make_seqreg(8), n_replicas=8, log_entries=1 << 12,
                   gc_slack=64, exec_window=32, mesh=mesh, **kw)
    return NodeReplicated(make_seqreg(8), n_replicas=8,
                          log_entries=1 << 12, gc_slack=64,
                          exec_window=32, mesh=mesh, device="cpu", **kw)


def _hashmap(mesh=None, jax_side=False, **kw):
    if jax_side:
        return JNR(j_make_hashmap(64), n_replicas=8, log_entries=1 << 12,
                   gc_slack=64, exec_window=32, mesh=mesh, **kw)
    return NodeReplicated(make_hashmap(64), n_replicas=8,
                          log_entries=1 << 12, gc_slack=64,
                          exec_window=32, mesh=mesh, device="cpu", **kw)


def _trio(make, jmesh, **kw):
    """(reference meshed, port meshed, port un-meshed)."""
    return (make(jmesh, jax_side=True, **kw), make(_tmesh(), **kw),
            make(None, **kw))


class TestNodeReplicatedMesh:
    def test_scan_engine_shmap_tier_bit_identical(self, jmesh):
        fleets = _trio(_seqreg, jmesh)
        ref, got, un = fleets
        assert got.engine == "scan" and got._mesh_tier == "shmap"
        toks = [nr.register(2) for nr in fleets]
        for i in range(60):
            op = (SR_SET, i % 8, i)
            outs = {nr.execute_mut(op, t) for nr, t in zip(fleets, toks)}
            assert len(outs) == 1, i
        assert len({nr.execute((SR_GET, 5), t)
                    for nr, t in zip(fleets, toks)}) == 1
        for nr in fleets:
            nr.sync()
        _three(ref, got, un)

    def test_union_engine_gspmd_tier_bit_identical(self, jmesh):
        fleets = _trio(_hashmap, jmesh)
        ref, got, un = fleets
        assert got.engine == "combined" and got._mesh_tier == "gspmd"
        toks = [nr.register(0) for nr in fleets]
        rng = np.random.default_rng(3)
        for i in range(60):
            op = (HM_PUT, int(rng.integers(64)), int(rng.integers(1000)), 0)
            assert len({nr.execute_mut(op, t)
                        for nr, t in zip(fleets, toks)}) == 1, i
        for k in (0, 7, 31):
            assert len({nr.execute((HM_GET, k), t)
                        for nr, t in zip(fleets, toks)}) == 1
        for nr in fleets:
            nr.sync()
        _three(ref, got, un)

    def test_shmap_forced_on_combined_model(self, jmesh):
        fleets = _trio(_hashmap, jmesh, collectives="shmap")
        ref, got, un = fleets
        assert got._mesh_tier == "shmap" and un.mesh is None
        toks = [nr.register(0) for nr in fleets]
        for i in range(40):
            op = (HM_PUT, i % 64, i, 0)
            assert len({nr.execute_mut(op, t)
                        for nr, t in zip(fleets, toks)}) == 1, i
        for nr in fleets:
            nr.sync()
        _three(ref, got, un)

    def test_batch_path_bit_identical(self, jmesh):
        fleets = _trio(_seqreg, jmesh)
        ops = [(SR_SET, i % 8, i) for i in range(96)]
        outs = [nr.execute_mut_batch(ops, rid=1) for nr in fleets]
        assert outs[0] == outs[1] == outs[2]
        for nr in fleets:
            nr.sync()
        _three(*fleets)

    @pytest.mark.parametrize("pair", ["seqreg", "hashmap"])
    def test_fenced_gc_mask_across_devices(self, jmesh, pair):
        make = _seqreg if pair == "seqreg" else _hashmap
        fleets = _trio(make, jmesh)
        ref, got, un = fleets
        mkop = (
            (lambda i: (SR_SET, i % 8, i)) if pair == "seqreg"
            else (lambda i: (HM_PUT, i % 64, i, 0))
        )
        for nr in fleets:
            t = nr.register(0)
            for i in range(24):
                nr.execute_mut(mkop(i), t)
            nr.fence_replica(5)
            for i in range(24, 48):
                nr.execute_mut(mkop(i), t)
        # the fenced cursor is frozen on shard 5; head advanced past it
        assert int(got.log.ltails[5]) < int(got.log.head)
        _three(ref, got, un)
        for nr in fleets:
            nr.clone_replica_from(5)
            nr.unfence_replica(5)
            nr.sync()
            assert nr.replicas_equal()
        _three(ref, got, un)

    def test_union_round_plans_from_the_global_least_cursor(self, jmesh):
        """Shard-distinct live cursors on the gspmd tier: replica 5 is
        fenced while 40 ops replay, then readmitted without a clone, so
        its shard's least cursor lies 40 entries behind every other
        shard's while 80 more are pending (exec_window 32). Each round
        plans from the global least cursor, as the reference's
        un-meshed program over sharded arrays does: ltails agree round
        by round, and so do the delivered responses."""
        fleets = _trio(_hashmap, jmesh)
        ref, got, un = fleets
        assert got._mesh_tier == "gspmd"
        toks = [nr.register(0) for nr in fleets]
        for i in range(8):
            for nr, t in zip(fleets, toks):
                nr.execute_mut((HM_PUT, i, i, 0), t)
        for nr in fleets:
            nr.fence_replica(5)
        ops = [(HM_PUT, i % 64, i, 0) for i in range(40)]
        assert len({tuple(nr.execute_mut_batch(ops, rid=0))
                    for nr in fleets}) == 1
        for nr in fleets:
            nr.unfence_replica(5)
        assert [int(x) for x in got.log.ltails] == [48] * 5 + [8] + [48] * 2
        # pending entries with no combiner: one exec round at a time
        N = 80
        opc = np.full(N, HM_PUT, np.int32)
        args = np.zeros((N, 3), np.int32)
        args[:, 0] = np.arange(N) % 64
        args[:, 1] = 500 + np.arange(N)
        ref.log = j_log_append(ref.spec, ref.log, jnp.asarray(opc),
                               jnp.asarray(args), N)
        for nr in (got, un):
            nr.log = log_append(nr.spec, nr.log, torch.from_numpy(opc),
                                torch.from_numpy(args), N)
        for rnd in range(8):
            for nr in fleets:
                nr._exec_round()
            want = np.asarray(ref.log.ltails)
            assert np.array_equal(want, got.log.ltails.numpy()), rnd
            assert np.array_equal(want, un.log.ltails.numpy()), rnd
        _three(ref, got, un)
        # and through the combiner, with responses delivered
        for nr in fleets:
            nr.fence_replica(5)
        ops = [(HM_PUT, i % 64, 700 + i, 0) for i in range(40)]
        for nr in fleets:
            nr.execute_mut_batch(ops, rid=0)
            nr.unfence_replica(5)
        ops = [(HM_PUT, i % 64, 900 + i, 0) for i in range(80)]
        outs = [nr.execute_mut_batch(ops, rid=1) for nr in fleets]
        assert outs[0] == outs[1] == outs[2]
        _three(ref, got, un)

    def test_ring_catchup_tier_bit_identical(self, jmesh):
        fleets = _trio(_seqreg, jmesh)
        ref, got, un = fleets
        rng = np.random.default_rng(0)
        N = 400
        opc = np.full(N, SR_SET, np.int32)
        args = np.zeros((N, 3), np.int32)
        args[:, 0] = rng.integers(0, 8, N)
        args[:, 1] = rng.integers(0, 1000, N)
        ref.log = j_log_append(ref.spec, ref.log, jnp.asarray(opc),
                               jnp.asarray(args), N)
        for nr in (got, un):
            nr.log = log_append(nr.spec, nr.log, torch.from_numpy(opc),
                                torch.from_numpy(args), N)
        for nr in fleets:
            nr.sync()
        assert got._ring_rounds > 0, "ring tier never fired"
        assert got._ring_rounds == ref._ring_rounds
        assert un._ring_rounds == 0
        _three(ref, got, un)

    def test_ring_tier_counter(self, jmesh):
        reg = get_registry()
        reg.enable()
        try:
            got = _seqreg(_tmesh())
            before = reg.counter("nr.exec.engine.ring").value
            N = 200
            opc = torch.full((N,), SR_SET, dtype=torch.int32)
            args = torch.zeros((N, 3), dtype=torch.int32)
            got.log = log_append(got.spec, got.log, opc, args, N)
            got.sync()
            assert reg.counter("nr.exec.engine.ring").value > before
            assert reg.counter("nr.exec.mesh.shmap").value > 0
            assert reg.counter("mesh.sync_bytes").value > 0
            assert reg.gauge("mesh.replicas_per_device").value == 1
        finally:
            reg.disable()

    def test_grow_fleet_keeps_placement(self, jmesh):
        fleets = _trio(_seqreg, jmesh)
        ref, got, un = fleets
        toks = [nr.register(0) for nr in fleets]
        for i in range(16):
            for nr, t in zip(fleets, toks):
                nr.execute_mut((SR_SET, i % 8, i), t)
        # growing by a non-multiple of the shard count is rejected
        # before any state mutates
        with pytest.raises(ValueError):
            got.grow_fleet(3)
        assert got.n_replicas == 8
        assert [nr.grow_fleet(8) for nr in fleets] == [
            list(range(8, 16))] * 3
        assert got._placed.n_shards == 8
        assert got.replica_device(15) == got._placed.shards[7].device
        for i in range(16, 32):
            op = (SR_SET, i % 8, i)
            assert len({nr.execute_mut(op, t)
                        for nr, t in zip(fleets, toks)}) == 1
        for nr in fleets:
            nr.sync()
        _three(ref, got, un)
        assert got.replicas_equal()

    def test_checkpoint_restore_replaces(self, jmesh, tmp_path):
        ref, got = _seqreg(jmesh, jax_side=True), _seqreg(_tmesh())
        for nr in (ref, got):
            t = nr.register(0)
            for i in range(20):
                nr.execute_mut((SR_SET, i % 8, i), t)
        path = str(tmp_path / "snap.npz")
        got.checkpoint(path)
        back = NodeReplicated.restore(path, make_seqreg(8), mesh=_tmesh(),
                                      device="cpu")
        _same_fleet(got, back)
        _same_fleet(ref, back)
        # the port's snapshot restores into the reference, meshed
        jback = JNR.restore(path, j_make_seqreg(8), mesh=jmesh)
        _same_fleet(jback, back)
        t2 = back.register(0)
        assert back.execute_mut((SR_SET, 0, 999), t2) is not None
        assert back._mesh_tier is not None
        assert back._placed.n_shards == 8

    def test_validation(self, jmesh):
        with pytest.raises(ValueError):  # 8 shards can't take R=6
            NodeReplicated(make_seqreg(4), n_replicas=6, mesh=_tmesh(),
                           device="cpu")
        with pytest.raises(ValueError):  # unknown tier
            NodeReplicated(make_seqreg(4), n_replicas=8, mesh=_tmesh(),
                           collectives="nope", device="cpu")
        with pytest.raises(ValueError):  # shmap has no debug twin
            NodeReplicated(make_seqreg(4), n_replicas=8, mesh=_tmesh(),
                           collectives="shmap", debug=True, device="cpu")
        with pytest.raises(ValueError):  # not the mesh's home device
            NodeReplicated(make_seqreg(4), n_replicas=8, mesh=_tmesh(),
                           device="meta")
        # the reference raises the same three
        with pytest.raises(ValueError):
            JNR(j_make_seqreg(4), n_replicas=6, mesh=jmesh)

    def test_replica_device_map(self, jmesh):
        ref, got = _seqreg(jmesh, jax_side=True), _seqreg(_tmesh())
        assert [_shard_index(ref, r) for r in range(8)] == \
            [_shard_index(got, r) for r in range(8)] == list(range(8))
        assert all(got.replica_device(r) == torch.device("cpu")
                   for r in range(8))
        assert ref.snapshot()["mesh"] == got.snapshot()["mesh"] == {
            "devices": 8, "tier": "shmap", "replicas_per_device": 1}
        un = NodeReplicated(make_seqreg(4), n_replicas=2, device="cpu")
        # un-meshed the port names the fleet's device (the reference
        # None), and has no mesh
        assert un.replica_device(0) == torch.device("cpu")
        assert un.snapshot()["mesh"] is None

    def test_serve_frontend_maps_workers_to_devices(self, jmesh):
        from node_replication_torch.serve import ServeConfig, ServeFrontend

        got = _seqreg(_tmesh())
        with ServeFrontend(got, ServeConfig(batch_max_ops=8,
                                            batch_linger_s=0.0)) as fe:
            for i in range(1, 9):
                assert fe.call((SR_SET, 2, i),
                               rid=i % got.n_replicas) == i - 1
            st = fe.stats()
            dev_map = dict(fe.device_of_rid)
        assert dev_map == {r: str(got.replica_device(r)) for r in range(8)}
        # eight shards on one repeated device: one device key
        assert st["mesh"]["devices"] == len(set(dev_map.values())) == 1
        assert sum(st["mesh"]["replicas_per_device"].values()) == 8
        assert len(st["mesh"]["device_of_rid"]) == 8


def _mixed_ops(rng, n, n_keys):
    ops = []
    for _ in range(n):
        if rng.rand() < 0.7:
            ops.append((HM_PUT, int(rng.randint(n_keys)),
                        int(rng.randint(1000))))
        else:
            ops.append((2, int(rng.randint(n_keys))))
    return ops


class TestMeshFused:
    def test_forced_30_rounds_two_wraps_fence_repair(self):
        K, R = 31, 4
        kw = dict(n_replicas=R, log_entries=256, gc_slack=32,
                  exec_window=32)
        j_m = JNR(j_make_hashmap(K), engine="pallas",
                  mesh=j_replica_mesh(2), **kw)
        t_m = NodeReplicated(make_hashmap(K), engine="pallas",
                             mesh=_tmesh(2), device="cpu", **kw)
        t_s = NodeReplicated(make_hashmap(K), engine="scan", device="cpu",
                             **kw)
        fleets = (j_m, t_m, t_s)
        reg = get_registry()
        reg.enable()
        try:
            before = reg.counter("log.engine.mesh_fused").value
            mesh_before = reg.counter("nr.exec.mesh.mesh_fused").value
            rng = np.random.RandomState(7)
            for rnd in range(30):
                if rnd == 12:
                    for nr in fleets:
                        nr.fence_replica(3)  # shard 1 of the 2-wide mesh
                if rnd == 16:
                    for nr in fleets:
                        nr.clone_replica_from(3, donor=0)
                        nr.unfence_replica(3)
                ops = _mixed_ops(rng, int(rng.randint(18, 26)), K)
                outs = [nr.execute_mut_batch(ops, rid=0) for nr in fleets]
                assert outs[0] == outs[1] == outs[2], rnd
            # the port's registry: every round one meshed round
            assert reg.counter("log.engine.mesh_fused").value \
                - before == 30
            assert reg.counter("nr.exec.mesh.mesh_fused").value \
                - mesh_before == 30
        finally:
            reg.disable()
        assert int(t_m.log.tail) > 2 * 256  # two genuine ring wraps
        for nr in fleets:
            nr.sync()
        _same_fleet(j_m, t_m)
        _same_fleet(t_s, t_m)
        assert j_m.stats() == t_m.stats()
        assert t_m.replicas_equal()
        st = t_m.stats()
        assert st["fused_tier"] == "forced" and st["fused_rounds"] == 30
        assert st["exec_rounds"] == 0 and st["mesh_devices"] == 2
        assert t_m.last_round_tier == t_m.round_tier(0) == "mesh_fused"

    @pytest.mark.parametrize("fenced", [False, True])
    def test_engine_round_matches_reference_programs(self, fenced):
        # the port's one form of the meshed round against both forms of
        # the reference's (its shard_map program and its sliced
        # composition), unfenced and fenced; under debug checks the
        # shards' ring planes are also checked equal
        from node_replication_tpu.core.log import LogSpec as JLogSpec
        from node_replication_tpu.core.log import log_init as j_log_init
        from node_replication_tpu.core.replica import (
            replicate_state as j_replicate,
        )
        from node_replication_tpu.ops.encoding import (
            encode_ops as j_encode,
        )
        from node_replication_tpu.parallel import (
            MeshFusedEngine as JMeshFused,
        )

        from node_replication_torch.core.log import LogSpec, log_init
        from node_replication_torch.core.replica import replicate_state
        from node_replication_torch.ops.encoding import encode_ops
        from node_replication_torch.parallel import (
            MeshFusedEngine,
            place,
        )

        K, R = 13, 4
        rng = np.random.RandomState(3)
        ops = [(HM_PUT, int(rng.randint(K)), int(rng.randint(100)))
               for _ in range(7)]
        fen = np.array([False, False, True, False]) if fenced else None
        jspec = JLogSpec(capacity=256, n_replicas=R, arg_width=3,
                         gc_slack=32)
        jd = j_make_hashmap(K)
        jeng = JMeshFused(jd, jspec, j_replica_mesh(2))
        jopc, jargs, n = j_encode(ops, 3, pad_to=8)
        extra = (jnp.asarray(fen, bool),) if fenced else ()
        want = [
            f(j_log_init(jspec), j_replicate(jd.init_state(), R), jopc,
              jargs, n, *extra)
            for f in (jeng._sliced_round(8, fenced),
                      jeng._shmap_round(8, fenced))
        ]
        spec = LogSpec(capacity=256, n_replicas=R, arg_width=3,
                       gc_slack=32)
        d = make_hashmap(K)
        eng = MeshFusedEngine(d, spec, _tmesh(2))
        fleet = place(log_init(spec, "cpu"),
                      replicate_state(d.init_state("cpu"), R), _tmesh(2))
        opc, args, _ = encode_ops(ops, 3, pad_to=8, device="cpu")
        with debug_checks(True):
            fleet, resps = eng.round(fleet, opc, args, n, fenced=fen)
        got_log = interop.log_to_numpy(fleet.log)
        for jlog, jstates, jresps in want:
            for f in got_log:
                assert np.array_equal(np.asarray(getattr(jlog, f)),
                                      got_log[f]), f
            for f, leaf in fleet.states.items():
                assert np.array_equal(np.asarray(jstates[f]), leaf.numpy())
            assert np.array_equal(np.asarray(jresps), resps.numpy())

    def test_fenced_head_gc_corpse_on_other_shard(self):
        kw = dict(n_replicas=4, log_entries=256, gc_slack=32,
                  engine="pallas")
        fleets = (JNR(j_make_hashmap(16), mesh=j_replica_mesh(2), **kw),
                  NodeReplicated(make_hashmap(16), mesh=_tmesh(2),
                                 device="cpu", **kw))
        for nr in fleets:
            nr.execute_mut_batch([(HM_PUT, 1, 1), (HM_PUT, 2, 2)], rid=0)
            nr.fence_replica(2)  # shard 1 hosts rids 2, 3
        frozen = int(fleets[1].log.ltails[2])
        for i in range(3):
            outs = [nr.execute_mut_batch([(HM_PUT, i, i * 3)], rid=0)
                    for nr in fleets]
            assert outs[0] == outs[1]
        got = fleets[1]
        assert got.stats()["fused_rounds"] == 4
        assert int(got.log.ltails[2]) == frozen
        assert int(got.log.head) > frozen  # GC not stalled by the corpse
        _same_fleet(fleets[0], got)
        assert fleets[0].stats() == got.stats()

    def test_grow_resets_calibration_at_devices_key(self, monkeypatch):
        monkeypatch.setenv("NR_TPU_FUSED_CAL", "1")
        t = get_tracer()
        t.enable(None)
        try:
            nr = NodeReplicated(make_hashmap(17), n_replicas=8,
                                log_entries=512, gc_slack=64,
                                engine="auto", mesh=_tmesh(4),
                                device="cpu")
            assert nr.stats()["fused_tier"] == "calibrating"
            for i in range(8):
                nr.execute_mut_batch(
                    [(HM_PUT, i % 17, i), (HM_PUT, (i + 5) % 17, i)],
                    rid=0,
                )
            st = nr.stats()
            assert st["fused_tier"] in ("auto:mesh_fused",
                                        "auto:chain"), st
            cal = [e for e in t.events()
                   if e["event"] == "fused-calibration"]
            assert cal and cal[-1]["devices"] == 4
            assert cal[-1]["tier"] == "mesh_fused"
            assert cal[-1]["winner"] in ("mesh_fused", "chain")
            nr.grow_fleet(4)
            assert nr.stats()["fused_tier"] == "calibrating"
        finally:
            t.disable()

    def test_vspace_mesh_fused_and_fenced_fallback(self):
        P_pages = 512
        kw = dict(n_replicas=4, log_entries=512, gc_slack=64)
        j_m = JNR(j_make_vspace(P_pages, max_span=8), engine="pallas",
                  mesh=j_replica_mesh(2), **kw)
        t_m = NodeReplicated(make_vspace(P_pages, max_span=8),
                             engine="pallas", mesh=_tmesh(2), device="cpu",
                             **kw)
        t_s = NodeReplicated(make_vspace(P_pages, max_span=8),
                             engine="scan", device="cpu", **kw)
        fleets = (j_m, t_m, t_s)
        rng = np.random.RandomState(11)
        ops = []
        for _ in range(12):
            if rng.rand() < 0.7:
                ops.append((1, int(rng.randint(P_pages)),
                            int(rng.randint(1, 1000)),
                            int(rng.randint(0, 8))))
            else:
                ops.append((2, int(rng.randint(P_pages)),
                            int(rng.randint(0, 8))))
        outs = [nr.execute_mut_batch(ops, rid=0) for nr in fleets]
        assert outs[0] == outs[1] == outs[2]
        assert t_m.last_round_tier == j_m.last_round_tier == "mesh_fused"
        reg = get_registry()
        reg.enable()
        try:
            fb = reg.counter("nr.exec.engine.fused_fallback")
            before = fb.value
            for nr in fleets:
                nr.fence_replica(3)
            ops2 = [(1, 9, 99, 4)]
            outs = [nr.execute_mut_batch(ops2, rid=0) for nr in fleets]
            assert outs[0] == outs[1] == outs[2]
            assert fb.value > before
        finally:
            reg.disable()
        assert t_m.last_round_tier == t_m.engine  # the chain served it
        for nr in fleets:
            nr.sync()
        _same_fleet(j_m, t_m)
        _same_fleet(t_s, t_m)

    def test_pipelined_serve_depth1_meshed(self):
        from node_replication_torch.serve import ServeConfig, ServeFrontend

        nr = NodeReplicated(make_seqreg(8), n_replicas=2, log_entries=512,
                            gc_slack=64, engine="scan", mesh=_tmesh(2),
                            device="cpu")
        assert nr.stats()["fused_tier"] == "off"  # seqreg has no factory
        nr_f = NodeReplicated(make_hashmap(32), n_replicas=2,
                              log_entries=512, gc_slack=64,
                              engine="pallas", mesh=_tmesh(2),
                              device="cpu")
        t = get_tracer()
        t.enable(None)
        try:
            with ServeFrontend(
                nr_f,
                ServeConfig(queue_depth=32, batch_max_ops=8,
                            batch_linger_s=0.002, pipeline_depth=1),
            ) as fe:
                for i in range(24):
                    assert fe.call((HM_PUT, i % 32, i),
                                   rid=fe.rids[i % 2]) == 0
                assert fe.read((HM_GET, 5), rid=fe.rids[0]) >= 0
            events = t.events()
        finally:
            t.disable()
        batches = [e for e in events if e["event"] == "serve-batch"]
        assert batches
        assert all(e.get("engine") == "mesh_fused" for e in batches)
        launches = [e for e in events if e["event"] == "kernel-launch"]
        assert launches
        assert all(e["tier"] == "mesh_fused" and e["devices"] == 2
                   for e in launches)
        assert nr_f.stats()["fused_rounds"] > 0
        nr_f.sync()
        assert nr_f.replicas_equal()
        # every acked put landed: key k holds k (puts of (i % 32, i))
        assert nr_f.states["values"][:, :24].tolist() == \
            [list(range(24))] * 2
        assert bool(nr_f.states["present"][:, :24].all())


def _mapper(opc, args):
    return args[0]


class TestCnrMesh:
    KW = dict(nlogs=4, n_replicas=2, log_entries=1 << 10, gc_slack=32,
              exec_window=32)

    def _trio(self):
        return (
            JMulti(j_make_hashmap(64), _mapper, mesh=j_make_mesh(2, 4),
                   **self.KW),
            MultiLogReplicated(make_hashmap(64), _mapper,
                               mesh=make_mesh(2, 4, devices=CPU8),
                               device="cpu", **self.KW),
            MultiLogReplicated(make_hashmap(64), _mapper, device="cpu",
                               **self.KW),
        )

    @staticmethod
    def _same_cnr(ref, got):
        for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
            w = getattr(ref.ml, f)
            w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
            assert np.array_equal(w, getattr(got.ml, f).numpy()), f
        for f, leaf in got.states.items():
            w = ref.states[f]
            w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
            assert np.array_equal(w, leaf.numpy()), f

    def test_cnr_bit_identical(self, jmesh):
        fleets = self._trio()
        reads = []
        for nr in fleets:
            t = nr.register(0)
            r2 = nr.register(1)
            rr = np.random.default_rng(5)
            outs = [nr.execute_mut((HM_PUT, int(rr.integers(64)),
                                    int(rr.integers(1000)), 0), t)
                    for _ in range(60)]
            nr.sync()
            reads.append((outs, nr.execute((HM_GET, 7), r2)))
        assert reads[0] == reads[1] == reads[2]
        ref, got, un = fleets
        self._same_cnr(ref, got)
        self._same_cnr(un, got)
        assert ref.stats() == got.stats()
        assert got.snapshot()["mesh"] == ref.snapshot()["mesh"] == {
            "devices": 8, "tier": "gspmd",
            "shape": {"replica": 2, "log": 4},
        }
        assert [_shard_index_cnr(ref, r) for r in range(2)] == \
            [_shard_index_cnr(got, r) for r in range(2)] == [0, 1]

    def test_cnr_batch_bit_identical(self, jmesh):
        fleets = self._trio()
        ops = [(HM_PUT, i % 64, i, 0) for i in range(48)]
        outs = [nr.execute_mut_batch(ops, rid=0) for nr in fleets]
        assert outs[0] == outs[1] == outs[2]
        for nr in fleets:
            nr.sync()
        self._same_cnr(fleets[0], fleets[1])
        self._same_cnr(fleets[2], fleets[1])

    def test_cnr_serve_frontend(self, jmesh):
        from node_replication_torch.serve import ServeConfig, ServeFrontend

        got = self._trio()[1]
        with ServeFrontend(got, ServeConfig(batch_max_ops=8,
                                            batch_linger_s=0.0)) as fe:
            assert fe.call((HM_PUT, 3, 7, 0), rid=1) == 0
            st = fe.stats()
        assert st["mesh"]["device_of_rid"] == {0: "cpu", 1: "cpu"}
        assert st["mesh"]["devices"] == 1  # both rows on one cpu device

    def test_cnr_validation(self, jmesh):
        mesh = make_mesh(2, 4, devices=CPU8)
        with pytest.raises(ValueError):  # L=3 can't shard over 4 cols
            MultiLogReplicated(make_hashmap(8), _mapper, nlogs=3,
                               n_replicas=2, mesh=mesh, device="cpu")
        with pytest.raises(ValueError):  # R=3 can't shard over 2 rows
            MultiLogReplicated(make_hashmap(8), _mapper, nlogs=4,
                               n_replicas=3, mesh=mesh, device="cpu")
        with pytest.raises(ValueError):  # not a ('replica', 'log') Mesh
            MultiLogReplicated(make_hashmap(8), _mapper, nlogs=4,
                               n_replicas=2, mesh=4, device="cpu")
        with pytest.raises(ValueError):  # the CNR fused tier is un-meshed
            MultiLogReplicated(make_hashmap(8), _mapper, nlogs=4,
                               n_replicas=2, mesh=mesh, engine="pallas",
                               device="cpu")


def _shard_index_cnr(nr, rid):
    dev = nr.replica_device(rid)
    if isinstance(dev, torch.device):
        return nr._placed.shard_of(rid)[0]
    return [row.flat[0] for row in nr.mesh.devices].index(dev)


def test_ring_catchup_reclaims_the_wal(tmp_path):
    # the ring tier is the fourth WAL reclaim site: after a ring pass
    # the WAL keeps no whole segment below the new head, as after the
    # un-meshed scan rounds it replaces
    from node_replication_torch.durable.wal import WriteAheadLog

    rng = np.random.default_rng(9)
    N, chunk = 400, 100
    opc = np.full(N, SR_SET, np.int32)
    args = np.zeros((N, 3), np.int32)
    args[:, 0] = rng.integers(0, 8, N)
    args[:, 1] = rng.integers(0, 1000, N)
    ops = [(int(o), int(a[0]), int(a[1]), int(a[2]))
           for o, a in zip(opc, args)]
    bases = []
    for name, mesh in (("mesh", _tmesh()), ("un", None)):
        nr = _seqreg(mesh)
        wal = WriteAheadLog(str(tmp_path / name), policy="none",
                            segment_max_bytes=256)
        for p in range(0, N, chunk):
            wal.append(p, ops[p:p + chunk])
        wal.reclaim_floor = N
        nr.log = log_append(nr.spec, nr.log, torch.from_numpy(opc),
                            torch.from_numpy(args), N)
        nr.attach_wal(wal)
        nr.sync()
        assert (nr._ring_rounds > 0) == (mesh is not None)
        bases.append(wal.base)
        wal.close()
    assert bases[0] == bases[1] > 0
