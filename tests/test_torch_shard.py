"""The port's keyspace-sharded fleet (`node_replication_torch/shard/`)
against the reference's.

- Twins of `tests/test_shard.py`'s 25 tests (the `ShardMap` congruence
  contract and its corruption rules, the router's split, fan-out and
  reassembly over local backends, the TCP submit path with its HELLO
  version fence, and `ShardGroup`'s kill, promote and re-home), on the
  CPU through `nr_kwargs=dict(device="cpu")`, with the reference's
  sizes.
- The port's one knob, `ShardGroup(rids=)`, pinned on both frontends.
- Differential cases (integer data, tolerance 0): `shard_map.json` and
  the router's typed-error payloads are byte-identical across the
  packages and each package reads the other's; a `SocketShardClient` of
  either package talks to the other's `ShardServer`; and one seeded op
  stream through both packages' `ShardGroup` (with a misroute, a stale
  version, a kill and promotion, and an online split) gives equal
  responses and typed errors, equal published maps, and equal ring
  planes, int64 cursors, states and WAL records on every shard.
"""

import json
import os
import threading

import numpy as np
import pytest

from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.serve import ServeConfig as JServeConfig
from node_replication_tpu.serve import ServeFrontend as JServeFrontend
from node_replication_tpu.serve import errors as jerrors
from node_replication_tpu.shard import ReshardPlan as JReshardPlan
from node_replication_tpu.shard import ShardGroup as JShardGroup
from node_replication_tpu.shard import ShardMap as JShardMap
from node_replication_tpu.shard import ShardServer as JShardServer
from node_replication_tpu.shard import SocketShardClient as JSocketShardClient
from node_replication_tpu.shard import router as jrouter

from node_replication_torch import interop
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.models import (
    HM_GET,
    HM_PUT,
    make_hashmap,
)
from node_replication_torch.serve import (
    RetryPolicy,
    ServeConfig,
    ServeFrontend,
    ShardUnavailable,
    WrongShard,
    call_with_retry,
)
from node_replication_torch.serve import errors as terrors
from node_replication_torch.shard import (
    MAP_FILENAME,
    LocalBackend,
    ReshardPlan,
    ShardGroup,
    ShardMap,
    ShardMapCorruptError,
    ShardRouter,
    ShardServer,
    SocketShardClient,
)
from node_replication_torch.shard import router as trouter

NR_KW = dict(n_replicas=1, log_entries=1 << 10, gc_slack=32, device="cpu")
J_NR_KW = {k: v for k, v in NR_KW.items() if k != "device"}


def _frontend(n_keys=64):
    nr = NodeReplicated(make_hashmap(n_keys), **NR_KW)
    return ServeFrontend(nr, ServeConfig(batch_linger_s=0.0))


# ==========================================================================
# ShardMap
# ==========================================================================


class TestShardMap:
    def test_congruence_routing_is_deterministic(self):
        m = ShardMap(3)
        for k in range(30):
            assert m.shard_of(k) == k % 3
            assert m.shard_of_op((HM_PUT, k, 1)) == k % 3

    def test_split_batch_preserves_submission_indices(self):
        m = ShardMap(2)
        ops = [(HM_PUT, k, 100 + k) for k in (0, 1, 2, 5, 4)]
        groups = m.split_batch(ops)
        assert sorted(groups) == [0, 1]
        assert [i for i, _ in groups[0]] == [0, 2, 4]
        assert [i for i, _ in groups[1]] == [1, 3]
        # within a shard, submission order is preserved
        assert [op[1] for _, op in groups[0]] == [0, 2, 4]

    def test_opless_key_rejected(self):
        with pytest.raises(ValueError):
            ShardMap(2).shard_of_op((HM_GET,))

    def test_with_address_bumps_version(self):
        m = ShardMap(2)
        m2 = m.with_address(1, ("127.0.0.1", 9))
        assert m2.version == m.version + 1
        assert m2.addresses[1] == ("127.0.0.1", 9)
        assert m2.addresses[0] is None
        assert m.addresses[1] is None  # immutable original

    def test_publish_load_roundtrip(self, tmp_path):
        m = ShardMap(3).with_address(2, ("h", 7))
        m.publish(str(tmp_path))
        assert os.path.exists(tmp_path / MAP_FILENAME)
        assert ShardMap.load(str(tmp_path)) == m

    def test_invalid_maps_rejected(self):
        with pytest.raises(ValueError):
            ShardMap(0)
        with pytest.raises(ValueError):
            ShardMap(2, addresses=(None,))

    def test_refine_and_coarsen_round_trip(self):
        m = ShardMap(2, addresses=(("a", 1), ("b", 2)))
        r = m.refine()
        assert r.n_shards == 4 and r.version == m.version + 1
        # class s+N keeps class s's address until re-homed
        assert r.addresses == (("a", 1), ("b", 2), ("a", 1), ("b", 2))
        for k in range(40):  # refinement: {s, s+N} partitions class s
            assert r.shard_of(k) % 2 == m.shard_of(k)
        r2 = r.refine(overrides={2: ("c", 3)})
        assert r2.addresses[2] == ("c", 3)
        back = r.coarsen()
        assert back.n_shards == 2
        assert back.addresses == m.addresses
        with pytest.raises(ValueError):
            ShardMap(3).coarsen()  # only refined (even) maps coarsen
        with pytest.raises(ValueError):
            m.refine(overrides={7: ("x", 1)})  # out of range


# ==========================================================================
# corrupt / mid-publish shard maps
# ==========================================================================


class TestShardMapCorruption:
    def _publish(self, tmp_path, m=None):
        (m or ShardMap(2)).publish(str(tmp_path))
        return os.path.join(str(tmp_path), MAP_FILENAME)

    def test_bad_json_is_typed(self, tmp_path):
        path = self._publish(tmp_path)
        with open(path, "w") as f:
            f.write("{torn nonsense")
        with pytest.raises(ShardMapCorruptError) as ei:
            ShardMap.load(path)
        assert path in str(ei.value)

    def test_address_count_mismatch_is_typed(self, tmp_path):
        path = self._publish(tmp_path)
        with open(path, "w") as f:
            f.write('{"n_shards": 3, "version": 2, '
                    '"addresses": [null]}')
        with pytest.raises(ShardMapCorruptError) as ei:
            ShardMap.load(path)
        assert "1 addresses for 3 shards" in str(ei.value)

    def test_missing_fields_and_wrong_types_are_typed(self, tmp_path):
        path = self._publish(tmp_path)
        for doc in ('{"version": 1}', '{"n_shards": "x", "version": 1}',
                    '{"n_shards": 0, "version": 1}', '[1, 2]'):
            with open(path, "w") as f:
                f.write(doc)
            with pytest.raises(ShardMapCorruptError):
                ShardMap.load(path)

    def test_absent_map_stays_file_not_found(self, tmp_path):
        # absent and corrupt are DIFFERENT failures
        with pytest.raises(FileNotFoundError):
            ShardMap.load(str(tmp_path / "nowhere.json"))

    def test_refresh_map_survives_corruption(self, tmp_path):
        from node_replication_torch.obs.metrics import get_registry

        m = ShardMap(2)
        path = self._publish(tmp_path, m)
        fes = [_frontend(), _frontend()]
        router = ShardRouter(
            m, {s: LocalBackend(s, fes[s], m) for s in range(2)},
            map_path=str(tmp_path),
        )
        reg = get_registry()
        was_enabled = reg.enabled
        reg.enable()
        try:
            before = reg.counter("shard.map_corrupt").value
            with open(path, "w") as f:
                f.write("{bit rot")
            # keeps the old map, counts the event, keeps routing
            assert router.refresh_map() is False
            assert router.map.version == m.version
            assert reg.counter("shard.map_corrupt").value == before + 1
            assert int(router.call((HM_PUT, 1, 7))) >= 0
            # a good republish heals on the next poll
            m.with_address(0, None).publish(str(tmp_path))
            assert router.refresh_map() is True
            assert router.map.version == m.version + 1
        finally:
            reg.enabled = was_enabled
            router.close()
            for fe in fes:
                fe.close()

    def test_crash_mid_publish_window_is_invisible(self, tmp_path):
        """A publisher that died mid-`durable_publish` leaves tmp
        debris NEXT TO the intact old map, never a torn map. A router
        polling through that window keeps routing on the old topology
        and converges once the publish completes."""
        m = ShardMap(2)
        path = self._publish(tmp_path, m)
        fes = [_frontend(), _frontend()]
        router = ShardRouter(
            m, {s: LocalBackend(s, fes[s], m) for s in range(2)},
            map_path=str(tmp_path),
        )
        try:
            new_map = m.with_address(0, None)
            blob = json.dumps(new_map.as_dict()).encode()
            # the crash window: a half-written (and a complete but
            # unrenamed) staging file, old map content untouched
            with open(f"{path}.9999.1.tmp", "wb") as f:
                f.write(blob[: len(blob) // 2])
            with open(f"{path}.9999.2.tmp", "wb") as f:
                f.write(blob)
            assert router.refresh_map() is False  # old map, no error
            assert router.map.version == m.version
            assert int(router.call((HM_PUT, 0, 5))) >= 0
            # the retried publish completes; the poll converges
            new_map.publish(str(tmp_path))
            assert router.refresh_map() is True
            assert router.map.version == new_map.version
            # debris is inert: load never looked at it
            assert os.path.exists(f"{path}.9999.1.tmp")
        finally:
            router.close()
            for fe in fes:
                fe.close()


# ==========================================================================
# router over local backends
# ==========================================================================


class TestRouterLocal:
    @pytest.fixture
    def fleet(self):
        m = ShardMap(2)
        fes = [_frontend(), _frontend()]
        router = ShardRouter(
            m, {s: LocalBackend(s, fes[s], m) for s in range(2)}
        )
        yield m, fes, router
        router.close()
        for fe in fes:
            fe.close()

    def test_batch_routes_and_orders_within_shard(self, fleet):
        _m, fes, router = fleet
        # one mixed batch, including a same-key rewrite: each op must
        # land on its owning shard, in submission order (last write
        # wins within the congruence class)
        ops = [(HM_PUT, k, 100 + k) for k in range(8)]
        ops.append((HM_PUT, 3, 999))
        out = router.execute_batch(ops)
        assert len(out) == 9
        for k in range(8):
            want = 999 if k == 3 else 100 + k
            got = fes[k % 2].read((HM_GET, k, 0), rid=0)
            assert int(got) == want

    def test_ops_land_on_owning_shard_only(self, fleet):
        _m, fes, router = fleet
        router.execute_batch([(HM_PUT, k, 1) for k in range(6)])
        # each frontend's log holds exactly its congruence class
        for s, fe in enumerate(fes):
            assert int(fe.nr.log.tail) == 3

    def test_misrouted_op_is_typed_wrong_shard(self, fleet):
        m, fes, _router = fleet
        b = LocalBackend(0, fes[0], m)
        with pytest.raises(WrongShard) as ei:
            b.submit_batch([(HM_PUT, 1, 5)], m.version)
        assert ei.value.key == 1 and ei.value.expected_shard == 1
        # and provably no log effect
        assert int(fes[0].nr.log.tail) == 0

    def test_stale_version_is_wrong_shard(self, fleet):
        m, fes, _router = fleet
        b = LocalBackend(0, fes[0], m)
        b.update_version(m.with_address(0, None))  # now at version 2
        with pytest.raises(WrongShard) as ei:
            b.submit_batch([(HM_PUT, 0, 5)], m.version)
        assert ei.value.peer_version == m.version

    def test_cross_shard_batch_not_atomic(self, fleet):
        _m, fes, router = fleet
        fes[0].close(drain=False)  # shard 0 down
        ops = [(HM_PUT, 0, 7), (HM_PUT, 1, 8)]
        out = router.execute_batch(ops, return_exceptions=True)
        assert isinstance(out[0], ShardUnavailable)
        assert out[0].retryable  # never reached the log
        assert int(out[1]) >= 0  # shard 1 committed independently
        assert int(fes[1].read((HM_GET, 1, 0), rid=0)) == 8

    def test_sequential_fanout_matches_concurrent(self):
        m = ShardMap(2)
        fes = [_frontend(), _frontend()]
        router = ShardRouter(
            m, {s: LocalBackend(s, fes[s], m) for s in range(2)},
            concurrent=False,
        )
        try:
            ops = [(HM_PUT, k, 50 + k) for k in range(6)]
            router.execute_batch(ops)
            for k in range(6):
                got = fes[k % 2].read((HM_GET, k, 0), rid=0)
                assert int(got) == 50 + k
        finally:
            router.close()
            for fe in fes:
                fe.close()


# ==========================================================================
# the TCP submit path
# ==========================================================================


class TestSocketPath:
    @pytest.fixture
    def served(self):
        m = ShardMap(2)
        fes = [_frontend(), _frontend()]
        servers = [
            ShardServer(s, fes[s], m, name="t") for s in range(2)
        ]
        clients = {
            s: SocketShardClient(
                s, (servers[s].host, servers[s].port), m.version
            )
            for s in range(2)
        }
        router = ShardRouter(m, clients)
        yield m, fes, servers, router, clients
        router.close()
        for srv in servers:
            srv.close()
        for fe in fes:
            fe.close()

    def test_roundtrip_over_frames(self, served):
        _m, fes, _servers, router, _clients = served
        router.execute_batch([(HM_PUT, k, 10 + k) for k in range(4)])
        for k in range(4):
            got = fes[k % 2].read((HM_GET, k, 0), rid=0)
            assert int(got) == 10 + k

    def test_typed_errors_survive_the_wire(self, served):
        m, _fes, _servers, _router, clients = served
        with pytest.raises(WrongShard) as ei:
            clients[0].submit_batch([(HM_PUT, 1, 5)], m.version)
        assert ei.value.key == 1 and ei.value.expected_shard == 1

    def test_stale_hello_fenced_on_reconnect(self, served):
        m, _fes, servers, _router, clients = served
        # the shard adopts a bumped map; a client that reconnects
        # under the old version is refused at HELLO: the routing-tier
        # zombie fence
        servers[0].set_map(m.with_address(0, None))
        clients[0].close()  # force a fresh connect + HELLO replay
        with pytest.raises(WrongShard):
            clients[0].submit_batch([(HM_PUT, 0, 1)], m.version)

    def test_dead_server_is_retryable_unavailable(self, served):
        m, _fes, servers, _router, clients = served
        servers[0].close()
        clients[0].close()
        with pytest.raises(ShardUnavailable) as ei:
            clients[0].submit_batch([(HM_PUT, 0, 1)], m.version)
        assert not ei.value.maybe_executed


# ==========================================================================
# ShardGroup: kill one slice, promote, re-home
# ==========================================================================


class TestShardGroup:
    def test_kill_promote_rehome(self, tmp_path):
        g = ShardGroup(2, make_hashmap(64), str(tmp_path), nr_kwargs=NR_KW)
        try:
            r = g.router
            r.execute_batch([(HM_PUT, k, 100 + k) for k in range(8)])
            g.kill_primary(0)
            # the failed slice is typed-unavailable and retryable...
            with pytest.raises(ShardUnavailable) as ei:
                r.call((HM_PUT, 0, 1))
            assert ei.value.retryable
            # ...while the surviving shard never notices
            assert int(r.call((HM_PUT, 1, 201))) >= 0
            fe1 = g.primaries[1].live_frontend
            assert int(fe1.read((HM_GET, 1, 0), rid=0)) == 201
            report = g.promote(0)
            assert report.new_epoch >= 1
            # re-home: bumped map re-published, router repointed, the
            # promoted follower serves the slice with acked history
            assert ShardMap.load(str(tmp_path)).version == 2
            fe0 = g.primaries[0].live_frontend
            assert int(fe0.read((HM_GET, 0, 0), rid=0)) == 100
            assert int(r.call((HM_PUT, 0, 300))) >= 0
            assert int(fe0.read((HM_GET, 0, 0), rid=0)) == 300
        finally:
            g.close()

    def test_call_with_retry_rides_through_promotion(self, tmp_path):
        g = ShardGroup(2, make_hashmap(64), str(tmp_path), nr_kwargs=NR_KW)
        try:
            r = g.router
            call_with_retry(r, (HM_PUT, 0, 5), policy=RetryPolicy())
            g.kill_primary(0)
            done = threading.Event()

            def promote_later():
                g.promote(0)
                done.set()

            t = threading.Thread(target=promote_later,
                                 name="test-shard-promoter")
            t.start()
            try:
                # retries absorb the outage window; the resubmission
                # re-homes onto the promoted follower via refresh_map
                val = call_with_retry(
                    r, (HM_PUT, 0, 6),
                    policy=RetryPolicy(max_attempts=400,
                                       base_backoff_s=0.05),
                    deadline_s=30.0,
                )
            finally:
                # never tear the group down under a live promote
                t.join(timeout=30)
            assert not t.is_alive() and done.is_set()
            assert int(val) >= 0
            fe0 = g.primaries[0].live_frontend
            assert int(fe0.read((HM_GET, 0, 0), rid=0)) == 6
        finally:
            g.close()


def test_shard_rids_bound_both_frontends(tmp_path):
    # the port's one extra knob: the primary's frontend and the
    # follower's read-only frontend serve only the named replicas (one
    # worker thread each); the default serves every replica
    kw = dict(NR_KW, n_replicas=4)
    g = ShardGroup(2, make_hashmap(64), str(tmp_path / "a"), nr_kwargs=kw,
                   rids=range(1, 4, 2))
    try:
        for p in g.primaries:
            assert p.frontend.rids == [1, 3]
            assert p.follower.frontend.rids == [1, 3]
        assert int(g.router.call((HM_PUT, 0, 7), rid=3)) == 0
        with pytest.raises(ValueError):
            g.router.call((HM_PUT, 0, 8), rid=0)
        g.kill_primary(0)
        g.promote(0)
        fe0 = g.primaries[0].live_frontend
        assert fe0.rids == [1, 3] and not fe0.read_only
        assert int(fe0.read((HM_GET, 0), rid=1)) == 7
        assert g.primaries[0].follower.nr.n_replicas == 4
    finally:
        g.close()
    g = ShardGroup(1, make_hashmap(64), str(tmp_path / "b"), nr_kwargs=kw)
    try:
        p = g.primaries[0]
        assert p.frontend.rids == [0, 1, 2, 3]
        assert p.follower.frontend.rids == [0, 1, 2, 3]
    finally:
        g.close()


# =========================================== against the reference


def _maps(pkg):
    M = JShardMap if pkg == "ref" else ShardMap
    m = M(3)
    a = m.with_address(2, ("10.0.0.7", 7400))
    r = a.refine(overrides={4: ("h", 9)})
    return [m, a, r, r.coarsen(), M(5, version=9)]


def test_shard_map_files_byte_identical(tmp_path):
    """The same maps (fresh, re-pointed, refined with an override,
    coarsened, a late version) published by both packages: equal bytes,
    and each package loads the other's file to the same map."""
    for i, (jm, tm) in enumerate(zip(_maps("ref"), _maps("port"))):
        jd, td = tmp_path / f"ref{i}", tmp_path / f"port{i}"
        jd.mkdir()
        td.mkdir()
        jm.publish(str(jd))
        tm.publish(str(td))
        a = (jd / MAP_FILENAME).read_bytes()
        b = (td / MAP_FILENAME).read_bytes()
        assert a == b, i
        assert ShardMap.load(str(jd)) == tm
        assert JShardMap.load(str(td)) == jm
        assert tm.as_dict() == jm.as_dict()


def _errors(E):
    return [
        E.WrongShard(7, 1, 2, 3, peer_version=2),
        E.WrongShard(-1, 0, 0, 4),
        E.ShardUnavailable(2, cause=RuntimeError("gone"),
                           maybe_executed=True),
        E.ShardUnavailable(1),
        E.Overloaded(3, 64),
        E.ReplicaFailed(1, cause=RuntimeError("x"), maybe_executed=False),
        E.DeadlineExceeded(0, 0.25),
        E.NotPrimary(5),
        E.FrontendClosed("closed for good"),
        E.TxnConflict(9, "c.g1.4"),
        E.TxnAborted("c.g1.5", cause=RuntimeError("no vote")),
        E.TxnInDoubt("c.g2.1", decision="commit"),
        ValueError("plain"),
    ]


def test_router_error_payloads_byte_identical():
    """Every typed error the shard wire carries encodes to the same
    JSON bytes in both packages, and each package decodes the other's
    payload to the same type and fields."""
    jerrs, terrs = _errors(jerrors), _errors(terrors)
    for je, te in zip(jerrs, terrs):
        jd, td = jrouter._encode_error(je), trouter._encode_error(te)
        assert json.dumps(jd).encode() == json.dumps(td).encode()
        back_t = trouter._decode_error(jd, 3)
        back_j = jrouter._decode_error(td, 3)
        assert type(back_t).__name__ == type(back_j).__name__
        assert str(back_t) == str(back_j)
        assert vars(back_t).keys() == vars(back_j).keys()
        for f, v in vars(back_t).items():
            if f != "cause":
                assert v == getattr(back_j, f), f
    pairs = [("ok", 0), ("ok", None), ("err", jerrs[0])]
    tpairs = [("ok", 0), ("ok", None), ("err", terrs[0])]
    assert json.dumps(jrouter._encode_pairs(pairs)) == \
        json.dumps(trouter._encode_pairs(tpairs))


def _fe_of(pkg):
    if pkg == "ref":
        nr = JNR(j_make_hashmap(64), **J_NR_KW)
        return JServeFrontend(nr, JServeConfig(batch_linger_s=0.0))
    return _frontend()


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port")])
def test_socket_clients_talk_across_packages(client, server):
    """A `SocketShardClient` of one package against a `ShardServer` of
    the other: routed acks, a misroute answered as a typed
    `WrongShard` of the client's package, a stale HELLO fenced after
    the server adopts a bumped map, and a txn verb refused retryably
    (no participant)."""
    SM = JShardMap if server == "ref" else ShardMap
    Server = JShardServer if server == "ref" else ShardServer
    Client = JSocketShardClient if client == "ref" else SocketShardClient
    E = jerrors if client == "ref" else terrors
    m = SM(2)
    fe = _fe_of(server)
    srv = Server(1, fe, m, name="x")
    cl = Client(1, (srv.host, srv.port), m.version)
    try:
        ops = [(HM_PUT, 1, 11), (HM_PUT, 3, 33), (2, 1), (HM_PUT, 5, 55)]
        pairs = cl.submit_batch(ops, m.version, rid=0)
        assert pairs == [("ok", 0), ("ok", 0), ("ok", 1), ("ok", 0)]
        assert int(fe.read((HM_GET, 3), rid=0)) == 33
        assert int(fe.read((HM_GET, 1), rid=0)) == -1
        with pytest.raises(E.WrongShard) as ei:
            cl.submit_batch([(HM_PUT, 2, 5)], m.version)
        assert (ei.value.key, ei.value.shard, ei.value.expected_shard,
                ei.value.map_version) == (2, 1, 0, 1)
        with pytest.raises(E.ShardUnavailable) as ei:
            cl.txn_verb("status", "c.g1.1", 1, m.version)
        assert not ei.value.maybe_executed
        srv.set_map(m.with_address(1, None))
        cl.close()
        with pytest.raises(E.WrongShard) as ei:
            cl.submit_batch([(HM_PUT, 1, 1)], m.version)
        assert ei.value.peer_version == 1 and ei.value.map_version == 2
        assert int(fe.read((HM_GET, 1), rid=0)) == -1
    finally:
        cl.close()
        srv.close()
        fe.close()


def _ops_stream(seed, n, n_keys=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(-n_keys, 2 * n_keys))
        out.append((HM_PUT, k, int(rng.integers(1, 1 << 30)))
                   if rng.integers(0, 2) else (2, k))
    return out


def _outcome(x):
    """A response or typed error as comparable data."""
    if isinstance(x, BaseException):
        f = {k: v for k, v in vars(x).items() if k != "cause"}
        return (type(x).__name__, tuple(sorted(f.items())))
    return ("ok", int(x))


def _fleet_np(nr):
    lg = nr.log
    if hasattr(lg.tail, "numpy"):
        cur = interop.log_to_numpy(lg)
        states = {f: leaf.numpy() for f, leaf in nr.states.items()}
    else:
        cur = {f: np.asarray(getattr(lg, f)) for f in
               ("opcodes", "args", "head", "tail", "ctail", "ltails")}
        states = {f: np.asarray(nr.states[f]) for f in nr.states}
    return cur, states


def _wal_np(wal):
    return [(r.pos, r.count, np.asarray(r.opcodes).tobytes(),
             np.asarray(r.args).tobytes()) for r in wal.records(0)]


def _drive(pkg, d, stream):
    """One package's sharded run: routed batches, a misroute and a
    stale version at the door, shard 1 killed and promoted (its map
    re-published), more batches, an online split of class 0 re-homing
    class 3, more batches. Returns every outcome and every shard's
    fleet, WAL and map bytes."""
    kw = NR_KW if pkg == "port" else J_NR_KW
    G = ShardGroup if pkg == "port" else JShardGroup
    Plan = ReshardPlan if pkg == "port" else JReshardPlan
    LB = LocalBackend if pkg == "port" else jrouter.LocalBackend
    dispatch = make_hashmap(64) if pkg == "port" else j_make_hashmap(64)
    g = G(3, dispatch, d, nr_kwargs=kw, concurrent_router=False)
    outs, maps = [], []
    plan = None
    try:
        r = g.router

        def batches(part):
            for b in range(0, len(part), 8):
                outs.extend(_outcome(x) for x in r.execute_batch(
                    part[b:b + 8], return_exceptions=True))

        batches(stream[:40])
        m = g.map
        for call in (lambda: LB(0, g.primaries[0].frontend, m)
                     .submit_batch([(HM_PUT, 1, 5)], m.version),
                     lambda: LB(0, g.primaries[0].frontend, m)
                     .submit_batch([(HM_PUT, 0, 5)], m.version + 1)):
            try:
                call()
            except Exception as e:
                outs.append(_outcome(e))
        maps.append((g.map.version, (open(os.path.join(
            d, MAP_FILENAME), "rb").read())))
        g.kill_primary(1)
        outs.extend(_outcome(x) for x in r.execute_batch(
            [(HM_PUT, 1, 1), (HM_PUT, 0, 2)], return_exceptions=True))
        g.promote(1)
        maps.append((g.map.version, open(os.path.join(
            d, MAP_FILENAME), "rb").read()))
        batches(stream[40:80])
        plan = Plan(g, donor=0)
        rep = plan.split()
        maps.append((rep.old_version, rep.new_version, open(os.path.join(
            d, MAP_FILENAME), "rb").read()))
        batches(stream[80:])
        fleets = {}
        for s, p in enumerate(g.primaries):
            nr = p.live_frontend.nr
            nr.sync()
            fleets[s] = (_fleet_np(nr), _wal_np(nr.wal))
        nr = plan._recipient.nr
        nr.sync()
        fleets["moved"] = (_fleet_np(nr), _wal_np(nr.wal))
        return outs, maps, fleets
    finally:
        g.close()


def test_sharded_op_stream_matches_reference(tmp_path):
    """One seeded op stream (keys in [-64, 128), PUT/REMOVE) through
    both packages' three-shard `ShardGroup` with a sequential router:
    equal responses and typed errors (misroute, stale version, a killed
    shard), byte-equal published maps after the promotion and the
    split, and on every shard and the split's recipient equal ring
    planes, int64 cursors, states and WAL records."""
    stream = _ops_stream(31, 120)
    jo, jm, jf = _drive("ref", str(tmp_path / "ref"), stream)
    to, tm, tf = _drive("port", str(tmp_path / "port"), stream)
    assert jo == to
    kinds = {o[0] for o in to}
    assert {"ok", "WrongShard", "ShardUnavailable"} <= kinds
    assert jm == tm and [m[0] for m in tm[:2]] == [1, 2]
    assert tm[2][:2] == (2, 3)
    assert set(jf) == set(tf)
    for s in tf:
        (jcur, jst), jwal = jf[s]
        (tcur, tst), twal = tf[s]
        for f in jcur:
            assert jcur[f].dtype == tcur[f].dtype, (s, f)
            assert np.array_equal(jcur[f], tcur[f]), (s, f)
        for f in jst:
            assert np.array_equal(jst[f], tst[f]), (s, f)
        assert jwal == twal, s
        assert len(twal) > 0


def _recording_server(answers):
    """A one-connection TCP endpoint that records every request frame
    and answers the i-th with `answers[i]`."""
    import socket

    from node_replication_torch.repl.transport import recv_frame, send_frame

    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    got = []

    def serve():
        conn, _ = lsock.accept()
        conn.settimeout(10.0)
        try:
            for ans in answers:
                got.append(recv_frame(conn))
                send_frame(conn, json.dumps(ans).encode())
        finally:
            conn.close()

    t = threading.Thread(target=serve, name="test-shard-recorder")
    t.start()
    return lsock, t, got


def test_shard_frames_byte_identical(tmp_path):
    """The request frames of both packages' `SocketShardClient` (HELLO,
    submit, a txn verb) are equal byte for byte, and so are the answer
    frames both packages' `ShardServer` send for the same requests
    (HELLO, acks, a typed misroute, a refused txn verb)."""
    import socket

    from node_replication_torch.repl.transport import recv_frame, send_frame

    answers = [{"kind": "hello-ok", "shard": 1, "version": 3},
               {"kind": "ack", "pairs": [["ok", 0], ["ok", 1]]},
               {"kind": "txn-ok", "result": [0, None]}]
    frames = {}
    for pkg, Client in (("ref", JSocketShardClient),
                        ("port", SocketShardClient)):
        lsock, t, got = _recording_server(answers)
        cl = Client(1, lsock.getsockname()[:2], 3)
        try:
            assert cl.submit_batch([(HM_PUT, 1, 5), (2, 3)], 3,
                                   deadline_s=0.5, priority=2,
                                   rid=4) == [("ok", 0), ("ok", 1)]
            assert cl.txn_verb("commit", "c.g2.7", 2, 3,
                               ops=[(HM_PUT, 7, 1)],
                               timeout=1.5) == [0, None]
        finally:
            cl.close()
            t.join(timeout=10)
            lsock.close()
        assert not t.is_alive()
        frames[pkg] = got
    assert frames["ref"] == frames["port"] and len(frames["port"]) == 3
    reqs = [{"kind": "hello", "version": 1},
            {"kind": "submit", "version": 1, "ops": [[1, 1, 11], [1, 3, 3]],
             "deadline_s": None, "timeout": 5.0, "priority": None, "rid": 0},
            {"kind": "submit", "version": 1, "ops": [[2, 3], [2, 5]],
             "rid": 0},
            {"kind": "submit", "version": 1, "ops": [[1, 2, 1]]},
            {"kind": "txn", "verb": "status", "txn": "c.g1.1", "gen": 1,
             "version": 1, "ops": []},
            {"kind": "nope"}]
    answered = {}
    for pkg in ("ref", "port"):
        SM = JShardMap if pkg == "ref" else ShardMap
        Server = JShardServer if pkg == "ref" else ShardServer
        fe = _fe_of(pkg)
        srv = Server(1, fe, SM(2), name="rec")
        sock = socket.create_connection((srv.host, srv.port), timeout=10)
        try:
            got = []
            for req in reqs:
                send_frame(sock, json.dumps(req).encode())
                got.append(recv_frame(sock))
            answered[pkg] = got
        finally:
            sock.close()
            srv.close()
            fe.close()
    assert answered["ref"] == answered["port"]
    kinds = [json.loads(f)["kind"] for f in answered["port"]]
    assert kinds == ["hello-ok", "ack", "ack", "error", "error", "error"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_refused_ack_reaches_the_caller_untyped(pkg, tmp_path):
    """A round whose ship-before-ack barrier refuses (a killed shard's
    stopped shipper) reaches the router's caller as the raw
    `ShipError`, not a typed shard-plane error, in both packages: the
    op is in the log, and `call_with_retry` does not resubmit it."""
    if pkg == "ref":
        from node_replication_tpu.durable import WriteAheadLog as W
        from node_replication_tpu.repl.shipper import ShipError
        from node_replication_tpu.serve import call_with_retry as cwr
        nr = JNR(j_make_hashmap(64), **J_NR_KW)
        FE, Cfg, SM = JServeFrontend, JServeConfig, JShardMap
        LB, Router = jrouter.LocalBackend, jrouter.ShardRouter
    else:
        from node_replication_torch.durable import WriteAheadLog as W
        from node_replication_torch.repl.shipper import ShipError
        cwr = call_with_retry
        nr = NodeReplicated(make_hashmap(64), **NR_KW)
        FE, Cfg, SM = ServeFrontend, ServeConfig, ShardMap
        LB, Router = LocalBackend, ShardRouter
    nr.attach_wal(W(str(tmp_path / "wal"), policy="batch"))
    fe = FE(nr, Cfg(durability="batch", batch_linger_s=0.0))

    def refuse(pos):
        raise ShipError("shipper stopped")

    fe.ack_barrier = refuse
    m = SM(1)
    router = Router(m, {0: LB(0, fe, m)})
    try:
        with pytest.raises(ShipError):
            router.call((HM_PUT, 3, 4))
        assert int(nr.wal.tail) == 1
        with pytest.raises(ShipError):
            cwr(router, (HM_PUT, 3, 5))
        assert int(nr.wal.tail) == 2
    finally:
        router.close()
        fe.close()
        nr.detach_wal().close()
