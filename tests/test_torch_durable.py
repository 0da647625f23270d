"""The port's durability plane (`node_replication_torch/durable/`,
`core/checkpoint.py` and the wrapper's WAL hooks) against the
reference's.

- For the same op stream the port writes WAL segments and snapshot
  files byte for byte equal to the reference's (the snapshot's zip
  entries carry the save time, so both saves run under one frozen
  clock).
- A WAL and snapshot written by either package recover in the other to
  the same ring planes, int64 cursors and states as in the package that
  wrote them.
- Twins of `tests/test_durable.py`'s WAL framing, snapshot integrity,
  recovery and durable-serve cases, and of `tests/test_checkpoint.py`.
"""

import os
import shutil
import time
import types
import zipfile

import numpy as np
import pytest

from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.durable import WriteAheadLog as JWriteAheadLog
from node_replication_tpu.durable import recover_fleet as j_recover_fleet
from node_replication_tpu.durable import (
    save_durable_snapshot as j_save_durable_snapshot,
)
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.models import make_seqreg as j_make_seqreg

from node_replication_torch import interop
from node_replication_torch.core.checkpoint import (
    SnapshotCorruptError,
    load_snapshot,
    peek_spec,
    recover_states,
    save_snapshot,
)
from node_replication_torch.core.log import (
    LogSpec,
    log_append,
    log_exec_all,
    log_init,
    ring_slice,
)
from node_replication_torch.core.replica import (
    NodeReplicated,
    replicate_state,
)
from node_replication_torch.durable import (
    WalCorruptError,
    WalError,
    WriteAheadLog,
    list_snapshots,
    recover_fleet,
    save_durable_snapshot,
)
from node_replication_torch.durable.wal import (
    _REC_HEADER,
    _REC_PREFIX,
    _SEG_HEADER,
)
from node_replication_torch.fault import FaultError, FaultPlan, FaultSpec
from node_replication_torch.models import (
    HM_GET,
    HM_PUT,
    SR_GET,
    SR_SET,
    make_hashmap,
    make_seqreg,
)
from node_replication_torch.ops.encoding import encode_ops
from node_replication_torch.serve import ServeConfig, ServeFrontend
from node_replication_torch.utils.tree import tree_leaves

DISPATCH = make_hashmap(64)
NR_KW = dict(n_replicas=2, log_entries=1 << 10, gc_slack=32)
CPU = dict(device="cpu")


def states_np(nr):
    return {k: v.numpy().copy() for k, v in nr.states.items()}


def assert_states_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _filled_nr(n_ops=50, n_replicas=2):
    nr = NodeReplicated(make_hashmap(64), n_replicas=n_replicas,
                        log_entries=1 << 10, gc_slack=32, device="cpu")
    tok = nr.register(0)
    for i in range(n_ops):
        nr.execute_mut((HM_PUT, i % 64, 1000 + i), tok)
    nr.sync()
    return nr


# ------------------------------------------------- against the reference


def _frozen_zip_clock(monkeypatch):
    """npz members carry their save time: pin zipfile's clock."""
    shim = types.SimpleNamespace(time=lambda: 1_700_000_000.0,
                                 localtime=time.localtime)
    monkeypatch.setattr(zipfile, "time", shim)


def _stream(model, seed, n):
    rng = np.random.default_rng(seed)
    if model == "seqreg":
        return [(1, int(rng.integers(-8, 24)), int(rng.integers(1 << 30)))
                for _ in range(n)]
    return [(int(rng.integers(1, 3)), int(rng.integers(-16, 48)),
             int(rng.integers(1 << 30))) for _ in range(n)]


def _fleets(model, engine):
    kw = dict(n_replicas=3, log_entries=256, gc_slack=32, exec_window=32,
              engine=engine)
    if model == "seqreg":
        return (j_make_seqreg(16), make_seqreg(16),
                JNR(j_make_seqreg(16), **kw),
                NodeReplicated(make_seqreg(16), device="cpu", **kw))
    return (j_make_hashmap(24), make_hashmap(24),
            JNR(j_make_hashmap(24), **kw),
            NodeReplicated(make_hashmap(24), device="cpu", **kw))


def _drive(nr, ops, snap_dir, at):
    """Batches of 9 ops round-robin over the replicas, a durable
    snapshot after batch `at`, the WAL synced at the end."""
    resps = []
    for b, i in enumerate(range(0, len(ops), 9)):
        resps += nr.execute_mut_batch(ops[i:i + 9], rid=b % 3)
        if b == at:
            yield "snap"
    nr.wal.sync()
    yield resps


def _same_fleet(jn, tn):
    got = interop.log_to_numpy(tn.log)
    for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
        want = np.asarray(getattr(jn.log, f))
        assert want.dtype == got[f].dtype and want.shape == got[f].shape
        assert np.array_equal(want, got[f]), f
    for f, leaf in tn.states.items():
        assert np.array_equal(np.asarray(jn.states[f]), leaf.numpy()), f


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


@pytest.mark.parametrize("model,engine", [("seqreg", "auto"),
                                          ("hashmap", "pallas")])
def test_wal_and_snapshot_files_byte_identical(model, engine, tmp_path,
                                               monkeypatch):
    """The same op stream (the ring of 256 wraps) through both packages,
    each with a WAL and one durable snapshot mid-stream: every file on
    disk is equal byte for byte, the responses and fleets too."""
    _frozen_zip_clock(monkeypatch)
    ops = _stream(model, 3, 420)
    _, _, jn, tn = _fleets(model, engine)
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    jn.attach_wal(JWriteAheadLog(os.path.join(jd, "wal"), policy="batch",
                                 segment_max_bytes=4096))
    tn.attach_wal(WriteAheadLog(os.path.join(td, "wal"), policy="batch",
                                segment_max_bytes=4096))
    jg, tg = _drive(jn, ops, jd, 20), _drive(tn, ops, td, 20)
    assert next(jg) == next(tg) == "snap"
    j_save_durable_snapshot(jn, jd)
    save_durable_snapshot(tn, td)
    assert next(jg) == next(tg)
    _same_fleet(jn, tn)
    jn.detach_wal().close()
    tn.detach_wal().close()
    jf, tf = _files(jd), _files(td)
    assert sorted(jf) == sorted(tf) and len(tf) >= 3
    for name in jf:
        assert jf[name] == tf[name], name


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("model,engine", [("seqreg", "auto"),
                                          ("hashmap", "pallas")])
def test_each_package_recovers_the_others_files(writer, model, engine,
                                                tmp_path):
    """Files written by one package recover in the other to the ring,
    cursors and states the writer's own recovery reaches."""
    ops = _stream(model, 4, 300)
    jd_, td_, jn, tn = _fleets(model, engine)
    d = str(tmp_path / "dir")
    src, Wal, save = ((jn, JWriteAheadLog, j_save_durable_snapshot)
                      if writer == "ref"
                      else (tn, WriteAheadLog, save_durable_snapshot))
    src.attach_wal(Wal(os.path.join(d, "wal"), policy="batch"))
    g = _drive(src, ops, d, 12)
    next(g)
    save(src, d)
    next(g)
    src.detach_wal().close()
    d_ref, d_port = str(tmp_path / "for-ref"), str(tmp_path / "for-port")
    shutil.copytree(d, d_ref)
    shutil.copytree(d, d_port)
    jr, jrep = j_recover_fleet(d_ref, jd_, nr_kwargs=dict(engine=engine))
    tr, trep = recover_fleet(d_port, td_,
                             nr_kwargs=dict(engine=engine, device="cpu"))
    assert (trep.snapshot_pos, trep.wal_ops, trep.tail) == \
        (jrep.snapshot_pos, jrep.wal_ops, jrep.tail)
    assert trep.wal_ops > 0 and trep.tail == len(ops)
    _same_fleet(jr, tr)
    src.sync()  # the writer's live fleet reaches the same states
    for f, leaf in tr.states.items():
        live = src.states[f]
        live = np.asarray(live) if writer == "ref" else live.numpy()
        assert np.array_equal(live, leaf.numpy()), f
    jr.detach_wal().close()
    tr.detach_wal().close()


# --------------------------------------------------------------- WAL unit


class TestWalFraming:
    def test_roundtrip_and_chain(self, tmp_path):
        w = WriteAheadLog(str(tmp_path), policy="none")
        w.append(0, [(1, 5, 50), (1, 6, 60)])
        w.append(2, [(2, 7, 0)])
        assert w.tail == 3
        with pytest.raises(WalError, match="chain"):
            w.append(7, [(1, 0, 0)])  # gap
        w.close()
        w2 = WriteAheadLog(str(tmp_path))
        recs = list(w2.records())
        assert [r.pos for r in recs] == [0, 2]
        assert recs[0].ops() == [(1, 5, 50, 0), (1, 6, 60, 0)]
        # slicing starts mid-record
        part = list(w2.records(start=1))
        assert part[0].pos == 1 and part[0].ops() == [(1, 6, 60, 0)]
        w2.close()

    def test_durable_tail_tracks_policy(self, tmp_path):
        w = WriteAheadLog(str(tmp_path), policy="batch")
        w.append(0, [(1, 1, 1)])
        assert w.tail == 1 and w.durable_tail == 0
        assert w.sync() == 1
        assert w.durable_tail == 1
        w.close()
        a = WriteAheadLog(str(tmp_path / "a"), policy="always")
        a.append(0, [(1, 1, 1)])
        assert a.durable_tail == 1  # fsync inside append
        a.close()

    def test_torn_final_record_truncated_on_open(self, tmp_path):
        w = WriteAheadLog(str(tmp_path), policy="always")
        w.append(0, [(1, 1, 10)])
        w.append(1, [(1, 2, 20), (1, 3, 30)])
        w.close()
        seg = os.path.join(str(tmp_path), os.listdir(tmp_path)[0])
        os.truncate(seg, os.path.getsize(seg) - 4)  # tear record 2
        w2 = WriteAheadLog(str(tmp_path))
        assert w2.tail == 1  # only the intact record survives
        assert w2.durable_tail == 1
        assert w2.truncated_bytes > 0
        # the WAL is usable again at the truncated tail
        w2.append(1, [(1, 9, 90)])
        assert list(w2.records())[-1].pos == 1
        w2.close()

    def test_corrupt_mid_segment_rejected_with_position(self, tmp_path):
        w = WriteAheadLog(str(tmp_path), policy="always")
        w.append(0, [(1, 1, 10)])
        w.append(1, [(1, 2, 20)])
        w.close()
        seg = os.path.join(str(tmp_path), os.listdir(tmp_path)[0])
        # flip one payload byte of the FIRST record: a complete record
        # with a bad CRC is bit rot, never silently truncated
        with open(seg, "r+b") as f:
            f.seek(_SEG_HEADER.size + 10)
            b = f.read(1)
            f.seek(_SEG_HEADER.size + 10)
            f.write(bytes([b[0] ^ 0x01]))
        with pytest.raises(WalCorruptError, match="CRC") as ei:
            WriteAheadLog(str(tmp_path))
        assert ei.value.segment == seg
        assert ei.value.offset == _SEG_HEADER.size
        assert ei.value.pos == 0

    def test_rotation_and_head_keyed_reclaim(self, tmp_path):
        w = WriteAheadLog(str(tmp_path), policy="none",
                          segment_max_bytes=64)  # rotate ~every record
        for i in range(6):
            w.append(i, [(1, i, i)])
        assert w.stats()["segments"] >= 3
        # no reclaim without a snapshot floor, however far head ran
        assert w.maybe_reclaim(6) == 0
        w.reclaim_floor = 4
        # ...and none past the GC head even WITH a floor
        assert w.maybe_reclaim(0) == 0
        deleted = w.maybe_reclaim(6)  # min(head=6, floor=4) = 4
        assert deleted >= 1
        assert w.base <= 4  # records >= floor all still readable
        assert [r.pos for r in w.records(4)] == [4, 5]
        w.close()
        w2 = WriteAheadLog(str(tmp_path))  # non-zero base reopens fine
        assert w2.tail == 6
        w2.close()

    def test_fault_sites_fire(self, tmp_path):
        w = WriteAheadLog(str(tmp_path), policy="batch")
        w.append(0, [(1, 1, 1)])
        with FaultPlan([FaultSpec(site="wal-append",
                                  action="raise")]).armed():
            with pytest.raises(FaultError):
                w.append(1, [(1, 2, 2)])
        w.append(1, [(1, 2, 2)])  # plan spent; WAL unharmed
        with FaultPlan([FaultSpec(site="wal-fsync",
                                  action="raise")]).armed():
            with pytest.raises(FaultError):
                w.sync()
        assert w.sync() == 2
        # corrupt-bytes: flips a byte of the last on-disk record; the
        # next append buries it mid-segment, so reopen must REJECT
        with FaultPlan([FaultSpec(site="wal-append",
                                  action="corrupt-bytes")]).armed():
            w.append(2, [(1, 3, 3)])
        w.close()
        with pytest.raises(WalCorruptError):
            WriteAheadLog(str(tmp_path))



class TestSnapshotIntegrity:
    def _save(self, tmp_path):
        spec = LogSpec(capacity=1 << 8, n_replicas=1, gc_slack=32)
        states = replicate_state(DISPATCH.init_state("cpu"), 1)
        path = str(tmp_path / "snap.npz")
        save_snapshot(path, spec, log_init(spec, "cpu"), states)
        return path, states

    def test_digest_roundtrip_ok(self, tmp_path):
        path, states = self._save(tmp_path)
        spec2, _, _ = load_snapshot(path, states)
        assert spec2.n_replicas == 1
        assert peek_spec(path).n_replicas == 1

    def test_bitflip_raises_typed(self, tmp_path):
        path, states = self._save(tmp_path)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
        with pytest.raises(SnapshotCorruptError):
            load_snapshot(path, states)

    def test_truncation_raises_typed(self, tmp_path):
        path, states = self._save(tmp_path)
        os.truncate(path, os.path.getsize(path) // 2)
        with pytest.raises(SnapshotCorruptError):
            load_snapshot(path, states)
        with pytest.raises(SnapshotCorruptError):
            peek_spec(path)

    def test_missing_digest_raises_typed(self, tmp_path):
        path = str(tmp_path / "legacy.npz")
        np.savez(path, spec=np.asarray([256, 1, 3, 32], np.int64))
        with pytest.raises(SnapshotCorruptError, match="digest"):
            peek_spec(path)
        with pytest.raises(SnapshotCorruptError, match="digest"):
            load_snapshot(path, None, device="cpu")



@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """One live durable fleet: 40 ops, snapshot, 20 more ops, synced
    WAL — the uninterrupted reference every recovery variant must be
    bit-identical to. Returns (nr, dir, mid_states, end_states)."""
    d = str(tmp_path_factory.mktemp("durable-scenario"))
    nr = NodeReplicated(DISPATCH, device="cpu", **NR_KW)
    wal = WriteAheadLog(os.path.join(d, "wal"), policy="batch")
    nr.attach_wal(wal)
    tok = nr.register(0)
    for i in range(40):
        nr.execute_mut((HM_PUT, i % 64, 1000 + i), tok)
    nr.sync()
    save_durable_snapshot(nr, d)
    mid_states = states_np(nr)
    for i in range(40, 60):
        nr.execute_mut((HM_PUT, i % 64, 1000 + i), tok)
    nr.sync()
    wal.sync()
    return nr, d, mid_states, states_np(nr)


def _copy_scenario(d, tmp_path):
    dst = str(tmp_path / "copy")
    shutil.copytree(d, dst)
    return dst


class TestRecovery:
    def test_wal_ahead_of_snapshot_bit_identical(self, scenario,
                                                 tmp_path):
        nr, d, _, end_states = scenario
        d2 = _copy_scenario(d, tmp_path)
        nr2, report = recover_fleet(d2, DISPATCH, nr_kwargs=CPU)
        assert report.snapshot_pos == 40
        assert report.wal_ops == 20
        assert int(nr2.log.tail) == 60
        assert_states_equal(end_states, nr2.states)
        # journaling continues where the fsync-acked history ends
        assert nr2.wal.tail == 60
        tok = nr2.register(0)
        nr2.execute_mut((HM_PUT, 1, 9999), tok)
        assert nr2.execute((HM_GET, 1), tok) == 9999

    def test_snapshot_ahead_of_wal_bit_identical(self, scenario,
                                                 tmp_path):
        # lose the WAL's unsynced tail (torn final record): the
        # snapshot at 40 is now AHEAD of the WAL — recovery must land
        # on the snapshot state and re-journal the gap from the ring
        nr, d, mid_states, _ = scenario
        d2 = _copy_scenario(d, tmp_path)
        wal_dir = os.path.join(d2, "wal")
        seg = os.path.join(wal_dir, sorted(os.listdir(wal_dir))[-1])
        # tear the journal back BELOW the snapshot: keep 38 whole
        # single-op records plus 3 bytes of the 39th (a torn frame)
        rec = _REC_HEADER.size + _REC_PREFIX.size + 4 * 1 * (1 + 3)
        os.truncate(seg, _SEG_HEADER.size + 38 * rec + 3)
        nr2, report = recover_fleet(d2, DISPATCH, nr_kwargs=CPU)
        assert report.snapshot_pos == 40
        assert report.wal_ops == 0  # nothing past the snapshot
        assert report.wal_truncated_bytes > 0
        assert int(nr2.log.tail) == 40
        assert_states_equal(mid_states, nr2.states)
        # attach backfilled the journal's lost [38, 40) from the ring
        assert nr2.wal.tail == 40
        assert sum(r.count for r in nr2.wal.records(38)) == 2

    def test_corrupt_newest_snapshot_falls_back(self, scenario,
                                                tmp_path):
        nr, d, _, end_states = scenario
        d2 = _copy_scenario(d, tmp_path)
        save_durable_snapshot(nr, d2)  # newest snapshot at 60
        newest = list_snapshots(d2)[0][1]
        with open(newest, "r+b") as f:
            f.seek(os.path.getsize(newest) // 2)
            f.write(b"\xde\xad\xbe\xef")
        nr2, report = recover_fleet(d2, DISPATCH, nr_kwargs=CPU)
        assert report.skipped_snapshots and (
            report.skipped_snapshots[0][0] == newest
        )
        assert report.snapshot_pos == 40  # the older good base
        assert report.wal_ops == 20  # longer replay, same state
        assert_states_equal(end_states, nr2.states)

    def test_empty_and_missing_dir_boot_fresh(self, tmp_path):
        d = str(tmp_path / "never-existed")
        nr, report = recover_fleet(d, DISPATCH,
                                   nr_kwargs={**NR_KW, **CPU})
        assert report.snapshot is None
        assert report.wal_records == 0
        assert int(nr.log.tail) == 0
        assert nr.n_replicas == 2
        tok = nr.register(0)
        nr.execute_mut((HM_PUT, 2, 22), tok)
        assert nr.wal.tail == 1  # journaling from the first op
        # second boot replays the journal it just started
        nr.detach_wal().close()
        nr2, report2 = recover_fleet(d, DISPATCH,
                                     nr_kwargs={**NR_KW, **CPU})
        assert report2.wal_ops == 1
        tok2 = nr2.register(0)
        assert nr2.execute((HM_GET, 2), tok2) == 22

    def test_attach_wal_backfills_from_ring(self, scenario, tmp_path):
        nr, _, _, _ = scenario
        # a WAL attached mid-traffic persists the ring's history
        late = WriteAheadLog(str(tmp_path / "late"), policy="none")
        tail = int(nr.log.tail)
        orig = nr.detach_wal()
        try:
            nr.attach_wal(late)
            assert late.tail == tail
            recs = list(late.records())
            assert recs[0].pos == 0
            assert sum(r.count for r in recs) == tail
            # ring_slice refuses positions past the tail
            with pytest.raises(ValueError, match="past tail"):
                ring_slice(nr.spec, nr.log, 0, tail + 1)
        finally:
            got = nr.detach_wal()
            assert got is late
            late.close()
            nr.attach_wal(orig)


class TestDurableServe:
    def test_durable_ack_then_from_recovery(self, tmp_path):
        disp = make_seqreg(4)
        d = str(tmp_path / "serve")
        nr = NodeReplicated(disp, n_replicas=2, log_entries=1 << 10,
                            gc_slack=32, device="cpu")
        wal = WriteAheadLog(os.path.join(d, "wal"), policy="batch")
        nr.attach_wal(wal)
        cfg = ServeConfig(queue_depth=64, batch_max_ops=8,
                          batch_linger_s=0.001, durability="batch")
        done = 0
        with ServeFrontend(nr, cfg) as fe:
            for c in range(4):
                for i in range(1, 6):
                    assert fe.call((SR_SET, c, i), rid=c % 2, timeout=30.0) == i - 1
                    done += 1
                    # the durable-ack contract: every op whose future
                    # resolved has its WAL record fsynced
                    assert wal.durable_tail >= done
            assert wal.durable_tail == wal.tail == 20
        save_durable_snapshot(nr, d)
        nr.detach_wal().close()
        # crash + reopen THROUGH the serve layer
        fe2 = ServeFrontend.from_recovery(
            d, disp, ServeConfig(durability="batch"), nr_kwargs=CPU,
        )
        try:
            assert fe2.recovery_report.tail == 20
            for c in range(4):
                assert fe2.read((SR_GET, c), rid=0) == 5
            # serving continues mid-sequence with durable acks
            assert fe2.call((SR_SET, 0, 6), rid=0, timeout=30.0) == 5
            assert fe2.nr.wal.durable_tail == 21
        finally:
            fe2.close()

    def test_durability_config_validation(self, tmp_path):
        with pytest.raises(ValueError, match="unknown durability"):
            ServeConfig(durability="sometimes")
        nr = NodeReplicated(make_seqreg(2), n_replicas=1,
                            log_entries=1 << 10, gc_slack=32, device="cpu")
        with pytest.raises(ValueError, match="requires a WAL"):
            ServeFrontend(nr, ServeConfig(durability="batch"))
        # durability='always' needs append-time fsync on the WAL side
        with WriteAheadLog(str(tmp_path), policy="batch") as wal:
            nr.attach_wal(wal)
            with pytest.raises(ValueError, match="fsync policy"):
                ServeFrontend(nr, ServeConfig(durability="always"))


class TestSnapshotRoundtrip:
    def test_save_load_identical(self, tmp_path):
        nr = _filled_nr()
        path = str(tmp_path / "snap.npz")
        nr.checkpoint(path)
        spec, log, states = load_snapshot(path, nr.states)
        assert spec == nr.spec
        assert int(log.tail) == int(nr.log.tail)
        assert_states_equal(states, nr.states)

    def test_restore_continues(self, tmp_path):
        nr = _filled_nr()
        path = str(tmp_path / "snap.npz")
        nr.checkpoint(path)
        expect_ctail = int(nr.log.ctail)
        del nr
        nr2 = NodeReplicated.restore(path, make_hashmap(64), device="cpu")
        assert int(nr2.log.ctail) == expect_ctail
        tok = nr2.register(1)
        # writes continue from the snapshot position
        nr2.execute_mut((HM_PUT, 7, 4242), tok)
        assert nr2.execute((HM_GET, 7), tok) == 4242
        assert nr2.replicas_equal()


class TestRecoveryByReplay:
    def test_recover_matches_survivors(self):
        nr = _filled_nr()
        survivor = {k: v[0].numpy().copy() for k, v in nr.states.items()}
        nr.recover()  # discard states, rebuild from head
        rebuilt = {k: v[0].numpy() for k, v in nr.states.items()}
        np.testing.assert_array_equal(
            survivor["values"], rebuilt["values"]
        )
        np.testing.assert_array_equal(
            survivor["present"], rebuilt["present"]
        )
        assert nr.replicas_equal()

    def test_recover_from_base_snapshot_position(self):
        # Snapshot states mid-stream, append more, recover from that base.
        spec = LogSpec(capacity=1 << 10, n_replicas=2, gc_slack=32)
        d = make_hashmap(32)
        log = log_init(spec, "cpu")
        opc, args, n = encode_ops(
            [(HM_PUT, k, k + 1) for k in range(20)], 3, device="cpu"
        )
        log = log_append(spec, log, opc, args, n)
        log, states = recover_states(d, spec, log)  # replay all 20
        base = states
        base_pos = int(log.tail)
        opc2, args2, n2 = encode_ops(
            [(HM_PUT, k, 900 + k) for k in range(5)], 3, device="cpu"
        )
        log = log_append(spec, log, opc2, args2, n2)
        log, states = recover_states(
            d, spec, log, base_states=base, base_pos=base_pos
        )
        vals = states["values"][0].numpy()
        assert all(vals[k] == 900 + k for k in range(5))
        assert all(vals[k] == k + 1 for k in range(5, 20))

    def test_recover_refuses_after_wrap(self):
        spec = LogSpec(capacity=1 << 10, n_replicas=1, gc_slack=32)
        d = make_hashmap(32)
        log = log_init(spec, "cpu")
        states = replicate_state(d.init_state("cpu"), 1)
        opc, args, n = encode_ops([(HM_PUT, 1, 2)] * 64, 3, device="cpu")
        for _ in range(20):  # 1280 appends > 1024 capacity: ring wraps
            log = log_append(spec, log, opc, args, n)
            log, states, _ = log_exec_all(spec, d, log, states, 64)
        with pytest.raises(ValueError, match="overwritten"):
            recover_states(d, spec, log)

    def test_stats_counters(self):
        nr = _filled_nr(n_ops=10)
        s = nr.stats()
        assert s["appended"] == 10
        assert s["ctail"] == 10
        assert s["exec_rounds"] > 0
