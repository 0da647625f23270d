"""The port's replication plane (`node_replication_torch/repl/`) against
the reference's.

- Twins of `tests/test_repl.py`'s 23 tests (feed delivery rules, WAL
  ship pinning, hardened control-file publishes, the shipper, follower
  apply rules and bounded reads, promotion), on the CPU through
  `nr_kwargs=dict(device="cpu")`, with the reference's sizes.
- Twins of `tests/test_overload.py`'s two `add_backpressure_source`
  tests: the frontend hook `install_backpressure` rides on.
- Differential cases (integer data, tolerance 0): the same seeded
  records make byte-identical feed message files in both packages; a
  follower of either package tails a feed shipped by the other and ends
  with the same ring planes, int64 cursors, states, WAL records and
  applied position as the writer's own follower; a hashmap follower
  with `engine="pallas"` (K1's plain version here) matches the
  reference's record for record; and promotion over the same feed
  (a torn trailing message, a zombie record) gives equal reports and
  fleets in both packages.
"""

import os
import shutil
import time

import numpy as np
import pytest

from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.durable import WriteAheadLog as JWAL
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.models import make_seqreg as j_make_seqreg
from node_replication_tpu.repl import DirectoryFeed as JFeed
from node_replication_tpu.repl import Follower as JFollower
from node_replication_tpu.repl import PromotionManager as JPromotionManager
from node_replication_tpu.repl import ReplicationShipper as JShipper
from node_replication_tpu.repl.feed import FeedRecord as JFeedRecord

from node_replication_torch import interop
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.durable import WriteAheadLog
from node_replication_torch.fault import FaultPlan, FaultSpec
from node_replication_torch.models import (
    HM_GET,
    SR_GET,
    SR_SET,
    make_hashmap,
    make_seqreg,
)
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.repl import (
    DirectoryFeed,
    EpochFencedError,
    FeedCorruptError,
    FeedError,
    FeedGapError,
    Follower,
    PromotionManager,
    ReplicationShipper,
    ShipError,
)
from node_replication_torch.repl.feed import FeedRecord, _message_name
from node_replication_torch.serve import (
    OverloadConfig,
    ServeConfig,
    ServeFrontend,
)
from node_replication_torch.serve.errors import NotPrimary, StaleRead
from node_replication_torch.utils.tree import tree_leaves

DISPATCH = make_seqreg(4)
NR_KW = dict(n_replicas=1, log_entries=1 << 10, gc_slack=32, device="cpu")
J_NR_KW = {k: v for k, v in NR_KW.items() if k != "device"}


@pytest.fixture
def metrics_on():
    """Enable the port's registry (restored after) — `repl.*` counter
    assertions need it; instruments are one no-op branch otherwise."""
    r = get_registry()
    was = r.enabled
    r.enable()
    yield r
    r.enabled = was


def states_np(nr):
    return {k: v.numpy().copy() for k, v in nr.states.items()}


def assert_states_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def sets(pos, pairs):
    """(opcodes, args) arrays for a batch of SR_SET ops at `pos`."""
    ops = np.full(len(pairs), SR_SET, np.int32)
    args = np.zeros((len(pairs), 3), np.int32)
    for i, (c, v) in enumerate(pairs):
        args[i, 0] = c
        args[i, 1] = v
    return ops, args


# --------------------------------------------------------------- feed unit


class TestFeed:
    def test_publish_poll_roundtrip(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path))
        feed.publish(0, 0, *sets(0, [(0, 1), (1, 1)]))
        feed.publish(0, 2, *sets(2, [(2, 1)]))
        recs = feed.poll(0)
        assert [r.pos for r in recs] == [0, 2]
        assert recs[0].ops() == [(SR_SET, 0, 1, 0), (SR_SET, 1, 1, 0)]
        assert feed.tail_pos() == 3
        # a record straddling `start` is returned whole
        assert [r.pos for r in feed.poll(1)] == [0, 2]
        assert feed.poll(3) == []

    def test_torn_tail_mid_ship_resumes_cleanly(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path))
        feed.publish(0, 0, *sets(0, [(0, 1), (1, 1)]))
        feed.publish(0, 2, *sets(2, [(0, 2)]))
        torn = os.path.join(str(tmp_path), _message_name(2))
        os.truncate(torn, os.path.getsize(torn) - 3)
        # poll stops BEFORE the torn message, without error
        assert [r.pos for r in feed.poll(0)] == [0]
        assert feed.tail_pos() == 2
        # a resuming shipper re-publishes over the same name
        feed.publish(0, 2, *sets(2, [(0, 2)]))
        assert [r.pos for r in feed.poll(0)] == [0, 2]
        assert feed.tail_pos() == 3

    def test_duplicate_publish_is_idempotent(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path))
        for _ in range(3):
            feed.publish(0, 0, *sets(0, [(0, 1)]))
        recs = feed.poll(0)
        assert len(recs) == 1
        assert recs[0].ops() == [(SR_SET, 0, 1, 0)]

    def test_corrupt_complete_message_raises_typed(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path))
        feed.publish(0, 0, *sets(0, [(0, 1)]))
        feed.publish(0, 1, *sets(1, [(0, 2)]))
        path = os.path.join(str(tmp_path), _message_name(0))
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) - 1)
            b = f.read(1)
            f.seek(os.path.getsize(path) - 1)
            f.write(bytes([b[0] ^ 0x01]))
        with pytest.raises(FeedCorruptError, match="CRC") as ei:
            feed.poll(0)
        assert ei.value.pos == 0

    def test_epoch_fencing_at_the_transport(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path))
        assert feed.epoch() == 0
        feed.publish(0, 0, *sets(0, [(0, 1)]))
        assert feed.fence(3) == 3
        with pytest.raises(EpochFencedError) as ei:
            feed.publish(0, 1, *sets(1, [(0, 2)]))
        assert (ei.value.epoch, ei.value.current) == (0, 3)
        assert feed.tail_pos() == 1
        feed.publish(3, 1, *sets(1, [(0, 2)]))
        with pytest.raises(FeedError, match="must exceed"):
            feed.fence(3)
        assert DirectoryFeed(str(tmp_path)).epoch() == 3

    def test_gap_error_carries_positions(self):
        e = FeedGapError(3, 7)
        assert (e.expected, e.got) == (3, 7)
        assert "[3, 7)" in str(e)

    def test_poll_relists_a_hole_a_racing_listing_left(self, tmp_path,
                                                      monkeypatch):
        # a listing taken while the shipper creates message files can
        # leave out a file created during it and still hold a later
        # one: a hole at the cursor is re-listed, a hole after it ends
        # the poll, and neither is ever reported as a gap
        import node_replication_torch.repl.feed as feed_mod

        feed = DirectoryFeed(str(tmp_path))
        for pos in range(6):
            feed.publish(0, pos, *sets(pos, [(0, pos + 1)]))
        real = os.listdir
        drop = []

        def racing(d):
            names = real(d)
            if drop:
                names.remove(_message_name(drop.pop()))
            return names

        monkeypatch.setattr(feed_mod.os, "listdir", racing)
        drop.append(2)
        assert [r.pos for r in feed.poll(2)] == [2, 3, 4, 5]
        drop.append(4)
        assert [r.pos for r in feed.poll(0)] == [0, 1, 2, 3]
        drop.append(4)
        assert [r.pos for r in feed.poll(4)] == [4, 5]
        # a hole both listings show is real: the follower's gap
        os.remove(os.path.join(str(tmp_path), _message_name(3)))
        assert [r.pos for r in feed.poll(3)] == [4, 5]

    def test_poll_never_reports_a_false_gap_under_publishes(self,
                                                            tmp_path):
        # another process publishes while this one tails: every record
        # chains onto the cursor (without the re-listing, some polls
        # here report holes that are not there)
        import subprocess
        import sys

        d = str(tmp_path / "feed")
        DirectoryFeed(d)
        code = (
            "import sys, time, numpy as np\n"
            "from node_replication_torch.repl import DirectoryFeed\n"
            "f = DirectoryFeed(sys.argv[1])\n"
            "o, a = np.ones(1, np.int32), np.ones((1, 3), np.int32)\n"
            "t = time.monotonic() + 1.5\n"
            "pos = 0\n"
            "while time.monotonic() < t:\n"
            "    f.publish(0, pos, o, a)\n"
            "    pos += 1\n"
        )
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.Popen([sys.executable, "-c", code, d], cwd=root)
        feed = DirectoryFeed(d)
        cursor, polls = 0, 0
        try:
            while proc.poll() is None or polls == 0:
                polls += 1
                for rec in feed.poll(cursor):
                    if rec.pos + rec.count <= cursor:
                        continue
                    assert rec.pos <= cursor, (cursor, rec.pos)
                    cursor = rec.pos + rec.count
        finally:
            proc.kill()
            proc.wait()
        assert cursor > 100 and polls > 10

    def test_prune(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path))
        feed.publish(0, 0, *sets(0, [(0, 1), (1, 1)]))
        feed.publish(0, 2, *sets(2, [(0, 2)]))
        feed.publish(0, 3, *sets(3, [(0, 3)]))
        assert feed.prune(3) == 2
        assert [r.pos for r in feed.poll(0)] == [3]


# --------------------------------------------------------- WAL pinning


class TestWalShipPinning:
    def _walled(self, tmp_path, n=6):
        w = WriteAheadLog(str(tmp_path), policy="none",
                          segment_max_bytes=64)  # rotate ~every record
        for i in range(n):
            w.append(i, [(SR_SET, 0, i)])
        w.reclaim_floor = n
        return w

    def test_pin_holds_reclaim_floor(self, tmp_path):
        w = self._walled(tmp_path)
        w.set_pin("ship", 2)
        w.maybe_reclaim(6)
        assert w.base <= 2
        assert [r.pos for r in w.records(2)] == [2, 3, 4, 5]
        assert w.stats()["pins"] == {"ship": 2}
        w.clear_pin("ship")
        w.maybe_reclaim(6)
        assert w.base > 2
        w.close()

    def test_reclaim_reclamps_under_lock(self, tmp_path):
        w = self._walled(tmp_path)
        w.set_pin("ship", 0)
        assert w.reclaim(6) == 0
        assert w.base == 0
        w.close()

    def test_shipper_pin_tracks_cursor(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "wal"), policy="always",
                            segment_max_bytes=64)
        for i in range(6):
            wal.append(i, [(SR_SET, 0, i)])
        wal.reclaim_floor = 6
        feed = DirectoryFeed(str(tmp_path / "feed"))
        s = ReplicationShipper(wal, feed, auto_start=False)
        assert wal.pins() == {s.pin_name: 0}
        assert s.pin_name.startswith("ship:")
        assert wal.maybe_reclaim(6) == 0
        s.start()
        s.barrier(6, timeout=10.0)
        assert wal.pins()[s.pin_name] == 6
        assert wal.maybe_reclaim(6) >= 1
        assert feed.tail_pos() == 6
        s.stop()
        assert wal.pins() == {}
        wal.close()

    def test_shipper_refuses_reclaimed_gap(self, tmp_path):
        wal = self._walled(tmp_path / "wal")
        wal.maybe_reclaim(6)
        assert wal.base > 0
        feed = DirectoryFeed(str(tmp_path / "feed"))
        with pytest.raises(ShipError, match="re-seed"):
            ReplicationShipper(wal, feed, auto_start=False)
        wal.close()

    def test_pin_namespaces_do_not_collide(self, tmp_path):
        wal = self._walled(tmp_path / "wal")
        a = ReplicationShipper(wal, DirectoryFeed(str(tmp_path / "fa")),
                               auto_start=False)
        b = ReplicationShipper(wal, DirectoryFeed(str(tmp_path / "fb")),
                               auto_start=False)
        assert a.pin_name != b.pin_name
        wal.set_pin("snapshot-server:0", 2)
        assert set(wal.pins()) == {a.pin_name, b.pin_name,
                                   "snapshot-server:0"}
        a.stop()
        assert set(wal.pins()) == {b.pin_name, "snapshot-server:0"}
        assert wal.maybe_reclaim(6) == 0
        assert wal.base == 0
        b.stop()
        assert wal.reclaim(6) >= 1
        assert wal.base <= 2
        assert [r.pos for r in wal.records(2)][:1] == [2]
        wal.close()


# ------------------------------------ hardened control-file publishes


class TestHardenedPublish:
    def test_fence_failure_leaves_epoch_intact(self, tmp_path,
                                               monkeypatch):
        feed = DirectoryFeed(str(tmp_path))
        feed.fence(5)
        assert feed.epoch() == 5

        def boom(src, dst):
            raise OSError("simulated crash at publish")

        monkeypatch.setattr(os, "replace", boom)
        with pytest.raises(OSError):
            feed.fence(9)
        monkeypatch.undo()
        assert feed.epoch() == 5
        assert not [n for n in os.listdir(tmp_path)
                    if n.endswith(".tmp")]

    def test_heartbeat_is_atomic_never_torn(self, tmp_path,
                                            monkeypatch):
        feed = DirectoryFeed(str(tmp_path))
        feed.write_heartbeat("1 100 6400")
        replaced = []
        orig = os.replace

        def spy(src, dst):
            with open(src) as f:
                replaced.append(f.read())
            return orig(src, dst)

        monkeypatch.setattr(os, "replace", spy)
        feed.write_heartbeat("1 101 6464")
        assert replaced == ["1 101 6464"]
        assert feed.read_heartbeat() == "1 101 6464"

        def boom(src, dst):
            raise OSError("simulated crash at publish")

        monkeypatch.setattr(os, "replace", boom)
        with pytest.raises(OSError):
            feed.write_heartbeat("2 1 9999")
        monkeypatch.undo()
        assert feed.read_heartbeat() == "1 101 6464"
        assert not [n for n in os.listdir(tmp_path)
                    if n.endswith(".tmp")]


# ---------------------------------------------------------------- shipper


class _FakeHealth:
    def __init__(self):
        self.reported = []

    def report_worker_exception(self, rid, exc=None):
        self.reported.append((rid, exc))


class TestShipper:
    def test_ships_only_durable_records(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "wal"), policy="batch")
        feed = DirectoryFeed(str(tmp_path / "feed"))
        s = ReplicationShipper(wal, feed, poll_s=0.001)
        try:
            wal.append(0, [(SR_SET, 0, 1), (SR_SET, 1, 1)])
            with pytest.raises(ShipError, match="timed out"):
                s.barrier(2, timeout=0.1)
            assert feed.tail_pos() == 0
            wal.sync()
            s.barrier(2, timeout=10.0)
            assert feed.tail_pos() == 2
            assert feed.poll(0)[0].ops()[0] == (SR_SET, 0, 1, 0)
            assert s.lag() == 0
            assert s.stats()["published"] == 2
        finally:
            s.stop()
            wal.close()

    def test_ship_failure_surfaces(self, tmp_path, metrics_on):
        wal = WriteAheadLog(str(tmp_path / "wal"), policy="batch")
        health = _FakeHealth()
        errors0 = get_registry().counter("repl.ship_errors").value
        s = ReplicationShipper(
            wal, feed=DirectoryFeed(str(tmp_path / "feed")),
            poll_s=0.001, health=health, health_rid=0,
            auto_start=False,
        )
        with FaultPlan([FaultSpec(site="ship",
                                  action="raise")]).armed():
            s.start()
            with pytest.raises(ShipError) as ei:
                s.barrier(1, timeout=10.0)
        assert s.error is not None
        assert ei.value.__cause__ is s.error
        s._thread.join(5.0)
        assert health.reported and health.reported[0][0] == 0
        assert get_registry().counter("repl.ship_errors").value \
            == errors0 + 1
        s.stop()
        wal.close()

    def test_heartbeat_beacon_changes(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "wal"), policy="batch")
        feed = DirectoryFeed(str(tmp_path / "feed"))
        s = ReplicationShipper(wal, feed, poll_s=0.001,
                               heartbeat_interval_s=0.0)
        try:
            deadline = 400
            while feed.read_heartbeat() is None and deadline:
                deadline -= 1
                time.sleep(0.005)
            first = feed.read_heartbeat()
            assert first is not None
            deadline = 400
            while feed.read_heartbeat() == first and deadline:
                deadline -= 1
                time.sleep(0.005)
            assert feed.read_heartbeat() != first
        finally:
            s.stop()
            wal.close()


# ----------------------------------------------------- follower (fleets)


def _primary(tmp_path):
    nr = NodeReplicated(DISPATCH, **NR_KW)
    wal = WriteAheadLog(str(tmp_path / "primary-wal"), policy="batch")
    nr.attach_wal(wal)
    feed = DirectoryFeed(str(tmp_path / "feed"),
                         arg_width=nr.spec.arg_width)
    shipper = ReplicationShipper(wal, feed, poll_s=0.001,
                                 heartbeat_interval_s=0.01)
    return nr, wal, feed, shipper


class TestFollower:
    def test_bit_identity_bounded_reads_and_not_primary(self, tmp_path):
        nr, wal, feed, shipper = _primary(tmp_path)
        tok = nr.register(0)
        for i in range(1, 11):
            for c in range(4):
                nr.execute_mut((SR_SET, c, i), tok)
        nr.wal_sync()
        shipper.barrier(40, timeout=10.0)
        f = Follower(DISPATCH, feed, str(tmp_path / "f1"),
                     nr_kwargs=NR_KW)
        try:
            assert f.wait_applied(40, timeout=10.0)
            assert_states_equal(states_np(nr), f.nr.states)
            assert f.nr.wal.tail == 40
            v, applied, bound = f.read_result((SR_GET, 2),
                                              max_lag_pos=0,
                                              wait_s=2.0)
            assert v == 10
            assert applied >= bound == 40
            with pytest.raises(NotPrimary):
                f.frontend.submit((SR_SET, 0, 99))
            with pytest.raises(StaleRead) as ei:
                f.read((SR_GET, 0), min_pos=10_000, wait_s=0.01)
            assert ei.value.min_pos == 10_000
            assert ei.value.applied_pos >= 40
        finally:
            f.close()
            shipper.stop()
            nr.detach_wal().close()

    def test_duplicate_overlap_and_gap(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path / "feed"))
        feed.publish(0, 0, *sets(0, [(0, 1), (1, 1)]))
        f = Follower(DISPATCH, feed, str(tmp_path / "f"),
                     nr_kwargs=NR_KW)
        try:
            assert f.wait_applied(2, timeout=10.0)
            feed.publish(0, 0, *sets(0, [(0, 1), (1, 1)]))
            time.sleep(0.05)
            assert f.applied_pos() == 2
            assert f.error is None
            feed.publish(0, 1, *sets(1, [(1, 1), (2, 1), (3, 1)]))
            assert f.wait_applied(4, timeout=10.0)
            tok = f.nr.register(0)
            assert f.nr.execute((SR_GET, 2), tok) == 1
            assert f.nr.execute((SR_GET, 1), tok) == 1  # not doubled
            feed.publish(0, 50, *sets(50, [(0, 9)]))
            deadline = 400
            while f.error is None and deadline:
                deadline -= 1
                time.sleep(0.005)
            assert isinstance(f.error, FeedGapError)
            assert (f.error.expected, f.error.got) == (4, 50)
            assert f.applied_pos() == 4
        finally:
            f.close()

    def test_follower_boots_behind_a_fenced_feed(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path / "feed"))
        feed.publish(0, 0, *sets(0, [(0, 1)]))
        feed.fence(2)
        feed.publish(2, 1, *sets(1, [(0, 2)]))
        f = Follower(DISPATCH, feed, str(tmp_path / "f"),
                     nr_kwargs=NR_KW)
        try:
            assert f.wait_applied(2, timeout=10.0)
            assert f.error is None
            assert f.epoch == 2
            tok = f.nr.register(0)
            assert f.nr.execute((SR_GET, 0), tok) == 2
        finally:
            f.close()

    def test_apply_record_rules_dup_fence_gap(self, tmp_path,
                                              metrics_on):
        feed = DirectoryFeed(str(tmp_path / "feed"))
        f = Follower(DISPATCH, feed, str(tmp_path / "f"),
                     nr_kwargs=NR_KW, auto_start=False)

        def rec(epoch, pos, pairs):
            ops, args = sets(pos, pairs)
            return FeedRecord(epoch, pos, ops, args)

        try:
            assert f._apply_record(rec(5, 0, [(0, 1), (1, 1)]))
            assert f.applied_pos() == 2
            assert f.epoch == 5
            dups0 = get_registry().counter(
                "repl.duplicate_records").value
            assert not f._apply_record(rec(5, 0, [(0, 1), (1, 1)]))
            assert f.applied_pos() == 2
            assert get_registry().counter(
                "repl.duplicate_records").value == dups0 + 1
            fenced0 = get_registry().counter(
                "repl.fenced_records").value
            assert not f._apply_record(rec(3, 2, [(0, 99)]))
            assert f.applied_pos() == 2
            assert get_registry().counter(
                "repl.fenced_records").value == fenced0 + 1
            tok = f.nr.register(0)
            assert f.nr.execute((SR_GET, 0), tok) == 1  # not 99
            assert f._apply_record(rec(5, 2, [(2, 1)]))
            with pytest.raises(FeedGapError) as ei:
                f._apply_record(rec(5, 50, [(0, 9)]))
            assert (ei.value.expected, ei.value.got) == (3, 50)
        finally:
            f.close()

    def test_promotion_fences_drains_and_serves_writes(self, tmp_path):
        nr, wal, feed, shipper = _primary(tmp_path)
        tok = nr.register(0)
        for i in range(1, 6):
            for c in range(4):
                nr.execute_mut((SR_SET, c, i), tok)
        nr.wal_sync()
        shipper.barrier(20, timeout=10.0)
        f = Follower(DISPATCH, feed, str(tmp_path / "f1"),
                     nr_kwargs=NR_KW, name="f1")
        lagger = Follower(DISPATCH, feed, str(tmp_path / "f2"),
                          nr_kwargs=NR_KW, name="f2",
                          auto_start=False)
        try:
            assert f.wait_applied(20, timeout=10.0)
            nr.execute_mut((SR_SET, 0, 6), tok)
            nr.wal_sync()
            shipper.barrier(21, timeout=10.0)
            shipper.stop(clear_pin=False)
            mgr = PromotionManager(feed, [f, lagger],
                                   heartbeat_timeout_s=0.2,
                                   check_interval_s=0.02)
            assert mgr.elect() is f
            report = mgr.promote_now(detect_s=0.1)
            assert report.follower == "f1"
            assert report.applied_pos == 21
            assert report.rto_s == pytest.approx(
                0.1 + report.promote_s)
            assert f.promoted and not f.frontend.read_only
            assert feed.epoch() == report.new_epoch
            with pytest.raises(EpochFencedError):
                feed.publish(report.new_epoch - 1, 21,
                             *sets(21, [(0, 99)]))
            assert f.frontend.call((SR_SET, 0, 7), rid=0) == 6
            assert f.frontend.read((SR_GET, 1), rid=0) == 5
            assert f.nr.wal.durable_tail == 22
        finally:
            lagger.close()
            f.close()
            nr.detach_wal().close()


# -------------------------------------------------------------- promotion


class TestPromotionWatch:
    def test_heartbeat_detection_quarantines_then_promotes(
        self, tmp_path,
    ):
        feed = DirectoryFeed(str(tmp_path / "feed"))
        feed.publish(0, 0, *sets(0, [(0, 1)]))
        f = Follower(DISPATCH, feed, str(tmp_path / "f"),
                     nr_kwargs=NR_KW, name="f")
        try:
            assert f.wait_applied(1, timeout=10.0)
            mgr = PromotionManager(feed, [f],
                                   heartbeat_timeout_s=0.1,
                                   check_interval_s=0.01)
            time.sleep(0.3)
            assert mgr.run(timeout=0.3) is None
            feed.write_heartbeat("0 1 1")
            assert mgr.run(timeout=0.05) is None
            report = mgr.run(timeout=10.0)
            assert report is not None
            assert report.follower == "f"
            assert report.detect_s >= 0.1
            assert report.rto_s == pytest.approx(
                report.detect_s + report.promote_s)
            assert mgr.report is report and mgr.wait(0.1) is report
            assert f.promoted
        finally:
            f.close()


# ----------------------------------- the frontend's backpressure hook


def test_add_backpressure_source_requires_governor():
    nr = NodeReplicated(make_seqreg(8), n_replicas=1, log_entries=512,
                        gc_slack=64, device="cpu")
    with ServeFrontend(nr, ServeConfig()) as fe:
        with pytest.raises(ValueError):
            fe.add_backpressure_source("x", lambda: 0, 1, 2)


def test_high_lag_clamps_admission():
    nr = NodeReplicated(make_seqreg(8), n_replicas=1, log_entries=512,
                        gc_slack=64, device="cpu")
    cfg = ServeConfig(
        queue_depth=64, batch_linger_s=0.0,
        overload=OverloadConfig(target_delay_s=10.0, min_limit=4),
    )
    with ServeFrontend(nr, cfg) as fe:
        lag = [10_000]
        fe.add_backpressure_source("ship", lambda: lag[0],
                                   low=100, high=1000)
        for _ in range(10):
            fe.governor.on_round(0, 0.0, 8)
        assert fe.governor.limit(0) == 4
        lag[0] = 0
        for _ in range(20):
            fe.governor.on_round(0, 0.0, 8)
        assert fe.governor.limit(0) == 64


def test_obs_port_knobs_raise(tmp_path):
    # the scrape endpoint needs obs/export.py, not ported yet: asking
    # for it fails loudly instead of starting nothing
    from node_replication_torch.repl import RelayNode

    feed = DirectoryFeed(str(tmp_path / "feed"))
    with pytest.raises(NotImplementedError, match="obs/export.py"):
        Follower(DISPATCH, feed, str(tmp_path / "f"), nr_kwargs=NR_KW,
                 obs_port=0)
    with pytest.raises(NotImplementedError, match="obs/export.py"):
        RelayNode(feed, str(tmp_path / "relay"), obs_port=0)


def test_follower_rids_bound_its_frontend(tmp_path):
    # the port's one extra knob: the read-only frontend serves only the
    # named replicas (one worker thread each), the fleet still applies
    # every record on all of them
    feed = DirectoryFeed(str(tmp_path / "feed"))
    feed.publish(0, 0, *sets(0, [(0, 1), (1, 2)]))
    kw = dict(NR_KW, n_replicas=4)
    f = Follower(DISPATCH, feed, str(tmp_path / "f"), nr_kwargs=kw,
                 rids=[1, 3])
    try:
        assert f.wait_applied(2, timeout=10.0)
        assert f.frontend.rids == [1, 3]
        assert f.read((SR_GET, 1), rid=3, max_lag_pos=0) == 2
        with pytest.raises(ValueError):
            f.read((SR_GET, 1), rid=0)
        assert f.nr.replicas_equal()
    finally:
        f.close()


def test_ack_barrier_without_a_wal_raises(tmp_path):
    # an installed barrier with no journal to gate on must fail the
    # batch, never ack a replication that never happened
    nr = NodeReplicated(DISPATCH, **NR_KW)
    calls = []
    with ServeFrontend(nr, ServeConfig()) as fe:
        fe.ack_barrier = calls.append
        with pytest.raises(RuntimeError, match="no WAL"):
            fe.call((SR_SET, 0, 1), timeout=10.0)
    assert calls == []


# =========================================== against the reference


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fh:
            out[name] = fh.read()
    return out


def _seeded_records(seed, n, aw=3):
    rng = np.random.default_rng(seed)
    pos, out = 0, []
    for _ in range(n):
        count = int(rng.integers(1, 9))
        opc = rng.integers(-2, 5, count).astype(np.int32)
        args = rng.integers(-(1 << 31), 1 << 31, (count, aw),
                            dtype=np.int64).astype(np.int32)
        out.append((int(rng.integers(0, 3)), pos, opc, args))
        pos += count
    return out


def test_feed_message_files_byte_identical(tmp_path):
    """The same seeded records, fence and beacon through both packages'
    `DirectoryFeed`: every file equal byte for byte, and each package
    reads the other's records back exactly."""
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    jf, tf = JFeed(jd, arg_width=3), DirectoryFeed(td, arg_width=3)
    for epoch, pos, opc, args in _seeded_records(12, 40):
        jf.publish(epoch, pos, opc, args)
        tf.publish(epoch, pos, opc, args)
    for f in (jf, tf):
        f.fence(7)
        f.write_heartbeat("7 12 345")
    a, b = _files(jd), _files(td)
    assert sorted(a) == sorted(b) and len(b) == 42
    for name in a:
        assert a[name] == b[name], name
    for reader, d in ((DirectoryFeed, jd), (JFeed, td)):
        got = reader(d, arg_width=3).poll(0)
        want = (JFeed if reader is DirectoryFeed else DirectoryFeed)(
            d, arg_width=3).poll(0)
        assert [(r.epoch, r.pos, r.count) for r in got] == \
            [(r.epoch, r.pos, r.count) for r in want]
        for g, w in zip(got, want):
            assert np.array_equal(g.opcodes, w.opcodes)
            assert np.array_equal(g.args, w.args)


def _same_fleet(jn, tn):
    got = interop.log_to_numpy(tn.log)
    for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
        want = np.asarray(getattr(jn.log, f))
        assert want.dtype == got[f].dtype and want.shape == got[f].shape
        assert np.array_equal(want, got[f]), f
    for f, leaf in tn.states.items():
        assert np.array_equal(np.asarray(jn.states[f]), leaf.numpy()), f


def _same_wal_records(jw, tw):
    a, b = list(jw.records(0)), list(tw.records(0))
    assert [(r.pos, r.count) for r in a] == [(r.pos, r.count) for r in b]
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x.opcodes), np.asarray(y.opcodes))
        assert np.array_equal(np.asarray(x.args), np.asarray(y.args))


def _seqreg_batches(seed, n):
    rng = np.random.default_rng(seed)
    return [[(SR_SET, int(rng.integers(0, 4)), int(rng.integers(1 << 30)))
             for _ in range(int(rng.integers(1, 7)))] for _ in range(n)]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_followers_tail_the_other_packages_shipper(writer, tmp_path):
    """A primary of one package ships its WAL; a follower of each
    package tails the same feed directory. Both end with equal ring
    planes, int64 cursors, states, WAL records and applied position,
    equal to the primary's."""
    if writer == "ref":
        nr = JNR(j_make_seqreg(4), **J_NR_KW)
        wal = JWAL(str(tmp_path / "pwal"), policy="batch")
        feed = JFeed(str(tmp_path / "feed"), arg_width=3)
        Ship = JShipper
    else:
        nr = NodeReplicated(DISPATCH, **NR_KW)
        wal = WriteAheadLog(str(tmp_path / "pwal"), policy="batch")
        feed = DirectoryFeed(str(tmp_path / "feed"), arg_width=3)
        Ship = ReplicationShipper
    nr.attach_wal(wal)
    shipper = Ship(wal, feed, poll_s=0.001, heartbeat_interval_s=0.01)
    tail = 0
    for b, ops in enumerate(_seqreg_batches(21, 30)):
        nr.execute_mut_batch(ops, rid=0)
        tail += len(ops)
    nr.wal_sync()
    shipper.barrier(tail, timeout=10.0)
    tf = Follower(DISPATCH, DirectoryFeed(str(tmp_path / "feed")),
                  str(tmp_path / "tf"), nr_kwargs=NR_KW, name="port")
    jf = JFollower(j_make_seqreg(4), JFeed(str(tmp_path / "feed")),
                   str(tmp_path / "jf"), nr_kwargs=J_NR_KW, name="ref")
    try:
        assert tf.wait_applied(tail, timeout=20.0)
        assert jf.wait_applied(tail, timeout=20.0)
        assert tf.applied_pos() == jf.applied_pos() == tail
        assert tf.error is None and jf.error is None
        _same_fleet(jf.nr, tf.nr)
        _same_wal_records(jf.nr.wal, tf.nr.wal)
        _same_wal_records(wal, tf.nr.wal)
        nr.sync()
        for f, leaf in tf.nr.states.items():
            live = nr.states[f]
            live = np.asarray(live) if writer == "ref" else live.numpy()
            assert np.array_equal(live, leaf.numpy()), f
    finally:
        tf.close()
        jf.close()
        shipper.stop()
        nr.detach_wal().close()


def test_hashmap_follower_matches_reference_record_for_record(tmp_path):
    """A port primary (`make_hashmap(64)`, R = 4, `engine="pallas"`)
    serves seeded batches with durable, shipped acks; a port follower
    with `engine="pallas"` (each applied record one fused round: K1's
    plain version on the CPU) and a reference follower apply the feed
    one record at a time and are equal after every record."""
    reg = get_registry()
    was = reg.enabled
    reg.enable()
    kw = dict(n_replicas=4, log_entries=256, gc_slack=32, engine="pallas")
    d = str(tmp_path / "primary")
    fe = ServeFrontend.from_recovery(
        d, make_hashmap(64), ServeConfig(durability="batch",
                                         batch_max_ops=8,
                                         batch_linger_s=0.0),
        nr_kwargs=dict(kw, device="cpu"))
    feed = DirectoryFeed(str(tmp_path / "feed"), arg_width=3)
    shipper = ReplicationShipper(fe.nr.wal, feed, poll_s=0.001)
    fe.ack_barrier = shipper.barrier
    tf = jf = None
    try:
        rng = np.random.default_rng(5)
        futs = []
        for i in range(120):
            k = int(rng.integers(-64, 128))
            op = ((1, k, int(rng.integers(1, 1 << 30)))
                  if rng.integers(0, 2) else (2, k))
            futs.append(fe.submit(op, rid=int(rng.integers(0, 4))))
            if i % 7 == 6:
                for f in futs:
                    f.result(10.0)
                futs = []
        for f in futs:
            f.result(10.0)
        tail = int(fe.nr.log.tail)
        assert feed.tail_pos() == tail == 120
        tf = Follower(make_hashmap(64), feed, str(tmp_path / "tf"),
                      nr_kwargs=dict(kw, device="cpu"), auto_start=False)
        jf = JFollower(j_make_hashmap(64), JFeed(feed.dir),
                       str(tmp_path / "jf"), nr_kwargs=kw,
                       auto_start=False)
        assert tf.nr._fused is not None
        fused0 = reg.counter("nr.exec.engine.pallas_fused").value
        records = feed.poll(0)
        assert len(records) > 10
        for rec in records:
            assert tf._apply_record(rec)
            assert jf._apply_record(JFeedRecord(rec.epoch, rec.pos,
                                                rec.opcodes, rec.args))
            assert tf.applied_pos() == jf.applied_pos()
            _same_fleet(jf.nr, tf.nr)
        assert reg.counter("nr.exec.engine.pallas_fused").value \
            - fused0 == len(records)
        _same_wal_records(jf.nr.wal, tf.nr.wal)
        _same_wal_records(fe.nr.wal, tf.nr.wal)
        for k in range(64):
            assert tf.read((HM_GET, k), rid=k % 4) == \
                fe.read((HM_GET, k), rid=0)
    finally:
        for f in (tf, jf):
            if f is not None:
                f.close()
        shipper.stop()
        fe.close()
        fe.nr.detach_wal().close()
        reg.enabled = was


def test_promotion_agrees_across_packages(tmp_path):
    """One feed directory, copied for each package: 12 records, the
    last torn mid-frame (the primary died mid-publish). A follower of
    each package applies the first 8, then is promoted: the drain stops
    at the torn message, the feed is fenced to epoch 1, a zombie
    record of epoch 0 is rejected by the feed and by the follower, and
    the promoted frontend serves a durable write. Reports, feed files
    and fleets are equal."""
    src = str(tmp_path / "src")
    base = DirectoryFeed(src, arg_width=3)
    pos = 0
    for b, ops in enumerate(_seqreg_batches(33, 12)):
        o = np.array([op[0] for op in ops], np.int32)
        a = np.array([[op[1], op[2], 0] for op in ops], np.int32)
        base.publish(0, pos, o, a)
        last, pos = pos, pos + len(ops)
    torn = os.path.join(src, _message_name(last))
    os.truncate(torn, os.path.getsize(torn) - 5)
    base.write_heartbeat("0 9 0")
    out = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / f"feed-{pkg}")
        shutil.copytree(src, d)
        if pkg == "ref":
            feed = JFeed(d, arg_width=3)
            f = JFollower(j_make_seqreg(4), feed, str(tmp_path / "jf"),
                          nr_kwargs=J_NR_KW, auto_start=False, name="f")
            Mgr, Rec = JPromotionManager, JFeedRecord
        else:
            feed = DirectoryFeed(d, arg_width=3)
            f = Follower(DISPATCH, feed, str(tmp_path / "tf"),
                         nr_kwargs=NR_KW, auto_start=False, name="f")
            Mgr, Rec = PromotionManager, FeedRecord
        try:
            for rec in feed.poll(0)[:8]:
                assert f._apply_record(rec)
            report = Mgr(feed, [f]).promote_now(detect_s=0.25)
            zombie = sets(report.applied_pos, [(0, 99)])
            with pytest.raises(Exception) as ei:
                feed.publish(0, report.applied_pos, *zombie)
            assert type(ei.value).__name__ == "EpochFencedError"
            assert not f._apply_record(Rec(0, report.applied_pos,
                                           *zombie))
            resp = f.frontend.call((SR_SET, 1, 4242), rid=0)
            out[pkg] = dict(
                report=(report.follower, report.new_epoch,
                        report.applied_pos, report.drained_records,
                        report.detect_s),
                files=_files(d), resp=resp,
                durable=int(f.nr.wal.durable_tail),
                read=f.frontend.read((SR_GET, 1), rid=0), f=f)
        except BaseException:
            f.close()
            raise
    try:
        ref, port = out["ref"], out["port"]
        assert ref["report"] == port["report"]
        assert port["report"][1:4] == (1, last, 3)
        assert ref["files"] == port["files"]
        assert (ref["resp"], ref["durable"], ref["read"]) == \
            (port["resp"], port["durable"], port["read"])
        assert port["read"] == 4242 and port["durable"] == last + 1
        _same_fleet(ref["f"].nr, port["f"].nr)
        _same_wal_records(ref["f"].nr.wal, port["f"].nr.wal)
    finally:
        for v in out.values():
            v["f"].close()
