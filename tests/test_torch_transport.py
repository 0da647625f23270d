"""The port's socket transport and relays (`node_replication_torch/repl/
transport.py`, `relay.py`) against the reference's.

- Twins of `tests/test_transport.py`'s 21 tests (CRC frames, the socket
  feed's delivery rules, fences over the wire, the tree barrier,
  followers over sockets, the 1-2-4 relay tree, snapshot bootstrap, the
  in-memory pipe twin, relay rules), on the CPU through
  `nr_kwargs=dict(device="cpu")`, with the reference's sizes.
- Differential cases (integer data, tolerance 0): `encode_record` and
  `send_frame` give the reference's bytes for the same seeded records;
  a server of each package answers the same POLL, STAT, FENCE and
  snapshot requests with the same frames; and a client of each package
  reads a server of the other, a cold follower bootstrapping from the
  other package's snapshot included.

The reference's wire has no separate greeting message: a client's
first frame is a POLL, STAT, FENCE or snapshot request, and the fence
carries the epoch and the fencer's token.
"""

import os
import socket
import struct
import threading
import zlib

import numpy as np
import pytest

from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.durable import WriteAheadLog as JWAL
from node_replication_tpu.durable.recovery import (
    save_durable_snapshot as j_save_durable_snapshot,
)
from node_replication_tpu.models import make_seqreg as j_make_seqreg
from node_replication_tpu.repl import DirectoryFeed as JFeed
from node_replication_tpu.repl import FeedServer as JFeedServer
from node_replication_tpu.repl import Follower as JFollower
from node_replication_tpu.repl import ReplicationShipper as JShipper
from node_replication_tpu.repl import SocketFeed as JSocketFeed
from node_replication_tpu.repl import transport as jtp

from node_replication_torch import interop
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.durable import WriteAheadLog
from node_replication_torch.durable.recovery import save_durable_snapshot
from node_replication_torch.models import SR_GET, SR_SET, make_seqreg
from node_replication_torch.repl import (
    DirectoryFeed,
    EpochFencedError,
    FeedError,
    FeedServer,
    Follower,
    PipeTransport,
    ReplicationShipper,
    SocketFeed,
    TransportError,
    make_tree_barrier,
)
from node_replication_torch.repl import transport as ttp
from node_replication_torch.repl.relay import RelayNode
from node_replication_torch.repl.transport import (
    FeedRecord,
    decode_record,
    encode_record,
    recv_frame,
    send_frame,
)
from node_replication_torch.utils.tree import tree_leaves

DISPATCH = make_seqreg(4)
NR_KW = dict(n_replicas=1, log_entries=1 << 10, gc_slack=32, device="cpu")
J_NR_KW = {k: v for k, v in NR_KW.items() if k != "device"}
AW = DISPATCH.arg_width


def sets(pos, pairs):
    """(opcodes, args) arrays for a batch of SR_SET ops."""
    opcodes = np.full(len(pairs), SR_SET, np.int32)
    args = np.zeros((len(pairs), AW), np.int32)
    for i, (c, v) in enumerate(pairs):
        args[i, 0] = c
        args[i, 1] = v
    return opcodes, args


def states_np(nr):
    return {k: v.numpy().copy() for k, v in nr.states.items()}


def assert_states_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def _primary(tmp_path, n_ops=10):
    """NR + WAL + feed + shipper with `4 * n_ops` shipped SR_SETs."""
    nr = NodeReplicated(DISPATCH, **NR_KW)
    wal = WriteAheadLog(str(tmp_path / "primary-wal"), policy="batch")
    nr.attach_wal(wal)
    feed = DirectoryFeed(str(tmp_path / "feed"), arg_width=AW)
    shipper = ReplicationShipper(wal, feed, poll_s=0.001,
                                 heartbeat_interval_s=0.01)
    tok = nr.register(0)
    for i in range(1, n_ops + 1):
        for c in range(4):
            nr.execute_mut((SR_SET, c, i), tok)
    nr.wal_sync()
    shipper.barrier(4 * n_ops, timeout=10.0)
    return nr, wal, feed, shipper


# =============================================================== frames


class TestFraming:
    def test_frame_roundtrip_over_socketpair(self):
        a, b = socket.socketpair()
        a.settimeout(5.0)
        b.settimeout(5.0)
        try:
            payload = os.urandom(3000)
            send_frame(a, payload)
            assert recv_frame(b) == payload
        finally:
            a.close()
            b.close()

    def test_corrupt_frame_raises_transport_error(self):
        a, b = socket.socketpair()
        a.settimeout(5.0)
        b.settimeout(5.0)
        try:
            payload = b"x" * 64
            frame = struct.pack("<II", len(payload),
                                zlib.crc32(payload) ^ 1) + payload
            a.sendall(frame)
            with pytest.raises(TransportError, match="CRC"):
                recv_frame(b)
        finally:
            a.close()
            b.close()

    def test_eof_mid_frame_raises_transport_error(self):
        a, b = socket.socketpair()
        b.settimeout(5.0)
        payload = b"y" * 64
        frame = struct.pack("<II", len(payload),
                            zlib.crc32(payload)) + payload
        a.sendall(frame[:20])  # torn mid-payload
        a.close()
        try:
            with pytest.raises(TransportError, match="closed"):
                recv_frame(b)
        finally:
            b.close()

    def test_record_roundtrip(self):
        rec = FeedRecord(
            3, 17, np.arange(5, dtype=np.int32),
            np.arange(5 * AW, dtype=np.int32).reshape(5, AW),
        )
        out = decode_record(encode_record(rec), AW)
        assert (out.epoch, out.pos, out.count) == (3, 17, 5)
        assert np.array_equal(out.opcodes, rec.opcodes)
        assert np.array_equal(out.args, rec.args)


# ======================================================== socket feed


class TestSocketFeed:
    def test_poll_matches_directory_feed(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path), arg_width=AW)
        feed.publish(0, 0, *sets(0, [(0, 1), (1, 1)]))
        feed.publish(0, 2, *sets(2, [(2, 1)]))
        feed.write_heartbeat("0 1 3")
        with FeedServer(feed) as srv, \
                SocketFeed(*srv.address, arg_width=AW) as cli:
            got = cli.poll(0)
            want = feed.poll(0)
            assert [(r.pos, r.count, r.epoch) for r in got] \
                == [(r.pos, r.count, r.epoch) for r in want]
            for g, w in zip(got, want):
                assert np.array_equal(g.opcodes, w.opcodes)
                assert np.array_equal(g.args, w.args)
            # straddle: same whole-record rule as the directory feed
            assert [r.pos for r in cli.poll(1)] == [0, 2]
            assert cli.tail_pos() == feed.tail_pos() == 3
            assert cli.epoch() == 0
            assert cli.read_heartbeat() == "0 1 3"

    def test_reconnect_resumes_from_cursor(self, tmp_path):
        # the re-ship idempotence rule over the wire: a dead upstream
        # degrades polls to empty; a restarted server re-serves from
        # whatever cursor the client presents — duplicates, never
        # holes
        from node_replication_torch.obs.metrics import get_registry

        reg = get_registry()
        was = reg.enabled
        reg.enable()
        try:
            feed = DirectoryFeed(str(tmp_path), arg_width=AW)
            feed.publish(0, 0, *sets(0, [(0, 1), (1, 1)]))
            srv = FeedServer(feed)
            port = srv.address[1]
            cli = SocketFeed("127.0.0.1", port, arg_width=AW,
                             connect_timeout_s=0.5)
            assert [r.pos for r in cli.poll(0)] == [0]
            srv.close()
            rc0 = reg.counter("repl.transport.reconnects").value
            assert cli.poll(2) == []  # degraded, not dead
            assert cli.tail_pos() == 2  # cached observation
            assert reg.counter("repl.transport.reconnects").value > rc0
            feed.publish(0, 2, *sets(2, [(2, 1)]))
            srv2 = FeedServer(feed, port=port)
            try:
                assert [r.pos for r in cli.poll(2)] == [2]
                assert cli.tail_pos() == 3
            finally:
                srv2.close()
                cli.close()
        finally:
            reg.enabled = was

    def test_torn_stream_resume(self, tmp_path):
        # a server dying MID-FRAME: the partial frame is discarded
        # (CRC framing), the client reconnects and the retry serves
        # the full records — nothing applied from a torn frame
        feed = DirectoryFeed(str(tmp_path), arg_width=AW)
        feed.publish(0, 0, *sets(0, [(0, 7)]))
        real = FeedServer(feed, auto_start=False)

        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.bind(("127.0.0.1", 0))
        lst.listen(4)
        lst.settimeout(5.0)
        served: list[str] = []

        def fake_server():
            # first connection: answer with a TORN frame, then die
            conn, _ = lst.accept()
            conn.settimeout(5.0)
            recv_frame(conn)
            good = real._poll_payload(0, 0, 16)
            frame = struct.pack("<II", len(good),
                                zlib.crc32(good)) + good
            conn.sendall(frame[: len(frame) // 2])
            conn.close()
            served.append("torn")
            # second connection (the client's retry): serve it whole
            conn, _ = lst.accept()
            conn.settimeout(5.0)
            recv_frame(conn)
            send_frame(conn, good)
            served.append("whole")
            conn.close()

        t = threading.Thread(target=fake_server, daemon=True)
        t.start()
        cli = SocketFeed(*lst.getsockname()[:2], arg_width=AW,
                         connect_timeout_s=1.0, io_timeout_s=5.0)
        try:
            recs = cli.poll(0)
            assert [r.pos for r in recs] == [0]
            assert recs[0].ops()[0] == (SR_SET, 0, 7, 0)
            t.join(5.0)
            assert served == ["torn", "whole"]
        finally:
            cli.close()
            lst.close()
            real.close()

    def test_fence_over_socket_and_zombie_rejection(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path), arg_width=AW)
        feed.publish(1, 0, *sets(0, [(0, 1)]))
        with FeedServer(feed) as srv, \
                SocketFeed(*srv.address, arg_width=AW) as cli:
            assert cli.fence(5) == 5
            assert feed.epoch() == 5  # forwarded to the SOURCE
            # the zombie primary's late publish dies at the source
            with pytest.raises(EpochFencedError):
                feed.publish(1, 1, *sets(1, [(0, 2)]))
            # a non-monotone fence is a typed error over the wire too
            # (a SECOND fencer at the same epoch must not "succeed" —
            # two winners at one epoch would be split brain)
            with pytest.raises(FeedError, match="must exceed"):
                cli.fence(5)

    def test_fence_retry_is_token_idempotent(self, tmp_path):
        # the lost-response case: the client retries a fence whose
        # RESPONSE died on the wire — the SAME fencer token re-applies
        # idempotently, a DIFFERENT token at the same epoch fails
        import struct as _struct

        from node_replication_torch.repl import transport as tp

        feed = DirectoryFeed(str(tmp_path), arg_width=AW)
        with FeedServer(feed, auto_start=False) as srv:
            token = b"A" * 16
            req = (bytes([tp._REQ_FENCE]) + _struct.pack("<q", 7)
                   + token)
            assert srv._handle(0, None, req)[0][0] == tp._RSP_STAT
            assert feed.epoch() == 7
            # the retry (identical bytes) succeeds without re-fencing
            assert srv._handle(0, None, req)[0][0] == tp._RSP_STAT
            assert feed.epoch() == 7
            # a different promoter racing to the same number fails
            req2 = (bytes([tp._REQ_FENCE]) + _struct.pack("<q", 7)
                    + b"B" * 16)
            with pytest.raises(FeedError, match="must exceed"):
                srv._handle(0, None, req2)

    def test_poll_response_byte_cap_streams_backlog(self, tmp_path):
        # a deep backlog must stream as several bounded responses,
        # never one mega-frame the client's recv bound would reject
        from node_replication_torch.repl import transport as tp

        feed = DirectoryFeed(str(tmp_path), arg_width=AW)
        pos = 0
        for _ in range(6):
            n = 400
            feed.publish(0, pos, np.full(n, SR_SET, np.int32),
                         np.ones((n, AW), np.int32))
            pos += n
        cap = tp.MAX_RESPONSE_BYTES
        try:
            tp.MAX_RESPONSE_BYTES = 4000  # ~2 records per response
            with FeedServer(feed) as srv, \
                    SocketFeed(*srv.address, arg_width=AW) as cli:
                got, cursor = 0, 0
                for _ in range(10):
                    recs = cli.poll(cursor)
                    if not recs:
                        break
                    assert len(recs) <= 3
                    cursor = recs[-1].pos + recs[-1].count
                    got += len(recs)
                assert cursor == pos  # the whole backlog arrived
                assert got == 6
        finally:
            tp.MAX_RESPONSE_BYTES = cap

    def test_server_barrier_and_tree_barrier(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path / "feed"), arg_width=AW)
        wal = WriteAheadLog(str(tmp_path / "wal"), policy="always")
        shipper = ReplicationShipper(wal, feed, poll_s=0.001)
        srv = FeedServer(feed)
        cli = SocketFeed(*srv.address, arg_width=AW)
        try:
            wal.append(0, [(SR_SET, 0, 1), (SR_SET, 1, 1)])
            shipper.barrier(2, timeout=10.0)
            # no downstream has confirmed anything yet
            with pytest.raises(FeedError, match="barrier timed out"):
                srv.barrier(2, timeout=0.05)
            assert [r.pos for r in cli.poll(0)] == [0]
            # ...the poll proved receipt up to 0 only; polling FROM 2
            # confirms everything below 2
            cli.poll(2)
            srv.barrier(2, timeout=5.0)
            assert list(srv.downstream_cursors().values()) == [2]
            # composed: fsynced AND feed-visible AND received by one
            # downstream connection
            barrier = make_tree_barrier(shipper, srv, min_clients=1,
                                        timeout=5.0)
            barrier(2)
            with pytest.raises(FeedError):
                make_tree_barrier(shipper, srv, min_clients=2,
                                  timeout=0.05)(2)
        finally:
            cli.close()
            srv.close()
            shipper.stop()
            wal.close()


# ============================================================ followers


class TestFollowerOverSocket:
    def test_follower_bit_identity_over_socket(self, tmp_path):
        nr, wal, feed, shipper = _primary(tmp_path)
        srv = FeedServer(feed)
        cli = SocketFeed(*srv.address, arg_width=AW)
        f = Follower(DISPATCH, cli, str(tmp_path / "f"),
                     nr_kwargs=NR_KW)
        try:
            assert f.wait_applied(40, timeout=15.0)
            assert_states_equal(states_np(nr), f.nr.states)
            v, applied, bound = f.read_result((SR_GET, 2),
                                              max_lag_pos=0,
                                              wait_s=2.0)
            assert v == 10 and applied >= bound == 40
        finally:
            f.close()
            cli.close()
            srv.close()
            shipper.stop()
            nr.detach_wal().close()

    def test_relay_tree_1_2_4_bit_identity(self, tmp_path):
        # the fan-out topology: primary -> 2 relays -> 4 followers;
        # every leaf folds the SAME history as a follower reading the
        # primary's feed directly — bit-identity composes through
        # relay depth, and the primary serves only its 2 relay edges
        nr, wal, feed, shipper = _primary(tmp_path)
        srv = FeedServer(feed, wal=wal)
        relays, followers = [], []
        direct = Follower(DISPATCH, feed, str(tmp_path / "direct"),
                          nr_kwargs=NR_KW, name="direct")
        try:
            for r in range(2):
                relay = RelayNode(
                    SocketFeed(*srv.address, arg_width=AW),
                    str(tmp_path / f"relay{r}"), arg_width=AW,
                    poll_s=0.001, name=f"relay{r}",
                )
                relays.append(relay)
                for k in range(2):
                    leaf = SocketFeed(*relay.address, arg_width=AW)
                    followers.append(Follower(
                        DISPATCH, leaf,
                        str(tmp_path / f"f{r}{k}"),
                        nr_kwargs=NR_KW, name=f"f{r}{k}",
                        poll_s=0.001,
                    ))
            assert direct.wait_applied(40, timeout=15.0)
            for f in followers:
                assert f.wait_applied(40, timeout=15.0), f.stats()
            want = states_np(direct.nr)
            assert_states_equal(want, nr.states)
            for f in followers:
                assert_states_equal(want, f.nr.states)
            # heartbeat forwards verbatim through the relays (stop the
            # shipper first so the beacon quiesces, then wait for the
            # pumps to converge on the final value)
            shipper.stop()
            final_hb = feed.read_heartbeat()
            assert final_hb is not None
            import time as _time

            for relay in relays:
                assert relay.wait_forwarded(40, timeout=5.0)
                deadline = _time.monotonic() + 5.0
                while (relay.local.read_heartbeat() != final_hb
                       and _time.monotonic() < deadline):
                    _time.sleep(0.005)
                assert relay.local.read_heartbeat() == final_hb
            # each record crossed the primary's edge once per RELAY,
            # not once per leaf: only the 2 relays poll the primary
            assert len(srv.downstream_cursors()) == 2
        finally:
            for f in followers:
                f.close()
            direct.close()
            for relay in relays:
                relay.close()
            srv.close()
            shipper.stop()
            nr.detach_wal().close()

    def test_snapshot_bootstrap_bit_identical_to_full_replay(
            self, tmp_path):
        # cold-follower bootstrap: fetch snap-<pos>.npz, recover from
        # it (digest-validated by recover_fleet), stream only
        # [pos, tail) — same final state as replaying everything
        nr, wal, feed, shipper = _primary(tmp_path, n_ops=10)
        snap_dir = str(tmp_path / "primary-snaps")
        save_durable_snapshot(nr, snap_dir)  # snapshot at pos 40
        tok = nr.register(0)
        for i in range(11, 16):
            for c in range(4):
                nr.execute_mut((SR_SET, c, i), tok)
        nr.wal_sync()
        shipper.barrier(60, timeout=10.0)
        srv = FeedServer(feed, snapshot_dir=snap_dir, wal=wal)
        cold = warm = None
        try:
            cold = Follower(
                DISPATCH, SocketFeed(*srv.address, arg_width=AW),
                str(tmp_path / "cold"), nr_kwargs=NR_KW,
                name="cold", bootstrap=True,
            )
            # the bootstrap really happened: recovery started at the
            # FETCHED snapshot, so only [40, 60) replayed from history
            assert cold.bootstrap_report is not None
            assert cold.bootstrap_report[0] == 40
            assert cold.recovery_report.snapshot_pos == 40
            warm = Follower(
                DISPATCH, SocketFeed(*srv.address, arg_width=AW),
                str(tmp_path / "warm"), nr_kwargs=NR_KW,
                name="warm", bootstrap=False,
            )
            assert warm.bootstrap_report is None
            assert warm.recovery_report.snapshot_pos == 0
            assert cold.wait_applied(60, timeout=15.0)
            assert warm.wait_applied(60, timeout=15.0)
            assert_states_equal(states_np(nr), cold.nr.states)
            assert_states_equal(states_np(cold.nr), warm.nr.states)
        finally:
            for f in (cold, warm):
                if f is not None:
                    f.close()
            srv.close()
            shipper.stop()
            nr.detach_wal().close()


# ========================================================== pipe twin


class TestPipeTransport:
    def test_disconnect_reconnect_dup_idempotence(self, tmp_path):
        # the in-memory twin drives the exact client contract: polls
        # go quiet while disconnected, the post-reconnect rewind
        # re-delivers applied records, and the follower absorbs the
        # duplicates idempotently — applied history stays exact
        feed = DirectoryFeed(str(tmp_path / "feed"), arg_width=AW)
        for pos in range(0, 6, 2):
            feed.publish(0, pos,
                         *sets(pos, [(0, pos + 1), (1, pos + 1)]))
        pipe = PipeTransport(feed, rewind=4)
        f = Follower(DISPATCH, pipe, str(tmp_path / "f"),
                     nr_kwargs=NR_KW, auto_start=False)
        try:
            f._apply_once()
            assert f.applied_pos() == 6
            pipe.disconnect()
            feed.publish(0, 6, *sets(6, [(2, 9)]))
            assert f._apply_once() == 0  # quiet, not dead
            assert pipe.tail_pos() == 6  # cached observation
            pipe.reconnect()  # rewound: next poll re-serves from 2
            assert f._apply_once() == 1  # ONLY the new record applied
            assert f.applied_pos() == 7
            # duplicates were counted, not re-applied
            assert f.frontend.read((SR_GET, 1), rid=0) == 5
            assert f.frontend.read((SR_GET, 2), rid=0) == 9
        finally:
            f.close()

    def test_promote_drain_survives_degraded_polls(self, tmp_path):
        # the lost-acked-writes hazard: SocketFeed.poll degrades to []
        # on a transient wire blip, and a drain that trusts one empty
        # poll would conclude "drained" with acked records still on
        # the upstream. promote() must verify the applied cursor
        # against the fenced feed tail and keep polling through blips.
        class _BlinkingFeed:
            def __init__(self, inner, blips):
                self.inner = inner
                self.arg_width = inner.arg_width
                self.blips = blips

            def poll(self, start=0):
                if self.blips > 0:
                    self.blips -= 1
                    return []  # the degraded-transport blip
                return self.inner.poll(start)

            def tail_pos(self):
                return self.inner.tail_pos()

            def epoch(self):
                return self.inner.epoch()

            def read_heartbeat(self):
                return self.inner.read_heartbeat()

            def fence(self, e):
                return self.inner.fence(e)

        inner = DirectoryFeed(str(tmp_path / "feed"), arg_width=AW)
        inner.publish(0, 0, *sets(0, [(0, 1), (1, 1)]))
        blink = _BlinkingFeed(inner, blips=0)
        f = Follower(DISPATCH, blink, str(tmp_path / "f"),
                     nr_kwargs=NR_KW, auto_start=False)
        try:
            f._apply_once()
            assert f.applied_pos() == 2
            # the dead primary's LAST acked batch, not yet applied
            inner.publish(0, 2, *sets(2, [(2, 7)]))
            blink.blips = 3  # every drain poll blips a few times
            rep = f.promote()
            assert rep["applied"] == 3  # the blip did NOT truncate it
            assert f.frontend.read((SR_GET, 2), rid=0) == 7
        finally:
            f.close()

    def test_promote_drain_stall_fails_loudly(self, tmp_path):
        # a transport that stays down past the drain deadline must
        # FAIL the promotion (another follower can be elected), never
        # serve a truncated history
        class _DeadAfterFence:
            def __init__(self, inner):
                self.inner = inner
                self.arg_width = inner.arg_width
                self.dead = False

            def poll(self, start=0):
                return [] if self.dead else self.inner.poll(start)

            def tail_pos(self):
                return self.inner.tail_pos()

            def epoch(self):
                return self.inner.epoch()

            def read_heartbeat(self):
                return self.inner.read_heartbeat()

            def fence(self, e):
                out = self.inner.fence(e)
                self.dead = True
                return out

        inner = DirectoryFeed(str(tmp_path / "feed"), arg_width=AW)
        inner.publish(0, 0, *sets(0, [(0, 1)]))
        f = Follower(DISPATCH, _DeadAfterFence(inner),
                     str(tmp_path / "f"), nr_kwargs=NR_KW,
                     auto_start=False)
        try:
            with pytest.raises(RuntimeError, match="drain stalled"):
                f.promote(drain_timeout_s=0.3)
            assert not f.promoted
        finally:
            f.close()

    def test_fence_requires_connection(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path), arg_width=AW)
        pipe = PipeTransport(feed)
        pipe.disconnect()
        with pytest.raises(FeedError, match="disconnected"):
            pipe.fence(3)
        pipe.reconnect()
        assert pipe.fence(3) == 3
        assert feed.epoch() == 3

    def test_frozen_heartbeat_while_disconnected(self, tmp_path):
        # a partitioned upstream reads as heartbeat SILENCE — exactly
        # the signal the promotion watcher needs to act on
        feed = DirectoryFeed(str(tmp_path), arg_width=AW)
        feed.write_heartbeat("0 1 0")
        pipe = PipeTransport(feed)
        assert pipe.read_heartbeat() == "0 1 0"
        pipe.disconnect()
        feed.write_heartbeat("0 2 0")
        assert pipe.read_heartbeat() == "0 1 0"  # frozen
        pipe.reconnect()
        assert pipe.read_heartbeat() == "0 2 0"


# ============================================================== relays


class TestRelayRules:
    def test_gap_surfaces_typed(self, tmp_path):
        from node_replication_torch.repl import FeedGapError

        feed = DirectoryFeed(str(tmp_path / "feed"), arg_width=AW)
        feed.publish(0, 0, *sets(0, [(0, 1)]))
        relay = RelayNode(feed, str(tmp_path / "relay"), arg_width=AW,
                          auto_start=False)
        assert relay._pump_once() == 1
        feed.prune(10)
        feed.publish(0, 5, *sets(5, [(0, 2)]))  # hole: [1, 5) gone
        with pytest.raises(FeedGapError) as ei:
            relay._pump_once()
        assert (ei.value.expected, ei.value.got) == (1, 5)

    def test_zombie_records_never_reach_the_subtree(self, tmp_path):
        feed = DirectoryFeed(str(tmp_path / "feed"), arg_width=AW)
        feed.publish(0, 0, *sets(0, [(0, 1)]))
        relay = RelayNode(feed, str(tmp_path / "relay"), arg_width=AW,
                          auto_start=False)
        relay._pump_once()
        # a downstream promotion fences the relay's journal...
        relay.local.fence(4)
        relay._propagate_fence(4)
        assert feed.epoch() == 4  # ...and propagates to the source
        # a zombie record already in flight upstream (published before
        # the source fence landed) is dropped, never forwarded
        os.remove(os.path.join(feed.dir, "EPOCH"))  # re-open the door
        feed.publish(0, 1, *sets(1, [(0, 99)]))
        assert relay._pump_once() == 0
        assert relay.local.tail_pos() == 1  # journal did NOT grow
        assert relay.cursor() == 2  # ...but the pump moved past it


# =========================================== against the reference


def _seeded_records(seed, n):
    rng = np.random.default_rng(seed)
    pos, out = 0, []
    for _ in range(n):
        count = int(rng.integers(1, 9))
        opc = rng.integers(-2, 5, count).astype(np.int32)
        args = rng.integers(-(1 << 31), 1 << 31, (count, AW),
                            dtype=np.int64).astype(np.int32)
        out.append((int(rng.integers(0, 3)), pos, opc, args))
        pos += count
    return out


def _raw_frame(sock):
    """One whole frame off the wire, header included, unchecked."""
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            assert chunk, "connection closed mid-frame"
            buf += chunk
        return buf

    hdr = exact(8)
    (length, _crc) = struct.unpack("<II", hdr)
    return hdr + exact(length)


def test_frames_byte_identical():
    """`encode_record` and `send_frame` of both packages give the same
    bytes for the same seeded records, and each decodes the other's."""
    for epoch, pos, opc, args in _seeded_records(7, 50):
        t = encode_record(FeedRecord(epoch, pos, opc, args))
        j = jtp.encode_record(jtp.FeedRecord(epoch, pos, opc, args))
        assert t == j
        for dec in (decode_record, jtp.decode_record):
            back = dec(t, AW)
            assert (back.epoch, back.pos, back.count) == \
                (epoch, pos, len(opc))
            assert np.array_equal(back.opcodes, opc)
            assert np.array_equal(back.args, args)
        wire = []
        for send in (send_frame, jtp.send_frame):
            a, b = socket.socketpair()
            a.settimeout(5.0)
            b.settimeout(5.0)
            try:
                send(a, t)
                wire.append(_raw_frame(b))
            finally:
                a.close()
                b.close()
        assert wire[0] == wire[1]
        assert wire[0][:8] == struct.pack("<II", len(t), zlib.crc32(t))


def _same_feeds(tmp_path):
    """The same seeded records, beacon and snapshot file in a feed of
    each package (the snapshot saved once, by the port, and copied)."""
    recs = _seeded_records(9, 30)
    nr = NodeReplicated(DISPATCH, **NR_KW)
    nr.execute_mut_batch([(SR_SET, c, 5 + c) for c in range(4)], rid=0)
    snap_src = str(tmp_path / "snap-src")
    save_durable_snapshot(nr, snap_src)
    feeds = {}
    for pkg, Feed in (("ref", JFeed), ("port", DirectoryFeed)):
        d = tmp_path / f"feed-{pkg}"
        feed = Feed(str(d), arg_width=AW)
        for epoch, pos, opc, args in recs:
            feed.publish(epoch, pos, opc, args)
        feed.write_heartbeat("2 31 400")
        snaps = tmp_path / f"snaps-{pkg}"
        snaps.mkdir()
        for name in os.listdir(snap_src):
            with open(os.path.join(snap_src, name), "rb") as src, \
                    open(snaps / name, "wb") as dst:
                dst.write(src.read())
        feeds[pkg] = (feed, str(snaps))
    return feeds


def test_server_answers_byte_identical(tmp_path, monkeypatch):
    """A server of each package over the same feed answers the same
    request frames — POLLs, a STAT, a FENCE, its retry under the same
    fencer token, a rival fence (an error frame), a snapshot request
    (META, CHUNK frames, END) — with the same frames, byte for byte."""
    monkeypatch.setattr(ttp, "SNAP_CHUNK_BYTES", 1 << 10)
    monkeypatch.setattr(jtp, "SNAP_CHUNK_BYTES", 1 << 10)
    feeds = _same_feeds(tmp_path)
    q = struct.Struct("<q")
    requests = [
        bytes([1]) + struct.pack("<qi", 0, 4),
        bytes([1]) + struct.pack("<qi", 13, 0),
        bytes([1]) + struct.pack("<qi", 10_000, 8),
        bytes([2]),
        bytes([3]) + q.pack(4) + b"T" * 16,
        bytes([3]) + q.pack(4) + b"T" * 16,
        bytes([3]) + q.pack(4) + b"U" * 16,
        bytes([1]) + struct.pack("<qi", 0, 256),
    ]
    answers = {}
    for pkg, Server in (("ref", JFeedServer), ("port", FeedServer)):
        feed, snaps = feeds[pkg]
        got = []
        with Server(feed, snapshot_dir=snaps) as srv:
            s = socket.create_connection(srv.address, timeout=5.0)
            s.settimeout(5.0)
            try:
                for req in requests:
                    send_frame(s, req)
                    got.append(_raw_frame(s))
                send_frame(s, bytes([4]) + q.pack(0))
                while True:
                    got.append(_raw_frame(s))
                    if got[-1][8] == 21:  # END of the snapshot stream
                        break
            finally:
                s.close()
        answers[pkg] = got
    ref, port = answers["ref"], answers["port"]
    assert [f[8] for f in port] == [f[8] for f in ref]
    assert port[6][8] == 18  # the rival fence: an error frame
    assert sum(f[8] == 20 for f in port) > 2  # several chunks
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, i
    assert feeds["ref"][0].epoch() == feeds["port"][0].epoch() == 4


def _ship_primary(pkg, tmp_path):
    """A primary of package `pkg` with 40 shipped SR_SETs, a durable
    snapshot at 40 in its own directory, then 20 more shipped."""
    if pkg == "ref":
        nr = JNR(j_make_seqreg(4), **J_NR_KW)
        wal = JWAL(str(tmp_path / "pwal"), policy="batch")
        feed = JFeed(str(tmp_path / "feed"), arg_width=AW)
        Ship, save = JShipper, j_save_durable_snapshot
    else:
        nr = NodeReplicated(DISPATCH, **NR_KW)
        wal = WriteAheadLog(str(tmp_path / "pwal"), policy="batch")
        feed = DirectoryFeed(str(tmp_path / "feed"), arg_width=AW)
        Ship, save = ReplicationShipper, save_durable_snapshot
    nr.attach_wal(wal)
    shipper = Ship(wal, feed, poll_s=0.001, heartbeat_interval_s=0.01)
    tok = nr.register(0)
    snap_dir = str(tmp_path / "psnaps")
    for i in range(1, 16):
        for c in range(4):
            nr.execute_mut((SR_SET, c, 100 * i + c), tok)
        if i == 10:
            save(nr, snap_dir)
    nr.wal_sync()
    shipper.barrier(60, timeout=10.0)
    return nr, wal, feed, shipper, snap_dir


def _same_fleet(jn, tn):
    got = interop.log_to_numpy(tn.log)
    for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
        want = np.asarray(getattr(jn.log, f))
        assert want.dtype == got[f].dtype and want.shape == got[f].shape
        assert np.array_equal(want, got[f]), f
    for f, leaf in tn.states.items():
        assert np.array_equal(np.asarray(jn.states[f]), leaf.numpy()), f


@pytest.mark.parametrize("server", ["ref", "port"])
def test_clients_read_the_other_packages_server(server, tmp_path):
    """A server of one package, a socket client and a cold follower of
    each: polls equal the source feed's, both followers bootstrap from
    the served snapshot at 40 and replay only [40, 60), and end with
    equal rings, int64 cursors, states and WAL records; then a fence
    from the other package's client lands on the source feed."""
    nr, wal, feed, shipper, snap_dir = _ship_primary(server, tmp_path)
    Server = JFeedServer if server == "ref" else FeedServer
    # a short io timeout: closing the server does not wake a connection
    # thread blocked in recv, which then waits out its timeout
    srv = Server(feed, snapshot_dir=snap_dir, wal=wal, io_timeout_s=1.0)
    tf = jf = None
    try:
        for Client in (SocketFeed, JSocketFeed):
            with Client(*srv.address, arg_width=AW) as cli:
                got, want = cli.poll(0), feed.poll(0)
                assert [(r.epoch, r.pos, r.count) for r in got] == \
                    [(r.epoch, r.pos, r.count) for r in want]
                for g, w in zip(got, want):
                    assert np.array_equal(g.opcodes, w.opcodes)
                    assert np.array_equal(g.args, w.args)
                assert cli.tail_pos() == 60
        tf = Follower(DISPATCH, SocketFeed(*srv.address, arg_width=AW),
                      str(tmp_path / "tf"), nr_kwargs=NR_KW, name="tf")
        jf = JFollower(j_make_seqreg(4),
                       JSocketFeed(*srv.address, arg_width=AW),
                       str(tmp_path / "jf"), nr_kwargs=J_NR_KW, name="jf")
        for f in (tf, jf):
            assert f.bootstrap_report is not None
            assert f.bootstrap_report[0] == 40
            assert f.recovery_report.snapshot_pos == 40
            assert f.wait_applied(60, timeout=20.0)
        _same_fleet(jf.nr, tf.nr)
        a, b = list(jf.nr.wal.records(0)), list(tf.nr.wal.records(0))
        assert [(r.pos, r.count) for r in a] == \
            [(r.pos, r.count) for r in b]
        nr.sync()
        for k, leaf in tf.nr.states.items():
            live = nr.states[k]
            live = np.asarray(live) if server == "ref" else live.numpy()
            assert np.array_equal(live, leaf.numpy()), k
        assert tf.read((SR_GET, 3), max_lag_pos=0, wait_s=2.0) == 1503
        Other = SocketFeed if server == "ref" else JSocketFeed
        with Other(*srv.address, arg_width=AW) as cli:
            assert cli.fence(6) == 6
        assert feed.epoch() == 6
    finally:
        for f in (tf, jf):
            if f is not None:
                f.close()
        srv.close()
        shipper.stop()
        nr.detach_wal().close()
