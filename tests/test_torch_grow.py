"""`NodeReplicated.grow_fleet` and the sequence-register model of the port
against the reference.

Twins of `tests/test_replica.py::TestGrowFleet` as differentials (the
same stream and the same grow through both packages; ring planes,
cursors and states equal), including a grow after the ring wrapped and
a grow under a forced fused tier, where the port's K1 engine is rebuilt
for the wider fleet. Then a seqreg case in the style of
`tests/test_models.py`: fetch-and-set responses, reads and states equal
to the reference's.
"""

import numpy as np
import pytest

from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.models import make_seqreg as j_make_seqreg

from node_replication_torch import interop
from node_replication_torch.core.replica import (
    NodeReplicated,
    ReplicaFencedError,
)
from node_replication_torch.models import (
    HM_GET,
    HM_PUT,
    SR_GET,
    SR_SET,
    make_hashmap,
    make_seqreg,
)
from node_replication_torch.ops.replay import FusedHashmapEngine

KW = dict(log_entries=256, gc_slack=16, exec_window=32)


def small_nr(d, n_replicas=1, **kw):
    return NodeReplicated(d, n_replicas=n_replicas, device="cpu",
                          **{**KW, **kw})


def _same_fleet(jn, tn):
    got = interop.log_to_numpy(tn.log)
    for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
        want = np.asarray(getattr(jn.log, f))
        assert want.dtype == got[f].dtype and want.shape == got[f].shape
        assert np.array_equal(want, got[f]), f
    for f, leaf in tn.states.items():
        assert np.array_equal(np.asarray(jn.states[f]), leaf.numpy()), f
    assert jn.stats() == tn.stats()


class TestGrowFleet:
    def test_join_mid_run_converges_and_participates(self):
        nr = small_nr(make_hashmap(32), n_replicas=2)
        t0 = nr.register(0)
        for i in range(20):
            nr.execute_mut((HM_PUT, i % 32, i + 1), t0)
        [rid] = nr.grow_fleet(1)
        assert rid == 2 and nr.n_replicas == 3
        assert nr.replicas_equal()
        t2 = nr.register(rid)
        nr.execute_mut((HM_PUT, 7, 777), t2)
        assert nr.execute((HM_GET, 7), t0) == 777
        nr.execute_mut((HM_PUT, 9, 999), t0)
        assert nr.execute((HM_GET, 9), t2) == 999
        nr.sync()
        assert nr.replicas_equal()

    def test_join_after_ring_wrap(self):
        nr = small_nr(make_hashmap(16), n_replicas=2)
        t0 = nr.register(0)
        for i in range(600):  # log_entries=256 -> multiple wraps
            nr.execute_mut((HM_PUT, i % 16, i), t0)
        assert int(nr.log.tail) > nr.spec.capacity
        [rid] = nr.grow_fleet(1)
        assert nr.replicas_equal()
        assert nr.execute((HM_GET, 3), nr.register(rid)) == 595

    def test_join_multiple_and_divergent_donor(self):
        nr = small_nr(make_seqreg(4), n_replicas=2)
        t0 = nr.register(0)
        for i in range(10):
            nr.execute_mut((SR_SET, 1, i + 1), t0)
        rids = nr.grow_fleet(2)
        assert rids == [2, 3] and nr.n_replicas == 4
        assert nr.replicas_equal()
        assert nr.execute_mut((SR_SET, 1, 99), nr.register(3)) == 10
        nr.sync()
        assert nr.replicas_equal()

    def test_grow_validation(self):
        nr = small_nr(make_hashmap(8))
        with pytest.raises(ValueError):
            nr.grow_fleet(0)
        with pytest.raises(ValueError):
            nr.grow_fleet(1, donor=5)

    def test_grow_never_clones_a_fenced_donor(self):
        nr = small_nr(make_seqreg(2), n_replicas=2)
        nr.execute_mut_batch([(SR_SET, 0, 5)], rid=0)
        nr.fence_replica(1)
        with pytest.raises(ReplicaFencedError):
            nr.grow_fleet(1, donor=1)
        assert nr.grow_fleet(1) == [2]
        assert nr.fenced_rids == [1]
        assert nr.replica_device(2) == nr.device


def _stream(rng, n, K):
    return [(int(rng.integers(1, 3)), int(rng.integers(-K, 2 * K)),
             int(rng.integers(1 << 20))) for _ in range(n)]


@pytest.mark.parametrize("engine,wrap", [("combined", False),
                                         ("scan", True),
                                         ("pallas", False),
                                         ("pallas", True)])
def test_grow_differential_bit_identical(engine, wrap):
    """Batches round-robin over the replicas, a grow by 2 in the middle
    (after the 256-slot ring wrapped, for `wrap`), more batches that
    include the newcomers; everything equals the reference."""
    K = 24
    rng = np.random.default_rng(21 + wrap)
    jn = JNR(j_make_hashmap(K), n_replicas=2, engine=engine, **KW)
    tn = small_nr(make_hashmap(K), n_replicas=2, engine=engine)
    pre = 40 if wrap else 6
    for b in range(pre):
        ops = _stream(rng, 8, K)
        assert (jn.execute_mut_batch(ops, rid=b % 2)
                == tn.execute_mut_batch(ops, rid=b % 2))
    assert (int(tn.log.tail) > 256) == wrap
    assert jn.grow_fleet(2) == tn.grow_fleet(2) == [2, 3]
    _same_fleet(jn, tn)
    for b in range(12):
        ops = _stream(rng, 8, K)
        assert (jn.execute_mut_batch(ops, rid=b % 4)
                == tn.execute_mut_batch(ops, rid=b % 4))
    jn.sync()
    tn.sync()
    _same_fleet(jn, tn)
    if engine == "pallas":
        # the fused engine was rebuilt for R + k: rounds stayed fused
        assert isinstance(tn._fused, FusedHashmapEngine)
        assert tn._fused.spec.n_replicas == 4
        assert tn.stats()["fused_rounds"] == jn.stats()["fused_rounds"]
        assert tn.stats()["fused_tier"] == "forced"


def test_grow_resets_auto_calibration(monkeypatch):
    monkeypatch.setenv("NR_TPU_FUSED_CAL", "1")
    nr = small_nr(make_hashmap(16), n_replicas=2)
    assert nr._fused_mode == "auto"
    for i in range(8):
        nr.execute_mut_batch([(HM_PUT, i, i)], rid=0)
    assert nr.stats()["fused_tier"] != "calibrating"
    nr.grow_fleet(1)
    assert nr.stats()["fused_tier"] == "calibrating"
    assert nr._fused is None


class TestSeqReg:
    def test_fetch_and_set_matches_reference(self):
        """Fetch-and-set over 5 slots on two replicas, slot indices
        wrapping both ways (the floored `slot % n`): every response,
        read and state equals the reference's."""
        rng = np.random.default_rng(5)
        jn = JNR(j_make_seqreg(5), n_replicas=2, **KW)
        tn = small_nr(make_seqreg(5), n_replicas=2)
        jt = [jn.register(r) for r in range(2)]
        tt = [tn.register(r) for r in range(2)]
        for i in range(120):
            r = i % 2
            op = (SR_SET, int(rng.integers(-12, 12)),
                  int(rng.integers(-(1 << 31), 1 << 31)))
            assert jn.execute_mut(op, jt[r]) == tn.execute_mut(op, tt[r])
            rd = (SR_GET, int(rng.integers(-12, 12)))
            assert jn.execute(rd, jt[1 - r]) == tn.execute(rd, tt[1 - r])
        jn.sync()
        tn.sync()
        _same_fleet(jn, tn)

    def test_sequence_oracle(self):
        # writes 1..N to one slot read back 0..N-1: the serve verifier's
        # invariant, on the bare wrapper
        nr = small_nr(make_seqreg(3), n_replicas=2)
        tok = nr.register(1)
        assert [nr.execute_mut((SR_SET, 4, v + 1), tok)
                for v in range(50)] == list(range(50))
        assert nr.execute((SR_GET, 1), nr.register(0)) == 50
        nr.sync()
        assert nr.replicas_equal()
