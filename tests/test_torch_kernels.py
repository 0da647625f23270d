"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips with a reason where there is no CUDA
device (decided inside the fixture, never at import). The real check at
the flagship shapes is `chip_smoke.py`; these cover the edges at small
shapes: replica counts that are not a multiple of a warp or of 4,
planes that are not 16-byte aligned, windows past one shared-memory
chunk, one key for the whole window, hot keys, negative keys, ring
wrap, fenced lanes, K1 over the model's `[R, K]` states (at the
flagship shape too) and `round_fn`'s one launch of it, and for the flat
vspace kernels spans that end at P-1 or wrap through 0, int32 wrap near
2^31, n = 0, both state layouts, hot tiles, spans across tile edges and
partial last tiles.
Every value is an integer, so the tolerance is 0.

This file imports torch and the port only, so it runs on a machine
without JAX: `python -m pytest --noconftest tests/test_torch_kernels.py`.
"""

import numpy as np
import pytest
import torch

from node_replication_torch.core.log import LogSpec
from node_replication_torch.ops.replay import (
    FUSED_KERNEL,
    REPLAY_KERNEL,
    hashmap_fused_round_model,
    hashmap_fused_round_model_plain,
    hashmap_fused_round_plain,
    hashmap_replay,
    hashmap_replay_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _window(rng, W, K, dev, hot=False):
    opc = rng.choice(np.array([0, 1, 2, 7], np.int32), W)
    key = rng.integers(-3 * K, 3 * K, W).astype(np.int32)
    val = rng.integers(-1000, 1000, W).astype(np.int32)
    if hot:  # half of the entries on 8 keys
        at = rng.random(W) < 0.5
        key[at] = rng.choice(key[:8], int(at.sum()))
    return [torch.from_numpy(a).to(dev) for a in (opc, key, val)]


def _planes(rng, K, R, dev):
    kp = -(-K // 8) * 8
    v = rng.integers(-50, 50, (kp, R)).astype(np.int32)
    p = (rng.random((kp, R)) < 0.5).astype(np.int32)
    return torch.from_numpy(v).to(dev), torch.from_numpy(p).to(dev)


def _unaligned(t):
    """The same values, contiguous, 4 bytes past an aligned address."""
    flat = torch.cat([t.new_zeros(1), t.reshape(-1)])
    return flat[1:].view(t.shape)


# K2 tiles 16 key rows x 512 replica columns and scans the window in
# chunks of 1024: R = 34 is not 16-byte aligned (its scalar path), as
# are the "unaligned" planes; K = 1 puts every entry of five chunks on
# one row; Kp = 40 is not a multiple of the row tile; R = 600 spans two
# column tiles, under a window with half of its entries on 8 keys
@pytest.mark.parametrize("R,K,W,window", [
    (1, 5, 7, "mixed"), (33, 13, 300, "mixed"), (64, 64, 2500, "mixed"),
    (100, 1, 40, "mixed"), (34, 13, 300, "mixed"), (100, 1, 5000, "mixed"),
    (64, 37, 700, "mixed"), (600, 1000, 3000, "hot"),
    (36, 40, 500, "unaligned")])
def test_replay_kernel_equals_plain(dev, R, K, W, window):
    rng = np.random.default_rng(R * 1000 + W)
    opc, key, val = _window(rng, W, K, dev, hot=window == "hot")
    v, p = _planes(rng, K, R, dev)
    if window == "unaligned":
        v, p = _unaligned(v), _unaligned(p)
    before = REPLAY_KERNEL.launches
    got = hashmap_replay(opc, key, val, v, p, K)
    torch.cuda.synchronize()
    want = hashmap_replay_plain(opc, key, val, v, p, K)
    assert REPLAY_KERNEL.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# K1 over the model's [R, K] states tiles 64 keys x 128 replica rows:
# the flagship (R = 4096, K = 10000, W = 256), a mesh shard's R = 1024,
# R = 4097 (a last tile of one replica row), K = 10001 (the scalar path),
# K = 1000 (16-byte values, present in 4-byte runs), K = 37 (scalar), the
# sim's R = 3, K = 32 at W = 1, states 4 and 1 bytes past an aligned
# address (scalar), and an empty window (count 0: all NOOP padding). The
# fields: R, K, W, rounds, and "unaligned" or "empty" where the case is
# one. Each first tail makes the rounds cross the wrap of a 4096 ring.
K1_MODEL_CASES = {
    "flagship": (4096, 10000, 256, 3),
    "shard": (1024, 10000, 256, 3),
    "r4097": (4097, 10000, 256, 3),
    "k10001": (4096, 10001, 256, 3),
    "k1000": (300, 1000, 64, 6),
    "k37": (70, 37, 64, 6),
    "sim_r3_w1": (3, 32, 1, 6),
    "unaligned": (260, 64, 64, 6, "unaligned"),
    "empty": (600, 1000, 8, 3, "empty"),
}


def _k1_model_inputs(rng, R, K, W, count, dev):
    """A round's batch (NOOP padding past `count` with junk keys and
    values) over keys in [-3K, 3K)."""
    opc = np.zeros(W, np.int32)
    opc[:count] = rng.choice(np.array([0, 1, 1, 2, 2, 7], np.int32), count)
    args = np.stack([rng.integers(-3 * K, 3 * K, W),
                     rng.integers(-(1 << 31), 1 << 31, W),
                     rng.integers(-9, 9, W)], 1).astype(np.int32)
    return torch.from_numpy(opc).to(dev), torch.from_numpy(args).to(dev)


@pytest.mark.parametrize("fenced", [False, True])
@pytest.mark.parametrize("case", list(K1_MODEL_CASES))
def test_model_layout_k1_equals_plain(dev, case, fenced):
    R, K, W, rounds, *kind = K1_MODEL_CASES[case]
    spec = LogSpec(capacity=4096, n_replicas=R, arg_width=3, gc_slack=64)
    L = spec.capacity
    rng = np.random.default_rng(
        11 + fenced + 10 * list(K1_MODEL_CASES).index(case))
    ring_opc = torch.from_numpy(
        rng.integers(0, 3, L).astype(np.int32)).to(dev)
    ring_args = torch.from_numpy(
        rng.integers(-9, 9, (L, 3)).astype(np.int32)).to(dev)
    v = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (R, K)).astype(np.int32)).to(dev)
    p = torch.from_numpy(rng.random((R, K)) < 0.5).to(dev)
    if kind == ["unaligned"]:
        v, p = _unaligned(v), _unaligned(p)
    fen = None
    if fenced:
        fen = torch.zeros(R, dtype=torch.int32, device=dev)
        fen[[r for r in (0, 31, 127, 128, R // 2, R - 1) if r < R]] = 1
    kern = plain = (ring_opc, ring_args, v, p)
    tail = tail0 = L - max(1, rounds * W // 4)
    before = FUSED_KERNEL.launches
    for rnd in range(rounds):
        count = 0 if kind == ["empty"] else \
            int(rng.integers(W // 2, W + 1)) if W > 1 else 1
        opc, args = _k1_model_inputs(rng, R, K, W, count, dev)
        t = torch.tensor(tail, dtype=torch.int64, device=dev)
        out_k = hashmap_fused_round_model(spec, t, count, opc, args, *kern,
                                          K, fen)
        out_p = hashmap_fused_round_model_plain(spec, t, count, opc, args,
                                                *plain, K, fen)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            assert a.dtype == b.dtype and torch.equal(a, b), rnd
        if fen is not None:
            assert not out_k[4][fen > 0].any()
        kern, plain = out_k[:4], out_p[:4]
        tail += count
    assert FUSED_KERNEL.launches == before + rounds
    assert tail == tail0 if kind == ["empty"] else tail0 < L < tail


@pytest.mark.parametrize("fenced", [False, True])
def test_round_fn_is_one_model_layout_launch_equal_to_the_planes(dev,
                                                                 fenced):
    """One `round_fn` call moves `FUSED_KERNEL.launches` by exactly 1,
    and equals the planes' plain round (over `[Kp, R]` planes) with the
    transposes around it."""
    from node_replication_torch.core.log import log_init
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.ops.ring import fused_cursor_lattice

    R, K, W, count = 600, 1001, 64, 50
    spec = LogSpec(capacity=4096, n_replicas=R, arg_width=3, gc_slack=64)
    eng = make_hashmap(K).fused_factory(spec, device=dev)
    rng = np.random.default_rng(3 + fenced)
    log = log_init(spec, dev)
    states = {
        "values": torch.from_numpy(rng.integers(
            -1000, 1000, (R, K)).astype(np.int32)).to(dev),
        "present": torch.from_numpy(rng.random((R, K)) < 0.5).to(dev),
    }
    opc, args = _k1_model_inputs(rng, R, K, W, count, dev)
    extra = ()
    if fenced:
        mask = torch.zeros(R, dtype=torch.bool, device=dev)
        mask[[0, 127, 128, R - 1]] = True
        extra = (mask,)
    before = FUSED_KERNEL.launches
    lm, sm, rm = eng.round_fn(W, fenced)(log, states, opc, args, count,
                                         *extra)
    assert FUSED_KERNEL.launches == before + 1
    vt = torch.zeros((-(-K // 8) * 8, R), dtype=torch.int32, device=dev)
    vt[:K] = states["values"].T
    pt = torch.zeros_like(vt)
    pt[:K] = states["present"].T
    fen = extra[0].to(torch.int32) if fenced else None
    ro, ra, vt, pt, rr = hashmap_fused_round_plain(
        spec, log.tail, count, opc, args, log.opcodes, log.args, vt, pt, K,
        fen)
    lr = fused_cursor_lattice(log._replace(opcodes=ro, args=ra), count,
                              *extra)
    torch.cuda.synchronize()
    for f in lr._fields:
        assert torch.equal(getattr(lm, f), getattr(lr, f)), f
    assert torch.equal(sm["values"], vt[:K].T)
    assert torch.equal(sm["present"], (pt[:K] > 0).T)
    want = rr.T.clone()
    if fenced:
        want[extra[0]] = 0
    assert torch.equal(rm, want)


# ------------------------------------------------- flat vspace (K4, K7a, K5)


def _vs_window(rng, W, P, S, dev, kind="mixed"):
    """Spans ending at P-1 and wrapping through 0, vpages near 2^31,
    pframes near 2^31 (int32 wrap of pframe + lane), n = 0, n < 0,
    n > max_span, NOOP and unknown opcodes. `hot`: every span in tile 1
    (pages 1024-2047), from vpages v and v - P, so that tile's list is
    the whole window. `cross`: half of the spans cross a 1024-page tile
    boundary, half start within max_span of P (from the last tile, often
    partial, through page 0 into tile 0). `noop`: every opcode 0."""
    opc = rng.choice(np.array([0, 1, 1, 2, 7, -1], np.int32), W)
    args = np.stack([rng.integers(-P, 2 * P, W),
                     rng.integers(1, 1 << 31, W),
                     rng.integers(-2, S + 4, W)], axis=1).astype(np.int32)
    k = max(1, W // 8)
    at = rng.choice(W, 5 * k if 5 * k <= W else W, replace=False)
    at = np.array_split(at, 5)
    args[at[0], 0] = P - 1 - rng.integers(0, S, len(at[0]))  # end at P-1
    args[at[1], 0] = -rng.integers(1, S + 1, len(at[1]))      # wrap via 0
    args[at[2], 0] = 2 ** 31 - 1 - rng.integers(0, S, len(at[2]))
    args[at[3], 1] = 2 ** 31 - 1 - rng.integers(0, S, len(at[3]))
    args[at[4], 2] = 0
    if kind == "hot":
        opc = rng.choice(np.array([1, 1, 2], np.int32), W)
        args[:, 0] = (rng.integers(1024, min(2048, P) - S + 1, W)
                      - P * rng.integers(0, 2, W))
        args[:, 2] = rng.integers(1, S + 1, W)
    elif kind == "cross":
        half = np.arange(W) < W // 2
        edge = 1024 * rng.integers(1, max(2, -(-P // 1024)), W)
        args[:, 0] = np.where(half, edge, P) - rng.integers(1, S + 1, W)
    elif kind == "noop":
        opc[:] = 0
    return (torch.from_numpy(opc).to(dev), torch.from_numpy(args).to(dev))


def _vs_frames(rng, shape, dev):
    f = rng.integers(1, 1 << 30, shape).astype(np.int32)
    f[rng.random(shape) < 0.5] = 0
    return torch.from_numpy(f).to(dev)


# K4/K7a/K5 tile 1024 pages x 64 replica rows and scan the window in
# chunks of 1024: R = 17, 65, 257 leave a short last group; hot windows
# put a list as long as W (three chunks) on one tile; P = 2^18 + 1500
# and P = 1500 end in a partial tile (the kernel layout's rows pass P);
# P = 1501 in the model layout is a row that is not whole 16-byte words
# (the 4-byte copies), as are unaligned planes; P = 300 is one tile, so
# a wrapped span lands in the tile it started in; S = P (3000) gives
# spans that meet three tiles or more; W = 0 copies the state
@pytest.mark.parametrize("R,P,S,W,layout,window", [
    (1, 300, 5, 7, "model", "mixed"), (3, 600, 8, 300, "kernel", "mixed"),
    (33, 4096, 64, 2500, "model", "mixed"),
    (256, 1 << 14, 64, 1100, "kernel", "mixed"),
    (17, 4096, 64, 3000, "model", "hot"),
    (65, 1 << 14, 64, 2500, "kernel", "hot"),
    (3, 1500, 20, 500, "model", "noop"), (4, 1500, 20, 0, "model", "mixed"),
    (5, (1 << 18) + 1500, 64, 2000, "kernel", "mixed"),
    (2, (1 << 18) + 1500, 64, 1500, "kernel", "cross"),
    (2, 1500, 20, 300, "model", "cross"), (6, 1501, 20, 300, "model", "mixed"),
    (3, 1500, 20, 300, "model", "unaligned"),
    (257, 4096, 64, 700, "kernel", "cross"),
    (65, 300, 64, 500, "model", "mixed"),
    (3, 3000, 3000, 200, "model", "mixed"),
])
def test_vspace_replay_kernel_equals_plain(dev, R, P, S, W, layout, window):
    from node_replication_torch.ops.vspace import (
        REPLAY_KERNEL,
        grid_rows,
        vspace_replay,
        vspace_replay_plain,
    )

    rng = np.random.default_rng(R + W)
    opc, args = _vs_window(rng, W, P, S, dev, window)
    shape = (R, P) if layout == "model" else (R, grid_rows(P), 128)
    frames = _vs_frames(rng, shape, dev)  # the padding is copied through
    if window == "unaligned":
        frames = _unaligned(frames)
    before = REPLAY_KERNEL.launches
    got = vspace_replay(opc, args, frames, P, S)
    torch.cuda.synchronize()
    want = vspace_replay_plain(opc, args, frames, P, S)
    assert REPLAY_KERNEL.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# the contract takes any R; the plan step passes R = 1, model layout
@pytest.mark.parametrize("P,S,W,R,layout,window", [
    (300, 5, 33, 1, "model", "mixed"), (1 << 18, 64, 4096, 1, "model",
                                        "mixed"),
    (4096, 64, 3000, 1, "model", "hot"), (1500, 20, 500, 1, "model", "noop"),
    (1500, 20, 0, 1, "model", "mixed"), (1501, 20, 300, 1, "model", "cross"),
    (1500, 20, 300, 1, "model", "unaligned"),
    ((1 << 18) + 1500, 64, 2000, 1, "kernel", "cross"),
    (4096, 64, 700, 17, "model", "mixed"), (1500, 20, 300, 65, "kernel",
                                            "cross"),
])
def test_vspace_plan_kernel_equals_plain(dev, P, S, W, R, layout, window):
    from node_replication_torch.ops.vspace import (
        PLAN_KERNEL,
        grid_rows,
        vspace_plan_replay,
        vspace_plan_replay_plain,
    )

    rng = np.random.default_rng(P + W)
    opc, args = _vs_window(rng, W, P, S, dev, window)
    shape = (R, P) if layout == "model" else (R, grid_rows(P), 128)
    frames = _vs_frames(rng, shape, dev)
    touched = torch.from_numpy(
        (rng.random(shape) < 0.1).astype(np.int32)).to(dev)
    if window == "unaligned":
        frames, touched = _unaligned(frames), _unaligned(touched)
    before = PLAN_KERNEL.launches
    got = vspace_plan_replay(opc, args, frames, touched, P, S)
    torch.cuda.synchronize()
    want = vspace_plan_replay_plain(opc, args, frames, touched, P, S)
    assert PLAN_KERNEL.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# R = 65: a group of 64 rows and one of 1; count < W leaves NOOP tails
# (count is drawn from [0, W])
@pytest.mark.parametrize("P,S,R,W,window", [
    (600, 8, 37, 96, "mixed"), (1500, 20, 65, 96, "cross"),
    (4096, 64, 65, 128, "hot"), (1501, 20, 17, 64, "noop"),
])
def test_vspace_fused_kernel_equals_plain_across_ring_wrap(dev, P, S, R, W,
                                                           window):
    from node_replication_torch.ops.vspace import (
        FUSED_KERNEL,
        vspace_fused_round,
        vspace_fused_round_plain,
    )

    spec = LogSpec(capacity=256, n_replicas=R, arg_width=3, gc_slack=64)
    rng = np.random.default_rng(3)
    ring_opc = torch.from_numpy(
        rng.integers(0, 3, 256).astype(np.int32)).to(dev)
    ring_args = torch.from_numpy(
        rng.integers(-9, 9, (256, 3)).astype(np.int32)).to(dev)
    frames = _vs_frames(rng, (R, P), dev)
    kern = plain = (ring_opc, ring_args, frames)
    tail = 230  # the first round already wraps the 256-slot ring
    before = FUSED_KERNEL.launches
    for rnd in range(10):
        count = int(rng.integers(0, W + 1))
        opc, args = _vs_window(rng, W, P, S, dev, window)
        opc[count:] = 0
        t = torch.tensor(tail, dtype=torch.int64, device=dev)
        out_k = vspace_fused_round(spec, t, count, opc, args, *kern, P, S)
        out_p = vspace_fused_round_plain(spec, t, count, opc, args,
                                         *plain, P, S)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b), rnd
        kern, plain = out_k[:3], out_p[:3]
        tail += count
    assert FUSED_KERNEL.launches == before + 10
    assert tail > 256 + 230


# ----------------------------------------------- radix vspace (K6, K7b)


def _radix_window(rng, W, P, S, dev, kind="mixed"):
    """All four write kinds plus NOOP and unknown opcodes; vpages in
    [-P, 2P) (negative and >= P wrap through the mod), spans of n <= 0
    and n > max_span, spans that cross a PD boundary or pass P, and
    teardowns (of unallocated regions too). `hot`: every entry writes
    pages of tile 1 (pages 1024-2047) and no other, so one tile's list is
    the whole window. `late`: unmaps, teardowns and maps of n <= 0 up to
    entry 3W/4, there the first live MAP (under PDPT entry 1), then the
    mix: with the upper levels unset nothing walks before it, and after
    it only the tiles whose PDPT entry a MAP has set."""
    opc = rng.choice(np.array([0, 1, 2, 3, 4, 4, 7, -1], np.int32), W)
    args = np.stack([rng.integers(-P, 2 * P, W),
                     rng.integers(-(1 << 31), 1 << 31, W),
                     rng.integers(-2, S + 4, W)], axis=1).astype(np.int32)
    k = max(1, W // 8)
    at = np.array_split(rng.choice(W, min(W, 3 * k), replace=False), 3)
    args[at[0], 0] = 512 * rng.integers(1, max(2, P // 512), len(at[0])) \
        - rng.integers(1, S + 1, len(at[0]))           # cross a PD boundary
    args[at[1], 0] = P - rng.integers(1, S + 1, len(at[1]))   # pass P
    args[at[2], 2] = S                                  # full spans
    if kind == "hot":
        opc = rng.choice(np.array([1, 2, 3, 4], np.int32), W)
        args[:, 0] = (rng.integers(1024, min(2049 - S, P), W)
                      + P * rng.integers(-1, 2, W))
        args[:, 1] = np.where(opc == 3, rng.integers(1, S + 1, W),
                              args[:, 1])
        args[:, 2] = rng.integers(1, S + 1, W)
    elif kind == "late":
        head = 3 * W // 4
        opc[:head] = rng.choice(np.array([1, 2, 3, 4], np.int32), head)
        args[:head, 1] = np.where(opc[:head] == 3,
                                  rng.integers(1, S + 1, head),
                                  args[:head, 1])
        args[:head, 2] = rng.integers(-2, 1, head)
        opc[head] = 1
        args[head] = ((1 << 18) + 4096, 7, S)
    return (torch.from_numpy(opc).to(dev), torch.from_numpy(args).to(dev))


def _radix_levels(rng, P, dev, upper):
    from node_replication_torch.ops.vspace import levels

    l2, l3, _ = levels(P)
    pd = (rng.random(l2) < 0.5).astype(np.int32)
    pdpt = (rng.random(l3) < 0.5).astype(np.int32) if upper else \
        np.zeros(l3, np.int32)
    pml4 = np.array([int(upper)], np.int32)
    return [torch.from_numpy(a).to(dev) for a in (pd, pdpt, pml4)]


# K6/K7b tile 1024 pages x 16 replica rows and scan the window in chunks
# of 1024: hot windows put a list as long as W (three chunks) on one
# tile; R = 20, 17, 33 are not multiples of 16; P = 2^20 + 1500 puts tiles
# under five PDPT entries; P = 1501 in the model layout is a row that is
# not whole 16-byte words (the 4-byte copies); W = 0 copies the state
@pytest.mark.parametrize("R,P,S,W,layout,upper,window", [
    (1, 1500, 20, 64, "model", True, "mixed"),
    (3, 1500, 20, 700, "kernel", False, "mixed"),
    (33, 4096, 64, 1100, "model", True, "mixed"),
    (4, (1 << 18) + 3000, 64, 1500, "kernel", False, "mixed"),
    (256, 1 << 14, 64, 1100, "kernel", True, "mixed"),
    (20, 4096, 64, 3000, "model", True, "hot"),
    (17, 1 << 14, 64, 2500, "kernel", False, "hot"),
    (1, 1501, 20, 300, "model", True, "hot"),
    (3, (1 << 19) + 5000, 64, 2000, "kernel", False, "late"),
    (18, (1 << 19) + 5000, 64, 1200, "model", False, "late"),
    (5, (1 << 20) + 1500, 64, 1500, "kernel", False, "mixed"),
    (2, (1 << 20) + 1500, 64, 600, "model", True, "mixed"),
    (4, 1500, 20, 0, "model", True, "mixed"),
    (6, 1501, 20, 300, "model", False, "mixed"),
])
def test_vspace_radix_kernel_equals_plain(dev, R, P, S, W, layout, upper,
                                          window):
    from node_replication_torch.ops.vspace import (
        RADIX_KERNEL,
        grid_rows,
        vspace_radix_replay,
        vspace_radix_replay_plain,
    )

    rng = np.random.default_rng(R + W + P)
    opc, args = _radix_window(rng, W, P, S, dev, window)
    shape = (R, P) if layout == "model" else (R, grid_rows(P), 128)
    pt = _vs_frames(rng, shape, dev)
    lv = _radix_levels(rng, P, dev, upper)
    before = RADIX_KERNEL.launches
    got = vspace_radix_replay(opc, args, pt, *lv, P, S)
    torch.cuda.synchronize()
    want = vspace_radix_replay_plain(opc, args, pt, *lv, P, S)
    assert RADIX_KERNEL.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P,S,W,upper,window", [
    (1500, 20, 64, True, "mixed"),
    ((1 << 18) + 3000, 64, 4096, False, "mixed"),
    (4096, 64, 3000, True, "hot"), ((1 << 19) + 5000, 64, 2000, False, "late"),
    ((1 << 20) + 1500, 64, 1500, False, "mixed"), (1500, 20, 0, True, "mixed"),
    (1501, 20, 300, False, "mixed"),
])
def test_vspace_radix_plan_kernel_equals_plain(dev, P, S, W, upper, window):
    from node_replication_torch.ops.vspace import (
        RADIX_PLAN_KERNEL,
        vspace_radix_plan_replay,
        vspace_radix_plan_replay_plain,
    )

    rng = np.random.default_rng(P + W)
    opc, args = _radix_window(rng, W, P, S, dev, window)
    pt = _vs_frames(rng, (1, P), dev)
    lv = _radix_levels(rng, P, dev, upper)
    bits = lambda n: torch.from_numpy(
        (rng.random(n) < 0.1).astype(np.int32)).to(dev)
    planes = (bits((1, P)), bits((1, P)), bits(lv[0].shape))
    before = RADIX_PLAN_KERNEL.launches
    got = vspace_radix_plan_replay(opc, args, pt, *lv, *planes, P, S)
    torch.cuda.synchronize()
    want = vspace_radix_plan_replay_plain(opc, args, pt, *lv, *planes, P, S)
    assert RADIX_PLAN_KERNEL.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------- open-addressing map (K3)


def _oa_colliding_keys(n_slots, count, near=None, seed=0):
    """`count` distinct keys sharing one home slot (or homes within
    `near` slots of n_slots, whose windows wrap), found by hashing."""
    from node_replication_torch.models.oahashmap import _mix

    rng = np.random.default_rng(seed)
    cand = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 1 << 20)
                            .astype(np.int32))
    home = torch.remainder(_mix(cand), n_slots)
    if near is not None:
        return cand[home >= n_slots - near][:count].numpy()
    target = int(home[0])
    return cand[home == target][:count].numpy()


@pytest.mark.parametrize("R,N,probe,W", [(3, 300, 8, 96), (33, 4096, 16, 2000),
                                         (4, 1 << 16, 128, 3000)])
def test_oahashmap_kernel_equals_plain(dev, R, N, probe, W):
    from node_replication_torch.ops.oahashmap import (
        REPLAY_KERNEL,
        grid_rows,
        oahashmap_replay,
        oahashmap_replay_plain,
    )

    rng = np.random.default_rng(R + N)
    same_home = _oa_colliding_keys(N, probe + 2)
    pool = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, max(4, N // 4)).astype(np.int32),
        same_home, _oa_colliding_keys(N, 8, probe)])
    opc = rng.choice(np.array([0, 1, 1, 2, 5], np.int32), W)
    args = np.stack([rng.choice(pool, W), rng.integers(-99, 99, W),
                     np.zeros(W)], axis=1).astype(np.int32)
    # PUTs of more distinct same-home keys than the window holds: the
    # ones that find neither their key nor a free slot drop (-2)
    opc[:len(same_home)] = 1
    args[:len(same_home), 0] = same_home
    rows = grid_rows(N)
    planes = []
    for hi in (1 << 31, 1 << 31, 3):
        p = rng.integers(-hi if hi > 3 else 0, hi, (R, rows * 128))
        planes.append(torch.from_numpy(p.astype(np.int32)).reshape(
            R, rows, 128).to(dev))
    # occupied slots hold keys from the pool, so matches occur
    planes[0] = torch.where(planes[2] == 1, torch.from_numpy(
        rng.choice(pool, (R, rows, 128))).to(dev), planes[0])
    o, a = torch.from_numpy(opc).to(dev), torch.from_numpy(args).to(dev)
    before = REPLAY_KERNEL.launches
    got = oahashmap_replay(o, a, *planes, N, probe)
    torch.cuda.synchronize()
    want = oahashmap_replay_plain(o, a, *planes, N, probe)
    assert REPLAY_KERNEL.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert (want[3] == -2).any() == (len(same_home) > probe)


def test_serve_frontend_over_k1_equals_the_chain(dev):
    """A small `ServeFrontend` over a hashmap fleet that forces the fused
    tier (every round one K1 launch) against the same closed-loop stream
    over a chain fleet, at both pipeline depths: every response and
    read, the ring, the cursors and the states are equal, and every
    write round of the K1 fleet was a K1 launch."""
    from node_replication_torch.core.replica import NodeReplicated
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    K, R = 37, 5
    rng = np.random.default_rng(77)
    stream = []
    for _ in range(400):
        rid = int(rng.integers(R))
        if rng.random() < 0.8:
            stream.append(("w", (int(rng.integers(1, 3)),
                                 int(rng.integers(-K, 2 * K)),
                                 int(rng.integers(1 << 20))), rid))
        else:
            stream.append(("r", (1, int(rng.integers(K))), rid))
    n_writes = sum(k == "w" for k, _, _ in stream)
    for depth in (0, 1):
        fleets, outs = [], []
        for engine in ("pallas", "combined"):
            nr = NodeReplicated(make_hashmap(K), n_replicas=R,
                                log_entries=256, gc_slack=16,
                                engine=engine, device=dev)
            before = FUSED_KERNEL.launches
            fe = ServeFrontend(nr, ServeConfig(batch_linger_s=0.0,
                                               pipeline_depth=depth))
            out = []
            for kind, op, rid in stream:
                out.append(fe.submit(op, rid=rid).result(timeout=60.0)
                           if kind == "w" else fe.read(op, rid=rid))
            fe.close()
            launched = FUSED_KERNEL.launches - before
            assert launched == (n_writes if engine == "pallas" else 0)
            assert nr.stats()["fused_rounds"] == launched
            nr.sync()
            fleets.append(nr)
            outs.append(out)
        assert outs[0] == outs[1]
        k1, chain = fleets
        assert int(k1.log.tail) == n_writes > 256  # the ring wrapped
        for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
            assert torch.equal(getattr(k1.log, f), getattr(chain.log, f)), f
        for f in ("values", "present"):
            assert torch.equal(k1.states[f], chain.states[f]), f


@pytest.mark.parametrize("R,K,L", [(5, 37, 3), (33, 1000, 8)])
def test_cnr_per_log_rounds_over_k1_equal_the_scan_tier(dev, R, K, L):
    """`MultiLogReplicated` over a hashmap on the fused tier: every
    per-log sub-batch is one K1 launch on that log's row of the stacked
    ring, against the scan tier on the same batches (rotating rids,
    sub-batches of 1 to 64 ops, the rings wrapping): responses, every
    ring and cursor row, and every replica's state are equal."""
    from node_replication_torch.core.cnr import MultiLogReplicated
    from node_replication_torch.models import make_hashmap

    mapper = lambda opc, args: args[0]  # noqa: E731
    fleets = {e: MultiLogReplicated(make_hashmap(K), mapper, nlogs=L,
                                    n_replicas=R, log_entries=256,
                                    gc_slack=16, engine=e, device=dev)
              for e in ("pallas", "scan")}
    rng = np.random.default_rng(R)
    before = FUSED_KERNEL.launches
    for i in range(40):
        n = int(rng.integers(1, 64 * L // 4))
        ops = [(int(rng.integers(1, 3)), int(rng.integers(-K, 2 * K)),
                int(rng.integers(1 << 20))) for _ in range(n)]
        rid = i % R
        outs = [f.execute_mut_batch(ops, rid) for f in fleets.values()]
        assert outs[0] == outs[1]
    k1, scan = fleets["pallas"], fleets["scan"]
    st = k1.stats()
    assert st["exec_rounds"] == 0
    assert FUSED_KERNEL.launches - before == st["fused_rounds"] \
        == sum(st["combine_rounds"])
    assert max(st["tails"]) > 256  # the rings wrapped
    scan.sync()
    for f in k1.ml._fields:
        assert torch.equal(getattr(k1.ml, f), getattr(scan.ml, f)), f
    for f in ("values", "present"):
        assert torch.equal(k1.states[f], scan.states[f]), f


# ------------------------------------------------ mesh-fused (K1, K5 per shard)


def _mesh_fleets(make, dev, devices, R, **kw):
    """(meshed pallas fleet over `devices`, un-meshed pallas fleet,
    un-meshed chain fleet) of one model."""
    from node_replication_torch.core.replica import NodeReplicated
    from node_replication_torch.parallel import replica_mesh

    mesh = replica_mesh(len(devices), devices=devices)
    return (
        NodeReplicated(make(), n_replicas=R, engine="pallas", mesh=mesh,
                       **kw),
        NodeReplicated(make(), n_replicas=R, engine="pallas", device=dev,
                       **kw),
        NodeReplicated(make(), n_replicas=R, engine="combined",
                       device=dev, **kw),
    )


def _fleets_equal(a, b):
    for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
        assert torch.equal(getattr(a.log, f).to(b.log.tail.device),
                           getattr(b.log, f)), f
    for f in b.states:
        assert torch.equal(a.states[f].to(b.log.tail.device),
                           b.states[f]), f


def _k1_mesh_run(dev, devices, fenced):
    from node_replication_torch.models import make_hashmap

    K, R = 37, 8
    fleets = _mesh_fleets(lambda: make_hashmap(K), dev, devices, R,
                          log_entries=256, gc_slack=32)
    meshed = fleets[0]
    rng = np.random.default_rng(11 + fenced)
    before = FUSED_KERNEL.launches
    rounds = 0
    for rnd in range(24):
        if fenced and rnd == 8:
            for nr in fleets:
                nr.fence_replica(5)  # shard 2 of 4: not the combiner's
        if fenced and rnd == 16:
            for nr in fleets:
                nr.clone_replica_from(5, donor=0)
                nr.unfence_replica(5)
        n = int(rng.integers(8, 32))
        ops = [(int(rng.integers(1, 3)), int(rng.integers(-K, 2 * K)),
                int(rng.integers(1 << 20))) for _ in range(n)]
        fused_before = meshed.stats()["fused_rounds"]
        outs = [nr.execute_mut_batch(ops, rid=rnd % 4) for nr in fleets]
        assert outs[0] == outs[1] == outs[2], rnd
        if meshed.stats()["fused_rounds"] > fused_before:
            rounds += 1
            assert meshed.last_round_tier == "mesh_fused"
    torch.cuda.synchronize()
    # one K1 launch per shard for each meshed round, and one for each of
    # the un-meshed pallas fleet's rounds
    launched = FUSED_KERNEL.launches - before
    assert launched == len(devices) * rounds + \
        fleets[1].stats()["fused_rounds"]
    assert int(meshed.log.tail) > 256  # the ring wrapped
    for nr in fleets:
        nr.sync()
    _fleets_equal(meshed, fleets[1])
    _fleets_equal(meshed, fleets[2])
    return rounds


@pytest.mark.parametrize("fenced", [False, True])
def test_meshed_k1_rounds_equal_unmeshed_and_plain(dev, fenced):
    """`NodeReplicated(mesh=)` on 4 shards of one card, engine 'pallas':
    every round one K1 launch per shard, against the un-meshed K1 fleet
    and the plain chain, fenced (the corpse on shard 2) and across a
    ring wrap."""
    assert _k1_mesh_run(dev, [dev] * 4, fenced) >= 20


def test_meshed_k5_rounds_equal_unmeshed_and_plain(dev):
    """The flat vspace on 4 shards of one card: every round 4 K5
    launches, equal to the un-meshed K5 fleet and the plain chain; a
    fenced stretch falls back to the chain (K5 has no fenced variant)."""
    from node_replication_torch.models.vspace import make_vspace
    from node_replication_torch.ops.vspace import FUSED_KERNEL as K5

    P, S, R = 1024, 8, 8
    fleets = _mesh_fleets(lambda: make_vspace(P, max_span=S), dev,
                          [dev] * 4, R, log_entries=256, gc_slack=32)
    meshed = fleets[0]
    rng = np.random.default_rng(5)
    for rnd in range(20):
        if rnd == 14:
            for nr in fleets:
                nr.fence_replica(6)
        before = K5.launches
        n = int(rng.integers(8, 32))
        ops = []
        for _ in range(n):
            if rng.random() < 0.7:
                ops.append((1, int(rng.integers(-P, 2 * P)),
                            int(rng.integers(1, 1000)),
                            int(rng.integers(0, S + 2))))
            else:
                ops.append((2, int(rng.integers(-P, 2 * P)),
                            int(rng.integers(0, S + 2))))
        out_m = meshed.execute_mut_batch(ops, rid=0)
        torch.cuda.synchronize()
        assert K5.launches - before == (4 if rnd < 14 else 0), rnd
        outs = [nr.execute_mut_batch(ops, rid=0) for nr in fleets[1:]]
        assert out_m == outs[0] == outs[1], rnd
    assert int(meshed.log.tail) > 256  # the ring wrapped
    for nr in fleets:
        nr.sync()
    _fleets_equal(meshed, fleets[1])
    _fleets_equal(meshed, fleets[2])


def test_kernels_launch_on_the_card_of_their_tensors(dev):
    """With two cards, a kernel given tensors on `cuda:1` while the
    current device is `cuda:0` launches on `cuda:1` (each wrapper enters
    `torch.cuda.device(tensor.device)`), and a mesh with one shard on
    each card equals the one-card fleet. One card cannot show this."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the launch-device repair "
                    "shows only across cards")
    d1 = torch.device("cuda", 1)
    K, R, W = 29, 70, 64
    spec = LogSpec(capacity=256, n_replicas=R, arg_width=3, gc_slack=64)
    rng = np.random.default_rng(3)
    ring_opc = torch.from_numpy(
        rng.integers(0, 3, 256).astype(np.int32)).to(d1)
    ring_args = torch.from_numpy(
        rng.integers(-9, 9, (256, 3)).astype(np.int32)).to(d1)
    v, p = _planes(rng, K, R, d1)
    vm = v[:K].T.contiguous()
    pm = (p[:K] > 0).T.contiguous()
    opc, key, val = _window(rng, W, K, d1)
    args = torch.stack([key, val, torch.zeros_like(key)], 1)
    t = torch.tensor(200, dtype=torch.int64, device=d1)
    with torch.cuda.device(0):
        out_k = hashmap_fused_round_model(spec, t, W, opc, args, ring_opc,
                                          ring_args, vm, pm, K)
        out_r = hashmap_replay(opc, key, val, v, p, K)
    torch.cuda.synchronize(d1)
    for a, b in zip(out_k, hashmap_fused_round_model_plain(
            spec, t, W, opc, args, ring_opc, ring_args, vm, pm, K)):
        assert a.device == d1 and torch.equal(a, b)
    for a, b in zip(out_r, hashmap_replay_plain(opc, key, val, v, p, K)):
        assert torch.equal(a, b)
    cards = [torch.device("cuda", i % 2) for i in range(4)]
    assert _k1_mesh_run(torch.device("cuda", 0), cards, True) >= 20
