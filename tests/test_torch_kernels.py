"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips with a reason where there is no CUDA
device (decided inside the fixture, never at import). The real check at
the flagship shapes is `chip_smoke.py`; these cover the edges at small
shapes: replica counts that are not a multiple of a warp, windows past
one shared-memory chunk, negative keys, ring wrap, fenced lanes. Every
value is an integer, so the tolerance is 0.

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
    hashmap_fused_round,
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


def _window(rng, W, K, dev):
    opc = rng.choice(np.array([0, 1, 2, 7], np.int32), W)
    key = rng.integers(-3 * K, 3 * K, W).astype(np.int32)
    val = rng.integers(-1000, 1000, W).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (opc, key, val)]


def _planes(rng, K, R, dev):
    kp = -(-K // 8) * 8
    v = rng.integers(-50, 50, (kp, R)).astype(np.int32)
    p = (rng.random((kp, R)) < 0.5).astype(np.int32)
    return torch.from_numpy(v).to(dev), torch.from_numpy(p).to(dev)


@pytest.mark.parametrize("R,K,W", [(1, 5, 7), (33, 13, 300),
                                   (64, 64, 2500), (100, 1, 40)])
def test_replay_kernel_equals_plain(dev, R, K, W):
    rng = np.random.default_rng(R * 1000 + W)
    opc, key, val = _window(rng, W, K, dev)
    v, p = _planes(rng, K, R, dev)
    before = REPLAY_KERNEL.launches
    got = hashmap_replay(opc, key, val, v, p, K)
    torch.cuda.synchronize()
    want = hashmap_replay_plain(opc, key, val, v, p, K)
    assert REPLAY_KERNEL.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fenced", [False, True])
def test_fused_kernel_equals_plain_across_ring_wrap(dev, fenced):
    K, R, W = 29, 70, 64
    spec = LogSpec(capacity=256, n_replicas=R, arg_width=3, gc_slack=64)
    rng = np.random.default_rng(7 + fenced)
    ring_opc = torch.from_numpy(
        rng.integers(0, 3, 256).astype(np.int32)).to(dev)
    ring_args = torch.from_numpy(
        rng.integers(-9, 9, (256, 3)).astype(np.int32)).to(dev)
    v, p = _planes(rng, K, R, dev)
    fen = None
    if fenced:
        fen = torch.zeros(R, dtype=torch.int32, device=dev)
        fen[[0, 31, 32, 69]] = 1
    kern = (ring_opc, ring_args, v, p)
    plain = (ring_opc, ring_args, v, p)
    tail = 200  # the first round already wraps the 256-slot ring
    before = FUSED_KERNEL.launches
    for rnd in range(12):
        count = int(rng.integers(0, W + 1))
        opc, key, val = _window(rng, W, K, dev)
        opc[count:] = 0
        args = torch.stack([key, val, torch.zeros_like(key)], 1)
        t = torch.tensor(tail, dtype=torch.int64, device=dev)
        out_k = hashmap_fused_round(spec, t, count, opc, args, *kern, K,
                                    fen)
        out_p = hashmap_fused_round_plain(spec, t, count, opc, args,
                                          *plain, K, fen)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b), rnd
        kern, plain = out_k[:4], out_p[:4]
        tail += count
    assert FUSED_KERNEL.launches == before + 12
    assert tail > 256 + 200
