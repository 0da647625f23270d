"""`encode_ops` (`node_replication_torch/ops/encoding.py`) against the
reference's (`node_replication_tpu/ops/encoding.py`), element for
element: values, shapes, dtypes and `count`, over uniform and ragged
batches, paddings, arg widths, numpy opcodes and int32 extremes; its
errors; and the layout of what it returns, two contiguous views of one
buffer, each starting 16-byte aligned."""

import gc

import numpy as np
import pytest
import torch

from node_replication_tpu.ops.encoding import encode_ops as j_encode

from node_replication_torch.ops.encoding import encode_ops as t_encode

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
HM_PUT, HM_REMOVE = 1, 2
VS_MAP, VS_UNMAP = 1, 2


def _hashmap(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(HM_PUT, int(rng.integers(10000)), int(rng.integers(2**31)))
            if rng.random() < 0.5 else (HM_REMOVE, int(rng.integers(10000)))
            for _ in range(n)]


def _vspace(n, seed=0):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        vpage, pframe = int(rng.integers(2**18)), int(rng.integers(2**31))
        ops.append((VS_MAP, vpage, 1 + pframe % 64, pframe)
                   if rng.random() < 0.75 else (VS_UNMAP, vpage, 64))
    return ops


CASES = {
    "uniform": ([(HM_PUT, k, 7 * k) for k in range(9)], 3, None),
    "uniform-padded": ([(HM_PUT, k, 7 * k) for k in range(9)], 3, 16),
    "hashmap-ragged": (_hashmap(256), 3, 256),
    "hashmap-ragged-padded": (_hashmap(200, seed=1), 3, 256),
    "vspace-ragged": (_vspace(1024), 3, 1024),
    "vspace-ragged-padded": (_vspace(5, seed=2), 3, 8),
    "ragged-lists": ([[3], [1, 2], [2, 4, 5, 6]], 3, 3),
    "empty-pad-1": ([], 3, 1),
    "empty-unpadded": ([], 3, None),
    "arg-width-1": ([(1, 5), (2,), (3, -5)], 1, 4),
    "arg-width-1-opcodes-only": ([(1,), (2,)], 1, 2),
    "numpy-opcodes": ([(np.int32(1), 2, 3), (np.int64(2), 4),
                       (np.uint8(3), 5, 6), (np.True_, 7)], 3, 4),
    "numpy-args": ([(1, np.int64(-3), np.int32(9)), (2, np.int16(4))], 3, 2),
    "int32-extremes": ([(I32_MAX, I32_MIN, I32_MAX, I32_MIN),
                        (I32_MIN, I32_MAX), (1, -1, 0)], 3, 5),
    "odd-pad": ([(1, 2, 3)] * 3, 3, 3),
    "arity-changes-past-a-chunk": ([(2, k) for k in range(300)]
                                   + [(1, 5, 6, 7)] * 20, 3, 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_reference(case):
    ops, arg_width, pad_to = CASES[case]
    j_opc, j_args, j_n = j_encode(ops, arg_width, pad_to=pad_to)
    t_opc, t_args, t_n = t_encode(ops, arg_width, pad_to=pad_to,
                                  device="cpu")
    assert t_n == j_n == len(ops)
    for j, t in ((j_opc, t_opc), (j_args, t_args)):
        j = np.asarray(j)
        assert t.dtype == torch.int32 and j.dtype == np.int32
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("ops, pad_to", [
    ([(1, 2, 3)] * 5, 4),
    ([(1, 2)], 0),
])
def test_more_ops_than_pad_to_raise(ops, pad_to):
    with pytest.raises(ValueError, match="do not fit"):
        t_encode(ops, 3, pad_to=pad_to, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        j_encode(ops, 3, pad_to=pad_to)


@pytest.mark.parametrize("ops, arg_width", [
    ([(1, 2, 3, 4, 5)], 3),
    ([(1, 2), (1, 2, 3)], 1),
    ([(1, 2, 3)] * 3 + [(1, 2, 3, 4, 5, 6)], 3),
    ([(1, 2, 3)] * 300 + [(1, 2, 3, 4, 5)], 3),
])
def test_a_too_wide_op_raises(ops, arg_width):
    with pytest.raises(ValueError, match="does not fit"):
        t_encode(ops, arg_width, device="cpu")
    with pytest.raises((ValueError, TypeError)):  # the reference's reshape
        j_encode(ops, arg_width)


@pytest.mark.parametrize("op", [
    (1, 2**31), (1, 0, I32_MIN - 1), (2**31, 0), (I32_MIN - 1,),
    (1, np.int64(2**31)), (np.int64(2**31), 1),
])
def test_a_value_outside_int32_raises_overflow(op):
    with pytest.raises(OverflowError):
        t_encode([(1, 2, 3), op], 3, pad_to=4, device="cpu")


@pytest.mark.parametrize("n, pad_to, arg_width", [
    (0, 1, 3), (1, 1, 3), (3, 3, 3), (5, 8, 3), (7, 7, 1), (256, 256, 3),
    (1000, 1024, 3),
])
def test_one_buffer_two_aligned_contiguous_views(n, pad_to, arg_width):
    ops = [(1, i) for i in range(n)]
    opc, args, _ = t_encode(ops, arg_width, pad_to=pad_to, device="cpu")
    assert opc.is_contiguous() and args.is_contiguous()
    assert opc.data_ptr() % 16 == 0 and args.data_ptr() % 16 == 0
    assert (opc.untyped_storage().data_ptr()
            == args.untyped_storage().data_ptr())
    assert args.data_ptr() >= opc.data_ptr() + 4 * pad_to


def test_views_do_not_overlap_when_written():
    opc, args, _ = t_encode([(1, 2, 3), (2, 4)], 3, pad_to=3, device="cpu")
    opc.fill_(-1)
    np.testing.assert_array_equal(
        args.numpy(), [[2, 3, 0], [4, 0, 0], [0, 0, 0]])


def test_a_large_batch_sets_off_no_garbage_collection():
    """The fields stream through one op's iterator at a time: a
    transpose that made one iterator per op would set off a collection
    of the cyclic collector every ~700 ops, on every round."""
    ops = _vspace(4096, seed=3)
    started = []

    def count(phase, info):
        if phase == "start":
            started.append(info["generation"])

    was_enabled = gc.isenabled()
    gc.enable()
    gc.collect()
    gc.callbacks.append(count)
    try:
        t_encode(ops, 3, pad_to=4096, device="cpu")
    finally:
        gc.callbacks.remove(count)
        if not was_enabled:
            gc.disable()
    assert started == []
