"""The hashmap's replay and fused-round kernels, their plain versions,
and the engines built on them (PyTorch + CUDA).

The port of `node_replication_tpu/ops/pallas_replay.py`. State is laid
out transposed, `[Kp, R]` (keys on rows, replicas on columns, Kp = K
rounded up to 8), as in the reference: replay touches one key per
entry but every replica at once.

Two kernels, one CUDA source (`csrc/hashmap_replay.cu`, whose header
says what bounds them and how they are laid out):

- `hashmap_replay` (replaces `_replay_kernel`, K2): in-order replay of
  a window into every replica's column; used by `make_hashmap_replay`
  and `make_pallas_step`. A block owns a tile of key rows x replica
  columns of both planes in shared memory (`replay_tile()`): it copies
  the tile in, scans the window once and keeps, in window order, the
  entries whose key lies in its rows, replays them against shared
  memory, writes their response segments and copies the tile out. It
  is bound by device-memory bytes (the state in and out and the
  responses); one launch a call.
- `hashmap_fused_round` (replaces `_fused_hashmap_kernel`, K1): one
  whole combiner round in one launch — the ring append, the replay,
  and the fenced-lane restore; used by `FusedHashmapEngine`. It keeps
  its first body: warps owning key partitions of 32-column groups, one
  dependent device-memory read-modify-write per owned entry.

Each wrapper takes its plain PyTorch version (a Python loop over the
window doing row operations on the planes) for CPU tensors ONLY; for
CUDA tensors it launches the kernel or raises, and for any other
device it raises. The kernels are built with nvcc into a shared library
with a plain C interface at first use (`ops/kernel_lib.py`), loaded with
ctypes, and launched on the current stream; each launch's
`cudaGetLastError()` is checked, and each wrapper counts its launches
(`REPLAY_KERNEL.launches`, `FUSED_KERNEL.launches`).
"""

from __future__ import annotations

import ctypes

import torch

from node_replication_torch.core.log import LogSpec, log_append
from node_replication_torch.ops.kernel_lib import (
    Kernel,
    expect,
    library,
    route,
)
from node_replication_torch.ops.ring import (
    FusedEngineHost,
    append_window_planes,
    fused_cursor_lattice,
    fused_window_ok,
)
from node_replication_torch.utils.device import resolve_device

# K1's key partitions per replica column (see the kernel's header): a
# multiple of its warps per block. K2 does not use them.
N_PART = 16


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


REPLAY_KERNEL = Kernel("hashmap_replay")
FUSED_KERNEL = Kernel("hashmap_fused_round")


def reset_launch_counts() -> None:
    REPLAY_KERNEL.launches = 0
    FUSED_KERNEL.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nr_hashmap_warps_per_block.argtypes = []
    lib.nr_hashmap_warps_per_block.restype = i
    lib.nr_hashmap_replay_tile.argtypes = [ctypes.POINTER(i)] * 3
    lib.nr_hashmap_replay_tile.restype = i
    lib.nr_hashmap_replay.argtypes = [
        p, p, p, i, i, i, i, p, p, p, p, p, p]
    lib.nr_hashmap_replay.restype = i
    lib.nr_hashmap_fused_round.argtypes = [
        p, p, i, i, i, i, i, i, p, p, p, p, p, p, p, i, i, p, p, p, p,
        p]
    lib.nr_hashmap_fused_round.restype = i
    if N_PART % lib.nr_hashmap_warps_per_block():
        raise RuntimeError("N_PART must be a multiple of the "
                           "kernel's warps per block")


def _library() -> ctypes.CDLL:
    """The kernels' library (`csrc/hashmap_replay.cu`), built at first
    use by `ops/kernel_lib.py`."""
    return library("hashmap_replay", _bind)


def replay_tile() -> dict:
    """K2's tile as built: key rows, replica columns, window entries
    scanned a pass, and its dynamic shared memory in bytes."""
    out = [ctypes.c_int() for _ in range(3)]
    smem = _library().nr_hashmap_replay_tile(
        *(ctypes.byref(c) for c in out))
    return dict(zip(("rows", "cols", "chunk"), (c.value for c in out)),
                smem_bytes=smem)


def _check_planes(opcodes, values, present, resps_rows):
    if values.dim() != 2:
        raise ValueError(f"values: expected [Kp, R], got "
                         f"{tuple(values.shape)}")
    kp, R = values.shape
    expect(opcodes, "opcodes", (resps_rows,), torch.int32)
    expect(values, "values", (kp, R), torch.int32)
    expect(present, "present", (kp, R), torch.int32)
    return kp, R


# ---------------------------------------------------------------- K2


def hashmap_replay_plain(opcodes, keys, vals, values, present,
                         n_keys: int):
    """Plain version of the replay kernel: `(values, present, resps
    int32[W, R])`, new tensors; a Python loop over the window doing row
    operations on the `[Kp, R]` planes."""
    values = values.clone()
    present = present.clone()
    W = opcodes.shape[0]
    R = values.shape[1]
    k_all = torch.remainder(keys, n_keys).long()
    resps = torch.empty((W, R), dtype=torch.int32, device=values.device)
    zero = torch.zeros((), dtype=torch.int32, device=values.device)
    one = torch.ones((), dtype=torch.int32, device=values.device)
    for i in range(W):
        k = k_all[i:i + 1]
        is_put = opcodes[i] == 1
        is_rem = opcodes[i] == 2
        row_v = values.index_select(0, k)
        row_p = present.index_select(0, k)
        values.index_copy_(0, k, torch.where(
            is_put, vals[i], torch.where(is_rem, zero, row_v)))
        present.index_copy_(0, k, torch.where(
            is_put, one, torch.where(is_rem, zero, row_p)))
        resps[i] = torch.where(is_rem, row_p[0], zero)
    return values, present, resps


def hashmap_replay(opcodes, keys, vals, values, present, n_keys: int):
    """Replay `opcodes/keys/vals int32[W]` in order into the
    `values/present int32[Kp, R]` planes: `(values, present, resps
    int32[W, R])` (new tensors)."""
    W = opcodes.shape[0]
    kp, R = _check_planes(opcodes, values, present, W)
    expect(keys, "keys", (W,), torch.int32)
    expect(vals, "vals", (W,), torch.int32)
    if not 0 < n_keys <= kp:
        raise ValueError(f"n_keys {n_keys} outside (0, Kp={kp}]")
    if route(opcodes, keys, vals, values, present) == "cpu":
        return hashmap_replay_plain(opcodes, keys, vals, values, present,
                                    n_keys)
    lib = _library()
    v_out = torch.empty_like(values)
    p_out = torch.empty_like(present)
    resps = torch.empty((W, R), dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.nr_hashmap_replay(
            opcodes.data_ptr(), keys.data_ptr(), vals.data_ptr(), W,
            n_keys, kp, R, values.data_ptr(), present.data_ptr(),
            v_out.data_ptr(), p_out.data_ptr(), resps.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"hashmap_replay launch failed: CUDA error "
                           f"{err}")
    REPLAY_KERNEL.launches += 1
    return v_out, p_out, resps


# ---------------------------------------------------------------- K1


def hashmap_fused_round_plain(spec: LogSpec, tail, count: int, opcodes,
                              args, ring_opc, ring_args, values, present,
                              n_keys: int, fenced=None):
    """Plain version of the fused-round kernel: the ring append, the
    replay, and the fenced lanes' state restored from the input."""
    ring_opc, ring_args = append_window_planes(
        spec.mask, ring_opc, ring_args, opcodes, args, tail, count)
    v, p, resps = hashmap_replay_plain(
        opcodes, args[:, 0], args[:, 1], values, present, n_keys)
    if fenced is not None:
        fen = (fenced > 0).reshape(1, -1)
        v = torch.where(fen, values, v)
        p = torch.where(fen, present, p)
    return ring_opc, ring_args, v, p, resps


def hashmap_fused_round(spec: LogSpec, tail, count: int, opcodes, args,
                        ring_opc, ring_args, values, present, n_keys: int,
                        fenced=None):
    """One combiner round: append batch entries `j < count` at ring
    slots `(tail + j) & mask`, replay the whole NOOP-padded batch into
    the planes, restore fenced lanes (`fenced int32[R]`, > 0 = fenced)
    from the input. Returns `(ring_opc, ring_args, values, present,
    resps int32[W, R])`, all new tensors. `tail` is the int64 cursor as
    a 0-d tensor on the planes' device; `count` a host int."""
    W = opcodes.shape[0]
    A = spec.arg_width
    L = spec.capacity
    kp, R = _check_planes(opcodes, values, present, W)
    expect(args, "args", (W, A), torch.int32)
    expect(ring_opc, "ring_opc", (L,), torch.int32)
    expect(ring_args, "ring_args", (L, A), torch.int32)
    expect(tail, "tail", (), torch.int64)
    if A < 2:
        raise ValueError("the hashmap needs arg_width >= 2 (key, value)")
    if not (0 <= count <= W and fused_window_ok(L, W)):
        raise ValueError(f"count {count} / window {W} do not fit a ring "
                         f"of {L} (fused_window_ok)")
    if not 0 < n_keys <= kp:
        raise ValueError(f"n_keys {n_keys} outside (0, Kp={kp}]")
    tensors = [tail, opcodes, args, ring_opc, ring_args, values, present]
    if fenced is not None:
        expect(fenced, "fenced", (R,), torch.int32)
        tensors.append(fenced)
    if route(*tensors) == "cpu":
        return hashmap_fused_round_plain(
            spec, tail, count, opcodes, args, ring_opc, ring_args, values,
            present, n_keys, fenced)
    lib = _library()
    ro = torch.empty_like(ring_opc)
    ra = torch.empty_like(ring_args)
    v_out = torch.empty_like(values)
    p_out = torch.empty_like(present)
    resps = torch.empty((W, R), dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.nr_hashmap_fused_round(
            opcodes.data_ptr(), args.data_ptr(), A, W, n_keys, kp, R,
            N_PART, values.data_ptr(), present.data_ptr(),
            v_out.data_ptr(), p_out.data_ptr(), resps.data_ptr(),
            None if fenced is None else fenced.data_ptr(),
            tail.data_ptr(), int(count), L, ring_opc.data_ptr(),
            ring_args.data_ptr(), ro.data_ptr(), ra.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"hashmap_fused_round launch failed: CUDA "
                           f"error {err}")
    FUSED_KERNEL.launches += 1
    return ro, ra, v_out, p_out, resps


# ------------------------------------------------------- replay step


def make_hashmap_replay(n_keys: int, n_replicas: int, window: int):
    """Build `replay(opcodes[W], keys[W], vals[W], values[Kp, R],
    present[Kp, R]) -> (values, present, resps[W, R])`, Kp = n_keys
    rounded up to 8. The reference tiles the replica axis for VMEM and
    its step chunks the window; the CUDA kernel takes the whole window
    and fleet in one launch."""
    kp = _round_up(n_keys, 8)

    def replay(opcodes, keys, vals, values, present):
        if tuple(values.shape) != (kp, n_replicas) \
                or opcodes.shape[0] != window:
            raise ValueError(
                f"replay built for window {window} over [{kp}, "
                f"{n_replicas}] planes, got window {opcodes.shape[0]} "
                f"over {tuple(values.shape)}"
            )
        return hashmap_replay(opcodes, keys, vals, values, present,
                              n_keys)

    return replay


def make_pallas_step(n_keys: int, spec: LogSpec, writes_per_replica: int,
                     reads_per_replica: int):
    """Kernel twin of `core/step.make_step` for the hashmap: append the
    fleet's write batch to the ring, replay it into every replica with
    the replay kernel, answer reads locally. State is `{"values":
    int32[Kp, R], "present": int32[Kp, R]}` (transposed) —
    `pallas_hashmap_state(n_keys, R)` makes one."""
    R = spec.n_replicas
    Bw = int(writes_per_replica)
    span = R * Bw
    replay = make_hashmap_replay(n_keys, R, span)

    def step(log, states, wr_opcodes, wr_args, rd_opcodes, rd_args):
        opc = wr_opcodes.reshape(span).contiguous()
        args = wr_args.reshape(span, spec.arg_width)
        log = log_append(spec, log, opc, args, span)
        values, present, resps = replay(
            opc, args[:, 0].contiguous(), args[:, 1].contiguous(),
            states["values"], states["present"],
        )
        states = {"values": values, "present": present}
        # cursors advance in lock-step (every replica replayed the span)
        log = log._replace(
            ltails=log.ltails + span,
            ctail=log.ctail + span,
            head=log.head + span,
        )
        dev = values.device
        r_idx = torch.arange(R, dtype=torch.int64, device=dev)[:, None]
        # resps is [W, R]; replica r's own writes are entries
        # [r*Bw, (r+1)*Bw)
        own = r_idx * Bw + torch.arange(Bw, dtype=torch.int64,
                                        device=dev)[None, :]
        wr_resps = resps[own, r_idx]
        # reads: gather values[k, r] per (replica, read slot)
        k = torch.remainder(rd_args[..., 0], n_keys).long()
        vals = values[k, r_idx]
        pres = present[k, r_idx]
        rd_resps = torch.where(
            (rd_opcodes == 1) & (pres > 0), vals, torch.full_like(vals, -1)
        )
        rd_resps = torch.where(rd_opcodes == 0, torch.zeros_like(vals),
                               rd_resps)
        return log, states, wr_resps, rd_resps

    return step


def pallas_hashmap_state(n_keys: int, n_replicas: int, device=None):
    kp = _round_up(n_keys, 8)
    dev = resolve_device(device)
    return {
        "values": torch.zeros((kp, n_replicas), dtype=torch.int32,
                              device=dev),
        "present": torch.zeros((kp, n_replicas), dtype=torch.int32,
                               device=dev),
    }


# ----------------------------------------------------- fused engine


class FusedHashmapEngine(FusedEngineHost):
    """The fused combiner-round engine for the hashmap model.

    `round(log, states, opcodes, args, count, fenced=None)` executes
    one whole combiner round — append `count` entries at the tail,
    replay the batch into every replica, restore fenced lanes — as ONE
    kernel launch. Requires the lock-step precondition the caller
    checks on the host: every live cursor at the pre-append tail
    (`core/replica._try_fused_round`).

    States cross the boundary in model layout (`[R, K]` values + bool
    present); the transposes to the kernel's `[Kp, R]` planes happen in
    `round_fn`. `raw_round` is the transposed-resident form.
    """

    supports_fenced = True

    def __init__(self, n_keys: int, spec: LogSpec, device=None):
        if not fused_window_ok(spec.capacity, 1):
            raise ValueError(
                f"fused hashmap engine: ring capacity {spec.capacity} "
                f"has no 128-slot row layout"
            )
        self.n_keys = int(n_keys)
        self.spec = spec
        self.device = resolve_device(device)
        self.kp = _round_up(self.n_keys, 8)
        self._init_host()

    def supports(self, window: int) -> bool:
        """Window fits the reference's ring-span rule and the
        appendable capacity."""
        return (fused_window_ok(self.spec.capacity, window)
                and window <= self.spec.capacity - self.spec.gc_slack)

    def launches(self, window: int) -> int:
        """Kernel launches per round: always one (no replica chunking
        on the GPU)."""
        del window
        return 1

    def raw_round(self, window: int, fenced: bool = False):
        """Round fn over TRANSPOSED planes: `(log, vals_t, pres_t,
        opcodes, args, count[, fenced_vec]) -> (log, vals_t, pres_t,
        resps[W, R])`."""
        spec, n_keys = self.spec, self.n_keys

        def raw(log, vals_t, pres_t, opcodes, args, count,
                fenced_vec=None):
            if opcodes.shape[0] != window:
                raise ValueError(f"round built for window {window}, got "
                                 f"{opcodes.shape[0]}")
            if (fenced_vec is not None) != fenced:
                raise ValueError("fenced mask given to an unfenced round "
                                 "or missing from a fenced one")
            fen = (None if fenced_vec is None
                   else torch.as_tensor(fenced_vec).to(
                       device=vals_t.device, dtype=torch.int32))
            ring_opc, ring_args, vals_t, pres_t, resps = \
                hashmap_fused_round(
                    spec, log.tail, int(count), opcodes, args,
                    log.opcodes, log.args, vals_t, pres_t, n_keys, fen,
                )
            log = log._replace(opcodes=ring_opc, args=ring_args)
            log = fused_cursor_lattice(log, count, fenced_vec)
            return log, vals_t, pres_t, resps

        return raw

    def round_fn(self, window: int, fenced: bool = False):
        """MODEL-layout round fn: `(log, states, opcodes, args, count[,
        fenced_vec]) -> (log, states, resps[R, W])`, `resps[r, j]`
        answering window offset j, fenced rows zeroed."""
        raw = self.raw_round(window, fenced)
        K, kp = self.n_keys, self.kp

        def fn(log, states, opcodes, args, count, fenced_vec=None):
            R = states["values"].shape[0]
            dev = states["values"].device
            vals_t = torch.zeros((kp, R), dtype=torch.int32, device=dev)
            vals_t[:K] = states["values"].T
            pres_t = torch.zeros_like(vals_t)
            pres_t[:K] = states["present"].T
            log, vals_t, pres_t, resps = raw(
                log, vals_t, pres_t, opcodes, args, count, fenced_vec
            )
            states = {
                "values": vals_t[:K].T.contiguous(),
                "present": (pres_t[:K] > 0).T.contiguous(),
            }
            resps = resps.T.contiguous()  # [R, W]
            if fenced_vec is not None:
                fen = torch.as_tensor(fenced_vec).to(device=dev,
                                                     dtype=torch.bool)
                resps = torch.where(fen[:, None], torch.zeros_like(resps),
                                    resps)
            return log, states, resps

        return fn
