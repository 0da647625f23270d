"""The open-addressing hash map's replay kernel, its plain version, and
the step built on it (PyTorch + CUDA).

The port of `node_replication_tpu/ops/pallas_oahashmap.py`. One kernel,
`oahashmap_replay` (`csrc/oahashmap_replay.cu`, replaces `_oa_kernel`,
K3): in-order probe-window replay of a window into every replica's
three planes `keys`/`vals`/`flag`; used by `make_oahashmap_replay` and
`make_pallas_oahashmap_step`, whose GET reads are probe-window gathers
on the plane layout (plain torch, as in the reference).

The planes keep the reference's layout `[R, ROWS, 128]`, ROWS =
`ceil(n_slots / 128) + 1` (a guard row), zero padding. Responses are
ONE canonical copy `[W]`, replica 0's, under the lock-step invariant.
Each replica chooses its targets from its own planes; the reference
lets the first replica of a VMEM group choose for the group, which is
the same under that invariant.

The wrapper takes its plain PyTorch version for CPU tensors ONLY; for
CUDA tensors it launches the kernel or raises. The reference's rules
stay (`probe <= 128`, `n_slots >= span_rows * 128 + probe`); its VMEM
budget and chunking do not.
"""

from __future__ import annotations

import ctypes

import torch

from node_replication_torch.core.log import LogSpec, log_append
from node_replication_torch.models.oahashmap import (
    _OCC,
    _TOMB,
    first_true,
    probe_window,
)
from node_replication_torch.ops.kernel_lib import (
    Kernel,
    expect,
    library,
    route,
)
from node_replication_torch.utils.device import resolve_device

REPLAY_KERNEL = Kernel("oahashmap_replay")
_PLANES = ("keys", "vals", "flag")


def reset_launch_counts() -> None:
    REPLAY_KERNEL.launches = 0


def grid_rows(n_slots: int) -> int:
    """ROWS of the reference's `[ROWS, 128]` planes (one guard row)."""
    return max(2, -(-n_slots // 128) + 1)


def check_config(n_slots: int, probe: int) -> None:
    """The reference's rules for a K3 config (ValueError)."""
    if probe > 128:
        raise ValueError("probe > 128 breaks the two-run window split")
    span_rows = min(-(-probe // 128) + 1, grid_rows(n_slots))
    if n_slots < span_rows * 128 + probe:
        raise ValueError(
            f"oahashmap pallas replay needs n_slots >= "
            f"{span_rows * 128 + probe} so a wrapped probe window's two "
            f"row blends never overlap")


def _bind(lib: ctypes.CDLL) -> None:
    """The C signature of `csrc/oahashmap_replay.cu`."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nr_oahashmap_replay.argtypes = [p, p, i, i, i, i, i, i] + [p] * 8
    lib.nr_oahashmap_replay.restype = i


def _check(opcodes, args, keys, vals, flag, n_slots: int, probe: int):
    """Shapes the kernel takes: `opcodes int32[W]`, `args int32[W, A]`
    (A >= 2), three `int32[R, ...]` planes of one shape with rows of at
    least `n_slots`, all contiguous. Returns (W, A, R, row_len)."""
    check_config(n_slots, probe)
    W = opcodes.shape[0]
    expect(opcodes, "opcodes", (W,), torch.int32)
    if args.dim() != 2 or args.shape[1] < 2:
        raise ValueError(f"args: expected [W, A >= 2], got "
                         f"{tuple(args.shape)}")
    expect(args, "args", (W, args.shape[1]), torch.int32)
    if keys.dim() < 2:
        raise ValueError(f"keys: expected [R, ...], got "
                         f"{tuple(keys.shape)}")
    for t, name in zip((keys, vals, flag), _PLANES):
        expect(t, name, tuple(keys.shape), torch.int32)
    R = keys.shape[0]
    row_len = keys[0].numel()
    if not 0 < n_slots <= row_len or n_slots >= 1 << 30:
        raise ValueError(f"n_slots {n_slots} outside (0, min(row length "
                         f"{row_len}, 2^30))")
    return W, args.shape[1], R, row_len


def oahashmap_replay_plain(opcodes, args, keys, vals, flag, n_slots: int,
                           probe: int):
    """Plain version of the replay kernel (K3), one entry at a time over
    all replicas (the opcodes are read to the host once): `(keys, vals,
    flag, resps int32[W])`, new tensors."""
    R = keys.shape[0]
    planes = [t.reshape(R, -1).clone() for t in (keys, vals, flag)]
    K, V, F = planes
    dev = keys.device
    rows = torch.arange(R, device=dev)
    windows = probe_window(args[:, 0], n_slots, probe)  # [W, probe]
    resps = torch.zeros((opcodes.shape[0],), dtype=torch.int32,
                        device=dev)
    for i, op in enumerate(opcodes.tolist()):
        if op not in (1, 2):
            continue
        idx = windows[i]
        k = args[i, 0]
        fl = F[:, idx]
        fm, any_match = first_true((fl == _OCC) & (K[:, idx] == k))
        if op == 1:
            ff, any_free = first_true(fl != _OCC)
            ok = any_match | any_free
            slot = idx[torch.where(any_match, fm, ff)]
            for plane, new in ((K, k), (V, args[i, 1]), (F, _OCC)):
                plane[rows, slot] = torch.where(ok, new, plane[rows, slot])
            resps[i] = torch.where(ok[0], 0, -2)
        else:
            slot = idx[fm]
            F[rows, slot] = torch.where(any_match, _TOMB, F[rows, slot])
            resps[i] = any_match[0]
    return (*(t.reshape(keys.shape) for t in planes), resps)


def oahashmap_replay(opcodes, args, keys, vals, flag, n_slots: int,
                     probe: int):
    """Replay `opcodes int32[W]`, `args int32[W, A]` in order into every
    replica's planes `keys`/`vals`/`flag int32[R, ...]` (rows of at least
    `n_slots`): `(keys, vals, flag, resps int32[W])`, new tensors."""
    W, A, R, L = _check(opcodes, args, keys, vals, flag, n_slots, probe)
    if route(opcodes, args, keys, vals, flag) == "cpu":
        return oahashmap_replay_plain(opcodes, args, keys, vals, flag,
                                      n_slots, probe)
    lib = library("oahashmap_replay", _bind)
    outs = [torch.empty_like(t) for t in (keys, vals, flag)]
    resps = torch.empty((W,), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        err = lib.nr_oahashmap_replay(
            opcodes.data_ptr(), args.data_ptr(), A, W, n_slots, probe, R, L,
            keys.data_ptr(), outs[0].data_ptr(), vals.data_ptr(),
            outs[1].data_ptr(), flag.data_ptr(), outs[2].data_ptr(),
            resps.data_ptr(),
            torch.cuda.current_stream(keys.device).cuda_stream)
    if err:
        raise RuntimeError(f"oahashmap_replay launch failed: CUDA error "
                           f"{err}")
    REPLAY_KERNEL.launches += 1
    return (*outs, resps)


def pallas_oahashmap_state(n_slots: int, n_replicas: int, model_state=None,
                           device=None):
    """Kernel-layout planes `{"keys", "vals", "flag": int32[R, ROWS,
    128]}`, optionally seeded from one model state
    (`make_oahashmap(...).init_state()` shape)."""
    dev = resolve_device(device)
    rows = grid_rows(n_slots)
    out = {}
    for key in _PLANES:
        grid = torch.zeros((rows * 128,), dtype=torch.int32, device=dev)
        if model_state is not None:
            grid[:n_slots] = model_state[key].to(dev)
        out[key] = grid.reshape(rows, 128).expand(
            n_replicas, rows, 128).contiguous()
    return out


def oahashmap_model_view(state, n_slots: int):
    """Model-layout view `{"keys", "vals", "flag": int32[R, N]}` of
    kernel-layout planes."""
    R = state["keys"].shape[0]
    return {k: state[k].reshape(R, -1)[:, :n_slots] for k in _PLANES}


def oahashmap_reads(n_slots: int, probe: int):
    """GET straight on the kernel layout (the reference's step reads):
    `reads(states, rd_opcodes int32[R, Br], rd_args int32[R, Br, A]) ->
    int32[R, Br]`: the value of the window's first slot holding the key,
    or -1; opcodes other than GET=1 answer 0."""

    def reads(states, rd_opcodes, rd_args):
        view = oahashmap_model_view(states, n_slots)
        R = rd_opcodes.shape[0]
        k = rd_args[..., 0]
        idx = probe_window(k, n_slots, probe)  # [R, Br, probe]
        flat = idx.reshape(R, -1)
        got = {name: view[name].gather(1, flat).reshape(idx.shape)
               for name in _PLANES}
        sel, found = first_true((got["flag"] == _OCC)
                                & (got["keys"] == k[..., None]))
        val = got["vals"].gather(-1, sel[..., None])[..., 0]
        out = torch.where(found, val, -1)
        return torch.where(rd_opcodes == 1, out, 0).to(torch.int32)

    return reads


def make_oahashmap_replay(n_slots: int, probe: int, n_replicas: int,
                          window: int):
    """Build `replay(opcodes[W], args[W, 3], keys[R, ROWS, 128], vals,
    flag) -> (keys, vals, flag, resps[W])` (K3), one launch for the
    whole window and fleet."""
    check_config(n_slots, probe)
    shape = (n_replicas, grid_rows(n_slots), 128)

    def replay(opcodes, args, keys, vals, flag):
        if tuple(keys.shape) != shape or opcodes.shape[0] != window:
            raise ValueError(
                f"replay built for window {window} over {shape} planes, "
                f"got window {opcodes.shape[0]} over {tuple(keys.shape)}")
        return oahashmap_replay(opcodes, args, keys, vals, flag, n_slots,
                                probe)

    return replay


def make_pallas_oahashmap_step(n_slots: int, probe: int, spec: LogSpec,
                               writes_per_replica: int,
                               reads_per_replica: int):
    """Kernel twin of `core/step.make_step` for the open-addressing map:
    append the fleet's batch to the ring, replay it in order into every
    replica with K3, answer GETs on the plane layout. State is
    `pallas_oahashmap_state(...)`; the same lock-step contract as
    `ops/vspace.py:make_pallas_vspace_step`."""
    R = spec.n_replicas
    Bw = int(writes_per_replica)
    span = R * Bw
    replay = make_oahashmap_replay(n_slots, probe, R, span)
    reads = oahashmap_reads(n_slots, probe)

    def step(log, states, wr_opcodes, wr_args, rd_opcodes, rd_args):
        opc = wr_opcodes.reshape(span).contiguous()
        args = wr_args.reshape(span, spec.arg_width).contiguous()
        log = log_append(spec, log, opc, args, span)
        *planes, resps = replay(opc, args,
                                *(states[k] for k in _PLANES))
        states = dict(zip(_PLANES, planes))
        log = log._replace(
            ltails=log.ltails + span, ctail=log.ctail + span,
            head=log.head + span,
        )
        dev = resps.device
        own = (torch.arange(R, dtype=torch.int64, device=dev)[:, None] * Bw
               + torch.arange(Bw, dtype=torch.int64, device=dev)[None, :])
        return log, states, resps[own], reads(states, rd_opcodes, rd_args)

    return step
