"""The vspace span kernels, their plain versions, and the paths built on
them (PyTorch + CUDA).

The port of `node_replication_tpu/ops/pallas_vspace.py`. Five kernels
in two CUDA sources, whose headers say what they compute, how they are
laid out and what bounds them. Flat model (`csrc/vspace_replay.cu`):

- `vspace_replay` (replaces `_flat_kernel`, K4): in-order span replay
  of a window into every replica's page row; used by
  `make_vspace_replay` and `make_pallas_vspace_step`.
- `vspace_plan_replay` (replaces `_flat_plan_kernel`, K7a): the same on
  one canonical replica, plus the plane of pages the window touched;
  used by `make_vspace_plan_replay` and `make_pallas_vspace_plan_step`,
  whose per-replica blend is the model's own `window_merge`.
- `vspace_fused_round` (replaces `_fused_flat_kernel`, K5): a whole
  combiner round, ring append and replay, in one launch; used by
  `FusedVspaceEngine`, the flat model's fused tier.

Radix model (`csrc/vspace_radix_replay.cu`):

- `vspace_radix_replay` (replaces `_radix_kernel`, K6): in-order replay
  with the full PML4/PDPT/PD walk before each entry, into every
  replica's page table `pt` and ONE canonical copy of the level tables
  `pd`/`pdpt`/`pml4`; used by `make_vspace_replay(radix=True)` and
  `make_pallas_vspace_step(radix=True)`.
- `vspace_radix_plan_replay` (replaces `_radix_plan_kernel`, K7b): K6
  on one canonical replica, plus the delta planes `wins`, `clr` and
  `pdt` that the radix model's `window_merge` blends per replica; used
  by `make_vspace_plan_replay(radix=True)` and
  `make_pallas_vspace_plan_step(radix=True)`.

The radix model has no fused tier, as in the reference.

Responses are ONE canonical copy `[W]`, replica 0's, which speaks for
the fleet under the lock-step invariant (every replica replays the same
window from the same state), as in the reference.

Each wrapper takes its plain PyTorch version for CPU tensors ONLY; for
CUDA tensors it launches the kernel or raises. The kernels work on a
row of at least `n_pages` ints per replica, so they take the
reference's padded layout `[R, ROWS, 128]` (the step path's state,
`pallas_vspace_state`) and the model layout `[R, P]` (the plan steps
and the fused round) alike.

The reference's eligibility rules stay, so the port routes work to the
kernels exactly as the reference does in interpret mode: `max_span <=
512`; for the flat model `n_pages >= span_rows * 128 + max_span` and a
fused window of at most 4096 entries; for the radix model one PML4
entry (`n_pages <= 2^27`, the reference's assertion, a ValueError
here). Its VMEM budget (`_grid_layout`) and its chunking do not: they
exist for the TPU's memories only.
"""

from __future__ import annotations

import ctypes

import torch

from node_replication_torch.core.log import LogSpec, log_append
from node_replication_torch.models.vspace import wrap_int32
from node_replication_torch.ops.encoding import dispatch_reads
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

# the fused round's window bound (the reference's SMEM window, kept as
# its routing rule)
FUSED_WINDOW_MAX = 4096

REPLAY_KERNEL = Kernel("vspace_replay")
PLAN_KERNEL = Kernel("vspace_plan_replay")
FUSED_KERNEL = Kernel("vspace_fused_round")
RADIX_KERNEL = Kernel("vspace_radix_replay")
RADIX_PLAN_KERNEL = Kernel("vspace_radix_plan_replay")
KERNELS = (REPLAY_KERNEL, PLAN_KERNEL, FUSED_KERNEL, RADIX_KERNEL,
           RADIX_PLAN_KERNEL)

_FRAME_MASK = (1 << 30) - 1
_DEV_BIT = 1 << 30


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def grid_rows(n_pages: int) -> int:
    """ROWS of the reference's `[ROWS, 128]` page grid."""
    return max(4, _round_up(n_pages, 512) // 128)


def min_pages(n_pages: int, max_span: int) -> int:
    """The reference's row rule: a mod-wrapped span's two row blends
    never overlap when n_pages >= span_rows * 128 + max_span."""
    span_rows = min(-(-max_span // 128) + 1, grid_rows(n_pages))
    return span_rows * 128 + max_span


def levels(n_pages: int) -> tuple[int, int, int]:
    """Entries of the radix PD, PDPT and PML4 tables (`l2, l3, l4`)."""
    l2 = max(1, -(-n_pages // 512))
    l3 = max(1, -(-n_pages // (512 ** 2)))
    l4 = max(1, -(-n_pages // (512 ** 3)))
    return l2, l3, l4


def check_config(n_pages: int, max_span: int, radix: bool,
                 what: str) -> None:
    """The reference's rules for a span-kernel config (ValueError)."""
    if max_span > 512:
        raise ValueError("max_span > 512 breaks the 2-entry/level "
                         "invariant of the radix walk kernel")
    if radix:
        if levels(n_pages)[2] != 1:
            raise ValueError(
                f"{what} walks one PML4 entry: n_pages {n_pages} > 2^27; "
                f"use the combined or scan engine")
        return
    need = min_pages(n_pages, max_span)
    if n_pages < need:
        raise ValueError(
            f"{what} needs n_pages >= {need} so a mod-wrapped span's two "
            f"row blends never overlap; use the combined engine for "
            f"n_pages={n_pages}"
        )


def _bind(lib: ctypes.CDLL) -> None:
    """The C signatures of `csrc/vspace_replay.cu`."""
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, p, i, i, i, i, i, i, p, p]
    lib.nr_vspace_replay.argtypes = head + [p, p, p]
    lib.nr_vspace_replay.restype = i
    lib.nr_vspace_plan_replay.argtypes = head + [p, p, p, p, p]
    lib.nr_vspace_plan_replay.restype = i
    lib.nr_vspace_fused_round.argtypes = head + [p, p, i, i, p, p, p, p, p,
                                                 p]
    lib.nr_vspace_fused_round.restype = i


def _library() -> ctypes.CDLL:
    """The kernels' library (`csrc/vspace_replay.cu`), built at first
    use by `ops/kernel_lib.py`."""
    return library("vspace_replay", _bind)


def _flat_scratch(W: int, device) -> torch.Tensor:
    """The flat kernels' scratch: per entry a decoded record (4 ints)
    and a tile key."""
    return torch.empty((5 * W,), dtype=torch.int32, device=device)


def _check(opcodes, args, frames, n_pages: int, max_span: int,
           radix: bool = False):
    """Shapes the kernels take: `opcodes int32[W]`, `args int32[W, A]`
    (A >= 3), `frames int32[R, ...]` with rows of at least `n_pages`,
    all contiguous. Returns (W, A, R, row_len)."""
    W = opcodes.shape[0]
    expect(opcodes, "opcodes", (W,), torch.int32)
    if args.dim() != 2 or args.shape[1] < 3:
        raise ValueError(f"args: expected [W, A >= 3], got "
                         f"{tuple(args.shape)}")
    expect(args, "args", (W, args.shape[1]), torch.int32)
    if frames.dim() < 2:
        raise ValueError(f"frames: expected [R, ...], got "
                         f"{tuple(frames.shape)}")
    expect(frames, "frames", tuple(frames.shape), torch.int32)
    R = frames.shape[0]
    row_len = frames[0].numel()
    if not 0 < n_pages <= row_len or n_pages >= 1 << 30:
        raise ValueError(f"n_pages {n_pages} outside (0, min(row length "
                         f"{row_len}, 2^30))")
    # the pages of one span are distinct (the kernel's one owner per
    # cell); a radix span never wraps, so it needs no such bound
    if not 0 <= max_span <= (512 if radix else n_pages):
        raise ValueError(f"max_span {max_span} outside [0, n_pages]")
    return W, args.shape[1], R, row_len


# ---------------------------------------------------- plain versions


def _span_lanes(opcodes, args, n_pages: int, max_span: int):
    """Per entry and span lane: the page (int64 [W, S]), whether the
    lane acts (bool [W, S]), the value it stores (int32 [W, S]) and
    whether the entry is a MAP (bool [W]) — the kernel's page rule:
    page (vm + l) mod P, acting when the int32 sum a0 + l is < P."""
    a = args.long()
    is_map, is_un = opcodes == 1, opcodes == 2
    n = torch.where(is_un, a[:, 1], a[:, 2]).clamp(0, max_span)
    n = torch.where(is_map | is_un, n, 0)
    lanes = torch.arange(max_span, dtype=torch.int64, device=a.device)
    vm = torch.remainder(a[:, 0], n_pages)
    ok = (lanes < n[:, None]) & (wrap_int32(a[:, :1] + lanes) < n_pages)
    page = torch.remainder(vm[:, None] + lanes, n_pages)
    stored = torch.where(is_map[:, None], wrap_int32(a[:, 1:2] + lanes),
                         0).to(torch.int32)
    return page, ok, stored, is_map


def _replay_plain(opcodes, args, frames, n_pages: int, max_span: int,
                  touched=None):
    """The kernels' replay on new tensors: frames (and the touched
    plane) as `[R, row_len + 1]`, whose last column absorbs idle lanes
    (they all write back what they read there), and resps."""
    R = frames.shape[0]
    rows = frames.reshape(R, -1)
    L = rows.shape[1]
    dev = frames.device
    fr = torch.zeros((R, L + 1), dtype=torch.int32, device=dev)
    fr[:, :L] = rows
    tch = None
    if touched is not None:
        tch = torch.zeros_like(fr)
        tch[:, :L] = touched.reshape(R, -1)
    page, ok, stored, is_map = _span_lanes(opcodes, args, n_pages,
                                           max_span)
    page = torch.where(ok, page, L)
    W = opcodes.shape[0]
    resps = torch.zeros((W,), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    for i in range(W):
        idx = page[i]
        old = fr[:, idx]
        pres = old != 0
        bits = torch.where(is_map[i], ~pres, pres) & ok[i]
        resps[i] = bits[0].sum()  # replica 0 speaks for the fleet
        fr[:, idx] = torch.where(ok[i], stored[i], old)
        if tch is not None:
            tch[:, idx] = torch.where(ok[i], one, tch[:, idx])
    return fr, tch, resps


def vspace_replay_plain(opcodes, args, frames, n_pages: int,
                        max_span: int):
    """Plain version of the replay kernel (K4): `(frames, resps
    int32[W])`, new tensors."""
    fr, _, resps = _replay_plain(opcodes, args, frames, n_pages, max_span)
    return fr[:, :-1].reshape(frames.shape).contiguous(), resps


def vspace_plan_replay_plain(opcodes, args, frames, touched,
                             n_pages: int, max_span: int):
    """Plain version of the plan kernel (K7a): `(frames, touched, resps
    int32[W])`, new tensors."""
    fr, tch, resps = _replay_plain(opcodes, args, frames, n_pages,
                                   max_span, touched)
    return (fr[:, :-1].reshape(frames.shape).contiguous(),
            tch[:, :-1].reshape(touched.shape).contiguous(), resps)


def vspace_fused_round_plain(spec: LogSpec, tail, count: int, opcodes,
                             args, ring_opc, ring_args, frames,
                             n_pages: int, max_span: int):
    """Plain version of the fused-round kernel (K5): the ring append,
    then the replay of the whole batch."""
    ring_opc, ring_args = append_window_planes(
        spec.mask, ring_opc, ring_args, opcodes, args, tail, count)
    frames, resps = vspace_replay_plain(opcodes, args, frames, n_pages,
                                        max_span)
    return ring_opc, ring_args, frames, resps


# ---------------------------------------------------------- wrappers


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def vspace_replay(opcodes, args, frames, n_pages: int, max_span: int):
    """Replay `opcodes int32[W]`, `args int32[W, A]` in order into every
    replica's row of `frames int32[R, ...]` (rows of at least
    `n_pages`): `(frames, resps int32[W])`, new tensors. One C call
    launches the decode pre-pass and the replay body on the current
    stream; the window is decoded into a scratch buffer made here
    (`_flat_scratch`, 20 bytes an entry)."""
    W, A, R, L = _check(opcodes, args, frames, n_pages, max_span)
    if route(opcodes, args, frames) == "cpu":
        return vspace_replay_plain(opcodes, args, frames, n_pages,
                                   max_span)
    lib = _library()
    out = torch.empty_like(frames)
    resps = torch.empty((W,), dtype=torch.int32, device=frames.device)
    with torch.cuda.device(frames.device):
        err = lib.nr_vspace_replay(
            opcodes.data_ptr(), args.data_ptr(), A, W, n_pages, max_span,
            R, L, frames.data_ptr(), out.data_ptr(), resps.data_ptr(),
            _flat_scratch(W, frames.device).data_ptr(), _stream(frames))
    if err:
        raise RuntimeError(f"vspace_replay launch failed: CUDA error "
                           f"{err}")
    REPLAY_KERNEL.launches += 1
    return out, resps


def vspace_plan_replay(opcodes, args, frames, touched, n_pages: int,
                       max_span: int):
    """`vspace_replay` that also carries the `touched int32` plane
    (frames' shape): set to 1 on every page the window writes.
    Returns `(frames, touched, resps int32[W])`, new tensors. One C call,
    a decode pre-pass and the replay body, with a scratch buffer made
    here, as in `vspace_replay`."""
    W, A, R, L = _check(opcodes, args, frames, n_pages, max_span)
    expect(touched, "touched", tuple(frames.shape), torch.int32)
    if route(opcodes, args, frames, touched) == "cpu":
        return vspace_plan_replay_plain(opcodes, args, frames, touched,
                                        n_pages, max_span)
    lib = _library()
    out = torch.empty_like(frames)
    t_out = torch.empty_like(touched)
    resps = torch.empty((W,), dtype=torch.int32, device=frames.device)
    with torch.cuda.device(frames.device):
        err = lib.nr_vspace_plan_replay(
            opcodes.data_ptr(), args.data_ptr(), A, W, n_pages, max_span,
            R, L, frames.data_ptr(), out.data_ptr(),
            touched.data_ptr(), t_out.data_ptr(), resps.data_ptr(),
            _flat_scratch(W, frames.device).data_ptr(), _stream(frames))
    if err:
        raise RuntimeError(f"vspace_plan_replay launch failed: CUDA "
                           f"error {err}")
    PLAN_KERNEL.launches += 1
    return out, t_out, resps


def vspace_fused_round(spec: LogSpec, tail, count: int, opcodes, args,
                       ring_opc, ring_args, frames, n_pages: int,
                       max_span: int):
    """One combiner round: append batch entries `j < count` at ring
    slots `(tail + j) & mask`, replay the whole NOOP-padded batch into
    `frames int32[R, ...]`. Returns `(ring_opc, ring_args, frames, resps
    int32[W])`, new tensors. `tail` is the int64 cursor as a 0-d tensor
    on the frames' device; `count` a host int. One C call: a decode
    pre-pass, which also writes the ring, and the replay body, on the
    current stream, with a scratch buffer made here, as in
    `vspace_replay`."""
    W, A, R, L = _check(opcodes, args, frames, n_pages, max_span)
    cap = spec.capacity
    if A != spec.arg_width:
        raise ValueError(f"args width {A}, the log's is {spec.arg_width}")
    expect(ring_opc, "ring_opc", (cap,), torch.int32)
    expect(ring_args, "ring_args", (cap, A), torch.int32)
    expect(tail, "tail", (), torch.int64)
    if not (0 <= count <= W and fused_window_ok(cap, W)):
        raise ValueError(f"count {count} / window {W} do not fit a ring "
                         f"of {cap} (fused_window_ok)")
    if route(tail, opcodes, args, ring_opc, ring_args, frames) == "cpu":
        return vspace_fused_round_plain(spec, tail, count, opcodes, args,
                                        ring_opc, ring_args, frames,
                                        n_pages, max_span)
    lib = _library()
    ro = torch.empty_like(ring_opc)
    ra = torch.empty_like(ring_args)
    out = torch.empty_like(frames)
    resps = torch.empty((W,), dtype=torch.int32, device=frames.device)
    with torch.cuda.device(frames.device):
        err = lib.nr_vspace_fused_round(
            opcodes.data_ptr(), args.data_ptr(), A, W, n_pages, max_span,
            R, L, frames.data_ptr(), out.data_ptr(),
            resps.data_ptr(), tail.data_ptr(), int(count), cap,
            ring_opc.data_ptr(), ring_args.data_ptr(), ro.data_ptr(),
            ra.data_ptr(), _flat_scratch(W, frames.device).data_ptr(),
            _stream(frames))
    if err:
        raise RuntimeError(f"vspace_fused_round launch failed: CUDA "
                           f"error {err}")
    FUSED_KERNEL.launches += 1
    return ro, ra, out, resps


# ----------------------------------------------- radix kernels (K6, K7b)


def _bind_radix(lib: ctypes.CDLL) -> None:
    """The C signatures of `csrc/vspace_radix_replay.cu`."""
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, p, i, i, i, i, i, i, p, p, p, p, p, p, p, p]
    lib.nr_vspace_radix_replay.argtypes = head + [p, p, p]
    lib.nr_vspace_radix_replay.restype = i
    lib.nr_vspace_radix_plan_replay.argtypes = head + [p] * 6 + [p, p, p]
    lib.nr_vspace_radix_plan_replay.restype = i


def _radix_scratch(W: int, n_pages: int, device) -> torch.Tensor:
    """The radix kernels' scratch: per entry a decoded record (4 ints)
    and a tile key, then the first-live-MAP indices `first[1 + l3]`."""
    return torch.empty((5 * W + 1 + levels(n_pages)[1],), dtype=torch.int32,
                       device=device)


def _check_radix(opcodes, args, pt, pd, pdpt, pml4, n_pages: int,
                 max_span: int):
    """`_check` for the radix kernels, plus the canonical level tables:
    `pd int32[l2]`, `pdpt int32[l3]`, `pml4 int32[1]`. Returns (W, A,
    R, row_len)."""
    check_config(n_pages, max_span, True, "radix vspace replay")
    out = _check(opcodes, args, pt, n_pages, max_span, radix=True)
    for t, name, width in zip((pd, pdpt, pml4), ("pd", "pdpt", "pml4"),
                              levels(n_pages)):
        expect(t, name, (width,), torch.int32)
    return out


def _radix_plain(opcodes, args, pt, pd, pdpt, pml4, n_pages: int,
                 max_span: int, planes=None):
    """The radix kernels' replay on new tensors, one entry at a time
    (the window is read to the host once): the walk before the entry
    (replica 0's pt and the canonical levels) gives the response, then
    the entry writes every replica's pt and updates the levels, exactly
    as `_radix_body` does. `planes` = (wins, clr, pdt) adds K7b's."""
    P, S = n_pages, max_span
    R = pt.shape[0]
    dev = pt.device
    rows = pt.reshape(R, -1).clone()
    pd, pdpt, pml4 = pd.clone(), pdpt.clone(), pml4.clone()
    l2, l3 = pd.shape[0], pdpt.shape[0]
    if planes is not None:
        wins, clr, pdt = (planes[0].reshape(R, -1).clone(),
                          planes[1].reshape(R, -1).clone(),
                          planes[2].clone())
    resps = torch.zeros((opcodes.shape[0],), dtype=torch.int32, device=dev)
    for i, (op, (a0, a1, a2)) in enumerate(zip(opcodes.tolist(),
                                               args[:, :3].tolist())):
        if op not in (1, 2, 3, 4):
            continue
        vs = a0 % P  # floored, as the model's mod
        n = 0 if op == 4 else min(max(a1 if op == 3 else a2, 0), S)
        lo = (vs >> 9) << 9 if op == 4 else vs
        hi = min(lo + 512, P) if op == 4 else min(vs + n, P)
        if hi > lo:
            pages = torch.arange(lo, hi, dtype=torch.int64, device=dev)
            walk = ((pd[pages >> 9] > 0)
                    & (pdpt[(pages >> 18).clamp(max=l3 - 1)] > 0)
                    & (pml4[0] > 0) & (rows[0, lo:hi] != 0))
            resps[i] = (~walk if op in (1, 2) else walk).sum()
            if op in (1, 2):
                dev_bit = _DEV_BIT if op == 2 else 0
                rows[:, lo:hi] = (((a1 + pages - vs + 1) & _FRAME_MASK)
                                  | dev_bit).to(torch.int32)
            else:
                rows[:, lo:hi] = 0
            if planes is not None:
                wins[:, lo:hi] = 0 if op == 4 else 1
                if op == 4:
                    clr[:, lo:hi] = 1
        r0 = vs >> 9
        if op == 4:
            pd[r0] = 0
            if planes is not None:
                pdt[r0] = 1
        elif op in (1, 2) and n > 0:
            last = vs + n - 1
            marks = [r0] + ([r0 + 1] if r0 + 1 < l2
                            and r0 + 1 <= last >> 9 else [])
            for r in marks:
                pd[r] = 1
                if planes is not None:
                    pdt[r] = 1
            for k in {vs >> 18, last >> 18}:
                if k < l3:
                    pdpt[k] = 1
            pml4[0] = 1
    out = (rows.reshape(pt.shape), pd, pdpt, pml4)
    if planes is None:
        return out + (resps,)
    return out + (wins.reshape(pt.shape), clr.reshape(pt.shape), pdt,
                  resps)


def vspace_radix_replay_plain(opcodes, args, pt, pd, pdpt, pml4,
                              n_pages: int, max_span: int):
    """Plain version of the radix replay kernel (K6): `(pt, pd, pdpt,
    pml4, resps int32[W])`, new tensors."""
    return _radix_plain(opcodes, args, pt, pd, pdpt, pml4, n_pages,
                        max_span)


def vspace_radix_plan_replay_plain(opcodes, args, pt, pd, pdpt, pml4,
                                   wins, clr, pdt, n_pages: int,
                                   max_span: int):
    """Plain version of the radix plan kernel (K7b): `(pt, pd, pdpt,
    pml4, wins, clr, pdt, resps int32[W])`, new tensors."""
    return _radix_plain(opcodes, args, pt, pd, pdpt, pml4, n_pages,
                        max_span, (wins, clr, pdt))


def vspace_radix_replay(opcodes, args, pt, pd, pdpt, pml4, n_pages: int,
                        max_span: int):
    """Replay `opcodes int32[W]`, `args int32[W, A]` in order into every
    replica's page table `pt int32[R, ...]` (rows of at least
    `n_pages`) and the canonical level tables `pd int32[l2]`, `pdpt
    int32[l3]`, `pml4 int32[1]`: `(pt, pd, pdpt, pml4, resps int32[W])`,
    new tensors. The window is decoded once per call into a scratch
    buffer made here (`_radix_scratch`, 20 bytes an entry)."""
    W, A, R, L = _check_radix(opcodes, args, pt, pd, pdpt, pml4, n_pages,
                              max_span)
    if route(opcodes, args, pt, pd, pdpt, pml4) == "cpu":
        return vspace_radix_replay_plain(opcodes, args, pt, pd, pdpt, pml4,
                                         n_pages, max_span)
    lib = library("vspace_radix_replay", _bind_radix)
    outs = [torch.empty_like(t) for t in (pt, pd, pdpt, pml4)]
    resps = torch.empty((W,), dtype=torch.int32, device=pt.device)
    with torch.cuda.device(pt.device):
        err = lib.nr_vspace_radix_replay(
            opcodes.data_ptr(), args.data_ptr(), A, W, n_pages, max_span,
            R, L, pt.data_ptr(), outs[0].data_ptr(), pd.data_ptr(),
            outs[1].data_ptr(), pdpt.data_ptr(), outs[2].data_ptr(),
            pml4.data_ptr(), outs[3].data_ptr(), resps.data_ptr(),
            _radix_scratch(W, n_pages, pt.device).data_ptr(), _stream(pt))
    if err:
        raise RuntimeError(f"vspace_radix_replay launch failed: CUDA "
                           f"error {err}")
    RADIX_KERNEL.launches += 1
    return (*outs, resps)


def vspace_radix_plan_replay(opcodes, args, pt, pd, pdpt, pml4, wins, clr,
                             pdt, n_pages: int, max_span: int):
    """`vspace_radix_replay` that also carries K7b's delta planes:
    `wins` (pt's shape; set on every page a MAP/UNMAP writes, reset on a
    torn-down region), `clr` (pt's shape; set on every torn-down region)
    and `pdt int32[l2]` (set on every PD entry an entry really updates).
    Returns `(pt, pd, pdpt, pml4, wins, clr, pdt, resps int32[W])`, new
    tensors."""
    W, A, R, L = _check_radix(opcodes, args, pt, pd, pdpt, pml4, n_pages,
                              max_span)
    expect(wins, "wins", tuple(pt.shape), torch.int32)
    expect(clr, "clr", tuple(pt.shape), torch.int32)
    expect(pdt, "pdt", tuple(pd.shape), torch.int32)
    ins = (pt, pd, pdpt, pml4, wins, clr, pdt)
    if route(opcodes, args, *ins) == "cpu":
        return vspace_radix_plan_replay_plain(opcodes, args, *ins, n_pages,
                                              max_span)
    lib = library("vspace_radix_replay", _bind_radix)
    outs = [torch.empty_like(t) for t in ins]
    resps = torch.empty((W,), dtype=torch.int32, device=pt.device)
    ptrs = [x for t, o in zip(ins, outs) for x in (t.data_ptr(),
                                                   o.data_ptr())]
    with torch.cuda.device(pt.device):
        err = lib.nr_vspace_radix_plan_replay(
            opcodes.data_ptr(), args.data_ptr(), A, W, n_pages, max_span,
            R, L, *ptrs, resps.data_ptr(),
            _radix_scratch(W, n_pages, pt.device).data_ptr(), _stream(pt))
    if err:
        raise RuntimeError(f"vspace_radix_plan_replay launch failed: "
                           f"CUDA error {err}")
    RADIX_PLAN_KERNEL.launches += 1
    return (*outs, resps)


# ------------------------------------------------- state and reads


def _grid(flat, n_pages: int, n_replicas: int, device):
    """One model-layout row `[P]` as the kernel grid `[R, ROWS, 128]`
    (pages row-major, zero padding)."""
    rows = grid_rows(n_pages)
    grid = torch.zeros((rows * 128,), dtype=torch.int32, device=device)
    if flat is not None:
        grid[:n_pages] = flat.to(device)
    return grid.reshape(rows, 128).expand(n_replicas, rows, 128).contiguous()


def pallas_vspace_state(n_pages: int, n_replicas: int, radix: bool,
                        model_state=None, device=None):
    """Kernel-layout state, optionally seeded from one model state
    (`make_vspace(...)`/`make_vspace_radix(...).init_state()` shape).
    Flat: `{"frames": int32[R, ROWS, 128]}` (the reference's grid).
    Radix: `{"pt": int32[R, ROWS, 128]}` per replica plus the ONE
    canonical copy of the levels, `pd int32[l2]`, `pdpt int32[l3]`,
    `pml4 int32[l4]`, as in the reference."""
    dev = resolve_device(device)
    ms = model_state or {}
    if not radix:
        return {"frames": _grid(ms.get("frames"), n_pages, n_replicas,
                                dev)}
    out = {"pt": _grid(ms.get("pt"), n_pages, n_replicas, dev)}
    for key, width in zip(("pd", "pdpt", "pml4"), levels(n_pages)):
        out[key] = (ms[key].to(device=dev, dtype=torch.int32) if ms
                    else torch.zeros((width,), dtype=torch.int32,
                                     device=dev))
    return out


def model_view(state, n_pages: int, radix: bool):
    """Model-layout view of kernel-layout state: `{"frames": int32[R,
    P]}`, or `{"pt": int32[R, P], "pd": bool[R, l2], "pdpt": bool[R,
    l3], "pml4": bool[R, l4]}` with the canonical levels broadcast."""
    key = "pt" if radix else "frames"
    R = state[key].shape[0]
    out = {key: state[key].reshape(R, -1)[:, :n_pages]}
    if radix:
        for k in ("pd", "pdpt", "pml4"):
            out[k] = (state[k] > 0).expand(R, state[k].shape[0])
    return out


def vspace_reads(n_pages: int, max_span: int, radix: bool = False):
    """Per-replica reads straight on the kernel layout (the reference's
    `_vspace_reads`): `reads(states, rd_opcodes int32[R, Br], rd_args
    int32[R, Br, A]) -> int32[R, Br]`, bit-identical to the model's read
    ops over `model_view`, by gathers instead of a relayout. IDENTIFY=1,
    RESOLVED=2, (radix) TABLES=3; NOOP and unknown opcodes answer 0."""
    P, S = n_pages, max_span

    def reads(states, rd_opcodes, rd_args):
        grid = states["pt" if radix else "frames"]
        R = grid.shape[0]
        row = grid.reshape(R, -1)
        a0 = rd_args[..., 0].long()

        def gather(pages):  # int64 [R, ...], sentinel P reads 0
            vals = row.gather(1, pages.clamp(0, P - 1).reshape(R, -1))
            return torch.where(pages < P, vals.reshape(pages.shape), 0)

        lanes = torch.arange(S, dtype=torch.int64, device=row.device)
        n = rd_args[..., 1].long().clamp(0, S)[..., None]
        v = torch.remainder(a0, P)
        f = gather(v)
        if not radix:
            ident = torch.where(f == 0, -1, f)
            raw = wrap_int32(a0[..., None] + lanes)
            pages = torch.where((lanes < n) & (raw < P),
                                torch.remainder(raw, P), P)
            resolved = ((pages < P) & (gather(pages) != 0)).sum(-1)
            out = torch.where(rd_opcodes == 1, ident, 0)
            return torch.where(rd_opcodes == 2, resolved,
                               out).to(torch.int32)
        pd, pdpt, pml4 = states["pd"], states["pdpt"], states["pml4"]

        def walk(pages):
            safe = pages.clamp(0, P - 1)
            return ((pages < P)
                    & (pml4[(safe >> 27).clamp(max=pml4.shape[0] - 1)] > 0)
                    & (pdpt[(safe >> 18).clamp(max=pdpt.shape[0] - 1)] > 0)
                    & (pd[safe >> 9] > 0) & (gather(pages) != 0))

        ident = torch.where(walk(v), f, -1)
        raw = v[..., None] + lanes  # v < P: no wrap
        pages = torch.where((lanes < n) & (raw < P), raw, P)
        resolved = walk(pages).sum(-1)
        out = torch.where(rd_opcodes == 1, ident, 0)
        out = torch.where(rd_opcodes == 2, resolved, out)
        return torch.where(rd_opcodes == 3, (pd > 0).sum(),
                           out).to(torch.int32)

    return reads


# ------------------------------------------------- replay and steps


def _expect_window(window: int, opcodes, what: str) -> None:
    if opcodes.shape[0] != window:
        raise ValueError(f"{what} built for window {window}, got "
                         f"{opcodes.shape[0]}")


def make_vspace_replay(n_pages: int, n_replicas: int, window: int,
                       max_span: int, radix: bool):
    """Build the replayer of a window into the kernel-layout fleet.

    flat:  `replay(opcodes[W], args[W, 3], frames[R, ROWS, 128]) ->
           (frames, resps[W])` (K4);
    radix: `replay(opcodes[W], args[W, 3], pt[R, ROWS, 128], pd[l2],
           pdpt[l3], pml4[l4]) -> (pt, pd, pdpt, pml4, resps[W])` (K6).

    The reference tiles replicas for VMEM and its step chunks the
    window; each kernel takes the whole window and fleet in one
    launch."""
    what = "radix vspace replay" if radix else "flat vspace replay"
    check_config(n_pages, max_span, radix, what)
    shape = (n_replicas, grid_rows(n_pages), 128)

    def replay(opcodes, args, frames, *lvls):
        _expect_window(window, opcodes, what)
        if tuple(frames.shape) != shape:
            raise ValueError(f"{what} built for {shape} state, got "
                             f"{tuple(frames.shape)}")
        if radix:
            return vspace_radix_replay(opcodes, args, frames, *lvls,
                                       n_pages, max_span)
        return vspace_replay(opcodes, args, frames, n_pages, max_span)

    return replay


def make_vspace_plan_replay(n_pages: int, window: int, max_span: int,
                            radix: bool):
    """Build the canonical-replica plan replayer, rows of at least
    `n_pages` (the reference's `[1, ROWS, 128]`, or the model layout
    `[1, P]` that the plan step passes):

    flat:  `plan_replay(opcodes[W], args[W, 3], frames[1, ...],
           touched[1, ...]) -> (frames, touched, resps[W])` (K7a);
    radix: `plan_replay(opcodes, args, pt[1, ...], pd[l2], pdpt[l3],
           pml4[l4], wins[1, ...], clr[1, ...], pdt[l2]) -> (pt, pd,
           pdpt, pml4, wins, clr, pdt, resps[W])` (K7b)."""
    what = ("radix vspace plan replay" if radix
            else "flat vspace plan replay")
    check_config(n_pages, max_span, radix, what)

    def plan_replay(opcodes, args, frames, *rest):
        _expect_window(window, opcodes, what)
        if frames.shape[0] != 1:
            raise ValueError(f"{what} runs on one replica, got "
                             f"{tuple(frames.shape)}")
        if radix:
            return vspace_radix_plan_replay(opcodes, args, frames, *rest,
                                            n_pages, max_span)
        return vspace_plan_replay(opcodes, args, frames, *rest, n_pages,
                                  max_span)

    return plan_replay


def _own(R: int, Bw: int, device) -> torch.Tensor:
    """Replica r's own writes: window offsets [r*Bw, (r+1)*Bw)."""
    return (torch.arange(R, dtype=torch.int64, device=device)[:, None] * Bw
            + torch.arange(Bw, dtype=torch.int64, device=device)[None, :])


def make_pallas_vspace_step(n_pages: int, spec: LogSpec,
                            writes_per_replica: int,
                            reads_per_replica: int, max_span: int,
                            radix: bool):
    """Kernel twin of `core/step.make_step` for the vspace models: append
    the fleet's batch to the ring, replay it in order into every replica
    with K4 (flat) or K6 (radix), answer reads on the kernel layout
    (`vspace_reads`). State is `pallas_vspace_state(...)`. Requires and
    preserves the lock-step invariant, like the combined step."""
    R = spec.n_replicas
    Bw = int(writes_per_replica)
    span = R * Bw
    replay = make_vspace_replay(n_pages, R, span, max_span, radix)
    reads = vspace_reads(n_pages, max_span, radix)
    keys = ("pt", "pd", "pdpt", "pml4") if radix else ("frames",)

    def step(log, states, wr_opcodes, wr_args, rd_opcodes, rd_args):
        opc = wr_opcodes.reshape(span).contiguous()
        args = wr_args.reshape(span, spec.arg_width).contiguous()
        log = log_append(spec, log, opc, args, span)
        *new, resps = replay(opc, args, *(states[k] for k in keys))
        states = dict(zip(keys, new))
        # cursors advance in lock-step (every replica replayed the span)
        log = log._replace(
            ltails=log.ltails + span, ctail=log.ctail + span,
            head=log.head + span,
        )
        # resps is the one canonical copy [span], shared by the fleet
        wr_resps = resps[_own(R, Bw, resps.device)]
        return log, states, wr_resps, reads(states, rd_opcodes, rd_args)

    return step


def _radix_plan(replay, opc, args, states):
    """K7b on replica 0 of the model-layout fleet, packaged as the radix
    model's plan (the reference's plan-step dict): monotone levels first
    set in the window are `final & ~init`."""
    pt = states["pt"][:1]
    lv = [states[k][0] for k in ("pd", "pdpt", "pml4")]
    pt, pd, pdpt, pml4, wins, clr, pdt, r = replay(
        opc, args, pt, *(x.to(torch.int32) for x in lv),
        torch.zeros_like(pt), torch.zeros_like(pt),
        torch.zeros_like(lv[0], dtype=torch.int32))
    return {
        "pt_wins": wins[0] > 0, "pt_value": pt[0],
        "pt_cleared": clr[0] > 0, "pd_touched": pdt > 0,
        "pd_value": pd > 0, "pdpt_set": (pdpt > 0) & ~lv[1],
        "pml4_set": (pml4 > 0) & ~lv[2], "resps": r,
    }


def make_pallas_vspace_plan_step(n_pages: int, spec: LogSpec,
                                 writes_per_replica: int,
                                 reads_per_replica: int, max_span: int,
                                 radix: bool, dispatch):
    """Kernel-planned combined step, the fleet-scale vspace engine: the
    window's sequential semantics run ONCE, on replica 0's row, in K7a
    (flat) or K7b (radix), which also emits the delta planes; the
    model's own `window_merge` then blends that plan into every replica
    (plain torch, `[R, P]`). State is model layout (`replicate_state`),
    as for `make_step`; same lock-step precondition."""
    R = spec.n_replicas
    Bw = int(writes_per_replica)
    span = R * Bw
    replay = make_vspace_plan_replay(n_pages, span, max_span, radix)

    def step(log, states, wr_opcodes, wr_args, rd_opcodes, rd_args):
        opc = wr_opcodes.reshape(span).contiguous()
        args = wr_args.reshape(span, spec.arg_width).contiguous()
        log = log_append(spec, log, opc, args, span)
        if radix:
            plan = _radix_plan(replay, opc, args, states)
        else:
            canon = states["frames"][:1]
            frames, touched, r = replay(opc, args, canon,
                                        torch.zeros_like(canon))
            plan = {"touched": touched[0] > 0, "value": frames[0],
                    "resps": r}
        states, resps = dispatch.window_merge(states, plan)
        log = log._replace(
            ltails=log.tail.expand(R).clone(), ctail=log.tail.clone(),
            head=log.tail.clone(),
        )
        wr_resps = torch.gather(resps, 1, _own(R, Bw, resps.device))
        rd_resps = dispatch_reads(dispatch, states, rd_opcodes, rd_args)
        return log, states, wr_resps, rd_resps

    return step


# ----------------------------------------------------- fused engine


class FusedVspaceEngine(FusedEngineHost):
    """The fused combiner-round engine of the flat vspace model, the
    twin of `ops/replay.py:FusedHashmapEngine` (same engine contract,
    same `core/replica.py` tier routing). States cross the boundary in
    model layout, `frames int32[R, P]`, and K5 works on that layout
    directly. Responses are the kernel's canonical copy broadcast to
    every replica, sound under the lock-step precondition the tier
    checks. No fenced variant, as in the reference
    (`supports_fenced=False`): a fenced fleet takes the chain. The radix
    model has no fused tier, as in the reference: it keeps the
    replay-only kernels K6 and K7b."""

    supports_fenced = False

    def __init__(self, n_pages: int, max_span: int, spec: LogSpec,
                 device=None):
        need = min_pages(n_pages, max_span)
        if n_pages < need:
            raise ValueError(
                f"fused flat vspace needs n_pages >= {need} (mod-wrapped "
                f"span row non-overlap); got {n_pages}"
            )
        if not fused_window_ok(spec.capacity, 1):
            raise ValueError(
                f"fused vspace engine: ring capacity {spec.capacity} "
                f"has no 128-slot row layout"
            )
        self.n_pages = int(n_pages)
        self.max_span = int(max_span)
        self.spec = spec
        self.device = resolve_device(device)
        self._init_host()

    def supports(self, window: int) -> bool:
        """The reference's rule: a window of at most 4096 entries that
        fits the ring's row rule and the appendable capacity."""
        return (window <= FUSED_WINDOW_MAX
                and fused_window_ok(self.spec.capacity, window)
                and window <= self.spec.capacity - self.spec.gc_slack)

    def launches(self, window: int) -> int:
        """Kernel wrapper calls per round: always one (no replica
        chunking on the GPU), one C call that launches the decode
        pre-pass (with the ring append) and the replay body on one
        stream."""
        del window
        return 1

    def round_fn(self, window: int, fenced: bool = False):
        """`(log, states, opcodes, args, count) -> (log, states,
        resps[R, W])`, `resps[r, j]` answering window offset j."""
        if fenced:
            raise ValueError("fused vspace round has no fenced variant "
                             "(supports_fenced=False)")
        spec, P, S = self.spec, self.n_pages, self.max_span

        def fn(log, states, opcodes, args, count, fenced_vec=None):
            if opcodes.shape[0] != window:
                raise ValueError(f"round built for window {window}, got "
                                 f"{opcodes.shape[0]}")
            ring_opc, ring_args, frames, resp = vspace_fused_round(
                spec, log.tail, int(count), opcodes, args, log.opcodes,
                log.args, states["frames"], P, S,
            )
            log = log._replace(opcodes=ring_opc, args=ring_args)
            log = fused_cursor_lattice(log, count, None)
            # the canonical responses, shared by the lock-step fleet
            R = frames.shape[0]
            return log, {"frames": frames}, resp[None].expand(R, window)

        return fn
