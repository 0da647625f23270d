"""The flat vspace's span kernels, their plain versions, and the paths
built on them (PyTorch + CUDA).

The port of the flat half of `node_replication_tpu/ops/pallas_vspace.py`.
Three kernels, one CUDA source (`csrc/vspace_replay.cu`, whose header
says what they compute, how they are laid out and what bounds them):

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

Responses are ONE canonical copy `[W]`, replica 0's, which speaks for
the fleet under the lock-step invariant (every replica replays the same
window from the same state), as in the reference.

Each wrapper takes its plain PyTorch version (a Python loop over the
window, each entry a gather and a scatter over all replicas) for CPU
tensors ONLY; for CUDA tensors it launches the kernel or raises. The
kernels work on a row of at least `n_pages` ints per replica, so they
take the reference's padded layout `[R, ROWS, 128]` (the step path's
state, `pallas_vspace_state`) and the model layout `[R, P]` (the plan
step and the fused round) alike.

The reference's eligibility rules stay, so the port routes work to the
kernels exactly as the reference does in interpret mode: `max_span <=
512`, `n_pages >= span_rows * 128 + max_span`, and a fused window of at
most 4096 entries. Its VMEM budget (`_grid_layout`) does not: it exists
for the TPU's vector memory only. Only the flat model is ported;
`radix=True` raises NotImplementedError until K6/K7b are (ROADMAP.md
queue 2).
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

RADIX_NOT_PORTED = (
    "the radix vspace kernels (K6 _radix_kernel, K7b _radix_plan_kernel) "
    "are not ported yet: ROADMAP.md queue 2"
)
# the fused round's window bound (the reference's SMEM window, kept as
# its routing rule)
FUSED_WINDOW_MAX = 4096

REPLAY_KERNEL = Kernel("vspace_replay")
PLAN_KERNEL = Kernel("vspace_plan_replay")
FUSED_KERNEL = Kernel("vspace_fused_round")


def reset_launch_counts() -> None:
    for k in (REPLAY_KERNEL, PLAN_KERNEL, FUSED_KERNEL):
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


def check_flat_config(n_pages: int, max_span: int, radix: bool,
                      what: str) -> None:
    """The reference's rules for a span-kernel config (ValueError), and
    the radix model's absence (NotImplementedError)."""
    if radix:
        raise NotImplementedError(RADIX_NOT_PORTED)
    if max_span > 512:
        raise ValueError("max_span > 512 breaks the 2-entry/level "
                         "invariant of the radix walk kernel")
    need = min_pages(n_pages, max_span)
    if n_pages < need:
        raise ValueError(
            f"{what} needs n_pages >= {need} so a mod-wrapped span's two "
            f"row blends never overlap; use the combined engine for "
            f"n_pages={n_pages}"
        )


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, p, i, i, i, i, i, i, p, p]
    lib.nr_vspace_replay.argtypes = head + [p, p]
    lib.nr_vspace_replay.restype = i
    lib.nr_vspace_plan_replay.argtypes = head + [p, p, p, p]
    lib.nr_vspace_plan_replay.restype = i
    lib.nr_vspace_fused_round.argtypes = head + [p, p, i, i, p, p, p, p, p]
    lib.nr_vspace_fused_round.restype = i


def _library() -> ctypes.CDLL:
    """The kernels' library (`csrc/vspace_replay.cu`), built at first
    use by `ops/kernel_lib.py`."""
    return library("vspace_replay", _bind)


def _check(opcodes, args, frames, n_pages: int, max_span: int):
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
    # the pages of one span are distinct (the kernel's one owner per cell)
    if not 0 <= max_span <= n_pages:
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
    `n_pages`): `(frames, resps int32[W])`, new tensors."""
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
            R, L, frames.data_ptr(), out.data_ptr(),
            resps.data_ptr(), _stream(frames))
    if err:
        raise RuntimeError(f"vspace_replay launch failed: CUDA error "
                           f"{err}")
    REPLAY_KERNEL.launches += 1
    return out, resps


def vspace_plan_replay(opcodes, args, frames, touched, n_pages: int,
                       max_span: int):
    """`vspace_replay` that also carries the `touched int32` plane
    (frames' shape): set to 1 on every page the window writes.
    Returns `(frames, touched, resps int32[W])`, new tensors."""
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
            _stream(frames))
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
    on the frames' device; `count` a host int."""
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
            ra.data_ptr(), _stream(frames))
    if err:
        raise RuntimeError(f"vspace_fused_round launch failed: CUDA "
                           f"error {err}")
    FUSED_KERNEL.launches += 1
    return ro, ra, out, resps


# ------------------------------------------------- state and reads


def pallas_vspace_state(n_pages: int, n_replicas: int, radix: bool,
                        model_state=None, device=None):
    """Kernel-layout state `{"frames": int32[R, ROWS, 128]}` (the
    reference's grid, pages row-major, zero padding), optionally seeded
    from one model state (`make_vspace(...).init_state()` shape)."""
    if radix:
        raise NotImplementedError(RADIX_NOT_PORTED)
    dev = resolve_device(device)
    rows = grid_rows(n_pages)
    grid = torch.zeros((rows * 128,), dtype=torch.int32, device=dev)
    if model_state is not None:
        grid[:n_pages] = model_state["frames"].to(dev)
    return {"frames": grid.reshape(rows, 128).expand(
        n_replicas, rows, 128).contiguous()}


def model_view(state, n_pages: int, radix: bool):
    """Model-layout view `{"frames": int32[R, P]}` of kernel-layout
    state."""
    if radix:
        raise NotImplementedError(RADIX_NOT_PORTED)
    R = state["frames"].shape[0]
    return {"frames": state["frames"].reshape(R, -1)[:, :n_pages]}


def vspace_reads(n_pages: int, max_span: int):
    """Per-replica reads straight on the kernel layout (the reference's
    `_vspace_reads`): `reads(states, rd_opcodes int32[R, Br], rd_args
    int32[R, Br, A]) -> int32[R, Br]`, bit-identical to the model's read
    ops over `model_view`, by gathers instead of a relayout. IDENTIFY=1,
    RESOLVED=2; NOOP and unknown opcodes answer 0."""
    P, S = n_pages, max_span

    def reads(states, rd_opcodes, rd_args):
        R = states["frames"].shape[0]
        row = states["frames"].reshape(R, -1)
        a0 = rd_args[..., 0].long()

        def gather(pages):  # int64 [R, ...], sentinel P reads 0
            vals = row.gather(1, pages.clamp(0, P - 1).reshape(R, -1))
            return torch.where(pages < P, vals.reshape(pages.shape), 0)

        f = gather(torch.remainder(a0, P))
        ident = torch.where(f == 0, -1, f)
        lanes = torch.arange(S, dtype=torch.int64, device=row.device)
        n = rd_args[..., 1].long().clamp(0, S)[..., None]
        raw = wrap_int32(a0[..., None] + lanes)
        pages = torch.where((lanes < n) & (raw < P),
                            torch.remainder(raw, P), P)
        resolved = ((pages < P) & (gather(pages) != 0)).sum(-1)
        out = torch.where(rd_opcodes == 1, ident, 0)
        return torch.where(rd_opcodes == 2, resolved, out).to(torch.int32)

    return reads


# ------------------------------------------------- replay and steps


def make_vspace_replay(n_pages: int, n_replicas: int, window: int,
                       max_span: int, radix: bool):
    """Build `replay(opcodes[W], args[W, 3], frames[R, ROWS, 128]) ->
    (frames, resps[W])` (K4). The reference tiles replicas for VMEM and
    its step chunks the window; the kernel takes the whole window and
    fleet in one launch."""
    check_flat_config(n_pages, max_span, radix, "flat vspace replay")
    shape = (n_replicas, grid_rows(n_pages), 128)

    def replay(opcodes, args, frames):
        if tuple(frames.shape) != shape or opcodes.shape[0] != window:
            raise ValueError(
                f"replay built for window {window} over {shape} frames, "
                f"got window {opcodes.shape[0]} over "
                f"{tuple(frames.shape)}")
        return vspace_replay(opcodes, args, frames, n_pages, max_span)

    return replay


def make_vspace_plan_replay(n_pages: int, window: int, max_span: int,
                            radix: bool):
    """Build the canonical-replica plan replayer (K7a):
    `plan_replay(opcodes[W], args[W, 3], frames[1, ...], touched[1,
    ...]) -> (frames, touched, resps[W])`, rows of at least `n_pages`
    (the reference's `[1, ROWS, 128]`, or the model layout `[1, P]`
    that the plan step passes)."""
    check_flat_config(n_pages, max_span, radix, "flat vspace plan replay")

    def plan_replay(opcodes, args, frames, touched):
        if frames.shape[0] != 1 or opcodes.shape[0] != window:
            raise ValueError(
                f"plan replay built for window {window} over one "
                f"replica, got window {opcodes.shape[0]} over "
                f"{tuple(frames.shape)}")
        return vspace_plan_replay(opcodes, args, frames, touched, n_pages,
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
    """Kernel twin of `core/step.make_step` for the flat vspace: append
    the fleet's batch to the ring, replay it in order into every replica
    with K4, answer reads on the kernel layout (`vspace_reads`). State
    is `pallas_vspace_state(...)`. Requires and preserves the lock-step
    invariant, like the combined step."""
    R = spec.n_replicas
    Bw = int(writes_per_replica)
    span = R * Bw
    replay = make_vspace_replay(n_pages, R, span, max_span, radix)
    reads = vspace_reads(n_pages, max_span)

    def step(log, states, wr_opcodes, wr_args, rd_opcodes, rd_args):
        opc = wr_opcodes.reshape(span).contiguous()
        args = wr_args.reshape(span, spec.arg_width).contiguous()
        log = log_append(spec, log, opc, args, span)
        frames, resps = replay(opc, args, states["frames"])
        states = {"frames": frames}
        # cursors advance in lock-step (every replica replayed the span)
        log = log._replace(
            ltails=log.ltails + span, ctail=log.ctail + span,
            head=log.head + span,
        )
        # resps is the one canonical copy [span], shared by the fleet
        wr_resps = resps[_own(R, Bw, resps.device)]
        return log, states, wr_resps, reads(states, rd_opcodes, rd_args)

    return step


def make_pallas_vspace_plan_step(n_pages: int, spec: LogSpec,
                                 writes_per_replica: int,
                                 reads_per_replica: int, max_span: int,
                                 radix: bool, dispatch):
    """Kernel-planned combined step, the fleet-scale vspace engine: the
    window's sequential semantics run ONCE, on replica 0's row, in K7a,
    which also marks the pages the window touched; the model's own
    `window_merge` then blends that plan into every replica (plain
    torch, `[R, P]`). State is model layout (`replicate_state`), as for
    `make_step`; same lock-step precondition."""
    R = spec.n_replicas
    Bw = int(writes_per_replica)
    span = R * Bw
    replay = make_vspace_plan_replay(n_pages, span, max_span, radix)

    def step(log, states, wr_opcodes, wr_args, rd_opcodes, rd_args):
        opc = wr_opcodes.reshape(span).contiguous()
        args = wr_args.reshape(span, spec.arg_width).contiguous()
        log = log_append(spec, log, opc, args, span)
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
    (`supports_fenced=False`): a fenced fleet takes the chain."""

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
        """Kernel launches per round: always one (no replica chunking
        on the GPU)."""
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
