"""Replicated virtual address space, flat page-table variant (PyTorch).

The port of the flat half of `node_replication_tpu/models/vspace.py`
(the NrOS use case, `benches/vspace.rs:176-481`): per replica one
last-level table `frames: int32[n_pages]`, 0 = unmapped; a map or unmap
touches a span of at most `max_span` consecutive pages. The 4-level
radix variant (`make_vspace_radix`) is not ported yet (ROADMAP.md queue
2, K6/K7b).

Write opcodes:
  VS_MAP=1       args (vpage, pframe, npages): pages vpage+i map to
                 pframe+i for i < clip(npages, 0, max_span); resp = the
                 number of those pages that were unmapped.
  VS_UNMAP=2     args (vpage, npages): resp = the number that were mapped.
Read opcodes:
  VS_IDENTIFY=1  args (vpage): pframe, or -1 if unmapped.
  VS_RESOLVED=2  args (vpage, npages): the number of mapped pages.

Span lane i touches page `(vpage + i) mod n_pages` (floored) when the
int32 sum `vpage + i` is below `n_pages`; sums wrap at 2^31 as int32
does in the reference, and so does `pframe + i` (`wrap_int32`).
"""

from __future__ import annotations

import torch

from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.utils.device import resolve_device

VS_MAP = 1
VS_UNMAP = 2
VS_IDENTIFY = 1
VS_RESOLVED = 2

UNMAPPED = 0


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """The int32 value of an int64 tensor modulo 2^32 (two's
    complement), still int64: what int32 arithmetic gives in the
    reference."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _write_span(frames, idx, ok, vals) -> None:
    """`frames[r, idx[r, l]] = vals[r, l]` where `ok[r, l]`, in place.
    Idle lanes write the row's first ok target with its value (or page
    0 with its own value), so every duplicate index carries one value
    and the scatter is deterministic on the card too."""
    first = ok.to(torch.int32).argmax(1, keepdim=True)
    any_ok = ok.any(1, keepdim=True)
    t0 = torch.where(any_ok, idx.gather(1, first), 0)
    v0 = torch.where(any_ok, vals.gather(1, first), frames.gather(1, t0))
    rows = torch.arange(frames.shape[0], device=frames.device)[:, None]
    frames[rows, torch.where(ok, idx, t0)] = torch.where(ok, vals, v0)


def make_vspace(n_pages: int, max_span: int = 16) -> Dispatch:
    """`max_span` bounds the pages touched per op (fixed scatter
    width)."""

    def make_state(device=None):
        return {"frames": torch.zeros((n_pages,), dtype=torch.int32,
                                      device=resolve_device(device))}

    def _span_idx(vpage, npages):
        # int64 [..., S] targets; idle lanes at the sentinel n_pages
        lanes = torch.arange(max_span, dtype=torch.int64,
                             device=vpage.device)
        n = npages.long().clamp(0, max_span)[..., None]
        raw = wrap_int32(vpage.long()[..., None] + lanes)
        ok = (lanes < n) & (raw < n_pages)
        idx = torch.where(ok, torch.remainder(raw, n_pages), n_pages)
        return idx, ok, lanes

    def _gather(frames, idx):
        return frames.gather(-1, idx.clamp(max=n_pages - 1))

    def vmap_(states, args, lanes_on):
        frames = states["frames"]
        idx, ok, lanes = _span_idx(args[:, 0], args[:, 2])
        newly = (ok & (_gather(frames, idx) == UNMAPPED)).sum(1)
        # pframe 0 is the caller's concern: a map to frame 0 reads back
        # as unmapped, as in the reference
        vals = wrap_int32(args[:, 1:2].long() + lanes).to(torch.int32)
        _write_span(frames, idx, ok & lanes_on[:, None], vals)
        return newly.to(torch.int32)

    def unmap(states, args, lanes_on):
        frames = states["frames"]
        idx, ok, _ = _span_idx(args[:, 0], args[:, 1])
        was = (ok & (_gather(frames, idx) != UNMAPPED)).sum(1)
        _write_span(frames, idx, ok & lanes_on[:, None],
                    torch.zeros_like(idx, dtype=torch.int32))
        return was.to(torch.int32)

    def identify(states, args):
        v = torch.remainder(args[:, 0].long(), n_pages)
        f = states["frames"].gather(1, v[:, None])[:, 0]
        return torch.where(f == UNMAPPED, torch.full_like(f, -1), f)

    def resolved(states, args):
        idx, ok, _ = _span_idx(args[:, 0], args[:, 1])
        return (ok & (_gather(states["frames"], idx) != UNMAPPED)).sum(
            1).to(torch.int32)

    def window_plan(state, opcodes, args):
        """Combined replay of a window (the reference's `window_plan`;
        its docstring has the algorithm): each op expands into
        `max_span` page events (idle lanes park at a sentinel page),
        one STABLE sort groups events by page, presence-before(event) is
        the same-page predecessor's stored value != 0 or the replica's
        initial frame, each op's response is the lane sum of its
        events' presence bits, and each page's last event (a
        scatter-max of event positions) gives its final frame. Leading
        axes of `state` and the window are batch axes (one plan per
        replica for the per-replica `window_apply` tier)."""
        W = opcodes.shape[-1]
        S = max_span
        lead = opcodes.shape[:-1]
        dev = opcodes.device
        a = args.long()
        is_map = opcodes == VS_MAP
        is_un = opcodes == VS_UNMAP
        active = is_map | is_un
        # MAP's span rides args[2], UNMAP's args[1]
        npages = torch.where(is_un, a[..., 1], a[..., 2])
        lanes = torch.arange(S, dtype=torch.int64, device=dev)
        n = npages.clamp(0, S)[..., None]
        raw = wrap_int32(a[..., 0:1] + lanes)
        lane_ok = (lanes < n) & (raw < n_pages) & active[..., None]
        page = torch.where(lane_ok, torch.remainder(raw, n_pages), n_pages)
        stored = torch.where(is_map[..., None],
                             wrap_int32(a[..., 1:2] + lanes),
                             0).to(torch.int32)
        E = W * S
        pe = page.reshape(lead + (E,))
        se = stored.reshape(lead + (E,))
        sp, order = torch.sort(pe, dim=-1, stable=True)
        same_prev = torch.cat(
            [torch.zeros_like(sp[..., :1], dtype=torch.bool),
             sp[..., 1:] == sp[..., :-1]], dim=-1,
        )
        prev = torch.cat([order[..., :1], order[..., :-1]], dim=-1)
        init_pres = _gather(state["frames"], sp) != UNMAPPED
        pres_before_s = torch.where(same_prev,
                                    se.gather(-1, prev) != UNMAPPED,
                                    init_pres)
        pres_before = torch.zeros(lead + (E,), dtype=torch.bool,
                                  device=dev).scatter(
            -1, order, pres_before_s).reshape(lead + (W, S))
        newly = (lane_ok & is_map[..., None] & ~pres_before).sum(-1)
        was = (lane_ok & is_un[..., None] & pres_before).sum(-1)
        resps = torch.where(is_map, newly,
                            torch.where(is_un, was, 0)).to(torch.int32)
        # last event per page wins (the sentinel slot absorbs idle lanes)
        pos = torch.arange(E, dtype=torch.int64, device=dev).expand(
            lead + (E,))
        last = torch.full(lead + (n_pages + 1,), -1, dtype=torch.int64,
                          device=dev).scatter_reduce(
            -1, pe, pos, "amax", include_self=True)[..., :n_pages]
        li = last.clamp(min=0)
        return {"touched": last >= 0, "value": se.gather(-1, li),
                "resps": resps}

    def window_merge(states, plan):
        """Blend `plan` into `states`; responses come back broadcast to
        the states' leading axes (a read-only view)."""
        frames = torch.where(plan["touched"], plan["value"],
                             states["frames"])
        resps = plan["resps"]
        return {"frames": frames}, resps.expand(
            frames.shape[:-1] + resps.shape[-1:])

    def window_apply(states, opcodes, args):
        # arbitrary-state form: the plan's presence-before half reads
        # THIS state, so the composition is the full per-replica fold
        return window_merge(states, window_plan(states, opcodes, args))

    # with max_span > n_pages one op's wrapped span can revisit a page
    # and the one-predecessor event expansion diverges from the fold:
    # such configs take the scan engine, as in the reference
    ok_combined = max_span <= n_pages

    def fused_factory(spec, device=None):
        # the span kernel with the ring append fused in; it rejects
        # configs outside the kernel's row rule, and the wrapper then
        # takes the chain
        from node_replication_torch.ops.vspace import FusedVspaceEngine

        return FusedVspaceEngine(n_pages, max_span, spec, device=device)

    return Dispatch(
        name=f"vspace{n_pages}",
        make_state=make_state,
        write_ops=(vmap_, unmap),
        read_ops=(identify, resolved),
        arg_width=3,
        window_apply=window_apply if ok_combined else None,
        window_plan=window_plan if ok_combined else None,
        window_merge=window_merge if ok_combined else None,
        window_canonical=ok_combined,
        fused_factory=fused_factory,
    )
