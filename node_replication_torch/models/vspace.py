"""Replicated virtual address space: the flat page table and the 4-level
radix page table (PyTorch).

The port of `node_replication_tpu/models/vspace.py` (the NrOS use case,
`benches/vspace.rs:176-481`). The flat model (`make_vspace`) keeps per
replica one last-level table `frames: int32[n_pages]`, 0 = unmapped; a
map or unmap touches a span of at most `max_span` consecutive pages.
The radix model (`make_vspace_radix`, below) keeps the flat table as
its last level `pt` and adds the PD/PDPT/PML4 present tables that a
full walk reads.

Flat write opcodes:
  VS_MAP=1       args (vpage, pframe, npages): pages vpage+i map to
                 pframe+i for i < clip(npages, 0, max_span); resp = the
                 number of those pages that were unmapped.
  VS_UNMAP=2     args (vpage, npages): resp = the number that were mapped.
Flat read opcodes:
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


# --------------------------------------------------------------- radix
# The 4-level variant: 9 radix bits per level over the bounded window,
# so a level-l entry covers 512^l pages.

VSR_MAP = 1
VSR_MAP_DEVICE = 2
VSR_UNMAP = 3
VSR_UNMAP_TABLE = 4

VSR_IDENTIFY = 1
VSR_RESOLVED = 2
VSR_TABLES = 3

# pt entry encoding: 0 = not present; else (pframe + 1) | device << 30
_DEV_BIT = 1 << 30
_FRAME_MASK = (1 << 30) - 1


def _take(table, idx):
    """`table[..., idx]` per leading index: `table [*lead, n]`, `idx
    int64 [*lead, *rest]` -> `[*lead, *rest]`."""
    lead = table.shape[:-1]
    flat = idx.reshape(lead + (-1,))
    return table.gather(-1, flat).reshape(idx.shape)


def _mark(n: int, idx, lead, device):
    """bool `[*lead, n]`: True at every `idx` below n (int64
    `[*lead, k]`; entries >= n are dropped). Every write is True, so
    duplicate indices are deterministic."""
    hit = torch.zeros(lead + (n + 1,), dtype=torch.bool, device=device)
    return hit.scatter(-1, idx.clamp(max=n),
                       torch.ones_like(idx, dtype=torch.bool))[..., :n]


def _seg_last(flag, seg_start):
    """Inclusive segmented scan along the last axis: per position, the
    index of the last position at or before it, in its own segment,
    where `flag` is set, and whether there is one. `seg_start` marks
    each segment's first position."""
    pos = torch.arange(flag.shape[-1], dtype=torch.int64,
                       device=flag.device).expand(flag.shape)
    last, _ = torch.cummax(torch.where(flag, pos, -1), dim=-1)
    start, _ = torch.cummax(torch.where(seg_start, pos, 0), dim=-1)
    return last.clamp(min=0), last >= start


def make_vspace_radix(n_pages: int, max_span: int = 16) -> Dispatch:
    """4-level page-table vspace with per-level present tables (see the
    reference's docstring for the semantics of the radix levels).

    Write opcodes:
      VSR_MAP=1          (vpage, pframe, npages): maps vpage+i to
                         pframe+i, allocating the walk's tables; resp =
                         the number of pages not fully walked before.
      VSR_MAP_DEVICE=2   the same, entries carrying the device bit.
      VSR_UNMAP=3        (vpage, npages): clears PT entries (tables stay
                         allocated); resp = the number fully walked.
      VSR_UNMAP_TABLE=4  (vpage): tears down the PD table covering vpage:
                         its 512-page region unmaps and the PD entry
                         clears; resp = the region's fully walked pages.
    Read opcodes:
      VSR_IDENTIFY=1     (vpage): (pframe+1) | device<<30 after a full
                         walk, or -1.
      VSR_RESOLVED=2     (vpage, npages): the number of fully walked
                         pages.
      VSR_TABLES=3       (): the number of allocated PD tables.

    vpage is taken floored mod n_pages first; span lane i then acts when
    vpage + i < n_pages (no wrap).
    """
    P, S = n_pages, max_span
    l2 = max(1, -(-P // 512))
    l3 = max(1, -(-P // (512 ** 2)))
    l4 = max(1, -(-P // (512 ** 3)))
    # a max_span run crosses at most this many PD entries (and always
    # at most 2 at the higher levels)
    pd_w = -(-S // 512) + 1

    def make_state(device=None):
        dev = resolve_device(device)
        return {
            "pt": torch.zeros((P,), dtype=torch.int32, device=dev),
            "pd": torch.zeros((l2,), dtype=torch.bool, device=dev),
            "pdpt": torch.zeros((l3,), dtype=torch.bool, device=dev),
            "pml4": torch.zeros((l4,), dtype=torch.bool, device=dev),
        }

    def _span_idx(vpage, npages):
        # vpage already in [0, P): int64 [R, S] targets, idle lanes at P
        lanes = torch.arange(S, dtype=torch.int64, device=vpage.device)
        n = npages.long().clamp(0, S)[:, None]
        raw = vpage[:, None] + lanes
        ok = (lanes < n) & (raw < P)
        return torch.where(ok, raw, P), ok, lanes

    def _walk(states, pages):
        """The full walk, `pages int64 [R, k]` (P -> False)."""
        safe = pages.clamp(max=P - 1)
        return (
            (pages < P)
            & states["pml4"].gather(1, (safe >> 27).clamp(max=l4 - 1))
            & states["pdpt"].gather(1, (safe >> 18).clamp(max=l3 - 1))
            & states["pd"].gather(1, safe >> 9)
            & (states["pt"].gather(1, safe) != 0)
        )

    def _mark_levels(states, vpage, npages, lanes_on):
        n = npages.long().clamp(0, S)
        # an empty map (npages <= 0) allocates no table
        live = (n > 0) & lanes_on
        last = torch.maximum(vpage + n - 1, vpage)
        pd_lanes = (vpage >> 9)[:, None] + torch.arange(
            pd_w, dtype=torch.int64, device=vpage.device)
        pd_idx = torch.where(pd_lanes <= (last >> 9)[:, None], pd_lanes, l2)
        hi = torch.stack([vpage >> 18, last >> 18], 1)
        top = torch.stack([vpage >> 27, last >> 27], 1)
        lead = vpage.shape
        for key, idx, width in (("pd", pd_idx, l2), ("pdpt", hi, l3),
                                ("pml4", top, l4)):
            idx = torch.where(live[:, None], idx, width)
            states[key] |= _mark(width, idx, lead, vpage.device)

    def _map_common(states, args, lanes_on, device_bit):
        vpage = torch.remainder(args[:, 0].long(), P)
        idx, ok, lanes = _span_idx(vpage, args[:, 2])
        newly = (ok & ~_walk(states, idx)).sum(1)
        entry = ((args[:, 1:2].long() + lanes + 1) & _FRAME_MASK) | (
            _DEV_BIT if device_bit else 0)
        _mark_levels(states, vpage, args[:, 2], lanes_on)
        _write_span(states["pt"], idx, ok & lanes_on[:, None],
                    entry.to(torch.int32))
        return newly.to(torch.int32)

    def map_(states, args, lanes_on):
        return _map_common(states, args, lanes_on, False)

    def map_device(states, args, lanes_on):
        return _map_common(states, args, lanes_on, True)

    def unmap(states, args, lanes_on):
        vpage = torch.remainder(args[:, 0].long(), P)
        idx, ok, _ = _span_idx(vpage, args[:, 1])
        was = (ok & _walk(states, idx)).sum(1)
        _write_span(states["pt"], idx, ok & lanes_on[:, None],
                    torch.zeros_like(idx, dtype=torch.int32))
        return was.to(torch.int32)

    def unmap_table(states, args, lanes_on):
        vpage = torch.remainder(args[:, 0].long(), P)
        pd_i = vpage >> 9
        region = (pd_i << 9)[:, None] + torch.arange(
            512, dtype=torch.int64, device=vpage.device)
        ok = region < P
        idx = torch.where(ok, region, P)
        was = (ok & _walk(states, idx)).sum(1)
        _write_span(states["pt"], idx, ok & lanes_on[:, None],
                    torch.zeros_like(idx, dtype=torch.int32))
        rows = torch.arange(vpage.shape[0], device=vpage.device)
        pd = states["pd"]
        pd[rows, pd_i] = pd[rows, pd_i] & ~lanes_on
        return was.to(torch.int32)

    def identify(states, args):
        v = torch.remainder(args[:, 0].long(), P)[:, None]
        f = states["pt"].gather(1, v)[:, 0]
        return torch.where(_walk(states, v)[:, 0], f, torch.full_like(f, -1))

    def resolved(states, args):
        vpage = torch.remainder(args[:, 0].long(), P)
        idx, ok, _ = _span_idx(vpage, args[:, 1])
        return (ok & _walk(states, idx)).sum(1).to(torch.int32)

    def tables(states, args):
        del args
        return states["pd"].sum(1).to(torch.int32)

    def window_plan(state, opcodes, args):
        """Combined replay of a window (the reference's `window_plan`;
        its docstring has the algorithm): a page stream (one stable sort
        of the W x max_span lane events by page gives every lane its
        same-page predecessor and successor), a region stream (one
        stable sort by PD entry of per-op [lane queries | table query |
        pd marks | clear] columns, then three segmented scans: last pd
        update, last clear before, first clear after), the walk before
        each lane, the teardown responses by epoch algebra, and the
        final per-page and per-PD-entry winners. The reference's
        associative scans become cummax/cummin over positions reset at
        segment starts. Leading axes of `state` and the window are batch
        axes (one plan per replica for the per-replica `window_apply`
        tier)."""
        W = opcodes.shape[-1]
        lead = opcodes.shape[:-1]
        dev = opcodes.device
        ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
        full = lambda shape, v: torch.full(shape, v, dtype=torch.int64,
                                           device=dev)
        t_op = ar(W).expand(lead + (W,))
        a = args.long()
        vpage = torch.remainder(a[..., 0], P)
        pframe = a[..., 1]
        is_map = (opcodes == VSR_MAP) | (opcodes == VSR_MAP_DEVICE)
        is_dev = opcodes == VSR_MAP_DEVICE
        is_un = opcodes == VSR_UNMAP
        is_tbl = opcodes == VSR_UNMAP_TABLE
        # MAP spans ride args[2], UNMAP's args[1]
        npages = torch.where(is_un, a[..., 1], a[..., 2])
        lanes = ar(S)
        nn = npages.clamp(0, S)
        raw = vpage[..., None] + lanes
        lane_ok = ((lanes < nn[..., None]) & (raw < P)
                   & (is_map | is_un)[..., None])
        page = torch.where(lane_ok, raw, P)
        stored = torch.where(
            is_map[..., None],
            ((pframe[..., None] + lanes + 1) & _FRAME_MASK)
            | torch.where(is_dev, _DEV_BIT, 0)[..., None], 0)
        safe = page.clamp(max=P - 1)

        # ---- level marks (the exact conditions of _mark_levels)
        live = is_map & (nn > 0)
        last_pg = torch.maximum(vpage + nn - 1, vpage)
        pd_lanes = (vpage >> 9)[..., None] + ar(pd_w)
        pd_mark = torch.where(
            live[..., None] & (pd_lanes <= (last_pg >> 9)[..., None])
            & (pd_lanes < l2), pd_lanes, l2)
        hi = torch.stack([vpage >> 18, last_pg >> 18], -1)
        hi_mark = torch.where(live[..., None] & (hi < l3), hi, l3)
        top = torch.stack([vpage >> 27, last_pg >> 27], -1)
        top_mark = torch.where(live[..., None] & (top < l4), top, l4)

        # ---- monotone levels: first-set time per entry
        tt2 = t_op[..., None].expand(lead + (W, 2)).reshape(lead + (2 * W,))

        def first_set(mark, width):
            return full(lead + (width + 1,), W).scatter_reduce(
                -1, mark.reshape(lead + (2 * W,)), tt2, "amin",
                include_self=True)[..., :width]

        fs_pdpt, fs_pml4 = first_set(hi_mark, l3), first_set(top_mark, l4)
        init_pt, init_pd = state["pt"], state["pd"]
        init_pdpt, init_pml4 = state["pdpt"], state["pml4"]

        def before(init, fs, entry, t):
            return _take(init, entry) | (_take(fs, entry) < t)

        # ---- page stream: same-page predecessor / successor
        E = W * S
        pe = page.reshape(lead + (E,))
        se = stored.reshape(lead + (E,))
        te = t_op[..., None].expand(lead + (W, S)).reshape(lead + (E,))
        spg, ordp = torch.sort(pe, dim=-1, stable=True)
        samep = spg[..., 1:] == spg[..., :-1]
        no = torch.zeros(lead + (1,), dtype=torch.bool, device=dev)
        prevp = torch.cat([ordp[..., :1], ordp[..., :-1]], -1)
        nextp = torch.cat([ordp[..., 1:], ordp[..., -1:]], -1)

        def unsort(v, order, shape):  # `order` is a permutation
            return torch.empty_like(v).scatter(-1, order, v).reshape(shape)

        ws = lead + (W, S)
        has_pred = unsort(torch.cat([no, samep], -1), ordp, ws)
        t_pred = unsort(te.gather(-1, prevp), ordp, ws)
        v_pred = unsort(se.gather(-1, prevp), ordp, ws)
        has_succ = unsort(torch.cat([samep, no], -1), ordp, ws)
        t_succ = unsort(te.gather(-1, nextp), ordp, ws)

        # ---- region stream: [lane q | tbl q | pd marks | clear]
        reg_tbl = vpage >> 9
        tbl_q = torch.where(is_tbl, reg_tbl, l2)[..., None]
        lane_q = torch.where(lane_ok, page >> 9, l2)
        Wc = S + 1 + pd_w + 1
        keys = torch.cat([lane_q, tbl_q, pd_mark, tbl_q], -1)
        col = lambda bits: torch.tensor(bits, dtype=torch.bool,
                                        device=dev).expand(lead + (W, Wc))
        col_upd = col([False] * (S + 1) + [True] * (pd_w + 1))
        col_val = col([False] * (S + 1) + [True] * pd_w + [False])
        is_upd = col_upd & (keys < l2)
        is_clear = is_upd & ~col_val
        N = W * Wc
        kz = keys.reshape(lead + (N,))
        tz = t_op[..., None].expand(lead + (W, Wc)).reshape(lead + (N,))
        skr, ordr = torch.sort(kz, dim=-1, stable=True)
        tzs = tz.gather(-1, ordr)
        yes = torch.ones(lead + (1,), dtype=torch.bool, device=dev)
        seg = torch.cat([yes, skr[..., 1:] != skr[..., :-1]], -1)
        srt = lambda v: v.reshape(lead + (N,)).gather(-1, ordr)
        # last pd update (its value) and last clear at or before each
        # position; first clear at or after it (the same scan reversed)
        iu, pd_has = _seg_last(srt(is_upd), seg)
        pd_val = srt(col_val).gather(-1, iu)
        ic, ch = _seg_last(srt(is_clear), seg)
        ct = torch.where(ch, tzs.gather(-1, ic), -1)
        flip = lambda v: v.flip(-1)
        segb = torch.cat([yes, flip(skr)[..., 1:] != flip(skr)[..., :-1]],
                         -1)
        inx, nh = _seg_last(flip(srt(is_clear)), segb)
        nt = flip(torch.where(nh, flip(tzs).gather(-1, inx), W))
        wc = lead + (W, Wc)
        pd_b = torch.where(unsort(pd_has, ordr, wc),
                           unsort(pd_val, ordr, wc),
                           _take(init_pd, keys.clamp(max=l2 - 1)))
        lcb = unsort(ct, ordr, wc)
        nca = unsort(nt, ordr, wc)

        # ---- per-lane walk-present just before its op
        lane_lcb = lcb[..., :S]
        lane_nc = nca[..., :S]
        init_pt_lane = _take(init_pt, safe)
        pt_b = torch.where(has_pred & (t_pred > lane_lcb), v_pred,
                           torch.where(lane_lcb >= 0, 0, init_pt_lane))
        t_b = t_op[..., None]
        walk_b = (before(init_pml4, fs_pml4, safe >> 27, t_b)
                  & before(init_pdpt, fs_pdpt, safe >> 18, t_b)
                  & pd_b[..., :S] & (pt_b != 0))
        resp_map = (lane_ok & ~walk_b).sum(-1)
        resp_un = (lane_ok & walk_b).sum(-1)

        # ---- UNMAP_TABLE responses: epoch algebra. A lane write is
        # last in its epoch iff its next same-page write falls beyond
        # the epoch's terminating clear
        epoch_last = lane_ok & (~has_succ | (t_succ > lane_nc))
        feeds = epoch_last & (lane_nc < W)
        ncf = lane_nc.clamp(0, W).reshape(lead + (E,))

        def bucket(bits):
            return torch.zeros(lead + (W + 1,), dtype=torch.int64,
                               device=dev).scatter_add(
                -1, ncf, bits.reshape(lead + (E,)).long())

        a_bucket = bucket(feeds & (stored != 0))
        b_sub = bucket(feeds & (lane_lcb == -1) & (init_pt_lane != 0))
        # per-region census of initially-mapped pages
        padded = torch.zeros(lead + (l2 * 512,), dtype=torch.int64,
                             device=dev)
        padded[..., :P] = (init_pt != 0).long()
        init_nz_count = padded.reshape(lead + (l2, 512)).sum(-1)
        c0 = lcb[..., S]
        levels_tbl = (
            before(init_pml4, fs_pml4, (reg_tbl >> 18).clamp(max=l4 - 1),
                   t_op)
            & before(init_pdpt, fs_pdpt, (reg_tbl >> 9).clamp(max=l3 - 1),
                     t_op)
            & pd_b[..., S])
        count_pt = _take(a_bucket, t_op) + torch.where(
            c0 == -1, _take(init_nz_count, reg_tbl) - _take(b_sub, t_op), 0)
        resp_tbl = torch.where(levels_tbl, count_pt, 0)
        resps = torch.where(
            is_map, resp_map,
            torch.where(is_un, resp_un, torch.where(is_tbl, resp_tbl, 0)),
        ).to(torch.int32)

        # ---- final state
        lastw = full(lead + (P + 1,), -1).scatter_reduce(
            -1, pe, ar(E).expand(lead + (E,)), "amax",
            include_self=True)[..., :P]
        li = lastw.clamp(min=0)
        lc_reg = full(lead + (l2 + 1,), -1).scatter_reduce(
            -1, tbl_q[..., 0], torch.where(is_tbl, t_op, -1), "amax",
            include_self=True)[..., :l2]
        lc_pg = lc_reg[..., ar(P) >> 9]
        Uc = pd_w + 1
        U = W * Uc
        upd_keys = torch.cat([pd_mark, tbl_q], -1).reshape(lead + (U,))
        upd_vals = torch.tensor([True] * pd_w + [False], device=dev).repeat(W)
        lastu = full(lead + (l2 + 1,), -1).scatter_reduce(
            -1, upd_keys, ar(U).expand(lead + (U,)), "amax",
            include_self=True)[..., :l2]
        return {
            # per page: the last in-window write (and whether it
            # postdates the last region clear), and the clear mask
            "pt_wins": (lastw >= 0) & (te.gather(-1, li) > lc_pg),
            "pt_value": se.gather(-1, li).to(torch.int32),
            "pt_cleared": lc_pg >= 0,
            # per PD entry: the last update (mark True, clear False)
            "pd_touched": lastu >= 0,
            "pd_value": upd_vals[lastu.clamp(min=0)],
            # monotone levels: entries first set inside the window
            "pdpt_set": fs_pdpt < W,
            "pml4_set": fs_pml4 < W,
            "resps": resps,
        }

    def window_merge(states, plan):
        """Blend `plan` into `states`; responses come back broadcast to
        the states' leading axes (a read-only view)."""
        pt = torch.where(plan["pt_wins"], plan["pt_value"],
                         torch.where(plan["pt_cleared"], 0, states["pt"]))
        out = {
            "pt": pt,
            "pd": torch.where(plan["pd_touched"], plan["pd_value"],
                              states["pd"]),
            "pdpt": states["pdpt"] | plan["pdpt_set"],
            "pml4": states["pml4"] | plan["pml4_set"],
        }
        resps = plan["resps"]
        return out, resps.expand(pt.shape[:-1] + resps.shape[-1:])

    def window_apply(states, opcodes, args):
        # arbitrary-state form: the plan's walk-before and epoch half
        # reads THIS state, so the composition is the per-replica fold
        return window_merge(states, window_plan(states, opcodes, args))

    return Dispatch(
        name=f"vspace_radix{n_pages}",
        make_state=make_state,
        write_ops=(map_, map_device, unmap, unmap_table),
        read_ops=(identify, resolved, tables),
        arg_width=3,
        window_apply=window_apply,
        window_plan=window_plan,
        window_merge=window_merge,
        window_canonical=True,
    )
