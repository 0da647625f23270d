"""Shared building blocks for combined window replay (PyTorch).

The port of `node_replication_tpu/ops/windowkit.py` (see its docstring
for why the order-dependent stack and queue decompose into a clamped
walk plus a slot-keyed last-writer-wins resolution). Every helper works
along the LAST axis and treats leading axes as batch axes, the port's
stand-in for the reference's `vmap`.

`associative_scan` replaces `jax.lax.associative_scan`, which torch
lacks. It is the same recursive odd/even algorithm, so every element is
combined in the reference's bracketing: results are bit-identical even
for compositions that are only associative up to integer wrap.
"""

from __future__ import annotations

import torch


def _interleave(even, odd):
    """`[e0, o0, e1, o1, ...]` along the last axis (`len(even)` is
    `len(odd)` or one more)."""
    n = even.shape[-1] + odd.shape[-1]
    out = torch.empty(even.shape[:-1] + (n,), dtype=even.dtype,
                      device=even.device)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def associative_scan(fn, elems):
    """Inclusive scan of the tuple `elems` (tensors sharing their last
    axis) under the associative `fn(earlier, later) -> combined`, along
    the last axis: `jax.lax.associative_scan(fn, elems, axis=-1)`, with
    its recursion (pairwise combine, scan the pairs, fill the evens)."""
    elems = tuple(elems)
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    reduced = fn(tuple(e[..., 0:-1:2] for e in elems),
                 tuple(e[..., 1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(o[..., :-1] for o in odd),
                  tuple(e[..., 2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[..., 2::2] for e in elems))
    even = tuple(torch.cat([e[..., :1], r], dim=-1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def clamped_walk(delta, lo: int, hi: int, x0):
    """Value of the clamped counter BEFORE and AFTER each op:
    `x_{t+1} = min(max(x_t + delta_t, lo), hi)` from origin `x0` (one
    per batch row). Returns `(before int32[..., W], after int32[...,
    W])`."""
    d = delta.to(torch.int32)
    l_el = torch.full_like(d, lo)
    h_el = torch.full_like(d, hi)

    def compose(f, g):
        # f then g over x -> min(max(x + a, l), h)
        af, lf, hf = f
        ag, lg, hg = g
        return (
            af + ag,
            torch.minimum(torch.maximum(lf + ag, lg), hg),
            torch.minimum(torch.maximum(hf + ag, lg), hg),
        )

    pa, pl, ph = associative_scan(compose, (d, l_el, h_el))
    x0 = torch.as_tensor(x0, dtype=torch.int32, device=d.device)
    x0 = x0.expand(d.shape[:-1])
    after = torch.minimum(torch.maximum(x0[..., None] + pa, pl), ph)
    before = torch.cat([x0[..., None], after[..., :-1]], dim=-1)
    return before, after


def slot_resolve(slot_upd, upd_val, slot_qry, init_vals, n_slots: int):
    """Answer every query with the latest earlier update to its slot
    (the reference's `slot_resolve`): `slot_upd`/`slot_qry [..., W]`
    hold a slot in [0, n_slots) where active, the `n_slots` sentinel
    where not; `init_vals [..., n_slots]` is the fallback. Inactive
    positions get garbage that callers mask."""
    is_upd = slot_upd < n_slots
    is_qry = slot_qry < n_slots
    key = torch.where(is_upd, slot_upd, slot_qry).to(torch.int32)
    sk, order = torch.sort(key, dim=-1, stable=True)
    segf = torch.cat([torch.ones_like(sk[..., :1], dtype=torch.bool),
                      sk[..., 1:] != sk[..., :-1]], dim=-1)

    def seg_last(a, b):
        va, ha, fa = a
        vb, hb, fb = b
        keep_b = fb | hb
        return (
            torch.where(keep_b, vb, va),
            torch.where(fb, hb, ha | hb),
            fa | fb,
        )

    pv, ph, _ = associative_scan(
        seg_last, (upd_val.gather(-1, order), is_upd.gather(-1, order),
                   segf))
    # a query is the identity element, so its inclusive scan value
    # covers exactly the strictly earlier updates of its segment; the
    # reference's `.get(mode="clip")` is the clamp
    init_q = init_vals.gather(
        -1, sk.clamp(max=n_slots - 1).to(torch.int64))
    resolved_s = torch.where(ph & is_qry.gather(-1, order), pv, init_q)
    # `order` is a permutation: no duplicate scatter indices
    return torch.zeros(order.shape, dtype=init_vals.dtype,
                       device=order.device).scatter(-1, order, resolved_s)


def last_update_table(slot_upd, upd_val, n_slots: int):
    """Per-slot last active update as `(touched bool[..., n_slots],
    value int32[..., n_slots])` (`slot_upd` uses the `n_slots` sentinel
    for inactive positions). The scatter-max of window positions does
    not depend on the order of duplicate slots, so it is deterministic
    on the card."""
    W = slot_upd.shape[-1]
    idx = torch.arange(W, dtype=torch.int32, device=slot_upd.device)
    idx = idx.expand(slot_upd.shape)
    last = torch.full(slot_upd.shape[:-1] + (n_slots + 1,), -1,
                      dtype=torch.int32, device=slot_upd.device)
    last = last.scatter_reduce(-1, slot_upd.to(torch.int64), idx, "amax",
                               include_self=True)[..., :n_slots]
    if W == 0:  # nothing to gather from; no slot is touched
        return last >= 0, torch.zeros_like(last, dtype=upd_val.dtype)
    li = last.clamp(min=0).to(torch.int64)
    return last >= 0, upd_val.gather(-1, li)
