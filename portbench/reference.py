"""The plain reference: an in-order replay of an op stream against one
copy of the state, in plain PyTorch, independent of the program.

A model adapter (`models/<model>.py`) turns ops into cell events: a
write event sets a cell to `(val, pres)`, a read event only looks. The
answer of every op follows from what its events saw before them: the
value the last earlier write to the same cell left, or the cell's value
when the stream began. So one stable sort of the events by cell, then
by op, replays a whole stream at once, and the responses and the final
cells come out exactly as a loop over the ops would give them (the
models' `step` functions are that loop; the tests hold the two equal).

Streams are replayed in chunks of ops, carrying the cells from one
chunk to the next, so that a long window fits on the device.
"""

from __future__ import annotations

import torch


def replay_chunk(model, planes: dict, opc, args, write, store=torch.int32):
    """Replay the ops `opc int32[N]`, `args int32[N, A]`, `write
    bool[N]` in order against `planes` ({"val": int32[C], "pres":
    bool[C]}, changed in place): their responses, int64[N]. `store` is
    the type the cells are kept in (the control narrows it)."""
    n = opc.shape[0]
    ev = model.events(opc, args, write, store)
    e = ev["op"].shape[0]
    if e == 0:
        return model.responses(opc, write, ev, ev["val"], ev["pres"], n)
    # ops touch distinct cells within themselves, so (cell, op) is unique
    key = ev["cell"].long() * (n + 1) + ev["op"].long()
    order = torch.argsort(key)
    cell = ev["cell"][order].long()
    wr = ev["write"][order]
    val = ev["val"][order]
    pres = ev["pres"][order]
    pos = torch.arange(e, device=cell.device)
    last_w = torch.cummax(torch.where(wr, pos, -1), 0).values
    prev_w = torch.cat([last_w.new_full((1,), -1), last_w[:-1]])
    pw = prev_w.clamp(min=0)
    seen = (prev_w >= 0) & (cell[pw] == cell)
    b_val = torch.where(seen, val[pw], planes["val"][cell])
    b_pres = torch.where(seen, pres[pw], planes["pres"][cell])
    # each cell's last event carries its last write, if any
    last = torch.ones(e, dtype=torch.bool, device=cell.device)
    last[:-1] = cell[1:] != cell[:-1]
    lw = last_w[last]
    lc = cell[last]
    hit = (lw >= 0) & (cell[lw.clamp(min=0)] == lc)
    planes["val"][lc[hit]] = val[lw[hit]]
    planes["pres"][lc[hit]] = pres[lw[hit]]
    before_val = torch.empty_like(b_val)
    before_pres = torch.empty_like(b_pres)
    before_val[order] = b_val
    before_pres[order] = b_pres
    return model.responses(opc, write, ev, before_val, before_pres, n)


def replay(model, planes: dict, opc, args, write, chunk: int = 1 << 16,
           store=torch.int32):
    """`replay_chunk` over a stream of any length, `chunk` ops at a
    time: the responses, int64[N], on the planes' device."""
    dev = planes["val"].device
    out = []
    for i in range(0, opc.shape[0], chunk):
        out.append(replay_chunk(
            model, planes,
            torch.as_tensor(opc[i:i + chunk]).to(dev),
            torch.as_tensor(args[i:i + chunk]).to(dev),
            torch.as_tensor(write[i:i + chunk]).to(dev), store))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    return torch.cat(out)


def narrow(planes: dict, store) -> dict:
    """The planes as a store of type `store` keeps them (the control's
    narrowing), as new tensors of the planes' own types."""
    val = planes["val"].to(store).to(planes["val"].dtype)
    return {"val": val, "pres": planes["pres"].clone()}
