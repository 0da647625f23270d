"""Replicated in-memory file system (block store) (PyTorch).

The port of `node_replication_tpu/models/memfs.py`: a fixed grid of
files x blocks, `data: int32[n_files, n_blocks]` plus per-file sizes.
`memfs_log_mapper` is the nrfs per-file LogMapper (ops on different
files commute; ops on one file share a log).

Write opcodes:
  FS_WRITE=1     args (fd, block, val) -> write one block, extend size;
                 resp = new size (blocks), or -1 if fd/block out of range.
  FS_TRUNCATE=2  args (fd) -> resp = old size.
  FS_READ_LOGGED=3  args (fd, block) -> a read through the log; resp =
                 block value, state unchanged.
Read opcodes:
  FS_READ=1      args (fd, block) -> block value, or -1 out of range.
  FS_SIZE=2      args (fd) -> size in blocks.
"""

from __future__ import annotations

import torch

from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.ops.windowkit import associative_scan
from node_replication_torch.utils.device import resolve_device

FS_WRITE = 1
FS_TRUNCATE = 2
FS_READ_LOGGED = 3
FS_READ = 1
FS_SIZE = 2

# the max-affine scan's "minus infinity": room for pairwise additions
NINF = torch.iinfo(torch.int64).min // 4


def memfs_log_mapper(opcode: int, args: tuple) -> int:
    """Per-file commutativity hash (nrfs's `fd - 1`)."""
    return args[0]


def make_memfs(n_files: int, n_blocks: int) -> Dispatch:
    def make_state(device=None):
        dev = resolve_device(device)
        return {
            "data": torch.zeros((n_files, n_blocks), dtype=torch.int32,
                                device=dev),
            "size": torch.zeros((n_files,), dtype=torch.int32, device=dev),
        }

    def _ok(fd, block):
        return ((fd >= 0) & (fd < n_files) & (block >= 0)
                & (block < n_blocks))

    def _cell(states, args):
        rows = torch.arange(states["size"].shape[0], device=args.device)
        fd = args[:, 0].clamp(0, n_files - 1).long()
        block = args[:, 1].clamp(0, n_blocks - 1).long()
        return rows, fd, block

    def write(states, args, lanes):
        rows, fdc, blc = _cell(states, args)
        data, size = states["data"], states["size"]
        ok = _ok(args[:, 0], args[:, 1])
        sel = lanes & ok
        data[rows, fdc, blc] = torch.where(sel, args[:, 2],
                                           data[rows, fdc, blc])
        new_size = torch.maximum(size[rows, fdc], (blc + 1).to(torch.int32))
        size[rows, fdc] = torch.where(sel, new_size, size[rows, fdc])
        return torch.where(ok, new_size, torch.full_like(new_size, -1))

    def truncate(states, args, lanes):
        rows, fd, _ = _cell(states, args)
        data, size = states["data"], states["size"]
        old = size[rows, fd]
        data[rows, fd] = torch.where(lanes[:, None],
                                     torch.zeros_like(data[rows, fd]),
                                     data[rows, fd])
        size[rows, fd] = torch.where(lanes, torch.zeros_like(old), old)
        return old

    def _read(states, args):
        rows, fd, block = _cell(states, args)
        val = states["data"][rows, fd, block]
        return torch.where(_ok(args[:, 0], args[:, 1]), val,
                           torch.full_like(val, -1))

    def read_logged(states, args, lanes):
        return _read(states, args)

    def read(states, args):
        return _read(states, args)

    def size(states, args):
        rows, fd, _ = _cell(states, args)
        return states["size"][rows, fd]

    def window_plan(state, opcodes, args):
        """Combined replay for the FS (the reference's `window_plan`;
        its docstring gives the four passes: the per-file segmented
        max-affine size scan, the per-cell grouping, the logged reads'
        answers, the final state). Leading axes are batch axes; the
        scans run in int64, as the reference's under x64."""
        W = opcodes.shape[-1]
        dev = opcodes.device
        lead = opcodes.shape[:-1]
        i64 = torch.int64
        fd, blk, val = args[..., 0], args[..., 1], args[..., 2]
        is_wr = opcodes == FS_WRITE
        is_tr = opcodes == FS_TRUNCATE
        is_rd = opcodes == FS_READ_LOGGED
        wr_ok = is_wr & _ok(fd, blk)
        fd_c = fd.clamp(0, n_files - 1)
        blk_c = blk.clamp(0, n_blocks - 1)
        idx = torch.arange(W, dtype=i64, device=dev).expand(lead + (W,))
        neg = torch.full(lead + (1,), -1, dtype=i64, device=dev)

        def take(x, order):
            return x.gather(-1, order)

        def unsort(order, x, fill):
            # `order` is a permutation: no duplicate scatter indices
            return torch.full_like(x, fill).scatter(-1, order, x)

        def seg_starts(s):
            return torch.cat([torch.ones_like(s[..., :1], dtype=torch.bool),
                              s[..., 1:] != s[..., :-1]], dim=-1)

        def run_max(a, b):
            va, fa = a
            vb, fb = b
            return torch.where(fb, vb, torch.maximum(va, vb)), fa | fb

        # ---- pass 1: per-file segmented size scan (logged reads ride
        # along as identity elements)
        size_active = wr_ok | is_tr
        f_eff = torch.where(size_active | is_rd, fd_c.to(i64),
                            torch.full_like(fd_c, n_files, dtype=i64))
        sf, order_f = torch.sort(f_eff, dim=-1, stable=True)
        seg_start = seg_starts(sf)
        tr_f = take(is_tr, order_f)
        ninf = torch.full(sf.shape, NINF, dtype=i64, device=dev)
        zero = torch.zeros_like(ninf)
        m_el = torch.where(tr_f, ninf, zero)
        c_el = torch.where(
            tr_f, zero,
            torch.where(take(wr_ok, order_f),
                        (take(blk_c, order_f) + 1).to(i64), ninf),
        )
        s0 = state["size"].gather(
            -1, sf.clamp(max=n_files - 1)).to(i64)

        def compose(a, b):
            ma, ca, fa = a
            mb, cb, fb = b
            m = torch.where(fb, mb, torch.clamp(ma + mb, min=NINF))
            c = torch.where(fb, cb, torch.maximum(ca + mb, cb))
            return m, c, fa | fb

        start_m = torch.where(seg_start, ninf, m_el)
        start_c = torch.where(seg_start, torch.maximum(s0 + m_el, c_el),
                              c_el)
        _, pc, _ = associative_scan(compose, (start_m, start_c, seg_start))
        size_after_s = pc
        prev_pc = torch.cat([pc[..., :1] * 0, pc[..., :-1]], dim=-1)
        size_before_s = torch.where(seg_start, s0, prev_pc)
        size_after = unsort(order_f, size_after_s, 0)
        size_before = unsort(order_f, size_before_s, 0)
        tr_idx_el = torch.where(tr_f, take(idx, order_f),
                                torch.full_like(sf, -1))
        tm, _ = associative_scan(run_max, (tr_idx_el, seg_start))
        prev_tm = torch.cat([neg, tm[..., :-1]], dim=-1)
        last_tr_before = unsort(
            order_f, torch.where(seg_start, torch.full_like(tm, -1),
                                 prev_tm), -1)

        # final per file: the size at its segment's end, and its last
        # truncate (the reference's `mode="drop"` scatter becomes a
        # sentinel slot that is cut off; segment ends are distinct)
        seg_end = torch.cat([sf[..., 1:] != sf[..., :-1],
                             torch.ones_like(sf[..., :1],
                                             dtype=torch.bool)], dim=-1)
        file_slot = torch.where(seg_end & (sf < n_files), sf,
                                torch.full_like(sf, n_files))
        size0 = state["size"].to(i64).expand(lead + (n_files,))
        new_size = torch.cat([size0, torch.zeros_like(size0[..., :1])],
                             dim=-1).scatter(-1, file_slot,
                                             size_after_s)[..., :n_files]
        last_tr_of_file = torch.full(
            lead + (n_files + 1,), -1, dtype=i64, device=dev,
        ).scatter(-1, file_slot, tm)[..., :n_files]

        # ---- pass 2: per-cell grouping (writes + logged reads)
        cell_active = wr_ok | is_rd
        n_cells = n_files * n_blocks
        cell = torch.where(
            cell_active, fd_c.to(i64) * n_blocks + blk_c.to(i64),
            torch.full_like(fd_c, n_cells, dtype=i64),
        )
        sc, order_c = torch.sort(cell, dim=-1, stable=True)
        cstart = seg_starts(sc)
        w_idx_el = torch.where(take(wr_ok, order_c), take(idx, order_c),
                               torch.full_like(sc, -1))
        cm, _ = associative_scan(run_max, (w_idx_el, cstart))
        prev_cm = torch.cat([neg, cm[..., :-1]], dim=-1)
        last_wr_before = unsort(
            order_c, torch.where(cstart, torch.full_like(cm, -1),
                                 prev_cm), -1)

        # ---- responses
        j = last_wr_before
        k = last_tr_before
        data_flat = state["data"].reshape(state["data"].shape[:-2]
                                          + (n_cells,))
        init_val = data_flat.expand(lead + (n_cells,)).gather(
            -1, fd_c.to(i64) * n_blocks + blk_c.to(i64))
        in_range = _ok(fd, blk)
        minus1 = torch.full_like(val, -1)
        rd_val = torch.where(
            j > k,
            val.gather(-1, j.clamp(min=0)),
            torch.where(k >= 0, torch.zeros_like(val),
                        torch.where(in_range, init_val, minus1)),
        )
        rd_val = torch.where(in_range, rd_val, minus1)
        resps = torch.where(
            is_wr,
            torch.where(wr_ok, size_after.to(torch.int32), minus1),
            torch.where(is_tr, size_before.to(torch.int32),
                        torch.where(is_rd, rd_val, torch.zeros_like(val))),
        )

        # ---- final state: a cell's last write survives iff it follows
        # the file's last truncate
        cell_wr = torch.where(wr_ok, cell,
                              torch.full_like(cell, n_cells))
        last_w = torch.full(
            lead + (n_cells + 1,), -1, dtype=i64, device=dev,
        ).scatter_reduce(-1, cell_wr, idx, "amax",
                         include_self=True)[..., :n_cells]
        lv = val.gather(-1, last_w.clamp(min=0)) if W else \
            torch.zeros_like(last_w, dtype=torch.int32)
        last_w = last_w.reshape(lead + (n_files, n_blocks))
        lv = lv.reshape(lead + (n_files, n_blocks))
        ltr = last_tr_of_file[..., None]
        return {
            "data_wins": (last_w >= 0) & (last_w > ltr),
            "data_value": lv,
            "data_cleared": ltr >= 0,
            "size_final": new_size.to(torch.int32),
            "resps": resps,
        }

    def window_merge(states, plan):
        data = torch.where(
            plan["data_wins"], plan["data_value"],
            torch.where(plan["data_cleared"], 0, states["data"]),
        )
        lead = data.shape[:-2]
        return {"data": data,
                "size": plan["size_final"].expand(
                    lead + (n_files,)).clone()}, \
            plan["resps"].expand(lead + plan["resps"].shape[-1:])

    def window_apply(states, opcodes, args):
        return window_merge(states, window_plan(states, opcodes, args))

    return Dispatch(
        name=f"memfs{n_files}x{n_blocks}",
        make_state=make_state,
        write_ops=(write, truncate, read_logged),
        read_ops=(read, size),
        arg_width=3,
        window_apply=window_apply,
        window_plan=window_plan,
        window_merge=window_merge,
        window_canonical=True,
    )
