"""The flat page table: the program's fleet and the plain reference's
rules.

The program is `node_replication_torch`'s `NodeReplicated` over
`make_vspace(n_pages, max_span)`: per replica one last-level table
`frames int32[P]`, 0 meaning unmapped. Lane i < clip(npages, 0,
max_span) of a span touches page `(vpage + i) mod P` (floored) when the
int32 sum `vpage + i` is below P. MAP (opcode 1, args vpage, pframe,
npages) sets each such page to the int32 sum `pframe + i` and answers
how many of them were unmapped; UNMAP (2, vpage, npages) sets them to 0
and answers how many were mapped; IDENTIFY (read opcode 1, vpage)
answers the frame of page `vpage mod P`, or -1 if it is unmapped.

The reference keeps one copy of the table (`val`; `pres` is carried
for the event machinery and never read here) and replays ops as page
events (`reference.py`); `step` is the same rules as a loop over
single ops, for the tests.
"""

from __future__ import annotations

import numpy as np
import torch

MAP, UNMAP, IDENTIFY = 1, 2, 1


def _wrap32(x):
    """The int32 value of an int64 quantity, as int32 arithmetic wraps."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class Model:
    KINDS = {"map": (MAP, True), "unmap": (UNMAP, True),
             "identify": (IDENTIFY, False)}
    ARG_WIDTH = 3
    #: bytes of one cell (page) of state: the int32 frame
    CELL_BYTES = 4

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.keyspace = int(cfg["n_pages"])
        self.max_span = int(cfg["max_span"])
        self.n_replicas = int(cfg["n_replicas"])

    # ---------------------------------------------------------- traffic

    def make_ops(self, kinds: list, kind_idx, keys, vals, lo: int, hi: int,
                 clip: bool = False):
        """`(opc int32[N], args int32[N, 3], write bool[N])`, as the
        source's bench (`benches/vspace.py --flat`) draws them: vpage =
        key; MAP's pframe = val and npages = 1 + pframe % max_span;
        UNMAP's npages = val itself, which the model clips to max_span.
        A span is cut to end before `hi` when `clip`."""
        del lo
        opc = np.array([self.KINDS[k][0] for k in kinds], np.int32)[kind_idx]
        write = np.array([self.KINDS[k][1] for k in kinds], bool)[kind_idx]
        is_map = write & (opc == MAP)
        is_unmap = write & (opc == UNMAP)
        vals = vals.astype(np.int64)
        npages = np.where(is_map, 1 + vals % self.max_span, vals)
        if clip:
            npages = np.minimum(npages, hi - keys.astype(np.int64))
        args = np.zeros((len(opc), self.ARG_WIDTH), np.int32)
        args[:, 0] = keys
        args[is_map, 1] = vals[is_map]
        args[is_map, 2] = npages[is_map]
        args[is_unmap, 1] = npages[is_unmap]
        return opc, args, write

    @staticmethod
    def n_args(opc, write):
        """How many of an op's args its tuple carries: MAP 3, UNMAP 2,
        IDENTIFY 1."""
        return np.where(write, np.where(opc == MAP, 3, 2), 1)

    # ---------------------------------------------------------- program

    def initial(self, gen: torch.Generator, device) -> dict:
        """An empty table, as `make_vspace` starts."""
        del gen
        p = self.keyspace
        return {"val": torch.zeros(p, dtype=torch.int32, device=device),
                "pres": torch.zeros(p, dtype=torch.bool, device=device)}

    def build(self, planes: dict, device):
        from node_replication_torch import NodeReplicated
        from node_replication_torch.models.vspace import make_vspace

        p, r = self.keyspace, self.n_replicas
        nr = NodeReplicated(make_vspace(p, max_span=self.max_span), r,
                            log_entries=int(self.cfg["log_entries"]),
                            engine=self.cfg["engine"], device=device)
        nr.states = {"frames": planes["val"].expand(r, p).contiguous()}
        return nr

    @staticmethod
    def fleet_state(nr) -> dict:
        nr.sync()
        return {"val": nr.states["frames"]}

    @staticmethod
    def mismatch(fleet: dict, planes: dict, rows: int = 64) -> int:
        """Pages of every replica that differ from the reference's."""
        bad = 0
        for i in range(0, fleet["val"].shape[0], rows):
            bad += int((fleet["val"][i:i + rows] != planes["val"]).sum())
        return bad

    # -------------------------------------------------------- reference

    def events(self, opc, args, write, store=torch.int32) -> dict:
        """A write's events are its span's pages; an IDENTIFY reads one."""
        n, s, p = opc.shape[0], self.max_span, self.keyspace
        dev = opc.device
        lanes = torch.arange(s, dtype=torch.int64, device=dev)
        is_map = write & (opc == MAP)
        npages = torch.where(is_map, args[:, 2], args[:, 1]).long()
        count = torch.where(write, npages.clamp(0, s), 1)
        raw = _wrap32(args[:, :1].long() + lanes)
        ok = (lanes < count[:, None]) & (~write[:, None] | (raw < p))
        page = torch.remainder(raw, p)
        frame = _wrap32(args[:, 1:2].long() + lanes)
        val = torch.where(is_map[:, None], frame, 0).to(store).to(torch.int32)
        op = torch.arange(n, device=dev)[:, None].expand(n, s)
        return {
            "op": op[ok], "cell": page[ok],
            "write": write[:, None].expand(n, s)[ok],
            "val": val[ok], "pres": val[ok] != 0,
        }

    @staticmethod
    def responses(opc, write, ev, before_val, before_pres, n: int):
        del before_pres
        is_map = write & (opc == MAP)
        unmapped = before_val == 0
        hits = torch.where(is_map[ev["op"]], unmapped, ~unmapped).long()
        counts = torch.zeros(n, dtype=torch.int64,
                             device=opc.device).index_add_(0, ev["op"], hits)
        read = torch.full((n,), -1, dtype=torch.int64, device=opc.device)
        rd = ~ev["write"]
        read[ev["op"][rd]] = torch.where(unmapped[rd], -1,
                                         before_val[rd].long())
        return torch.where(write, counts, read)

    def step(self, planes: dict, opc: int, args, write: bool) -> int:
        """One op against a numpy table, as a loop applies the rules:
        its response."""
        frames, p = planes["val"], self.keyspace
        if not write:
            f = int(frames[int(args[0]) % p])
            return -1 if f == 0 else f
        is_map = opc == MAP
        n = min(max(int(args[2] if is_map else args[1]), 0), self.max_span)
        resp = 0
        for i in range(n):
            raw = int(_wrap32(int(args[0]) + i))
            if raw >= p:
                continue
            page = raw % p
            if is_map:
                resp += int(frames[page] == 0)
                frames[page] = _wrap32(int(args[1]) + i)
            else:
                resp += int(frames[page] != 0)
                frames[page] = 0
        return resp
