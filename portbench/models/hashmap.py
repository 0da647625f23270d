"""The hashmap: the program's fleet and the plain reference's rules.

The program is `node_replication_torch`'s `NodeReplicated` over
`make_hashmap(n_keys)`: per replica a dense `values int32[K]` and
`present bool[K]`, keys taken floored modulo K. PUT (opcode 1, args
key, value) answers 0; REMOVE (2, key) answers 1 if the key was
present, else 0, and leaves the value 0; GET (read opcode 1, key)
answers the value, or -1 if absent.

The reference keeps one copy of the two planes ({"val", "pres"}) and
replays ops as cell events (`reference.py`); `step` is the same rules
as a loop over single ops, for the tests.
"""

from __future__ import annotations

import numpy as np
import torch

PUT, REMOVE, GET = 1, 2, 1


class Model:
    #: traffic's op names: (opcode, is a write)
    KINDS = {"put": (PUT, True), "remove": (REMOVE, True), "get": (GET, False)}
    ARG_WIDTH = 3
    #: bytes of one cell of state over the model's planes: int32 value,
    #: bool presence
    CELL_BYTES = 5

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.keyspace = int(cfg["n_keys"])
        self.n_replicas = int(cfg["n_replicas"])

    # ---------------------------------------------------------- traffic

    def make_ops(self, kinds: list, kind_idx, keys, vals, lo: int, hi: int,
                 clip: bool = False):
        """`(opc int32[N], args int32[N, 3], write bool[N])` from the
        traffic's draws: `kind_idx` indexes `kinds`, keys lie in
        [lo, hi), values in [0, 2^31). A key is one cell, so `clip`
        changes nothing."""
        del lo, hi, clip
        opc = np.array([self.KINDS[k][0] for k in kinds], np.int32)[kind_idx]
        write = np.array([self.KINDS[k][1] for k in kinds], bool)[kind_idx]
        args = np.zeros((len(opc), self.ARG_WIDTH), np.int32)
        args[:, 0] = keys
        put = write & (opc == PUT)
        args[put, 1] = vals[put]
        return opc, args, write

    @staticmethod
    def n_args(opc, write):
        """How many of an op's args its tuple carries: PUT 2, REMOVE and
        GET 1."""
        return np.where(write & (opc == PUT), 2, 1)

    # ---------------------------------------------------------- program

    def initial(self, gen: torch.Generator, device) -> dict:
        """The prefill: every key present, its value drawn from the
        seed over [0, 2^31)."""
        k = self.keyspace
        val = torch.randint(0, 1 << 31, (k,), generator=gen,
                            dtype=torch.int32, device=device)
        return {"val": val,
                "pres": torch.ones(k, dtype=torch.bool, device=device)}

    def build(self, planes: dict, device):
        """The program's fleet, every replica holding `planes`."""
        from node_replication_torch import NodeReplicated, make_hashmap

        k, r = self.keyspace, self.n_replicas
        nr = NodeReplicated(make_hashmap(k), r,
                            log_entries=int(self.cfg["log_entries"]),
                            engine=self.cfg["engine"], device=device)
        nr.states = {
            "values": planes["val"].expand(r, k).contiguous(),
            "present": planes["pres"].expand(r, k).contiguous(),
        }
        return nr

    @staticmethod
    def fleet_state(nr) -> dict:
        nr.sync()
        return {"val": nr.states["values"], "pres": nr.states["present"]}

    @staticmethod
    def mismatch(fleet: dict, planes: dict, rows: int = 512) -> int:
        """Cells of every replica, in both planes, that differ from the
        reference's planes."""
        bad = 0
        for i in range(0, fleet["val"].shape[0], rows):
            bad += int((fleet["val"][i:i + rows] != planes["val"]).sum())
            bad += int((fleet["pres"][i:i + rows] != planes["pres"]).sum())
        return bad

    # -------------------------------------------------------- reference

    def events(self, opc, args, write, store=torch.int32) -> dict:
        """One event an op, on its key's cell: a PUT writes (value,
        present), a REMOVE (0, absent), a GET reads."""
        is_put = write & (opc == PUT)
        is_rem = write & (opc == REMOVE)
        return {
            "op": torch.arange(opc.shape[0], device=opc.device),
            "cell": torch.remainder(args[:, 0].long(), self.keyspace),
            "write": is_put | is_rem,
            "val": torch.where(is_put, args[:, 1], 0).to(store).to(
                torch.int32),
            "pres": is_put,
        }

    @staticmethod
    def responses(opc, write, ev, before_val, before_pres, n: int):
        del ev, n
        is_rem = write & (opc == REMOVE)
        read = torch.where(before_pres, before_val.long(), -1)
        return torch.where(
            write, torch.where(is_rem, before_pres.long(), 0), read)

    @staticmethod
    def step(planes: dict, opc: int, args, write: bool) -> int:
        """One op against numpy planes, as a loop applies the rules:
        its response."""
        k = int(args[0]) % len(planes["val"])
        if not write:
            return int(planes["val"][k]) if planes["pres"][k] else -1
        if opc == PUT:
            planes["val"][k] = args[1]
            planes["pres"][k] = True
            return 0
        was = bool(planes["pres"][k])
        planes["val"][k] = 0
        planes["pres"][k] = False
        return int(was)
