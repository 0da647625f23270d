"""The CNR hashmap: the hashmap's ops, prefill and rules (`hashmap.py`)
on the program's `MultiLogReplicated` over `n_logs` logs.

The `LogMapper` sends an op to log `cell % L`, its key's cell modulo the
log count, so every op on a cell goes to one log, in submission order,
and every replica replays each log in order. Ops on different logs touch
different cells and commute. So the answers and the final cells are
those of one in-order replay of the whole stream, which is what
`reference.py` computes (the tests hold the two equal). `fleet_state`
is the hashmap's: `sync()` syncs every log.
"""

from __future__ import annotations

from portbench.models import hashmap


class Model(hashmap.Model):
    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.n_logs = int(cfg["n_logs"])

    def log_of(self, opcode: int, args: tuple) -> int:
        """The `LogMapper`: the log of the op's cell."""
        del opcode
        return int(args[0]) % self.keyspace % self.n_logs

    def build(self, planes: dict, device):
        """The program's fleet, every replica holding `planes`."""
        from node_replication_torch import MultiLogReplicated, make_hashmap

        k, r = self.keyspace, self.n_replicas
        nr = MultiLogReplicated(make_hashmap(k), self.log_of,
                                nlogs=self.n_logs, n_replicas=r,
                                log_entries=int(self.cfg["log_entries"]),
                                engine=self.cfg["engine"], device=device)
        nr.states = {
            "values": planes["val"].expand(r, k).contiguous(),
            "present": planes["pres"].expand(r, k).contiguous(),
        }
        return nr
