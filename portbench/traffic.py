"""The one generator of traffic: every mix is a data file,
`traffic/<name>.json`, that this module reads.

A mix names its driver (`drivers/<driver>.py`) and that driver's
parameters (clients, served rids, batch limits, the round's window),
the op names and their weights (`mix`, names the model adapter knows),
and the keys: `dist` `uniform`, over the whole keyspace (`scope` `all`)
or over a client's own slice of it (`scope` `client`: keyspace //
clients keys from c * that, with spans cut inside it). Values are
uniform over [0, 2^31).

Every stream is seeded from the run's seed and its own number, so the
same seed gives the same ops, whatever the order threads draw them in.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def seed_words(seed: int, stream: int) -> list[int]:
    """The SeedSequence entropy of one stream: any whole seed, taken
    modulo 2^64."""
    return [int(seed) % (1 << 64), int(stream)]


class Stream:
    """An endless op stream: client `client` of the mix, or the round loop's
    own (`client` 0 with `scope` `all`)."""

    def __init__(self, spec: dict, model, seed: int, client: int = 0):
        self.spec = spec
        self.model = model
        self.rng = np.random.default_rng(seed_words(seed, client))
        self.kinds = list(spec["mix"])
        w = np.array([spec["mix"][k] for k in self.kinds], np.float64)
        self.p = w / w.sum()
        keys = spec["keys"]
        self.clip = keys["scope"] == "client"
        if self.clip:
            size = model.keyspace // int(spec["clients"])
            self.lo, self.hi = client * size, (client + 1) * size
        elif keys["scope"] == "all":
            self.lo, self.hi = 0, model.keyspace
        else:
            raise ValueError(f"unknown key scope {keys['scope']!r}")
        if keys["dist"] != "uniform":
            raise ValueError(f"unknown key distribution {keys['dist']!r}")

    def draw(self, n: int):
        """The next `n` ops: `(opc int32[n], args int32[n, A], write
        bool[n])`."""
        kind = self.rng.choice(len(self.kinds), n, p=self.p)
        keys = self.rng.integers(self.lo, self.hi, n)
        vals = self.rng.integers(0, 1 << 31, n)
        return self.model.make_ops(self.kinds, kind, keys, vals, self.lo,
                                   self.hi, clip=self.clip)


def tuples(model, opc, args, write) -> list[tuple]:
    """The ops as the program's entry points take them: `(opcode,
    *args)`, each with as many args as the model gives its kind."""
    n_args = model.n_args(opc, write)
    widest = int(n_args.max(initial=0))
    out = list(zip(opc.tolist(), *args[:, :widest].T.tolist()))
    for k in range(widest):
        for i in np.flatnonzero(n_args == k).tolist():
            out[i] = out[i][:k + 1]
    return out
