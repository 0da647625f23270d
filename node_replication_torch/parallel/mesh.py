"""Mesh placement: replicas (and CNR's logs) across devices.

The port of `node_replication_tpu/parallel/mesh.py` (its docstring maps
the reference's NUMA placement onto a device mesh). The reference is
one JAX program over a `Mesh`: states carry `NamedSharding(mesh,
P('replica'))` and GSPMD inserts the collectives. PyTorch has no
single-process GSPMD, so the port keeps the reference's single
controller and makes the placement explicit:

- `Mesh` is a numpy object array of `torch.device`s shaped `(replica,
  log)` with the reference's `axis_names`, `shape` and `devices`.
- A device may appear more than once. This reproduces the reference's
  eight virtual host devices (`--xla_force_host_platform_device_count`,
  `tests/conftest.py`), which PyTorch cannot fake: the CPU tests build
  meshes of eight `cpu` entries, one H100 runs N shards on `cuda:0`,
  and a host with several cards puts one shard on each.
- `place(log, states, mesh)` returns a `Placed` fleet: mesh row s holds
  the replica rows `[s * R/S, (s+1) * R/S)` of the states and the
  ltails on the row's first device; the ring planes and the scalar
  cursors are copied once per distinct device (every shard appends
  the identical span, so every copy stays equal). A `MultiLogState`
  places the same way: rows by replica, every log's ring on each row
  device (ROADMAP.md queue 3 says why the log column does not hold
  its rings alone).
- Collectives are host-issued joins over the per-shard tensors
  (`parallel/collectives.py`).
"""

from __future__ import annotations

import enum
from typing import Any, NamedTuple

import numpy as np
import torch

from node_replication_torch.core.log import LogState
from node_replication_torch.core.multilog import MultiLogState
from node_replication_torch.utils.tree import tree_leaves, tree_map

_RING_FIELDS = ("opcodes", "args", "head", "tail", "ctail")


def _device(d) -> torch.device:
    """`d` as a `torch.device` with its index: a bare `cuda` means the
    current card, so that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of torch devices with named axes (the reference's
    `jax.sharding.Mesh`): `devices` is a numpy object array, `shape`
    maps each axis name to its size. Devices may repeat."""

    def __init__(self, devices, axis_names=("replica", "log")):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = _device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"{arr.ndim}-d device grid for axes {axis_names}"
            )
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


class ReplicaStrategy(enum.Enum):
    """Replica-shard placement granularity (`ReplicaStrategy`,
    `benches/mkbench.rs:321-362`): ONE puts the fleet on one device,
    PER_HOST one shard per host (one process here, so one device),
    PER_DEVICE one shard on every device."""

    ONE = "one"
    PER_HOST = "per_host"
    PER_DEVICE = "per_device"


def strategy_devices(strategy: ReplicaStrategy, topo=None, mapping=None):
    """Ordered device list realizing a ReplicaStrategy (the
    `replica_core_allocation` analog, `benches/mkbench.rs:838-945`)."""
    from node_replication_torch.parallel.topology import (
        MachineTopology,
        ThreadMapping,
    )

    topo = topo or MachineTopology()
    mapping = mapping or ThreadMapping.SEQUENTIAL
    if strategy == ReplicaStrategy.ONE:
        return topo.allocate(mapping, 1)
    if strategy == ReplicaStrategy.PER_HOST:
        hosts = sorted({i.process for i in topo.infos})
        return [topo.devices_on_host(p)[0] for p in hosts]
    return topo.allocate(mapping, topo.n_devices())


def _default_devices():
    from node_replication_torch.parallel.topology import cuda_devices

    return cuda_devices()


def make_mesh(n_replica_shards: int | None = None, n_log_shards: int = 1,
              devices=None) -> Mesh:
    """Build a ('replica', 'log') mesh. Defaults to every CUDA device
    on the replica axis."""
    devices = list(devices if devices is not None else _default_devices())
    total = len(devices)
    if n_replica_shards is None:
        n_replica_shards = total // n_log_shards
    if n_replica_shards * n_log_shards != total:
        raise ValueError(
            f"{n_replica_shards}x{n_log_shards} mesh needs "
            f"{n_replica_shards * n_log_shards} devices, got {total}"
        )
    arr = np.empty(total, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = _device(d)
    return Mesh(arr.reshape(n_replica_shards, n_log_shards),
                ("replica", "log"))


def replica_mesh(n_shards: int | None = None, devices=None,
                 strategy: ReplicaStrategy | None = None,
                 mapping=None) -> Mesh:
    """One-axis ('replica', 'log'=1) mesh for a replica-sharded fleet,
    the `NodeReplicated(mesh=...)` convenience: `n_shards=None` takes
    every device; a `ReplicaStrategy` picks them through the topology
    walk."""
    if strategy is not None:
        devices = strategy_devices(strategy, mapping=mapping)
        if n_shards is not None:
            devices = devices[:n_shards]
    elif devices is None:
        devices = _default_devices()
        if n_shards is not None:
            devices = list(devices)[:n_shards]
    return make_mesh(len(list(devices)), 1, devices=devices)


class Shard(NamedTuple):
    """Mesh row `index` of a placed fleet: replica `rows` on `device`.
    `log` carries this shard's ltails; its ring planes and scalar
    cursors are the device's copy."""

    index: int
    device: torch.device
    rows: slice
    log: Any
    states: Any


def _ring_copy(log, device) -> dict:
    return {f: getattr(log, f).to(device) for f in _RING_FIELDS}


def _ltails_rows(ltails, rows: slice, device):
    # a shard owns its cursors (CNR writes them in place): never a view
    # of another tensor
    return ltails[..., rows].to(device, copy=True)


class Placed:
    """A fleet placed over a mesh: one `Shard` per mesh row. Immutable:
    a round builds a new `Placed` from its shards' results. `gather()`
    is the global view on the home device (mesh row 0's), cached; the
    wrapper's non-round paths read it."""

    __slots__ = ("mesh", "shards", "_log", "_states")

    def __init__(self, mesh: Mesh, shards: list[Shard], log=None,
                 states=None):
        self.mesh = mesh
        self.shards = list(shards)
        # the gathered global views, built at first use
        self._log = log
        self._states = states

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_replicas(self) -> int:
        return self.shards[-1].rows.stop

    @property
    def home(self) -> torch.device:
        return self.shards[0].device

    def devices(self) -> list[torch.device]:
        """The distinct shard devices, in mesh-row order."""
        out: list[torch.device] = []
        for sh in self.shards:
            if sh.device not in out:
                out.append(sh.device)
        return out

    def shard_of(self, rid: int) -> tuple[int, int]:
        """`(shard, local index)` of replica `rid`."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        per = self.n_replicas // self.n_shards
        return rid // per, rid % per

    @property
    def log(self):
        """The global log on the home device: shard 0's ring and
        cursors with every shard's ltails."""
        if self._log is None:
            home = self.home
            self._log = self.shards[0].log._replace(ltails=torch.cat(
                [sh.log.ltails.to(home) for sh in self.shards], dim=-1))
        return self._log

    @property
    def states(self):
        """The global states on the home device (one copy of every
        shard's rows)."""
        if self._states is None:
            home = self.home
            self._states = tree_map(
                lambda *xs: torch.cat([x.to(home) for x in xs], dim=0),
                *[sh.states for sh in self.shards])
        return self._states

    def gather(self):
        """`(log, states)`: the global view on the home device."""
        return self.log, self.states

    def trees(self) -> list:
        """Every shard's `(log, states)`, for `utils/fence.py:fence`."""
        return [(sh.log, sh.states) for sh in self.shards]

    def with_log(self, log) -> "Placed":
        """This fleet with `log` placed in place of its log (rings
        copied per distinct device, ltails split by row)."""
        rings = {d: _ring_copy(log, d) for d in self.devices()}
        shards = [
            sh._replace(log=log._replace(
                ltails=_ltails_rows(log.ltails, sh.rows, sh.device),
                **rings[sh.device]))
            for sh in self.shards
        ]
        return Placed(self.mesh, shards)

    def with_states(self, states) -> "Placed":
        """This fleet with `states` placed in place of its states."""
        shards = [
            sh._replace(states=tree_map(
                lambda x, sh=sh: x[sh.rows].to(sh.device), states))
            for sh in self.shards
        ]
        return Placed(self.mesh, shards)

    def with_shards(self, logs, states) -> "Placed":
        """A new fleet from per-shard logs and states (a round's
        results, in shard order)."""
        shards = [sh._replace(log=lg, states=st)
                  for sh, lg, st in zip(self.shards, logs, states)]
        return Placed(self.mesh, shards)


def row_devices(mesh: Mesh) -> list[torch.device]:
    """The first device of each mesh row: where a replica shard lives."""
    return [row.flat[0] for row in mesh.devices.reshape(
        mesh.shape["replica"], -1)]


def place(log, states, mesh: Mesh) -> Placed:
    """Place a fleet over `mesh`: replica rows (states and ltails) by
    mesh row, on the row's first device; ring planes and scalar cursors
    (a `LogState`'s, or every log's of a `MultiLogState`) copied once
    per distinct device. Needs `R % mesh.shape['replica'] == 0`."""
    if not isinstance(log, (LogState, MultiLogState)):
        raise TypeError(f"place() takes a LogState or MultiLogState, "
                        f"got {type(log).__name__}")
    devs = row_devices(mesh)
    R = int(log.ltails.shape[-1])
    if R % len(devs):
        raise ValueError(f"R={R} not divisible by {len(devs)} shards")
    per = R // len(devs)
    rings = {}
    for d in devs:
        if d not in rings:
            rings[d] = _ring_copy(log, d)
    shards = []
    for s, d in enumerate(devs):
        rows = slice(s * per, (s + 1) * per)
        shards.append(Shard(
            index=s, device=d, rows=rows,
            log=log._replace(ltails=_ltails_rows(log.ltails, rows, d),
                             **rings[d]),
            states=tree_map(lambda x: x[rows].to(d), states),
        ))
    # the input is the global view as long as it sits on the home
    # device (its ring is then shard 0's copy)
    if all(t.device == devs[0] for t in
           [log.tail, log.ltails] + tree_leaves(states)):
        return Placed(mesh, shards,
                      log._replace(ltails=log.ltails.clone()), states)
    return Placed(mesh, shards)


def announce_placement(mesh: Mesh, n_replicas: int, wrapper: str,
                       tier: str) -> None:
    """Record a wrapper's mesh placement in obs: the `mesh.devices` and
    `mesh.replicas_per_device` gauges and one `mesh-place` event."""
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.utils.trace import get_tracer

    n_shards = int(np.prod(mesh.devices.shape))
    per_device = n_replicas // max(1, mesh.shape.get("replica", 1))
    reg = get_registry()
    reg.gauge("mesh.devices").set(n_shards)
    reg.gauge("mesh.replicas_per_device").set(per_device)
    get_tracer().emit(
        "mesh-place", wrapper=wrapper, devices=n_shards,
        replicas=n_replicas, per_device=per_device, tier=tier,
        shape=dict(mesh.shape),
    )


def shard_step(step_fn, mesh: Mesh, log_template, states_template,
               batch_spec=None, donate: bool = True):
    """The reference's `shard_step`: a `make_step`-style step under the
    mesh, with `step_fn`'s signature and results.

    How it runs: the reference jits `step_fn` with shardings and GSPMD
    partitions it; the port has no GSPMD, so the returned step moves
    its inputs (a `Placed` fleet is gathered) to the home device (mesh
    row 0's), runs `step_fn` there and returns its results there. The
    per-shard program with its explicit joins is
    `parallel/collectives.py:make_shmap_step`. `batch_spec` and
    `donate` are accepted for the reference's signature; the port never
    writes its inputs."""
    del batch_spec, donate
    R = int(log_template.ltails.shape[-1])
    shards = mesh.shape["replica"]
    if R % shards:
        raise ValueError(f"R={R} not divisible by {shards} shards")
    home = row_devices(mesh)[0]
    del states_template

    def step(log, states, *batches):
        if isinstance(log, Placed):
            log, states = log.gather()
        log = tree_map(lambda x: x.to(home), log)
        states = tree_map(lambda x: x.to(home), states)
        return step_fn(log, states, *(b.to(home) for b in batches))

    return step
