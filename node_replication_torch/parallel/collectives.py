"""Explicit-collective multi-device replay over a placed fleet.

The port of `node_replication_tpu/parallel/collectives.py` (its
docstring holds the design: the shmap step and exec, the ring replay of
a long window, the mesh-fused round). The reference writes each as a
`shard_map` program with `all_gather`/`pmax`/`pmin`/`ppermute` over
ICI. The port runs one Python loop over the mesh shards of a `Placed`
fleet (`parallel/mesh.py`), which is the form of the reference's own
`MeshFusedEngine._sliced_round`, pinned bit-identical to its
`shard_map` program by the reference's tests:

- the shard-local program runs on each shard's tensors, on its device;
- `pmax`/`pmin` become host-issued reductions over the per-shard
  scalars, each moved to the home device (`_cursor_lattice_join`);
- `all_gather` is a concatenation, `ppermute` a `.to(next_device)`.

Where the reference passes a fleet as the pair `(log, states)` of
sharded global arrays, the port passes one `Placed`: the built
functions take and return it (`exec(fleet) -> (fleet, resps)`).
Global outputs (responses) are concatenated on the home device in
mesh-row order.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from node_replication_torch.core import log as _corelog
from node_replication_torch.core.log import (
    LogSpec,
    _FAR,
    _exec_one,
    log_append,
)
from node_replication_torch.ops.encoding import (
    Dispatch,
    NOOP,
    apply_write,
    dispatch_reads,
)
from node_replication_torch.ops.ring import FusedEngineHost
from node_replication_torch.parallel.mesh import Mesh, Placed, row_devices
from node_replication_torch.utils.checks import check
from node_replication_torch.utils.tree import tree_leaves, tree_map


def _shards_of(mesh: Mesh, spec: LogSpec, axis: str) -> int:
    nshards = mesh.shape[axis]
    if spec.n_replicas % nshards:
        raise ValueError(
            f"R={spec.n_replicas} not divisible by {nshards} shards")
    return nshards


def _per_device(fleet: Placed, *tensors):
    """`tensors` copied once to each distinct shard device:
    `{device: (t0, t1, ...)}`."""
    return {d: tuple(t.to(d) for t in tensors) for d in fleet.devices()}


def _fenced_parts(fleet: Placed, fenced):
    """A global bool[R] mask split by shard (None stays None)."""
    if fenced is None:
        return [None] * fleet.n_shards
    fen = torch.as_tensor(fenced, dtype=torch.bool)
    return [fen[sh.rows].to(sh.device) for sh in fleet.shards]


def _cursor_lattice_join(log, new_lts, fenced_parts=None):
    """The cross-shard half of the exec-round cursor lattice, ONE
    definition for every mesh tier (the reference's
    `_cursor_lattice_join`): `ctail = max(ctail, max over shards of
    max new_lt)`; `head` is the min over UNFENCED cursors, fenced lanes
    composed through the `_FAR` sentinel (an all-fenced fleet holds
    head still), clamped monotone. `log` is the pre-round log on the
    home device, `new_lts` the per-shard new ltails, `fenced_parts` the
    per-shard masks (or None). The per-shard scalars are reduced on the
    home device. Returns `log` with ctail/head replaced."""
    home = log.tail.device

    def reduce(vals, op):
        return op(torch.stack([v.to(home) for v in vals]))

    ctail = torch.maximum(
        log.ctail, reduce([lt.max() for lt in new_lts], torch.max))
    if fenced_parts is None or all(f is None for f in fenced_parts):
        head = torch.maximum(
            log.head, reduce([lt.min() for lt in new_lts], torch.min))
    else:
        gmin = reduce([
            torch.where(f, torch.full_like(lt, _FAR), lt).min()
            for lt, f in zip(new_lts, fenced_parts)
        ], torch.min)
        head = torch.where(gmin >= _FAR, log.head,
                           torch.maximum(log.head, gmin))
    return log._replace(ctail=ctail, head=head)


def _joined(fleet: Placed, new_lts, states, fenced_parts=None,
            ring=None) -> Placed:
    """The fleet after a shard-local round: each shard's new ltails and
    states, ctail/head joined across shards and copied to each device;
    `ring` (per device: a log whose ring planes and tail to take) when
    the round appended."""
    base = fleet.shards[0].log
    if ring is not None:
        base = base._replace(tail=ring[fleet.home].tail)
    joined = _cursor_lattice_join(base, new_lts, fenced_parts)
    by_dev = {d: (joined.ctail.to(d), joined.head.to(d))
              for d in fleet.devices()}
    logs = []
    for sh, lt in zip(fleet.shards, new_lts):
        ctail, head = by_dev[sh.device]
        lg = sh.log
        if ring is not None:
            r = ring[sh.device]
            lg = lg._replace(opcodes=r.opcodes, args=r.args, tail=r.tail)
        logs.append(lg._replace(ltails=lt, ctail=ctail, head=head))
    return fleet.with_shards(logs, states)


def _cat_home(fleet: Placed, parts, dim: int = 0):
    return torch.cat([p.to(fleet.home) for p in parts], dim=dim)


def make_shmap_step(dispatch: Dispatch, spec: LogSpec, mesh: Mesh,
                    writes_per_replica: int, reads_per_replica: int,
                    axis: str = "replica"):
    """Explicit-collective twin of `core/step.make_step`:
    `step(fleet, wr_opcodes, wr_args, rd_opcodes, rd_args) -> (fleet,
    wr_resps int32[R, Bw], rd_resps int32[R, Br])`, batches global.

    The write span is gathered in replica-major order (the
    `all_gather`), every shard appends the identical span to its ring
    copy (once per distinct device), replays it into its own replicas,
    and answers its own lanes' writes and reads; the cursor lattice is
    joined on the host.
    Requires `R % mesh.shape[axis] == 0`."""
    nshards = _shards_of(mesh, spec, axis)
    R = spec.n_replicas
    Rl = R // nshards
    Bw = int(writes_per_replica)
    del reads_per_replica
    span = R * Bw
    local_spec = dataclasses.replace(spec, n_replicas=Rl)

    def step(fleet: Placed, wr_opcodes, wr_args, rd_opcodes, rd_args):
        opc = wr_opcodes.reshape(span)
        args = wr_args.reshape(span, spec.arg_width)
        ring = {}
        for d, (o, a) in _per_device(fleet, opc, args).items():
            sh0 = next(sh for sh in fleet.shards if sh.device == d)
            ring[d] = log_append(spec, sh0.log, o, a, span)
        new_lts, states, wr_parts, rd_parts = [], [], [], []
        for sh in fleet.shards:
            lg = ring[sh.device]._replace(ltails=sh.log.ltails)
            st, resps, lt = _exec_one(local_spec, dispatch, lg, sh.states,
                                      span)
            # own writes: local replica r is global g = s*Rl + r, its
            # entries are window offsets [g*Bw, (g+1)*Bw)
            g = sh.rows.start + torch.arange(Rl, device=sh.device)[:, None]
            own = g * Bw + torch.arange(Bw, device=sh.device)[None, :]
            wr_parts.append(torch.gather(resps, 1, own))
            rd_parts.append(dispatch_reads(
                dispatch, st, rd_opcodes[sh.rows].to(sh.device),
                rd_args[sh.rows].to(sh.device)))
            new_lts.append(lt)
            states.append(st)
        # the join's clamp at the old head is a no-op here: every new
        # ltail is at or past it, so head is make_step's plain min
        return (_joined(fleet, new_lts, states, ring=ring),
                _cat_home(fleet, wr_parts), _cat_home(fleet, rd_parts))

    return step


def sharded_exec(fleet: Placed, shard_fn, fenced=None):
    """Run a shard-local replay `shard_fn(shard, fenced_part) ->
    (new_ltails, states, resps)` on every shard and join the lattice
    (`_cursor_lattice_join`): the form of every mesh exec round.
    Returns `(fleet, resps int32[R, W])` on the home device."""
    parts = _fenced_parts(fleet, fenced)
    new_lts, states, resps = [], [], []
    for sh, fen in zip(fleet.shards, parts):
        lt, st, r = shard_fn(sh, fen)
        new_lts.append(lt)
        states.append(st)
        resps.append(r)
    return _joined(fleet, new_lts, states, parts), _cat_home(fleet, resps)


def make_shmap_exec(dispatch: Dispatch, spec: LogSpec, mesh: Mesh,
                    window: int, axis: str = "replica",
                    fenced: bool = False, donate: bool = True):
    """Explicit-collective twin of `core/log.py:log_exec_all`, the
    exec round of a meshed `NodeReplicated` (`collectives='shmap'`):
    `exec(fleet[, fenced bool[R]]) -> (fleet, resps int32[R, window])`.

    Each shard replays its replicas from their own ltails (`_exec_one`,
    the scan), a fenced replica frozen at its ltail; the lattice is
    joined by `_cursor_lattice_join`, so the fenced-head GC mask holds
    when the corpse sits on another shard than the combiner.
    `resps[r, i]` answers position `old_ltails[r] + i`. `donate` is
    accepted for the reference's signature (the port never writes its
    inputs). The meshed `'gspmd'` tier runs the wrapper's own engine
    through `sharded_exec` the same way."""
    del donate
    nshards = _shards_of(mesh, spec, axis)
    local_spec = dataclasses.replace(spec,
                                     n_replicas=spec.n_replicas // nshards)
    _corelog._m_engine_shmap.inc()

    def shard_fn(sh, fen):
        lt = sh.log.ltails
        limits = (None if fen is None else
                  torch.where(fen, lt, torch.full_like(lt, _FAR)))
        st, r, new_lt = _exec_one(local_spec, dispatch, sh.log, sh.states,
                                  window, limits)
        return new_lt, st, r

    def exec_(fleet: Placed, *mask):
        if bool(mask) != fenced:
            raise ValueError("fenced mask given to an unfenced exec or "
                             "missing from a fenced one")
        return sharded_exec(fleet, shard_fn, mask[0] if fenced else None)

    return exec_


def _apply_chunk(d: Dispatch, states, opc, args):
    """Apply `opc[c]`/`args[c, A]` in order to every replica of a
    shard's states, in place."""
    R = tree_leaves(states)[0].shape[0]
    for j in range(opc.shape[0]):
        apply_write(d, states, opc[j].expand(R),
                    args[j].expand(R, args.shape[1]))


def make_ring_exec(dispatch: Dispatch, mesh: Mesh, axis: str = "replica"):
    """Pipelined ring replay of a long window sharded over the mesh:
    `ring_exec(opcodes int32[W], args int32[W, A], fleet) -> fleet`
    (states updated, log untouched).

    The window splits into P chunks, chunk c starting on shard c.
    Chunks rotate backward one shard per round (`ppermute` as a
    `.to()`), so shard d holds chunk `(d + t) % P` at round t and is
    active for `t in [P-d, 2P-d-1]`: it applies chunks 0..P-1 in log
    order, and outside that window the chunk it holds is masked to
    NOOP (the pipeline's bubbles replay as identity). After `2P - 1`
    rounds every replica applied all W entries in order. W and R must
    divide by P."""
    nshards = mesh.shape[axis]

    def ring_exec(opcodes, args, fleet: Placed) -> Placed:
        W = int(opcodes.shape[0])
        if W % nshards:
            raise ValueError(f"W={W} not divisible by {nshards} shards")
        c = W // nshards
        held = [(opcodes[s * c:(s + 1) * c].to(sh.device),
                 args[s * c:(s + 1) * c].to(sh.device))
                for s, sh in enumerate(fleet.shards)]
        states = [tree_map(lambda x: x.clone(), sh.states)
                  for sh in fleet.shards]
        for t in range(1, 2 * nshards):
            # ppermute: shard d receives what shard d+1 held
            held = [(held[(d + 1) % nshards][0].to(sh.device),
                     held[(d + 1) % nshards][1].to(sh.device))
                    for d, sh in enumerate(fleet.shards)]
            for d, (opc, arg) in enumerate(held):
                active = nshards - d <= t <= 2 * nshards - d - 1
                masked = opc if active else torch.full_like(opc, NOOP)
                _apply_chunk(dispatch, states[d], masked, arg)
        return fleet.with_shards([sh.log for sh in fleet.shards], states)

    return ring_exec


class MeshFusedEngine(FusedEngineHost):
    """The mesh-fused exec tier: the fused append+replay round (K1 for
    the hashmap, K5 for the flat vspace) run once per mesh shard, on
    that shard's replica rows and device, with the cursor lattice
    joined across shards (the reference's `MeshFusedEngine`, in the
    form of its `_sliced_round`).

    - Each shard's inner engine is `dispatch.fused_factory(shard_spec,
      device=shard_device)` with `n_replicas = R / shards`; a factory
      ValueError means no fused form at this config, as un-meshed.
    - Every shard appends the identical span to its device's ring copy.
      Shards on one device read one ring tensor and each launch writes
      a new one; the first shard's output is kept for the device and
      the others dropped (under `debug_checks`, checked equal).
    - `ctail`/`head` come from `_cursor_lattice_join` with the fenced
      mask composed through `_FAR`, so fenced-head GC holds when the
      quarantined replica sits on another shard.
    - `launches(window)` is per device: 1. `tier = "mesh_fused"`,
      `devices = shards`, so `kernel.launches` rises by the shard count
      a round (`FusedEngineHost.note_round`).

    `round(fleet, opcodes, args, count, fenced=None) -> (fleet, resps
    int32[R, W])` is the host entry, with the host's instrumentation
    (`log.engine.mesh_fused`, `kernel.*`, `kernel-launch` with
    `devices=`)."""

    tier = "mesh_fused"

    def __init__(self, dispatch: Dispatch, spec: LogSpec, mesh: Mesh,
                 axis: str = "replica"):
        if dispatch.fused_factory is None:
            raise ValueError(
                f"{dispatch.name} has no fused_factory (no fused kernel "
                f"to mesh-wrap)"
            )
        nshards = mesh.shape[axis]
        if spec.n_replicas % nshards:
            raise ValueError(
                f"R={spec.n_replicas} not divisible by {nshards} mesh "
                f"shards"
            )
        shard_spec = dataclasses.replace(
            spec, n_replicas=spec.n_replicas // nshards)
        self._inner = {}
        for d in row_devices(mesh):
            if d not in self._inner:
                self._inner[d] = dispatch.fused_factory(shard_spec,
                                                        device=d)
        self.inner = next(iter(self._inner.values()))
        self.dispatch = dispatch
        self.spec = spec
        self.mesh = mesh
        self.axis = axis
        self.devices = int(nshards)
        self.supports_fenced = type(self.inner).supports_fenced
        self._init_host()

    def supports(self, window: int) -> bool:
        return self.inner.supports(window)

    def launches(self, window: int) -> int:
        """Kernel launches per round PER DEVICE (shard)."""
        return self.inner.launches(window)

    def round_fn(self, window: int, fenced: bool = False):
        """`(fleet, opcodes, args, count[, fenced bool[R]]) -> (fleet,
        resps int32[R, W])`: every shard's inner round, then the
        lattice join."""
        fns = {d: eng.round_fn(window, fenced)
               for d, eng in self._inner.items()}

        def entry(fleet: Placed, opcodes, args, count: int, *mask):
            parts = _fenced_parts(fleet, mask[0] if fenced else None)
            inputs = _per_device(fleet, opcodes, args)
            ring, new_lts, states, resps = {}, [], [], []
            for sh, fen in zip(fleet.shards, parts):
                opc, arg = inputs[sh.device]
                extra = (fen,) if fenced else ()
                lg, st, r = fns[sh.device](sh.log, sh.states, opc, arg,
                                           count, *extra)
                if sh.device in ring:
                    kept = ring[sh.device]
                    check(lambda: bool(torch.equal(kept.opcodes, lg.opcodes)
                                       and torch.equal(kept.args, lg.args)),
                          "shard {s}'s ring planes differ from its "
                          "device's first shard's", s=sh.index)
                else:
                    ring[sh.device] = lg
                new_lts.append(lg.ltails)
                states.append(st)
                resps.append(r)
            return (_joined(fleet, new_lts, states, parts, ring=ring),
                    _cat_home(fleet, resps))

        return entry

    def round(self, fleet: Placed, opcodes, args, count, fenced=None):
        """Host entry: one meshed round + instrumentation. `count` is a
        host int, `fenced` a bool[R] mask (numpy or tensor) or None."""
        if fenced is not None and not self.supports_fenced:
            raise ValueError(
                f"{type(self.inner).__name__} has no fenced kernel "
                f"variant (supports_fenced=False)"
            )
        W = int(opcodes.shape[0])
        is_fenced = fenced is not None
        fn = self.round_fn(W, is_fenced)
        t0 = time.perf_counter()
        extra = (fenced,) if is_fenced else ()
        out = fn(fleet, opcodes, args, count, *extra)
        self.note_round(W, count, time.perf_counter() - t0,
                        fenced=is_fenced)
        return out
