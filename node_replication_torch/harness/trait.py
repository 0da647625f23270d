"""The ReplicaTrait abstraction: one runner protocol for every system.

The port of `node_replication_tpu/harness/trait.py`. The reference's
harness runs NR replicas, CNR replicas, partitioned data structures,
and plain concurrent data structures under one `ReplicaTrait`
(`benches/mkbench.rs:77-139`), with `Partitioner<T>` and
`ConcurrentDs<T>` as the comparison wrappers
(`benches/hashmap_comparisons.rs:25-142`). The equivalents here are
*fleet step runners*: each owns pre-staged `[S, R, B]` workload tensors
on its device and exposes `run_step(s)` as one step of device work,
plus the native CPU engine as a duration-based runner.

Devices: a runner takes `device=None` as the card and raises without
one (`utils/device.py`); pass `device="cpu"` to run on the CPU. The
mesh runners take a device list, a `MachineTopology`, or a device
count where the reference takes a count (`mesh_devices`).

Dispatch accounting is honest per SURVEY.md §7: `dispatches_per_step`
counts *executed* dispatches (Python ints) — NR replay applies every
appended entry on every replica (R × span), partitioned/concurrent
baselines apply each op once.
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from node_replication_torch.core.log import LogSpec, log_init
from node_replication_torch.core.multilog import (
    MultiLogSpec,
    make_multilog_step,
    multilog_init,
)
from node_replication_torch.core.replica import replicate_state
from node_replication_torch.core.step import make_step
from node_replication_torch.ops.encoding import (
    Dispatch,
    apply_read,
    apply_write,
    dispatch_reads,
)
from node_replication_torch.utils.device import resolve_device
from node_replication_torch.utils.fence import fence
from node_replication_torch.utils.tree import tree_map


def stage(x, device) -> torch.Tensor:
    """A host (numpy) or device array as a tensor on `device`, copied
    once (the runners' `prepare`)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def host_tree(states, rid: int | None = None):
    """A state tree (or replica `rid` of a fleet) as numpy arrays."""
    if rid is None:
        return tree_map(lambda a: a.cpu().numpy(), states)
    return tree_map(lambda a: a[rid].cpu().numpy(), states)


def mesh_devices(devices=None) -> list[torch.device]:
    """The devices a mesh runner spans, where the reference takes a
    device count: None = every CUDA device; an int n = the first n CUDA
    devices (ValueError when fewer are visible); a `MachineTopology` or
    a list of devices as given (a device may repeat: N shards on one
    card, or `["cpu"] * N` on the CPU). Raises without a CUDA device
    unless a list names the devices."""
    from node_replication_torch.parallel.topology import (
        MachineTopology,
        cuda_devices,
    )

    if isinstance(devices, MachineTopology):
        return devices.devices()
    if devices is None or isinstance(devices, int):
        visible = cuda_devices()
        if devices is None:
            return visible
        if devices > len(visible):
            raise ValueError(
                f"devices={devices} requested, {len(visible)} visible"
            )
        return visible[:devices]
    return [torch.device(d) for d in devices]


class FleetRunner(abc.ABC):
    """A system under test, driven step-by-step over pre-staged batches.

    Two throughput counters per step (VERDICT r1 #3 — the reference's Mops
    counts *completed client ops* regardless of replication,
    `benches/mkbench.rs:592-604`, while the repo's bench metric counts
    *replayed dispatches*):

    - `client_ops_per_step` — ops a client issued and got answered
      (cross-system comparable: one write is ONE client op no matter how
      many replicas replay it);
    - `dispatches_per_step` — executed dispatches (NR replays every entry
      on every replica: R × span + reads).
    """

    name: str = "base"
    n_replicas: int = 1
    dispatches_per_step: int = 0
    client_ops_per_step: int = 0

    @abc.abstractmethod
    def prepare(self, wr_opc, wr_args, rd_opc, rd_args) -> None:
        """Stage `[S, R, B]`-shaped workload arrays on device."""

    @abc.abstractmethod
    def run_step(self, s: int) -> None:
        """Execute step `s` (asynchronously; call `block()` to fence)."""

    def block(self) -> None:
        """Fence outstanding device work. Implementations MUST use
        `utils.fence.fence` (a synchronize plus a data-dependent
        readback): CUDA launches return before the device finishes, and
        a timed region without a real barrier measures the enqueue."""

    def state_dump(self, rid: int = 0):
        """Replica state as a host tree (the verify hook)."""
        raise NotImplementedError

    def replicas_equal(self) -> bool:
        return True


class ReplicatedRunner(FleetRunner):
    """NR: R replicas behind one shared log (`nr` crate equivalent)."""

    def __init__(self, dispatch: Dispatch, n_replicas: int,
                 writes_per_replica: int, reads_per_replica: int,
                 log_capacity: int | None = None,
                 track_resp: int | None = None,
                 combined: bool | None = None,
                 make_engine: bool = True,
                 device=None):
        self.name = "nr"
        self.dispatch = dispatch
        self.device = resolve_device(device)
        self.n_replicas = n_replicas
        self.Bw, self.Br = writes_per_replica, reads_per_replica
        span = n_replicas * writes_per_replica
        self.spec = LogSpec(
            capacity=log_capacity or max(4 * span, 1 << 14),
            n_replicas=n_replicas,
            arg_width=dispatch.arg_width,
            gc_slack=min(8192, span),
        )
        # make_engine=False: a subclass brings its own step + states
        # (e.g. a kernel runner) — skip building the default engine and
        # the replicated model state it would allocate
        self._combined = combined
        if make_engine:
            self.step = make_step(dispatch, self.spec, self.Bw, self.Br,
                                  combined=combined)
            self.states = replicate_state(
                dispatch.init_state(self.device), n_replicas)
        self.log = log_init(self.spec, self.device)
        # Each appended entry is replayed by every replica + local reads
        # (Python ints: R x R x Bw passes 2^31 at the flagship's scale).
        self.dispatches_per_step = n_replicas * span + n_replicas * self.Br
        # A client write is one op regardless of replication.
        self.client_ops_per_step = span + n_replicas * self.Br
        # `track_resp`: count write responses equal to this value across
        # the run, accumulated ON DEVICE (no per-step readback) — e.g. the
        # open-addressing map's -2 window-full drops (VERDICT r2 #9).
        self.track_resp = track_resp
        self._tracked = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
        self._writes_seen = 0

    def grow(self, k: int = 1) -> None:
        """Dynamic replica registration under the harness
        (`Log::register`, `nr/src/log.rs:272-292`): widen a LIVE runner by
        `k` replicas between steps. The runner fleet is lock-step by
        construction (every step leaves `ltails == tail` and identical
        states), so the newcomers are bit-copies of replica 0 at the
        current cursor — no catch-up needed, exactly the degenerate case
        of `NodeReplicated.grow_fleet`'s donor-snapshot join. The step is
        rebuilt for the wider fleet; call `prepare()` again with
        `[S, R+k, ...]` batches before the next `run_step`.
        """
        if k < 1:
            raise ValueError("grow needs k >= 1")
        if type(self) is not ReplicatedRunner:
            # subclasses bring their own step (sharded, kernel); rebuilding
            # the generic one here would silently drop their engine — they
            # must override grow themselves
            raise NotImplementedError(
                f"{type(self).__name__} does not support grow()"
            )
        # validate + build the wider step FIRST: if the new span doesn't
        # fit the log, make_step raises before any runner state mutates
        # (a caller catching the error keeps a consistent runner)
        new_R = self.n_replicas + k
        new_spec = dataclasses.replace(self.spec, n_replicas=new_R)
        new_step = make_step(self.dispatch, new_spec, self.Bw, self.Br,
                             combined=self._combined)
        self.states = tree_map(
            lambda x: torch.cat([x] + [x[:1]] * k, dim=0), self.states,
        )
        self.log = self.log._replace(
            ltails=torch.cat(
                [self.log.ltails, self.log.tail.reshape(1).expand(k)]
            )
        )
        self.n_replicas = new_R
        self.spec = new_spec
        self.step = new_step
        span = new_R * self.Bw
        self.dispatches_per_step = new_R * span + new_R * self.Br
        self.client_ops_per_step = span + new_R * self.Br

    def prepare(self, wr_opc, wr_args, rd_opc, rd_args):
        self._w = (stage(wr_opc, self.device), stage(wr_args, self.device))
        self._r = (stage(rd_opc, self.device), stage(rd_args, self.device))

    def run_step(self, s: int):
        self.log, self.states, wr, self._last = self.step(
            self.log, self.states,
            self._w[0][s], self._w[1][s], self._r[0][s], self._r[1][s],
        )
        if self.track_resp is not None:
            # wr[r, j] answers replica r's own j-th write: summing the
            # whole matrix counts each client write exactly once
            self._tracked = self._tracked + (wr == self.track_resp).sum(
                dtype=torch.int64)
            self._writes_seen += self.n_replicas * self.Bw

    def tracked_rate(self) -> tuple[int, int]:
        """(count, writes_seen) of tracked write responses; one readback."""
        return int(self._tracked), self._writes_seen

    def block(self):
        fence(self.log, self.states)

    def state_dump(self, rid: int = 0):
        return host_tree(self.states, rid)

    def replicas_equal(self) -> bool:
        from node_replication_torch.core.replica import states_equal

        return states_equal(self.states)


class MultiLogRunner(FleetRunner):
    """CNR: R replicas behind L key-hash-partitioned logs (`cnr`
    equivalent).

    Routing is SKEW-FAITHFUL (VERDICT r2 #6): every write goes to log
    `key % L` — the LogMapper hash (`cnr/src/replica.rs:435`) — with NO
    re-balancing, so a zipf-hot key concentrates its whole conflict class
    on one log and per-log load imbalance is visible exactly as the
    reference's CNR experiences it (`benches/hashmap.rs:143-150`). Per-log
    batches are padded to the stream's worst bucket (static shapes); the
    per-STEP `counts[s, l]` differ, and `stats()` exposes the per-log
    appended depths so imbalance can be measured.

    Because `log = key % L`, the routed buckets satisfy the congruence
    invariant (`key ≡ log (mod L)`) by construction, so a
    `PartitionedModel` (`models/partitioned.py`) can replay all L logs in
    one batched computation (the parallel-combining payoff) with no key
    rewriting. Pass `rebalance=True` to opt back into the r2-style
    balanced congruence re-key (equal buckets; maximizes batch occupancy
    at the cost of workload fidelity).

    Steps are built per pad width and kept in a dict (the reference's
    jit cache): preparing again with the same width reuses the step.
    """

    def __init__(self, dispatch: Dispatch, n_replicas: int, nlogs: int,
                 writes_per_replica: int, reads_per_replica: int,
                 log_capacity: int | None = None,
                 partitioned=None, keyspace: int | None = None,
                 rebalance: bool = False,
                 combined: bool | None = None,
                 device=None):
        self.name = f"cnr{nlogs}" + ("p" if partitioned is not None else "")
        self.dispatch = dispatch
        self.device = resolve_device(device)
        self.n_replicas = n_replicas
        self.nlogs = nlogs
        self.keyspace = keyspace
        self.rebalance = rebalance
        self.partitioned = partitioned
        self.log_capacity = log_capacity
        self.combined = combined
        self.Bw, self.Br = writes_per_replica, reads_per_replica
        self.B = None  # per-log pad width; fixed by prepare() from data
        self.step = None
        self._steps: dict = {}

    def _build(self, B: int):
        """Instantiate spec/step/state once the per-log pad width is
        known (prepare time — B is the routed stream's worst bucket)."""
        self.B = B
        self.spec = MultiLogSpec(
            nlogs=self.nlogs,
            capacity=self.log_capacity or max(4 * B, 1 << 12),
            n_replicas=self.n_replicas,
            arg_width=self.dispatch.arg_width,
            gc_slack=min(1024, max(B, 1)),
        )
        if self.combined and self.partitioned is None:
            raise ValueError(
                "combined=True needs a PartitionedModel (per-log "
                "window_apply runs on state partitions); the "
                "partitioned=None fold path is scan-only"
            )
        self._init_fleet(
            multilog_init(self.spec, self.device),
            replicate_state(self.dispatch.init_state(self.device),
                            self.n_replicas),
        )
        if B not in self._steps:
            self._steps[B] = self._make_step(B)
        self.step = self._steps[B]

    def _init_fleet(self, ml, states):
        """Hold a fresh fleet (hook: the sharded runner places it)."""
        self.ml, self.states = ml, states

    def _make_step(self, B: int):
        """Build the step for pad width `B` (hook: the sharded runner
        builds a per-shard step)."""
        return make_multilog_step(
            self.dispatch, self.spec, B, self.Br,
            partitioned=self.partitioned,
            combined=self.combined if self.partitioned is not None
            else None,
        )

    def _place_streams(self, opc_b, args_b, counts, rd_opc, rd_args):
        """Stage the routed streams on the runner's device, once."""
        self._w = (stage(opc_b, self.device), stage(args_b, self.device))
        self._counts = stage(np.asarray(counts, np.int64), self.device)
        self._r = (stage(rd_opc, self.device), stage(rd_args, self.device))

    def prepare(self, wr_opc, wr_args, rd_opc, rd_args):
        S = wr_opc.shape[0]
        L = self.nlogs
        A = wr_args.shape[-1]
        N = int(np.prod(wr_opc.shape[1:]))  # client writes per step
        if N == 0:  # read-only sweep: no write buckets
            self._build(0)
            self._place_streams(
                np.zeros((S, L, 0), np.int32),
                np.zeros((S, L, 0, A), np.int32),
                np.zeros((S, L), np.int64), rd_opc, rd_args,
            )
            self.dispatches_per_step = self.n_replicas * self.Br
            self.client_ops_per_step = self.n_replicas * self.Br
            return
        if tuple(wr_opc.shape[1:]) != (self.n_replicas, self.Bw):
            raise ValueError(
                f"write stream is shaped {tuple(wr_opc.shape[1:])}, but "
                f"this runner was declared (R={self.n_replicas}, "
                f"Bw={self.Bw}) writes per step"
            )
        flat_opc = np.ascontiguousarray(np.asarray(wr_opc).reshape(S, N))
        flat_args = np.ascontiguousarray(
            np.asarray(wr_args).reshape(S, N, A)
        )
        if self.rebalance:
            opc_b, args_b, counts = self._rebalanced(flat_opc, flat_args)
        else:
            opc_b, args_b, counts = self._hash_routed(flat_opc, flat_args)
        self._build(opc_b.shape[2])
        self._place_streams(opc_b, args_b, counts, rd_opc, rd_args)
        # Appended entries per step from the ACTUAL routed counts (they
        # sum to N for hash routing, and to L*ceil(N/L) for the tiled
        # rebalance) — each is one client write, replayed by every
        # replica; padding slots beyond counts never append.
        appended = int(counts[0].sum())
        self.dispatches_per_step = (
            self.n_replicas * appended + self.n_replicas * self.Br
        )
        self.client_ops_per_step = appended + self.n_replicas * self.Br

    def _hash_routed(self, flat_opc, flat_args):
        """Stable-bucket the stream by `key % L` (the LogMapper hash),
        preserving per-log stream order; pad to the worst bucket."""
        S, N = flat_opc.shape
        L = self.nlogs
        logidx = flat_args[..., 0].astype(np.int64) % L
        counts = np.zeros((S, L), np.int64)
        for s in range(S):
            counts[s] = np.bincount(logidx[s], minlength=L)
        B = int(counts.max())
        opc_b = np.zeros((S, L, B), np.int32)  # NOOP padding
        args_b = np.zeros((S, L, B, flat_args.shape[-1]), np.int32)
        # padded slots keep the congruence invariant (key ≡ log mod L)
        args_b[..., 0] = np.arange(L, dtype=np.int32)[None, :, None]
        for s in range(S):
            order = np.argsort(logidx[s] * N + np.arange(N))
            slog = logidx[s][order]
            pos = np.arange(N) - np.searchsorted(slog, slog)
            opc_b[s, slog, pos] = flat_opc[s][order]
            args_b[s, slog, pos] = flat_args[s][order]
        return opc_b, args_b, counts

    def _rebalanced(self, flat_opc, flat_args):
        """r2-style balanced congruence re-key (opt-in): equal per-log
        buckets; keys rewritten into the bucket's congruence class within
        the keyspace truncated to a multiple of L."""
        S, N = flat_opc.shape
        L = self.nlogs
        B = -(-N // L)
        need = L * B
        if N < need:
            reps = -(-need // N)
            flat_opc = np.tile(flat_opc, (1, reps))
            flat_args = np.tile(flat_args, (1, reps, 1))
        opc_b = flat_opc[:, :need].reshape(S, L, B)
        args_b = flat_args[:, :need].reshape(S, L, B, -1).copy()
        base = (
            self.keyspace
            if self.keyspace is not None
            else int(args_b[..., 0].max()) + 1
        )
        if base < L:
            raise ValueError(
                f"keyspace {base} < nlogs {L}: the congruence re-key "
                f"cannot give every log a distinct key class"
            )
        k_eff = (base // L) * L
        lanes = np.arange(L, dtype=np.int32)[None, :, None]
        args_b[..., 0] = (
            (args_b[..., 0] % k_eff) // L
        ) * L + lanes
        counts = np.full((S, L), B, np.int64)
        return opc_b, args_b, counts

    def run_step(self, s: int):
        self.ml, self.states, _, self._last = self.step(
            self.ml, self.states, self._w[0][s], self._w[1][s],
            self._counts[s], self._r[0][s], self._r[1][s],
        )

    def block(self):
        fence(self.ml, self.states)

    def stats(self) -> dict:
        """Per-log progress — the observable where zipf imbalance shows:
        a hot key's log runs ahead of the others in appended depth."""
        tails = [int(x) for x in self.ml.tail.cpu()]
        total = sum(tails)
        mean = total / max(len(tails), 1)
        return {
            "per_log_tail": tails,
            "appended_total": total,
            "imbalance": (max(tails) / mean) if mean else 1.0,
        }

    def state_dump(self, rid: int = 0):
        return host_tree(self.states, rid)


class PartitionedRunner(FleetRunner):
    """`Partitioner<T>` comparison (`benches/hashmap_comparisons.rs:25-84`):
    one data structure per replica, NO shared log — each shard applies only
    its own batch. The no-replication upper bound on write scaling.

    A step applies write slot j of every replica as one lane-parallel
    `apply_write` (the reference's vmapped scan), in place on the
    runner's own states (the reference donates them)."""

    def __init__(self, dispatch: Dispatch, n_replicas: int,
                 writes_per_replica: int, reads_per_replica: int,
                 device=None):
        self.name = "partitioned"
        self.dispatch = dispatch
        self.device = resolve_device(device)
        self.n_replicas = n_replicas
        self.Bw, self.Br = writes_per_replica, reads_per_replica
        self.states = replicate_state(dispatch.init_state(self.device),
                                      n_replicas)
        self.dispatches_per_step = n_replicas * (self.Bw + self.Br)
        self.client_ops_per_step = self.dispatches_per_step

    def step(self, states, wr_opc, wr_args, rd_opc, rd_args):
        wr = [apply_write(self.dispatch, states, wr_opc[:, j], wr_args[:, j])
              for j in range(wr_opc.shape[1])]
        rd = dispatch_reads(self.dispatch, states, rd_opc, rd_args)
        return states, wr, rd

    def prepare(self, wr_opc, wr_args, rd_opc, rd_args):
        self._w = (stage(wr_opc, self.device), stage(wr_args, self.device))
        self._r = (stage(rd_opc, self.device), stage(rd_args, self.device))

    def run_step(self, s: int):
        self.states, _, self._last = self.step(
            self.states, self._w[0][s], self._w[1][s],
            self._r[0][s], self._r[1][s],
        )

    def block(self):
        fence(self.states)

    def state_dump(self, rid: int = 0):
        return host_tree(self.states, rid)


class ConcurrentDsRunner(FleetRunner):
    """`ConcurrentDs<T>` passthrough (`benches/hashmap_comparisons.rs:
    92-142`): ONE un-replicated data structure; the whole fleet's ops fold
    into it sequentially. The single-structure baseline.

    The fold applies one op at a time to the state (one lane), in
    place; the step's reads all answer against the post-fold state, as
    one lane-parallel `apply_read` over a broadcast view of it."""

    def __init__(self, dispatch: Dispatch, n_replicas: int,
                 writes_per_replica: int, reads_per_replica: int,
                 device=None):
        self.name = "concurrent"
        self.dispatch = dispatch
        self.device = resolve_device(device)
        self.n_replicas = n_replicas
        self.Bw, self.Br = writes_per_replica, reads_per_replica
        self.state = dispatch.init_state(self.device)
        self.dispatches_per_step = n_replicas * (self.Bw + self.Br)
        self.client_ops_per_step = self.dispatches_per_step

    def step(self, state, wr_opc, wr_args, rd_opc, rd_args):
        d = self.dispatch
        A = wr_args.shape[-1]
        one = tree_map(lambda x: x[None], state)  # a view: writes land
        opc, args = wr_opc.reshape(-1), wr_args.reshape(-1, A)
        wr = [apply_write(d, one, opc[i:i + 1], args[i:i + 1])
              for i in range(opc.shape[0])]
        n = rd_opc.numel()
        lanes = tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)),
                         state)
        rd = apply_read(d, lanes, rd_opc.reshape(n),
                        rd_args.reshape(n, A)).reshape(1, n)
        return state, wr, rd

    def prepare(self, wr_opc, wr_args, rd_opc, rd_args):
        self._w = (stage(wr_opc, self.device), stage(wr_args, self.device))
        self._r = (stage(rd_opc, self.device), stage(rd_args, self.device))

    def run_step(self, s: int):
        self.state, _, self._last = self.step(
            self.state, self._w[0][s], self._w[1][s],
            self._r[0][s], self._r[1][s],
        )

    def block(self):
        fence(self.state)

    def state_dump(self, rid: int = 0):
        return host_tree(self.state)


class ShardedRunner(ReplicatedRunner):
    """NR fleet sharded over a device mesh: the harness form of the
    multi-device path. Replica states shard over the mesh's 'replica'
    axis (the ReplicaStrategy↔mesh-shape analog,
    `benches/mkbench.rs:321-362`). Device order comes from the topology
    walk + ThreadMapping placement (`benches/utils/topology.rs:174-219`).

    `n_devices` takes a count (the first n CUDA devices, ValueError
    above the visible count), a device list or a `MachineTopology`
    (devices may repeat: N shards on one card). The fleet is placed by
    `parallel/mesh.py:place` and stepped through `shard_step`, which
    runs the step on the home device (mesh row 0's; the port has no
    GSPMD), so after a step the states live there and `state_dump`
    reads them from there. Stepping, fencing, and state inspection are
    inherited from `ReplicatedRunner`."""

    def __init__(self, dispatch: Dispatch, n_replicas: int,
                 writes_per_replica: int, reads_per_replica: int,
                 n_devices=None,
                 thread_mapping=None,
                 log_capacity: int | None = None,
                 strategy=None):
        from node_replication_torch.parallel.mesh import (
            make_mesh,
            place,
            shard_step,
            strategy_devices,
        )
        from node_replication_torch.parallel.topology import (
            MachineTopology,
            ThreadMapping,
        )

        mapping = thread_mapping or ThreadMapping.SEQUENTIAL
        count = n_devices if isinstance(n_devices, int) else None
        topo = MachineTopology(
            None if n_devices is None or count is not None
            else mesh_devices(n_devices))
        if strategy is not None:
            # ReplicaStrategy picks the device set (One/Socket/L1 ladder,
            # `benches/mkbench.rs:321-362`); an explicit count truncates
            devices = strategy_devices(strategy, topo, mapping)[:count]
        else:
            devices = topo.allocate(mapping, count or topo.n_devices())
        n_devices = len(devices)
        if n_replicas % n_devices:
            raise ValueError(
                f"R={n_replicas} not divisible by {n_devices} devices"
            )
        super().__init__(dispatch, n_replicas, writes_per_replica,
                         reads_per_replica, log_capacity,
                         device=devices[0])
        self.strategy = strategy
        self.name = f"nr-mesh{n_devices}" + (
            f"-{strategy.value}" if strategy is not None else ""
        )
        self.mesh = make_mesh(n_devices, 1, devices=devices)
        base = make_step(dispatch, self.spec, self.Bw, self.Br)
        self.step = shard_step(base, self.mesh, self.log, self.states,
                               donate=True)
        placed = place(self.log, self.states, self.mesh)
        self.log, self.states = placed, placed.states


class ShardedCnrRunner(MultiLogRunner):
    """CNR MultiLog sharded over a ('replica', 'log') device mesh — the
    multi-device form of the more-combiners-need-more-chips story
    (`cnr/src/replica.rs:93-98`), drivable from `ScaleBenchBuilder`
    (`systems(["sharded-cnr"])`). Routing, padding, stats, and
    accounting are inherited from MultiLogRunner — only device
    placement differs.

    The mesh shape is the reference's choice: the log axis takes every
    device when L divides over them, one column a log when the devices
    over-provision, else 1; the replica axis the widest split the fleet
    divides into. `devices` is a count, a device list or a
    `MachineTopology` (`mesh_devices`). The fleet is placed as
    `MultiLogReplicated(mesh=)` places it (`parallel/mesh.py:place`):
    replica states and the ltails' replica columns by mesh row, on the
    row's first device, every log's ring copied to each row device (the
    port's placement gives the log column no ring of its own). A step
    runs the multi-log step on each row shard's replicas and joins
    every log's cursor lattice on the host (`ctail` the max, `head` the
    min over shards), as `MultiLogReplicated`'s mesh round does.
    """

    def __init__(self, dispatch: Dispatch, n_replicas: int, nlogs: int,
                 writes_per_replica: int, reads_per_replica: int,
                 log_capacity: int | None = None,
                 n_log_shards: int | None = None,
                 n_replica_shards: int | None = None,
                 partitioned=None, keyspace: int | None = None,
                 combined: bool | None = None,
                 devices=None):
        from node_replication_torch.parallel.mesh import (
            make_mesh,
            row_devices,
        )

        devs = mesh_devices(devices)
        n_dev = len(devs)
        if n_log_shards is None:
            # prefer the log axis (the CNR scaling story): split the
            # logs over every device when they divide evenly, give each
            # log its own column when the devices over-provision, else
            # leave the log axis unsharded
            if nlogs % n_dev == 0:
                n_log_shards = n_dev
            elif n_dev % nlogs == 0:
                n_log_shards = nlogs
            else:
                n_log_shards = 1
        if n_replica_shards is None:
            # widest replica split the fleet actually divides into
            # (an unused remainder of the device grid is fine)
            cap = max(1, n_dev // n_log_shards)
            n_replica_shards = next(
                r for r in range(min(cap, n_replicas), 0, -1)
                if n_replicas % r == 0
            )
        if nlogs % n_log_shards:
            raise ValueError(
                f"L={nlogs} logs cannot shard over {n_log_shards} mesh "
                f"columns"
            )
        if n_replicas % n_replica_shards:
            raise ValueError(
                f"R={n_replicas} replicas cannot shard over "
                f"{n_replica_shards} mesh rows"
            )
        used = n_replica_shards * n_log_shards
        self.mesh = make_mesh(n_replica_shards, n_log_shards,
                              devices=devs[:used])
        super().__init__(
            dispatch, n_replicas, nlogs, writes_per_replica,
            reads_per_replica, log_capacity, partitioned=partitioned,
            keyspace=keyspace, combined=combined,
            device=row_devices(self.mesh)[0],
        )
        self.name = (
            f"sharded-cnr{nlogs}"
            + ("p" if partitioned is not None else "")
            + f"-mesh{n_replica_shards}x{n_log_shards}"
        )

    @property
    def ml(self):
        """The stacked logs, the global view on the home device."""
        return self.fleet.log

    @property
    def states(self):
        """The replica states, the global view on the home device."""
        return self.fleet.states

    def _init_fleet(self, ml, states):
        from node_replication_torch.parallel.mesh import place

        self.fleet = place(ml, states, self.mesh)

    def _make_step(self, B: int):
        rows = self.mesh.shape["replica"]
        local = dataclasses.replace(self.spec,
                                    n_replicas=self.n_replicas // rows)
        shard_step = make_multilog_step(
            self.dispatch, local, B, self.Br,
            partitioned=self.partitioned,
            combined=self.combined if self.partitioned is not None
            else None,
        )

        def step(fleet, opc, args, counts, rd_opc, rd_args):
            logs, states, wr, rd = [], [], [], []
            for sh in fleet.shards:
                dev = sh.device
                ml, st, w, r = shard_step(
                    sh.log, sh.states, opc.to(dev), args.to(dev),
                    counts.to(dev), rd_opc[sh.rows].to(dev),
                    rd_args[sh.rows].to(dev),
                )
                logs.append(ml)
                states.append(st)
                wr.append(w)
                rd.append(r)
            home = fleet.home
            ctail = torch.stack([lg.ctail.to(home) for lg in logs]).amax(0)
            head = torch.stack([lg.head.to(home) for lg in logs]).amin(0)
            logs = [lg._replace(ctail=ctail.to(lg.ctail.device),
                                head=head.to(lg.head.device))
                    for lg in logs]
            return (fleet.with_shards(logs, states),
                    torch.cat([w.to(home) for w in wr], dim=1),
                    torch.cat([r.to(home) for r in rd]))

        return step

    def run_step(self, s: int):
        self.fleet, _, self._last = self.step(
            self.fleet, self._w[0][s], self._w[1][s], self._counts[s],
            self._r[0][s], self._r[1][s],
        )

    def block(self):
        fence(self.fleet.trees())


class NativeRunner:
    """The native CPU engine as a duration-based runner (real OS threads;
    the measured loop lives in C++, `nr_bench_hashmap`)."""

    def __init__(self, model: int, model_param: int, n_replicas: int,
                 threads_per_replica: int, write_pct: int, keyspace: int,
                 nlogs: int = 1, batch: int = 32,
                 log_capacity: int = 1 << 18):
        from node_replication_torch.native import NativeEngine

        self.name = f"native{'-cnr' + str(nlogs) if nlogs > 1 else ''}"
        self.n_replicas = n_replicas
        self.nlogs = nlogs
        self.threads_per_replica = threads_per_replica
        self.write_pct = write_pct
        self.keyspace = keyspace
        self.batch = batch
        self.engine = NativeEngine(
            model, model_param, n_replicas, log_capacity, nlogs
        )

    def run_duration(self, duration_ms: int, seed: int = 1):
        """Returns (total_ops, per_thread_ops, per_sec_ops[t, s])."""
        return self.engine.bench_hashmap(
            self.threads_per_replica, self.write_pct, self.keyspace,
            self.batch, duration_ms, seed,
        )

    def replicas_equal(self) -> bool:
        self.engine.sync()
        return self.engine.replicas_equal()

    def close(self):
        self.engine.close()
