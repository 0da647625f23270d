"""Ring-window machinery of the fused append+replay round (PyTorch).

The port of `node_replication_tpu/ops/pallas_ring.py`. On the TPU the
fused kernel appends the batch to the ring with two pre-blended row
spans copied by DMA, because Mosaic cannot index the lane axis
dynamically. A CUDA thread can store to any slot, so the port's kernel
(`csrc/hashmap_replay.cu`) writes entry j < count straight to slot
`(tail + j) & mask`; `append_window_planes` below is the plain
PyTorch version of that store.

`fused_window_ok` stays the eligibility rule, so the port routes a
round to the fused tier exactly when the reference does.
"""

from __future__ import annotations

import time

import torch

RING_LANES = 128


def window_rows(window: int) -> int:
    """Ring rows of 128 slots covering any phase of `window` slots."""
    return -(-window // RING_LANES) + 1


def ring_rows(capacity: int) -> int:
    return capacity // RING_LANES


def fused_window_ok(capacity: int, window: int) -> bool:
    """The reference's eligibility rule for a `window`-slot fused
    append: a row-shaped ring (capacity a multiple of 128) tall enough
    for `window_rows(window)` rows, with `window + 128 <= capacity`."""
    if capacity % RING_LANES or window < 1:
        return False
    return (
        window_rows(window) <= ring_rows(capacity)
        and window + RING_LANES <= capacity
    )


def append_window_planes(mask: int, ring_opc, ring_args, opcodes, args,
                         tail, count: int):
    """Plain version of the kernel's append: the post-append ring
    planes `(opcodes int32[L], args int32[L, A])`, new tensors, with
    batch entry j < `count` at slot `(tail + j) & mask` and every other
    slot unchanged. `tail` is the int64 cursor (a 0-d tensor)."""
    lanes = torch.arange(int(count), dtype=torch.int64,
                         device=ring_opc.device)
    slot = (tail + lanes) & mask
    new_opc = ring_opc.clone()
    new_args = ring_args.clone()
    new_opc[slot] = opcodes[:count]
    new_args[slot] = args[:count]
    return new_opc, new_args


class FusedEngineHost:
    """Host-side plumbing of the fused engines: the `kernel.launches`
    counter, the `log.engine.pallas_fused` (or `mesh_fused`) tier
    counter and the `kernel-launch` trace event. The reference also
    caches a jitted round function per window here; the port runs
    eagerly and caches nothing but the built kernel library
    (`ops/replay.py`). Subclasses provide `round_fn(window, fenced)`,
    `launches(window)`, `supports(window)` and a `supports_fenced`
    class flag."""

    supports_fenced = False
    tier = "pallas_fused"
    devices = 1

    def _init_host(self) -> None:
        from node_replication_torch.obs.metrics import get_registry

        self._m_launches = get_registry().counter("kernel.launches")

    def note_round(self, window: int, count: int, duration_s: float,
                   fenced: bool = False) -> None:
        """Count one fused round: the tier counter, `kernel.launches`
        and the `kernel-launch` event, whose `duration_s` is
        enqueue-side. `kernel.launches` (and the event's `launches`)
        counts every launch of the round: `launches(window)` a device
        times `devices` (a mesh shard is a launch of its own)."""
        from node_replication_torch.core import log as _corelog
        from node_replication_torch.utils.trace import get_tracer

        n_launch = self.launches(window) * self.devices
        if self.tier == "mesh_fused":
            _corelog._m_engine_mesh_fused.inc()
        else:
            _corelog._m_engine_pallas_fused.inc()
        self._m_launches.inc(n_launch)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.emit(
                "kernel-launch", tier=self.tier, window=window,
                count=int(count), launches=n_launch,
                devices=self.devices,
                duration_s=duration_s, fenced=fenced,
            )

    def round(self, log, states, opcodes, args, count, fenced=None):
        """Host entry: one model-layout round + instrumentation.
        `count` is a host int; `opcodes` must be NOOP-padded past it
        (`encode_ops`); `fenced` a bool[R] mask (numpy or tensor)."""
        if fenced is not None and not self.supports_fenced:
            raise ValueError(
                f"{type(self).__name__} has no fenced kernel variant "
                f"(supports_fenced=False)"
            )
        W = int(opcodes.shape[0])
        is_fenced = fenced is not None
        fn = self.round_fn(W, is_fenced)
        t0 = time.perf_counter()
        if is_fenced:
            fen = torch.as_tensor(fenced, dtype=torch.bool).to(
                log.tail.device)
            out = fn(log, states, opcodes, args, count, fen)
        else:
            out = fn(log, states, opcodes, args, count)
        self.note_round(W, count, time.perf_counter() - t0,
                        fenced=is_fenced)
        return out


def fused_cursor_lattice(log, count: int, fenced=None):
    """The fused round's cursor join — `log_exec_all`'s lattice under
    the lock-step precondition: `tail += count`; unfenced `ltails` land
    on the new tail, fenced ones freeze; `ctail = max(ctail,
    max(ltails))`; `head` by `_gc_head` (min over unfenced, clamped
    monotone)."""
    from node_replication_torch.core.log import _gc_head

    new_tail = log.tail + int(count)
    R = log.ltails.shape[0]
    if fenced is None:
        new_lt = new_tail.expand(R).clone()
        return log._replace(
            tail=new_tail,
            ltails=new_lt,
            ctail=torch.maximum(log.ctail, new_tail),
            head=torch.maximum(log.head, new_lt.min()),
        )
    fen = torch.as_tensor(fenced, dtype=torch.bool,
                          device=log.ltails.device)
    new_lt = torch.where(fen, log.ltails, new_tail)
    out = log._replace(
        tail=new_tail,
        ltails=new_lt,
        ctail=torch.maximum(log.ctail, new_lt.max()),
    )
    return out._replace(head=_gc_head(out, new_lt, fen))
