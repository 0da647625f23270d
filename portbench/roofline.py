"""The work a round needs, in bytes and operations, and the shares of
the device's time and peaks that the per-layer metrics report.

The bytes count the work, not an implementation of it. For one round of
W entries over R replicas:

- each log entry (opcode and args, 4 bytes each) read once;
- each cell of state the round touches, in every replica and in each
  plane the model has (`Model.CELL_BYTES` over the planes), read once
  and written once;
- each response the round returns to its caller written once (4 bytes);
- the ring slots the append writes (one entry each).

Untouched cells that a kernel copies are not counted. The operations are
one an event in every replica (`events x R`); beside the bytes they are
negligible, and the metric says on standard error which of the two
bounds it.
"""

from __future__ import annotations

import torch

from portbench.harness import log
from portbench.trace import kernel_time

RESP_BYTES = 4


def entry_bytes(model) -> int:
    return 4 * (1 + model.ARG_WIDTH)


def touched_events(model, rounds, device="cpu") -> tuple[int, int]:
    """Distinct cells touched, summed over `rounds` (each a `(opc, args,
    write)` of one round), and their events."""
    cells = events = 0
    for opc, args, write in rounds:
        ev = model.events(torch.as_tensor(opc).to(device),
                          torch.as_tensor(args).to(device),
                          torch.as_tensor(write).to(device))
        cells += int(torch.unique(ev["cell"]).numel())
        events += int(ev["cell"].numel())
    return cells, events


def window_work(model, rounds, n_replicas: int,
                device="cpu") -> tuple[int, int]:
    """`(bytes, operations)` that `rounds` (each a `(opc, args, write)`
    of one round) need in all."""
    cells, events = touched_events(model, rounds, device)
    w = sum(int(r[0].shape[0]) for r in rounds)
    b = (2 * w * entry_bytes(model) + w * RESP_BYTES
         + 2 * cells * n_replicas * model.CELL_BYTES)
    return b, events * n_replicas


def idle_pct(run, driver: str):
    s = run.summary
    if s is None or run.outcome["driver"] != driver or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def kernel_roofline(run, pattern: str, name: str, also=()):
    """The least time the window's rounds need on this card (bytes over
    its memory rate, or operations over its operation rate, whichever
    is more) over the device time of the kernels named by `pattern` and
    `also`, in percent; None without a trace, a kernel or a peak."""
    s, o = run.summary, run.outcome
    if s is None or o["driver"] != "rounds" or not run.peaks:
        return None
    sec, launches = kernel_time(s, (pattern,))
    if launches == 0:
        return None
    more, _ = kernel_time(s, also) if also else (0.0, 0)
    sec += more
    b, ops = window_work(run.model, o["traced_ops"], run.model.n_replicas,
                         run.device)
    t_bytes = b / run.peaks["hbm_bytes_per_s"]
    t_ops = ops / run.peaks["ops_per_s"]
    bound = "bytes" if t_bytes >= t_ops else "operations"
    log(f"{name}: {launches} launches for {o['traced_rounds']} rounds, "
        f"{sec:.6f} s of device; needs {b} bytes, {ops} operations: "
        f"bound by {bound}")
    return 100.0 * max(t_bytes, t_ops) / sec
