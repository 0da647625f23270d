"""State carried between the JAX package and the port.

The reference's state, handed over as numpy arrays (`np.asarray` of each
field works on its arrays), becomes the port's tensors on a given
device, and back. This is what lets both packages start from the same
mid-stream log — one whose ring has already wrapped, say — the way a
model port starts both sides from the same weights. Nothing here
imports the JAX package.

- a log: the ring planes `opcodes int32[L]`/`args int32[L, A]` and the
  int64 cursors `head`/`tail`/`ctail`/`ltails`;
- model-layout hashmap states: `values int32[R, K]`, `present
  bool[R, K]`;
- kernel-layout planes: `values`/`present int32[Kp, R]`;
- flat vspace states, `frames int32[R, P]` in the model layout or
  `int32[R, ROWS, 128]` in the kernel layout (`ops/vspace.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from node_replication_torch.core.log import LogState
from node_replication_torch.utils.device import resolve_device

_LOG_DTYPES = {
    "opcodes": np.int32, "args": np.int32, "head": np.int64,
    "tail": np.int64, "ctail": np.int64, "ltails": np.int64,
}
_STATE_DTYPES = {"values": np.int32, "present": np.bool_}
_PLANE_DTYPES = {"values": np.int32, "present": np.int32}


def _fields(obj, names):
    if isinstance(obj, dict):
        return {n: obj[n] for n in names}
    return {n: getattr(obj, n) for n in names}


def _to_torch(fields: dict, dtypes: dict, device) -> dict:
    dev = resolve_device(device)
    out = {}
    for name, dtype in dtypes.items():
        a = np.asarray(fields[name])
        if a.dtype != dtype:
            raise ValueError(f"{name}: dtype {a.dtype}, expected "
                             f"{np.dtype(dtype)}")
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(dev)
    return out


def _to_numpy(fields: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in fields.items()}


def log_from_numpy(log, device=None) -> LogState:
    """A port `LogState` from a log's six fields (a NamedTuple such as
    the reference's `LogState`, or a dict), on `device`."""
    t = _to_torch(_fields(log, _LOG_DTYPES), _LOG_DTYPES, device)
    return LogState(**t)


def log_to_numpy(log: LogState) -> dict:
    """The port log's six fields as numpy arrays (a dict)."""
    return _to_numpy(log._asdict())


def states_from_numpy(states, device=None) -> dict:
    """Model-layout hashmap states `{"values": int32[R, K], "present":
    bool[R, K]}` as tensors on `device`."""
    return _to_torch(_fields(states, _STATE_DTYPES), _STATE_DTYPES,
                     device)


def states_to_numpy(states: dict) -> dict:
    return _to_numpy(states)


def planes_from_numpy(planes, device=None) -> dict:
    """Kernel-layout planes `{"values", "present"}` (int32[Kp, R]) as
    tensors on `device`."""
    return _to_torch(_fields(planes, _PLANE_DTYPES), _PLANE_DTYPES,
                     device)


def planes_to_numpy(planes: dict) -> dict:
    return _to_numpy(planes)


def vspace_from_numpy(states, device=None, layout: str = "model") -> dict:
    """Flat vspace states `{"frames"}` as tensors on `device`:
    `int32[R, P]` for `layout="model"`, `int32[R, ROWS, 128]` for
    `layout="kernel"`."""
    ndim = {"model": 2, "kernel": 3}[layout]
    frames = np.asarray(_fields(states, ["frames"])["frames"])
    if frames.ndim != ndim or (layout == "kernel"
                               and frames.shape[-1] != 128):
        raise ValueError(f"frames of shape {frames.shape} are not the "
                         f"{layout} layout")
    return _to_torch({"frames": frames}, {"frames": np.int32}, device)


def vspace_to_numpy(states: dict) -> dict:
    return _to_numpy(states)
