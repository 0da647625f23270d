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
  `int32[R, ROWS, 128]` in the kernel layout (`ops/vspace.py`);
- radix vspace states: the model layout `pt int32[R, P]` with
  `pd`/`pdpt`/`pml4 bool[R, l]`, or the kernel layout `pt int32[R, ROWS,
  128]` with ONE canonical `pd`/`pdpt`/`pml4 int32[l]`;
- open-addressing map planes `keys`/`vals`/`flag`, `int32[R, N]` in the
  model layout or `int32[R, ROWS, 128]` in the kernel layout
  (`ops/oahashmap.py`);
- a meshed fleet: the reference's sharded arrays read as numpy give
  their global view, which `fleet_from_numpy` places over a port
  `parallel.Mesh` (`fleet_to_numpy` gathers it back).
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


def _layout_check(name: str, a: np.ndarray, layout: str) -> None:
    ndim = {"model": 2, "kernel": 3}[layout]
    if a.ndim != ndim or (layout == "kernel" and a.shape[-1] != 128):
        raise ValueError(f"{name} of shape {a.shape} is not the {layout} "
                         f"layout")


def vspace_from_numpy(states, device=None, layout: str = "model") -> dict:
    """Flat vspace states `{"frames"}` as tensors on `device`:
    `int32[R, P]` for `layout="model"`, `int32[R, ROWS, 128]` for
    `layout="kernel"`."""
    frames = np.asarray(_fields(states, ["frames"])["frames"])
    _layout_check("frames", frames, layout)
    return _to_torch({"frames": frames}, {"frames": np.int32}, device)


def vspace_to_numpy(states: dict) -> dict:
    return _to_numpy(states)


def radix_from_numpy(states, device=None, layout: str = "model") -> dict:
    """Radix vspace states `{"pt", "pd", "pdpt", "pml4"}` as tensors on
    `device`: `pt int32[R, P]` and bool `[R, l]` levels for
    `layout="model"`; `pt int32[R, ROWS, 128]` and one canonical int32
    `[l]` per level for `layout="kernel"`."""
    f = _fields(states, ["pt", "pd", "pdpt", "pml4"])
    _layout_check("pt", np.asarray(f["pt"]), layout)
    lvl = np.bool_ if layout == "model" else np.int32
    return _to_torch(f, {"pt": np.int32, "pd": lvl, "pdpt": lvl,
                         "pml4": lvl}, device)


def radix_to_numpy(states: dict) -> dict:
    return _to_numpy(states)


def oahashmap_from_numpy(states, device=None, layout: str = "model") -> dict:
    """Open-addressing map planes `{"keys", "vals", "flag"}` as tensors
    on `device`: `int32[R, N]` for `layout="model"`, `int32[R, ROWS,
    128]` for `layout="kernel"`."""
    names = ["keys", "vals", "flag"]
    f = _fields(states, names)
    for n in names:
        _layout_check(n, np.asarray(f[n]), layout)
    return _to_torch(f, dict.fromkeys(names, np.int32), device)


def oahashmap_to_numpy(states: dict) -> dict:
    return _to_numpy(states)


def fleet_from_numpy(log, states, mesh, states_from=states_from_numpy):
    """A port `parallel.mesh.Placed` fleet from a fleet's global view
    as numpy (a reference meshed fleet's `log`/`states`: `np.asarray`
    of a sharded array is its global value): the log's six fields and
    the states, converted by `states_from` (default: hashmap model
    layout) onto the mesh's home device, then placed over `mesh`."""
    from node_replication_torch.parallel.mesh import place, row_devices

    home = row_devices(mesh)[0]
    return place(log_from_numpy(log, home), states_from(states, home),
                 mesh)


def fleet_to_numpy(fleet) -> tuple[dict, dict]:
    """A placed fleet's global view as numpy `(log fields, states)`."""
    log, states = fleet.gather()
    return log_to_numpy(log), _to_numpy(states)
