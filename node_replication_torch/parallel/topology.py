"""Device topology discovery over the CUDA devices of one process.

The port of `node_replication_tpu/parallel/topology.py` (its docstring
maps the reference's hwloc walk onto accelerator placement). The port's
hierarchy is flat: every device is a CUDA device of this process
(`torch.cuda.device_count()`), or an entry of an explicit device list,
so `process` and `slice_index` are 0 for every device and the
placement orders reduce to device order. `allocate()` keeps the
reference's contract: `n` devices in placement order, or a ValueError
when there are fewer.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict

import torch

from node_replication_torch.utils.device import NoCudaDeviceError


class ThreadMapping(enum.Enum):
    """Placement order over devices (`benches/utils/topology.rs:19-50`):
    NONE and SEQUENTIAL fill one host's devices before the next,
    INTERLEAVE deals devices round-robin over hosts."""

    NONE = "none"
    SEQUENTIAL = "sequential"
    INTERLEAVE = "interleave"


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    device: torch.device
    index: int
    process: int  # host index: 0, the port is one process
    slice_index: int  # 0: no slices on a CUDA host


def cuda_devices() -> list[torch.device]:
    """Every CUDA device of this process, in index order; raises
    without one (the port's rule: the default is the card)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise NoCudaDeviceError(
            "no CUDA device is available; pass devices=['cpu', ...] "
            "explicitly to build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


class MachineTopology:
    """Queryable accelerator topology (`MachineTopology`,
    `benches/utils/topology.rs:89-156`) over the CUDA devices, or over
    an explicit device list."""

    def __init__(self, devices=None):
        devices = list(devices if devices is not None else cuda_devices())
        self.infos = [
            DeviceInfo(device=torch.device(d), index=i, process=0,
                       slice_index=0)
            for i, d in enumerate(devices)
        ]

    def devices(self):
        return [i.device for i in self.infos]

    def n_devices(self) -> int:
        return len(self.infos)

    def n_hosts(self) -> int:
        return len({i.process for i in self.infos})

    def devices_on_host(self, process: int):
        return [i.device for i in self.infos if i.process == process]

    def allocate(self, mapping: ThreadMapping, n: int):
        """Pick `n` devices in placement order
        (`MachineTopology::allocate`, `benches/utils/topology.rs:174-219`)."""
        if n > len(self.infos):
            raise ValueError(f"want {n} devices, have {len(self.infos)}")
        if mapping in (ThreadMapping.NONE, ThreadMapping.SEQUENTIAL):
            order = sorted(self.infos, key=lambda i: (i.process, i.index))
        else:  # INTERLEAVE: round-robin hosts
            by_host = defaultdict(list)
            for i in sorted(self.infos, key=lambda i: i.index):
                by_host[i.process].append(i)
            order = []
            hosts = sorted(by_host)
            k = 0
            while len(order) < len(self.infos):
                h = hosts[k % len(hosts)]
                if by_host[h]:
                    order.append(by_host[h].pop(0))
                k += 1
        return [i.device for i in order[:n]]
