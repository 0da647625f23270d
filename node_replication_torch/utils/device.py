"""The port's device rule: entry points run on the card unless the
caller asks for another device.

`device=None` means `torch.device("cuda")`. Without a CUDA device that
raises: an entry point never carries on on the CPU unless the caller
passed `device="cpu"` (as the CPU tests do).
"""

from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """`device=None` asked for the card, and this process has none."""


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device is available; pass device='cpu' "
                "explicitly to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
