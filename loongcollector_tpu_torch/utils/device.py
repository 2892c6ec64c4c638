"""Device selection for the port's entry points.

Every entry point runs on the CUDA device unless its caller asks for the
CPU (``device="cpu"``, the CLI's ``--cpu``).  With no CUDA device and no
such request it raises: the port never carries on on the CPU by itself.
"""

from __future__ import annotations

from typing import Union

import torch


class NoCudaDevice(RuntimeError):
    """The default device (CUDA) was asked for but none is available."""


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device is available; pass device='cpu' (or --cpu on the "
            "command line) to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
