"""Device selection for the package's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another device. With no card and no explicit device this raises —
    an entry point never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def resolve_devices(devices) -> list:
    """A list of torch devices for a layout: one kind (all "cpu" or all
    "cuda"), each card present, repeats allowed. Raises ValueError (or
    RuntimeError for "cuda" with no card); never falls back."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("empty device list")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a device list mixes CPU and CUDA devices: "
                         f"{[str(d) for d in devs]}")
    for k, dev in enumerate(devs):
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {str(dev)!r} requested but CUDA "
                                   "is not available")
            if dev.index is None:
                devs[k] = dev = torch.device("cuda",
                                             torch.cuda.current_device())
            if dev.index >= torch.cuda.device_count():
                raise ValueError(f"device {str(dev)!r}: only "
                                 f"{torch.cuda.device_count()} CUDA "
                                 "device(s) visible")
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {str(dev)!r}")
    return devs
