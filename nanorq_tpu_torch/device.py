"""Explicit device selection: no global default, no fallback."""

import torch


def resolve(device) -> torch.device:
    """`device` (str or torch.device) -> torch.device.

    Raises when a CUDA device is asked for and no card is visible: the port
    never silently runs the CPU plain versions in place of the kernels.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch sees no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda[:n]'")
    return dev
