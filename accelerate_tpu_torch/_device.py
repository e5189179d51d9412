"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: ``cuda`` when one is visible, else a
    ``RuntimeError`` — an entry point never drifts to the CPU silently.  Any
    explicit device (``"cpu"`` in the tests) is taken as given, a bare
    ``"cuda"`` pinned to the current card's index."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the host"
        )
    return torch.device("cuda", torch.cuda.current_device())
