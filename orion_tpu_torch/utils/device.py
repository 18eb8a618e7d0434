"""Where the port's entry points run: on the card unless the caller asks for
the CPU. A request for CUDA on a machine without it raises; nothing falls
back to the CPU silently."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises if it
    names CUDA and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev


__all__ = ["resolve_device"]
