"""The one owner of the port's device choice.

Every entry point takes ``device=`` (default ``"cuda"``) and resolves it
here.  Asking for CUDA on a host without a usable card raises: the port
never carries on quietly on the CPU.  The CPU is used only when the
caller names it, as the tests do.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError`` when
    CUDA is asked for and none is available, ``ValueError`` for any type
    other than ``cuda`` or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev
