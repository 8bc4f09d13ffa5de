"""State carried across between the JAX package and the port.

The system has no model weights; the state that lives on the device is
leaf digest matrices and built tree levels.  These helpers turn the JAX
package's ``build_tree`` output, as numpy ``uint32`` arrays, into the
port's int32 tensors and back, bit for bit, so that both sides can be
handed the same tree.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.device import resolve_device


def levels_from_numpy(levels_hh, levels_hl, device="cuda"):
    """Per-level (n, 4) ``uint32`` arrays -> tuples of int32 tensors on
    ``device`` holding the same bits."""
    dev = resolve_device(device)

    def conv(level):
        arr = np.ascontiguousarray(level, dtype=np.uint32)
        return torch.from_numpy(arr.view(np.int32).copy()).to(dev)

    return (tuple(conv(x) for x in levels_hh),
            tuple(conv(x) for x in levels_hl))


def levels_to_numpy(levels_hh, levels_hl):
    """Tuples of int32 tensors -> per-level ``uint32`` numpy arrays."""

    def conv(level):
        return level.detach().cpu().numpy().view(np.uint32)

    return (tuple(conv(x) for x in levels_hh),
            tuple(conv(x) for x in levels_hl))
