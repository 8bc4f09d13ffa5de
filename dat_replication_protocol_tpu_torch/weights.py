"""State carried across between the JAX package and the port.

The system has no model weights; the state that lives on the device is
leaf digest matrices and built tree levels, and the state two peers
exchange is a blob's content summary.  These helpers turn the JAX
package's ``build_tree`` output, as numpy ``uint32`` arrays, into the
port's int32 tensors and back, and a summary's fields into the port's
``ContentSummary`` and back, bit for bit, so that both sides can be
handed the same tree and a peer on either package can read the other's
summary.
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


def summary_from_numpy(length, cuts, digests, root):
    """A content summary's fields (as the JAX package's ``ContentSummary``
    holds them) -> the port's ``ContentSummary``."""
    from .runtime.content import ContentSummary

    digests = np.ascontiguousarray(digests, dtype=np.uint8).reshape(-1, 32)
    cuts = [int(c) for c in cuts]
    if len(cuts) != digests.shape[0] or len(bytes(root)) != 32:
        raise ValueError("a summary needs one 32-byte digest per cut and a "
                         "32-byte root")
    return ContentSummary(int(length), cuts, digests.copy(), bytes(root))


def summary_to_numpy(summary):
    """The port's ``ContentSummary`` -> ``(length, cuts, digests, root)``:
    int, list of int, (nchunks, 32) uint8 array, 32 bytes."""
    return (int(summary.length), list(summary.cuts),
            np.array(summary.digests, dtype=np.uint8), bytes(summary.root))
