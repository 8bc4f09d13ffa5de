"""The flagship device step: batched BLAKE2b, then the Merkle fold.

The counterpart of ``__graft_entry__.py`` ``entry()`` (:21-40): a padded
payload batch is hashed by kernel B1 and its leaf digests folded to a
Merkle root by :func:`.ops.merkle.build_tree`, whose levels run on
kernel B2.  On the CPU both wrappers take their plain versions.
"""

from __future__ import annotations

from .ops.blake2b import pack_payloads
from .ops.blake2b_cuda import blake2b_packed_kernel
from .ops.merkle import build_tree
from .utils.device import resolve_device


def digest_root_forward(mh, ml, lengths):
    """Hash the padded batch (B a power of two), fold the leaf digests
    to the Merkle root: returns the (1, 4) hi/lo root halves."""
    hh, hl = blake2b_packed_kernel(mh, ml, lengths)
    levels_hh, levels_hl = build_tree(hh[:, :4].contiguous(),
                                      hl[:, :4].contiguous())
    return levels_hh[-1], levels_hl[-1]


def entry(device="cuda", payloads=None):
    """``(fn, example_args)``: the forward step and a packed batch on
    ``device`` (by default the reference's eight example payloads)."""
    dev = resolve_device(device)
    if payloads is None:
        payloads = [b"change-%02d" % i * (i + 1) for i in range(8)]
    mh, ml, lengths = pack_payloads(payloads)
    return digest_root_forward, (mh.to(dev), ml.to(dev), lengths.to(dev))
