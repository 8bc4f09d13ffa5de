"""Kernel B1 at the chunk buckets: the least time the card could take to
hash every chunk of the window's calls, by the reference's cuts
(``work/blake2b.py``), over the device time of the ``blake2b_*``
kernels, in percent."""

from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "blake2b_", "b1")
