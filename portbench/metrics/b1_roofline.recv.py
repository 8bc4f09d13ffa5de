"""Kernel B1: the least time the card could take to hash every item of
the window's sessions (``work/blake2b.py``) over the device time of the
``blake2b_*`` kernels, in percent."""

from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "blake2b_", "b1")
