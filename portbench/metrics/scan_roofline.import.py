"""Gear scan: the least time the card could take to scan every byte of
the window's files (``work/gear.py``) over the device time of whichever
``gear_*`` kernel the calls launched, in percent."""

from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "gear_", "gear")
