"""Device: the share of the traced window in which no kernel, copy or
set ran on the card, in percent."""

from portbench.readers import device_idle


def read(ctx):
    return device_idle(ctx)
