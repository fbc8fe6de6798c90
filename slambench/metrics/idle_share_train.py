"""Share of the traced stretch in which nothing ran on the device (%)."""

from slambench.core.readers import idle_share

NAME = "idle_share.train"


def read(trace, cell):
    return idle_share(trace)
