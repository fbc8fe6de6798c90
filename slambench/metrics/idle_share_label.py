"""Share of the traced stretch in which nothing ran on the device (%)."""

from slambench.core.readers import idle_share

NAME = "idle_share.label"


def read(trace, cell):
    return idle_share(trace)
