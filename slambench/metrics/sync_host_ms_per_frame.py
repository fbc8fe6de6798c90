"""Host milliseconds a frame blocked on the card: the program's ``sync/*``
stages, each of which holds one call that waits for the device (a pose or
count read back, a staged copy's event, an eviction's copy). The program
keeps every host wait of its serving path in such a stage (host values
reach the card without a synchronising copy; the card test of
``tests/test_slambench_sync_reader.py`` holds it to that). None where the
program has no such stage."""

from slambench.core.readers import STAGE, stage_ms_per_frame

NAME = "sync.host_ms_per_frame"
PREFIX = "sync/"


def read(trace, cell):
    if not any(k.startswith(STAGE + PREFIX) for k in trace.counts):
        return None
    return stage_ms_per_frame(trace, lambda s: s.startswith(PREFIX))
