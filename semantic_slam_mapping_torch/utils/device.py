"""Host values onto the device without a host wait.

A blocking host-to-device copy (``torch.tensor(..., device=)``, or
``.to(device)`` of a host tensor) synchronises the stream: the host waits
for every queued kernel before it copies a few bytes. ``to_device`` stages
the values in pinned memory and copies them asynchronously on the current
stream instead, so the host keeps queueing work; scalars are better built on
the device (``torch.full``). What is left of the host's waits on the device
is the readbacks that ``pipeline.py`` names ``sync/<site>``.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(values, device, dtype=None) -> torch.Tensor:
    """``values`` (array-like or host tensor) as a tensor on ``device``,
    with the dtype ``torch.as_tensor`` gives it unless ``dtype`` is set."""
    t = torch.as_tensor(values if isinstance(values, torch.Tensor)
                        else np.require(values, requirements="C"),
                        dtype=dtype)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.contiguous().pin_memory()
    return t.to(device, non_blocking=True)
