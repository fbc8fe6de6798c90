"""TUM RGB-D sequence reader (counterpart of
``semantic_slam_mapping_tpu/io/tum.py``), on the port's own PNG codec.

``associate.txt`` rows ``rgb_time rgb_file depth_time depth_file`` name
the frames. Color is uint8 / 255.0 in float32; grey is ``0.299 R + 0.587 G
+ 0.114 B`` of that float32 color, in float32, in that order; depth is the
16-bit sample / ``depth_scale`` in float32. ``right`` repeats ``left``: the
RGB-D path reads no right image.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from semantic_slam_mapping_torch.io.frame import StereoFrame
from semantic_slam_mapping_torch.io.png import read_png


def parse_associate(text: str) -> List[Tuple[float, str, float, str]]:
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 4:
            continue
        out.append((float(parts[0]), parts[1], float(parts[2]), parts[3]))
    return out


class TumReader:
    """RGB-D frame source over a TUM sequence with an associate.txt."""

    def __init__(self, root: str, depth_scale: float = 5000.0,
                 associate_file: str = "associate.txt",
                 start_index: int = 0, end_index: Optional[int] = None):
        self.root = Path(root)
        self.depth_scale = depth_scale
        assoc_path = self.root / associate_file
        if not assoc_path.is_file():
            raise FileNotFoundError(f"no associate file: {assoc_path}")
        self.pairs = parse_associate(assoc_path.read_text())
        self.start = start_index
        self.end = (min(end_index, len(self.pairs)) if end_index
                    else len(self.pairs))
        self.timestamps = [p[0] for p in self.pairs]

    def __len__(self) -> int:
        return self.end - self.start

    def get(self, index: int) -> StereoFrame:
        _, rgb_file, _, depth_file = self.pairs[index]
        color = read_png(self.root / rgb_file, "RGB").astype(np.float32) / 255.0
        gray = (0.299 * color[..., 0] + 0.587 * color[..., 1]
                + 0.114 * color[..., 2]).astype(np.float32)
        raw = read_png(self.root / depth_file).astype(np.float32)
        depth = raw / self.depth_scale
        return StereoFrame(left=gray, right=gray, index=index, color=color,
                           depth=depth)

    def __iter__(self) -> Iterator[StereoFrame]:
        for i in range(self.start, self.end):
            yield self.get(i)
