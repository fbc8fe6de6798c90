"""Semantic class definitions and palette for the 12-class driving SegNet.

A copy of ``semantic_slam_mapping_tpu/mapping/semantics.py`` (numpy only):
importing that module would run the JAX package's ``__init__``. Class
indices, not colors, drive the map's filters; the palette (the CamVid /
SegNet driving-webdemo one) is for visualization and exports.
"""

from __future__ import annotations

import numpy as np

# class ids — order matches the SegNet driving webdemo's 12 outputs
SKY = 0
BUILDING = 1
POLE = 2
ROAD_MARKING = 3
ROAD = 4
PAVEMENT = 5
TREE = 6
SIGN_SYMBOL = 7
FENCE = 8
VEHICLE = 9
PEDESTRIAN = 10
BICYCLIST = 11

NUM_CLASSES = 12

CLASS_NAMES = [
    "Sky", "Building", "Pole", "RoadMarking", "Road", "Pavement",
    "Tree", "SignSymbol", "Fence", "Vehicle", "Pedestrian", "Bicyclist",
]

# RGB palette (CamVid convention; the reference's color.png LUT rows)
PALETTE = np.array([
    [128, 128, 128],   # Sky
    [128, 0, 0],       # Building
    [192, 192, 128],   # Pole
    [255, 69, 0],      # RoadMarking
    [128, 64, 128],    # Road
    [60, 40, 222],     # Pavement
    [128, 128, 0],     # Tree
    [192, 128, 128],   # SignSymbol
    [64, 64, 128],     # Fence
    [64, 0, 128],      # Vehicle
    [64, 64, 0],       # Pedestrian
    [0, 128, 192],     # Bicyclist
], np.uint8)

# classes removed from the dense map (mapper.cpp:37-55: sky, pole, cyclist)
MAP_EXCLUDED_CLASSES = (SKY, POLE, BICYCLIST)

# classes fused into the moving mask (mapper.cpp:206-208)
MOTION_CLASSES = (PEDESTRIAN, BICYCLIST)


def colorize(labels: np.ndarray) -> np.ndarray:
    """Label image (H, W) -> RGB visualization (H, W, 3) uint8 (the
    LUT(color.png) role, experiment/segnet.cpp:131-146)."""
    return PALETTE[np.clip(labels, 0, NUM_CLASSES - 1)]
