"""PyTorch/CUDA port of the semantic-SLAM stereo frontend.

Sits beside ``semantic_slam_mapping_tpu`` (the JAX reference) and keeps its
module names. It imports ``torch`` and numpy, never JAX. Entry points run on
the CUDA card unless the caller passes ``device="cpu"``; with no card they
raise instead of falling back.
"""

__version__ = "0.1.0"

from semantic_slam_mapping_torch.config import SlamConfig, default_config

__all__ = ["SlamConfig", "default_config", "__version__"]
