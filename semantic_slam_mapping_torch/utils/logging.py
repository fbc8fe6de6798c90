"""The package's loggers, as the JAX package names and formats them.

Counterpart of ``semantic_slam_mapping_tpu/utils/logging.py``: loggers are
``ssm.<name>`` under one ``ssm`` logger that writes to stderr as
``"%(asctime)s %(name)s %(levelname).1s: %(message)s"`` with ``%H:%M:%S``
times, at the level of ``SSM_LOG_LEVEL`` (default ``INFO``), and does not
pass records on to the root logger. The ``ssm`` logger is configured once:
when it already has a handler, nothing is added.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname).1s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    root = logging.getLogger("ssm")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(os.environ.get("SSM_LOG_LEVEL", "INFO").upper())
        root.propagate = False
    return logging.getLogger(f"ssm.{name}")
