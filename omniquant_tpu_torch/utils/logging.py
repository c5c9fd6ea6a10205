"""Console + file logger, counterpart of ``omniquant_tpu/utils/logging.py``
(the same format and the same cache: one logger per (directory, name))."""
from __future__ import annotations

import functools
import logging
import os
import sys
import time
from typing import Optional


@functools.lru_cache()
def create_logger(output_dir: Optional[str] = None,
                  name: str = "omniquant_tpu_torch"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = "[%(asctime)s %(name)s] (%(filename)s %(lineno)d): %(levelname)s %(message)s"

    console = logging.StreamHandler(sys.stdout)
    console.setLevel(logging.DEBUG)
    console.setFormatter(logging.Formatter(fmt=fmt, datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(console)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        ts = time.strftime("%Y-%m-%d-%H:%M:%S")
        fh = logging.FileHandler(
            os.path.join(output_dir, f"log_{ts}.txt"), mode="a"
        )
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt=fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(fh)
    return logger
