"""Stdlib logger of the port (reference lib/utils/log.py:4-18)."""

import logging
import sys

_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "multiposenet_tpu_torch", level=logging.DEBUG):
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


logger = get_logger()
