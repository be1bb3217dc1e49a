"""Logging and TensorBoard setup, as the JAX package's `utils/logger.py`:
stdout plus a ``log.txt`` file handler, and a tensorboardX writer into the
experiment directory (a no-op writer where tensorboardX is not installed).
The training loop keeps the reference's tags: ``Loss/{key}``,
``Loss/loss_sum``, ``TrainPsnr``, ``LR`` and ``Val/*``.
"""

from __future__ import annotations

import logging
import os
import sys


def setup_logger(name: str, save_dir: str, filename: str = "log.txt") -> logging.Logger:
    """The named logger, writing to stdout and to ``save_dir/filename``.
    A logger that already has handlers is returned as it is."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger

    formatter = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(formatter)
    logger.addHandler(ch)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def add_text(self, *a, **k):
        pass

    def close(self):
        pass


def make_summary_writer(log_dir: str):
    """TensorBoard writer; a no-op writer if tensorboardX is unavailable."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return _NullWriter()
    return SummaryWriter(log_dir=log_dir, max_queue=1)
