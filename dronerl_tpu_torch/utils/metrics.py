"""Pluggable metric loggers: stdout, TensorBoard, W&B, none, and a fan-out
(counterpart of ``dronerl_tpu/utils/metrics.py``), with the same scalar
and histogram surface.

TensorBoard (``torch.utils.tensorboard``, which needs the ``tensorboard``
package) and W&B are imported only where a logger of theirs is made or
writes: the port runs without either, and a run that asks for one of
them raises when the package is missing.
"""

import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _host(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().float().cpu().numpy()
    return np.asarray(values)


class Logger:
    """Interface: scalar and histogram logging by global step."""

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        raise NotImplementedError

    def log_scalars(self, values: Dict[str, float], step: int) -> None:
        for tag, value in values.items():
            self.log_scalar(tag, value, step)

    def log_histogram(self, tag: str, values, step: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NoLogger(Logger):
    def log_scalar(self, tag, value, step):
        pass

    def log_histogram(self, tag, values, step):
        pass


class StdoutLogger(Logger):
    def log_scalar(self, tag, value, step):
        logger.info("step %s: %s = %.6g", f"{step:,}", tag, value)

    def log_histogram(self, tag, values, step):
        values = _host(values)
        logger.info(
            "step %s: %s histogram mean=%.4g std=%.4g min=%.4g max=%.4g",
            f"{step:,}", tag, values.mean(), values.std(),
            values.min(), values.max())


class TensorBoardLogger(Logger):
    """TensorBoard sink (torch's ``SummaryWriter``)."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir)

    def log_scalar(self, tag, value, step):
        self.writer.add_scalar(tag, float(value), step)

    def log_histogram(self, tag, values, step):
        self.writer.add_histogram(tag, _host(values), step)

    def close(self):
        self.writer.close()


class WandbLogger(Logger):
    def __init__(self, run):
        self.run = run

    def log_scalar(self, tag, value, step):
        self.run.log({tag: value}, step=step)

    def log_histogram(self, tag, values, step):
        import wandb

        self.run.log({tag: wandb.Histogram(_host(values))}, step=step)


class MultiLogger(Logger):
    def __init__(self, loggers: Sequence[Logger]):
        self.loggers = list(loggers)

    def log_scalar(self, tag, value, step):
        for lg in self.loggers:
            lg.log_scalar(tag, value, step)

    def log_histogram(self, tag, values, step):
        for lg in self.loggers:
            lg.log_histogram(tag, values, step)

    def close(self):
        for lg in self.loggers:
            lg.close()


def build_logger(tensorboard_dir: Optional[str] = None, wandb_run=None,
                 stdout: bool = False) -> Logger:
    """The sinks asked for, fanned out when more than one; ``NoLogger``
    when none. A TensorBoard directory without the ``tensorboard``
    package is skipped with a warning, as the JAX package does."""
    sinks = []
    if tensorboard_dir:
        try:
            sinks.append(TensorBoardLogger(tensorboard_dir))
        except ImportError:
            logger.warning("tensorboard unavailable; skipping TB logging")
    if wandb_run is not None:
        sinks.append(WandbLogger(wandb_run))
    if stdout:
        sinks.append(StdoutLogger())
    if not sinks:
        return NoLogger()
    if len(sinks) == 1:
        return sinks[0]
    return MultiLogger(sinks)
