"""Metric logging and the rotating file logger (copies of SmoothedValue,
MetricLogger and build_logger from llava_align_tpu/framework/logger.py,
the source unchanged; tests/test_torch_copies.py holds them to it).

Capability parity: reference lavis/common/logger.py — windowed median/avg
meters, the global average, the log_every iterator — and
llava/utils.py:17-60's build_logger (a daily rotating file handler, one
per file, shared by the loggers that write there).
"""

from __future__ import annotations

import datetime
import logging
import logging.handlers
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Iterator


class SmoothedValue:
    """Track a series of values with window-smoothed median/avg and global
    statistics (reference logger.py:19-78)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        if not d:
            return 0.0
        return d[len(d) // 2]

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    """reference logger.py:82-160 capability."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def global_avg(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(
        self, iterable: Iterable, print_freq: int, header: str = ""
    ) -> Iterator:
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable) if hasattr(iterable, "__len__") else None
        last = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - last)
            last = time.time()
            if i % print_freq == 0:
                if n:
                    eta = str(datetime.timedelta(seconds=int(iter_time.avg * (n - i))))
                    logging.info(f"{header} [{i}/{n}] eta: {eta} {self} time: {iter_time}")
                else:
                    logging.info(f"{header} [{i}] {self} time: {iter_time}")
        total = time.time() - start
        logging.info(f"{header} Total time: {datetime.timedelta(seconds=int(total))}")


_handlers: Dict[str, logging.Handler] = {}


def build_logger(
    logger_name: str, logger_filename: str, log_dir: str = "."
) -> logging.Logger:
    """Rotating file logger (reference llava/utils.py:17-60 capability)."""
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    os.makedirs(log_dir, exist_ok=True)
    filename = os.path.join(log_dir, logger_filename)
    if filename not in _handlers:
        handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True
        )
        handler.setFormatter(formatter)
        _handlers[filename] = handler
    if _handlers[filename] not in logger.handlers:
        logger.addHandler(_handlers[filename])
    return logger
