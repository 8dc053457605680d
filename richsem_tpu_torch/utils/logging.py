"""Logging and metric smoothing (a copy of ``richsem_tpu/utils/logging.py``).

Capability parity with the reference's ``util/logger.py:31-95`` (per-process
stream+file logger) and ``util/misc.py:32-263`` (SmoothedValue windowed
meters, MetricLogger.log_every with ETA / iter time / data time). The trainer
is one process, so no meter is synchronised across ranks.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Iterator, Optional

_LOGGERS: Dict[str, logging.Logger] = {}


def setup_logger(
    output_dir: Optional[str] = None,
    name: str = "richsem_tpu_torch",
    process_index: int = 0,
    level: int = logging.INFO,
) -> logging.Logger:
    key = f"{name}:{output_dir}:{process_index}"
    if key in _LOGGERS:
        return _LOGGERS[key]
    logger = logging.getLogger(f"{name}.{process_index}")
    logger.handlers.clear()  # a later output directory replaces the earlier one's handlers
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s]: %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    if process_index == 0:
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        suffix = "" if process_index == 0 else f".rank{process_index}"
        fh = logging.FileHandler(os.path.join(output_dir, f"info{suffix}.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _LOGGERS[key] = logger
    return logger


class SmoothedValue:
    """Track a series of values; report window median/avg and global avg."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class MetricLogger:
    """Iteration logger with smoothed meters, ETA, iter/data timing."""

    def __init__(self, delimiter: str = "  ", logger: Optional[logging.Logger] = None):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.logger = logger or logging.getLogger("richsem_tpu_torch.0")

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        # data_time/iter_time already print as dedicated fields in log_every
        return self.delimiter.join(
            f"{k}: {m}" for k, m in self.meters.items()
            if k not in ("data_time", "iter_time")
        )

    def log_every(
        self,
        iterable: Iterable,
        print_freq: int,
        header: str = "",
        total: Optional[int] = None,
    ) -> Iterator:
        i = 0
        if total is None:
            total = len(iterable) if hasattr(iterable, "__len__") else -1
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            # persist into the named meters so epoch stats (and the JSON log
            # line) carry input-pipeline visibility: data_time = host wait
            # for the next placed batch (loader + H2D), iter_time = full step
            self.meters["data_time"].update(data_time.value)
            self.meters["iter_time"].update(iter_time.value)
            if i % print_freq == 0 or (total > 0 and i == total - 1):
                if total > 0:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    count_str = f"[{i}/{total}] eta: {eta_str}"
                else:
                    count_str = f"[{i}]"
                self.logger.info(
                    self.delimiter.join(
                        [
                            f"{header} {count_str}",
                            str(self),
                            f"time: {iter_time}",
                            f"data: {data_time}",
                        ]
                    )
                )
            i += 1
            end = time.time()
        total_time = time.time() - start
        self.logger.info(
            f"{header} Total time: {datetime.timedelta(seconds=int(total_time))} "
            f"({total_time / max(i, 1):.4f} s / it)"
        )
