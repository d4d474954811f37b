"""Console log and the ``metrics.jsonl`` scalar file (``frostnet_tpu/utils/logging.py``).

The records are those of the JAX package: one JSON object a line,
``{"step": ..., "time": ..., "<tag>/<metric>": ...}``.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class _Color:
    INFO = "\033[32m"
    WARN = "\033[33m"
    ERROR = "\033[31m"
    END = "\033[0m"


class MetricLogger:
    def __init__(self, logdir: Optional[str] = None, name: str = "frostnet_tpu_torch",
                 echo: bool = True):
        """``echo=False`` prints nothing (the ranks of a data-parallel run
        but the first)."""
        self.name = name
        self.logdir = logdir
        self.echo = echo
        self._scalar_file = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._scalar_file = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def info(self, msg: str):
        if self.echo:
            print(f"{_Color.INFO}[{self.name}]{_Color.END} {msg}", flush=True)

    def warning(self, msg: str):
        if self.echo:
            print(f"{_Color.WARN}[{self.name} warn]{_Color.END} {msg}", flush=True)

    def error(self, msg: str):
        print(f"{_Color.ERROR}[{self.name} error]{_Color.END} {msg}",
              file=sys.stderr, flush=True)

    def log_scalars(self, scalars: Dict[str, float], step: int):
        if self._scalar_file:
            rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in scalars.items()}}
            self._scalar_file.write(json.dumps(rec) + "\n")
            self._scalar_file.flush()

    def close(self):
        if self._scalar_file:
            self._scalar_file.close()
            self._scalar_file = None
