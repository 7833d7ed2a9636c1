"""Structured metrics + console logging (copy of
``mcmda_tpu/utils/logging.py``).  In a ``torch.distributed`` group only
rank 0 writes files and echoes, as process 0 does in the JAX package.

Writes JSONL (one record per log step: {"step": n, "wall": t, **scalars}) which
TensorBoard-compatible tooling or plain pandas can consume, plus concise
console lines.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Mapping

import torch.distributed as dist


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = True,
                 stream: IO | None = None, tensorboard_dir: str | None = None):
        # multi-process: only rank 0 writes files / echoes
        if dist.is_available() and dist.is_initialized() and \
                dist.get_rank() != 0:
            path, tensorboard_dir, echo = None, None, False
        self.path = path
        self.echo = echo
        self.stream = stream or sys.stdout
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()
        self._tb = None
        if tensorboard_dir:
            from mcmda_tpu_torch.utils.tensorboard import EventWriter
            self._tb = EventWriter(tensorboard_dir)

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        rec = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb:
            self._tb.scalars(int(step), {k: v for k, v in rec.items()
                                         if k not in ("step", "wall")})
        if self.echo:
            body = " ".join(f"{k}={v:.4g}" for k, v in rec.items()
                            if k not in ("step", "wall"))
            print(f"[step {step:>7}] {body}", file=self.stream)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None
