"""Run logging: JSONL scalars + optional tensorboard (a copy of
seld_tpu/utils/logging.py, pinned equal to it by tests/test_torch_imports.py).

The primary sink is an append-only JSONL file; tensorboardX, or torch's
own writer, is used when importable.
"""
from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    def __init__(self, logdir: str, name: str = "scalars"):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, f"{name}.jsonl")
        self._file = open(self._path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(logdir=logdir)
        except Exception:
            try:  # torch's writer emits the same event-file format
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=logdir)
            except Exception:
                pass

    @property
    def path(self) -> str:
        return self._path

    def add_scalar(self, tag: str, value, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
