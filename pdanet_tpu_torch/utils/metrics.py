"""Training metrics sink, copied from ``pdanet_tpu/utils/metrics.py`` (the
reference's tensorboardX scalars, train_utils.py:89-93, test.py:129-131).

The primary sink is an append-only JSONL file, ``metrics.jsonl``: one
``{"tag", "value", "step", "ts"}`` object a line; a tensorboard event file
is written too when a SummaryWriter implementation is importable."""

import importlib
import json
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.log_dir / "metrics.jsonl", "a", buffering=1)
        self._tb = None
        for mod, cls in (
            ("tensorboardX", "SummaryWriter"),
            ("torch.utils.tensorboard", "SummaryWriter"),
        ):
            try:
                writer = getattr(importlib.import_module(mod), cls)
            except ImportError:
                continue
            self._tb = writer(log_dir=str(self.log_dir))
            break

    def add_scalar(self, tag, value, step):
        self._f.write(
            json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "ts": time.time()}
            )
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
