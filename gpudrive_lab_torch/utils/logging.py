"""Metrics logging (port of ``gpudrive_lab_tpu/utils/logging.py``).

The reference logs to wandb with a rich-console dashboard (reference:
gpudrive/integrations/puffer/logging.py:50-164).  Here the sink is JSONL on
disk, echoed to stdout; wandb is used when asked for and installed."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricsLogger:
    def __init__(
        self,
        log_dir: str = "runs",
        exp_id: str = "exp",
        use_wandb: bool = False,
        wandb_kwargs: Optional[dict] = None,
        echo: bool = True,
    ):
        self.path = Path(log_dir) / f"{exp_id}.metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self.echo = echo
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb.init(**(wandb_kwargs or {}))

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {"_t": round(time.time(), 3)}
        if step is not None:
            rec["step"] = step
        rec.update(metrics)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self.echo:
            print(json.dumps(rec), flush=True)

    def close(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
