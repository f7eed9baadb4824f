"""Experiment tracking (port of ``baddiffusion_tpu/utils/trackers.py``).

Always a JSONL stream, ``<logging_dir>/metrics.jsonl`` (one record per
``log`` call, with ``_time`` and ``_step``), and the scalar part of the run's
config in ``tracker_config.json``; also tensorboard and wandb when they can
be imported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from baddiffusion_tpu_torch.utils.logging import Log


class Tracker:
    def __init__(self, logging_dir: str, project: str = "baddiffusion_tpu", run_name: Optional[str] = None,
                 config: Optional[dict] = None):
        os.makedirs(logging_dir, exist_ok=True)
        self.logging_dir = logging_dir
        self.jsonl_path = os.path.join(logging_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a", buffering=1)
        self._tb = None
        self._wandb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(log_dir=logging_dir)
        try:
            import wandb
        except ImportError:
            pass
        else:
            try:
                self._wandb = wandb.init(project=project, name=run_name, config=config or {}, dir=logging_dir)
            except Exception as exc:  # offline or not logged in: the JSONL stream still records the run
                Log.warning(f"wandb disabled: {exc!r}")
        if config is not None:
            scalars = {k: v for k, v in config.items() if isinstance(v, (int, float, str, bool))}
            with open(os.path.join(logging_dir, "tracker_config.json"), "w") as f:
                json.dump(scalars, f, indent=2, sort_keys=True, default=str)

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        rec = {"_time": time.time()}
        if step is not None:
            rec["_step"] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(k, float(v), global_step=step)
                except (TypeError, ValueError):
                    pass
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
