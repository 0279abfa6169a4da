"""Metric logging behind one interface (port of ``tdspa/train/metrics.py``).

Keeps JAX's metric keys and JSONL records (each metric as a float, plus
``step`` and ``wall_s``, seconds since the logger was made); logs through
``logging`` and an in-memory ``history``, and to WandB only when it is
installed and a project is given.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import time
from typing import Any

logger = logging.getLogger(__name__)

WANDB_AVAILABLE = importlib.util.find_spec("wandb") is not None


class MetricLogger:
    def __init__(self, project: str | None = None, entity: str | None = None,
                 run_name: str | None = None, config: dict | None = None,
                 use_wandb: bool = True, jsonl_path: str | None = None):
        self.history: list[dict[str, Any]] = []
        self._jsonl_path = jsonl_path
        self._wandb = None
        self._t0 = time.time()
        if use_wandb and WANDB_AVAILABLE and project:
            import wandb

            self._wandb = wandb.init(project=project, entity=entity, name=run_name,
                                     config=config or {})
        elif use_wandb and project and not WANDB_AVAILABLE:
            logger.warning("wandb not installed; logging to logging/jsonl only")

    def log(self, metrics: dict[str, Any], step: int) -> None:
        """Record ``metrics`` (floats or scalar tensors, read here) at ``step``."""
        record = {k: float(v) for k, v in metrics.items()}
        record["step"] = int(step)
        record["wall_s"] = time.time() - self._t0
        self.history.append(record)
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "step"}, step=step)
        if self._jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(self._jsonl_path)), exist_ok=True)
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        logger.info("step %d: %s", step, ", ".join(
            f"{k}={v:.5g}" for k, v in record.items() if k != "step"))

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
