"""Training log: loss accumulation, log.txt and a JSONL metrics file.

A copy of `pointnerf2studio_tpu/utils/logger.py` (reference
`Visualizer`, pointnerf/utils/visualizer.py:38-182: append-only log.txt,
windowed loss averages with a PSNR for each `*raycolor` loss) with torch
tensors in place of JAX arrays. Values stay on their device until
`flush`, which reads the whole window back in one transfer. Tensorboard
export and the image and point dumps are not ported.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log10(max(mse, 1e-12)))


class Logger:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.log_path = os.path.join(out_dir, "log.txt")
        self.metrics_path = os.path.join(out_dir, "train_metrics.jsonl")
        self._acc: Dict[str, list] = defaultdict(list)
        self._t0 = time.time()
        self._last_step = 0

    def accumulate(self, losses: Dict[str, torch.Tensor]) -> None:
        """Keep the values as they are (device scalars stay on the device:
        reading one back here would wait for the step every iteration)."""
        for k, v in losses.items():
            self._acc[k].append(v)

    def flush(self, step: int, extra: Optional[Dict] = None
              ) -> Dict[str, float]:
        """Window averages since the last flush, a PSNR beside each
        raycolor loss; one line to log.txt and one record to the JSONL."""
        keys = [k for k, v in self._acc.items() if v]
        avg: Dict[str, float] = {}
        if keys:
            means = torch.stack([
                torch.stack([torch.as_tensor(x, dtype=torch.float32).mean()
                             for x in self._acc[k]]).mean() for k in keys])
            avg = dict(zip(keys, means.cpu().tolist()))
        for k in list(avg):
            if k.endswith("raycolor_loss"):
                avg[k.replace("_loss", "_psnr")] = mse2psnr(avg[k])
        dt = time.time() - self._t0
        ips = (step - self._last_step) / dt if dt > 0 else 0.0
        rec = {"step": step, "it_per_sec": round(ips, 3), **avg,
               **(extra or {})}
        line = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in rec.items())
        print(line)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._acc.clear()
        self._t0 = time.time()
        self._last_step = step
        return rec
