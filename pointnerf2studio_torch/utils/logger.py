"""Training log: loss accumulation, log.txt and a JSONL metrics file.

A copy of `pointnerf2studio_tpu/utils/logger.py` (reference
`Visualizer`, pointnerf/utils/visualizer.py:38-182: append-only log.txt,
windowed loss averages with a PSNR for each `*raycolor` loss) with torch
tensors in place of JAX arrays. Values stay on their device until
`flush`, which reads the whole window back in one transfer; with
`tensorboard=True` the window's averages also go to a SummaryWriter
under `<out_dir>/tensorboard` (JSONL alone, with a message, where
tensorboard is missing). The reference's image and point dumps are not
ported: nothing in the port calls them.
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
    def __init__(self, out_dir: str, tensorboard: bool = False):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.log_path = os.path.join(out_dir, "log.txt")
        self.metrics_path = os.path.join(out_dir, "train_metrics.jsonl")
        self._acc: Dict[str, list] = defaultdict(list)
        self._t0 = time.time()
        self._last_step = 0
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"logger: tensorboard unavailable ({e}); scalars go "
                      "to the JSONL only")
            else:
                self._tb = SummaryWriter(
                    log_dir=os.path.join(out_dir, "tensorboard"))

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
        # a record that closes no steps (growth, evaluation, the final
        # one) has no rate
        ips = None
        if step > self._last_step:
            dt = time.time() - self._t0
            ips = (step - self._last_step) / dt if dt > 0 else 0.0
        rate = {} if ips is None else {"it_per_sec": round(ips, 3)}
        rec = {"step": step, **rate, **avg, **(extra or {})}
        line = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in rec.items())
        print(line)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in avg.items():
                self._tb.add_scalar(k, v, step)
            if ips is not None:
                self._tb.add_scalar("it_per_sec", ips, step)
            self._tb.flush()
        self._acc.clear()
        self._t0 = time.time()
        self._last_step = step
        return rec

    def close(self) -> None:
        """Close the tensorboard writer, if there is one."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None
