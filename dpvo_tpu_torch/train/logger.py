"""Training logger with running means: a copy of ``dpvo_tpu/train/logger.py``.

Writes JSONL metrics (always) and TensorBoard summaries when available,
with the reference's 100-step running-mean smoothing.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict


class Logger:
    SUM_FREQ = 100  # ref logger.py

    def __init__(self, name: str, outdir: str = "runs"):
        self.name = name
        self.dir = os.path.join(outdir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self.window = defaultdict(lambda: deque(maxlen=self.SUM_FREQ))
        self.step = 0
        self.t0 = time.time()
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # optional
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self.tb = SummaryWriter(self.dir)

    def push(self, metrics: Dict[str, float], step: int = None):
        """Accumulate one metrics reading.

        Without `step`, reference semantics: called once per training
        step, running-mean flushed every SUM_FREQ calls. With `step`
        (callers that pre-batch readings at a log_every cadence), the
        true step is recorded and every reading is flushed — otherwise
        the internal call counter drifts from the real step and JSONL
        rows land once per SUM_FREQ*log_every real steps."""
        explicit = step is not None
        self.step = step if explicit else self.step + 1
        for k, v in metrics.items():
            self.window[k].append(float(v))
        if explicit or self.step % self.SUM_FREQ == 0:
            means = {k: sum(v) / len(v) for k, v in self.window.items()}
            means["step"] = self.step
            means["wall"] = time.time() - self.t0
            self.jsonl.write(json.dumps(means) + "\n")
            self.jsonl.flush()
            if self.tb:
                for k, v in means.items():
                    if k not in ("step",):
                        self.tb.add_scalar(k, v, self.step)
            line = " ".join(f"{k}={v:.4g}" for k, v in means.items() if k != "step")
            print(f"[{self.step}] {line}")

    def close(self):
        self.jsonl.close()
        if self.tb:
            self.tb.close()

    def write_dict(self, results: Dict[str, float], step: int = None):
        results = dict(results, step=self.step if step is None else step)
        self.jsonl.write(json.dumps(results) + "\n")
        self.jsonl.flush()
        if self.tb:
            for k, v in results.items():
                self.tb.add_scalar(f"eval/{k}", v, self.step)
