"""EMA-validation early stopping (paper §4 'Model learning' and §5.4): the
port of ``repro/mbrl/early_stop.py``, which is plain Python.

Training stops when the CURRENT validation loss exceeds the exponential
moving average of past validation losses; the average resets whenever new
samples arrive. Lower ``weight`` = more aggressive stopping (Fig. 5a)."""
from __future__ import annotations


class EMAEarlyStop:
    def __init__(self, weight: float = 0.9, enabled: bool = True):
        if not 0.0 < weight < 1.0:
            raise ValueError(f"EMA weight must be in (0, 1), got {weight}")
        self.weight = weight
        self.enabled = enabled
        self.reset()

    def reset(self):
        self.ema = None
        self.stopped = False

    def update(self, val_loss: float) -> bool:
        """Feed one epoch's validation loss; returns stopped flag."""
        if self.ema is None:
            self.ema = val_loss
            return False
        if self.enabled and val_loss > self.ema:
            self.stopped = True
        self.ema = self.weight * self.ema + (1 - self.weight) * val_loss
        return self.stopped
