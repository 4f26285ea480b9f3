"""ReduceLROnPlateau with torch-default semantics (a copy of
``nylon_amt_tpu/train/plateau.py``).

The reference steps ``torch.optim.lr_scheduler.ReduceLROnPlateau(optimizer)``
on the validation loss (``m_training.py:147,437``); torch defaults are
mode='min', factor=0.1, patience=10, threshold=1e-4 (relative), cooldown=0,
min_lr=0, eps=1e-8. This class reproduces that state machine exactly so
training trajectories match.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    cooldown: int = 0
    min_lr: float = 0.0
    eps: float = 1e-8

    best: float = float("inf")
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def _is_better(self, metric: float) -> bool:
        # mode='min', threshold_mode='rel'
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> bool:
        """Record one epoch's metric; returns True when the LR was reduced."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
                return True
        return False

    # -- (de)serialization for checkpoints ---------------------------------

    def state_dict(self) -> dict:
        return asdict(self)

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)
