"""Patience-based early stopping with best-checkpoint saving (port of the
JAX package's `utils/early_stopping.EarlyStopping`; reference:
src/utils/pytorchtools.py:5-58, imported by the reference's training loop
but never instantiated, src/experiment_main/train.py:4).

`engine/train.train(..., early_stopping=EarlyStopping(...))` runs a
validation pass at every chunk boundary, calls `update()`, and on a stop
restores the best parameters.
"""

from __future__ import annotations

import numpy as np

from vae_posterior_consistency_tpu_torch.engine import checkpoint


class EarlyStopping:
    """Stop when the validation loss has not improved for `patience` checks.

    update(val_loss, params) returns True when training should stop. On
    every improvement it keeps a detached copy of `params` (the trainer's
    leaves go on being updated in place) and, with `path`, saves them there
    (the reference saves model and epoch the same way, pytorchtools.py:
    51-58)."""

    def __init__(self, patience: int = 100, verbose: bool = False,
                 delta: float = 0.0, path: str | None = None):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.path = path
        self.counter = 0
        self.best_loss = np.inf
        self.early_stop = False
        self.best_params = None

    def update(self, val_loss: float, params) -> bool:
        if val_loss < self.best_loss - self.delta:
            if self.verbose:
                print(f"Validation loss decreased "
                      f"({self.best_loss:.6f} -> {val_loss:.6f}).")
            self.best_loss = float(val_loss)
            self.best_params = checkpoint.unflatten({
                k: v.detach().clone()
                for k, v in checkpoint.flatten(params).items()})
            self.counter = 0
            if self.path is not None:
                checkpoint.save(params, self.path)
        else:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} / "
                      f"{self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop
