"""Patience-based early stopping with best-checkpoint saving (port of the
JAX package's `utils/early_stopping.EarlyStopping` and, for the ensembles,
`EnsembleEarlyStopping`; reference:
src/utils/pytorchtools.py:5-58, imported by the reference's training loop
but never instantiated, src/experiment_main/train.py:4).

`engine/train.train(..., early_stopping=EarlyStopping(...))` runs a
validation pass at every chunk boundary, calls `update()`, and on a stop
restores the best parameters.
"""

from __future__ import annotations

import numpy as np
import torch

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


class EnsembleEarlyStopping:
    """Per-replica early stopping for the stacked ensemble trainers
    (`parallel/sweep`), the port of the JAX package's
    `utils/early_stopping.EnsembleEarlyStopping` (utils/early_stopping.py:
    57-131).

    `update(val_losses [S], params_ens)` keeps, for each replica on its own,
    the best loss, a patience counter and that replica's parameters at its
    best check, and returns True only when every replica has used up its
    patience: one replica still improving keeps the whole ensemble
    training. The trainers then return each replica's own best parameters.

    `best_params` holds detached host (CPU) copies, every leaf with its
    leading [S] axis: the first check, and a check where every replica
    improved, copy all rows; any other check copies only the improved rows,
    so the copies are not touched by the training that goes on in place."""

    def __init__(self, patience: int = 100, delta: float = 0.0,
                 verbose: bool = False):
        self.patience = patience
        self.delta = delta
        self.verbose = verbose
        self.best_loss = None     # np [S] after the first update
        self.counter = None       # np int [S]
        self.best_params = None   # host tensors, leading [S] axis per leaf
        self.early_stop = False

    def clone_config(self) -> "EnsembleEarlyStopping":
        """A fresh tracker with the same thresholds and no state (the
        grouped seed ensemble gives each group one of its own)."""
        return EnsembleEarlyStopping(patience=self.patience,
                                     delta=self.delta, verbose=self.verbose)

    def update(self, val_losses, params_ens) -> bool:
        v = np.asarray(val_losses, dtype=np.float64)
        first = self.best_loss is None
        if first:
            self.best_loss = np.full(v.shape[0], np.inf)
            self.counter = np.zeros(v.shape[0], dtype=np.int64)
        improved = v < self.best_loss - self.delta
        self.counter = np.where(improved, 0, self.counter + 1)
        self.best_loss = np.where(improved, v, self.best_loss)
        idx = np.flatnonzero(improved)
        flat = checkpoint.flatten(params_ens)
        if first or idx.size == v.shape[0]:
            # every replica gets a best row, even one whose loss never
            # improves again (a diverged NaN replica)
            self.best_params = checkpoint.unflatten({
                k: leaf.detach().to("cpu", copy=True)
                for k, leaf in flat.items()})
        elif idx.size:
            rows = torch.as_tensor(idx)
            best = checkpoint.flatten(self.best_params)
            for k, leaf in flat.items():
                best[k][rows] = leaf.detach()[rows.to(leaf.device)].cpu()
        if self.verbose:
            # exhausted replicas, not the largest counter: a row's counter
            # can pass patience while other rows still improve
            done = int(np.sum(self.counter >= self.patience))
            print(f"EnsembleEarlyStopping: {int(improved.sum())}/"
                  f"{v.shape[0]} improved, {done}/{v.shape[0]} exhausted "
                  f"(patience {self.patience})")
        self.early_stop = bool(np.all(self.counter >= self.patience))
        return self.early_stop
