"""The training engine (port of the JAX package's `engine/train.py`: the
per-batch step, the epoch x batch loop, the end-of-training checkpoint and
`load_trained`).

Reference behaviour (src/experiment_main/train.py:13-133): Adam(lr=1e-3),
the per-batch `mask_p` draw, the vae_type-dispatched loss, the checkpoint
saved at the end under the reference's mangled name. As in the JAX package:
- each epoch takes one permutation of the training rows, wrap-padded to a
  whole number of batches of min(batch_size, n) rows (PARITY.md deviation 6);
- the loss receives the 1-based epoch as a float;
- the history holds one number per epoch: the sum of its steps' losses.

PyTorch runs the loop eagerly: one Python step per batch, parameters a
nested dict of leaf tensors updated in place by `torch.optim.Adam`, whose
defaults (betas 0.9/0.999, eps 1e-8) are optax.adam's.

All noise comes from one source, called as `noise(kind, epoch, step, shape)`
with `epoch` 0-based and `kind` one of
  "perm"    a permutation of range(shape[0]) (int64), once an epoch (step 0);
  "mask_p"  uniforms in [0, 1) for the `mask_p` draw (regularized types);
  "eps"     standard normals, [2, B, L] regularized or [B, L] vanilla;
  "eps_z"   standard normals [B, L] for `ml_reg`;
drawn in that order each step. `GeneratorNoise`, the default, draws from a
`torch.Generator` on the training device; a caller may pass its own source,
for instance one that replays the JAX package's key stream.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset
from vae_posterior_consistency_tpu_torch.engine import checkpoint
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.ops import masks

#: reference optimizer settings (src/experiment_main/train.py:21)
LEARNING_RATE = 1e-3


class GeneratorNoise:
    """Every draw of a training run from one seeded `torch.Generator` on
    `device`, in the order the run asks for them."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def __call__(self, kind: str, epoch: int, step: int, shape):
        del epoch, step  # the generator's own state advances draw by draw
        g, dev = self.generator, self.device
        if kind == "perm":
            return torch.randperm(shape[0], generator=g, device=dev)
        if kind == "mask_p":
            return torch.rand(shape, generator=g, device=dev)
        if kind in ("eps", "eps_z"):
            return torch.randn(shape, generator=g, device=dev)
        raise ValueError(f"unknown noise kind {kind!r}")


def draw_step(cfg: RunConfig, noise, mask, epoch: int, step: int):
    """The noise of one step and the masks it implies: (eff_mask, mask_p,
    eps, eps_z), eps_z None unless reg_type is 'ml_reg' on a regularized
    type. The mask dispatch is `ops/masks.train_masks`."""
    info = cfg.info
    B = mask.shape[0]
    L = cfg.latent_dim
    uniforms = (noise("mask_p", epoch, step, tuple(mask.shape)).to(mask.device)
                if info.regularized else None)
    eff_mask, mask_p = masks.train_masks(info, cfg, mask, uniforms=uniforms)
    eps = noise("eps", epoch, step, (2, B, L) if info.regularized else (B, L))
    eps_z = (noise("eps_z", epoch, step, (B, L)).to(mask.device)
             if info.regularized and cfg.reg_type == "ml_reg" else None)
    return eff_mask, mask_p, eps.to(mask.device), eps_z


def make_optimizer(params) -> torch.optim.Adam:
    """Adam(1e-3) over every leaf of `params` (leaf tensors that require a
    gradient)."""
    return torch.optim.Adam(list(checkpoint.flatten(params).values()),
                            lr=LEARNING_RATE)


def make_train_step(cfg: RunConfig, model=None) -> Callable:
    """The per-batch step:
    (params, optimizer, x, mask, noise, epoch, step) -> loss (a detached 0-d
    tensor on the device; no host sync). `epoch` is 0-based; the loss gets
    epoch + 1. Updates `params` in place through `optimizer`."""
    model = model or get_model(cfg)

    def train_step(params, optimizer, x, mask, noise, epoch, step):
        eff_mask, mask_p, eps, eps_z = draw_step(cfg, noise, mask, epoch, step)
        optimizer.zero_grad(set_to_none=True)
        loss, _aux = model.train_loss(params, x, eff_mask, mask_p, eps,
                                      float(epoch + 1), cfg, eps_z=eps_z)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "train on the CPU")
    return device


def train(
    dataset: Dataset,
    cfg: RunConfig,
    experiments_root: str = "experiments",
    log_fn: Optional[Callable[[int, float], None]] = None,
    save: bool = True,
    device="cuda",
    noise=None,
    params: Optional[dict] = None,
    on_step: Optional[Callable[[int, int, torch.Tensor], None]] = None,
):
    """Full training run; returns (params, per-epoch loss history).

    Equivalent of the reference train() (src/experiment_main/train.py:
    13-133): a fresh model (or `params`, copied), Adam(1e-3), cfg.epoch
    epochs, the checkpoint saved to `checkpoint.checkpoint_path(cfg,
    experiments_root)` at the end when `save`. Fresh parameters come from a
    `torch.Generator` on `device` seeded with cfg.seed, the default noise
    from `GeneratorNoise(cfg.seed + 1, device)`. `log_fn(epoch, loss_sum)`
    runs after each epoch (1-based), `on_step(epoch, step, loss)` after each
    step (0-based; `loss` stays on the device)."""
    device = _check_device(device)
    model = get_model(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        params = model.init(gen, cfg, dataset.obs_dim, device=device)
    params = checkpoint.unflatten({
        k: v.detach().to(device=device, dtype=torch.float32, copy=True
                         ).requires_grad_(True)
        for k, v in checkpoint.flatten(params).items()})
    noise = GeneratorNoise(cfg.seed + 1, device) if noise is None else noise
    optimizer = make_optimizer(params)
    train_step = make_train_step(cfg, model)

    split = dataset.train
    x = split.x.to(device=device, dtype=torch.float32)
    mask = split.mask.to(device=device, dtype=torch.float32)
    n = split.n
    bsz = min(cfg.batch_size, n)
    steps = math.ceil(n / bsz)
    pad = steps * bsz - n

    history = []
    for epoch in range(cfg.epoch):
        perm = noise("perm", epoch, 0, (n,)).to(device)
        if pad:
            perm = torch.cat([perm, perm[:pad]])
        x_epoch, m_epoch = x[perm], mask[perm]
        total = torch.zeros((), device=device)
        for s in range(steps):
            rows = slice(s * bsz, (s + 1) * bsz)
            loss = train_step(params, optimizer, x_epoch[rows], m_epoch[rows],
                              noise, epoch, s)
            total += loss
            if on_step is not None:
                on_step(epoch, s, loss)
        history.append(total.item())  # the one host sync of an epoch
        if log_fn is not None:
            log_fn(epoch + 1, history[-1])

    params = checkpoint.unflatten({k: v.detach() for k, v
                                   in checkpoint.flatten(params).items()})
    if save:
        checkpoint.save(params, checkpoint.checkpoint_path(cfg,
                                                           experiments_root))
    return params, history


def load_trained(dataset: Dataset, cfg: RunConfig,
                 experiments_root: str = "experiments", device="cuda"):
    """model_loader('test') equivalent (reference: src/utils/loaders.py:
    13-246): rebuild the model and load the mangled-path checkpoint."""
    device = _check_device(device)
    model = get_model(cfg)
    template = model.init(torch.Generator(device=device).manual_seed(0), cfg,
                          dataset.obs_dim, device=device)
    return checkpoint.load(template,
                           checkpoint.checkpoint_path(cfg, experiments_root))
