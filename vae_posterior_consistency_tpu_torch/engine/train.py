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
  "mask_p"  uniforms in [0, 1) shaped like the batch's mask, for the
            `mask_p` draw (regularized types);
  "drop"    uniforms in [0, 1), [2, B, D], for the EDDI drop mask
            (vanilla `_with_drop` types; ops/masks.eddi_drop_mask);
then the model family's draws, `ModelDef.train_noise`:
  "eps"     standard normals: the gauss reparameterisation noise or the
            flow's base noise, [2, B, L] regularized or [B, L] vanilla;
            the importance samples of MIWAE and notMIWAE, [2, B, K, L] or
            [B, K, L] with K = cfg.train_k;
  "eps_z"   standard normals [B, L] for the gauss family's `ml_reg`;
  "mask_s"  uniforms in [0, 1), [B, D], for the Bernoulli mask of the
            notMIWAE 'sampled_mask' variant;
drawn in that order each step, "mask_p" and "drop" never both.
`GeneratorNoise`, the default, draws from a `torch.Generator` on the
training device, reseeded at each epoch from (seed, epoch), so an epoch's
draws do not depend on the epochs before it and a resumed run draws what
the uninterrupted run drew; a caller may pass its own source, for instance
one that replays the JAX package's key stream.

Restartability and early stopping, as in the JAX package: `train` runs in
chunks of `chunk_epochs` epochs; `checkpoint_every=N` writes (parameters,
Adam state, epochs done) to `<checkpoint>.resume.pt` every N epochs and at
the end, `resume=True` continues from that file, and `early_stopping`
validates at every multiple of `chunk_epochs` and at the end, stops when
patience runs out and returns the best check's parameters. The validation
objective's draws are made once, as a step's at epoch `VAL_EPOCH`, and
reused at every check.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset
from vae_posterior_consistency_tpu_torch.engine import checkpoint
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.ops import masks

#: reference optimizer settings (src/experiment_main/train.py:21)
LEARNING_RATE = 1e-3


#: the epoch at which the validation objective's draws are made (the JAX
#: package's fold_in(k_run, 0x5A11D))
VAL_EPOCH = 0x5A11D

#: epochs below 2**EPOCH_BITS get seeds of their own under every seed
EPOCH_BITS = 20


def epoch_seed(seed: int, epoch: int) -> int:
    """The generator seed of `epoch` under `seed`: distinct for every pair
    with epoch < 2**EPOCH_BITS, and, for a CPU generator, which reads only
    the low 32 bits of a seed, for every seed below 2**12 as well."""
    return (seed << EPOCH_BITS) + epoch


class GeneratorNoise:
    """The draws of a training run from a `torch.Generator` on `device`,
    reseeded with `epoch_seed(seed, epoch)` at the first draw of each epoch
    (an epoch's draws are those made since), then in the order the run asks
    for them."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self._epoch = None

    def __call__(self, kind: str, epoch: int, step: int, shape):
        del step  # within an epoch the generator advances draw by draw
        if epoch != self._epoch:
            self.generator.manual_seed(epoch_seed(self.seed, epoch))
            self._epoch = epoch
        return draw(self.generator, kind, shape, self.device)


def draw(generator, kind: str, shape, device):
    """One draw of noise `kind` from `generator`: a permutation of
    range(shape[0]) for "perm", uniforms for "mask_p", "drop", "mask_s",
    standard normals for "eps", "eps_z"."""
    if kind == "perm":
        return torch.randperm(shape[0], generator=generator, device=device)
    if kind in ("mask_p", "drop", "mask_s"):
        return torch.rand(shape, generator=generator, device=device)
    if kind in ("eps", "eps_z"):
        return torch.randn(shape, generator=generator, device=device)
    raise ValueError(f"unknown noise kind {kind!r}")


def draw_step(cfg: RunConfig, noise, mask, epoch: int, step: int,
              model=None):
    """The noise of one step and the masks it implies: (eff_mask, mask_p,
    eps, extra), `extra` the family's other draws by kind (`eps_z`,
    `mask_s`), the keyword arguments of its `train_loss`. The mask dispatch
    is `ops/masks.train_masks`: a step draws "mask_p" (regularized types)
    or "drop" (vanilla `_with_drop` types), where the JAX step draws either
    from its `k_mask`."""
    model = model or get_model(cfg)
    info = cfg.info
    if info.regularized:
        uniforms = noise("mask_p", epoch, step, tuple(mask.shape))
    elif info.with_drop:
        uniforms = noise("drop", epoch, step, (2, *mask.shape))
    else:
        uniforms = None
    if uniforms is not None:
        uniforms = uniforms.to(mask.device)
    eff_mask, mask_p = masks.train_masks(info, cfg, mask, uniforms=uniforms)
    drawn = {kind: noise(kind, epoch, step, shape).to(mask.device)
             for kind, shape in model.train_noise(cfg, *mask.shape).items()}
    return eff_mask, mask_p, drawn.pop("eps"), drawn


def trainable(params) -> dict:
    """Copies of the leaves of `params` that require a gradient (the
    leaves Adam updates in place)."""
    return checkpoint.unflatten({
        k: v.detach().clone().requires_grad_(True)
        for k, v in checkpoint.flatten(params).items()})


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
        eff_mask, mask_p, eps, extra = draw_step(cfg, noise, mask, epoch,
                                                 step, model)
        optimizer.zero_grad(set_to_none=True)
        loss, _aux = model.train_loss(params, x, eff_mask, mask_p, eps,
                                      float(epoch + 1), cfg, **extra)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return device


def _build_val_fn(cfg: RunConfig, model, x, mask, noise) -> Callable:
    """The full-split validation objective of early stopping: the training
    loss on (x, mask) without gradients, its draws made once, as a step's
    at epoch VAL_EPOCH, step 0, and reused at every check, and the loss at
    the fixed epoch cfg.epoch (an epoch-annealed loss, ml_reg or
    beta_annealing, would otherwise drift between checks), as in the JAX
    package's `_build_val_fn`. Returns params -> float."""
    eff_mask, mask_p, eps, extra = draw_step(cfg, noise, mask, VAL_EPOCH, 0,
                                             model)
    fixed_epoch = float(cfg.epoch)

    def val_loss(params) -> float:
        with torch.no_grad():
            return model.train_loss(params, x, eff_mask, mask_p, eps,
                                    fixed_epoch, cfg, **extra)[0].item()

    return val_loss


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
    chunk_epochs: int = 200,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    early_stopping=None,
    val_noise=None,
):
    """Full training run; returns (params, per-epoch loss history of the
    epochs this call ran).

    Equivalent of the reference train() (src/experiment_main/train.py:
    13-133): a fresh model (or `params`, copied), Adam(1e-3), cfg.epoch
    epochs, the checkpoint saved to `checkpoint.checkpoint_path(cfg,
    experiments_root)` at the end when `save`. Fresh parameters come from a
    `torch.Generator` on `device` seeded with cfg.seed, the default noise
    from `GeneratorNoise(cfg.seed + 1, device)`. `log_fn(epoch, loss_sum)`
    runs after each epoch (1-based), `on_step(epoch, step, loss)` after each
    step (0-based; `loss` stays on the device).

    Beyond the reference, as in the JAX package's `train`:
    - `checkpoint_every=N` writes `<checkpoint>.resume.pt` every N epochs
      and at the last epoch (`checkpoint.save_resume`, tagged
      `run:{vae_type}:seed={seed}:batch={batch_size}`);
    - `resume=True` continues from that file when it exists
      (`checkpoint.load_resume`, which refuses another run's file or one
      that trained more than cfg.epoch epochs);
    - `early_stopping` (`utils.early_stopping.EarlyStopping`) validates on
      dataset.test, or on train where there is none, at every multiple of
      `chunk_epochs` and at the end (`checkpoint_every` does not move these
      checks); when it says stop, training ends and the best check's
      parameters are returned and saved. The validation draws come from
      `val_noise`, by default the training noise source, at epoch
      VAL_EPOCH."""
    device = check_device(device)
    model = get_model(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        params = model.init(gen, cfg, dataset.obs_dim, device=device)
    params = checkpoint.on_device(params, device)
    noise = GeneratorNoise(cfg.seed + 1, device) if noise is None else noise

    final_path = checkpoint.checkpoint_path(cfg, experiments_root)
    resume_path = final_path + ".resume.pt"
    # seed and batch_size are tagged because the checkpoint name holds
    # neither
    resume_tag = f"run:{cfg.vae_type}:seed={cfg.seed}:batch={cfg.batch_size}"
    done, opt_state = 0, None
    if resume and os.path.exists(resume_path):
        params, opt_state, done = checkpoint.load_resume(
            params, resume_path, tag=resume_tag, max_epochs=cfg.epoch)
    params = trainable(params)
    optimizer = make_optimizer(params)
    if opt_state is not None:
        checkpoint.load_adam_state(optimizer, params, opt_state)
    train_step = make_train_step(cfg, model)

    split = dataset.train
    x = split.x.to(device=device, dtype=torch.float32)
    mask = split.mask.to(device=device, dtype=torch.float32)
    n = split.n
    bsz = min(cfg.batch_size, n)
    steps = math.ceil(n / bsz)
    pad = steps * bsz - n

    val_fn = None
    if early_stopping is not None:
        vsplit = dataset.test if dataset.test is not None else dataset.train
        val_fn = _build_val_fn(
            cfg, model, vsplit.x.to(device=device, dtype=torch.float32),
            vsplit.mask.to(device=device, dtype=torch.float32),
            noise if val_noise is None else val_noise)

    def run_epoch(epoch: int) -> float:
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
        return total.item()  # the one host sync of an epoch

    history = []
    while done < cfg.epoch:
        n_e = min(chunk_epochs, cfg.epoch - done)
        if checkpoint_every:
            n_e = min(n_e, checkpoint_every - done % checkpoint_every)
        if val_fn is not None:
            # the checks stay at multiples of chunk_epochs whatever
            # checkpoint_every is
            n_e = min(n_e, chunk_epochs - done % chunk_epochs)
        for epoch in range(done, done + n_e):
            history.append(run_epoch(epoch))
            if log_fn is not None:
                log_fn(epoch + 1, history[-1])
        done += n_e
        if checkpoint_every and (done % checkpoint_every == 0
                                 or done >= cfg.epoch):
            # the last boundary is always written, so a later run with a
            # larger budget resumes from the true end
            checkpoint.save_resume(params,
                                   checkpoint.adam_state(optimizer, params),
                                   done, resume_path, tag=resume_tag)
        if val_fn is not None and (done % chunk_epochs == 0
                                   or done >= cfg.epoch):
            if early_stopping.update(val_fn(params), params):
                break

    params = checkpoint.unflatten({k: v.detach() for k, v
                                   in checkpoint.flatten(params).items()})
    if early_stopping is not None and early_stopping.best_params is not None:
        params = early_stopping.best_params
    if save:
        checkpoint.save(params, final_path)
    return params, history


def load_trained(dataset: Dataset, cfg: RunConfig,
                 experiments_root: str = "experiments", device="cuda"):
    """model_loader('test') equivalent (reference: src/utils/loaders.py:
    13-246): rebuild the model and load the mangled-path checkpoint."""
    device = check_device(device)
    model = get_model(cfg)
    template = model.init(torch.Generator(device=device).manual_seed(0), cfg,
                          dataset.obs_dim, device=device)
    return checkpoint.load(template,
                           checkpoint.checkpoint_path(cfg, experiments_root))
