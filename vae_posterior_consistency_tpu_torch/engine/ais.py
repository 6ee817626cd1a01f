"""Annealed importance sampling with HMC transitions for the marginal
likelihood, and the BDMC sandwich (port of the JAX package's
`engine/ais.py`; reference: src/utils/AIS.py:19-305).

The bridge is log f_t(z) = log p(z) + t * log p(x|z) over a temperature
schedule; each temperature makes one HMC proposal of `leapfrog`=10 steps,
accepted or not chain by chain, with a step size that adapts per chain
(x1.02 while the chain's acceptance rate is above 0.65, else x0.98,
clamped to [1e-4, 0.5]); log p(x) is the log-mean-exp of the chains'
weights. All `n_sample` chains of a batch run as one [B0*n_sample, L]
tensor, chain `s*B0 + b` on data row `b`. Gradients are
`torch.autograd.grad` of the summed potential with respect to z alone,
clamped to [-1e4, 1e4] (AIS.py:196); z carries no graph from one update
to the next.

The observation likelihood ("bridge") follows the model family
(`bridge_for`): the fixed-logvar Gaussian of the gauss family, the
obs_logvar=-8 Gaussian of the flow, the learned-variance Gaussian of
notMIWAE ('changed' and 'author' decoders) and MIWAE's Student-t. As in
the JAX package, Gaussian log-densities drop their constant (AIS.py:32-46),
so a Gaussian bridge's logw estimates log p(x) + D/2 log 2pi, while the
Student-t bridge is exact; the annealed term is +t*log p(x|z).

The schedule is computed in float64 numpy and cast to float32, and logw
accumulates (t1 - t0) * log p(x|z) in float32, as in the JAX package.

Every random draw comes from a noise source called as
`noise(kind, t, shape, df=None)`:
  "z0"      standard normals [B, L], the chains' start (t = 0);
  "v", "u"  at temperature step t (0-based): the momenta [B, L] (normals)
            and the accept uniforms [B] in [0, 1);
  "z_true"  BDMC: the simulated rows' latents [n_batch, L] (normals);
  "x_sim"   BDMC: the observation noise [n_batch, D], standard normals for
            a Gaussian bridge, Student-t draws with `df` [n_batch, D]
            degrees of freedom for MIWAE's;
  "v_rev", "u_rev"  BDMC's reverse chains' momenta and uniforms.
`GeneratorNoise`, the default, draws them from a seeded `torch.Generator`
on the device; a caller may pass its own, for instance one that replays
the JAX package's keys.

Mesh (the JAX package's engine/ais.py:210-263). With a (dp, tp) mesh the
chains are dp-sharded: the batch is padded with zero rows (zero latents
for BDMC's reverse chains) until its B0_run * n_sample chains divide over
dp, each dp rank anneals its block of them (`parallel/mesh.Rows`; the tp
ranks of one dp index repeat it), its draws are the global draws of the
chains cut to its rows ("z0", "v", "u", "v_rev", "u_rev" along their chain
axis, `parallel/mesh.RankRows`; BDMC's simulated rows "z_true" and "x_sim"
are shared), and the step sizes adapt chain by chain, so the temperature
loop needs no collective. The weights and latents are all-gathered at the
end, the padded rows' chains dropped (`_chain_views`). Rank 0 alone
writes.

`eval_ais_ensemble` anneals the same chains for S seed replicas at once
(`_ensemble_runner`): the chain state carries a leading [S] axis, the
bridge's forward is `torch.func.vmap` of `log_lik` over the stacked
parameters and z [S, B, L], and the gradient to z is `torch.autograd.grad`
of its sum, each replica's own since a replica's chains depend on its
parameters alone. The draws [B, L] and [B] are shared and broadcast over S.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.engine import artifacts, checkpoint
from vae_posterior_consistency_tpu_torch.engine.train import (
    check_device,
    epoch_seed,
    load_trained,
)
from vae_posterior_consistency_tpu_torch.models import (
    flow_vae,
    gauss,
    get_model,
    layers,
)
from vae_posterior_consistency_tpu_torch.ops.math import student_t_logpdf
from vae_posterior_consistency_tpu_torch.parallel import mesh as meshlib
from vae_posterior_consistency_tpu_torch.parallel import multihost


def linear_schedule(T: int) -> np.ndarray:
    """(reference: AIS.py:19-20)."""
    return np.linspace(0.0, 1.0, T)


def sigmoidial_schedule(T: int, delta: float = 4.0) -> np.ndarray:
    """Sigmoidal temperature schedule from BDMC §6 (reference: AIS.py:65-77)."""

    def sigmoid(x):
        return np.exp(x) / (1.0 + np.exp(x))

    def beta_tilde(t):
        return sigmoid(delta * (2.0 * t / T - 1.0))

    t = np.arange(1, T + 1, dtype=np.float64)
    return (beta_tilde(t) - beta_tilde(1)) / (beta_tilde(T) - beta_tilde(1))


def _log_normal_nc(x, mean=None, logvar=None):
    """log N without the constant, summed over the last axis (reference:
    AIS.py:32-46)."""
    if mean is None:
        mean = torch.zeros_like(x)
    if logvar is None:
        logvar = torch.zeros_like(x)
    return -0.5 * torch.sum(logvar + torch.square(x - mean)
                            * torch.exp(-logvar), dim=-1)


# ---------------------------------------------------------------------------
# Per-family bridge likelihoods
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BridgeLik:
    """A model family's observation likelihood as AIS sees it.

    log_lik(params, z, x) -> [B] log p(x|z) (the bridge's annealed term);
    sample_x(params, z, noise) -> x ~ p(x|z) (BDMC's simulation, its draw
    the source's "x_sim"). `convention` records the logw offset:
    'gauss_nc' estimates log p(x) + D/2 log 2pi (constant-free normals),
    'exact' log p(x) itself (Student-t, full density)."""

    family: str
    log_lik: Callable
    sample_x: Callable
    convention: str


def _gaussian_ll_from(decode):
    def log_lik(params, z, x):
        mean, logvar = decode(params, z)
        return _log_normal_nc(x, mean, logvar.expand_as(mean))

    return log_lik


def _gaussian_sample_from(decode):
    def sample_x(params, z, noise):
        mean, logvar = decode(params, z)
        logvar = logvar.expand_as(mean)
        draw = noise("x_sim", 0, tuple(mean.shape)).to(mean.device)
        return mean + torch.exp(0.5 * logvar) * draw

    return sample_x


def _notmiwae_decode_changed(params, z):
    return layers.notmiwae_decoder_apply(params["decoder"], z,
                                         variant="changed")


def _notmiwae_decode_author(params, z):
    return layers.notmiwae_decoder_apply(params["decoder"], z,
                                         variant="author")


def _miwae_log_lik(params, z, x):
    """Exact Student-t log p(x|z) (reference decoder: VAE.py:3061-3066)."""
    mean, scale, df = layers.student_t_decoder_apply(params["decoder"], z)
    return torch.sum(student_t_logpdf(x, mean, scale, df), dim=-1)


def _miwae_sample_x(params, z, noise):
    mean, scale, df = layers.student_t_decoder_apply(params["decoder"], z)
    draw = noise("x_sim", 0, tuple(mean.shape), df=df).to(mean.device)
    return mean + scale * draw


_BRIDGES = {
    ("gauss",): BridgeLik("gauss", _gaussian_ll_from(gauss.decode),
                          _gaussian_sample_from(gauss.decode), "gauss_nc"),
    ("flow",): BridgeLik("flow", _gaussian_ll_from(flow_vae.decode),
                         _gaussian_sample_from(flow_vae.decode), "gauss_nc"),
    ("notmiwae", "changed"): BridgeLik(
        "notmiwae", _gaussian_ll_from(_notmiwae_decode_changed),
        _gaussian_sample_from(_notmiwae_decode_changed), "gauss_nc"),
    ("notmiwae", "author"): BridgeLik(
        "notmiwae", _gaussian_ll_from(_notmiwae_decode_author),
        _gaussian_sample_from(_notmiwae_decode_author), "gauss_nc"),
    ("miwae",): BridgeLik("miwae", _miwae_log_lik, _miwae_sample_x, "exact"),
}


def bridge_for(cfg: RunConfig) -> BridgeLik:
    """The AIS observation likelihood for cfg's model family."""
    model = get_model(cfg)
    if model.name == "notmiwae":
        return _BRIDGES[("notmiwae", cfg.not_miwae_type)]
    return _BRIDGES[(model.name,)]


#: flow-family bridge floor: the JAX package's BDMC curve for the flow
#: checkpoints' obs_logvar=-8 likelihood (RESULTS.md "AIS/BDMC schedule
#: certification", measured there on a TPU) closes only around T=4000
FLOW_MIN_AIS_DIST = 4000


def default_schedule(cfg: RunConfig, bridge: BridgeLik | None = None,
                     warn: bool = True) -> np.ndarray:
    """cfg's (ais_schedule, n_ais_dist) bridge schedule; for a flow bridge
    below FLOW_MIN_AIS_DIST temperatures it prints the JAX package's
    warning first."""
    if (warn and bridge is not None and bridge.family == "flow"
            and cfg.n_ais_dist < FLOW_MIN_AIS_DIST):
        print(
            f"[ais] WARNING: flow-family checkpoint on a "
            f"{cfg.ais_schedule} T={cfg.n_ais_dist} bridge — certified only "
            f"for Gaussian decoders; the flow likelihood's measured BDMC "
            f"gap is ~2.5 nats at T=1000 / ~0.7 at T=2000, closing "
            f"(~0.07) only at sigmoidal T={FLOW_MIN_AIS_DIST}. Raise "
            f"-n_ais_dist (and run ais_eval.py -bdmc true to measure the "
            "remaining gap).",
            flush=True,
        )
    return (linear_schedule(cfg.n_ais_dist) if cfg.ais_schedule == "linear"
            else sigmoidial_schedule(cfg.n_ais_dist))


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------


def student_t(df: torch.Tensor, seed: int) -> torch.Tensor:
    """Standard Student-t draws with `df` degrees of freedom (any shape, on
    df's device), made by `torch.distributions.StudentT` from the global
    generator of that device reseeded with `seed` inside `fork_rng`, which
    leaves the caller's global stream as it was (torch has no gamma sampler
    that takes a Generator)."""
    dev = df.device
    cuda = dev.type == "cuda"
    index = (dev.index if dev.index is not None
             else torch.cuda.current_device()) if cuda else None
    with torch.random.fork_rng(devices=[index] if cuda else []):
        if cuda:
            with torch.cuda.device(index):
                torch.cuda.manual_seed(seed)
        else:
            torch.random.default_generator.manual_seed(seed)
        return torch.distributions.StudentT(df).sample()


class GeneratorNoise:
    """The draws of AIS and BDMC from one seeded `torch.Generator` on
    `device`, in the order the run asks for them; a Student-t "x_sim" draw
    is seeded from the generator (`student_t`)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def __call__(self, kind: str, t: int, shape, df=None):
        del t  # the generator's own state advances draw by draw
        g, dev = self.generator, self.device
        if kind in ("u", "u_rev"):
            return torch.rand(shape, generator=g, device=dev)
        if kind in ("z0", "z_true", "v", "v_rev") or (kind == "x_sim"
                                                      and df is None):
            return torch.randn(shape, generator=g, device=dev)
        if kind == "x_sim":
            seed = int(torch.randint(2 ** 62, (1,), generator=g, device=dev))
            return student_t(df, seed)
        raise ValueError(f"unknown AIS noise kind {kind!r}")


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AISResult:
    logw: float  # mean log marginal-likelihood estimate ([S] for S replicas)
    latents: np.ndarray  # final chain positions [(S,) B, n_sample, L]


@dataclasses.dataclass
class AISState:
    """The chains between two temperatures: positions z [..., B, L], step
    sizes eps [..., B], accepts so far accept_hist [..., B], weights logw
    [..., B], and j, the number of the next step (1-based). The leading
    axes are an ensemble's replicas."""

    z: torch.Tensor
    eps: torch.Tensor
    accept_hist: torch.Tensor
    logw: torch.Tensor
    j: float


#: the chain axis of each draw of the chains (None: the simulated rows'
#: "z_true" and "x_sim" are shared by the ranks)
CHAIN_ROWS = {"z0": 0, "v": 0, "u": 0, "v_rev": 0, "u_rev": 0,
              "z_true": None, "x_sim": None}


@dataclasses.dataclass
class Chains:
    """A batch's chains on this rank: the rows x_rep [B, D] and starts z0
    [B, L] of its block of the B0_run * n_sample chains (all of them off a
    mesh), the noise source of its draws, and the `parallel/mesh.Rows` of
    the chain axis."""

    x_rep: torch.Tensor
    z0: torch.Tensor
    noise: Callable
    B0_run: int
    rows: meshlib.Rows

    def gather(self, logw, z):
        """Every rank's chain outputs from this rank's (logw [..., B], z
        [..., B, L]) along the chain axis."""
        return (self.rows.gather(logw, logw.dim() - 1),
                self.rows.gather(z, z.dim() - 2))


def _prep_chains(x, n_sample: int, latent_dim: int, noise, z_init=None,
                 mesh=None) -> Chains:
    """The chains of a batch: x tiled n_sample times (chain s*B0 + b on row
    b), and their starts, the source's "z0" or `z_init` [B0, L] tiled the
    same way (BDMC's reverse chains). With `mesh`, the rows are first
    padded with zero rows (and zero latents) to B0_run, until the chains
    divide over dp, and the chains are this rank's block of them."""
    B0 = x.shape[0]
    B0_run, dp = B0, 1 if mesh is None else mesh.shape["dp"]
    while (B0_run * n_sample) % dp:
        B0_run += 1
    x = meshlib.pad_rows(x, B0_run)
    if z_init is not None:
        z_init = meshlib.pad_rows(z_init, B0_run)
    B = B0_run * n_sample
    rows = meshlib.rows_of(mesh, B)
    if rows.dp > 1:
        noise = meshlib.RankRows(noise, CHAIN_ROWS, rows.dp, rows.r)
    x_rep = rows.take(x.repeat(n_sample, 1))
    if z_init is None:
        z0 = noise("z0", 0, (rows.local, latent_dim)).to(x.device)
    else:
        z0 = rows.take(z_init.repeat(n_sample, 1))
    return Chains(x_rep, z0, noise, B0_run, rows)


def _chain_views(logw, z, n_sample: int, B0_run: int, B0: int,
                 latent_dim: int):
    """[..., B0_run*n_sample] chain outputs -> per-row views: (logw_mat
    [..., B0, n_sample], latents [..., B0, n_sample, L]); the padded rows
    of a mesh drop out here."""
    lead = tuple(logw.shape[:-1])
    logw_mat = torch.movedim(logw.reshape(lead + (n_sample, B0_run)), -2,
                             -1)[..., :B0, :]
    lats = torch.movedim(z.reshape(lead + (n_sample, B0_run, latent_dim)),
                         -3, -2)[..., :B0, :, :]
    return logw_mat, lats


def _log_mean_exp_rows(logw_mat, n_sample: int):
    return torch.logsumexp(logw_mat, dim=-1) - math.log(n_sample)


def _grad_U(ll_fn, z, t):
    """dU/dz of U(z) = -(log p(z) + t log p(x|z)) summed over the chains,
    clamped to [-1e4, 1e4]; z's graph ends here."""
    with torch.enable_grad():
        zg = z.detach().requires_grad_(True)
        U = -(_log_normal_nc(zg) + t * ll_fn(zg))
        (g,) = torch.autograd.grad(U.sum(), zg)
    return torch.clamp(g, -1e4, 1e4)


def _hmc_leapfrog(ll_fn, z, v, eps, t, leapfrog: int):
    """(reference: AIS.py:237-262)."""
    eps_c = eps[..., None]
    v = v - 0.5 * eps_c * _grad_U(ll_fn, z, t)
    for i in range(1, leapfrog + 1):
        z = z + eps_c * v
        if i < leapfrog:
            v = v - eps_c * _grad_U(ll_fn, z, t)
    v = v - 0.5 * eps_c * _grad_U(ll_fn, z, t)
    return z, -v


def ais_step(ll_fn, state: AISState, t0, t1, v, u, leapfrog: int = 10):
    """One temperature of the chains: the weight increment (t1 - t0) *
    log p(x|z), one HMC proposal at t1 from momenta `v` [B, L], accepted
    where its probability exceeds `u` [B], and the step sizes adapted
    (reference: AIS.py:265-304). `ll_fn(z) -> [B]` is the bridge's log
    p(x|z), closed over the data and parameters; t0, t1 are 0-d float32
    tensors. A state with leading replica axes ([S, B, L]) takes `ll_fn(z)
    -> [S, B]`, and the draws broadcast over S. Returns (the next state,
    the accept probabilities [..., B])."""
    with torch.no_grad():
        z = state.z
        lp_z, ll_z = _log_normal_nc(z), ll_fn(z)
        logw = state.logw + (t1 - t0) * ll_z
        z_new, v_new = _hmc_leapfrog(ll_fn, z, v, state.eps, t1, leapfrog)
        cur_H = 0.5 * torch.sum(torch.square(v), -1) - (lp_z + t1 * ll_z)
        prop_H = (0.5 * torch.sum(torch.square(v_new), -1)
                  - (_log_normal_nc(z_new) + t1 * ll_fn(z_new)))
        prob = torch.exp(cur_H - prop_H)
        accept = (prob > u).to(z.dtype)
        z = z_new * accept[..., None] + z * (1.0 - accept[..., None])
        accept_hist = state.accept_hist + accept
        criteria = (accept_hist / state.j > 0.65).to(z.dtype)
        eps = torch.clamp(state.eps * (1.02 * criteria
                                       + 0.98 * (1.0 - criteria)),
                          1e-4, 0.5)
    return AISState(z, eps, accept_hist, logw, state.j + 1.0), prob


def init_state(z0, initial_eps: float = 0.01) -> AISState:
    lead = tuple(z0.shape[:-1])
    zeros = torch.zeros(lead, device=z0.device)
    return AISState(z0, torch.full(lead, initial_eps, device=z0.device),
                    zeros, zeros.clone(), 1.0)


def as_schedule(schedule, device) -> torch.Tensor:
    """A schedule as the float32 tensor the chain steps through."""
    return torch.tensor(np.asarray(schedule, dtype=np.float32),
                        device=device)


def _ais_chain(ll_fn, z0, schedule, noise, initial_eps: float = 0.01,
               leapfrog: int = 10, kinds=("v", "u")):
    """Annealed HMC over the float32 `schedule` for B independent chains
    from z0 [..., B, L]; step i's momenta [B, L] and uniforms [B] are the
    source's kinds[0] and kinds[1] at t = i, shared by any leading
    (replica) axes. Returns (logw [..., B], final z [..., B, L])."""
    B, L = z0.shape[-2:]
    state = init_state(z0, initial_eps)
    for i in range(len(schedule) - 1):
        v = noise(kinds[0], i, (B, L)).to(z0.device)
        u = noise(kinds[1], i, (B,)).to(z0.device)
        state, _ = ais_step(ll_fn, state, schedule[i], schedule[i + 1], v, u,
                            leapfrog)
    return state.logw, state.z


def _bridge_ll(decoder_fn, log_lik_fn):
    """(z, x) -> [B] log p(x|z): `log_lik_fn` itself, or the constant-free
    Gaussian of `decoder_fn(z) -> (mean, logvar)`."""
    if log_lik_fn is not None:
        return log_lik_fn
    gauss_ll = _gaussian_ll_from(lambda _p, z: decoder_fn(z))
    return lambda z, x: gauss_ll(None, z, x)


def ais_batch(decoder_fn, x, n_sample: int, latent_dim: int, schedule, noise,
              initial_eps: float = 0.01, leapfrog: int = 10, mesh=None,
              log_lik_fn=None) -> AISResult:
    """AIS for one batch of data x [B0, D], n_sample chains a row.

    decoder_fn(z) -> (mean, logvar) is a Gaussian observation decoder (the
    reference uses model.decoder so, AIS.py:135); for another bridge pass
    `log_lik_fn(z, x_rep) -> [B]` and decoder_fn=None. The estimate is the
    rows' mean of the log-mean-exp of their chains' weights (AIS.py:
    219-220). With `mesh`, every rank of it calls this and the chains are
    dp-sharded (see the module docstring)."""
    B0 = x.shape[0]
    ll = _bridge_ll(decoder_fn, log_lik_fn)
    ch = _prep_chains(x, n_sample, latent_dim, noise, mesh=mesh)
    logw, z = ch.gather(*_ais_chain(
        lambda z: ll(z, ch.x_rep), ch.z0, as_schedule(schedule, x.device),
        ch.noise, initial_eps, leapfrog))
    logw_mat, lats = _chain_views(logw, z, n_sample, ch.B0_run, B0,
                                  latent_dim)
    lw = _log_mean_exp_rows(logw_mat, n_sample)
    return AISResult(logw=lw.mean().item(), latents=lats.cpu().numpy())


def _ensemble_runner(bridge: BridgeLik):
    """The chain runner of S replicas of one family's bridge: run(params_ens,
    x_rep, z0, schedule, noise, initial_eps=0.01, leapfrog=10) -> (logw [S,
    B], z [S, B, L]), every replica annealing the chains of z0 [B, L] on
    the rows x_rep [B, D] with the same draws. The forward is
    `torch.func.vmap` of the bridge's log_lik over the stacked parameters
    and z [S, B, L]; `_grad_U` differentiates its sum with plain autograd,
    which gives each replica its own gradient."""

    def run(params_ens, x_rep, z0, schedule, noise, initial_eps=0.01,
            leapfrog=10):
        S = next(iter(checkpoint.flatten(params_ens).values())).shape[0]
        forward = torch.func.vmap(
            lambda p, z: bridge.log_lik(p, z, x_rep))
        return _ais_chain(lambda z: forward(params_ens, z),
                          z0.expand(S, *z0.shape), schedule, noise,
                          initial_eps, leapfrog)

    return run


@dataclasses.dataclass
class BDMCResult:
    lower: float  # forward-AIS stochastic lower bound on log p(x_sim)
    upper: float  # reverse-AIS stochastic upper bound on log p(x_sim)
    gap: float  # upper - lower; certifies schedule accuracy
    x_sim: np.ndarray  # the simulated batch [B, D]
    z_true: np.ndarray  # its exact posterior samples [B, L]


def bdmc(decoder_fn, n_batch: int, n_sample: int, latent_dim: int, schedule,
         noise, initial_eps: float = 0.01, leapfrog: int = 10, mesh=None,
         log_lik_fn=None, sample_fn=None, device=None) -> BDMCResult:
    """Bidirectional Monte Carlo sandwich (Grosse et al. 2015) on n_batch
    rows simulated from the model: z_true ~ N(0, I), x_sim ~ p(x|z_true).
    Forward AIS (prior -> posterior) bounds log p(x_sim) from below;
    reverse AIS, its chains started at z_true and the schedule run from 1
    to 0, bounds it from above (by Jensen, -logmeanexp of the reverse
    weights). The gap certifies the schedule for this decoder.

    Gaussian bridges pass decoder_fn; others log_lik_fn(z, x) and
    sample_fn(z, noise) -> x (eval_bdmc wires them through bridge_for).
    The draws are made on `device`, by default decoder_fn's or the
    source's. With `mesh`, both chains are dp-sharded as in `ais_batch`;
    the simulated rows are drawn whole on every rank."""
    z_true = noise("z_true", 0, (n_batch, latent_dim))
    if device is not None:
        z_true = z_true.to(device)
    with torch.no_grad():
        if sample_fn is None:
            mean, logvar = decoder_fn(z_true)
            logvar = logvar.expand_as(mean)
            x = mean + torch.exp(0.5 * logvar) * noise(
                "x_sim", 0, tuple(mean.shape)).to(mean.device)
        else:
            x = sample_fn(z_true, noise)

    fwd = ais_batch(decoder_fn, x, n_sample, latent_dim, schedule, noise,
                    initial_eps, leapfrog, mesh=mesh, log_lik_fn=log_lik_fn)

    ll = _bridge_ll(decoder_fn, log_lik_fn)
    ch = _prep_chains(x, n_sample, latent_dim, noise, z_init=z_true,
                      mesh=mesh)
    rev_sched = torch.flip(as_schedule(schedule, x.device), (0,))
    logw, z = ch.gather(*_ais_chain(
        lambda z: ll(z, ch.x_rep), ch.z0, rev_sched, ch.noise, initial_eps,
        leapfrog, kinds=("v_rev", "u_rev")))
    logw_mat, _ = _chain_views(logw, z, n_sample, ch.B0_run, n_batch,
                               latent_dim)
    upper = (-_log_mean_exp_rows(logw_mat, n_sample)).mean().item()
    return BDMCResult(lower=fwd.logw, upper=upper, gap=upper - fwd.logw,
                      x_sim=x.cpu().numpy(), z_true=z_true.cpu().numpy())


# ---------------------------------------------------------------------------
# Drivers over a trained checkpoint
# ---------------------------------------------------------------------------


def _elbos_dir(cfg: RunConfig, root: str) -> str:
    return os.path.join(root, cfg.vae_type, cfg.data_type, "elbos",
                        f"{cfg.missing_rate}_missing", f"{cfg.epoch}_epochs")


def _trained(dataset, cfg: RunConfig, params, experiments_root: str, device):
    if params is None:
        params = load_trained(dataset, cfg, experiments_root, device=device)
    return checkpoint.on_device(params, device)


def eval_ais(dataset, cfg: RunConfig, params=None, schedule=None,
             n_sample: int = 100, noise: Optional[Callable] = None,
             experiments_root: str = "experiments", save: bool = True,
             mesh=None, device="cuda") -> dict:
    """AIS over the dataset's splits (reference: AIS.py:80-91) for the
    trained checkpoint of any family (its bridge, `bridge_for`), by
    default loaded from its reference name; returns {stage: AISResult}.
    Saves the JAX package's artifacts: the estimate as a 0-d float64
    `<root>/<vae_type>/<data_type>/elbos/<missing_rate>_missing/
    <epoch>_epochs/<stage>_ais.pt`, the final chains [B0, n_sample, L]
    float32 at the same path under latents/ as
    `<stage>_ais_true_latents.pt`, and the `ais_logw` metric.

    `noise(split_index) -> source` gives each split's draws (train 0, test
    1); by default `GeneratorNoise(epoch_seed(cfg.seed + 4, split_index),
    device)`. With `mesh`, the chains are dp-sharded (`ais_batch`) and
    rank 0 writes."""
    device = mesh.device if mesh is not None else check_device(device)
    bridge = bridge_for(cfg)
    params = _trained(dataset, cfg, params, experiments_root, device)
    if schedule is None:
        schedule = default_schedule(cfg, bridge)
    if noise is None:
        def noise(split_idx):
            return GeneratorNoise(epoch_seed(cfg.seed + 4, split_idx), device)

    def log_lik_fn(z, x):
        return bridge.log_lik(params, z, x)

    results = {}
    for split_idx, split in enumerate((dataset.train, dataset.test)):
        if split is None:
            continue
        res = ais_batch(None, split.x.to(device=device, dtype=torch.float32),
                        n_sample, cfg.latent_dim, schedule, noise(split_idx),
                        mesh=mesh, log_lik_fn=log_lik_fn)
        results[split.stage] = res
        if save and multihost.is_coordinator():
            base = _elbos_dir(cfg, experiments_root)
            artifacts.save_tensor(res.logw,
                                  os.path.join(base, f"{split.stage}_ais.pt"))
            artifacts.save_tensor(
                res.latents,
                os.path.join(base.replace("elbos", "latents"),
                             f"{split.stage}_ais_true_latents.pt"))
            artifacts.log_metric(cfg, "ais_logw", res.logw, split.stage,
                                 experiments_root)
    return results


def eval_ais_ensemble(dataset, cfg: RunConfig, params_ens, schedule=None,
                      n_sample: int = 100, noise: Optional[Callable] = None,
                      experiments_root: str = "experiments",
                      save: bool = True, mesh=None, device="cuda") -> dict:
    """AIS over the dataset's splits for the S seed replicas of
    `params_ens` (every leaf [S, ...], `checkpoint.load_seed_ensemble`'s
    layout) at once (engine/ais.py:500-569 of the JAX package): every
    replica anneals the same chains, the same z0, momenta and uniforms as
    `eval_ais` draws from `noise(split_index)`, so replica s is `eval_ais`
    of replica s's parameters; each keeps its own step sizes, accepts and
    weights. Returns {stage: AISResult} with logw a float64 [S] array and
    latents [S, B0, n_sample, L]. With `save`, replica s writes `eval_ais`'s
    two artifacts with `checkpoint.seed_suffix(s)` appended (replica 0 at
    the reference names), and replica 0's `ais_logw` is logged. With
    `mesh`, the chains are dp-sharded as in `eval_ais` (the parameters
    replicated)."""
    device = mesh.device if mesh is not None else check_device(device)
    bridge = bridge_for(cfg)
    params_ens = checkpoint.on_device(params_ens, device)
    if schedule is None:
        schedule = default_schedule(cfg, bridge)
    if noise is None:
        def noise(split_idx):
            return GeneratorNoise(epoch_seed(cfg.seed + 4, split_idx), device)

    run = _ensemble_runner(bridge)
    results = {}
    for split_idx, split in enumerate((dataset.train, dataset.test)):
        if split is None:
            continue
        x = split.x.to(device=device, dtype=torch.float32)
        ch = _prep_chains(x, n_sample, cfg.latent_dim, noise(split_idx),
                          mesh=mesh)
        logw, z = ch.gather(*run(params_ens, ch.x_rep, ch.z0,
                                 as_schedule(schedule, device), ch.noise))
        logw_mat, lats = _chain_views(logw, z, n_sample, ch.B0_run,
                                      x.shape[0], cfg.latent_dim)
        logws = _log_mean_exp_rows(logw_mat, n_sample).mean(dim=-1)
        res = AISResult(logw=logws.cpu().numpy().astype(np.float64),
                        latents=lats.cpu().numpy())
        results[split.stage] = res
        if save and multihost.is_coordinator():
            base = _elbos_dir(cfg, experiments_root)
            for s in range(res.logw.shape[0]):
                sfx = checkpoint.seed_suffix(s)
                artifacts.save_tensor(
                    float(res.logw[s]),
                    os.path.join(base, f"{split.stage}_ais.pt{sfx}"))
                artifacts.save_tensor(
                    res.latents[s],
                    os.path.join(base.replace("elbos", "latents"),
                                 f"{split.stage}_ais_true_latents.pt{sfx}"))
            artifacts.log_metric(cfg, "ais_logw", float(res.logw[0]),
                                 split.stage, experiments_root)
    return results


def eval_bdmc(dataset, cfg: RunConfig, params=None, schedule=None,
              n_sample: int = 100, n_batch: int | None = None, noise=None,
              experiments_root: str = "experiments", save: bool = True,
              mesh=None, device="cuda") -> BDMCResult:
    """The BDMC sandwich for the trained checkpoint of any family:
    n_batch rows (by default min(batch_size, the test split's rows))
    simulated from its decoder (Gaussian or Student-t, per bridge_for),
    their log p bracketed by forward and reverse AIS on the schedule
    eval_ais uses. Saves bdmc_lower.pt and bdmc_upper.pt (0-d float64)
    beside eval_ais's artifacts and the `bdmc_gap` metric (stage 'sim').
    The draws come from `noise`, by default `GeneratorNoise(cfg.seed + 5,
    device)`. With `mesh`, the chains are dp-sharded (`bdmc`) and rank 0
    writes."""
    device = mesh.device if mesh is not None else check_device(device)
    bridge = bridge_for(cfg)
    params = _trained(dataset, cfg, params, experiments_root, device)
    if schedule is None:
        # no warning: BDMC is the tool that measures the gap
        schedule = default_schedule(cfg, bridge, warn=False)
    if n_batch is None:
        n_batch = min(cfg.batch_size, dataset.test.x.shape[0]
                      if dataset.test is not None else cfg.batch_size)
    noise = GeneratorNoise(cfg.seed + 5, device) if noise is None else noise

    res = bdmc(None, n_batch, n_sample, cfg.latent_dim, schedule, noise,
               log_lik_fn=lambda z, x: bridge.log_lik(params, z, x),
               sample_fn=lambda z, src: bridge.sample_x(params, z, src),
               device=device, mesh=mesh)
    if save and multihost.is_coordinator():
        base = _elbos_dir(cfg, experiments_root)
        artifacts.save_tensor(res.lower, os.path.join(base, "bdmc_lower.pt"))
        artifacts.save_tensor(res.upper, os.path.join(base, "bdmc_upper.pt"))
        artifacts.log_metric(cfg, "bdmc_gap", res.gap, "sim",
                             experiments_root)
    return res
