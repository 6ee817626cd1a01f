"""EDDI-style information-reward active variable selection (port of the JAX
package's `engine/active_learning.py`, the serial path; reference:
src/experiment_main/evaluate.py:300-511).

From an empty mask, each step imputes the rows M times, scores every
still-hidden candidate feature u of each row by the Lindley information
reward R(u) ~ KL(post(x_o u x_u) || post(x_o)) - KL(the same with the
target revealed), reveals the argmax feature of each row, and records the
predictive MSE of the target (the last column) after the reveal. An
episode is D-1 steps, one Python iteration each (`al_step`): each reveal
feeds the next step's mask.

Inside a step nothing loops over candidates or samples: they are stacked on
the row axis. The Gaussian-KL reward (every family with
`ModelDef.encode_stats`) makes four encoder calls a step: q(x, mask) once,
q(x with the target from sample m, mask + target) over the [M*n] rows, and
the two candidate-dependent posteriors over the [M*(D-1)*n] rows. A
candidate only scores where it is hidden, and hidden features never reach
the encoder, so the first two are candidate-invariant, as in the JAX
package's hoisting. The flow's ratio reward makes four calls of
[(D-1)*M*n] rows. For the EDDI types each call is one launch of the
embed+pool kernel B2f on CUDA tensors; with the imputations' and the
predictive MSE's one each, an episode launches it 1 + 6*(D-1) times.

Reward math (reference: evaluate.py:514-708): the chaini 'KL' with the
reference's quirk kept, and the flow's ratio form sum|lp - lp_u| -
sum|lp_t - lp_tu| of sampled-z encoder log-probs.

The noise is explicit: a source called as `noise(kind, repeat, step,
shape)` hands out whole stacked standard-normal tensors:
- "init" (step 0): the M imputations of the empty-mask predictive MSE,
  [M, *eps], `eps` the family's `ModelDef.eval_noise(cfg, n, D)["eps"]`;
- "im": step t's M imputations, [M, *eps];
- "flow" (flow family only): step t's reward draws, [4, D-1, M, n, L],
  axis 0 the four encoder calls (lp, lp_u, lp_t, lp_tu), then candidate,
  then sample;
- "mse": the M imputations of step t's predictive MSE after the reveal,
  [M, *eps].
By default one `torch.Generator` seeded with cfg.seed + 3 on the device
draws them in that order. The JAX package also draws a `mask_p` a repeat
that no reward reads (evaluate.py:351-352); the port draws none.

Mesh (the JAX package's engine/active_learning.py:219-236, 89-115). With a
(dp, tp) mesh the test rows are dp-sharded: they are padded with zero rows
to a multiple of dp (`parallel/mesh.Rows`), each dp rank runs the episode
on its block (the tp ranks of one dp index repeat it), its draws are the
global draws at the padded row count cut to its rows (`parallel/mesh.
RankRows`: the row axis of "init", "im", "mse" and the flow's "flow"), and
rewards and reveals stay row-local. The one collective is the predictive
MSE: each rank's squared errors are summed with the padded rows weighted
out (`predictive_mse(row_weights=)`), the sums all-reduced over dp and
divided by M times the real row count, as JAX's `sum(sq * w) / (M *
sum(w))`. The MSE feeds no decision, so the reduce comes after the
episode. The row artifacts are all-gathered and cut to the real rows;
rank 0 alone writes. At dp = 1 nothing is padded or reduced: the mesh
episode is the single-device one.

`active_learning_ensemble` runs the episode of S seed replicas (stacked
parameters, `checkpoint.load_seed_ensemble`) as one `torch.func.vmap` of
`run_episode` over the replicas. Every replica sees the same draws: a
repeat's are made before the vmap, in the serial episode's order
(`replay_noise`), and handed out unbatched inside it, so replica s is the
serial episode of replica s's parameters. The rows are shared; the masks
part after the first reveal. B2f stays one launch a call for all replicas
(`EmbedPool.vmap`).
"""

from __future__ import annotations

import os

import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import artifacts, checkpoint
from vae_posterior_consistency_tpu_torch.engine.inference import completion
from vae_posterior_consistency_tpu_torch.engine.train import (
    GeneratorNoise,
    check_device,
    load_trained,
)
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.parallel import mesh as meshlib
from vae_posterior_consistency_tpu_torch.parallel import multihost
from vae_posterior_consistency_tpu_torch.utils import tracing

#: reward placeholder for already-revealed features
#: (reference: evaluate.py:391)
NEG_INF_REWARD = -1e4
#: the four episode tensors, in the order they are saved
ARTIFACTS = ("information_curve", "action", "R_hist", "im")


def _chaini_kl(mean, logvar, mean_i, logvar_i):
    """The reference's closed-form 'KL' between encoder posteriors before and
    after revealing feature i (evaluate.py:582-584), its quirk kept
    verbatim: the squared mean difference is divided by v = exp(logvar/2),
    the std, not the variance."""
    v = torch.exp(logvar / 2.0)
    var = torch.exp(logvar)
    var_i = torch.exp(logvar_i)
    return 0.5 * torch.sum(
        torch.square(mean_i - mean) / v + var_i / var - 1.0 - logvar_i
        + logvar, dim=-1)


def _flow_reward(model, params, cfg, x_mod, mask, u_onehot, last_onehot,
                 eps):
    """The ratio-version reward sum|log q - log q_u| - sum|log q_t -
    log q_tu| (reference: evaluate.py:669-708) of each row, `eps` [4, rows,
    L] the base noise of the four encoder calls."""
    lp = model.encode_sample_logprob(params, x_mod, mask, eps[0], cfg)
    mask_u = torch.maximum(mask, u_onehot)
    lp_u = model.encode_sample_logprob(params, x_mod, mask_u, eps[1], cfg)
    kl_1 = torch.sum(torch.abs(lp - lp_u), dim=-1)

    mask_t = torch.maximum(mask, last_onehot)
    lp_t = model.encode_sample_logprob(params, x_mod, mask_t, eps[2], cfg)
    mask_tu = torch.maximum(mask_t, u_onehot)
    lp_tu = model.encode_sample_logprob(params, x_mod, mask_tu, eps[3], cfg)
    kl_2 = torch.sum(torch.abs(lp_t - lp_tu), dim=-1)
    return kl_1 - kl_2


def _impute_samples(cfg, params, x, mask, eps):
    """M Monte-Carlo imputations [M, n, D] from eps [M, *eps] (reference:
    evaluate.py:393-414), through `completion` with an all-ones mask_p."""
    return completion(params, x, mask, torch.ones_like(mask), eps.shape[0],
                      cfg, eps={"eps": eps})


def eps_shape(cfg: RunConfig, n: int, D: int) -> tuple:
    """The shape of one imputation's noise: the family's evaluation eps."""
    return tuple(get_model(cfg).eval_noise(cfg, n, D)["eps"])


def predictive_mse(cfg, params, x, mask, eps, row_weights=None):
    """The mean over the M samples and the rows of the squared error of the
    imputed target (reference: evaluate.py:364-385), a 0-d tensor; with
    `row_weights` [n], the weighted sum of the squared errors instead (a
    mesh rank's share, which the caller reduces and divides)."""
    im = _impute_samples(cfg, params, x, mask, eps)
    sq = torch.square(im[:, :, -1] - x[None, :, -1])
    if row_weights is None:
        return torch.mean(sq)
    return torch.sum(sq * row_weights[None, :])


def _onehots(D, device):
    eye = torch.eye(D, device=device)
    return eye[:D - 1], eye[D - 1]  # candidates [D-1, D], target [D]


def _gauss_rewards(model, params, cfg, x, mask, im):
    """R [D-1, n], the sample mean of the Gaussian-KL rewards. Four encoder
    calls: the two candidate-invariant posteriors once a step and once a
    sample, the two candidate ones over every (sample, candidate) pair."""
    M, n, D = im.shape
    U = D - 1
    cand, last = _onehots(D, x.device)
    stats = model.encode_stats

    def encode(xs, ms):
        mean, logvar = stats(params, xs.reshape(-1, D), ms.reshape(-1, D),
                             cfg)
        return (mean.reshape(*xs.shape[:-1], -1),
                logvar.reshape(*xs.shape[:-1], -1))

    mean0, logvar0 = stats(params, x, mask, cfg)  # [n, L]
    mask_t = torch.maximum(mask, last)
    x_last = x * (1 - last) + im * last  # [M, n, D]
    mean_t, logvar_t = encode(x_last, mask_t.expand(M, n, D))  # [M, n, L]

    u = cand[None, :, None, :]  # [1, U, 1, D]
    x_mod = x * (1 - u) + im[:, None] * u  # [M, U, n, D]
    mean_u, logvar_u = encode(x_mod,
                              torch.maximum(mask, u).expand(M, U, n, D))
    x_mod2 = x_mod * (1 - last) + im[:, None] * last
    mean_tu, logvar_tu = encode(x_mod2,
                                torch.maximum(mask_t, u).expand(M, U, n, D))
    kl_1 = _chaini_kl(mean0, logvar0, mean_u, logvar_u)  # [M, U, n]
    kl_2 = _chaini_kl(mean_t[:, None], logvar_t[:, None], mean_tu, logvar_tu)
    return (kl_1 - kl_2).sum(dim=0) / M


def _flow_rewards(model, params, cfg, x, mask, im, eps):
    """R [D-1, n], the sample mean of the flow's ratio rewards: four encoder
    calls over the [(D-1)*M*n] (candidate, sample, row) stack."""
    M, n, D = im.shape
    U = D - 1
    cand, last = _onehots(D, x.device)
    u = cand[:, None, None, :]  # [U, 1, 1, D]
    x_mod = x * (1 - u) + im[None] * u  # [U, M, n, D]

    def rows(t):
        return t.expand(U, M, n, D).reshape(-1, D)

    r = _flow_reward(model, params, cfg, rows(x_mod), rows(mask), rows(u),
                     last, eps.reshape(4, U * M * n, -1))
    return r.reshape(U, M, n).sum(dim=1) / M


def rewards(model, params, cfg, x, mask, im, eps=None):
    """R [n, D-1]: each row's reward for each candidate feature, the
    revealed ones at NEG_INF_REWARD. `eps` [4, D-1, M, n, L] is the flow's
    reward noise (None for the Gaussian-KL families)."""
    D = x.shape[1]
    if model.encode_stats is None:
        R = _flow_rewards(model, params, cfg, x, mask, im, eps)
    else:
        R = _gauss_rewards(model, params, cfg, x, mask, im)
    hidden = mask[:, :D - 1] == 0.0
    return torch.where(hidden, R.T, torch.full_like(R.T, NEG_INF_REWARD))


def al_step(model, params, cfg: RunConfig, x, mask, noise, repeat: int,
            t: int, row_weights=None) -> dict:
    """Selection step t of episode `repeat` from `mask` [n, D]: the M
    imputations, the rewards, the argmax reveal of each row and the
    predictive MSE after it (`predictive_mse`'s, with `row_weights`).
    Returns {"R" [n, D-1], "action" [n] (float32), "mse" (0-d), "im" [M,
    n, D], "mask" [n, D] (the new mask)}."""
    n, D = x.shape
    M = cfg.M
    shape = (M, *eps_shape(cfg, n, D))
    with tracing.span("al.step"):
        with tracing.span("al.impute"):
            im = _impute_samples(cfg, params, x, mask,
                                 noise("im", repeat, t, shape).to(x.device))
        with tracing.span("al.rewards"):
            flow_eps = None
            if model.encode_stats is None:
                flow_eps = noise("flow", repeat, t,
                                 (4, D - 1, M, n, cfg.latent_dim)).to(
                                     x.device)
            R = rewards(model, params, cfg, x, mask, im, flow_eps)
        with tracing.span("al.select"):
            i_opt = torch.argmax(R, dim=1)  # the first maximum, as jnp.argmax
            new_mask = mask + torch.nn.functional.one_hot(i_opt, D).to(
                mask.dtype)
            mse = predictive_mse(cfg, params, x, new_mask,
                                 noise("mse", repeat, t, shape).to(x.device),
                                 row_weights)
    return {"R": R, "action": i_opt.to(torch.float32), "mse": mse, "im": im,
            "mask": new_mask}


def run_episode(model, params, cfg: RunConfig, x, noise, repeat: int = 0,
                row_weights=None):
    """One selection episode over the rows x [n, D] from an empty mask:
    {"information_curve" [n, D] (the target MSE after 0..D-1 reveals, the
    same for every row, as the reference stores it; with `row_weights`
    the weighted sums of `predictive_mse`), "action" [n, D-1], "R_hist"
    [D-1, n, D-1], "im" [D-1, M, n, D]}."""
    n, D = x.shape
    with tracing.span("al.episode"):
        mask = torch.zeros_like(x)
        shape = (cfg.M, *eps_shape(cfg, n, D))
        curve = [predictive_mse(cfg, params, x, mask,
                                noise("init", repeat, 0, shape).to(x.device),
                                row_weights)]
        steps = []
        for t in range(D - 1):
            out = al_step(model, params, cfg, x, mask, noise, repeat, t,
                          row_weights)
            mask = out["mask"]
            curve.append(out["mse"])
            steps.append(out)
        return {
            "information_curve": torch.stack(curve)[None, :].expand(n, D),
            "action": torch.stack([s["action"] for s in steps]).T,
            "R_hist": torch.stack([s["R"] for s in steps]),
            "im": torch.stack([s["im"] for s in steps]),
        }


def default_noise(cfg: RunConfig, device):
    """The episode's draws from one `torch.Generator` seeded with
    cfg.seed + 3 on `device`, in the order the episode asks for them."""
    src = GeneratorNoise(cfg.seed + 3, device)
    return lambda kind, repeat, step, shape: src("eps", repeat, step, shape)


def replay_noise(noise, cfg: RunConfig, n: int, D: int, repeat: int,
                 flow: bool):
    """Repeat `repeat`'s draws of an episode over n rows of width D, made
    from `noise` now in the order `run_episode` asks for them ("init", then
    each step's "im", the flow's "flow" and "mse"), as a source that hands
    them out again by (kind, step): the draws of a vmapped episode, which
    may not draw inside the vmap."""
    shape = (cfg.M, *eps_shape(cfg, n, D))
    draws = {("init", 0): noise("init", repeat, 0, shape)}
    for t in range(D - 1):
        draws["im", t] = noise("im", repeat, t, shape)
        if flow:
            draws["flow", t] = noise("flow", repeat, t,
                                     (4, D - 1, cfg.M, n, cfg.latent_dim))
        draws["mse", t] = noise("mse", repeat, t, shape)
    return lambda kind, r, step, shape: draws[kind, step]


#: the row axis of each episode artifact after its leading [Repeat] axis
_ARTIFACT_ROWS = {"action": 1, "R_hist": 2, "im": 3}


def _episode_rows(x, cfg: RunConfig, mesh, noise):
    """The test rows of an episode on a mesh (the JAX package's
    `_pad_rows_for_mesh`): their `Rows`, this rank's block of x padded
    with zero rows to a multiple of dp, its row weights (None at dp = 1)
    and its noise source. At dp = 1 it hands back x and `noise`."""
    rows = meshlib.rows_of(mesh, x.shape[0])
    if rows.dp == 1:
        return rows, x, None, noise
    eps_rows = get_model(cfg).eval_noise_rows(cfg)["eps"] + 1
    noise = meshlib.RankRows(
        noise, {"init": eps_rows, "im": eps_rows, "mse": eps_rows,
                "flow": 3}, rows.dp, rows.r)
    return rows, rows.take(rows.pad(x)), rows.weights(x.device), noise


def _assemble(stacked: dict, rows, M: int, lead: int) -> dict:
    """The episode artifacts of every rank from this rank's (each with
    `lead` leading axes before its own): the MSE sums reduced over dp and
    divided by M times the real rows, broadcast to them, and the row
    artifacts gathered and cut to the real rows."""
    if rows.dp == 1:
        return stacked
    import torch.distributed as dist

    sums = stacked["information_curve"].select(lead, 0).contiguous()
    dist.all_reduce(sums, group=rows.group)
    curve = sums / (M * rows.n)
    out = {"information_curve": curve.unsqueeze(lead).expand(
        *curve.shape[:lead], rows.n, curve.shape[-1])}
    for name, axis in _ARTIFACT_ROWS.items():
        out[name] = rows.gather(stacked[name], lead + axis - 1)
    return out


def active_learning_func(dataset_train, test_data, test_mask, cfg: RunConfig,
                         experiments_root: str = "experiments",
                         Repeat: int = 1, params=None, noise=None,
                         save: bool = True, mesh=None, device="cuda"):
    """Top-level AL driver (reference: evaluate.py:300-511): `Repeat`
    selection episodes on the test rows with the trained checkpoint
    (loaded by `train.load_trained` when `params` is None; the reference's
    training call is commented out, evaluate.py:309-313). Returns the four
    tensors with a leading [Repeat] axis, on the device:
    information_curve [R, n, D], action [R, n, D-1] (float32), R_hist
    [R, D-1, n, D-1], im [R, D-1, M, n, D]; with `save`, writes each at its
    `artifacts.active_learning_paths` name as a float32 tensor and logs
    al_final_mse (information_curve[:, 0, -1]) at stage 'test'.
    `dataset_train` is unused, as in the JAX package. With `mesh`, every
    rank of it calls this; the test rows are dp-sharded (see the module
    docstring), every rank gets the whole artifacts and rank 0 writes
    them."""
    del dataset_train
    device = mesh.device if mesh is not None else check_device(device)
    x = torch.as_tensor(test_data, dtype=torch.float32).to(device)
    test_mask = torch.as_tensor(test_mask, dtype=torch.float32).to(device)
    D = x.shape[1]
    if params is None:
        path = checkpoint.checkpoint_path(cfg, experiments_root)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path}: no trained checkpoint of {cfg.vae_type}; train it "
                "first (experiment_main/imputation.py)")
        ds = Dataset(train=Split(x, test_mask, "train"), test=None, obs_dim=D)
        params = load_trained(ds, cfg, experiments_root, device=device)
    noise = default_noise(cfg, device) if noise is None else noise
    model = get_model(cfg)
    rows, x, weights, noise = _episode_rows(x, cfg, mesh, noise)
    with torch.no_grad():
        runs = [run_episode(model, params, cfg, x, noise, r, weights)
                for r in range(Repeat)]
        stacked = _assemble({name: torch.stack([run[name] for run in runs])
                             for name in ARTIFACTS}, rows, cfg.M, 1)
    if save and multihost.is_coordinator():
        paths = artifacts.active_learning_paths(cfg, experiments_root)
        tracing.count("host_reads", len(ARTIFACTS) + 1)
        for name in ARTIFACTS:
            artifacts.save_tensor(stacked[name].cpu().contiguous(),
                                  paths[name])
        artifacts.log_metric(
            cfg, "al_final_mse",
            stacked["information_curve"][:, 0, -1].cpu().numpy(), "test",
            experiments_root)
    return stacked


def active_learning_ensemble(test_data, test_mask, cfg: RunConfig, params_ens,
                             experiments_root: str = "experiments",
                             Repeat: int = 1, noise=None, save: bool = True,
                             mesh=None, device="cuda"):
    """`Repeat` selection episodes of each of the S seed replicas of
    `params_ens` (every leaf [S, ...], `checkpoint.load_seed_ensemble`'s
    layout) on the test rows, as one vmapped episode a repeat
    (engine/active_learning.py:328-415 of the JAX package). Every replica
    sees the same draws, those `active_learning_func` would draw from
    `noise` (by default `default_noise(cfg, device)`), so replica s is the
    serial episode of replica s's parameters. Returns the four tensors with
    a leading [S, Repeat] on the device: information_curve [S, R, n, D],
    action [S, R, n, D-1], R_hist [S, R, D-1, n, D-1], im [S, R, D-1, M, n,
    D]; with `save`, replica s writes each at its `active_learning_paths`
    name + `checkpoint.seed_suffix(s)` (replica 0 at the reference names)
    and replica 0's al_final_mse is logged at stage 'test'. `test_mask` is
    unused, as in the serial driver. With `mesh`, the test rows are
    dp-sharded as in `active_learning_func` (the parameters replicated)."""
    del test_mask
    device = mesh.device if mesh is not None else check_device(device)
    x = torch.as_tensor(test_data, dtype=torch.float32).to(device)
    params_ens = checkpoint.on_device(params_ens, device)
    noise = default_noise(cfg, device) if noise is None else noise
    model = get_model(cfg)
    flow = model.encode_stats is None
    rows, x, weights, noise = _episode_rows(x, cfg, mesh, noise)
    n, D = x.shape
    runs = []
    with torch.no_grad():
        for r in range(Repeat):
            src = replay_noise(noise, cfg, n, D, r, flow)
            runs.append(torch.func.vmap(
                lambda p: run_episode(model, p, cfg, x, src, r,
                                      weights))(params_ens))
        stacked = _assemble({name: torch.stack([run[name] for run in runs],
                                               dim=1)
                             for name in ARTIFACTS}, rows, cfg.M, 2)
    if save and multihost.is_coordinator():
        paths = artifacts.active_learning_paths(cfg, experiments_root)
        tracing.count("host_reads", len(stacked))
        host = {name: t.cpu() for name, t in stacked.items()}
        for s in range(host["im"].shape[0]):
            for name in ARTIFACTS:
                artifacts.save_tensor(host[name][s].contiguous(),
                                      paths[name] + checkpoint.seed_suffix(s))
        artifacts.log_metric(
            cfg, "al_final_mse",
            host["information_curve"][0, :, 0, -1].numpy(), "test",
            experiments_root)
    return stacked
