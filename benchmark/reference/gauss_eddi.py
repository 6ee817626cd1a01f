"""Plain PyTorch reference of the regularised EDDI VAE (`reg_EDDI*`,
`kl_reg`): the model, its training loss, Adam, its evaluation, serving and
active-learning semantics, written from the published description and
nothing of the system under test.

The model (Ma et al., "EDDI", arXiv:1809.11142; the posterior-consistency
reference `stschia/VAE-posterior-consistency`, src/models/VAE.py
Reg_EDDI / Reg_EDDI_mnist):
- each feature d becomes the point [x_d, x_d * e_d, b_d] (e_d the K-wide
  per-feature embedding `type_pars`, b_d its scalar `type_bias`), mapped by
  one Linear(K+2 -> K) and a ReLU, and the points of the observed features
  are summed (PointNet): the aggregate [N, K];
- a ReLU trunk maps the aggregate to 2 x latent: (mean, logvar);
- z = mean + eps * exp(logvar / 2);
- a ReLU decoder with a sigmoid output gives the mean of a Gaussian with
  the fixed log-variance log(0.02);
- the reconstruction term of a cell is the masked negative log-density
  m * (0.5 (x - mu)^2 / 0.02 + 0.5 log 0.02) plus log sqrt(2 pi) on every
  cell, the reference's mask-everything convention;
- `kl_reg`: the q branch sees `mask`, the p branch `mask_p` (mask with a
  further 30% MCAR removed); loss = L_q + alpha (KL(q||p) - L_q + L_p +
  RE_q on the cells that mask_p hides), over the batch rows.

Everything is float32. Every matrix product goes through `matmul`, which
rounds both operands to TF32 under `precision("tf32")`: the control that
the comparison must reject. The point embedding is formed as written above
(a [N, D, K+2] tensor), not in any folded form; rows are taken in blocks.

Parameters are a flat dict {"encoder/pnp1/layer0/w": tensor, ...}: the
benchmark makes them (`harness/inputs.py`) and hands the same values to
the system and to this file.
"""

from __future__ import annotations

import contextlib
import math

import torch

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
#: the decoder's fixed observation log-variance, log((0.1 sqrt 2)^2)
X_LOGVAR = math.log(0.02)
#: rows a forward takes at once (the [N, D, K+2] point tensor of MNIST
#: at 4096 rows is 154 MB)
BLOCK_ROWS = 4096

_PRECISION = ["fp32"]


@contextlib.contextmanager
def precision(mode: str):
    """'fp32' (the reference) or 'tf32' (both operands of every product
    rounded to TF32's 10 mantissa bits, float32 sums: the control)."""
    _PRECISION.append(mode)
    try:
        yield
    finally:
        _PRECISION.pop()


def tf32_round(t):
    """Round float32 to the nearest TF32 value (10 mantissa bits), ties
    away from zero, as the tensor cores take their operands."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a [..., N, K] @ b [K, M] with both operands rounded to TF32, and
    the backward's products so too."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        da = torch.matmul(rg, rb.mT)
        db = torch.matmul(ra.reshape(-1, ra.shape[-1]).mT,
                          rg.reshape(-1, rg.shape[-1]))
        return da, db


def matmul(a, b):
    if _PRECISION[-1] == "tf32":
        return _TF32MatMul.apply(a, b)
    return torch.matmul(a, b)


def param_specs(cfg: dict):
    """[(key, shape, init bound)] of the model in `cfg`, in a fixed order:
    torch's Linear default U(+-1/sqrt(fan_in)), Xavier-uniform for the
    per-feature tables."""
    D, K, L = cfg["obs_dim"], cfg["K"], cfg["latent_dim"]
    specs = []

    def mlp(prefix, sizes):
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / math.sqrt(a)
            specs.append((f"{prefix}/layer{i}/w", (a, b), bound))
            specs.append((f"{prefix}/layer{i}/b", (b,), bound))

    mlp("encoder/pnp1", [K + 2, K])
    mlp("encoder/pnp2", [K, *cfg["encoder_trunk"], 2 * L])
    specs.append(("encoder/type_pars", (D, K), math.sqrt(6.0 / (D + K))))
    specs.append(("encoder/type_bias", (D, 1), math.sqrt(6.0 / (D + 1))))
    mlp("decoder", [L, *cfg["decoder"], D])
    return specs


def _mlp(p, prefix, h, final):
    n = sum(1 for k in p if k.startswith(prefix + "/layer") and
            k.endswith("/w"))
    for i in range(n):
        h = matmul(h, p[f"{prefix}/layer{i}/w"]) + p[f"{prefix}/layer{i}/b"]
        h = torch.relu(h) if i < n - 1 else final(h)
    return h


def encode(p, x, mask):
    """(mean, logvar) [N, L] of q(z | x, mask), x and mask [N, D]."""
    xe = x[..., None]
    points = torch.cat([xe, xe * p["encoder/type_pars"],
                        p["encoder/type_bias"].expand(*x.shape, 1)], dim=-1)
    emb = torch.relu(matmul(points, p["encoder/pnp1/layer0/w"])
                     + p["encoder/pnp1/layer0/b"])
    agg = (emb * mask[..., None]).sum(dim=-2)
    h = _mlp(p, "encoder/pnp2", agg, lambda t: t)
    L = h.shape[-1] // 2
    return h[..., :L], h[..., L:]


def decode(p, z):
    return _mlp(p, "decoder", z, torch.sigmoid)


def recon(x, x_mean, m, dim=None):
    cell = (m * (0.5 * torch.square(x - x_mean) / math.exp(X_LOGVAR)
                 + 0.5 * X_LOGVAR) + LOG_SQRT_2PI)
    return cell.sum() if dim is None else cell.sum(dim=dim)


def kl_std(mean, logvar, dim=None):
    kl = 0.5 * (torch.exp(logvar) + torch.square(mean) - 1.0 - logvar)
    return kl.sum() if dim is None else kl.sum(dim=dim)


def kl_pair(mq, lq, mp, lp):
    return (0.5 * (lp - lq + (torch.exp(lq) + torch.square(mq - mp))
                   * torch.exp(-lp) - 1.0)).sum()


def keep_threshold(rate):
    """1 - rate/100 in float32 arithmetic: an MCAR cell is observed where
    its uniform lies below it."""
    r = torch.tensor(float(rate), dtype=torch.float32) / 100.0
    return float(torch.tensor(1.0, dtype=torch.float32) - r)


def train_loss(p, cfg, x, mask, u_maskp, eps):
    """The `kl_reg` loss of one batch: x, mask [B, D]; u_maskp [B, D] the
    uniforms of mask_p; eps [2, B, L] (q branch, p branch)."""
    B = x.shape[0]
    mask_p = mask * (u_maskp < keep_threshold(cfg["p_missingness"])).float()
    mq, lq = encode(p, x, mask)
    mp, lp = encode(p, x, mask_p)
    zq = mq + eps[0] * torch.exp(0.5 * lq)
    zp = mp + eps[1] * torch.exp(0.5 * lp)
    xq, xp = decode(p, zq), decode(p, zp)
    beta, alpha = cfg["beta"], cfg["alpha"]
    loss_q = recon(x, xq, mask) + beta * kl_std(mq, lq)
    loss_p = recon(x, xp, mask_p) + beta * kl_std(mp, lp)
    re_extra = recon(x, xq, mask * (1.0 - mask_p))
    loss = loss_q + alpha * (kl_pair(mq, lq, mp, lp) - loss_q + loss_p
                             + re_extra)
    return loss / B


class Adam:
    """Adam (Kingma and Ba), lr 1e-3, betas (0.9, 0.999), eps 1e-8."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params, grads):
        self.t += 1
        out = {}
        for k, w in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            out[k] = w - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return out


def train_steps(p0, cfg, batches):
    """Follow training from parameters `p0` over `batches` [(x, mask,
    u_maskp, eps)]: returns (losses, first gradients {leaf: tensor},
    parameters after the last step)."""
    params = {k: v.detach().clone() for k, v in p0.items()}
    opt = Adam(params)
    losses, first = [], None
    for x, mask, u, eps in batches:
        leaves = {k: v.detach().requires_grad_(True) for k, v in
                  params.items()}
        loss = train_loss(leaves, cfg, x, mask, u, eps)
        keys = list(leaves)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [leaves[k] for k in keys])))
        if first is None:
            first = {k: g.detach() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            params = opt.step(params, grads)
    return losses, first, params


@torch.no_grad()
def eval_rows(p, cfg, x, mask, eps):
    """Per-row evaluation of q: {x_mean, loss, negl, negl_imp}, rows in
    blocks of BLOCK_ROWS."""
    outs = []
    for s in range(0, x.shape[0], BLOCK_ROWS):
        xb, mb, eb = (t[s:s + BLOCK_ROWS] for t in (x, mask, eps))
        mean, logvar = encode(p, xb, mb)
        xm = decode(p, mean + eb * torch.exp(0.5 * logvar))
        negl = recon(xb, xm, mb, dim=-1)
        outs.append({"x_mean": xm,
                     "loss": negl + cfg["beta"] * kl_std(mean, logvar,
                                                         dim=-1),
                     "negl": negl,
                     "negl_imp": recon(xb, xm, 1.0 - mb, dim=-1)})
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


@torch.no_grad()
def serve(p, cfg, x, mask, eps):
    """An imputation request: (filled [n, D], score [n]): the observed
    cells kept, the missing ones the decoder's mean, the score the row's
    negative evidence bound."""
    r = eval_rows(p, cfg, x, mask, eps)
    return x * mask + r["x_mean"] * (1.0 - mask), r["loss"]


@torch.no_grad()
def evaluate_split(p, cfg, x, mask, perm, eps, batch):
    """One split at one Monte-Carlo rep: (statistics [batches, 4] (rmse,
    loss, negl, negl_imp of each batch), the imputations [batches * batch,
    D]): rows in the order `perm` (wrap-padded to whole batches), batches
    of `batch` rows; a batch's RMSE over the missing cells of its real
    rows, its means over its real rows. The split's metrics are the mean
    over the batches."""
    n = x.shape[0]
    steps = -(-n // batch)
    order = torch.cat([perm, perm[:steps * batch - n]])
    r = eval_rows(p, cfg, x[order], mask[order], eps)
    w = (torch.arange(steps * batch, device=x.device) < n).float()
    hole = (1.0 - mask[order]) * w[:, None]
    se = torch.square((r["x_mean"] - x[order]) * hole).sum(-1)
    per = lambda t: t.reshape(steps, batch).sum(-1)  # noqa: E731
    cnt = per(w)
    rmse = torch.sqrt(per(se) / torch.clamp(per(hole.sum(-1)), min=1.0))
    stats = [rmse] + [per(r[k] * w) / cnt for k in ("loss", "negl",
                                                     "negl_imp")]
    return torch.stack(stats, dim=1), r["x_mean"]


def _chaini_kl(m0, l0, m1, l1):
    """The reference's reward 'KL' between the posterior before and after
    a reveal, its quirk kept: the squared mean difference over the std."""
    return 0.5 * (torch.square(m1 - m0) / torch.exp(l0 / 2.0)
                  + torch.exp(l1) / torch.exp(l0) - 1.0 - l1 + l0).sum(-1)


@torch.no_grad()
def impute_samples(p, cfg, x, mask, eps):
    """[M, n, D] decoder means of M posterior samples, eps [M, n, L]."""
    M, n = eps.shape[:2]
    r = eval_rows(p, cfg, x.repeat(M, 1), mask.repeat(M, 1),
                  eps.reshape(M * n, -1))
    return r["x_mean"].reshape(M, n, -1)


@torch.no_grad()
def al_rewards(p, cfg, x, mask, im):
    """R [n, D-1]: each still-hidden candidate's information reward, the
    sample mean over the M imputations `im` [M, n, D] of KL(post(x_o, x_u)
    || post(x_o)) - KL(post(x_o, x_u, x_t) || post(x_o, x_t)), x_t the
    target (last feature); revealed candidates -1e4."""
    M, n, D = im.shape
    last = torch.zeros(D, device=x.device)
    last[-1] = 1.0
    m0, l0 = encode(p, x, mask)  # [n, L]
    # the M samples side by side on the row axis: [M * n, D]
    xs, ims = x.repeat(M, 1), im.reshape(M * n, D)
    masks = mask.repeat(M, 1)
    mask_t = torch.maximum(masks, last)
    xt = xs * (1 - last) + ims * last
    mt, lt = encode(p, xt, mask_t)
    R = torch.zeros(n, D - 1, device=x.device)
    for u in range(D - 1):
        onehot = torch.zeros(D, device=x.device)
        onehot[u] = 1.0
        xu = xs * (1 - onehot) + ims * onehot
        mu, lu = encode(p, xu, torch.maximum(masks, onehot))
        xtu = xu * (1 - last) + ims * last
        mtu, ltu = encode(p, xtu, torch.maximum(mask_t, onehot))
        gain = (_chaini_kl(m0.repeat(M, 1), l0.repeat(M, 1), mu, lu)
                - _chaini_kl(mt, lt, mtu, ltu))
        R[:, u] = gain.reshape(M, n).sum(0) / M
    return torch.where(mask[:, :D - 1] == 0, R, torch.full_like(R, -1e4))


@torch.no_grad()
def al_mse(p, cfg, x, mask, eps):
    """The target's predictive MSE over M imputations and the rows."""
    im = impute_samples(p, cfg, x, mask, eps)
    return torch.square(im[:, :, -1] - x[None, :, -1]).mean()
