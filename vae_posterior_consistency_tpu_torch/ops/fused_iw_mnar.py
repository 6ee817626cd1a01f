"""IW2, notMIWAE's importance-weighted evaluation step in one call: the CUDA
kernel's wrapper, its plain version and the autograd Function that carries
its vmap rule.

For rows x, mask [B, D], the noise eps [B, K, L] and the model's parameters
(`models/notmiwae.init`: the encoder's trunk D-128-128 and its mean and
log-variance heads, the decoder's trunk L-128-128 and its mean and
log-variance heads, the missingness model's W, b [1, 1, D]) under the
self-masking-known missingness process, the encoder gives every row its
mean and logvar [B, L]; every sample (b, k) gets z = mean_b +
exp(0.5 logvar_b) eps_bk, the decoder's x_mean and x_logvar, RE (minus the
masked Gaussian log-density of x_b), log q - log p of z, the Bernoulli
log-pmf of the mask under the self-masking logits of the mixed row, and
l_w = RE + KL - log p(s|x). Then each row is reduced over its K samples.
Returned, as `models/notmiwae.eval_step` computes them:

- x_imputed [B, D]: sum_k softmax_k(-l_w) x_mean_k;
- per_row [2, B]: logsumexp_k(l_w) - log K (PARITY.md deviation 3; under
  cfg.fixed_iwae_bound -(logsumexp_k(-l_w) - log K)), then mean_k RE;
- mean, logvar [B, L]: the encoder's.

With a leading replica axis R on every input (an ensemble's replicas, each
with its own parameters) the outputs are [R, B, D], [R, 2, B] and [R, B, L].

The kernel is IW2 of `csrc/iw_decode.cu`, IW1's skeleton under notMIWAE's
policy; it replaces no TPU kernel (the JAX package computes notMIWAE in
plain jnp). One call launches the encoder and then the body, which keeps the
decoder's [B*K, 128] activations, the per-feature terms and the [B, K]
weights out of device memory and reduces over K in its epilogue; both
`not_miwae_type`s ('changed': ELU, a sigmoid mean, a hardtanh log-variance;
'author': tanh, a linear mean, a softplus std) are compiled.

`iw_mnar` takes the plain version for CPU tensors only: the model's own
eager composition (`models/notmiwae._eager_rows`: `forward`, `_branch` and
the reductions over K) to the bit, run with `utils/tracing` muted, so it
records no span or counter inside the caller's, as the kernel records none.
For CUDA tensors it launches the kernel or raises; there is no switch back
to the plain version. It has no backward: call it without gradients. Under
`torch.func.vmap` `IwMnarFused.vmap` folds the vmapped axis into the
replica axis, so a vmapped call is one call. Calls count in
`ops/_kernel.launches` (`iw_mnar`), one a call: its two device operations
are the encoder's and the body's.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vae_posterior_consistency_tpu_torch.ops import _kernel, fused_iw
from vae_posterior_consistency_tpu_torch.utils import tracing

#: the networks' heads, in the kernel's order: the encoder's mean and
#: log-variance, the decoder's
ENCODER_HEADS = ("q_mu", "q_logstd")
DECODER_HEADS = ("x_mean", "x_logvar")
#: a slot's floats before its D weighted means: the two families' maxima
#: and weight sums, the sum of RE (`NotMiwae::kHead` of the source)
SLOT_HEAD = 5

_TRUNK = ("w1", "b1", "w2", "b2")
_HEADS = ("mw", "mb", "vw", "vb")
_LEAVES = (*(f"e{n}" for n in _TRUNK + _HEADS), *_TRUNK,
           *(f"x{n}" for n in _HEADS), "W", "Wb")


def _net_leaves(net, heads) -> tuple:
    trunk = net["trunk"]
    return (*(trunk[f"layer{i}"][k] for i in range(2) for k in "wb"),
            *(net[h]["layer0"][k] for h in heads for k in "wb"))


def leaves_of(params) -> tuple:
    """The parameters' 18 leaves in the kernel's order: the encoder's
    trunk and heads, the decoder's, then W and b."""
    return (*_net_leaves(params["encoder"], ENCODER_HEADS),
            *_net_leaves(params["decoder"], DECODER_HEADS),
            params["W"], params["b"])


def _net(leaves, heads):
    layer = lambda w, b: {"w": w, "b": b}  # noqa: E731
    return {"trunk": {"layer0": layer(*leaves[0:2]),
                      "layer1": layer(*leaves[2:4])},
            heads[0]: {"layer0": layer(*leaves[4:6])},
            heads[1]: {"layer0": layer(*leaves[6:8])}}


def params_of(leaves) -> dict:
    """`leaves_of`'s inverse: the parameters `models/notmiwae` reads."""
    return {"encoder": _net(leaves[:8], ENCODER_HEADS),
            "decoder": _net(leaves[8:16], DECODER_HEADS),
            "W": leaves[16], "b": leaves[17]}


def iw_mnar_reference(x, mask, eps, cfg, *leaves):
    """The plain version for one run: `models/notmiwae._eager_rows` on the
    parameters of `leaves`, its spans and counters muted, reduced to IW2's
    outputs."""
    # the model imports this module, so it is imported here, at the call
    from vae_posterior_consistency_tpu_torch.models import notmiwae

    with tracing.muted():
        x_imputed, row_loss, row_negl, mean, logvar = notmiwae._eager_rows(
            params_of(leaves), x, mask, eps, cfg)
    return x_imputed, torch.stack([row_loss, row_negl]), mean, logvar


class _Pointers(ctypes.Structure):
    """`MnarPointers` of csrc/iw_decode.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "mask", "eps", *_LEAVES, "x_imputed", "per_row", "mean",
        "logvar", "work")]


class _Strides(ctypes.Structure):
    """`MnarStrides`: row strides (ld_), then replica strides (rs_)."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "ld_x", "ld_mask", "rs_x", "rs_mask", "rs_eps",
        *(f"rs_{n}" for n in _LEAVES))]


class _Dims(ctypes.Structure):
    """`MnarDims`."""
    _fields_ = [*((n, ctypes.c_int) for n in ("R", "B", "K", "D", "L",
                                              "blocks", "parts", "author",
                                              "fixed")),
                ("log_k", ctypes.c_float), ("work_floats", ctypes.c_longlong)]


_launch = _kernel.entry(
    "iw_decode", "vpc_iw_mnar",
    [ctypes.POINTER(_Pointers), ctypes.POINTER(_Strides),
     ctypes.POINTER(_Dims)], "iw_mnar", iw_mnar_reference)


def _work_floats(R, B, D, L, blocks, parts) -> int:
    """The kernel's workspace in floats (`work_floats` of the source): a
    replica's slots and scratch, then its exp(0.5 logvar) and exp(-logvar)
    [B, L] and -softplus(W) [D]; then a ticket a replica."""
    return R * (fused_iw.slot_scratch_floats(B, D, blocks, parts, SLOT_HEAD)
                + 2 * B * L + D) + R


def _shapes(x, mask, eps, leaves):
    """The kernel's contract; returns (lead, B, K, D, L), lead 1 for inputs
    with a replica axis."""
    _kernel.check_inputs("iw_mnar", (x, mask, eps, *leaves))
    lead = x.dim() - 2
    R = tuple(x.shape[:lead])
    B, D = x.shape[lead:] if lead in (0, 1) else (0, 0)
    K, L = eps.shape[-2:]
    H = fused_iw.HIDDEN
    net = lambda i, o: {"w1": (i, H), "b1": (H,), "w2": (H, H),  # noqa: E731
                        "b2": (H,), "mw": (H, o), "mb": (o,), "vw": (H, o),
                        "vb": (o,)}
    want = {"x": (B, D), "mask": (B, D), "eps": (B, K, L),
            **{f"encoder {k}": v for k, v in net(D, L).items()},
            **{f"decoder {k}": v for k, v in net(L, D).items()},
            "W": (1, 1, D), "b": (1, 1, D)}
    got = {k: tuple(t.shape) for k, t in zip(want, (x, mask, eps, *leaves))}
    bad = {k: shape for k, shape in got.items()
           if shape != (*R, *want[k])}
    if lead not in (0, 1) or bad or min(B, D, K, L, *R) < 1:
        raise ValueError(f"iw_mnar: want {want} (each with one leading "
                         f"replica axis, or none), got {bad or got}")
    if (L > fused_iw.MAX_LATENT or (R and R[0] > fused_iw.MAX_REPLICAS)
            or B * K * max(D, L, 5) >= 2**31):
        raise ValueError(f"iw_mnar: the kernel takes a latent width of at "
                         f"most {fused_iw.MAX_LATENT}, at most "
                         f"{fused_iw.MAX_REPLICAS} replicas and B*K*max(D, "
                         f"L, 5) below 2^31 (its indices are ints), got "
                         f"L={L}, R={R}, B={B}, K={K}, D={D}")
    return lead, B, K, D, L


def iw_mnar_kernel(x, mask, eps, cfg, *leaves):
    """One call on the card for one run or R replicas, two device
    operations (the encoder, the body): (x_imputed, per_row, mean, logvar),
    shaped as the module says."""
    lead, B, K, D, L = _shapes(x, mask, eps, leaves)
    rows = [_kernel.columns(t) for t in (x, mask)]
    rest = [_kernel.replica_slices(t, lead) for t in (eps, *leaves)]
    R = x.shape[:lead]
    n = R[0] if lead else 1
    dev = x.device
    blocks, parts = fused_iw.grid(B, K, n, dev)
    work_floats = _work_floats(n, B, D, L, blocks, parts)
    outs = [torch.empty(shape, device=dev, dtype=torch.float32)
            for shape in ((*R, B, D), (*R, 2, B), (*R, B, L), (*R, B, L),
                          (work_floats,))]

    def replicas(t):  # the replica stride, 0 for one run
        return t.stride(0) if lead else 0

    ptrs = _Pointers(*(t.data_ptr() for t in (*rows, *rest, *outs)))
    strides = _Strides(*(t.stride(-2) for t in rows),
                       *map(replicas, rows), *map(replicas, rest))
    dims = _Dims(n, B, K, D, L, blocks, parts,
                 int(cfg.not_miwae_type == "author"),
                 int(bool(cfg.fixed_iwae_bound)), math.log(K), work_floats)
    _launch(dev, ctypes.byref(ptrs), ctypes.byref(strides),
            ctypes.byref(dims))
    return tuple(outs[:4])


class IwMnarFused(torch.autograd.Function):
    """IW2 on CUDA tensors, the plain version on CPU tensors (one replica
    at a time where there is a replica axis); its outputs take no gradient
    and it has no backward. The vmap rule makes a vmapped call one call of
    this Function with the vmapped axis folded into the replica axis:
    inputs that are not vmapped (the rows and the noise an ensemble's
    replicas share) are expanded without a copy."""

    @staticmethod
    def forward(x, mask, eps, cfg, *leaves):
        if not _kernel.on_cpu(x, mask, eps, *leaves):
            return iw_mnar_kernel(x, mask, eps, cfg, *leaves)
        if x.dim() == 2:
            return iw_mnar_reference(x, mask, eps, cfg, *leaves)
        outs = [iw_mnar_reference(x[r], mask[r], eps[r], cfg,
                                  *(t[r] for t in leaves))
                for r in range(x.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def vmap(info, in_dims, x, mask, eps, cfg, *leaves):
        V = info.batch_size
        lead = _kernel.logical_dim(x, in_dims[0]) - 2  # x [B, D]: 0
        folded = [_kernel.fold_replicas(t, d, V, lead)
                  for t, d in zip((x, mask, eps, *leaves),
                                  (*in_dims[:3], *in_dims[4:]))]
        outs = IwMnarFused.apply(*folded[:3], cfg, *folded[3:])
        return (tuple(_kernel.unfold_replicas(t, V, lead) for t in outs),
                (0,) * len(outs))


def iw_mnar(x, mask, eps, params, cfg):
    """(x_imputed [B, D], per_row [2, B], mean [B, L], logvar [B, L]) in
    one call, as the module says; `params` the model's (`encoder`,
    `decoder`, `W`, `b`), `cfg` a RunConfig whose `not_miwae_type` and
    `fixed_iwae_bound` are read. Not differentiable: raises where gradients
    are enabled and an input requires one.

    CPU tensors: the plain version. CUDA tensors: the kernel, each call
    counted (`ops/_kernel.launches`)."""
    leaves = leaves_of(params)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, mask, eps, *leaves)):
        raise RuntimeError("iw_mnar has no backward: call it under "
                           "torch.no_grad()")
    return IwMnarFused.apply(x, mask, eps, cfg, *leaves)
