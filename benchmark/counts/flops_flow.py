"""Model FLOPs of the flow-posterior VAE's evaluation (`eval_vae`), from
the configuration's widths: the dense layers' products (2 * fan_in *
fan_out) of the context encoder (2 D -> encoder_trunk -> L * L) and of the
decoder's trunk and mean head (L -> decoder -> D), once a wrap-padded row
a rep. The spline flow (softmax, cumsum, bin search, gathers, log-dets),
the densities and the statistics are elementwise and not counted; nor is
the decoder's logvar head, which the program does not compute. A call
scores both splits, each wrap-padded to whole batches of min(batch_size,
rows) rows, M times."""

from __future__ import annotations

from counts.flops_iw import padded_rows


def _dense(sizes):
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def encoder_row(cfg):
    D, L = cfg["obs_dim"], cfg["latent_dim"]
    return _dense([2 * D, *cfg["encoder_trunk"], L * L])


def decoder_row(cfg):
    return _dense([cfg["latent_dim"], *cfg["decoder"], cfg["obs_dim"]])


def eval_call(cfg):
    """FLOPs of one `eval_vae` call at cfg["M"] reps."""
    return padded_rows(cfg) * (encoder_row(cfg) + decoder_row(cfg))
