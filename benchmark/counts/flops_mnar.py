"""Model FLOPs of not-MIWAE's MNAR evaluation (`eval_vae_mnar` at
valid_k samples a row, one `eval_step` over the whole matrix a rep), from
the configuration's widths: the dense layers' products (2 * fan_in *
fan_out) of the encoder's trunk and its two heads once a row, of the
decoder's trunk and its two heads once a sample, and the imputation's
weighted sum over the samples (2 D a sample). Elementwise work (the
reparameterisation, the densities, the missingness logits and their
log-pmf, the logsumexp and softmax over K) is not counted, as in
`flops_iw`."""

from __future__ import annotations


def _dense(sizes):
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def encoder_row(cfg):
    """The trunk D -> ... and the mu and log-variance heads, L each."""
    D, L, trunk = cfg["obs_dim"], cfg["latent_dim"], cfg["encoder_trunk"]
    return _dense([D, *trunk]) + 2 * _dense([trunk[-1], L])


def decoder_sample(cfg):
    """One sample through the trunk L -> ... and the mean and log-variance
    heads, D each, and its share of the imputation."""
    D, L, trunk = cfg["obs_dim"], cfg["latent_dim"], cfg["decoder_trunk"]
    return _dense([L, *trunk]) + 2 * _dense([trunk[-1], D]) + 2 * D


def eval_call(cfg):
    """FLOPs of one `eval_vae_mnar` call: M reps over cfg["rows"] rows at
    cfg["valid_k"] samples a row."""
    return cfg["rows"] * cfg["M"] * (encoder_row(cfg) + cfg["valid_k"]
                                     * decoder_sample(cfg))
