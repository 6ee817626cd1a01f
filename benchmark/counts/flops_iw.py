"""Model FLOPs of the importance-weighted evaluator (MIWAE,
`eval_vae` at valid_k samples a row), from the configuration's widths:
the dense layers' products (2 * fan_in * fan_out) of the encoder once a
row and of the Student-t decoder once a sample, and the imputation's
weighted sum over the samples (2 D a sample). Elementwise work (the
reparameterisation, the densities, the logsumexp and softmax over K) is
not counted. A call scores both splits, each wrap-padded to whole batches
of min(batch_size, rows) rows, M times."""

from __future__ import annotations


def _dense(sizes):
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def encoder_row(cfg):
    D, L = cfg["obs_dim"], cfg["latent_dim"]
    return _dense([D, *cfg["encoder_trunk"], 2 * L])


def decoder_sample(cfg):
    """One sample through the decoder (location, scale and degrees of
    freedom of each feature: 3 D outputs) and its share of the
    imputation."""
    D, L = cfg["obs_dim"], cfg["latent_dim"]
    return _dense([L, *cfg["decoder"], 3 * D]) + 2 * D


def padded_rows(cfg):
    """Rows one `eval_vae` call scores: each split wrap-padded to whole
    batches, times M."""
    out = 0
    for n in (cfg["rows_train"], cfg["rows_test"]):
        b = min(cfg["batch_size"], n)
        out += -(-n // b) * b
    return out * cfg["M"]


def eval_call(cfg):
    """FLOPs of one `eval_vae` call at cfg["valid_k"] samples a row."""
    rows = padded_rows(cfg)
    return rows * (encoder_row(cfg) + cfg["valid_k"] * decoder_sample(cfg))
