"""Model FLOPs of the work a window did, from the configuration's widths:
the dense layers' products (2 * fan_in * fan_out a row), the collapsed
point embedding (2 D K a row, and 2 D K K a call for its affine) and the
masked pool (2 S D K a row for S masks). A training step counts 3 times
its forward (the backward's two products a layer). Each branch is counted
as it runs (the q and p branches of a regularised step); nothing that
is recomputed is counted twice. Elementwise work is not counted."""

from __future__ import annotations


def _dense(sizes):
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def encoder_row(cfg, S=1):
    """FLOPs of one row through the EDDI encoder under S masks."""
    D, K, L = cfg["obs_dim"], cfg["K"], cfg["latent_dim"]
    return (2 * D * K + 2 * S * D * K
            + S * _dense([K, *cfg["encoder_trunk"], 2 * L]))


def encoder_call(cfg):
    """FLOPs of an encoder call that do not scale with its rows."""
    D, K = cfg["obs_dim"], cfg["K"]
    return 2 * D * K * K


def decoder_row(cfg):
    return _dense([cfg["latent_dim"], *cfg["decoder"], cfg["obs_dim"]])


def eval_rows(cfg, rows, calls=1):
    """An evaluation forward (encode, sample, decode) of `rows` rows in
    `calls` calls."""
    return (rows * (encoder_row(cfg) + decoder_row(cfg))
            + calls * encoder_call(cfg))


def encode_rows(cfg, rows, calls=1):
    return rows * encoder_row(cfg) + calls * encoder_call(cfg)


def train_steps(cfg, steps, batch):
    """Regularised training steps: both branches, forward and backward."""
    fwd = (batch * (encoder_row(cfg, S=2) + 2 * decoder_row(cfg))
           + encoder_call(cfg))
    return 3 * fwd * steps
