"""Convert a reference checkpoint into the port's, or back (port of the JAX
package's `tools/convert_reference_checkpoint.py`, flag for flag).

A `state_dict` saved by the reference's training loop
(`src/experiment_main/train.py:120-131`) becomes a checkpoint in the flat-key
format both packages read, at the reference-mangled path of its config by
default, so the entry points' evaluation stages find it without training.
`--reverse` turns such a checkpoint back into a reference-named state_dict
that the reference's own classes load with strict=True. The mapping of every
family is `engine/checkpoint.convert_state_dict` / `export_state_dict`.

Usage (host work on CPU tensors: no card is touched):
  python -m vae_posterior_consistency_tpu_torch.tools.convert_reference_checkpoint \\
      --checkpoint <reference .pt> --vae_type reg_vae1 --obs_dim 13 \\
      [--data_type wine] [--out <checkpoint path>]
  python -m vae_posterior_consistency_tpu_torch.tools.convert_reference_checkpoint \\
      --reverse --checkpoint <port checkpoint> --vae_type reg_vae1 \\
      --obs_dim 13 [--out <reference .pt>]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.engine import checkpoint as ckpt
from vae_posterior_consistency_tpu_torch.models import get_model


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True,
                    help="reference torch state_dict (.pt); with --reverse, "
                         "a port checkpoint instead")
    ap.add_argument("--reverse", action="store_true",
                    help="export a port checkpoint back to a reference "
                         "torch state_dict")
    ap.add_argument("--vae_type", required=True)
    ap.add_argument("--data_type", default="wine")
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--p_missingness", type=int, default=30)
    ap.add_argument("--reg_type", default="kl_reg")
    ap.add_argument("--missing_rate", type=int, default=30)
    ap.add_argument("--obs_dim", type=int, required=True)
    # the sizes must be those the reference checkpoint was trained with
    ap.add_argument("--latent_dim", type=int, default=10)
    ap.add_argument("--K", type=int, default=10,
                    help="EDDI embedding width")
    ap.add_argument("--hid_dim", type=int, default=500,
                    help="flow trunk width")
    ap.add_argument("--not_miwae_type", default="changed",
                    choices=["changed", "author"])
    ap.add_argument("--out", default=None,
                    help="output path (default: the reference-mangled "
                         "checkpoint path; with --reverse, the checkpoint's "
                         "path + '.reference.pt')")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    cfg = RunConfig(vae_type=args.vae_type, data_type=args.data_type,
                    alpha=args.alpha, p_missingness=args.p_missingness,
                    reg_type=args.reg_type, missing_rate=args.missing_rate,
                    latent_dim=args.latent_dim, K=args.K,
                    hid_dim=args.hid_dim,
                    not_miwae_type=args.not_miwae_type)
    if args.reverse:
        template = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                       args.obs_dim, device="cpu")
        params = ckpt.load(template, args.checkpoint)
        sd = ckpt.export_state_dict(params, cfg, args.obs_dim)
        out = args.out or (args.checkpoint + ".reference.pt")
        parent = os.path.dirname(out)
        if parent:
            os.makedirs(parent, exist_ok=True)
        torch.save(sd, out)
        print(f"exported port checkpoint -> {out} "
              f"({len(sd)} reference-named torch tensors)")
        return
    sd = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    params = ckpt.flatten(ckpt.convert_state_dict(sd, cfg, args.obs_dim))
    out = args.out or ckpt.checkpoint_path(cfg)
    ckpt.save(ckpt.params_from_jax(params, "cpu"), out)
    n = sum(int(np.size(v)) for v in params.values())
    print(f"converted {len(sd)} torch tensors -> {out} ({n} parameters)")


if __name__ == "__main__":
    main()
