"""The port's command-line entry points (`python -m
vae_posterior_consistency_tpu_torch.experiment_main.<name>`)."""
