"""End-to-end examples of the port (`python -m
vae_posterior_consistency_tpu_torch.examples.<name>`)."""
