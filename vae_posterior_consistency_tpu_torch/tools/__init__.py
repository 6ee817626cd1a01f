"""Small tools of the port: the reference-checkpoint converter and the MNIST
IDX converter (`python -m
vae_posterior_consistency_tpu_torch.tools.<name>`)."""
