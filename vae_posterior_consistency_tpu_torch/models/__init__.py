from vae_posterior_consistency_tpu_torch.models.registry import (  # noqa: F401
    ModelDef,
    get_model,
)
