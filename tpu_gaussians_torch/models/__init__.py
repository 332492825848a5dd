from tpu_gaussians_torch.models.gaussian_model import (
    RawParams, activate, init_params)

__all__ = ["RawParams", "activate", "init_params"]
