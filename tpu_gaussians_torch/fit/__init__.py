from tpu_gaussians_torch.fit.loss import LossConfig, loss_fn
from tpu_gaussians_torch.fit.step import make_train_step
from tpu_gaussians_torch.fit.densify import DensifyConfig, densify_and_prune

__all__ = [
    "LossConfig",
    "loss_fn",
    "make_train_step",
    "DensifyConfig",
    "densify_and_prune",
]
