from tpu_gaussians_torch.ops.dispatch import render

__all__ = ["render"]
