from tpu_gaussians_torch.core.types import Camera, Gaussians, RenderConfig

__all__ = ["Camera", "Gaussians", "RenderConfig"]
