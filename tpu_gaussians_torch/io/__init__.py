from tpu_gaussians_torch.io.npz import load_gaussians_npz, save_gaussians_npz

__all__ = ["load_gaussians_npz", "save_gaussians_npz"]
