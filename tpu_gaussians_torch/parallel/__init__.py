from tpu_gaussians_torch.parallel.mesh import make_mesh, view_sharding, replicated
from tpu_gaussians_torch.parallel.sharded import make_sharded_train_step

__all__ = [
    "make_mesh",
    "view_sharding",
    "replicated",
    "make_sharded_train_step",
]
