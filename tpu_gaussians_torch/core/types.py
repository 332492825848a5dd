"""Core data types: Gaussians, Camera, RenderConfig, validation.

PyTorch counterpart of `tpu_gaussians.core.types`, with the same fields,
defaults and validation contract (reference: include/gr/gaussian_types.h
`GaussiansHost`/`RenderParams`, python/torch_renderer.py `Camera`).

  * `Gaussians` and `Camera` are plain dataclasses of tensors; every tensor
    of one instance lives on one device.
  * A fixed-capacity `alive` mask replaces dynamic N, as in the JAX package,
    so that models move between the two packages unchanged.
  * Entry points take an explicit `device`. "cuda" is the default; asking
    for it with no card present raises (`resolve_device`), it never falls
    back to the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent.

    On CUDA it also pins float32 matmuls and convolutions to full precision
    (TF32 off for both; cuDNN convolutions default to TF32): the
    projection, the plain renderers' feature contractions and the SSIM
    filter must stay true f32 for parity with the JAX package's "highest"
    precision.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available()"
                " is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {str(device)!r}")
    return dev


def to_device(array, device: Device) -> torch.Tensor:
    """A C-contiguous float32 copy of a host array-like on `device`. A CUDA
    upload goes through pinned memory and is queued without waiting for
    the device, so per-frame uploads do not stall the work queued before
    them."""
    dev = resolve_device(device)
    host = torch.from_numpy(np.array(array, dtype=np.float32, order="C"))
    if dev.type == "cuda":
        host = host.pin_memory()
    return host.to(dev, non_blocking=True)


@dataclass(frozen=True)
class Camera:
    """A pinhole camera as row-major 4x4 view and projection matrices.

    `view` maps object space to camera space (camera looks down -z), `proj`
    is an OpenGL-style perspective matrix. Both float32 (4,4); may carry a
    leading batch dimension (V,4,4) for multi-view batches.
    """

    view: torch.Tensor
    proj: torch.Tensor

    def __getitem__(self, idx) -> "Camera":
        return Camera(view=self.view[idx], proj=self.proj[idx])

    @property
    def batched(self) -> bool:
        return self.view.ndim == 3

    def num_views(self) -> int:
        return self.view.shape[0] if self.batched else 1


@dataclass(frozen=True)
class Gaussians:
    """Activated (render-ready) Gaussian set at fixed capacity C.

    Fields (all float32 tensors on one device):
      means:     (C, 3) world-space centers
      scales:    (C, 3) world-space axis scales (z unused by the axis
                 footprint, kept for schema parity)
      opacities: (C,)   in [0, 1]
      colors:    (C, 3) RGB in [0, 1], or None when `sh` is set
      sh:        (C, K, 3) SH coefficients, or None. K=4: reference
                 degree-1 convention; K=9/16: 3DGS real SH degree 2/3
      alive:     (C,) float32 {0,1} mask; None means all alive
      quats:     (C, 4) wxyz unit quaternions for the EWA footprint, or None

    Exactly one of `colors` / `sh` is set.
    """

    means: torch.Tensor
    scales: torch.Tensor
    opacities: torch.Tensor
    colors: Optional[torch.Tensor] = None
    sh: Optional[torch.Tensor] = None
    alive: Optional[torch.Tensor] = None
    quats: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def use_sh(self) -> bool:
        return self.sh is not None

    @property
    def device(self) -> torch.device:
        return self.means.device

    def alive_mask(self) -> torch.Tensor:
        if self.alive is None:
            return torch.ones((self.capacity,), dtype=torch.float32,
                              device=self.device)
        return self.alive.to(torch.float32)

    def num_alive(self) -> torch.Tensor:
        return self.alive_mask().sum().to(torch.int32)

    def replace(self, **kw) -> "Gaussians":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration; the fields and defaults of
    `tpu_gaussians.core.types.RenderConfig`.

    mode:
      "accum"  — order-independent weighted-average compositing (the
                 training path)
      "sorted" — global depth sort + front-to-back alpha compositing
    impl:
      "auto"   — "tiled"
      "torch"  — whole-frame plain renderer (ops/plain_renderer.py), the
                 counterpart of the JAX package's "jnp"
      "tiled"  — tile binner + per-tile compositing kernel, the
                 counterpart of "pallas"
    The sorted_* knobs act on the tiled path only (see ops/sorted.py).
    accum_binned picks the accumulation kernels of the tiled path: "auto"
    bins EWA at n >= ops.binned.BINNED_MIN_N, "on" always (the axis
    footprint through the separable binned kernels K7), "off" never.
    accum_tile_capacity (0 = auto) and accum_cull ("exact": the W_CULL
    extent; "alpha": the 1e-5 extent) act on the binned path only.
    """

    width: int = 800
    height: int = 600
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    mode: str = "accum"
    impl: str = "auto"
    footprint: str = "axis"   # "axis" (reference parity) | "ewa"
    chunk_size: int = 256     # gaussian block size of the plain renderer
    return_aux: bool = False  # also return (alpha, depth)
    sorted_band_capacity: int = 0  # per-tile list capacity (0 = auto)
    sorted_exit_t: float = 0.0     # whole-tile early-exit threshold
                                   # (0 = default 1e-6)
    sorted_pair_k: int = 0         # per-gaussian tile budget (0 = auto)
    accum_binned: str = "auto"
    accum_tile_capacity: int = 0
    accum_cull: str = "exact"
    proj_height: int = 0  # full-frame height when rendering a row window

    def __post_init__(self):
        if self.mode not in ("accum", "sorted"):
            raise ValueError(f"mode must be 'accum' or 'sorted', got {self.mode!r}")
        if self.impl not in ("auto", "torch", "tiled"):
            raise ValueError(f"impl must be auto/torch/tiled, got {self.impl!r}")
        if self.footprint not in ("axis", "ewa"):
            raise ValueError(f"footprint must be axis/ewa, got {self.footprint!r}")
        if self.accum_binned not in ("auto", "on", "off"):
            raise ValueError(
                f"accum_binned must be auto/on/off, got {self.accum_binned!r}")
        if self.accum_cull not in ("exact", "alpha"):
            raise ValueError(
                f"accum_cull must be exact/alpha, got {self.accum_cull!r}")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("width/height must be positive")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def background_tensor(self, device: Device) -> torch.Tensor:
        return to_device(self.background, device)

    def full_height(self) -> int:
        """Height of the frame the camera projects to (== height except
        when rendering a row window of a taller frame)."""
        return self.proj_height if self.proj_height > 0 else self.height


def resolve_footprint(footprint: str, g: Gaussians) -> str:
    """The footprint a model is drawn with (cli.eval, cli.render and
    cli.serve): "auto" is "ewa" when the model carries quaternions (as
    `cli.fit --footprint ewa` and 3DGS PLYs export it), else "axis";
    "ewa" without quaternions raises."""
    if footprint == "auto":
        return "ewa" if g.quats is not None else "axis"
    if footprint not in ("axis", "ewa"):
        raise ValueError(f"footprint must be auto/axis/ewa, got {footprint!r}")
    if footprint == "ewa" and g.quats is None:
        raise ValueError("footprint 'ewa' needs a model with quaternions")
    return footprint


def _check_f32(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")


def validate_gaussians(g: Gaussians) -> None:
    """Shape/dtype/device contract of the reference bindings plus the SH
    variant, as in the JAX package."""
    if g.means.ndim != 2 or g.means.shape[1] != 3:
        raise ValueError(f"means must be (N,3), got {tuple(g.means.shape)}")
    n = g.means.shape[0]
    if tuple(g.scales.shape) != (n, 3):
        raise ValueError(f"scales must be ({n},3), got {tuple(g.scales.shape)}")
    if tuple(g.opacities.shape) != (n,):
        raise ValueError(
            f"opacities must be ({n},), got {tuple(g.opacities.shape)}")
    if (g.colors is None) == (g.sh is None):
        raise ValueError("exactly one of colors / sh must be set")
    if g.colors is not None and tuple(g.colors.shape) != (n, 3):
        raise ValueError(f"colors must be ({n},3), got {tuple(g.colors.shape)}")
    if g.sh is not None and (
            g.sh.ndim != 3 or g.sh.shape[0] != n
            or g.sh.shape[1] not in (4, 9, 16) or g.sh.shape[2] != 3):
        raise ValueError(
            f"sh must be ({n},{{4|9|16}},3), got {tuple(g.sh.shape)}")
    if g.alive is not None and tuple(g.alive.shape) != (n,):
        raise ValueError(f"alive must be ({n},), got {tuple(g.alive.shape)}")
    if g.quats is not None and tuple(g.quats.shape) != (n, 4):
        raise ValueError(f"quats must be ({n},4), got {tuple(g.quats.shape)}")
    for name in ("means", "scales", "opacities"):
        _check_f32(name, getattr(g, name))
    for f in dataclasses.fields(g):
        t = getattr(g, f.name)
        if t is not None and t.device != g.means.device:
            raise ValueError(
                f"{f.name} is on {t.device}, means on {g.means.device}")


def validate_camera(c: Camera) -> None:
    if tuple(c.view.shape[-2:]) != (4, 4) or tuple(c.proj.shape[-2:]) != (4, 4):
        raise ValueError(
            f"view/proj must be (...,4,4), got {tuple(c.view.shape)}/"
            f"{tuple(c.proj.shape)}")
    if c.view.shape != c.proj.shape:
        raise ValueError("view and proj must have matching batch shape")


def make_gaussians(
    means,
    scales,
    opacities,
    colors=None,
    sh=None,
    alive=None,
    quats=None,
    validate: bool = True,
    device: Device = "cuda",
) -> Gaussians:
    """Construct Gaussians from array-likes, coercing to float32 on
    `device`."""
    dev = resolve_device(device)

    def f32(x):
        return to_device(x, dev)

    g = Gaussians(
        means=f32(means),
        scales=f32(scales),
        opacities=f32(opacities).reshape(-1),
        colors=None if colors is None else f32(colors),
        sh=None if sh is None else f32(sh),
        alive=None if alive is None else f32(alive),
        quats=None if quats is None else f32(quats),
    )
    if validate:
        validate_gaussians(g)
    return g


def gaussians_from_numpy(arrays: Mapping[str, np.ndarray],
                         device: Device = "cuda") -> Gaussians:
    """The fields of a JAX-package `Gaussians`, given as numpy arrays keyed
    by field name (None or absent for unset optional fields), as this
    package's `Gaussians` on `device`. Carries one scene into both
    packages bit for bit."""
    fields = [f.name for f in dataclasses.fields(Gaussians)]
    unknown = set(arrays) - set(fields)
    if unknown:
        raise KeyError(f"unknown Gaussians fields {sorted(unknown)}")
    return make_gaussians(**{k: arrays.get(k) for k in fields},
                          device=device)
