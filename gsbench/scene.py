"""Inputs made from the seed: scenes, camera paths and fit targets.

Scenes are `bench/trace_viewer.py`'s uniform cube (means U(-1, 1), scales
U(0.005, 0.03), colours U(0, 1), opacities U(0.2, 0.9)) in the
configuration's representation: SH coefficients of its degree and basis
whose DC term gives the colour and whose higher terms are N(0,
sh_rest_std), and, for the EWA footprint, seeded N(0, 1) quaternions.
They are drawn on the device by a torch.Generator in a few large calls.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

SH_C0 = 0.28209479177387814


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def sh_rows(cfg: dict) -> int:
    return (cfg["sh_degree"] + 1) ** 2


def make_scene(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Activated gaussians {means, scales, opacities, sh (N, rows, 3), and
    quats for the EWA footprint} of configuration cfg."""
    sc = cfg["scene"]
    n = cfg["num_gaussians"]
    rows = sh_rows(cfg)
    quats = 4 if cfg["footprint"] == "ewa" else 0
    gen = generator(seed, "scene", device)
    u = torch.rand((n, 10), generator=gen, device=device)

    def span(cols, lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * cols

    means = span(u[:, 0:3], sc["means_uniform"])
    scales = span(u[:, 3:6], sc["scales_uniform"])
    colours = span(u[:, 6:9], sc["colours_uniform"])
    opacities = span(u[:, 9], sc["opacities_uniform"])
    normal = torch.randn((n, quats + (rows - 1) * 3), generator=gen,
                         device=device)
    rest = normal[:, quats:].reshape(n, rows - 1, 3) * sc["sh_rest_std"]
    # The DC row: 3DGS's 0.5 + SH_C0 c = colour; the linear basis's c =
    # colour.
    dc = (colours - 0.5) / SH_C0 if cfg["sh_basis"] == "3dgs" else colours
    g = {"means": means.contiguous(), "scales": scales.contiguous(),
         "opacities": opacities.contiguous(),
         "sh": torch.cat([dc[:, None, :], rest], 1).contiguous()}
    if quats:
        g["quats"] = (normal[:, :quats] * sc["quats_std"]).contiguous()
    return g


def orbit_path(spec: dict, seed: int, tag: str, count: int):
    """`count` (yaw, pitch, radius) camera poses as Python floats: yaw
    advances by spec["yaw_step"] from a seeded phase; pitch and radius
    cycle through spec's fixed lists, in a seeded order, so every seed
    gets the same set of poses."""
    gen = torch.Generator().manual_seed(subseed(seed, tag))
    phase = float(torch.rand((), generator=gen)) * 2.0 * math.pi
    pitches, radii = spec["pitches"], spec["radii"]
    pairs = [(p, r) for p in pitches for r in radii]
    order = torch.randperm(len(pairs), generator=gen).tolist()
    return [(phase + i * spec["yaw_step"], *pairs[order[i % len(pairs)]])
            for i in range(count)]


def smooth_fields(count: int, height: int, width: int, channels: int,
                  seed: int, tag: str, device, waves: int = 4
                  ) -> torch.Tensor:
    """(count, H, W, channels) smooth fields in [0, 1]: 0.5 plus `waves`
    seeded plane waves of at most 3 cycles a frame per channel, clipped."""
    gen = generator(seed, tag, device)
    p = torch.rand((count, channels, waves, 4), generator=gen, device=device)
    ys = torch.linspace(0.0, 1.0, height, device=device)[:, None]
    xs = torch.linspace(0.0, 1.0, width, device=device)[None, :]
    out = torch.full((count, height, width, channels), 0.5, device=device)
    for w in range(waves):
        fx = (p[..., w, 0] * 6.0 - 3.0)[..., None, None]
        fy = (p[..., w, 1] * 6.0 - 3.0)[..., None, None]
        ph = (p[..., w, 2] * 2.0 * math.pi)[..., None, None]
        amp = (p[..., w, 3] * 0.25)[..., None, None]
        wave = amp * torch.sin(2.0 * math.pi * (fx * xs + fy * ys) + ph)
        out = out + wave.permute(0, 2, 3, 1)
    return torch.clamp(out, 0.0, 1.0)
