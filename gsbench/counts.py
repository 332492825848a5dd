"""The work a call needs, counted from its inputs and the configuration's
semantics (never from the program's counters), itemised, and the least
time the chip could take for it (peaks.bound_s).

Compositing. A pair is a (gaussian, pixel) of the pixel's tile list whose
alpha reaches the 1e-5 cut, met, near first, while the pixel's
transmittance before it is above the exit threshold: the pairs exact
front-to-back compositing must evaluate (gsbench/reference/render.py
counts them). Per pair (chip_smoke.py's figures, counted from the kernels'
arithmetic):
  forward   EWA 22 f32 flops: dx, dy, the conic's exponent (11), cut and
            clamp, T a, four multiply-adds into r, g, b, z, T's update;
            the axis footprint's factorised exponent makes it 16
  backward  EWA 66: dy, exponent and alpha (11), cut and clamp, T a,
            f . g (8 multiply-adds), the prefix, the pass test, g_a and
            g_e (6), three moment sums (6), g_feat (8 multiply-adds), T's
            update; axis 60
  one exp each way.
Bytes: each listed (gaussian, tile) row of 10 floats read once; the frame's
5 floats a pixel (r, g, b, alpha, depth) written once forward; backward the
cotangent read once and a gradient row written once a listed pair.
"""

from __future__ import annotations

from dataclasses import dataclass

from gsbench import peaks

F32 = 4
FWD_FLOPS_PER_PAIR = {"ewa": 22, "axis": 16}
BWD_FLOPS_PER_PAIR = {"ewa": 66, "axis": 60}
ROW_FLOATS = 10           # px, py, conic a b c, op, r g b, z
PIXEL_FLOATS = 5          # r, g, b, alpha, depth

# The per-gaussian stage, f32 flops a gaussian and view, forward:
PROJECT_FLOPS = 70        # two 4x4 products (56), w guard and ndc (4),
                          # px, py (6), visibility and |z| (4)
FOOTPRINT_FLOPS = {
    "ewa": 250,           # quaternion norm (12), rotation (30), R S^2 R^T
                          # (45), camera point (18), Jacobian (10), V S V^T
                          # (90), J S J^T (30), clamps, det, inverse (15)
    "axis": 12,           # two sigmas and the diagonal conic
}
COLOUR_FLOPS = {
    ("3dgs", 3): 145,     # direction (12), 16 basis terms (35), 48
                          # multiply-adds (96), clamp (2)
    ("3dgs", 2): 84,      # direction (12), 9 basis terms (16), 27
                          # multiply-adds (54), clamp (2)
    ("linear", 1): 32,    # direction (12), 9 multiply-adds (18), clamp (2)
}
ACTIVATE_FLOPS = 12       # softplus of 3 scales, sigmoid of the opacity
ACTIVATE_EXPS = 4
STAGE_BWD_FACTOR = 2      # a backward costs about twice its forward

# The loss per pixel and view: resolve (3 multiply-adds and clamps), L1 of
# 3 channels and the silhouette term, forward and backward.
LOSS_FLOPS_PER_PIXEL = 30
LOSS_BYTES_PER_PIXEL = (3 + 1 + 3 + 1) * F32   # target, mask, image, alpha
# Adam per parameter float: two moment updates (5), bias corrections (2),
# sqrt, divide, the update (3); reads p, g, m, v and writes p, m, v.
ADAM_FLOPS = 12
ADAM_BYTES = 7 * F32
# Serving resolves and quantises each pixel (about 8 flops), reading 5
# floats and writing 3 bytes.
QUANTISE_FLOPS_PER_PIXEL = 8
QUANTISE_BYTES_PER_PIXEL = PIXEL_FLOATS * F32 + 3


@dataclass
class Work:
    flops: float = 0.0
    exps: float = 0.0
    nbytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.exps + other.exps,
                    self.nbytes + other.nbytes)

    def bound_s(self) -> float:
        return peaks.bound_s(self.flops, self.exps, self.nbytes)


def composite_fwd(pairs: int, listed: int, pixels: int,
                  footprint: str) -> Work:
    return Work(FWD_FLOPS_PER_PAIR[footprint] * pairs, pairs,
                (ROW_FLOATS * listed + PIXEL_FLOATS * pixels) * F32)


def composite_bwd(pairs: int, listed: int, pixels: int,
                  footprint: str) -> Work:
    return Work(BWD_FLOPS_PER_PAIR[footprint] * pairs, pairs,
                (2 * ROW_FLOATS * listed + PIXEL_FLOATS * pixels) * F32)


def stage_fwd(n: int, cfg: dict) -> Work:
    """The per-gaussian stage of one view under configuration cfg: its
    footprint, SH degree and basis, and the floats a gaussian reads."""
    flops = (PROJECT_FLOPS + FOOTPRINT_FLOPS[cfg["footprint"]]
             + COLOUR_FLOPS[(cfg["sh_basis"], cfg["sh_degree"])])
    return Work(n * flops, 0,
                n * (cfg["floats_per_gaussian"] + ROW_FLOATS) * F32)


def train_step(pairs: int, listed: int, pixels: int, views: int,
               cfg: dict) -> Work:
    """One step over `views` views of `pixels` pixels each, with the
    compositing pairs and listed rows summed over its views."""
    n, floats, fp = (cfg["num_gaussians"], cfg["floats_per_gaussian"],
                     cfg["footprint"])
    stage = stage_fwd(n, cfg)
    stage = Work(stage.flops * (1 + STAGE_BWD_FACTOR) * views,
                 0, stage.nbytes * 2 * views)
    activate = Work(n * ACTIVATE_FLOPS * 2, n * ACTIVATE_EXPS, 0)
    loss = Work(LOSS_FLOPS_PER_PIXEL * pixels * views, 0,
                LOSS_BYTES_PER_PIXEL * pixels * views)
    adam = Work(ADAM_FLOPS * floats * n, 0, ADAM_BYTES * floats * n)
    return (composite_fwd(pairs, listed, pixels * views, fp)
            + composite_bwd(pairs, listed, pixels * views, fp)
            + stage + activate + loss + adam)


def serve_frame(pairs: int, listed: int, pixels: int, cfg: dict) -> Work:
    return (composite_fwd(pairs, listed, pixels, cfg["footprint"])
            + stage_fwd(cfg["num_gaussians"], cfg)
            + Work(QUANTISE_FLOPS_PER_PIXEL * pixels, 0,
                   QUANTISE_BYTES_PER_PIXEL * pixels))
