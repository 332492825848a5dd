#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
hold each of its CUDA kernels against its plain PyTorch twin.

  python3 chip_smoke.py [--seed 0]

Run from the root of a checkout (it imports `tpu_gaussians_torch` from
beside itself and builds the kernels from `tpu_gaussians_torch/csrc/`).
Phases, each of which fails the run by raising:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc for every kernel source, all started together; nvcc's
              seconds and ptxas' register and shared-memory lines; the count
              of HMMA (tensor-core) instructions in K1's, K2's, K5's, K6's,
              K7a's, K7b's, K8a's, K8b's, K9a's and K9b's SASS (cuobjdump),
              none of which may be 0
  3. scene    a synthetic 100,000-gaussian scene from --seed, written as a
              reference-schema npz (means U(-1,1)^3, scales U(0.005,0.03),
              colors U(0,1), opacities U(0.2,0.9))
  4. serve    cli.serve's RenderService on cuda, interactive preset, behind
              its HTTP handler on 127.0.0.1: /info, then 960x540 frames as
              jpg, png and raw; the raw frame is held against the same pose
              rendered through the kernel's plain twin (<= 1 LSB on <= 0.1%
              of values)
  5. loop     cli.serve.run_loop, 50 frames (its JSON line), then the
              serving cells (100k under both presets, 1M interactive) with
              a torch.profiler breakdown each
 5b. serve ewa  a 1M-gaussian model as 3DGS trainers export it (N(0,1)
              quaternions, SH degree 3) served at 1920x1080 under the
              quality preset with the default footprint: it resolves to
              ewa, the served frame launches the stage's forward kernel
              and K3 once each and nothing else, and it is bit for bit the
              port's render(..., footprint="ewa") of the pose
  6. kernel   the compositing kernel (K3) vs its plain twin on the serving
              path's inputs (axis at 960x540; K3's EWA build on phase 5b's
              model at 1920x1080, quality preset): image and alpha within
              rtol 1e-4 / atol 1e-5,
              and within exit_t on tiles whose whole-tile early-exit
              decision differs; K3 twice, bit-identical, and the blocks
              its launch takes (a cluster of 8 a tile: the grid of its
              kernel event in a torch.profiler trace); its device time
              (torch.profiler) beside its all-pairs bound and its live
              bound (the composited pairs with a_raw >= 1e-5, the pairs
              its culling evaluates, the SM clock read while it runs);
              and a small scene through render(impl="tiled") against the
              plain renderer in both modes and both footprints (EWA accum
              through K5)
 6b. stage    the per-gaussian stage's forward and backward kernels against
              their plain twins at 100k EWA SH3, 1M axis SH1 and 1M EWA
              SH3 gaussians, 1920x1080 (stage_case): each value's error against float64
              within 4x the f32 twin's, bit-identical across two launches;
              event and device ms beside the plain twins', the plain
              composition's under autograd and the byte bound. Every fit
              phase below also counts the stage's launches exactly: once a
              rendered view forward and once a view backward (the sorted
              fits also once for each of auto_pair_k's views)
  7. fit      cli.fit.main on cuda with the flagship recipe (example scene,
              150 iterations, --use_sh, 800 gaussians, 128x128, capacity
              3000): loss.txt has 150 lines and its last loss is under half
              its first, N grows at iteration 80, the four artifacts exist,
              K1 launched exactly 901 times (6 per step and the preview),
              K2 900 and no other kernel;
              then a torch.profiler breakdown of train steps, and the band
              kernels K1 (splat_sep_fwd, twice, bit-identical) and K2
              (splat_sep_bwd, twice, bit-identical) against their twins on
              the fitted model's staged inputs; each one's device time
              (torch.profiler; K2's main kernel and its slice sum apart) and
              bound on this card (their products on the tensor cores, the SM
              clock read while each runs: the largest of the TF32 product,
              f32 elementwise, SFU exp and byte terms, the deciding one
              named) beside the 10- and 20-flop f32 ones, each one's slices
              and partial bytes, and the products alone through cuBLAS f32
              torch.bmm on factors formed beforehand (K1's one call, K2's
              two: a yardstick the port never calls)
  7b. colmap_fit  the COLMAP workflow at the flagship's width: a COLMAP
              sparse model (PINHOLE, binary and text) of the example scene's
              rig with 800 SfM points (a seeded sample of phase 7's fitted
              centres, noise 2% of their extent, their colours);
              cli.import_colmap --init_out (its cameras.npz within 1e-5 of
              the rig, the text model's outputs equal to the binary one's);
              three cli.fit runs from its init_points.npz with the flagship
              recipe and --checkpoint_every 50 (150 iterations unbroken, 50,
              then --resume to 150): the resume printed, metrics.jsonl steps
              1-150, checkpoints 50, 100 and 150, the resumed parameters
              within rtol 1e-5 / atol 1e-6 of the unbroken ones (both at
              their checkpoint 150), loss falling, N growing at 80, K1 and K2
              launched exactly 6 times a step (K1 once more, the preview)
              and no other kernel; checkpoint save and restore ms and bytes;
              cli.eval on the card and with --device cpu through the twins
              (|dPSNR| <= 0.01 dB, |dSSIM| <= 1e-4, |dL1| <= 1e-5 a view),
              its device ms (CUDA events); cli.convert to ply and back, the
              fields at tests/test_ply.py's tolerances, the ply evaluated on
              the card and rendered against the fitted model (dc clamped)
              within atol 1e-4
  8. scale    100,000 alive gaussians (the scene generator of phase 3), 4
              orbit views at 512x512 (R = 32, 16 bands), random targets from
              --seed: 10 train steps timed with CUDA events, a profile, and
              K1/K2 against their twins on those staged inputs, as in 7
  9. fit sorted  cli.fit.main with the same recipe plus --max_gaussians
              4096 --footprint ewa (render_mode auto -> sorted): the checks
              of phase 7, the pair-budget line printed, K3 (sorted_fwd) and
              K4 (sorted_bwd) launched exactly 6 times per step and K5
              (splat_v2_fwd) once, for the preview; a profile of its train
              steps;
              K5 and K6 against their twins on the fitted model (the
              preview's inputs), and K3 and K4 against theirs on its EWA
              tile lists, K3's checks, time (events and torch.profiler)
              and bounds on those lists as in 6, beside K4's
 10. scale sorted  100,000 alive EWA gaussians (phase 8's scene, seeded
              quaternions), 4 views at 512x512, sorted with the measured
              pair budget: 10 train steps timed, a profile; K3, then K4 on
              K3's outputs, against their twins on the binner's lists, for
              both footprints (K3 checked, timed and bounded there as in
              6), with the
              blocks K4's launch takes (more
              than tiles; the grid of its kernel event in a torch.profiler
              trace); sorted-render gradients against the plain renderer
              on a small scene; K5 and K6 against their twins at 8,192 EWA
              gaussians on 512x512; K3 and K4 likewise on view 0 of the
              benchmark's fit cell (100k EWA SH3 gaussians from gsbench's
              inputs at --seed, 1920x1080, pair budget by auto_pair_k).
              Every K4 case also checks its walk counter (one launch under
              a profiler: the same rows, and the counter equal to
              sorted_bwd.walk_counts on host copies of the lists) and
              gives K4's device time and its bound on the live pairs
 11. scale ewa accum  the same 100k EWA scene and views in accum mode
              (n >= 10,240 under accum_binned "auto" -> tile-binned): 10
              train steps timed, a profile; K8a (binned_fwd, twice,
              bit-identical), then K8b (binned_bwd, twice, bit-identical)
              on a seeded cotangent, against their twins on view 0's lists,
              with the binner's stats and the live slots; K8a's device time
              (torch.profiler) split between its main kernel and its slice
              sum, and its bound on this card (its product on the tensor
              cores, the SM clock read while it runs, the deciding term
              named) beside the 22-flop f32 one and the bytes of its slice
              partials; K8b's device time and bound on the same terms (its
              two products on the tensor cores) beside the 44-flop f32
              one, its pixel slices, and its ptxas register and spill
              lines
 12. binned vs dense  12,288 EWA gaussians at 512x512: render with
              accum_binned "on" (K8a) against "off" (K5), every overflow
              stat 0, image and alpha within rtol 1e-4 / atol 1e-5
 13. fit ewa accum  cli.fit.main with the recipe plus --footprint ewa
              (capacity 3000: auto -> accum, dense): the checks of phase 7,
              K5 launched exactly 901 times (6 per step and the preview), K6
              (splat_v2_bwd) 900, no other kernel; a profile of its steps;
              K5 and K6 against their twins on the fitted model, each twice
              (bit-identical), K5 with its range slices and K6 with its
              pixel slices, each one's device time (torch.profiler; its
              main kernel and slice sum apart) and bound on this card (its
              products on the tensor cores, the SM clock read while it
              runs, the deciding term named) beside the 25- and 52-flop f32
              ones, as on every K5/K6 case
 14. fit ewa binned  the recipe plus --footprint ewa --max_gaussians 16384
              --render_mode accum: the checks of phase 7, K8a launched
              exactly 901 times and K8b 900, no other kernel, no pair
              dropped in any step; a profile; K8a/K8b against their twins on
              the fit's own lists
 15. fit axis binned  the recipe plus --accum_binned on (the axis footprint
              through the separable tile-binned kernels): the checks of
              phase 7, K7a (binned_sep_fwd) launched exactly 900 times, K7b
              (binned_sep_bwd) 900 and K1 once (the preview, on JAX's
              preview config), no other kernel, no pair dropped in any step;
              a profile; K7a/K7b against their twins on the fit's own lists
 16. scale axis binned  phase 8's 100k axis scene and views under
              accum_binned "on": 10 train steps timed, a profile; K7a, then
              K7b on a seeded cotangent, against their twins on view 0's
              lists (K7a twice, bit-identical), with the binner's stats and
              the live slots; K7a's device time split between its main
              kernel and its slice sum, with the launches the trace kept,
              and its bound on this card (its product on the tensor cores,
              the SM clock read while it runs, the deciding term named)
              beside the 16-flop f32 one and the bytes of its slice
              partials, and its product alone through cuBLAS (torch.bmm,
              TF32 off, the factors formed beforehand); K7b's device time
              and its bound on the same terms (two products) beside the
              32-flop f32 one, its column slices, and its two products
              alone through cuBLAS (two torch.bmm, as K7a's); view 0
              rendered through K7a against K1, with
              nothing dropped (the tile capacity raised to n if the default
              drops pairs)
 17. scale ewa exact  1,000,000 EWA gaussians (phase 3's generator at the
              serving path's 1M size, seeded quaternions), 4 views at
              512x512, accum mode under accum_binned "off": above both of
              JAX's v2 sizes, so forward and backward take the tile grid; 3
              train steps timed and 1 profiled, K9a (splat_v1_fwd) and K9b
              (splat_v1_bwd) launched exactly 4 times per step each and no
              other kernel
 18. K9       K9a (twice, bit-identical), then K9b on a seeded cotangent,
              against their twins on view 0 at 1M (one twin call each; K5
              and K6 timed on the same view, the route the threshold does
              not take) and at 8,192 EWA gaussians on 512x512, where K9a's
              sums are also held against K5's and splat_accumulate's
              gradients through K9a/K9b against those through K5/K6; K9a's
              and K9b's bounds on this card (their products on the tensor
              cores, the SM clock read while each runs: the largest of the
              elementwise f32, TF32 product, SFU exp and byte terms, the
              deciding one named) beside the 26- and 55-flop f32 ones
 19. scale ewa mixed  500,000 EWA gaussians, the same views and config:
              between JAX's two v2 sizes, so the forward takes K5 and the
              backward K9b on a restaging of the saved columns; 1 train
              step timed and 1 profiled, K5 and K9b launched exactly 4
              times per step each and no other kernel; view 0's sums and
              gradients against both directions on the tile grid; K5's
              bound on view 0's band staging and K9b's on its restaging
              (each at the SM clock read while it runs), each beside its
              CUDA-event time there
 20. parallel  the flagship fit of phase 7 as two ranks sharing the card:
              cli.fit under `python -m torch.distributed.run --standalone
              --nproc_per_node 2` with --num_view_shards 2 (3 views a rank,
              gloo by parallel.mesh's rule): torch.distributed.run exits 0
              (it exits non-zero, naming the rank, when any rank fails) and
              each rank printed its summary line, the checks of phase 7,
              rank 0 alone wrote out_dir, the parameters bit-identical
              across ranks (sha256), each rank launched K1 and K2 exactly
              450 times (3 a step; rank 0 K1 once more, the preview) and no
              other kernel, one all-reduce a step; its wall time and steps/s
              beside phase 7's. Then chip_smoke.py --parallel_worker on two
              ranks: one step of the sharded, shardmap and overlapped (1, 2
              and 3 chunks) factories and of the rows mesh (1x2, SSIM on)
              against the single-process step on the flagship's inputs, in
              accum (K1/K2), sorted (K3/K4) and accum_binned on (K7a/K7b)
              mode, at tests/test_sharded.py's tolerances (loss rtol 1e-5 /
              atol 1e-6, leaves rtol 2e-4 / atol 2e-6), both ranks equal;
              and phase 8's 100k scene, 2 views a rank: 10 steps timed
              (CUDA events), the all-reduce's bytes and host ms a step, the
              same all-reduce alone, each rank's device busy share
              (torch.profiler). render_tiled on phase 3's scene at 960x540
              (phase 4's pose), 2 and 7 bands on the one card, sorted (K3)
              and accum (K1), against the whole frame at rtol / atol 2e-5
              with the aux outputs, timed beside it (CUDA events); cli.render
              --shard_bands 2 against cli.render (<= 1 LSB). The native CPU
              rasterizer (tpu_gaussians_torch.native, built with g++): phase
              6's small scene and the flagship's fitted model in both modes
              against the plain and the card renders within NATIVE_ATOL,
              its host ms a frame beside the CPU's name, gs_viewer for 3
              frames
 21. report   one `kernels` JSON line, the nvidia-smi line, and last
              {"ok": true, "device": {...}}

K1, K5, K7a, K8a and K9a are held to rtol 1e-5 / atol 1e-5; K2, K6, K7b,
K8b and K9b to rtol 2e-4 and atol 2e-5 times the largest magnitude of their
output column (at least 1; their moments are sums of signed terms that
cancel); K4 to rtol 2e-3 and atol 2e-4 times the largest magnitude of its
output column (the JAX suite's tolerance for the sorted backward: ctg - P_i
cancels and is divided by 1 - a); K1, K2, K3, K4, K5, K6, K7a, K7b, K8a,
K8b, K9a and K9b are bit-identical across two launches (K1, K2, K5, K6,
K7a, K7b, K8a, K8b, K9a and K9b run their products on the tensor cores, in
TF32 split three ways, and sum in a fixed order; K3 composites each pixel
in slot order and culls only pairs whose alpha is under the cutoff). K9a
against K5 and binned against dense renders: rtol 1e-4 / atol 1e-5;
gradients through K9 against K5/K6, and the mixed route's against the tile
grid's: rtol 2e-3 and atol 2e-4 times the largest magnitude. Kernel times
are CUDA-event medians of 20 after warm-up (twins: of 5; at 1M, kernels of
5 and twins of 1). The launch counters are set to 0 just before each main
path (phases 4-5 for serving, the cli.fit.main calls of phases 7, 7b, 9,
13, 14 and 15 and the train steps of phases 17 and 19 for training, 7b's
cli.eval calls and phase 20's render_tiled calls; the ranks of phase 20's
fit count their own from 0 and print them) and read just after: every
kernel of the path must have launched there. It exits non-zero, printing no result,
without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# FLOP/s outside the tensor cores. The tensor cores' dense TF32 flops and
# the SFU's exps per SM and clock, times the SMs and the SM clock nvidia-smi
# reports during the run: the data sheet's 495 TFLOP/s in TF32 is 132 SMs x
# 2048 flops at 1830 MHz, and a card that runs at 1980 MHz does 535.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_SM_CLOCK = 2048
SFU_EXP_PER_SM_CLOCK = 16
# f32 operations per (slot, pixel) the compositing evaluates: the alpha
# product and exponent terms (5 for the factorised axis form, 11 for the
# general conic, as K4's count below), cutoff and clamp, T*a, four
# multiply-adds into r, g, b, z (two each) and the transmittance update.
SORTED_FLOPS_PER_EVAL = {"axis": 16, "ewa": 22}
# f32 operations per (gaussian, band) pair and per pixel of the band: one
# multiply-add per feature plane (5) in K1; two in K2 (the gG and gEx
# products). The R + Wp exps per pair (a few percent) are not counted.
SEP_FWD_FLOPS_PER_PIXEL = 2 * 5
SEP_BWD_FLOPS_PER_PIXEL = 2 * 2 * 5
# K2's on the tensor-core terms (csrc/splat_sep_bwd.cu runs both products
# on the tensor cores, as the TPU did on its matrix unit): the products'
# SEP_BWD_FLOPS_PER_PIXEL per band pixel, and the f32 work the function
# needs per (gaussian, band) pair beside them: per band row G = featsop x Ey
# (5), g_featop and gEy from gG (5 multiply-adds each), ty, u_y, t2 and the
# Mdy and Myy sums (6); per column tx, u_x, t1 and the Mdx and Mxx sums (6).
SEP_BWD_ELEMENTWISE_FLOPS_PER_ROW = 5 + 2 * 2 * 5 + 6
SEP_BWD_ELEMENTWISE_FLOPS_PER_COLUMN = 6
# f32 operations per composited (slot, pixel) in K4's pixel loop
# (csrc/sorted_bwd.cu): dy; the exponent and alpha (11 for the general
# conic, 5 for the factorised axis form); cutoff and clamp; T*a; f.g8 (8
# multiply-adds); the prefix P; the pass test; g_a and g_e (6); three
# moment sums (6); g_feat (8 multiply-adds); T's update. The exp is not
# counted.
SORTED_BWD_FLOPS_PER_EVAL = {"ewa": 66, "axis": 60}
# f32 operations per (gaussian, pixel) pair in K5's function with every
# term paid per pair and the product on the CUDA cores: dx, dy, the Horner
# exponent (7) and 8 multiply-adds; the exp not counted. K5 runs its
# product on the tensor cores (csrc/splat_v2_fwd.cu, as the TPU did on its
# matrix unit): its bound is v2_fwd_bound's, on K9a's terms per pair (the
# same per-pair function with op folded into featsop: the product's 16
# flops, 5 elementwise, one exp), and this f32 figure is printed beside it
# (bound_ms_25flop).
V2_FWD_FLOPS_PER_PAIR = 25
# Per (gaussian, pixel) pair of K6's function with every term paid per
# pair and the products on the CUDA cores: dx, dy, the Horner exponent
# (7), g_x (8 multiply-adds), g_e, u and v, the five moment sums (8),
# g_featop (8 multiply-adds); the exp not counted. K6 runs both products on
# the tensor cores (csrc/splat_v2_bwd.cu, as the TPU did on its matrix
# unit): its bound is v2_bwd_bound's, on K9b's terms per pair (the same
# per-pair function with op folded into featsop: the products' 32 flops, 11
# elementwise, one exp), and this f32 figure is printed beside it
# (bwd_bound_ms_52flop).
V2_BWD_FLOPS_PER_PAIR = 52
# Per (slot, pixel) pair in K8a's function with its product on the CUDA
# cores: dy, the exponent (2 multiply-adds), op * exp, 8 multiply-adds; and
# in K8b's: dx, the exponent (2 multiply-adds), op * exp, g_w (8
# multiply-adds), g_e, u = g_e dx and the three row sums (5), g_feat (8
# multiply-adds). The exps are not counted. Both kernels run their products
# on the tensor cores: their bounds are binned_fwd_bound's and
# binned_bwd_bound's, these f32 figures printed beside them.
BINNED_FWD_FLOPS_PER_PAIR = 22
BINNED_BWD_FLOPS_PER_PAIR = 44
# K8a's on the tensor-core terms (csrc/binned_fwd.cu runs its 8-wide
# product on the tensor cores, as the TPU did on its matrix unit), as K9a's
# below: the product's 16 flops per pair (8 multiply-adds), and the
# elementwise work the function needs per pair with the row terms (dy,
# b dy, c dy^2) paid once per slot and row and op folded into the feature
# rows: dx (1) and e = fma(dx, fma(a, dx, b dy), c dy^2) (4). The 22-flop
# f32 bound above is printed beside it (fwd_bound_ms_22flop).
BINNED_FWD_ELEMENTWISE_FLOPS_PER_PAIR = 5
BINNED_FWD_PRODUCT_FLOPS_PER_PAIR = 16
# Per (slot, pixel) pair of K7a/K7b, counted from the function's products
# as K1/K2's are, not from the kernels' loops: acc += G2 . Ex, one
# multiply-add per feature (G2 = featsop x Ey is per slot and row); the
# backward's gG2 = gband . Ex and gEx = gband^T . G2, one each. The TPU runs
# these products on its matrix unit; on this card K7a runs its product and
# K7b its two on the tensor cores (csrc/binned_sep_{fwd,bwd}.cu), so both
# bounds are counted on
# tensor_core_bound's terms as K1's and K2's (binned_sep_fwd_bound,
# binned_sep_bwd_bound): the products' flops per pair x 3 (the TF32 split),
# one exp per tile row and per column of each slot (144), and the f32 work
# beside the products, per slot and row and per slot and column. K7a's: G2
# = featsop x Ey, 8 multiplies a row. K7b's, as K2's with 8 features: G2
# (8), g_featop and gEy from gG2 (8 multiply-adds each), ty, u_y, t2 and the
# Mdy and Myy sums (6) a row; tx, u_x, t1 and the Mdx and Mxx sums (6) a
# column. The f32 figures of the products at the CUDA-core rate are printed
# beside (fwd_bound_ms_f32, bwd_bound_ms_f32).
BINNED_SEP_FWD_FLOPS_PER_PAIR = 2 * 8
BINNED_SEP_BWD_FLOPS_PER_PAIR = 2 * 2 * 8
BINNED_SEP_FWD_ELEMENTWISE_FLOPS_PER_ROW = 8
BINNED_SEP_BWD_ELEMENTWISE_FLOPS_PER_ROW = 8 + 2 * 2 * 8 + 6
BINNED_SEP_BWD_ELEMENTWISE_FLOPS_PER_COLUMN = 6
# Per (gaussian, pixel) pair of the active (tile, block) pairs in K9a
# (csrc/splat_v1_fwd.cu): dx, dy, the Horner exponent (7), op * exp and 8
# multiply-adds; in K9b's function with every term paid per pair and the
# products on the CUDA cores: dx, dy, the exponent (7), op * exp, g_w (8
# multiply-adds), g_e, exp(e) g_w, u and v, the five moment sums (8) and
# g_feat (8 multiply-adds). The exps are not counted.
V1_FWD_FLOPS_PER_PAIR = 26
V1_BWD_FLOPS_PER_PAIR = 55
# K9b's bound for a kernel that runs the two 8-wide products on the tensor
# cores (csrc/splat_v1_bwd.cu does, as the TPU did on its matrix unit): the
# largest of the elementwise f32 flops per pair at the f32 rate, the
# products' 32 flops times 3 (the TF32 split that keeps f32 accuracy) at the
# TF32 rate, one exp per pair at the SFU rate, and the bytes. The
# elementwise work the function needs per pair, with the row-constant terms
# (dy, b dy, c dy^2) paid once per row and op factored out of every sum
# (g_e = op v; the dy moments are dy and dy^2 times per-row sums): dx (1),
# e = fma(dx, fma(a, dx, b dy), c dy^2) (4), v = exp(e) g_w (1), u = v dx
# (1), the sums of v and u (2) and of u dx (2): 11. The 55-flop f32 bound
# above prices the products at the CUDA-core rate; it is printed beside
# (bwd_bound_ms_55flop) so that runs before the tensor-core kernel stay
# comparable.
V1_BWD_PRODUCT_FLOPS_PER_PAIR = 32
V1_BWD_ELEMENTWISE_FLOPS_PER_PAIR = 11
# K9a's on the same terms (csrc/splat_v1_fwd.cu runs its 8-wide product on
# the tensor cores): the product's 16 flops per pair, and the elementwise
# work the function needs per pair with the row terms (dy, b dy, c dy^2)
# paid once per row and op folded into the feature rows: dx (1) and e =
# fma(dx, fma(a, dx, b dy), c dy^2) (4). The 26-flop f32 bound above is
# printed beside it (bound_ms_26flop).
V1_FWD_PRODUCT_FLOPS_PER_PAIR = 16
V1_FWD_ELEMENTWISE_FLOPS_PER_PAIR = 5
TF32_SPLIT = 3
# The port's kernels by their CUDA names (csrc/*.cu), for profile rows.
PORT_KERNELS = {f"{k}_kernel" for k in (
    "sorted_fwd", "sorted_bwd", "splat_sep_fwd", "splat_sep_bwd",
    "splat_v2_fwd", "splat_v2_bwd", "binned_fwd", "binned_bwd",
    "binned_sep_fwd", "binned_sep_bwd", "splat_v1_fwd", "splat_v1_bwd",
    "stage_fwd", "stage_bwd",
    "slice_sum", "segment_sum", "splat_sep_bwd_sum", "splat_v2_fwd_sum")}
FIT_ARGS = ["--targets_dir", "assets/example_scene", "--camera_npz",
            "assets/example_scene/cameras.npz", "--iters", "150", "--use_sh",
            "--num_gaussians", "800"]
SORTED_FIT_ARGS = ["--max_gaussians", "4096", "--footprint", "ewa"]
EWA_ACCUM_FIT_ARGS = ["--footprint", "ewa"]
EWA_BINNED_FIT_ARGS = ["--footprint", "ewa", "--max_gaussians", "16384",
                       "--render_mode", "accum"]
AXIS_BINNED_FIT_ARGS = ["--accum_binned", "on"]

# A torch.profiler window keeps a kernel event only if the event falls
# inside the window by the profiler's clock, and on an H100 that clock can
# be off by more than a short wait: minutes into a process, a window of ten
# launches with 0.2 s of host sleep at both ends often keeps none of them,
# where one with 2 s keeps all ten (tools/profiler_window_probe.py).
# launched_blocks, whose check needs an event, waits PROFILE_PAD_S at both
# ends; the helpers that read a kernel's launches from a trace take a window
# that kept none again, at most PROFILE_TRIES windows in all, waiting
# PROFILE_PAD_S, and say so on both output streams.
PROFILE_TRIES = 3
PROFILE_PAD_S = 2.0
PROFILE_SHORT_PAD_S = 0.2

# K3's keys beside its all-pairs bound in the kernels line.
K3_LIVE_KEYS = ("blocks", "device_launches_traced", "composited_pairs",
                "live_pairs", "evaluated_pairs", "live_bound_ms",
                "live_bound_by", "live_bound_terms_ms", "sm_clock_mhz")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*parts) -> None:
    print(*parts, flush=True)


def warn(msg: str) -> None:
    """log(msg), and the same line on standard error, whose tail a
    failed run's report keeps."""
    log(msg)
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reports now (call it while kernels run)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def tensor_core_bound(pairs: int, elementwise: int, product: int,
                      nbytes: int, sms: int, mhz: float, exps: int = 1):
    """(bound ms, deciding term, every term's ms) of a kernel that runs its
    per-pair product on the tensor cores: the largest of `elementwise` f32
    flops per pair at the f32 rate, `product` flops per pair times the
    TF32 split on the tensor cores (2048 per SM and clock), `exps` exps per
    pair on the SFU (16 per SM and clock), both at the SM clock `mhz`, and
    `nbytes` at the memory rate."""
    per_s = sms * mhz * 1e6               # SM clocks per second, all SMs
    terms = {
        "f32 elementwise": 1e3 * elementwise * pairs / F32_FLOPS_PER_S,
        "tf32 products": 1e3 * TF32_SPLIT * product * pairs
        / (TF32_FLOPS_PER_SM_CLOCK * per_s),
        "sfu exp": 1e3 * exps * pairs / (SFU_EXP_PER_SM_CLOCK * per_s),
        "bytes": 1e3 * nbytes / HBM_BYTES_PER_S}
    term = max(terms, key=terms.get)
    return terms[term], term, terms


def v1_live_pairs(mask, gdata, nb: int, tp: int, hw: int) -> int:
    """The (gaussian, pixel) pairs K9's function needs: each mask-active
    (tile, block) pair's live rows (op > 0) times the tile's pixels inside
    the frame."""
    import torch

    live = (gdata[:, 5] > 0).to(torch.int64).reshape(-1, nb).sum(dim=1)
    tile_px = torch.clamp(hw - tp * torch.arange(
        mask.shape[0], device=mask.device), 0, tp)
    return int(((mask.to(torch.int64) * live[None, :]).sum(dim=1)
                * tile_px).sum())


def v2_alive_pairs(lo, cnt, gdata, nb: int, hw: int) -> int:
    """The (gaussian, pixel) pairs K5's and K6's function needs: each
    band's live rows (op > 0) within its block range, times the band's
    pixels inside the frame."""
    import torch

    live = (gdata[:, 5] > 0).to(torch.int64).reshape(-1, nb).sum(dim=1)
    live_csum = torch.nn.functional.pad(live.cumsum(0), (1, 0))
    lo64, cnt64 = lo.to(torch.int64), cnt.to(torch.int64)
    band_px = torch.clamp(hw - 2048 * torch.arange(
        lo.shape[0], device=lo.device), 0, 2048)
    return int(((live_csum[lo64 + cnt64] - live_csum[lo64]) * band_px).sum())


def v2_fwd_bound(lo, cnt, gdata, nb: int, hw: int, hw_pad: int, sms: int,
                 mhz: float) -> dict:
    """K5's bound on this card for its alive pairs (v2_alive_pairs), for a
    kernel that runs its product on the tensor cores (csrc/splat_v2_fwd.cu
    does, as the TPU did on its matrix unit): the largest of
    tensor_core_bound's terms at the SM clock `mhz`, on K9a's per-pair
    terms (the product's 16 flops, 5 elementwise with the row terms paid
    once per row, one exp), against gdata, lo and cnt read once and the
    (8, hw_pad) sums written once. The 25-flop f32 figure beside it. The
    slice partials are K5's design, not its function, and stay out."""
    pairs = v2_alive_pairs(lo, cnt, gdata, nb, hw)
    nbytes = gdata.numel() * 4 + 2 * lo.numel() * 4 + 8 * hw_pad * 4
    ms, term, terms = tensor_core_bound(
        pairs, V1_FWD_ELEMENTWISE_FLOPS_PER_PAIR,
        V1_FWD_PRODUCT_FLOPS_PER_PAIR, nbytes, sms, mhz)
    return {"alive_pairs": pairs, "bound_ms": ms,
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_terms_ms": terms,
            "bound_ms_25flop": max(
                1e3 * V2_FWD_FLOPS_PER_PAIR * pairs / F32_FLOPS_PER_S,
                1e3 * nbytes / HBM_BYTES_PER_S),
            "sm_clock_mhz": mhz}


def v2_bwd_bound(lo, cnt, gdata, nb: int, hw: int, hw_pad: int, sms: int,
                 mhz: float) -> dict:
    """K6's bound on this card for its alive pairs (v2_alive_pairs), for a
    kernel that runs its two products on the tensor cores
    (csrc/splat_v2_bwd.cu does, as the TPU did on its matrix unit): the
    largest of tensor_core_bound's terms at the SM clock `mhz`, on K9b's
    per-pair terms (the products' 32 flops, 11 elementwise with the row
    terms paid once per row, one exp), against gdata, lo, cnt and g8 read
    once and the (n_pad, 16) rows written once. The 52-flop f32 figure
    beside it."""
    pairs = v2_alive_pairs(lo, cnt, gdata, nb, hw)
    nbytes = 2 * gdata.numel() * 4 + 2 * lo.numel() * 4 + 8 * hw_pad * 4
    ms, term, terms = tensor_core_bound(
        pairs, V1_BWD_ELEMENTWISE_FLOPS_PER_PAIR,
        V1_BWD_PRODUCT_FLOPS_PER_PAIR, nbytes, sms, mhz)
    return {"bwd_bound_ms": ms,
            "bwd_bound_by": "bytes" if term == "bytes" else "operations",
            "bwd_bound_term": term, "bwd_bound_terms_ms": terms,
            "bwd_bound_ms_52flop": max(
                1e3 * V2_BWD_FLOPS_PER_PAIR * pairs / F32_FLOPS_PER_S,
                1e3 * nbytes / HBM_BYTES_PER_S),
            "bwd_sm_clock_mhz": mhz}


def v1_bwd_bound(mask, gdata, nb: int, tp: int, hw: int, hw_pad: int,
                 sms: int, mhz: float) -> dict:
    """K9b's bound on this card for its live pairs (v1_live_pairs): the
    largest of tensor_core_bound's terms on its per-pair terms at the SM
    clock `mhz`, against gdata, the mask and g8 read once and the (n_pad,
    16) rows written once; the 55-flop f32 figure beside it."""
    pairs = v1_live_pairs(mask, gdata, nb, tp, hw)
    nbytes = 2 * gdata.numel() * 4 + mask.numel() + 8 * hw_pad * 4
    ms, term, terms = tensor_core_bound(
        pairs, V1_BWD_ELEMENTWISE_FLOPS_PER_PAIR,
        V1_BWD_PRODUCT_FLOPS_PER_PAIR, nbytes, sms, mhz)
    return {"alive_pairs": pairs, "bound_ms": ms,
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_terms_ms": terms,
            "bound_ms_55flop": max(
                1e3 * V1_BWD_FLOPS_PER_PAIR * pairs / F32_FLOPS_PER_S,
                1e3 * nbytes / HBM_BYTES_PER_S),
            "sm_clock_mhz": mhz}


def clock_while(fn, ms: float) -> float:
    """The SM clock nvidia-smi reports while launches of fn (about `ms`
    each) run queued for about 0.3 s."""
    import torch

    for _ in range(max(1, int(300 / max(ms, 1e-3)))):
        fn()
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    return mhz


def scene_arrays(n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return dict(
        means=rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.005, 0.03, (n, 3)).astype(np.float32),
        colors=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.9, (n,)).astype(np.float32))


def serve_ewa_phase(tmpdir: Path, seed: int, n: int = 1_000_000):
    """cli.serve's RenderService on a 3DGS-style model: n gaussians of
    phase 3's generator with N(0,1) quaternions and SH degree 3 (DC from
    the colour in the 3DGS basis, higher rows N(0,0.1)), written as the npz
    a trainer exports, served under the quality preset at 1920x1080 with
    the default footprint. The footprint must resolve to ewa, a served
    frame must launch the stage's forward kernel once, K3 once and no
    other kernel, and be bit for bit the port's render(...,
    footprint="ewa") of the same pose quantised as the service does; the
    axis draw of the model is logged beside it. Returns the served
    gaussians (phase 6 holds K3's EWA build against its twin on them)."""
    import numpy as np
    import torch

    from tpu_gaussians_torch.cli.serve import RenderService
    from tpu_gaussians_torch.core.types import RenderConfig, make_gaussians
    from tpu_gaussians_torch.io.npz import save_gaussians_npz
    from tpu_gaussians_torch.ops.dispatch import render

    rng = np.random.default_rng(seed)
    arr = scene_arrays(n, seed)
    sh = rng.normal(0.0, 0.1, (n, 16, 3)).astype(np.float32)
    sh[:, 0] = (arr["colors"] - 0.5) / 0.28209479177387814
    path = tmpdir / "scene_1m_ewa_sh3.npz"
    save_gaussians_npz(path, make_gaussians(
        arr["means"], arr["scales"], arr["opacities"], sh=sh,
        quats=rng.normal(size=(n, 4)).astype(np.float32), device="cpu"))
    svc = RenderService(str(path), preset="quality", device="cuda")
    check(svc.footprint == "ewa",
          f"serve ewa: footprint auto resolved to {svc.footprint!r}")
    width, height, pose = 1920, 1080, (0.7, 0.2, 2.5)
    svc.render_frame(*pose, width, height, "sorted")   # build and warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    served = svc.render_frame(*pose, width, height, "sorted")
    frame_ms = 1e3 * (time.perf_counter() - t0)
    launches = {k: v for k, v in read_launches().items() if v}

    def drawn(footprint):
        cfg = RenderConfig(width=width, height=height, mode="sorted",
                           footprint=footprint,
                           background=(0.02, 0.02, 0.02))
        with torch.no_grad():
            img = render(svc.gaussians,
                         svc.camera(*pose, width, height), cfg)
        return (torch.clamp(img, 0.0, 1.0) * 255.0).to(
            torch.uint8).cpu().numpy()

    ewa, axis = drawn("ewa"), drawn("axis")
    axis_off = float((np.abs(served.astype(np.int16)
                             - axis.astype(np.int16)) > 1).mean())
    out = {"n": n, "footprint": svc.footprint, "frame_ms": frame_ms,
           "launches": launches,
           "equal_to_ewa_render": bool(np.array_equal(served, ewa)),
           "axis_share_off_by_2_or_more": axis_off}
    log("serve ewa: " + json.dumps(out))
    check(launches == {"stage_fwd": 1, "sorted_fwd": 1},
          f"serve ewa: a served frame launched {launches}, not the stage's "
          "forward and K3 once each")
    check(out["equal_to_ewa_render"],
          "serve ewa: the served frame differs from render(footprint='ewa')")
    return svc.gaussians


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median CUDA-event time of `fn` over `reps` launches after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def timed(fn, reps: int):
    """(fn()'s last output, median CUDA-event ms of `reps` calls), with no
    warm-up: for plain twins that take seconds a call."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return out, times[len(times) // 2]


def http_get(url: str):
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.status, r.headers, r.read()


def serve_phase(svc, width: int, height: int, pose) -> dict:
    """/info and three /render formats through the HTTP handler."""
    from http.server import ThreadingHTTPServer

    import numpy as np
    from PIL import Image

    from tpu_gaussians_torch.cli.serve import make_handler

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out = {}
    try:
        status, _, body = http_get(base + "/info")
        info = json.loads(body)
        check(status == 200 and info["num_gaussians"] == svc.n,
              f"/info answered {status} {info}")
        yaw, pitch, radius = pose
        query = (f"/render?yaw={yaw}&pitch={pitch}&radius={radius}"
                 f"&width={width}&height={height}&mode=sorted")
        for fmt in ("jpg", "png", "raw"):
            t0 = time.perf_counter()
            status, headers, body = http_get(base + query + f"&format={fmt}")
            wall_ms = 1e3 * (time.perf_counter() - t0)
            check(status == 200, f"/render {fmt} answered {status}")
            if fmt == "raw":
                check(len(body) == width * height * 4,
                      f"raw frame has {len(body)} bytes")
                out["raw"] = np.frombuffer(body, np.uint8).reshape(
                    height, width, 4)[..., :3]
            else:
                size = Image.open(io.BytesIO(body)).size
                check(size == (width, height), f"{fmt} frame is {size}")
            log(f"serve: /render {fmt} {width}x{height}: {len(body)} bytes, "
                f"{wall_ms:.3f} ms wall, X-Render-Ms "
                f"{headers['X-Render-Ms']}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "HTTP server thread did not stop")
    return out


def sorted_fwd_agreement(acc_k, chunks_k, acc_p, chunks_p, tiles_y, tiles_x,
                         height, width, exit_t):
    """(agrees, largest error, tiles with another exit) of a compositing
    output (acc_k, chunks_k) against the twin's: image and alpha within
    rtol 1e-4 / atol 1e-5, and within exit_t on tiles whose whole-tile
    early-exit decision differs; a non-finite image or alpha disagrees."""
    import torch

    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.ops.binning import TPS

    with torch.no_grad():
        bg = torch.zeros(3, device=acc_k.device)
        img_k, al_k, _ = tiled.resolve_sorted(acc_k, bg, tiles_y, tiles_x,
                                              height, width)
        img_p, al_p, _ = tiled.resolve_sorted(acc_p, bg, tiles_y, tiles_x,
                                              height, width)
        finite = all(bool(torch.isfinite(t).all()) for t in (img_k, al_k))
        same = (chunks_k == chunks_p).to(torch.float32).repeat_interleave(TPS)
        same_px = tiled.crop_tiled_acc(same.expand(8, -1), tiles_y, tiles_x,
                                       height, width)[..., 0] > 0.5
        err_img = (img_k - img_p).abs()
        err_al = (al_k - al_p).abs()
        bound_img = 1e-5 + 1e-4 * img_p.abs()
        bound_al = 1e-5 + 1e-4 * al_p.abs()
        ok_same = bool(((err_img <= bound_img).all(-1) & (err_al <= bound_al)
                        | ~same_px).all())
        ok_diff = bool(((err_img.amax(-1) <= exit_t) & (err_al <= exit_t)
                        | same_px).all())
        max_err = max(float(err_img.max()), float(err_al.max()))
        tiles_differ = int((chunks_k != chunks_p).sum())
    return finite and ok_same and ok_diff, max_err, tiles_differ


def sorted_fwd_check(name, gdense, cnt, tiles_x, tiles_y, height, width,
                     axis, exit_t):
    """K3 against its plain twin on one view's tile lists
    (sorted_fwd_agreement), then against itself: a second launch bit for
    bit, and the cluster of sorted_fwd.CLUSTER blocks a tile that its
    launch takes (the grid of its kernel event in a torch.profiler trace).
    Raises on a disagreement; returns K3's (acc, chunks_done), the largest
    error, the count of tiles with another exit and the launched blocks."""
    import torch

    from tpu_gaussians_torch.kernels import sorted_fwd

    def k3():
        return sorted_fwd.sorted_tiles(gdense, cnt, tiles_x, axis=axis,
                                       exit_t=exit_t)

    with torch.no_grad():
        acc_k, chunks_k = k3()
        acc_p, chunks_p = sorted_fwd.sorted_tiles_plain(
            gdense, cnt, tiles_x, axis=axis, exit_t=exit_t)
        again, chunks_again = k3()
        torch.cuda.synchronize()
        ok, max_err, tiles_differ = sorted_fwd_agreement(
            acc_k, chunks_k, acc_p, chunks_p, tiles_y, tiles_x, height,
            width, exit_t)
        check(ok, f"{name}: K3 and its plain twin disagree (max abs err "
              f"{max_err}, {tiles_differ} tiles with another exit)")
        check(torch.equal(acc_k, again) and torch.equal(chunks_k,
                                                        chunks_again),
              f"{name}: K3 not bit-identical across two launches")
        blocks = launched_blocks(k3, "sorted_fwd_kernel")
        check(blocks == sorted_fwd.CLUSTER * cnt.shape[0],
              f"{name}: K3 launched {blocks} blocks for {cnt.shape[0]} "
              f"tiles, not {sorted_fwd.CLUSTER} a tile")
    return acc_k, chunks_k, max_err, tiles_differ, blocks


def sorted_fwd_bound(cnt, chunks, footprint: str) -> dict:
    """K3's least time on this card for one launch's work: the slots the
    tiles composited (up to their exit, chunks x 512 at most), each read
    once (64 B), cnt read and the (8, pixels) f32 output and chunk counts
    written once, against SORTED_FLOPS_PER_EVAL of the footprint per
    composited (slot, pixel)."""
    from tpu_gaussians_torch.ops.binning import TPS

    slots, nbytes = sorted_fwd_bytes(cnt, chunks)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * SORTED_FLOPS_PER_EVAL[footprint] * slots * TPS / (
        F32_FLOPS_PER_S)
    return {"slots_composited": slots, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def sorted_fwd_bytes(cnt, chunks):
    """(composited slots, bytes) of one K3 launch: each composited slot read
    once (64 B), cnt read and the (8, pixels) f32 output and chunk counts
    written once."""
    import torch

    from tpu_gaussians_torch.ops.binning import NBS, TPS

    n_tiles = cnt.shape[0]
    slots = int(torch.minimum(cnt, chunks * NBS).sum())
    return slots, (slots * 64 + n_tiles * 4 + 8 * 4 * n_tiles * TPS
                   + n_tiles * 4)


def sorted_fwd_live_bound(gdense, cnt, chunks, tiles_x: int, footprint: str,
                          sms: int, mhz: float) -> dict:
    """K3's least time on this card for the work its function needs: the
    live pairs (composited (slot, pixel) pairs with a_raw >= 1e-5, counted
    by the twin's slot_alpha) at SORTED_FLOPS_PER_EVAL each at the f32 rate
    and one exp each at the SFU rate (16 per SM and clock at the SM clock
    `mhz`), against sorted_fwd_bound's bytes; beside it the pairs the
    kernel's culling rule evaluates (kernels/sorted_fwd.cull_counts)."""
    from tpu_gaussians_torch.kernels import sorted_fwd

    counts = sorted_fwd.cull_counts(gdense, cnt, chunks, tiles_x,
                                    footprint == "axis")
    live = counts["live_pairs"]
    terms = {"bytes": 1e3 * sorted_fwd_bytes(cnt, chunks)[1]
             / HBM_BYTES_PER_S,
             "f32": 1e3 * SORTED_FLOPS_PER_EVAL[footprint] * live
             / F32_FLOPS_PER_S,
             "sfu exp": 1e3 * live
             / (SFU_EXP_PER_SM_CLOCK * sms * mhz * 1e6)}
    term = max(terms, key=terms.get)
    return {**counts, "live_bound_ms": terms[term], "live_bound_by": term,
            "live_bound_terms_ms": terms, "sm_clock_mhz": mhz}


def sorted_bwd_live_bound(live: int, nbytes: int, footprint: str,
                          sms: int, mhz: float) -> dict:
    """K4's least time on this card for the work its function needs: the
    live pairs (a_raw >= 1e-5; the others add exact zeros, and K4 culls
    them by warp) at SORTED_BWD_FLOPS_PER_EVAL each at the f32 rate and one
    exp each at the SFU rate (16 per SM and clock at the SM clock `mhz`),
    against the launch's `nbytes`."""
    terms = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
             "f32": 1e3 * SORTED_BWD_FLOPS_PER_EVAL[footprint] * live
             / F32_FLOPS_PER_S,
             "sfu exp": 1e3 * live
             / (SFU_EXP_PER_SM_CLOCK * sms * mhz * 1e6)}
    term = max(terms, key=terms.get)
    return {"live_bound_ms": terms[term], "live_bound_by": term,
            "live_bound_terms_ms": terms, "sm_clock_mhz": mhz}


def kernel_device(fn, calls: int, kernel: str = "sorted_fwd_kernel"):
    """(device ms per traced launch, launches traced) of `kernel` over
    `calls` calls of fn (profile_calls: late in a run the trace can miss
    launches, so the time is per launch it kept)."""
    for attempt in range(1, PROFILE_TRIES + 1):
        pad = PROFILE_SHORT_PAD_S if attempt == 1 else PROFILE_PAD_S
        port = profile_calls(lambda i: fn(), calls, pad)["port_kernels"]
        if kernel in port or attempt == PROFILE_TRIES:
            break
        warn(f"profile: window {attempt} kept no launch of {kernel}; "
             "tracing again")
    check(kernel in port, f"{PROFILE_TRIES} profiler windows of {calls} "
          f"calls kept no launch of {kernel}")
    ms, per_call = port[kernel]
    return ms / per_call, round(per_call * calls)


def sorted_fwd_clock(k3) -> float:
    """The SM clock nvidia-smi reads while about 300 ms of K3 launches
    (the callable k3) run."""
    import torch

    ms = max(time_ms(k3, 5, 1), 1e-3)
    for _ in range(max(1, int(300 / ms))):
        k3()
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    return mhz


def kernel_case(name, g, width, height, knobs, reps, footprint="axis"):
    """K3's build for `footprint` against its plain twin and itself on one
    served frame's compositing inputs (sorted_fwd_check), timed (CUDA
    events, and its kernel alone by torch.profiler) beside its bounds
    (sorted_fwd_bound, sorted_fwd_live_bound)."""
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import RenderConfig
    from tpu_gaussians_torch.kernels import sorted_fwd
    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.ops.binning import EXIT_T
    from tpu_gaussians_torch.ops.common import prepare_splats
    from tpu_gaussians_torch.ops.projection import camera_z

    cfg = RenderConfig(width=width, height=height, mode="sorted",
                       footprint=footprint, **knobs)
    exit_t = cfg.sorted_exit_t or EXIT_T
    axis = footprint == "axis"
    c = cam.orbit_cameras(8, width, height, device="cuda")[1]
    with torch.no_grad():
        s = prepare_splats(g, c.view, c.proj, width, height, footprint)
        gdense, cnt, tiles_x, tiles_y, stats = tiled.tile_lists(
            s, camera_z(g.means, c.view), height, width,
            cfg.sorted_band_capacity, cfg.sorted_pair_k)
        _, chunks_k, max_err, tiles_differ, blocks = sorted_fwd_check(
            name, gdense, cnt, tiles_x, tiles_y, height, width, axis, exit_t)

        def k3():
            return sorted_fwd.sorted_tiles(gdense, cnt, tiles_x, axis=axis,
                                           exit_t=exit_t)
        k_ms = time_ms(k3, reps)
        device_ms, traced = kernel_device(k3, reps)
        p_ms = time_ms(lambda: sorted_fwd.sorted_tiles_plain(
            gdense, cnt, tiles_x, axis=axis, exit_t=exit_t), reps)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        live = sorted_fwd_live_bound(gdense, cnt, chunks_k, tiles_x,
                                     footprint, sms, sorted_fwd_clock(k3))

    # The least the card could take for this run's work (the footprint's
    # compositing, as the server renders): every composited (slot, pixel)
    # pair (bound_ms), and the live ones (live_bound_ms).
    n_tiles = cnt.shape[0]
    case = {
        "case": name, "n": g.capacity, "footprint": footprint,
        "width": width, "height": height,
        "tiles": n_tiles, "blocks": blocks, "cap": gdense.shape[0] // n_tiles,
        "exit_t": exit_t, "slots_listed": int(cnt.sum()),
        "tiles_exit_differs": tiles_differ, "max_abs_err": max_err,
        "ms": k_ms, "device_ms": device_ms,
        "device_launches_traced": traced, "plain_ms": p_ms,
        **sorted_fwd_bound(cnt, chunks_k, footprint), **live,
        "stats": {k: int(v) for k, v in stats.items()},
    }
    log("kernel case " + json.dumps(case))
    return case


def stage_err(x, ref, rows: bool) -> float:
    """Worst error of x against ref (float64), relative to the largest
    |ref| of its field (rows: each of the 8 rows and each feats column) or
    of its gaussian (gradients: the gaussian's largest of that leaf), as
    tests/test_torch_port_cuda.py measures it."""
    ref = ref.double()
    if rows:
        scale = ref.abs().amax(dim=1 if ref.shape[0] == 8 else 0,
                               keepdim=True)
    else:
        n = ref.shape[0]
        scale = ref.abs().reshape(n, -1).amax(dim=1).reshape(
            (n,) + (1,) * (ref.ndim - 1))
    return float(((x.double() - ref).abs() / scale.clamp(min=1e-30)).max())


def stage_case(name: str, n: int, ewa: bool, sh_k: int, seed: int,
               reps: int = 20) -> dict:
    """The per-gaussian stage's kernels against their plain twins on the
    benchmark's kind of scene (phase 3's generator, N(0,1) quaternions, SH
    DC U(0,1) and higher rows N(0,0.1), a tenth dead) for view 1 of 4
    orbit cameras at 1920x1080: the forward, then the backward on a seeded
    N(0,1) cotangent of every output, strided as the sorted route's gather
    hands it back (columns of one (N, 16) buffer). Each value's error
    against a float64 evaluation of the twin's formulas within 4 times the
    f32 twin's own worst error plus 1e-6 (tests/test_torch_port_cuda.py's
    rule), and bit for bit across two launches. Timed: each kernel (CUDA
    events, and its device time by torch.profiler), its plain twin, and
    the stage's plain composition under autograd, forward and backward
    (the path before the kernels); beside the bound, the bytes the stage
    must read and write at 3.35 TB/s."""
    import numpy as np
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.kernels import stage

    rng = np.random.default_rng(seed)
    arr = scene_arrays(n, seed)
    sh = rng.normal(0.0, 0.1, (n, sh_k, 3))
    sh[:, 0] = arr["colors"]
    host = (arr["means"], arr["scales"],
            rng.normal(size=(n, 4)) if ewa else None, sh, arr["opacities"],
            rng.uniform(size=n) > 0.1)
    width, height = 1920, 1080
    c = cam.orbit_cameras(4, width, height, device="cuda")[1]
    ins = [None if a is None else torch.from_numpy(
        np.asarray(a, np.float32)).cuda() for a in host] + [c.view, c.proj]
    ins64 = [None if t is None else t.double() for t in ins]
    args = (width, height, ewa, sh_k)
    buf = torch.randn((n, 16), generator=torch.Generator().manual_seed(
        seed)).cuda()
    cot = [buf[:, k] for k in range(8)] + [buf[:, 8:13]]
    needs = [t is not None for t in ins[:5]]

    out = {"case": name, "n": n, "footprint": "ewa" if ewa else "axis",
           "sh_rows": sh_k, "width": width, "height": height}
    fwd = [stage._fwd(ins, *args) for _ in range(2)]
    bwd = [stage._bwd(ins, *args, cot, needs) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*fwd)),
          f"stage {name}: two forward launches differ")
    check(all((a is None and b is None) or torch.equal(a, b)
              for a, b in zip(*bwd)),
          f"stage {name}: two backward launches differ")
    twins = {"fwd": stage.stage_fwd_plain(*ins, width, height, ewa),
             "bwd": stage.stage_bwd_plain(*ins, width, height, ewa, cot,
                                          needs)}
    exact = {"fwd": stage.stage_fwd_plain(*ins64, width, height, ewa),
             "bwd": stage.stage_bwd_plain(
                 *ins64, width, height, ewa,
                 [g.double() for g in cot], needs)}
    for kind_, got in (("fwd", fwd[0]), ("bwd", bwd[0])):
        errs, abs_errs = [], []
        for k, (a, b, r) in enumerate(zip(got, twins[kind_], exact[kind_])):
            if r is None:
                continue
            e_k = stage_err(a, r, kind_ == "fwd")
            e_t = stage_err(b, r, kind_ == "fwd")
            check(e_k <= 4.0 * e_t + 1e-6, f"stage {name} {kind_} output "
                  f"{k}: error {e_k} against float64, the twin's {e_t}")
            errs.append([e_k, e_t])
            abs_errs.append(float((a - b).abs().max()))
        out[f"{kind_}_err_vs_float64"] = errs
        out[f"{kind_}_max_abs_err"] = max(abs_errs)
    del twins, exact, ins64

    def composition():
        leaves = [None if t is None or k == 5 else
                  t.detach().requires_grad_(True)
                  for k, t in enumerate(ins[:6])]
        leaves[5] = ins[5]
        rows, feats = stage.stage_fwd_plain(*leaves, *ins[6:], width,
                                            height, ewa)
        torch.autograd.backward([rows, feats], [buf[:, :8].T, buf[:, 8:13]])

    floats_in = 3 + 3 + (4 if ewa else 0) + 3 * max(sh_k, 1) + 1 + 1
    floats_grad = 3 + 3 + (4 if ewa else 0) + 3 * max(sh_k, 1) + 1
    nbytes = {"fwd": 4 * n * (floats_in + 13),
              "bwd": 4 * n * (floats_in + 13 + floats_grad)}
    runs = {"fwd": (lambda: stage._fwd(ins, *args),
                    lambda: stage.stage_fwd_plain(*ins, width, height, ewa)),
            "bwd": (lambda: stage._bwd(ins, *args, cot, needs),
                    lambda: stage.stage_bwd_plain(*ins, width, height, ewa,
                                                  cot, needs))}
    for kind_, (kernel, twin) in runs.items():
        out[f"{kind_}_ms"] = time_ms(kernel, reps)
        out[f"{kind_}_plain_ms"] = time_ms(twin, 5)
        prof = profile_calls(lambda i: kernel(), reps, pad=PROFILE_PAD_S)
        ms, launches = prof["port_kernels"].get(f"stage_{kind_}_kernel",
                                                (None, 0))
        out[f"{kind_}_device_ms"] = ms
        out[f"{kind_}_device_launches_traced"] = launches * reps
        out[f"{kind_}_bytes"] = nbytes[kind_]
        out[f"{kind_}_bound_ms"] = 1e3 * nbytes[kind_] / HBM_BYTES_PER_S
        out[f"{kind_}_bound_by"] = "bytes"
    out["composition_autograd_ms"] = time_ms(composition, 5)
    log("stage case " + json.dumps(out))
    return out


def profile_calls(fn, calls: int, pad: float = PROFILE_SHORT_PAD_S) -> dict:
    """Device time per call by CUDA kernel, from torch.profiler over
    `calls` back-to-back calls of fn(i); the device's busy share of the
    wall time (the profiler's own host overhead included); and the torch
    operations the host dispatches per call: every aten op that no other
    aten op encloses, wherever it runs (forward, an autograd.Function's
    body, the backward, the optimizer), so that the count does not depend
    on how the code nests its profiler ranges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # The trace can miss the first or last kernels of a window
        # (PROFILE_PAD_S): wait `pad` s at both ends.
        time.sleep(pad)
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
        time.sleep(pad)
    rows = [{"kernel": e.key[:90],
             "ms_per_call": e.self_device_time_total / 1e3 / calls,
             "calls_per_call": e.count / calls}
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            # Not a range (`record_function`: Adam.step's, the program's
            # spans), whose device time is its whole range's. A '#' in
            # the key marks no range: kernels named by a lambda hold one.
            and not e.is_user_annotation]
    rows.sort(key=lambda r: -r["ms_per_call"])
    busy = sum(r["ms_per_call"] for r in rows)
    # Every row of the port's own kernels, which "top" may cut off: ms and
    # launches per call by kernel name.
    port = {}
    for r in rows:
        name = re.search(r"::(\w+_kernel)[<(]", r["kernel"])
        if name and name.group(1) in PORT_KERNELS:
            ms, n = port.get(name.group(1), (0.0, 0.0))
            port[name.group(1)] = (ms + r["ms_per_call"],
                                   n + r["calls_per_call"])
    def outermost_aten(e) -> bool:
        if e.device_type != DeviceType.CPU or not e.name.startswith(
                "aten::"):
            return False
        parent = e.cpu_parent
        while parent is not None:
            if parent.name.startswith("aten::"):
                return False
            parent = parent.cpu_parent
        return True

    host_ops = sum(1 for e in prof.events() if outermost_aten(e))
    return {"calls": calls, "wall_ms_per_call": wall_ms,
            "device_busy_ms_per_call": busy if rows else None,
            "device_busy_share": busy / wall_ms if rows else None,
            "kernels_per_call": sum(r["calls_per_call"] for r in rows),
            "host_ops_per_call": host_ops / calls,
            "top": rows[:12], "port_kernels": port}


def launched_blocks(fn, kernel: str) -> int:
    """The thread blocks of each launch of the kernel whose name holds
    `kernel` that fn() makes: the grid of its kernel events in a
    torch.profiler trace (CPU and CUDA activities, as profile_calls) of ten
    calls of fn, traced again (at most PROFILE_TRIES windows) while a
    window keeps no such event. Raises unless a trace holds such an event
    and every one in it has the same grid."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                # The trace can miss the kernels near a window's ends
                # (PROFILE_PAD_S): wait at both ends, launch ten times.
                time.sleep(PROFILE_PAD_S)
                for _ in range(10):
                    fn()
                    torch.cuda.synchronize()
                time.sleep(PROFILE_PAD_S)
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        grids = {tuple(e["args"]["grid"]) for e in kernels
                 if kernel in e.get("name", "")}
        if grids or attempt == PROFILE_TRIES:
            break
        warn(f"launched_blocks: window {attempt} kept no launch of "
             f"{kernel} ({len(kernels)} kernel and "
             f"{sum(e.get('cat') == 'cuda_runtime' for e in events)} runtime "
             "events); tracing again")
    check(len(grids) == 1, f"grids {grids} of {kernel} in a trace of "
          f"{len(kernels)} kernel events "
          f"{sorted({e.get('name', '')[:60] for e in kernels})[:4]} and "
          f"{sum(e.get('cat') == 'cuda_runtime' for e in events)} runtime "
          f"events, after {attempt} windows")
    x, y, z = grids.pop()
    return x * y * z


def profile_frames(svc, width: int, height: int, frames: int = 10) -> dict:
    """profile_calls over `frames` served renders."""
    out = profile_calls(lambda i: svc.render_tensor(
        0.013 * (2000 + i), 0.2, 2.5, width, height, "sorted"), frames)
    return {"n": svc.n, "preset": svc.preset, **out}


def small_scene(device: str = "cuda"):
    """2,000 gaussians four times phase 3's size, with seeded quaternions."""
    import numpy as np

    from tpu_gaussians_torch.core.types import gaussians_from_numpy

    arr = scene_arrays(2000, 7)
    arr["scales"] *= 4.0
    arr["quats"] = np.random.default_rng(8).normal(
        size=(2000, 4)).astype(np.float32)
    return gaussians_from_numpy(arr, device=device)


def small_reference_check() -> None:
    """render(impl="tiled") with the kernels against the whole-frame plain
    renderer on a small scene, in both compositing modes and footprints."""
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import RenderConfig
    from tpu_gaussians_torch.ops.dispatch import render

    g = small_scene()
    c = cam.orbit_cameras(2, 256, 64, device="cuda")
    for footprint in ("axis", "ewa"):
        for mode, rtol in (("sorted", 1e-4), ("accum", 1e-5)):
            cfg = RenderConfig(width=256, height=64, mode=mode,
                               footprint=footprint, return_aux=True)
            with torch.no_grad():
                tiled = render(g, c, cfg.replace(impl="tiled"))
                plain = render(g, c, cfg.replace(impl="torch"))
            name = f"small {footprint} {mode} render"
            for t, p in zip(tiled[:2], plain[:2]):
                check(t.shape == p.shape and bool(torch.isfinite(t).all()),
                      f"{name}: bad shape or non-finite values")
                check(bool(torch.allclose(t, p, rtol=rtol, atol=1e-5)),
                      f"{name}: tiled and plain renderers disagree (max "
                      f"abs err {float((t - p).abs().max())})")
            log(f"small scene, {footprint} {mode}: render(impl='tiled') == "
                f"render(impl='torch') (max abs err "
                f"{float((tiled[0] - plain[0]).abs().max())})")


def small_grad_check() -> dict:
    """Gradients of render(mode="sorted") through K3/K4 against the plain
    renderer's autograd on the small scene, both footprints, at rtol 2e-3
    and atol 2e-4 times each parameter's largest gradient."""
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import RenderConfig
    from tpu_gaussians_torch.ops.dispatch import render

    c = cam.orbit_cameras(3, 256, 64, device="cuda")[1]
    gen = torch.Generator(device="cuda").manual_seed(9)
    target = torch.rand((64, 256, 3), generator=gen, device="cuda")
    errs = {}
    for footprint in ("axis", "ewa"):
        cfg = RenderConfig(width=256, height=64, mode="sorted",
                           footprint=footprint, return_aux=True)
        grads = {}
        for impl in ("tiled", "torch"):
            g = small_scene()
            leaves = {k: getattr(g, k).requires_grad_(True) for k in (
                "means", "scales", "opacities", "colors", "quats")}
            img, alpha, _ = render(g, c, cfg.replace(impl=impl))
            ((img - target).abs().mean() + alpha.mean()).backward()
            grads[impl] = {k: t.grad for k, t in leaves.items()
                           if t.grad is not None}
        check(set(grads["tiled"]) == set(grads["torch"]),
              f"sorted {footprint} grads: different leaves reached")
        for k, want in grads["torch"].items():
            got = grads["tiled"][k]
            scale = float(want.abs().max())
            check(bool(torch.isfinite(got).all()) and bool(torch.allclose(
                got, want, rtol=2e-3, atol=2e-4 * scale)),
                f"sorted {footprint} grad of {k}: tiled and plain disagree "
                f"(max abs err {float((got - want).abs().max())}, scale "
                f"{scale})")
            errs[f"{footprint}_{k}"] = float((got - want).abs().max()) / max(
                scale, 1e-30)
    log("small scene, sorted gradients: tiled == plain, max err / scale "
        + json.dumps(errs))
    return errs


def staged_sep(g, view, proj, width: int, height: int):
    """K1/K2's inputs for one view, staged by the training path's own
    ops/splat.stage: (lo, cnt, gdata, rows, wp, nb)."""
    import torch

    from tpu_gaussians_torch.ops import splat
    from tpu_gaussians_torch.ops.common import prepare_splats

    with torch.no_grad():
        s = prepare_splats(g, view, proj, width, height)
        _, (lo, cnt, gdata, nb, wp, _, _, rows) = splat.stage(s, height,
                                                               width)
    return lo, cnt, gdata, rows, wp, nb


def sep_library_products(lo, cnt, gdata, gband, rows: int, wp: int,
                         nb: int, acc, reps: int) -> dict:
    """K1's and K2's products alone through cuBLAS: the factors G (n_bands,
    5R, K) and Ex (n_bands, K, Wp) formed beforehand by the twin's own
    arithmetic, zero-padded to the longest range K; K1's one torch.bmm
    (G . Ex) and K2's two (gband . Ex^T and gband^T . G), in f32 (TF32 off).
    Yardsticks of the products' time, not of the functions' (the factors'
    exps and K2's moments are outside them); the port never calls them. ->
    {fwd_library_ms, fwd_library_max_abs_diff (from K1's sums),
    bwd_library_ms}, medians of `reps`."""
    import torch

    from tpu_gaussians_torch.kernels import splat_sep as K

    ranges = K._ranges(lo, cnt, nb)
    k_max = max([e - s for _, s, e in ranges], default=nb)
    n_bands = lo.shape[0]
    g_all = torch.zeros((n_bands, K.FEAT * rows, k_max), device="cuda")
    ex_all = torch.zeros((n_bands, k_max, wp), device="cuda")
    for i, s0, e0 in ranges:
        _, ex, _, _, _, g_mat = K._band_factors(gdata[s0:e0], i, rows, wp)
        g_all[i, :, :e0 - s0] = g_mat.reshape(K.FEAT * rows, -1)
        ex_all[i, :e0 - s0] = ex.T
        del ex, g_mat
    fwd_ms = time_ms(lambda: torch.bmm(g_all, ex_all), reps)
    prod = torch.bmm(g_all, ex_all).reshape(acc.shape)
    err = float((prod - acc).abs().max())
    del prod
    gb = gband.reshape(n_bands, K.FEAT * rows, wp)

    def bwd_products():
        return (torch.bmm(gb, ex_all.transpose(1, 2)),
                torch.bmm(gb.transpose(1, 2), g_all))
    bwd_ms = time_ms(bwd_products, reps)
    del g_all, ex_all
    return {"fwd_library_ms": fwd_ms, "fwd_library_max_abs_diff": err,
            "bwd_library_ms": bwd_ms}


def sep_fwd_bound(lo, cnt, gdata, rows: int, wp: int, nb: int, sms: int,
                  mhz: float) -> dict:
    """K1's bound on this card for the (gaussian, band) pairs this run's
    block ranges evaluate, for a kernel that runs its product on the tensor
    cores (csrc/splat_sep_fwd.cu does, as the TPU did on its matrix unit):
    the largest of tensor_core_bound's terms at the SM clock `mhz`. Per
    pair, the product is SEP_FWD_FLOPS_PER_PIXEL per band pixel (priced x3,
    the TF32 split); G = featsop x Ey takes 5R multiplies at the f32 rate;
    one exp per row and per column; against gdata and lo/cnt read once and
    the planes written once. The operands' splits and the slice partials
    are K1's design, not its function, and stay out of the bound: the
    partials' bytes and their time at the memory rate are reported beside
    it. The 10-flop f32 figure beside it too; K1's slices."""
    import torch

    from tpu_gaussians_torch.kernels import splat_sep as K

    n_bands, n_pad = lo.shape[0], gdata.shape[0]
    pairs = int(cnt.to(torch.int64).sum()) * nb
    length, slices = K.fwd_slices(n_bands, rows, wp, n_pad)
    spans = (torch.clamp((lo + cnt).to(torch.int64) * nb, max=n_pad)
             - lo.to(torch.int64) * nb)
    live = int(torch.clamp((spans + length - 1) // length, min=1).sum())
    plane_bytes = K.FEAT * rows * wp * 4
    partial_bytes = 2 * live * plane_bytes if slices > 1 else 0
    nbytes = gdata.numel() * 4 + 2 * n_bands * 4 + n_bands * plane_bytes
    product = SEP_FWD_FLOPS_PER_PIXEL * rows * wp
    ms, term, terms = tensor_core_bound(pairs, K.FEAT * rows, product,
                                        nbytes, sms, mhz, exps=rows + wp)
    f32_ms = 1e3 * pairs * product / F32_FLOPS_PER_S
    return {"fwd_bound_ms": ms,
            "fwd_bound_by": "bytes" if term == "bytes" else "operations",
            "fwd_bound_term": term, "fwd_bound_terms_ms": terms,
            "fwd_bound_ms_f32": max(f32_ms, 1e3 * nbytes / HBM_BYTES_PER_S),
            "fwd_sm_clock_mhz": mhz, "fwd_slice_len": length,
            "fwd_slices": slices, "fwd_live_slices": live,
            "fwd_partial_bytes": partial_bytes,
            "fwd_partial_ms": 1e3 * partial_bytes / HBM_BYTES_PER_S}


def sep_bwd_bound(lo, cnt, gdata, rows: int, wp: int, nb: int, sms: int,
                  mhz: float) -> dict:
    """K2's bound on this card for the (gaussian, band) pairs this run's
    block ranges evaluate, for a kernel that runs both products on the
    tensor cores (csrc/splat_sep_bwd.cu does, as the TPU did on its matrix
    unit): the largest of tensor_core_bound's terms at the SM clock `mhz`.
    Per pair, the products are SEP_BWD_FLOPS_PER_PIXEL per band pixel
    (priced x3, the TF32 split); the f32 work beside them
    SEP_BWD_ELEMENTWISE_FLOPS_PER_ROW a band row and _PER_COLUMN a column;
    one exp per row and per column; against gdata, lo/cnt and the band
    planes read once and the (n_pad, 16) rows written once. The operands'
    splits, gband's re-reads and the slice partials are K2's design, not
    its function, and stay out of the bound: the partials' bytes (each
    slice's rows written and read once) and their time at the memory rate
    are reported beside it. The 20-flop f32 figure beside it too; K2's
    slices."""
    import torch

    from tpu_gaussians_torch.kernels import splat_sep as K

    n_bands, n_pad = lo.shape[0], gdata.shape[0]
    pairs = int(cnt.to(torch.int64).sum()) * nb
    slices = K.bwd_slices(rows, wp, n_pad)
    partial_bytes = 2 * slices * gdata.numel() * 4 if slices > 1 else 0
    nbytes = (2 * gdata.numel() * 4 + 2 * n_bands * 4
              + n_bands * K.FEAT * rows * wp * 4)
    product = SEP_BWD_FLOPS_PER_PIXEL * rows * wp
    elementwise = (SEP_BWD_ELEMENTWISE_FLOPS_PER_ROW * rows
                   + SEP_BWD_ELEMENTWISE_FLOPS_PER_COLUMN * wp)
    ms, term, terms = tensor_core_bound(pairs, elementwise, product, nbytes,
                                        sms, mhz, exps=rows + wp)
    f32_ms = 1e3 * pairs * product / F32_FLOPS_PER_S
    return {"bwd_bound_ms": ms,
            "bwd_bound_by": "bytes" if term == "bytes" else "operations",
            "bwd_bound_term": term, "bwd_bound_terms_ms": terms,
            "bwd_bound_ms_f32": max(f32_ms, 1e3 * nbytes / HBM_BYTES_PER_S),
            "bwd_sm_clock_mhz": mhz, "bwd_slices": slices,
            "bwd_partial_bytes": partial_bytes,
            "bwd_partial_ms": 1e3 * partial_bytes / HBM_BYTES_PER_S}


def sep_kernel_case(name: str, staged, seed: int, reps: int = 20) -> dict:
    """K1 and K2 against their plain twins on one set of staged inputs:
    errors, determinism, CUDA-event and device times, bounds, and their
    products through cuBLAS. Raises if either disagrees or is not
    deterministic."""
    import torch

    from tpu_gaussians_torch.kernels import splat_sep as K

    lo, cnt, gdata, rows, wp, nb = staged
    with torch.no_grad():
        acc = K.splat_sep_fwd(lo, cnt, gdata, rows, wp, nb)
        acc_again = K.splat_sep_fwd(lo, cnt, gdata, rows, wp, nb)
        ref = K.sep_fwd_plain(lo, cnt, gdata, rows, wp, nb)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        gband = torch.randn(acc.shape, generator=gen, device="cuda")
        out = K.splat_sep_bwd(lo, cnt, gdata, gband, rows, wp, nb)
        again = K.splat_sep_bwd(lo, cnt, gdata, gband, rows, wp, nb)
        ref_b = K.sep_bwd_plain(lo, cnt, gdata, gband, rows, wp, nb)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(acc).all() and torch.isfinite(out).all()),
              f"{name}: non-finite kernel output")
        check(bool(torch.equal(acc, acc_again)),
              f"{name}: K1 not deterministic")
        err_f = float((acc - ref).abs().max())
        check(bool(torch.allclose(acc, ref, rtol=1e-5, atol=1e-5)),
              f"{name}: K1 disagrees with its twin (max abs err {err_f})")
        scale = torch.clamp(ref_b.abs().amax(dim=0), min=1.0)
        bad = (out - ref_b).abs() > 2e-4 * ref_b.abs() + 2e-5 * scale
        err_b = float((out - ref_b).abs().max())
        check(not bool(bad.any()),
              f"{name}: K2 disagrees with its twin in {int(bad.sum())} "
              f"values (max abs err {err_b})")
        check(bool(torch.equal(out, again)), f"{name}: K2 not deterministic")
        ref_b_max = ref_b.abs().max()
        del acc_again, ref_b, again
        times = {
            "fwd_ms": time_ms(lambda: K.splat_sep_fwd(
                lo, cnt, gdata, rows, wp, nb), reps),
            "fwd_plain_ms": time_ms(lambda: K.sep_fwd_plain(
                lo, cnt, gdata, rows, wp, nb), reps),
            "bwd_ms": time_ms(lambda: K.splat_sep_bwd(
                lo, cnt, gdata, gband, rows, wp, nb), reps),
            "bwd_plain_ms": time_ms(lambda: K.sep_bwd_plain(
                lo, cnt, gdata, gband, rows, wp, nb), reps),
        }
        # Each kernel alone per call (torch.profiler): the event time above
        # also holds the wrapper's host work, which at the flagship's size
        # is longer than the kernels. K2's main kernel and its slice sum
        # apart.
        times["fwd_device_ms"] = profile_calls(
            lambda i: K.splat_sep_fwd(lo, cnt, gdata, rows, wp, nb),
            reps)["device_busy_ms_per_call"]
        prof = profile_calls(lambda i: K.splat_sep_bwd(
            lo, cnt, gdata, gband, rows, wp, nb), reps)
        split = device_split(prof, "splat_sep_bwd_kernel",
                             "splat_sep_bwd_sum_kernel")
        times.update(bwd_device_ms=prof["device_busy_ms_per_call"],
                     bwd_device_ms_main=split["main"],
                     bwd_device_ms_slice_sum=split["second"])
        # The SM clock while each runs (launches queued for about 0.3 s).
        mhz = {}
        for kind, fn in (
                ("fwd", lambda: K.splat_sep_fwd(lo, cnt, gdata, rows, wp,
                                                nb)),
                ("bwd", lambda: K.splat_sep_bwd(lo, cnt, gdata, gband, rows,
                                                wp, nb))):
            for _ in range(max(1, int(300 / max(times[f"{kind}_ms"],
                                                1e-3)))):
                fn()
            mhz[kind] = sm_clock_mhz()
            torch.cuda.synchronize()
        library = sep_library_products(lo, cnt, gdata, gband, rows, wp, nb,
                                       acc, reps)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # The least the card could take: the (gaussian, band) pairs this
    # run's block ranges evaluate, on the terms of sep_fwd_bound and
    # sep_bwd_bound.
    pairs = int(cnt.to(torch.int64).sum()) * nb
    # Of those, the pairs whose gaussian has weight (op > 0): the bound
    # above also counts the dead slots of the capacity in each block.
    alive = torch.cat([cnt.new_zeros(1, dtype=torch.int64),
                       (gdata[:, 5] > 0).reshape(-1, nb).sum(1).cumsum(0)])
    lo64 = lo.to(torch.int64)
    alive_pairs = int((alive[lo64 + cnt] - alive[lo64]).sum())
    bands = int((cnt > 0).sum())
    bounds = {**sep_fwd_bound(lo, cnt, gdata, rows, wp, nb, sms,
                              mhz["fwd"]),
              **sep_bwd_bound(lo, cnt, gdata, rows, wp, nb, sms,
                              mhz["bwd"])}
    case = {"case": name, "n_pad": gdata.shape[0], "nb": nb, "rows": rows,
            "wp": wp, "n_bands": lo.shape[0], "bands_with_work": bands,
            "pairs_evaluated": pairs, "alive_pairs": alive_pairs,
            "alive_share": alive_pairs / max(pairs, 1),
            "fwd_max_abs_err": err_f, "fwd_max_abs_ref": float(
                ref.abs().max()),
            "bwd_max_abs_err": err_b, "bwd_max_abs_ref": float(
                ref_b_max), **times, **library,
            "library_call": (
                "torch.bmm, cuBLAS f32 (TF32 off), on G and Ex formed "
                "beforehand (K2: two calls, with gband): the products' "
                "time, not the functions'"), **bounds}
    log("sep kernel case " + json.dumps(case))
    return case


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from tpu_gaussians_torch.kernels import (
        binned, sorted_bwd, sorted_fwd, splat_sep, splat_v1, splat_v2, stage)

    for counts in (splat_sep.launches, splat_v2.launches, binned.launches,
                   splat_v1.launches, stage.launches):
        for k in counts:
            counts[k] = 0
    sorted_fwd.launches = sorted_bwd.launches = 0


def read_launches() -> dict:
    from tpu_gaussians_torch.utils.profiling import launch_counts

    return launch_counts()


def fit_phase(tmp: Path, name: str, extra_args, launches_expected: dict,
              expect_line: str = "") -> dict:
    """A training main path: cli.fit.main on the card with the flagship
    recipe plus `extra_args`, launch counters from 0 just before it and
    read just after; each kernel of `launches_expected` must have launched
    exactly that often and every other kernel never, and `expect_line`
    must be printed."""
    import numpy as np

    from tpu_gaussians_torch.cli import fit as fit_cli

    out_dir = tmp / name
    argv = [str(ROOT / a) if a.startswith("assets") else a
            for a in FIT_ARGS] + list(extra_args) + [
                "--out_dir", str(out_dir), "--device", "cuda"]
    reset_launches()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        fit_cli.main(argv)
    main_s = time.perf_counter() - t0
    launches = read_launches()
    text = printed.getvalue()
    log(text.rstrip())
    log(f"{name} main path: kernel launches {launches}")

    losses = [float(x) for x in
              (out_dir / "loss.txt").read_text().splitlines()]
    metrics = [json.loads(line) for line in
               (out_dir / "metrics.jsonl").read_text().splitlines()]
    n_alive = [m["n_alive"] for m in metrics]
    check(len(losses) == 150, f"{name}: loss.txt has {len(losses)} lines")
    check(bool(np.isfinite(losses).all()) and losses[-1] < 0.5 * losses[0],
          f"{name}: loss went {losses[0]} -> {losses[-1]}: not under half")
    check(n_alive[80] > n_alive[79], f"{name}: N did not grow at iteration "
          f"80 ({n_alive[79]} -> {n_alive[80]})")
    for artifact in ("gaussians_fitted.npz", "loss.txt", "metrics.jsonl",
                     "preview_view0.png"):
        check((out_dir / artifact).stat().st_size > 0,
              f"{name} wrote no {artifact}")
    want = {k: launches_expected.get(k, 0) for k in launches}
    check(launches == want, f"{name}: kernel launches {launches} in a "
          f"150-step fit, expected exactly {want}")
    check(expect_line in text, f"{name} did not print {expect_line!r}")
    loop_s = float(text.split("Done in ")[1].split("s.")[0])
    views, pix = 6, 128 * 128
    out = {"iters": 150, "main_wall_s": main_s, "fit_loop_wall_s": loop_s,
           "steps_per_s": 150 / loop_s,
           "mpix_per_s": views * pix * 150 / loop_s / 1e6,
           "loss_first": losses[0], "loss_last": losses[-1],
           "n_first": n_alive[0], "n_last": n_alive[-1],
           "binner_dropped_pairs_max": max(
               m["binner_dropped_pairs"] for m in metrics),
           "launches": launches}
    if "sorted pair budget k=" in text:
        out["pair_k"] = int(text.split("sorted pair budget k=")[1].split()[0])
    log(f"{name} " + json.dumps(out))
    return out


def train_steps(raw, cameras, targets, masks, steps: int, profile: int,
                render_config):
    """`steps` train steps rendering with `render_config` (its width and
    height are the targets'), timed with CUDA events (median and mean ms),
    then a profile of `profile` more."""
    import torch

    from tpu_gaussians_torch.fit.loss import LossConfig
    from tpu_gaussians_torch.fit.step import (
        init_state, make_optimizer, make_train_step)

    height, width = targets.shape[1:3]
    state = init_state(raw, make_optimizer(0.02))
    step = make_train_step(render_config.replace(width=width, height=height,
                                                 return_aux=True),
                           LossConfig(), masks is not None, False)
    zeros = torch.zeros_like(targets[..., 0])
    m = zeros if masks is None else masks

    def one(_):
        step(state, cameras, targets, m, zeros)

    one(0)
    times = []
    for i in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        one(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    prof = profile_calls(one, profile)
    times.sort()
    return {"steps": steps, "mode": render_config.mode,
            "footprint": render_config.footprint,
            "step_ms_median": times[len(times) // 2],
            "step_ms_mean": sum(times) / steps,
            "views": cameras.num_views(), "width": width, "height": height,
            "capacity": raw.capacity, "profile": prof}, state


def sorted_bwd_case(name: str, g, view, proj, width: int, height: int,
                    footprint: str, pair_k: int, seed: int,
                    reps: int = 20) -> dict:
    """K4 against its plain twin on one view's compositing inputs (the
    binner's lists, K3's acc and chunks_done, a seeded N(0,1) cotangent):
    error, determinism, its walk counter (a launch under a profiler: the
    same rows, and the counter equal to the CPU mirror,
    `sorted_bwd.walk_counts` on host copies of the lists), CUDA-event and
    torch.profiler times, and bounds: every composited (slot, pixel) pair
    at K4's operations (bound_ms) and the live ones (live_bound_ms, at the
    SM clock read while K4 runs). K3 is held against its twin and itself
    on the same lists first (sorted_fwd_check), and timed there (CUDA
    events, and its kernel alone by torch.profiler) beside its bounds on
    those lists (sorted_fwd_bound, sorted_fwd_live_bound). Raises on a
    disagreement."""
    import torch

    from tpu_gaussians_torch.kernels import sorted_bwd, sorted_fwd
    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.ops.binning import EXIT_T, NBS, TPS
    from tpu_gaussians_torch.ops.common import prepare_splats
    from tpu_gaussians_torch.ops.projection import camera_z
    from tpu_gaussians_torch.utils import profiling

    axis = footprint == "axis"
    with torch.no_grad():
        s = prepare_splats(g, view, proj, width, height, footprint=footprint)
        gdense, cnt, tiles_x, tiles_y, stats = tiled.tile_lists(
            s, camera_z(g.means, view), height, width, 0, pair_k)
        del s
        acc, chunks, k3_err, k3_differ, k3_blocks = sorted_fwd_check(
            name, gdense, cnt, tiles_x, tiles_y, height, width, axis, EXIT_T)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g8 = torch.randn(acc.shape, generator=gen, device="cuda")
        args = (gdense, cnt, acc, g8, chunks, tiles_x, axis)
        out = sorted_bwd.sorted_bwd(*args)
        again = sorted_bwd.sorted_bwd(*args)
        ref = sorted_bwd.sorted_bwd_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite K4 rows")
        check(bool(torch.equal(out, again)), f"{name}: K4 not deterministic")
        scale = ref.abs().amax(dim=0)
        bad = (out - ref).abs() > 2e-3 * ref.abs() + 2e-4 * scale
        err = float((out - ref).abs().max())
        check(not bool(bad.any()),
              f"{name}: K4 disagrees with its twin in {int(bad.sum())} "
              f"values (max abs err {err})")
        del again, ref, bad
        before = len(profiling.counters())
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            counted = sorted_bwd.sorted_bwd(*args)
            torch.cuda.synchronize()
        records = profiling.counters()[before:]
        check([r.name for r in records] == ["gs.composite.bwd.walks"],
              f"{name}: K4 under a profiler recorded "
              f"{[r.name for r in records]}")
        check(bool(torch.equal(counted, out)),
              f"{name}: K4 with its walk counter gives other rows")
        del counted, out
        walked, unculled = records[0].value.tolist()
        mirror = sorted_bwd.walk_counts(gdense.cpu(), cnt.cpu(),
                                        chunks.cpu(), tiles_x, axis)
        check((walked, unculled) == mirror,
              f"{name}: K4's walk counter {(walked, unculled)}, the CPU "
              f"mirror's {mirror}")

        def k4():
            return sorted_bwd.sorted_bwd(*args)
        k_ms = time_ms(k4, reps)
        device_ms, traced = kernel_device(k4, reps, "sorted_bwd_kernel")
        k4_mhz = clock_while(k4, k_ms)
        p_ms = time_ms(lambda: sorted_bwd.sorted_bwd_plain(*args), 5, 1)
        blocks = launched_blocks(k4, "sorted_bwd_kernel")
        slots = int(torch.minimum(cnt, chunks * NBS).sum())

        def k3():
            return sorted_fwd.sorted_tiles(gdense, cnt, tiles_x, axis=axis,
                                           exit_t=EXIT_T)
        k3_times = {
            "sorted_fwd_ms": time_ms(k3, reps),
            "sorted_fwd_plain_ms": time_ms(
                lambda: sorted_fwd.sorted_tiles_plain(
                    gdense, cnt, tiles_x, axis=axis, exit_t=EXIT_T), 5, 1),
            "sorted_fwd_blocks": k3_blocks}
        (k3_times["sorted_fwd_device_ms"],
         k3_times["sorted_fwd_device_launches_traced"]) = kernel_device(
             k3, reps)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        k3_live = sorted_fwd_live_bound(gdense, cnt, chunks, tiles_x,
                                        footprint, sms, sorted_fwd_clock(k3))
    k3_bound = {f"sorted_fwd_{k}": v for k, v in {
        **sorted_fwd_bound(cnt, chunks, footprint), **k3_live}.items()}
    # The least the card could take: the (slot, pixel) pairs the tiles
    # composited at K4's operations each (bound_ms), or the live ones
    # (live_bound_ms; K3's count on the same lists and chunks), against the
    # composited slots, acc, g8, cnt and chunks_done read once and the rows
    # written once.
    n_tiles = cnt.shape[0]
    nbytes = (slots * 64 + 2 * 8 * 4 * n_tiles * TPS + 2 * 4 * n_tiles
              + gdense.numel() * 4)
    ops_ms = 1e3 * SORTED_BWD_FLOPS_PER_EVAL[footprint] * slots * TPS / (
        F32_FLOPS_PER_S)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    live = sorted_bwd_live_bound(k3_live["live_pairs"], nbytes, footprint,
                                 sms, k4_mhz)
    check(blocks > n_tiles, f"{name}: K4 launched {blocks} blocks for "
          f"{n_tiles} tiles")
    case = {"case": name, "footprint": footprint, "pair_k": pair_k,
            "width": width, "height": height,
            "tiles": n_tiles, "blocks": blocks,
            "blocks_per_tile": blocks / n_tiles,     # K4's cluster size
            "cap": gdense.shape[0] // n_tiles,
            "slots_listed": int(cnt.sum()), "slots_composited": slots,
            "walked": walked, "walks_unculled": unculled,
            "walked_share": walked / unculled if unculled else None,
            "max_abs_err": err, "max_abs_ref": float(scale.max()),
            "ms": k_ms, "device_ms": device_ms,
            "device_launches_traced": traced, "plain_ms": p_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_share": max(ops_ms, bytes_ms) / device_ms,
            "composited_pairs": slots * TPS,
            "live_pairs": k3_live["live_pairs"], **live,
            "live_bound_share": live["live_bound_ms"] / device_ms,
            "sorted_fwd_max_abs_err": k3_err,
            "sorted_fwd_tiles_exit_differs": k3_differ, **k3_times,
            **k3_bound,
            "stats": {k: int(v) for k, v in stats.items()}}
    log("sorted bwd case " + json.dumps(case))
    return case


def fit_cell_view0(seed: int):
    """(g, view, proj, width, height, pair_k): the benchmark's fit cell
    (`fit_100k_ewa_sorted_1080p`: 100k EWA SH3 gaussians at 1920x1080,
    seeded quaternions) from gsbench's own inputs at `seed`, as its first
    step starts, pool view 0, and the pair budget `auto_pair_k` gives over
    its pool."""
    import torch

    from gsbench import harness
    from tpu_gaussians_torch.models.gaussian_model import RawParams, activate
    from tpu_gaussians_torch.ops import sorted as tiled

    cell = harness.find_cell(ROOT, "fit_100k_ewa_sorted_1080p")
    width, height = cell["traffic"]["width"], cell["traffic"]["height"]
    raw0, views, proj, _, _ = harness.traffic_kind(ROOT, "fit").inputs(
        cell, seed, torch.device("cuda"))
    n = raw0["means"].shape[0]
    g = activate(RawParams(alive=torch.ones((n,), device="cuda"), **raw0))
    pair_k = tiled.auto_pair_k(g, views, proj.expand(views.shape[0], 4, 4),
                               width, height, footprint="ewa")
    return g, views[0], proj, width, height, pair_k


def v2_case(name: str, g, view, proj, width: int, height: int, seed: int,
            reps: int = 20) -> dict:
    """K5, and K6 on a seeded N(0,1) cotangent (zero beyond the frame and in
    rows 5-7, as the backward stages it), against their plain twins on one
    view's EWA accumulation inputs, staged by the render path's own
    ops/splat staging: errors, both kernels' determinism, CUDA-event
    times, K5's range slices and K6's pixel slices, each one's device ms
    per call (its main kernel and slice sum apart), and bounds
    (v2_fwd_bound and v2_bwd_bound, each at the SM clock read while it
    runs). Raises on a disagreement."""
    import torch

    from tpu_gaussians_torch.kernels import splat_v2
    from tpu_gaussians_torch.ops import splat
    from tpu_gaussians_torch.ops.common import prepare_splats

    hw = width * height
    with torch.no_grad():
        s = prepare_splats(g, view, proj, width, height, footprint="ewa")
        lo, cnt, gdata, nb, hw_pad = splat._v2_prep(splat.y_sorted(s),
                                                    height, width)
        args = (lo, cnt, gdata, hw_pad, width, nb)
        acc = splat_v2.splat_v2_fwd(*args)
        acc_again = splat_v2.splat_v2_fwd(*args)
        ref = splat_v2.v2_fwd_plain(*args)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g8 = torch.zeros((8, hw_pad), device="cuda")
        g8[:5, :hw] = torch.randn((5, hw), generator=gen, device="cuda")
        bargs = (lo, cnt, gdata, g8, hw_pad, width, nb)
        out = splat_v2.splat_v2_bwd(*bargs)
        again = splat_v2.splat_v2_bwd(*bargs)
        ref_b = splat_v2.v2_bwd_plain(*bargs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(acc).all()), f"{name}: non-finite K5 sums")
        check(bool(torch.equal(acc, acc_again)),
              f"{name}: K5 not deterministic")
        del acc_again
        err = float((acc - ref).abs().max())
        check(bool(torch.allclose(acc, ref, rtol=1e-5, atol=1e-5)),
              f"{name}: K5 disagrees with its twin (max abs err {err})")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite K6 rows")
        check(bool(torch.equal(out, again)), f"{name}: K6 not deterministic")
        scale = torch.clamp(ref_b.abs().amax(dim=0), min=1.0)
        bad = (out - ref_b).abs() > 2e-4 * ref_b.abs() + 2e-5 * scale
        err_b = float((out - ref_b).abs().max())
        check(not bool(bad.any()),
              f"{name}: K6 disagrees with its twin in {int(bad.sum())} "
              f"values (max abs err {err_b})")
        k_ms = time_ms(lambda: splat_v2.splat_v2_fwd(*args), reps)
        p_ms = time_ms(lambda: splat_v2.v2_fwd_plain(*args), 5, 1)
        fprof = profile_calls(lambda i: splat_v2.splat_v2_fwd(*args), reps)
        fparts = device_split(fprof, "splat_v2_fwd_kernel",
                              "splat_v2_fwd_sum_kernel")
        fmhz = clock_while(lambda: splat_v2.splat_v2_fwd(*args), k_ms)
        kb_ms = time_ms(lambda: splat_v2.splat_v2_bwd(*bargs), reps)
        pb_ms = time_ms(lambda: splat_v2.v2_bwd_plain(*bargs), 5, 1)
        prof = profile_calls(lambda i: splat_v2.splat_v2_bwd(*bargs), reps)
        parts = device_split(prof, "splat_v2_bwd_kernel", "segment_sum_kernel")
        mhz = clock_while(lambda: splat_v2.splat_v2_bwd(*bargs), kb_ms)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
    # The least the card could take, for the (gaussian, pixel) pairs that
    # need evaluating (v2_alive_pairs). pairs_evaluated is what the kernels
    # run: every row of the range (padding and dead capacity rows included)
    # on every pixel of the band.
    pairs = int(cnt.to(torch.int64).sum()) * nb * splat_v2.TP2
    fwd = v2_fwd_bound(lo, cnt, gdata, nb, hw, hw_pad, sms, fmhz)
    case = {"case": name, "n_pad": gdata.shape[0], "nb": nb,
            "width": width, "height": height, "bands": lo.shape[0],
            "pairs_evaluated": pairs, "alive_pairs": fwd.pop("alive_pairs"),
            "alive": int((gdata[:, 5] > 0).sum()), "max_abs_err": err,
            "max_abs_ref": float(ref.abs().max()),
            "ms": k_ms, "plain_ms": p_ms,
            "slices": splat_v2.fwd_slices(lo.shape[0], gdata.shape[0],
                                          gdata.device),
            "device_ms": fprof["device_busy_ms_per_call"],
            "device_ms_main": fparts["main"],
            "device_ms_slice_sum": fparts["second"],
            "bwd_max_abs_err": err_b,
            "bwd_max_abs_ref": float(ref_b.abs().max()),
            "bwd_ms": kb_ms, "bwd_plain_ms": pb_ms,
            "bwd_slices": splat_v2.bwd_slices(gdata.shape[0], gdata.device),
            "bwd_device_ms": prof["device_busy_ms_per_call"],
            "bwd_device_ms_main": parts["main"],
            "bwd_device_ms_slice_sum": parts["second"], **fwd,
            **v2_bwd_bound(lo, cnt, gdata, nb, hw, hw_pad, sms, mhz)}
    log("v2 case " + json.dumps(case))
    return case


def binned_fwd_bound(cnt, cap: int, sms: int, mhz: float) -> dict:
    """K8a's bound on this card for the listed (live) slots of each tile
    times its 2048 pixels, for a kernel that runs its product on the tensor
    cores (csrc/binned_fwd.cu does, as the TPU did on its matrix unit): the
    largest of tensor_core_bound's terms at the SM clock `mhz`, against the
    listed slots (64 B) and cnt read once and the (8, tiles*2048) sums
    written once. The slice partials are K8a's design, not its function,
    and stay out of the bound: their bytes (each live slice's (8, 2048)
    plane written and read once) and their time at the memory rate are
    reported beside it. The 22-flop f32 figure beside it too; K8a's
    slices."""
    import torch

    from tpu_gaussians_torch.kernels import binned as KB
    from tpu_gaussians_torch.ops.binning import TPS

    n_tiles = cnt.shape[0]
    live_t = torch.clamp(cnt.to(torch.int64), 0, cap)
    pairs = int(live_t.sum()) * TPS
    length, slices = KB.fwd_slices(n_tiles, cap)
    live_slices = int(torch.clamp((live_t + length - 1) // length,
                                  min=1).sum())
    partial_bytes = 2 * live_slices * 8 * TPS * 4 if slices > 1 else 0
    nbytes = int(live_t.sum()) * 64 + n_tiles * 4 + 8 * 4 * n_tiles * TPS
    ms, term, terms = tensor_core_bound(
        pairs, BINNED_FWD_ELEMENTWISE_FLOPS_PER_PAIR,
        BINNED_FWD_PRODUCT_FLOPS_PER_PAIR, nbytes, sms, mhz)
    return {"fwd_bound_ms": ms,
            "fwd_bound_by": "bytes" if term == "bytes" else "operations",
            "fwd_bound_term": term, "fwd_bound_terms_ms": terms,
            "fwd_bound_ms_22flop": max(
                1e3 * BINNED_FWD_FLOPS_PER_PAIR * pairs / F32_FLOPS_PER_S,
                1e3 * nbytes / HBM_BYTES_PER_S),
            "fwd_sm_clock_mhz": mhz, "fwd_slice_len": length,
            "fwd_slices": slices, "fwd_live_slices": live_slices,
            "fwd_partial_bytes": partial_bytes,
            "fwd_partial_ms": 1e3 * partial_bytes / HBM_BYTES_PER_S}


def binned_bwd_bound(cnt, cap: int, sms: int, mhz: float) -> dict:
    """K8b's bound on this card for the listed (live) slots of each tile
    times its 2048 pixels, for a kernel that runs its two products on the
    tensor cores (csrc/binned_bwd.cu does, as the TPU did on its matrix
    unit): the largest of tensor_core_bound's terms at the SM clock `mhz`,
    against the listed slots (64 B), cnt and g8 (8, tiles*2048) read once
    and the (tiles*cap, 16) rows written once. K8b's per-pair function is
    K9b's, so its terms are K9b's per pair: the products' 32 flops and 11
    elementwise flops (the row terms paid once per slot and row, op
    factored out of every sum). The 44-flop f32 figure beside it; K8b's
    pixel slices, whose partials stay in shared memory (0 bytes beside the
    bound)."""
    import torch

    from tpu_gaussians_torch.kernels import binned as KB
    from tpu_gaussians_torch.ops.binning import TPS

    n_tiles = cnt.shape[0]
    live = int(torch.clamp(cnt.to(torch.int64), 0, cap).sum())
    pairs = live * TPS
    nbytes = (live * 64 + n_tiles * 4 + 8 * 4 * n_tiles * TPS
              + n_tiles * cap * 64)
    ms, term, terms = tensor_core_bound(
        pairs, V1_BWD_ELEMENTWISE_FLOPS_PER_PAIR,
        V1_BWD_PRODUCT_FLOPS_PER_PAIR, nbytes, sms, mhz)
    return {"bwd_bound_ms": ms,
            "bwd_bound_by": "bytes" if term == "bytes" else "operations",
            "bwd_bound_term": term, "bwd_bound_terms_ms": terms,
            "bwd_bound_ms_44flop": max(
                1e3 * BINNED_BWD_FLOPS_PER_PAIR * pairs / F32_FLOPS_PER_S,
                1e3 * nbytes / HBM_BYTES_PER_S),
            "bwd_sm_clock_mhz": mhz,
            "bwd_pixel_slices": KB.bwd_pixel_slices(n_tiles, cap),
            "bwd_partial_bytes": 0, "bwd_partial_ms": 0.0}


def binned_sep_fwd_bound(cnt, cap: int, sms: int, mhz: float) -> dict:
    """K7a's bound on this card for the listed (live) slots of each tile,
    for a kernel that runs its product on the tensor cores
    (csrc/binned_sep_fwd.cu does, as the TPU did on its matrix unit): the
    largest of tensor_core_bound's terms at the SM clock `mhz`. Per slot
    and tile the product is BINNED_SEP_FWD_FLOPS_PER_PAIR per pixel (priced
    x3, the TF32 split); G2 = featsop x Ey takes 8 multiplies a row at the
    f32 rate; one exp per row and per column; against the listed slots (64
    B) and cnt read once and the (8, tiles*2048) sums written once. The
    operands' splits and the slice partials are K7a's design, not its
    function, and stay out of the bound: the partials' bytes (each live
    slice's (8, 2048) plane written and read once) and their time at the
    memory rate are reported beside it. The 16-flop f32 figure beside it
    too; K7a's slices."""
    import torch

    from tpu_gaussians_torch.kernels import binned as KB
    from tpu_gaussians_torch.ops.binning import TH, TPS, TWC

    n_tiles = cnt.shape[0]
    live_t = torch.clamp(cnt.to(torch.int64), 0, cap)
    live = int(live_t.sum())
    length, slices = KB.fwd_slices(n_tiles, cap, "binned_sep_fwd")
    live_slices = int(torch.clamp((live_t + length - 1) // length,
                                  min=1).sum())
    partial_bytes = 2 * live_slices * 8 * TPS * 4 if slices > 1 else 0
    nbytes = live * 64 + n_tiles * 4 + 8 * 4 * n_tiles * TPS
    ms, term, terms = tensor_core_bound(
        live, BINNED_SEP_FWD_ELEMENTWISE_FLOPS_PER_ROW * TH,
        BINNED_SEP_FWD_FLOPS_PER_PAIR * TPS, nbytes, sms, mhz,
        exps=TH + TWC)
    return {"fwd_bound_ms": ms,
            "fwd_bound_by": "bytes" if term == "bytes" else "operations",
            "fwd_bound_term": term, "fwd_bound_terms_ms": terms,
            "fwd_bound_ms_f32": max(
                1e3 * BINNED_SEP_FWD_FLOPS_PER_PAIR * live * TPS
                / F32_FLOPS_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S),
            "fwd_sm_clock_mhz": mhz, "fwd_slice_len": length,
            "fwd_slices": slices, "fwd_live_slices": live_slices,
            "fwd_partial_bytes": partial_bytes,
            "fwd_partial_ms": 1e3 * partial_bytes / HBM_BYTES_PER_S}


def binned_sep_bwd_bound(cnt, cap: int, sms: int, mhz: float) -> dict:
    """K7b's bound on this card for the listed (live) slots of each tile,
    for a kernel that runs both products on the tensor cores
    (csrc/binned_sep_bwd.cu does, as the TPU did on its matrix unit): the
    largest of tensor_core_bound's terms at the SM clock `mhz`. Per slot
    and tile the products are BINNED_SEP_BWD_FLOPS_PER_PAIR per pixel
    (priced x3, the TF32 split); the f32 work beside them
    BINNED_SEP_BWD_ELEMENTWISE_FLOPS_PER_ROW a tile row and _PER_COLUMN a
    column; one exp per row and per column; against the listed slots
    (64 B), cnt and g8 (8, tiles*2048) read once and the (tiles*cap, 16)
    rows written once. The operands' splits, the re-reads of g8 (once a
    block) and the dead slots of the processed chunks are K7b's design or
    the contract's, not the function's, and stay out of the bound. The
    32-flop f32 figure beside it; K7b's column slices."""
    import torch

    from tpu_gaussians_torch.kernels import binned as KB
    from tpu_gaussians_torch.ops.binning import TH, TPS, TWC

    n_tiles = cnt.shape[0]
    live = int(torch.clamp(cnt.to(torch.int64), 0, cap).sum())
    nbytes = (live * 64 + n_tiles * 4 + 8 * 4 * n_tiles * TPS
              + n_tiles * cap * 64)
    ms, term, terms = tensor_core_bound(
        live, BINNED_SEP_BWD_ELEMENTWISE_FLOPS_PER_ROW * TH
        + BINNED_SEP_BWD_ELEMENTWISE_FLOPS_PER_COLUMN * TWC,
        BINNED_SEP_BWD_FLOPS_PER_PAIR * TPS, nbytes, sms, mhz,
        exps=TH + TWC)
    return {"bwd_bound_ms": ms,
            "bwd_bound_by": "bytes" if term == "bytes" else "operations",
            "bwd_bound_term": term, "bwd_bound_terms_ms": terms,
            "bwd_bound_ms_f32": max(
                1e3 * BINNED_SEP_BWD_FLOPS_PER_PAIR * live * TPS
                / F32_FLOPS_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S),
            "bwd_sm_clock_mhz": mhz,
            "bwd_col_slices": KB.bwd_col_slices(n_tiles, cap)}


def binned_sep_library_product(gdense, cnt, tiles_x: int, acc, g8,
                               reps: int) -> dict:
    """K7a's product and K7b's two alone through cuBLAS: the factors G2
    (tiles, 8*16, K) and Ex (tiles, K, 128) of every tile's first K slots
    (K: the longest list, rounded up to 64; dead slots add zeros) formed
    beforehand by the twin's own arithmetic, then in f32 (TF32 off) K7a's
    one torch.bmm (G2 . Ex) and K7b's two (Ex . gband^T and G2^T . gband,
    gband the tile's (8*16, 128) cotangent). Yardsticks of the products'
    time, not of the functions' (the factors' exps and K7b's moments are
    outside them); the port never calls them. -> {fwd_library_ms,
    fwd_library_max_abs_diff (from K7a's sums), bwd_library_ms}, medians
    of `reps`."""
    import torch

    from tpu_gaussians_torch.kernels import binned as KB
    from tpu_gaussians_torch.ops.binning import TPS

    n_tiles = cnt.shape[0]
    cap = gdense.shape[0] // n_tiles
    k = min(cap, max(64, -(-int(cnt.max()) // 64) * 64))
    xc, yr = KB._tile_axes(n_tiles, tiles_x, gdense.device)
    _, ex, _, ey, fo = KB._sep_factors(
        gdense.reshape(n_tiles, cap, 16)[:, :k], xc, yr)
    g2 = (fo[..., :, None] * ey[..., None, :]).flatten(2).transpose(
        1, 2).contiguous()                                   # (T, 128, K)
    del ey, fo
    ms = time_ms(lambda: torch.bmm(g2, ex), reps)
    prod = torch.bmm(g2, ex).reshape(n_tiles, 8, TPS)
    ref = acc.reshape(8, n_tiles, TPS).permute(1, 0, 2)
    err = float((prod - ref).abs().max())
    del prod
    gband = g8.reshape(8, n_tiles, TPS).permute(1, 0, 2).reshape(
        n_tiles, 8 * TPS // 128, 128).contiguous()         # (T, 128, 128)

    def bwd_products():
        return (torch.bmm(ex, gband.transpose(1, 2)),
                torch.bmm(g2.transpose(1, 2), gband))
    bwd_ms = time_ms(bwd_products, reps)
    del g2, ex, gband
    return {"fwd_library_ms": ms, "fwd_library_max_abs_diff": err,
            "bwd_library_ms": bwd_ms}


def ptxas_lines(name: str) -> list:
    """ptxas' register and spill lines of kernel `name`'s build in this
    process (kernels/build.logs)."""
    from tpu_gaussians_torch.kernels import build

    return [line.strip() for line in build.logs.get(name, "").splitlines()
            if "registers" in line or "spill" in line]


def device_split(prof: dict, main: str, second: str) -> dict:
    """A two-kernel wrapper's device ms per call from profile_calls' rows:
    the kernel whose name holds `main`, and the one whose name holds
    `second`; and the main kernel's launches per call that the trace
    holds (1 for a wrapper that launches it once, unless the profiler lost
    events)."""
    return {"main": sum(r["ms_per_call"] for r in prof["top"]
                        if main in r["kernel"]),
            "second": sum(r["ms_per_call"] for r in prof["top"]
                          if second in r["kernel"]),
            "main_launches": sum(r["calls_per_call"] for r in prof["top"]
                                 if main in r["kernel"])}


def binned_case(name: str, g, view, proj, width: int, height: int,
                seed: int, reps: int = 20, footprint: str = "ewa") -> dict:
    """K8a, then K8b on a seeded N(0,1) cotangent of K8a's output (for the
    axis footprint the separable K7a and K7b), against their plain twins on
    one view's lists, built by the training path's own
    ops/binned.accum_lists: errors, both directions' determinism, CUDA-event
    times, the binner's stats and the live slots. For the forward also its
    device time split between its main kernel and its slice sum, with the
    launches the trace kept, and its bound on the tensor-core terms
    (binned_fwd_bound, binned_sep_fwd_bound); for the backward its device
    time (its one kernel apart from any other row) and its bound on the
    tensor-core terms (binned_bwd_bound, binned_sep_bwd_bound), with the SM
    clock read while each runs. For K7a and K7b also their products alone
    through cuBLAS. Raises on a disagreement."""
    import torch

    from tpu_gaussians_torch.kernels import binned as KB
    from tpu_gaussians_torch.ops.binned import accum_lists
    from tpu_gaussians_torch.ops.binning import NBS
    from tpu_gaussians_torch.ops.common import prepare_splats

    if footprint == "axis":
        ids, names, fwd, fwd_plain, bwd, bwd_plain = (
            ("K7a", "K7b"), ("binned_sep_fwd", "binned_sep_bwd"),
            KB.binned_sep_fwd, KB.binned_sep_fwd_plain, KB.binned_sep_bwd,
            KB.binned_sep_bwd_plain)
        bounds_fb = (binned_sep_fwd_bound, binned_sep_bwd_bound)
    else:
        ids, names, fwd, fwd_plain, bwd, bwd_plain = (
            ("K8a", "K8b"), ("binned_fwd", "binned_bwd"), KB.binned_fwd,
            KB.binned_fwd_plain, KB.binned_bwd, KB.binned_bwd_plain)
        bounds_fb = (binned_fwd_bound, binned_bwd_bound)
    with torch.no_grad():
        s = prepare_splats(g, view, proj, width, height, footprint=footprint)
        gdense, cnt, tiles_x, _, stats = accum_lists(s, height, width)
        acc = fwd(gdense, cnt, tiles_x)
        acc_again = fwd(gdense, cnt, tiles_x)
        ref = fwd_plain(gdense, cnt, tiles_x)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g8 = torch.randn(acc.shape, generator=gen, device="cuda")
        out = bwd(gdense, cnt, g8, tiles_x)
        again = bwd(gdense, cnt, g8, tiles_x)
        ref_b = bwd_plain(gdense, cnt, g8, tiles_x)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(acc).all() and torch.isfinite(out).all()),
              f"{name}: non-finite {ids} output")
        err_f = float((acc - ref).abs().max())
        check(bool(torch.allclose(acc, ref, rtol=1e-5, atol=1e-5)),
              f"{name}: {ids[0]} disagrees with its twin (max abs err "
              f"{err_f})")
        check(bool(torch.equal(out, again)),
              f"{name}: {ids[1]} not deterministic")
        check(bool(torch.equal(acc, acc_again)),
              f"{name}: {ids[0]} not deterministic")
        del acc_again
        scale = torch.clamp(ref_b.abs().amax(dim=0), min=1.0)
        bad = (out - ref_b).abs() > 2e-4 * ref_b.abs() + 2e-5 * scale
        err_b = float((out - ref_b).abs().max())
        check(not bool(bad.any()),
              f"{name}: {ids[1]} disagrees with its twin in "
              f"{int(bad.sum())} values (max abs err {err_b})")
        times = {
            "fwd_ms": time_ms(lambda: fwd(gdense, cnt, tiles_x), reps),
            "fwd_plain_ms": time_ms(lambda: fwd_plain(gdense, cnt, tiles_x),
                                    5, 1),
            "bwd_ms": time_ms(lambda: bwd(gdense, cnt, g8, tiles_x), reps),
            "bwd_plain_ms": time_ms(lambda: bwd_plain(gdense, cnt, g8,
                                                      tiles_x), 5, 1),
        }
        # Each direction's kernels alone per call (torch.profiler): the
        # event time above also holds the wrapper's host work. The forward's
        # main kernel and its slice sum apart, the backward's one kernel
        # apart from any second pass, each with the launches of its main
        # kernel that the trace kept (the profiler drops some late in the
        # run). Then the SM clock while each runs (launches queued for
        # about 0.3 s).
        mhz = {}
        for kind, kname, fn in (
                ("fwd", names[0], lambda: fwd(gdense, cnt, tiles_x)),
                ("bwd", names[1], lambda: bwd(gdense, cnt, g8, tiles_x))):
            prof = profile_calls(lambda i: fn(), reps)
            split = device_split(prof, f"{kname}_kernel", "slice_sum_kernel")
            second = "slice_sum" if kind == "fwd" else "second_pass"
            times.update({
                f"{kind}_device_ms": prof["device_busy_ms_per_call"],
                f"{kind}_device_ms_main": split["main"],
                f"{kind}_device_ms_{second}": split["second"],
                f"{kind}_device_launches_traced": split["main_launches"],
                f"{kind}_device_ms_per_launch": split["main"] / max(
                    split["main_launches"], 1e-9)})
            for _ in range(max(1, int(300 / max(times[f"{kind}_ms"],
                                                1e-3)))):
                fn()
            mhz[kind] = sm_clock_mhz()
            torch.cuda.synchronize()
        library = (binned_sep_library_product(gdense, cnt, tiles_x, acc, g8,
                                              reps)
                   if footprint == "axis" else {})
    # The least the card could take: the listed (live) slots of each tile
    # times its 2048 pixels, on the tensor-core terms of the bound
    # functions above. slots_processed is what the twins run: whole
    # 512-slot chunks.
    n_tiles = cnt.shape[0]
    cap = gdense.shape[0] // n_tiles
    live = int(cnt.to(torch.int64).sum())
    processed = int(torch.clamp((cnt.to(torch.int64) + NBS - 1) // NBS * NBS,
                                max=cap).sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bounds = {**bounds_fb[0](cnt, cap, sms, mhz["fwd"]),
              **bounds_fb[1](cnt, cap, sms, mhz["bwd"])}
    case = {"case": name, "footprint": footprint, "n": g.capacity,
            "width": width, "height": height,
            "tiles": n_tiles, "cap": cap, "slots_live": live,
            "slots_processed": processed, "max_cnt": int(cnt.max()),
            "fwd_max_abs_err": err_f, "fwd_max_abs_ref": float(
                ref.abs().max()), "bwd_max_abs_err": err_b,
            "bwd_max_abs_ref": float(ref_b.abs().max()),
            "stats": {k: int(v) for k, v in stats.items()},
            **times, **library, **bounds}
    log("binned case " + json.dumps(case))
    return case


def v1_case(name: str, g, view, proj, width: int, height: int, seed: int,
            reps: int = 20, plain_reps: int = 5, dense: bool = False) -> dict:
    """K9a, and K9b on a seeded N(0,1) cotangent (zero beyond the frame and
    in rows 5-7, as the backward stages it), against their plain twins on
    one view's EWA accumulation inputs, staged by the render path's own
    ops/splat._v1_prep: errors, K9b's determinism, CUDA-event times and
    bounds. With dense, also the band route on the same view: K9a's sums
    against K5's (rtol 1e-4 / atol 1e-5), and splat_accumulate's values and
    gradients with both directions on the tile grid against both on the
    bands (K6 and its post-pass) at the sorted-gradient tolerance (rtol
    2e-3, atol 2e-4 times the largest magnitude). Without dense (a size the
    route sends to the tile grid), K5 and K6 are timed on the same view
    and cotangent instead, and K5's largest difference from K9a's sums is
    reported, not checked: the route never takes the bands there. Raises on
    a disagreement."""
    import torch

    from tpu_gaussians_torch.kernels import splat_v1
    from tpu_gaussians_torch.ops import splat
    from tpu_gaussians_torch.ops.common import prepare_splats

    hw = width * height
    with torch.no_grad():
        s = splat.y_sorted(prepare_splats(g, view, proj, width, height,
                                          footprint="ewa"))
        mask, gdata, nb, tp, hw_pad = splat._v1_prep(s, height, width)
        args = (mask, gdata, hw_pad, width, nb, tp)
        acc = splat_v1.splat_v1_fwd(*args)
        acc_again = splat_v1.splat_v1_fwd(*args)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g8 = torch.zeros((8, hw_pad), device="cuda")
        g8[:5, :hw] = torch.randn((5, hw), generator=gen, device="cuda")
        bargs = (mask, gdata, g8, hw_pad, width, nb, tp)
        out = splat_v1.splat_v1_bwd(*bargs)
        again = splat_v1.splat_v1_bwd(*bargs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(acc).all()), f"{name}: non-finite K9a sums")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite K9b rows")
        check(bool(torch.equal(acc, acc_again)),
              f"{name}: K9a not deterministic")
        check(bool(torch.equal(out, again)), f"{name}: K9b not deterministic")
        del acc_again
        # the twins without warm-up (at 1M a call takes seconds)
        ref, p_ms = timed(lambda: splat_v1.v1_fwd_plain(*args), plain_reps)
        err = float((acc - ref).abs().max())
        check(bool(torch.allclose(acc, ref, rtol=1e-5, atol=1e-5)),
              f"{name}: K9a disagrees with its twin (max abs err {err})")
        ref_b, pb_ms = timed(lambda: splat_v1.v1_bwd_plain(*bargs),
                             plain_reps)
        scale = torch.clamp(ref_b.abs().amax(dim=0), min=1.0)
        bad = (out - ref_b).abs() > 2e-4 * ref_b.abs() + 2e-5 * scale
        err_b = float((out - ref_b).abs().max())
        check(not bool(bad.any()),
              f"{name}: K9b disagrees with its twin in {int(bad.sum())} "
              f"values (max abs err {err_b})")
        del ref, ref_b
        k_ms = time_ms(lambda: splat_v1.splat_v1_fwd(*args), reps)
        kb_ms = time_ms(lambda: splat_v1.splat_v1_bwd(*bargs), reps)
        # The SM clock while each kernel runs (launches queued for about
        # 0.3 s).
        mhz = {"fwd": clock_while(lambda: splat_v1.splat_v1_fwd(*args), k_ms),
               "bwd": clock_while(lambda: splat_v1.splat_v1_bwd(*bargs),
                                  kb_ms)}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
    # The least the card could take: the (gaussian, pixel) pairs that need
    # evaluating -- each mask-active (tile, block) pair's live rows (op >
    # 0) times the tile's pixels inside the frame -- at K9a's (K9b's)
    # operations each, against gdata and the mask read once and the
    # (8, hw_pad) sums written once (K9b: g8 read once and the (n_pad, 16)
    # rows written once). pairs_evaluated is what the kernels run: every
    # row of each active block on every pixel of the tile.
    active = mask.to(torch.int64)
    alive_pairs = v1_live_pairs(mask, gdata, nb, tp, hw)
    pairs = int(active.sum()) * nb * tp
    in_bytes = gdata.numel() * 4 + mask.numel()
    bounds = {"sms": sms}
    # Each kernel's bound on this card, its products on the tensor cores:
    # the largest of its terms, the one that decides it named; the 26-
    # (55-) flop f32 figure, which prices the products at the CUDA-core
    # rate, kept beside it. The SM clock is the one read while it ran.
    nbytes = in_bytes + 8 * hw_pad * 4
    ms, term, terms = tensor_core_bound(
        alive_pairs, V1_FWD_ELEMENTWISE_FLOPS_PER_PAIR,
        V1_FWD_PRODUCT_FLOPS_PER_PAIR, nbytes, sms, mhz["fwd"])
    bounds.update({
        f"bound_ms_{V1_FWD_FLOPS_PER_PAIR}flop": max(
            1e3 * V1_FWD_FLOPS_PER_PAIR * alive_pairs / F32_FLOPS_PER_S,
            1e3 * nbytes / HBM_BYTES_PER_S),
        "bound_ms": ms, "bound_by": "bytes" if term == "bytes" else
        "operations", "bound_term": term, "bound_terms_ms": terms,
        "sm_clock_mhz": mhz["fwd"]})
    bounds.update({f"bwd_{k}": v for k, v in v1_bwd_bound(
        mask, gdata, nb, tp, hw, hw_pad, sms, mhz["bwd"]).items()
        if k != "alive_pairs"})
    case = {"case": name, "n_pad": gdata.shape[0], "nb": nb, "tp": tp,
            "width": width, "height": height, "tiles": mask.shape[0],
            "blocks": mask.shape[1], "active_pairs": int(active.sum()),
            "mask_density": float(active.sum()) / mask.numel(),
            "pairs_evaluated": pairs, "alive_pairs": alive_pairs,
            "max_abs_err": err, "max_abs_ref": float(acc.abs().max()),
            "ms": k_ms, "plain_ms": p_ms, "bwd_max_abs_err": err_b,
            "bwd_ms": kb_ms, "bwd_plain_ms": pb_ms, **bounds}
    if dense:
        case.update(v1_vs_v2(name, s, height, width, acc, seed))
    else:
        case.update(bands_timed(s, height, width, acc, g8, reps))
    log("v1 case " + json.dumps(case))
    return case


def bands_timed(s, height: int, width: int, acc_v1, g8, reps: int) -> dict:
    """K5 and K6 on the band staging of the same y-sorted splats and
    cotangent as a v1 case: CUDA-event medians, and K5's largest difference
    from K9a's sums (acc_v1)."""
    import torch

    from tpu_gaussians_torch.kernels import splat_v2
    from tpu_gaussians_torch.ops import splat

    hw = height * width
    with torch.no_grad():
        st = splat._v2_prep(s, height, width)
        check(st.hw_pad == g8.shape[1], "band and tile padding differ")
        args = (st.lo, st.cnt, st.gdata, st.hw_pad, width, st.nb)
        acc_v2 = splat_v2.splat_v2_fwd(*args)
        err = float((acc_v1[:, :hw] - acc_v2[:, :hw]).abs().max())
        k5_ms = time_ms(lambda: splat_v2.splat_v2_fwd(*args), reps, 1)
        bargs = (st.lo, st.cnt, st.gdata, g8, st.hw_pad, width, st.nb)
        k6_ms = time_ms(lambda: splat_v2.splat_v2_bwd(*bargs), reps, 1)
    return {"band_blocks_in_ranges": int(st.cnt.to(torch.int64).sum()),
            "k5_ms": k5_ms, "k6_ms": k6_ms, "k5_vs_k9a_max_abs_err": err}


def route_grads(s, height: int, width: int, g_out, max_n_pad):
    """splat_accumulate(axis=False)'s sums and the gradients of sum(acc *
    g_out) in px, py, conic_a, conic_b, conic_c, op and feats, with the
    route thresholds V2_MAX_N_PAD_{FWD,BWD} set to max_n_pad (fwd, bwd),
    or at their defaults for None."""
    from tpu_gaussians_torch.ops import splat

    saved = (splat.V2_MAX_N_PAD_FWD, splat.V2_MAX_N_PAD_BWD)
    if max_n_pad is not None:
        splat.V2_MAX_N_PAD_FWD, splat.V2_MAX_N_PAD_BWD = max_n_pad
    try:
        cols = [t.detach().clone().requires_grad_(True) for t in (
            s.px, s.py, s.conic_a, s.conic_b, s.conic_c, s.op_eff, s.feats)]
        acc = splat.splat_accumulate(splat._columns(*cols), height, width,
                                     axis=False)
        (acc * g_out).sum().backward()
    finally:
        splat.V2_MAX_N_PAD_FWD, splat.V2_MAX_N_PAD_BWD = saved
    return [acc.detach()] + [c.grad for c in cols]


def compare_routes(name: str, what: str, got, ref) -> dict:
    """route_grads' outputs against another route's: the sums at rtol 1e-4
    / atol 1e-5, the gradients at the sorted-gradient tolerance (rtol 2e-3,
    atol 2e-4 times the largest magnitude). Raises on a disagreement;
    returns each output's largest difference."""
    import torch

    errs = {}
    for k, a, b in zip(("acc", "px", "py", "conic_a", "conic_b", "conic_c",
                        "op", "feats"), got, ref):
        if k == "acc":
            ok = bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5))
        else:
            ok = bool(torch.allclose(a, b, rtol=2e-3,
                                     atol=2e-4 * float(b.abs().max())))
        errs[k] = float((a - b).abs().max())
        check(ok and bool(torch.isfinite(a).all()),
              f"{name}: {k} through {what} disagree (max abs err "
              f"{errs[k]}, scale {float(b.abs().max())})")
    return errs


def v1_vs_v2(name: str, s, height: int, width: int, acc_v1, seed: int):
    """The tile grid (K9a/K9b) against the bands (K5/K6 and the post-pass)
    on the same y-sorted splats: K9a's sums against K5's, then
    splat_accumulate(axis=False)'s values and gradients of sum(acc * g)
    with the route thresholds at 0 (both directions on the tile grid)
    against the defaults (both on the bands at this n)."""
    import torch

    from tpu_gaussians_torch.kernels import splat_v2
    from tpu_gaussians_torch.ops import splat

    hw = height * width
    n = s.px.shape[0]
    check(splat._choose_v2(n, False) and splat._choose_v2(n, True),
          f"{name}: {n} gaussians do not take the bands by default")
    with torch.no_grad():
        st = splat._v2_prep(s, height, width)
        acc_v2 = splat_v2.splat_v2_fwd(st.lo, st.cnt, st.gdata, st.hw_pad,
                                       width, st.nb)
    err_f = float((acc_v1[:, :hw] - acc_v2[:, :hw]).abs().max())
    check(bool(torch.allclose(acc_v1[:, :hw], acc_v2[:, :hw], rtol=1e-4,
                              atol=1e-5)),
          f"{name}: K9a and K5 disagree (max abs err {err_f})")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    g_out = torch.randn((hw, 5), generator=gen, device="cuda")
    errs = compare_routes(name, "K9a/K9b and through K5/K6",
                          route_grads(s, height, width, g_out, (0, 0)),
                          route_grads(s, height, width, g_out, None))
    return {"v1_vs_v2_fwd_max_abs_err": err_f,
            "v1_vs_v2_grad_max_abs_err": errs}


def mixed_route_check(name: str, g, view, proj, side: int, seed: int):
    """One view of a scene between JAX's two v2 sizes through the default
    route (K5 forward, K9b backward on a restaging of the saved columns)
    against both directions on the tile grid (K9a, K9b on the forward's
    staging): sums and gradients of sum(acc * g) at compare_routes'
    tolerances, and whether the gradients came out bit for bit equal (the
    same columns staged the same way for the same K9b). Then the bounds of
    the route's two kernels on this view: K5's on its band staging
    (v2_fwd_bound: its alive pairs from lo, cnt and gdata, no twin run) and
    K9b's on the restaging (v1_bwd_bound, on a seeded N(0,1) cotangent),
    each at the SM clock read while it runs and beside its CUDA-event time
    here, K5's with its slices."""
    import torch

    from tpu_gaussians_torch.kernels import splat_v1, splat_v2
    from tpu_gaussians_torch.ops import splat
    from tpu_gaussians_torch.ops.common import prepare_splats

    with torch.no_grad():
        s = splat.y_sorted(prepare_splats(g, view, proj, side, side,
                                          footprint="ewa"))
    n = s.px.shape[0]
    check(splat._choose_v2(n, False) and not splat._choose_v2(n, True),
          f"{name}: {n} gaussians do not take the mixed route")
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    g_out = torch.randn((side * side, 5), generator=gen, device="cuda")
    mixed = route_grads(s, side, side, g_out, None)
    tiles = route_grads(s, side, side, g_out, (0, 0))
    errs = compare_routes(name, "K5/K9b (restaged) and through K9a/K9b",
                          mixed, tiles)
    out = {"case": name, "n": n, "width": side, "height": side,
           "max_abs_err": errs,
           "grads_bit_identical": all(bool(torch.equal(a, b))
                                      for a, b in zip(mixed[1:], tiles[1:]))}
    del mixed, tiles
    hw = side * side
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with torch.no_grad():
        st = splat._v2_prep(s, side, side)
        args = (st.lo, st.cnt, st.gdata, st.hw_pad, side, st.nb)
        k5_ms = time_ms(lambda: splat_v2.splat_v2_fwd(*args), 3, 1)
        mhz = clock_while(lambda: splat_v2.splat_v2_fwd(*args), k5_ms)
        k5 = {"ms": k5_ms, "slices": splat_v2.fwd_slices(
                  st.lo.shape[0], st.gdata.shape[0], st.gdata.device),
              **v2_fwd_bound(st.lo, st.cnt, st.gdata, st.nb, hw, st.hw_pad,
                             sms, mhz)}
        del st, args
        st = splat._v1_prep(s, side, side)
        g8 = torch.zeros((8, st.hw_pad), device="cuda")
        g8[:5, :hw] = torch.randn((5, hw), generator=gen, device="cuda")
        bargs = (st.mask, st.gdata, g8, st.hw_pad, side, st.nb, st.tp)
        k9b_ms = time_ms(lambda: splat_v1.splat_v1_bwd(*bargs), 3, 1)
        mhz = clock_while(lambda: splat_v1.splat_v1_bwd(*bargs), k9b_ms)
        k9b = {"ms": k9b_ms, **v1_bwd_bound(st.mask, st.gdata, st.nb, st.tp,
                                            hw, st.hw_pad, sms, mhz)}
    out.update(k5=k5, k9b=k9b)
    log("mixed route " + json.dumps(out))
    return out


def binned_dense_check(name: str, g, c, side: int, footprint: str) -> dict:
    """One view at side x side through render(accum_binned="on": K8a, or
    K7a for the axis footprint) against render(accum_binned="off": K5, or
    K1). With nothing dropped (every overflow stat 0; the tile capacity
    raised to n if one is not) the image and alpha agree within rtol 1e-4 /
    atol 1e-5."""
    import torch

    from tpu_gaussians_torch.core.types import RenderConfig
    from tpu_gaussians_torch.ops.dispatch import render, render_accum

    n = g.capacity
    cfg = RenderConfig(width=side, height=side, mode="accum",
                       footprint=footprint, return_aux=True, impl="tiled")
    with torch.no_grad():
        first = {k: int(v) for k, v in render_accum(
            g, c.view, c.proj, cfg.replace(accum_binned="on"),
            return_stats=True)[3].items()}
        stats = first
        if stats["dropped_pairs"] or stats["full_tiles"]:
            cfg = cfg.replace(accum_tile_capacity=n)
            stats = {k: int(v) for k, v in render_accum(
                g, c.view, c.proj, cfg.replace(accum_binned="on"),
                return_stats=True)[3].items()}
        check(not any(stats.values()), f"{name}: the binner dropped work "
              f"({stats})")
        on = render(g, c, cfg.replace(accum_binned="on"))
        off = render(g, c, cfg.replace(accum_binned="off"))
    errs = []
    for a, b, what in zip(on[:2], off[:2], ("image", "alpha")):
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite {what}")
        errs.append(float((a - b).abs().max()))
        check(bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5)),
              f"{name}: {what} disagrees (max abs err {errs[-1]})")
    out = {"case": name, "footprint": footprint, "n": n, "side": side,
           "stats_default_capacity": first,
           "tile_capacity": cfg.accum_tile_capacity, "stats": stats,
           "image_max_abs_err": errs[0], "alpha_max_abs_err": errs[1]}
    log("binned vs dense " + json.dumps(out))
    return out


def rotmat_to_qvec(rot):
    """COLMAP's (w, x, y, z) quaternion of a rotation matrix (Shepperd's
    method through the symmetric 4x4 eigenproblem; w >= 0)."""
    import numpy as np

    r = rot
    k = np.array([
        [r[0, 0] - r[1, 1] - r[2, 2], r[1, 0] + r[0, 1],
         r[2, 0] + r[0, 2], r[2, 1] - r[1, 2]],
        [r[1, 0] + r[0, 1], r[1, 1] - r[0, 0] - r[2, 2],
         r[2, 1] + r[1, 2], r[0, 2] - r[2, 0]],
        [r[2, 0] + r[0, 2], r[2, 1] + r[1, 2],
         r[2, 2] - r[0, 0] - r[1, 1], r[1, 0] - r[0, 1]],
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
         r[1, 0] - r[0, 1], r[0, 0] + r[1, 1] + r[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    x, y, z, w = vecs[:, np.argmax(vals)]
    q = np.array([w, x, y, z])
    return q if w >= 0 else -q


def write_colmap_model(d: Path, views, width: int, height: int, fx: float,
                       fy: float, names, pts, rgb, binary: bool) -> None:
    """A COLMAP sparse model (one PINHOLE camera, an image per view, the
    points with their uint8 colours) in binary or text form. The views are
    OpenGL-style world->camera matrices; COLMAP's pose is their rows with
    y and z flipped (io/colmap.py's convention, inverted). Text floats are
    written with repr, so both forms hold the same doubles."""
    import struct

    import numpy as np

    flip = np.diag([1.0, -1.0, -1.0])
    images = []
    for i, (v, name) in enumerate(zip(views, names)):
        v = np.asarray(v, np.float64)
        images.append((i + 1, rotmat_to_qvec(flip @ v[:3, :3]),
                       flip @ v[:3, 3], name))
    intr = (fx, fy, width / 2.0, height / 2.0)
    d.mkdir(parents=True, exist_ok=True)
    if binary:
        with open(d / "cameras.bin", "wb") as f:
            f.write(struct.pack("<QiiQQ", 1, 1, 1, width, height))
            f.write(struct.pack("<4d", *intr))
        with open(d / "images.bin", "wb") as f:
            f.write(struct.pack("<Q", len(images)))
            for iid, q, t, name in images:
                f.write(struct.pack("<i4d3di", iid, *q, *t, 1))
                f.write(name.encode() + b"\x00" + struct.pack("<Q", 0))
        with open(d / "points3D.bin", "wb") as f:
            f.write(struct.pack("<Q", len(pts)))
            for k, (p, c) in enumerate(zip(pts, rgb)):
                f.write(struct.pack("<q3d3BdQ", k, *map(float, p),
                                    *map(int, c), 0.5, 0))
        return
    (d / "cameras.txt").write_text(
        "# Camera list\n1 PINHOLE %d %d %s\n"
        % (width, height, " ".join(repr(float(x)) for x in intr)))
    lines = ["# Image list"]
    for iid, q, t, name in images:
        lines += [" ".join([str(iid)] + [repr(float(x)) for x in (*q, *t)]
                           + ["1", name]), "1.0 2.0 -1"]
    (d / "images.txt").write_text("\n".join(lines) + "\n")
    (d / "points3D.txt").write_text("# 3D point list\n" + "".join(
        "%d %s %d %d %d 0.5\n" % (k, " ".join(repr(float(x)) for x in p),
                                  *map(int, c))
        for k, (p, c) in enumerate(zip(pts, rgb))))


def colmap_fit_run(tmp: Path, run: str, name: str, argv, steps: int):
    """One cli.fit.main run of the COLMAP workflow on the card, launch
    counters from 0 just before it and read just after: K1 6 times a step
    and once for the preview, K2 6 times a step, no other kernel. Returns
    (its timings, what it printed)."""
    from tpu_gaussians_torch.cli import fit as fit_cli

    reset_launches()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        fit_cli.main(argv + ["--out_dir", str(tmp / name), "--device",
                             "cuda"])
    main_s = time.perf_counter() - t0
    launches = read_launches()
    text = printed.getvalue()
    log(text.rstrip())
    want = {k: 0 for k in launches}
    want.update(splat_sep_fwd=6 * steps + 1, splat_sep_bwd=6 * steps,
                stage_fwd=6 * steps + 1, stage_bwd=6 * steps)
    check(launches == want, f"colmap_fit {run}: kernel launches "
          f"{launches} for {steps} steps, expected exactly {want}")
    loop_s = float(text.split("Done in ")[1].split("s.")[0])
    out = {"run": run, "out_dir": name, "steps": steps,
           "main_wall_s": main_s,
           "fit_loop_wall_s": loop_s, "steps_per_s": steps / loop_s,
           "launches": {k: v for k, v in launches.items() if v}}
    log("colmap_fit " + json.dumps(out))
    return out, text


def colmap_fit_phase(tmp: Path, g_fit, seed: int) -> None:
    """The COLMAP workflow at the flagship's width: a COLMAP model of the
    example scene's rig (PINHOLE, binary and text) with 800 SfM points
    sampled from phase 7's fitted centres; cli.import_colmap; three
    150-step fits from its init_points.npz (unbroken, interrupted at 50,
    resumed to 150), the resumed one held to the unbroken one; cli.eval on
    the card and through the twins on the host; cli.convert to ply and
    back, the ply evaluated and rendered against the fitted model."""
    import numpy as np
    import torch

    from tpu_gaussians_torch.cli import convert as convert_cli
    from tpu_gaussians_torch.cli import eval as eval_cli
    from tpu_gaussians_torch.cli import import_colmap as import_cli
    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import RenderConfig, to_device
    from tpu_gaussians_torch.fit.step import make_optimizer
    from tpu_gaussians_torch.io import image as im
    from tpu_gaussians_torch.io.checkpoint import STATE_FILE, Checkpointer
    from tpu_gaussians_torch.io.npz import load_gaussians_npz
    from tpu_gaussians_torch.io.ply import load_gaussians_ply
    from tpu_gaussians_torch.ops.dispatch import render

    d = tmp / "colmap"
    scene = ROOT / "assets" / "example_scene"
    rig = np.load(scene / "cameras.npz")
    names = [p.name for p in im.list_target_paths(scene)]
    side = 128
    # The rig's pinhole: m00 = 2 fx / w, m11 = 2 fy / h.
    fx = float(rig["proj"][0, 0, 0]) * side / 2.0
    fy = float(rig["proj"][0, 1, 1]) * side / 2.0
    alive = g_fit.alive_mask().cpu().numpy() > 0.5
    centres = g_fit.means.cpu().numpy()[alive]
    colours = np.clip(g_fit.sh[:, 0].cpu().numpy()[alive], 0, 1)
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(centres), 800, replace=False)
    extent = float(np.linalg.norm(centres.max(0) - centres.min(0)))
    pts = (centres[pick].astype(np.float64)
           + rng.normal(0.0, 0.02 * extent, (800, 3)))
    rgb = np.round(colours[pick] * 255).astype(np.uint8)
    for binary in (True, False):
        write_colmap_model(d / ("sparse_bin" if binary else "sparse_txt"),
                           rig["view"], side, side, fx, fy, names, pts, rgb,
                           binary)

    # 1. import: the binary model, then the text one
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        import_cli.main(["--colmap_dir", str(d / "sparse_bin"), "--out_dir",
                         str(d / "import_bin"), "--init_out", "--seed",
                         str(seed)])
    import_s = time.perf_counter() - t0
    log(printed.getvalue().rstrip())
    check("python -m tpu_gaussians_torch.cli.fit" in printed.getvalue(),
          "import_colmap did not name the port's fit CLI")
    with contextlib.redirect_stdout(io.StringIO()):
        import_cli.main(["--colmap_dir", str(d / "sparse_txt"), "--out_dir",
                         str(d / "import_txt"), "--init_out", "--seed",
                         str(seed)])
    imported = np.load(d / "import_bin" / "cameras.npz")
    cam_err = max(float(np.abs(imported[k] - rig[k]).max())
                  for k in ("view", "proj"))
    check(cam_err <= 1e-5, f"imported cameras differ from the rig by "
          f"{cam_err} (> 1e-5)")
    for f in ("cameras.npz", "init_points.npz"):
        a, b = (np.load(d / sub / f) for sub in ("import_bin", "import_txt"))
        check(sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files),
            f"the text model's {f} differs from the binary model's")
    order = (d / "import_bin" / "image_order.txt").read_text().splitlines()
    check(order == names, f"image order {order} is not the targets' {names}")
    init = np.load(d / "import_bin" / "init_points.npz")
    check(init["means"].shape == (800, 3) and init["sh_coeffs"].shape == (
        800, 4, 3), "init_points.npz does not hold 800 SH-1 gaussians")
    log("colmap_fit import " + json.dumps(
        {"import_s": import_s, "camera_max_abs_err": cam_err,
         "points": len(pts)}))

    # 2. three fits: unbroken, interrupted at 50, resumed to 150
    base = ["--targets_dir", str(scene), "--camera_npz",
            str(d / "import_bin" / "cameras.npz"), "--init_npz",
            str(d / "import_bin" / "init_points.npz"), "--use_sh",
            "--checkpoint_every", "50"]
    runs = {}
    runs["unbroken"], _ = colmap_fit_run(d, "unbroken", "unbroken",
                                         base + ["--iters", "150"], 150)
    runs["interrupted"], _ = colmap_fit_run(d, "interrupted", "resumed",
                                            base + ["--iters", "50"], 50)
    runs["resumed"], text = colmap_fit_run(
        d, "resumed", "resumed", base + ["--iters", "150", "--resume"], 100)
    check("Resumed from checkpoint at iter 50" in text,
          "the resumed fit did not print 'Resumed from checkpoint at iter 50'")
    rows = [json.loads(line) for line in
            (d / "resumed" / "metrics.jsonl").read_text().splitlines()]
    check([r["step"] for r in rows] == list(range(1, 151)),
          "the resumed fit's metrics.jsonl does not hold steps 1-150")
    ckpts = Checkpointer(d / "resumed" / "checkpoints")
    check(ckpts.steps() == [50, 100, 150],
          f"checkpoints/ holds {ckpts.steps()}, not 50, 100 and 150")
    unbroken = [json.loads(line) for line in
                (d / "unbroken" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in unbroken]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"colmap_fit: loss went {losses[0]} -> {losses[-1]}")
    n_alive = [r["n_alive"] for r in rows]
    check(n_alive[80] > n_alive[79], f"colmap_fit: N did not grow at "
          f"iteration 80 ({n_alive[79]} -> {n_alive[80]})")

    # The resumed fit's parameters against the unbroken one's, both from
    # their checkpoints at 150; the checkpoint's save and restore timed.
    tx = make_optimizer()
    restore_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, res_state, _ = ckpts.restore(tx, "cuda")
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    _, full_state, _ = Checkpointer(d / "unbroken" / "checkpoints").restore(
        tx, "cuda")
    err = {}
    for k, t in full_state.raw.trainable().items():
        r = res_state.raw.trainable()[k].detach()
        t = t.detach()
        err[k] = float((r - t).abs().max())
        check(bool(torch.allclose(r, t, rtol=1e-5, atol=1e-6)),
              f"colmap_fit: the resumed fit's {k} is off the unbroken "
              f"fit's by {err[k]} (rtol 1e-5, atol 1e-6)")
    bitwise = all(torch.equal(res_state.raw.trainable()[k],
                              full_state.raw.trainable()[k]) for k in err)
    save_ms = []
    gen = torch.Generator()
    scratch = Checkpointer(d / "save_timing")
    for step in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scratch.save(step, res_state, gen)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    ckpt_bytes = (ckpts.directory / "150" / STATE_FILE).stat().st_size
    out = {"fits": runs, "resumed_vs_unbroken_max_abs_err": err,
           "resumed_vs_unbroken_bitwise": bitwise,
           "checkpoint_save_ms": sorted(save_ms)[2],
           "checkpoint_restore_ms": sorted(restore_ms)[2],
           "checkpoint_bytes": ckpt_bytes,
           "loss_first": losses[0], "loss_last": losses[-1],
           "n_first": n_alive[0], "n_last": n_alive[-1]}
    log("colmap_fit resume " + json.dumps(out))

    # 3. eval on the card, then through the twins on the host
    fitted = d / "resumed" / "gaussians_fitted.npz"
    eval_args = ["--targets_dir", str(scene), "--camera_npz",
                 str(d / "import_bin" / "cameras.npz"), "--width",
                 str(side), "--height", str(side)]
    reports = {}
    for dev in ("cuda", "cpu"):
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            eval_cli.main([str(fitted)] + eval_args + [
                "--device", dev, "--out", str(d / f"eval_{dev}.json")])
        k1 = read_launches()["splat_sep_fwd"]
        check(k1 == (6 if dev == "cuda" else 0),
              f"cli.eval on {dev} launched K1 {k1} times")
        reports[dev] = json.loads((d / f"eval_{dev}.json").read_text())
    diff = {k: max(abs(a[k] - b[k]) for a, b in zip(
        reports["cuda"]["views"] + [reports["cuda"]["mean"]],
        reports["cpu"]["views"] + [reports["cpu"]["mean"]]))
        for k in ("psnr", "ssim", "l1")}
    for k, tol in (("psnr", 0.01), ("ssim", 1e-4), ("l1", 1e-5)):
        check(diff[k] <= tol, f"cli.eval on the card and through the twins "
              f"differ by {diff[k]} in {k} (> {tol})")
    g_res = load_gaussians_npz(fitted, device="cuda")
    cams = cam.load_cameras_npz(d / "import_bin" / "cameras.npz",
                                device="cuda")
    targets = to_device(im.load_targets(im.list_target_paths(scene), side,
                                        side), "cuda")
    eval_cfg = RenderConfig(width=side, height=side)
    eval_ms = time_ms(lambda: eval_cli.view_metrics(g_res, cams, targets,
                                                    eval_cfg), reps=10)
    out = {"eval_device_ms": eval_ms, "eval_cuda_mean": reports["cuda"][
        "mean"], "eval_cpu_mean": reports["cpu"]["mean"],
        "cuda_vs_cpu_max_abs_diff": diff}
    log("colmap_fit eval " + json.dumps(out))

    # 4. ply: npz -> ply -> npz, the ply evaluated on the card and
    # rendered against the fitted model with its dc clamped as on export
    with contextlib.redirect_stdout(io.StringIO()):
        convert_cli.main([str(fitted), str(d / "fitted.ply")])
        convert_cli.main([str(d / "fitted.ply"), str(d / "fitted_ply.npz")])
        eval_cli.main([str(d / "fitted.ply")] + eval_args + [
            "--footprint", "axis", "--device", "cuda", "--out",
            str(d / "eval_ply.json")])
    g_ply = load_gaussians_ply(d / "fitted.ply", device="cuda")
    g_back = load_gaussians_npz(d / "fitted_ply.npz", device="cuda")
    sh_c = g_res.sh.clone()
    sh_c[:, 0] = sh_c[:, 0].clamp(0, 1)
    for got in (g_ply, g_back):
        for a, b, rtol, atol in ((got.means, g_res.means, 1e-5, 1e-6),
                                 (got.scales, g_res.scales, 1e-4, 0.0),
                                 (got.opacities, g_res.opacities, 1e-4, 0.0),
                                 (got.sh, sh_c, 1e-3, 1e-5)):
            check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
                  f"the ply round trip moved a field by "
                  f"{float((a - b).abs().max())}")
    with torch.no_grad():
        img_ply = render(g_ply.replace(quats=None), cams[0], eval_cfg)
        img_fit = render(g_res.replace(sh=sh_c), cams[0], eval_cfg)
    render_err = float((img_ply - img_fit).abs().max())
    check(render_err <= 1e-4, f"the ply-loaded model renders {render_err} "
          f"off the fitted one (> 1e-4)")
    ply_report = json.loads((d / "eval_ply.json").read_text())
    out = {"ply_bytes": (d / "fitted.ply").stat().st_size,
           "ply_render_max_abs_err": render_err,
           "eval_ply_mean": ply_report["mean"]}
    log("colmap_fit ply " + json.dumps(out))


PARALLEL_FIT_ARGS = ["--num_view_shards", "2"]
PARALLEL_TIMEOUT_S = 600
# The native CPU rasterizer against the port's renders (phase 20): its
# splats are cut where w < 1e-5 and it sums in another order, so it
# differs from the plain renderer by up to about N x 1e-5 (tests/
# test_native.py's atol 5e-4 at 40 gaussians). Measured: at most 3.4e-4
# over phase 20's cases on the H100 (the flagship fit, accum mode), 5.9e-4
# on the CPU with another fit of the same recipe.
NATIVE_ATOL = 1e-3


def served_camera(yaw: float, pitch: float, radius: float, width: int,
                  height: int):
    """cli.serve's orbit camera of a request, on the card."""
    import math

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import Camera

    eye = [radius * math.cos(pitch) * math.sin(yaw), radius * math.sin(pitch),
           radius * math.cos(pitch) * math.cos(yaw)]
    return Camera(view=cam.look_at(eye, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                                   device="cuda"),
                  proj=cam.perspective(60.0, width / height, 0.01, 100.0,
                                       device="cuda"))


def torchrun(args, timeout: int = PARALLEL_TIMEOUT_S):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2`
    with `args`, from the root of the checkout; (completed process, wall
    s). torch.distributed.run exits non-zero when any rank does, and its
    summary names the rank and its exit code."""
    import os

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def rank_lines(text: str, prefix: str) -> dict:
    """The JSON of each `<prefix> <rank> of <world>: {...}` line."""
    out = {}
    for line in text.splitlines():
        m = re.match(rf"{prefix} (\d+) of (\d+): (\{{.*\}})\s*$", line)
        if m:
            out[int(m.group(1))] = json.loads(m.group(3))
    return out


def parallel_fit_phase(tmp: Path, single: dict) -> dict:
    """The flagship fit as two ranks on the one card: cli.fit under
    torch.distributed.run with --num_view_shards 2 (3 of the 6 views a
    rank, gloo by initialize_distributed's rule). Both ranks exit 0, the
    loss falls under half, N grows at 80, rank 0 alone writes out_dir, the
    parameters are bit-identical across ranks, and each rank launched K1
    and K2 3 times a step (rank 0 K1 once more, the preview) and no other
    kernel."""
    import numpy as np

    out_dir = tmp / "fit_2ranks"
    argv = ["-m", "tpu_gaussians_torch.cli.fit"] + [
        str(ROOT / a) if a.startswith("assets") else a for a in FIT_ARGS] + (
        PARALLEL_FIT_ARGS + ["--out_dir", str(out_dir), "--device", "cuda"])
    proc, wall = torchrun(argv)
    log(proc.stdout.rstrip())
    check(proc.returncode == 0, f"2-rank fit: torch.distributed.run exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    ranks = rank_lines(proc.stdout, "rank")
    check(sorted(ranks) == [0, 1], f"2-rank fit: rank summaries of ranks "
          f"{sorted(ranks)}, expected 0 and 1")
    check("backend gloo" in proc.stdout,
          "2-rank fit on one card did not pick gloo")
    losses = [float(x) for x in
              (out_dir / "loss.txt").read_text().splitlines()]
    metrics = [json.loads(line) for line in
               (out_dir / "metrics.jsonl").read_text().splitlines()]
    n_alive = [m["n_alive"] for m in metrics]
    check(len(losses) == 150, f"2-rank fit: loss.txt has {len(losses)} "
          "lines")
    check(bool(np.isfinite(losses).all()) and losses[-1] < 0.5 * losses[0],
          f"2-rank fit: loss went {losses[0]} -> {losses[-1]}: not under "
          "half")
    check(n_alive[80] > n_alive[79], f"2-rank fit: N did not grow at "
          f"iteration 80 ({n_alive[79]} -> {n_alive[80]})")
    artifacts = ["gaussians_fitted.npz", "loss.txt", "metrics.jsonl",
                 "preview_view0.png"]
    check(sorted(p.name for p in out_dir.iterdir()) == artifacts
          and all((out_dir / a).stat().st_size > 0 for a in artifacts),
          f"2-rank fit: out_dir holds {sorted(p.name for p in out_dir.iterdir())}")
    check(ranks[0]["wrote_out_dir"] and not ranks[1]["wrote_out_dir"],
          "2-rank fit: a rank other than 0 wrote out_dir")
    check(ranks[0]["params_sha256"] == ranks[1]["params_sha256"],
          "2-rank fit: the ranks' parameters differ: "
          f"{ranks[0]['params_sha256']} != {ranks[1]['params_sha256']}")
    for r, summary in ranks.items():
        want = {k: 0 for k in summary["kernel_launches"]}
        want["splat_sep_fwd"] = 3 * 150 + (1 if r == 0 else 0)
        want["splat_sep_bwd"] = 3 * 150
        want["stage_fwd"] = want["splat_sep_fwd"]
        want["stage_bwd"] = want["splat_sep_bwd"]
        check(summary["kernel_launches"] == want, f"2-rank fit: rank {r} "
              f"launched {summary['kernel_launches']}, expected {want}")
        check(summary["allreduce_calls_per_step"] == 1,
              f"2-rank fit: rank {r} made "
              f"{summary['allreduce_calls_per_step']} all-reduces a step")
    loop_s = float(proc.stdout.split("Done in ")[1].split("s.")[0])
    out = {"iters": 150, "command_wall_s": wall, "fit_loop_wall_s": loop_s,
           "steps_per_s": 150 / loop_s,
           "single_process_fit_loop_wall_s": single["fit_loop_wall_s"],
           "single_process_steps_per_s": single["steps_per_s"],
           "loss_first": losses[0], "loss_last": losses[-1],
           "single_process_loss_last": single["loss_last"],
           "n_first": n_alive[0], "n_last": n_alive[-1],
           "params_sha256": ranks[0]["params_sha256"],
           "launches": {r: s["kernel_launches"] for r, s in ranks.items()},
           "allreduce_bytes_per_step": ranks[0]["allreduce_bytes_per_step"],
           "allreduce_host_ms_per_step": {
               r: s["allreduce_host_ms_per_step"] for r, s in ranks.items()}}
    log("parallel fit 2 ranks " + json.dumps(out))
    return out


def states_err(s1, m1, s2, m2) -> dict:
    """How far a step's result is from the single-process step's, in units
    of tests/test_sharded.py's _assert_states_match tolerances (loss rtol
    1e-5 / atol 1e-6, leaves rtol 2e-4 / atol 2e-6): at most 1 passes."""
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    leaves = max(float(((b - a).abs() / (2e-6 + 2e-4 * a.abs())).max())
                 for a, b in zip(s1.raw.trainable().values(),
                                 s2.raw.trainable().values())
                 for a, b in [(a.detach(), b.detach())])
    return {"loss": abs(l2 - l1) / (1e-6 + 1e-5 * abs(l1)),
            "leaves": leaves,
            "psnr_diff": abs(float(m2["psnr"]) - float(m1["psnr"]))}


def parallel_worker(out_dir: Path, seed: int) -> None:
    """One of two ranks under torch.distributed.run, sharing the card
    (gloo): one sharded step of each factory against the single-process
    step on the flagship's inputs (RGB colours, as tests/test_sharded.py's
    setup), in three modes; then phase 8's 100k scene on 4 views of
    512x512 over the two ranks. Writes out_dir/rank<r>.json.

    With SH colours the rows mesh misses the leaf tolerance on the
    degree-1 coefficients: their gradients (about 1e-9, under Adam's eps
    1e-8) cancel over views, and Adam's first step passes their rounding
    (a window's pixels summed apart) to the update; 2.7-2.9 times the
    tolerance on the CPU through the plain renderer, 4.1 on the card. That
    case is measured and printed beside the held ones, not held."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_gaussians_torch.cli.fit import params_digest
    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import (
        RenderConfig, make_gaussians, resolve_device, to_device)
    from tpu_gaussians_torch.fit.loss import LossConfig
    from tpu_gaussians_torch.fit.step import (
        init_state, make_optimizer, make_train_step)
    from tpu_gaussians_torch.fit.trainer import load_dataset
    from tpu_gaussians_torch.models.gaussian_model import (
        activate, init_params, raw_from_gaussians)
    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.parallel import mesh as pmesh
    from tpu_gaussians_torch.parallel import sharded
    from tpu_gaussians_torch.utils.config import FitConfig

    pmesh.initialize_distributed(device="cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    check(world == 2, f"parallel worker: {world} ranks, expected 2")
    resolve_device("cuda")
    out = {"rank": rank, "backend": dist.get_backend(),
           "card": torch.cuda.current_device()}

    # One step of each factory against the single-process step.
    cfg = FitConfig(targets_dir=str(ROOT / "assets" / "example_scene"),
                    camera_npz=str(ROOT / "assets" / "example_scene"
                                   / "cameras.npz"))
    with contextlib.redirect_stdout(io.StringIO()):
        targets, masks, _, cams = load_dataset(cfg, device="cuda")
    targets, masks = to_device(targets, "cuda"), to_device(masks, "cuda")
    zeros = torch.zeros_like(masks)
    raw = init_params(torch.Generator().manual_seed(seed), 800, 3000,
                      device="cuda")
    tx = make_optimizer(0.02)
    views, rows = pmesh.make_mesh(2, 1), pmesh.make_mesh(1, 2)
    pair_k = tiled.auto_pair_k(activate(raw), cams.view, cams.proj, 128, 128)
    modes = {"accum": RenderConfig(mode="accum"),
             "sorted": RenderConfig(mode="sorted", sorted_pair_k=pair_k),
             "accum_binned_on": RenderConfig(mode="accum", accum_binned="on")}
    errs, digests = {}, {}
    for label, rc in modes.items():
        rc = rc.replace(width=128, height=128, return_aux=True)
        for ssim in (0.0, 0.2):
            lc = LossConfig(ssim_weight=ssim)
            s1, m1 = make_train_step(rc, lc, True, False)(
                init_state(raw, tx), cams, targets, masks, zeros)
            if ssim:
                factories = {"sharded_rows_1x2": sharded.make_sharded_train_step(
                    tx, rc, lc, True, False, rows, shard_rows=True)}
            else:
                factories = {
                    "sharded": sharded.make_sharded_train_step(
                        tx, rc, lc, True, False, views),
                    "shardmap": sharded.make_shardmap_train_step(
                        tx, rc, lc, True, False, views),
                    **{f"overlapped{k}": sharded.make_overlapped_train_step(
                        tx, rc, lc, True, False, views, n_chunks=k)
                       for k in (1, 2, 3)}}
            for name, step in factories.items():
                s2, m2 = step(init_state(raw, tx), cams, targets, masks,
                              zeros)
                case = f"{label}/{name}/ssim{ssim}"
                errs[case] = states_err(s1, m1, s2, m2)
                digests[case] = params_digest(s2.raw)
                check(errs[case]["loss"] <= 1 and errs[case]["leaves"] <= 1,
                      f"rank {rank}: {case} against the single-process step: "
                      f"{errs[case]} (in units of the tolerance)")
    out["step_vs_single"] = errs
    out["digests"] = digests
    out["pair_k"] = pair_k
    raw_sh = init_params(torch.Generator().manual_seed(seed), 800, 3000,
                         use_sh=True, device="cuda")
    fit_bytes = 4 * (sum(t.numel() for t in raw_sh.trainable().values())
                     + len(sharded.MEAN_KEYS) + len(sharded.SUM_KEYS))
    rc = modes["accum"].replace(width=128, height=128, return_aux=True)
    lc = LossConfig(ssim_weight=0.2)
    out["sh_rows_1x2_accum_ssim0.2_not_held"] = states_err(
        *make_train_step(rc, lc, True, False)(
            init_state(raw_sh, tx), cams, targets, masks, zeros),
        *sharded.make_sharded_train_step(tx, rc, lc, True, False, rows,
                                         shard_rows=True)(
            init_state(raw_sh, tx), cams, targets, masks, zeros))
    del raw, raw_sh

    # Phase 8's 100k scene and views, data parallel over the two ranks.
    n_s, side = 100_000, 512
    raw_s = raw_from_gaussians(make_gaussians(
        **scene_arrays(n_s, seed + 2), device="cuda"), capacity=n_s)
    cams_s = cam.orbit_cameras(4, side, side, device="cuda")
    targets_s = to_device(np.random.default_rng(seed).uniform(
        0, 1, (4, side, side, 3)), "cuda")
    masks_s = (targets_s.mean(dim=3) > 0.06).to(torch.float32)
    zeros_s = torch.zeros_like(masks_s)
    rc = RenderConfig(mode="accum", width=side, height=side, return_aux=True)
    step = sharded.make_sharded_train_step(tx, rc, LossConfig(), True, False,
                                           views)
    state = init_state(raw_s, tx)

    def one(_):
        step(state, cams_s, targets_s, masks_s, zeros_s)

    one(0)
    torch.cuda.synchronize()
    dist.barrier()
    sharded.reset_allreduce()
    times = []
    for i in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        one(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ar = {k: v / 10 for k, v in sharded.allreduce.items()}
    dist.barrier()
    prof = profile_calls(one, 3)

    def allreduce_alone_ms(nbytes: int) -> float:
        """Median host ms of an all-reduce of `nbytes` alone: CUDA tensors
        through gloo, the stream drained before and after each call."""
        buf = torch.zeros(nbytes // 4, device="cuda")
        alone = []
        for _ in range(11):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(buf)
            torch.cuda.synchronize()
            alone.append((time.perf_counter() - t0) * 1e3)
        return sorted(alone)[5]

    out["fit_allreduce_bytes"] = fit_bytes
    out["fit_allreduce_alone_ms_median"] = allreduce_alone_ms(fit_bytes)
    times.sort()
    out["scale_100k"] = {
        "views": 4, "views_per_rank": 2, "width": side, "height": side,
        "capacity": n_s, "steps": 10, "step_ms_median": times[5],
        "step_ms_mean": sum(times) / 10,
        "allreduce_calls_per_step": ar["calls"],
        "allreduce_bytes_per_step": ar["bytes"],
        "allreduce_host_ms_per_step": ar["ms"],
        "allreduce_alone_ms_median": allreduce_alone_ms(int(ar["bytes"])),
        "device_busy_share_this_rank": prof["device_busy_share"],
        "device_busy_ms_per_step_this_rank": prof["device_busy_ms_per_call"],
        "wall_ms_per_step_profiled": prof["wall_ms_per_call"],
        "params_sha256": params_digest(state.raw)}
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def parallel_steps_phase(tmp: Path, seed: int, single_100k: dict) -> dict:
    """parallel_worker on two ranks: every one-step comparison held, the
    ranks' parameters bit-identical in each case."""
    out_dir = tmp / "parallel_steps"
    out_dir.mkdir()
    proc, wall = torchrun([str(ROOT / "chip_smoke.py"), "--parallel_worker",
                           str(out_dir), "--seed", str(seed)])
    log(proc.stdout.rstrip())
    check(proc.returncode == 0, f"parallel steps: torch.distributed.run "
          f"exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(2)]
    check(all(r["backend"] == "gloo" for r in ranks),
          "parallel steps: the ranks on one card did not pick gloo")
    check(ranks[0]["digests"] == ranks[1]["digests"] and
          ranks[0]["scale_100k"]["params_sha256"]
          == ranks[1]["scale_100k"]["params_sha256"],
          "parallel steps: the ranks' parameters differ after a step")
    s0, s1 = ranks[0]["scale_100k"], ranks[1]["scale_100k"]
    busy = [s0["device_busy_share_this_rank"],
            s1["device_busy_share_this_rank"]]
    out = {"command_wall_s": wall, "pair_k": ranks[0]["pair_k"],
           "fit_allreduce_bytes": ranks[0]["fit_allreduce_bytes"],
           "fit_allreduce_alone_ms_median": [
               r["fit_allreduce_alone_ms_median"] for r in ranks],
           "step_vs_single_worst": {k: max(r["step_vs_single"][c][k]
                                           for r in ranks
                                           for c in r["step_vs_single"])
                                    for k in ("loss", "leaves", "psnr_diff")},
           "step_vs_single": ranks[0]["step_vs_single"],
           "sh_rows_1x2_accum_ssim0.2_not_held":
               ranks[0]["sh_rows_1x2_accum_ssim0.2_not_held"],
           "scale_100k": {
               **{k: v for k, v in s0.items() if k != "params_sha256"},
               "step_ms_median_rank1": s1["step_ms_median"],
               "allreduce_alone_ms_median_rank1":
                   s1["allreduce_alone_ms_median"],
               "device_busy_share_rank1": s1["device_busy_share_this_rank"],
               # Two processes' kernels time-slice the card: the card's
               # busy share is about the sum of the two.
               "device_busy_share_card": (None if None in busy
                                          else sum(busy)),
               "single_process_step_ms_median":
                   single_100k["step_ms_median"]}}
    log("parallel steps " + json.dumps(out))
    return out


def tiled_phase(npz: Path, tmp: Path) -> dict:
    """render_tiled on the 100k served scene at 960x540 (the pose of phase
    4), 2 and 7 bands on the one card named for each, sorted (K3) and
    accum (K1) mode, against the whole-frame render at rtol / atol 2e-5
    with the aux outputs; the tiled and whole-frame times (CUDA events);
    then cli.render --shard_bands 2 against cli.render (<= 1 LSB)."""
    import numpy as np
    import torch
    from PIL import Image

    from tpu_gaussians_torch.cli import render as render_cli
    from tpu_gaussians_torch.core.types import RenderConfig
    from tpu_gaussians_torch.io.npz import load_gaussians_npz
    from tpu_gaussians_torch.ops.dispatch import render
    from tpu_gaussians_torch.parallel.tiled import render_tiled

    width, height = 960, 540
    g = load_gaussians_npz(npz, device="cuda")
    c = served_camera(0.5, 0.2, 2.5, width, height)
    out = {}
    reset_launches()
    with torch.no_grad():
        for mode in ("sorted", "accum"):
            cfg = RenderConfig(width=width, height=height, mode=mode,
                               return_aux=True)
            full = render(g, c, cfg)
            row = {"full_ms": time_ms(lambda: render(g, c, cfg), reps=10)}
            for n in (2, 7):
                devices = ["cuda:0"] * n
                tiled_out = render_tiled(g, c, cfg, devices=devices)
                errs = []
                for a, b in zip(tiled_out, full):
                    check(a.shape == b.shape and bool(torch.allclose(
                        a, b, rtol=2e-5, atol=2e-5)), f"render_tiled {mode} "
                        f"{n} bands: differs from the whole frame (max abs "
                        f"err {float((a - b).abs().max())})")
                    errs.append(float((a - b).abs().max()))
                row[f"bands{n}_max_abs_err"] = max(errs)
                row[f"bands{n}_ms"] = time_ms(
                    lambda: render_tiled(g, c, cfg, devices=devices),
                    reps=10)
            out[mode] = row
    launches = read_launches()
    check(launches["sorted_fwd"] > 0 and launches["splat_sep_fwd"] > 0
          and launches["stage_fwd"] > 0
          and all(v == 0 for k, v in launches.items()
                  if k not in ("sorted_fwd", "splat_sep_fwd", "stage_fwd")),
          f"render_tiled launched {launches}")
    out["launches"] = {k: v for k, v in launches.items() if v}
    frames = {}
    for bands in ("0", "2"):
        d = tmp / f"render_bands{bands}"
        with contextlib.redirect_stdout(io.StringIO()):
            render_cli.main([str(npz), "--out_dir", str(d), "--width",
                             str(width), "--height", str(height),
                             "--shard_bands", bands, "--device", "cuda"])
        frames[bands] = np.asarray(Image.open(d / "view_000.png"), np.int16)
    lsb = int(np.abs(frames["0"] - frames["2"]).max())
    check(lsb <= 1, f"cli.render --shard_bands 2: {lsb} LSB from cli.render")
    out["cli_shard_bands2_max_lsb"] = lsb
    log("tiled " + json.dumps(out))
    return out


def native_phase(g_fit, cams, tmp: Path) -> dict:
    """The port's binding of the native CPU rasterizer: built with g++
    here, the small scene of phase 6 (256x64, axis footprint) and the
    flagship's fitted model (128x128, SH evaluated for the view) in both
    modes against the port's plain renderer and the card's render,
    within NATIVE_ATOL; its host ms a frame; gs_viewer for 3 frames."""
    import numpy as np
    import torch

    from tpu_gaussians_torch import native
    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import RenderConfig
    from tpu_gaussians_torch.io.npz import save_gaussians_npz
    from tpu_gaussians_torch.ops.dispatch import render
    from tpu_gaussians_torch.ops.sh import eval_colors

    t0 = time.perf_counter()
    native.build()
    import os
    import platform

    lscpu = subprocess.run(["lscpu"], capture_output=True, text=True,
                           timeout=60).stdout
    names = [line.split(":", 1)[1].strip() for line in
             lscpu.splitlines() + Path("/proc/cpuinfo").read_text(
                 errors="replace").splitlines()
             if line.strip().lower().startswith("model name")]
    # The host may hide its CPU's model; its architecture and core count
    # are printed beside.
    out = {"build_s": time.perf_counter() - t0,
           "cpu": names[0] if names else "not reported by the host",
           "cpu_arch": platform.machine(), "cpu_count": os.cpu_count()}
    bg = (0.02, 0.02, 0.02)
    small = small_scene()
    cases = {"small_2000_256x64": (small, cam.orbit_cameras(
        2, 256, 64, device="cuda")[0], 256, 64),
        "flagship_fitted_128x128": (g_fit, cams[0], 128, 128)}
    for name, (g, c, width, height) in cases.items():
        alive = g.alive_mask() > 0.5
        colors = torch.clamp(eval_colors(g.sh if g.use_sh else g.colors,
                                         g.means, c.view), 0.0, 1.0)
        args = (g.means[alive], g.scales[alive], colors[alive],
                g.opacities[alive], c.view, c.proj)
        for mode in ("accum", "sorted"):
            kw = dict(width=width, height=height, background=bg,
                      depth_sort=mode == "sorted", as_float=True)
            rgb, alpha = native.render_native(*args, **kw)
            host = []
            for _ in range(5):
                t1 = time.perf_counter()
                native.render_native(*args, **kw)
                host.append((time.perf_counter() - t1) * 1e3)
            cfg = RenderConfig(width=width, height=height, mode=mode,
                               background=bg, return_aux=True)
            row = {"n": int(alive.sum()), "host_ms_median": sorted(host)[2]}
            with torch.no_grad():
                for impl in ("torch", "tiled"):
                    img, a, _ = render(g, c, cfg.replace(impl=impl))
                    err = max(float(np.abs(rgb - img.cpu().numpy()).max()),
                              float(np.abs(alpha - a.cpu().numpy()).max()))
                    row[f"max_abs_diff_vs_{impl}"] = err
                    check(err <= NATIVE_ATOL, f"native {name} {mode}: "
                          f"{err} from the port's {impl} render (atol "
                          f"{NATIVE_ATOL})")
            out[f"{name}_{mode}"] = row
    npz = tmp / "small_scene.npz"
    save_gaussians_npz(npz, small)
    res = subprocess.run(
        [str(native.viewer_path()), str(npz), "--width", "256", "--height",
         "64", "--frames", "3", "--out_dir", str(tmp / "viewer_frames")],
        capture_output=True, text=True, timeout=120)
    check(res.returncode == 0 and "FPS" in res.stdout
          and len(list((tmp / "viewer_frames").glob("frame_*.ppm"))) == 3,
          f"gs_viewer: rc {res.returncode}\n{res.stdout}\n{res.stderr}")
    out["gs_viewer"] = res.stdout.strip().splitlines()[-1]
    log("native " + json.dumps(out))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parallel_worker", default="", metavar="DIR",
                    help="run as one rank of phase 20's two-rank checks "
                         "(under torch.distributed.run), writing DIR/"
                         "rank<r>.json")
    args = ap.parse_args()

    check((ROOT / "tpu_gaussians_torch" / "__init__.py").exists(),
          "tpu_gaussians_torch/ not found beside chip_smoke.py: run it from "
          "the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    if args.parallel_worker:
        parallel_worker(Path(args.parallel_worker), args.seed)
        return 0

    from tpu_gaussians_torch.cli.serve import (
        INTERACTIVE_KNOBS, RenderService, run_loop)
    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import (
        Camera, RenderConfig, make_gaussians, resolve_device, to_device)
    from tpu_gaussians_torch.fit.trainer import load_dataset
    from tpu_gaussians_torch.io.npz import load_gaussians_npz, save_gaussians_npz
    from tpu_gaussians_torch.kernels import build, sorted_bwd, sorted_fwd
    from tpu_gaussians_torch.models.gaussian_model import (
        activate, raw_from_gaussians)
    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.ops import splat
    from tpu_gaussians_torch.ops.common import prepare_splats
    from tpu_gaussians_torch.ops.projection import camera_z
    from tpu_gaussians_torch.utils.config import FitConfig

    resolve_device("cuda")   # TF32 off for matmuls and convolutions
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is still on after resolve_device('cuda')")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {', '.join(build.KERNELS)} in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, text in build.logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"build {name}: {line.strip()}")
    # K1, K2, K5, K6, K7a, K7b, K8a, K8b, K9a and K9b run their products on
    # the tensor cores: their SASS holds HMMA.
    hmma = {}
    for name in ("splat_sep_fwd", "splat_sep_bwd", "splat_v2_fwd",
                 "splat_v2_bwd",
                 "binned_sep_fwd", "binned_sep_bwd", "binned_fwd",
                 "binned_bwd", "splat_v1_fwd", "splat_v1_bwd"):
        hmma[name] = build.sass_count(build.library_path(name),
                                      f"{name}_kernel", "HMMA")
        log(f"build {name}: {hmma[name]} HMMA instructions in the kernel's "
            f"SASS")
        check(hmma[name] > 0, f"{name}'s SASS holds no HMMA instruction")

    # 3. scene
    n, width, height = 100_000, 960, 540
    tmp = tempfile.TemporaryDirectory()
    npz = Path(tmp.name) / "scene.npz"
    save_gaussians_npz(npz, make_gaussians(**scene_arrays(n, args.seed),
                                           device="cpu"))
    log(f"scene: {n} gaussians, seed {args.seed}, {npz.stat().st_size} B npz")

    # 4 + 5. the main path: serve over HTTP, then the sustained loop
    svc = RenderService(str(npz), impl="auto", fovy=60.0,
                        preset="interactive", device="cuda")
    pose = (0.5, 0.2, 2.5)
    reset_launches()
    svc.frames = 0
    served = serve_phase(svc, width, height, pose)
    loop = run_loop(svc, frames=50, width=width, height=height,
                    mode="sorted", fmt="jpg")
    launches = {"sorted_fwd": read_launches()["sorted_fwd"]}
    frames = svc.frames
    log(f"main path: {frames} frames rendered, kernel launches {launches}")
    check(frames >= 53, f"only {frames} frames rendered")
    check(launches["sorted_fwd"] >= frames,
          f"sorted_fwd launched {launches['sorted_fwd']} times for "
          f"{frames} frames")
    check(loop["device_ms_per_frame"] and loop["device_ms_per_frame"] > 0,
          "run_loop measured no device time")

    # The served raw frame against the same pose through the plain twin.
    with torch.no_grad():
        c: Camera = svc.camera(*pose, width, height)
        cfg = svc.config(width, height, "sorted")
        s = prepare_splats(svc.gaussians, c.view, c.proj, width, height)
        gdense, cnt, tiles_x, tiles_y, _ = tiled.tile_lists(
            s, camera_z(svc.gaussians.means, c.view), height, width,
            cfg.sorted_band_capacity, cfg.sorted_pair_k)
        acc, _ = sorted_fwd.sorted_tiles_plain(gdense, cnt, tiles_x,
                                               axis=True,
                                               exit_t=cfg.sorted_exit_t)
        img, _, _ = tiled.resolve_sorted(
            acc, cfg.background_tensor("cuda"), tiles_y, tiles_x, height,
            width)
        plain_u8 = (torch.clamp(img, 0.0, 1.0) * 255.0).to(
            torch.uint8).cpu().numpy()
    diff = np.abs(served["raw"].astype(np.int16) - plain_u8.astype(np.int16))
    off = float((diff > 0).mean())
    log(f"serve: raw frame vs plain twin: max {int(diff.max())} LSB, "
        f"{off:.6%} of values differ")
    check(diff.max() <= 1 and off <= 1e-3,
          "served frame disagrees with the plain twin")

    # The serving cells: 100k under both presets, 1M interactive; the
    # sustained loop and a profiled breakdown of each.
    npz_big = Path(tmp.name) / "scene_1m.npz"
    save_gaussians_npz(npz_big, make_gaussians(
        **scene_arrays(1_000_000, args.seed + 1), device="cpu"))
    cells = {
        "100k_interactive": svc,
        "100k_quality": RenderService(str(npz), preset="quality",
                                      device="cuda"),
        "1M_interactive": RenderService(str(npz_big), device="cuda"),
    }
    for name, cell in cells.items():
        if cell is not svc:
            log(f"loop {name}:")
            run_loop(cell, frames=50, width=width, height=height,
                     mode="sorted", fmt="jpg")
        log(f"profile {name} " + json.dumps(profile_frames(cell, width,
                                                           height)))

    # 5b. a 3DGS model at the benchmark's serving size: the footprint
    # follows the model
    g_ewa = serve_ewa_phase(Path(tmp.name), args.seed + 2)

    # 6. kernel vs plain twin at full size
    g_big = cells["1M_interactive"].gaussians
    cases = [
        kernel_case("100k_960x540_interactive", svc.gaussians, width,
                    height, INTERACTIVE_KNOBS, reps=20),
        kernel_case("100k_960x540_quality", svc.gaussians, width, height,
                    {}, reps=20),
        kernel_case("1M_960x540_interactive", g_big, width, height,
                    INTERACTIVE_KNOBS, reps=20),
        kernel_case("1M_ewa_sh3_1920x1080_quality", g_ewa, 1920, 1080, {},
                    reps=20, footprint="ewa"),
    ]
    del g_big, g_ewa, cells
    torch.cuda.empty_cache()

    # 6b. the per-gaussian stage's kernels vs their twins at the
    # benchmark's sizes
    stage_cases = [stage_case("100k_ewa_sh3_1080p", 100_000, True, 16,
                              args.seed),
                   stage_case("1M_axis_sh1_1080p", 1_000_000, False, 4,
                              args.seed + 1),
                   stage_case("1M_ewa_sh3_1080p", 1_000_000, True, 16,
                              args.seed + 2)]
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"after kernel timing: sm clock, power, limit, temperature: "
        f"{clocks.stdout.strip()}")
    small_reference_check()
    del svc

    # 7. fit: the training main path, then its step profile and K1/K2 on
    # the fitted model's inputs (padded to the fit's capacity, as in
    # training)
    fit = fit_phase(Path(tmp.name), "fit", [],
                    {"splat_sep_fwd": 901, "splat_sep_bwd": 900,
                     "stage_fwd": 901, "stage_bwd": 900})
    fit_dir = Path(tmp.name) / "fit"
    g_fit = load_gaussians_npz(fit_dir / "gaussians_fitted.npz",
                               device="cuda")
    raw_fit = raw_from_gaussians(g_fit, capacity=3000)
    cfg_fit = FitConfig(targets_dir=str(ROOT / "assets" / "example_scene"),
                        camera_npz=str(ROOT / "assets" / "example_scene"
                                       / "cameras.npz"))
    with contextlib.redirect_stdout(io.StringIO()):
        targets, masks, _, cams = load_dataset(cfg_fit, device="cuda")
    targets, masks = to_device(targets, "cuda"), to_device(masks, "cuda")
    accum = RenderConfig(mode="accum")
    flag_steps, _ = train_steps(raw_fit, cams, targets, masks, steps=20,
                                profile=10, render_config=accum)
    log("fit step profile, flagship " + json.dumps(flag_steps))
    sep_cases = [sep_kernel_case(
        "flagship_128x128_fitted", staged_sep(activate(raw_fit), cams.view[0],
                                              cams.proj[0], 128, 128),
        args.seed)]

    # 7b. colmap_fit: the SfM workflow, from SfM points sampled from the
    # fitted model: import, fit, interrupt, resume, evaluate, export
    colmap_fit_phase(Path(tmp.name), g_fit, args.seed)

    # 8. at scale: 100k alive gaussians, 4 views at 512x512
    n_s, side = 100_000, 512
    arr_s = scene_arrays(n_s, args.seed + 2)
    raw_s = raw_from_gaussians(make_gaussians(**arr_s, device="cuda"),
                               capacity=n_s)
    cams_s = cam.orbit_cameras(4, side, side, device="cuda")
    rng = np.random.default_rng(args.seed)
    targets_s = to_device(rng.uniform(0, 1, (4, side, side, 3)), "cuda")
    masks_s = (targets_s.mean(dim=3) > 0.06).to(torch.float32)
    scale_steps, state_s = train_steps(raw_s, cams_s, targets_s, masks_s,
                                       steps=10, profile=3,
                                       render_config=accum)
    log("fit step profile, 100k 512x512 x4 " + json.dumps(scale_steps))
    sep_cases.append(sep_kernel_case(
        "100k_512x512", staged_sep(activate(state_s.raw), cams_s.view[0],
                                   cams_s.proj[0], side, side), args.seed))
    del state_s, raw_s

    # 9. fit sorted: the EWA sorted training main path, its step profile,
    # and K5 on the fitted model (the preview's inputs)
    fit_s = fit_phase(Path(tmp.name), "fit_sorted", SORTED_FIT_ARGS,
                      {"sorted_fwd": 900, "sorted_bwd": 900,
                       "splat_v2_fwd": 1, "stage_fwd": 900 + 1 + 6,
                       "stage_bwd": 900},
                      expect_line="sorted pair budget k=")
    g_fs = load_gaussians_npz(Path(tmp.name) / "fit_sorted"
                              / "gaussians_fitted.npz", device="cuda")
    raw_fs = raw_from_gaussians(g_fs, capacity=4096)
    sorted_flag = RenderConfig(mode="sorted", footprint="ewa",
                               sorted_pair_k=fit_s["pair_k"])
    flag_sorted_steps, _ = train_steps(raw_fs, cams, targets, masks,
                                       steps=20, profile=10,
                                       render_config=sorted_flag)
    log("fit step profile, flagship sorted "
        + json.dumps(flag_sorted_steps))
    v2_cases = [v2_case("flagship_ewa_128x128_fitted", activate(raw_fs),
                        cams.view[0], cams.proj[0], 128, 128, args.seed)]
    flag_bwd_case = sorted_bwd_case(
        "flagship_ewa_128x128_fitted", activate(raw_fs), cams.view[0],
        cams.proj[0], 128, 128, "ewa", fit_s["pair_k"], args.seed)

    # 10. at scale, sorted: the same 100k scene with seeded quaternions,
    # EWA, the pair budget measured at its initial parameters
    arr_s["quats"] = np.random.default_rng(args.seed + 2).normal(
        size=(n_s, 4)).astype(np.float32)
    g_e = make_gaussians(**arr_s, device="cuda")
    raw_e = raw_from_gaussians(g_e, capacity=n_s)
    pair_k_s = tiled.auto_pair_k(g_e, cams_s.view, cams_s.proj, side, side,
                           footprint="ewa")
    scale_sorted_steps, state_e = train_steps(
        raw_e, cams_s, targets_s, masks_s, steps=10, profile=3,
        render_config=RenderConfig(mode="sorted", footprint="ewa",
                                   sorted_pair_k=pair_k_s))
    scale_sorted_steps["pair_k"] = pair_k_s
    log("fit step profile, 100k 512x512 x4 sorted "
        + json.dumps(scale_sorted_steps))

    # 11. at scale, EWA accumulation: the same scene and views, accum mode,
    # n >= BINNED_MIN_N under accum_binned "auto" -> the binned K8a/K8b;
    # K8a and K8b against their twins on view 0's lists at full size
    ewa_accum = RenderConfig(mode="accum", footprint="ewa")
    scale_binned_steps, state_b = train_steps(
        raw_from_gaussians(g_e, capacity=n_s), cams_s, targets_s, masks_s,
        steps=10, profile=3, render_config=ewa_accum)
    log("fit step profile, 100k 512x512 x4 EWA accum (binned) "
        + json.dumps(scale_binned_steps))
    binned_cases = [binned_case("100k_512x512_ewa", activate(state_b.raw),
                                cams_s.view[0], cams_s.proj[0], side, side,
                                args.seed)]
    del state_b
    g_trained = activate(state_e.raw)
    del state_e, raw_e
    bwd_cases = [sorted_bwd_case(f"100k_512x512_{fp}", g_trained,
                                 cams_s.view[0], cams_s.proj[0], side, side,
                                 fp, pair_k_s, args.seed)
                 for fp in ("ewa", "axis")] + [flag_bwd_case]
    grad_errs = small_grad_check()
    v2_cases.append(v2_case("8192_ewa_512x512", make_gaussians(
        **scene_arrays(8192, args.seed + 3),
        quats=np.random.default_rng(args.seed + 3).normal(
            size=(8192, 4)).astype(np.float32), device="cuda"),
        cams_s.view[0], cams_s.proj[0], side, side, args.seed))
    del g_trained, g_e
    # K4 where the fit cell runs it: its scene's view 0 at 1920x1080, full
    # tiles of 2,048 slots
    g_fc, view_fc, proj_fc, w_fc, h_fc, k_fc = fit_cell_view0(args.seed)
    bwd_cases.append(sorted_bwd_case(
        "fit_100k_ewa_sorted_1080p_view0", g_fc, view_fc, proj_fc, w_fc,
        h_fc, "ewa", k_fc, args.seed))
    del g_fc

    # 12. binned vs dense: K8a against K5 through render at ~12k gaussians
    n_bd = 12_288
    g_bd = make_gaussians(**scene_arrays(n_bd, args.seed + 4),
                          quats=np.random.default_rng(args.seed + 4).normal(
                              size=(n_bd, 4)).astype(np.float32),
                          device="cuda")
    dense_checks = [binned_dense_check("12288_ewa_512x512", g_bd, cams_s[0],
                                       side, "ewa")]
    del g_bd

    # 13. fit ewa accum: the dense EWA accumulation training main path
    # (capacity 3000: auto -> accum, n < BINNED_MIN_N -> K5/K6), its step
    # profile, and K5/K6 on the fitted model
    fit_ea = fit_phase(Path(tmp.name), "fit_ewa_accum", EWA_ACCUM_FIT_ARGS,
                       {"splat_v2_fwd": 901, "splat_v2_bwd": 900,
                        "stage_fwd": 901, "stage_bwd": 900})
    raw_ea = raw_from_gaussians(load_gaussians_npz(
        Path(tmp.name) / "fit_ewa_accum" / "gaussians_fitted.npz",
        device="cuda"), capacity=3000)
    flag_ewa_steps, _ = train_steps(raw_ea, cams, targets, masks, steps=20,
                                    profile=10, render_config=ewa_accum)
    log("fit step profile, flagship EWA accum " + json.dumps(flag_ewa_steps))
    v2_main = v2_case("flagship_ewa_accum_128x128_fitted", activate(raw_ea),
                      cams.view[0], cams.proj[0], 128, 128, args.seed)
    v2_cases.insert(0, v2_main)

    # 14. fit ewa binned: capacity 16384 in accum mode -> the tile-binned
    # K8a/K8b for training and the preview; no pair dropped
    fit_eb = fit_phase(Path(tmp.name), "fit_ewa_binned", EWA_BINNED_FIT_ARGS,
                       {"binned_fwd": 901, "binned_bwd": 900,
                        "stage_fwd": 901, "stage_bwd": 900})
    check(fit_eb["binner_dropped_pairs_max"] == 0,
          f"fit_ewa_binned dropped pairs "
          f"({fit_eb['binner_dropped_pairs_max']} in a step)")
    raw_eb = raw_from_gaussians(load_gaussians_npz(
        Path(tmp.name) / "fit_ewa_binned" / "gaussians_fitted.npz",
        device="cuda"), capacity=16384)
    flag_binned_steps, _ = train_steps(raw_eb, cams, targets, masks,
                                       steps=20, profile=10,
                                       render_config=ewa_accum)
    log("fit step profile, flagship EWA binned "
        + json.dumps(flag_binned_steps))
    binned_cases.insert(0, binned_case(
        "flagship_ewa_binned_128x128_fitted", activate(raw_eb), cams.view[0],
        cams.proj[0], 128, 128, args.seed))
    # 15. fit axis binned: the flagship recipe under --accum_binned on ->
    # the separable tile-binned K7a/K7b for training; the preview takes
    # JAX's preview config (accum_binned auto: the band kernel K1)
    fit_ab = fit_phase(Path(tmp.name), "fit_axis_binned",
                       AXIS_BINNED_FIT_ARGS,
                       {"binned_sep_fwd": 900, "binned_sep_bwd": 900,
                        "splat_sep_fwd": 1, "stage_fwd": 901,
                        "stage_bwd": 900})
    check(fit_ab["binner_dropped_pairs_max"] == 0,
          f"fit_axis_binned dropped pairs "
          f"({fit_ab['binner_dropped_pairs_max']} in a step)")
    raw_ab = raw_from_gaussians(load_gaussians_npz(
        Path(tmp.name) / "fit_axis_binned" / "gaussians_fitted.npz",
        device="cuda"), capacity=3000)
    axis_binned = RenderConfig(mode="accum", accum_binned="on")
    flag_axis_binned_steps, _ = train_steps(raw_ab, cams, targets, masks,
                                            steps=20, profile=10,
                                            render_config=axis_binned)
    log("fit step profile, flagship axis binned "
        + json.dumps(flag_axis_binned_steps))
    sep_binned_cases = [binned_case(
        "flagship_axis_binned_128x128_fitted", activate(raw_ab), cams.view[0],
        cams.proj[0], 128, 128, args.seed, footprint="axis")]

    # 16. at scale, axis binned: phase 8's 100k axis scene and views under
    # accum_binned "on"; K7a/K7b against their twins on view 0's lists;
    # view 0 through K7a against K1
    arr_a = {k: v for k, v in arr_s.items() if k != "quats"}
    scale_axis_binned_steps, state_ab = train_steps(
        raw_from_gaussians(make_gaussians(**arr_a, device="cuda"),
                           capacity=n_s),
        cams_s, targets_s, masks_s, steps=10, profile=3,
        render_config=axis_binned)
    log("fit step profile, 100k 512x512 x4 axis binned "
        + json.dumps(scale_axis_binned_steps))
    g_ab = activate(state_ab.raw)
    del state_ab
    sep_binned_cases.append(binned_case(
        "100k_512x512_axis", g_ab, cams_s.view[0], cams_s.proj[0], side,
        side, args.seed, footprint="axis"))
    dense_checks.append(binned_dense_check("100k_axis_512x512", g_ab,
                                           cams_s[0], side, "axis"))
    del g_ab

    # 17. at 1M, EWA exact: accum_binned "off" above both of JAX's v2
    # sizes -> the tile grid K9a forward and K9b backward, 4 launches each
    # per step and no K5/K6
    n_x = 1_000_000
    arr_x = scene_arrays(n_x, args.seed + 1)
    arr_x["quats"] = np.random.default_rng(args.seed + 1).normal(
        size=(n_x, 4)).astype(np.float32)
    check(not splat._choose_v2(n_x, False) and not splat._choose_v2(
        n_x, True), "1M gaussians do not take the tile grid")
    exact = RenderConfig(mode="accum", footprint="ewa", accum_binned="off")
    reset_launches()
    scale_exact_steps, state_x = train_steps(
        raw_from_gaussians(make_gaussians(**arr_x, device="cuda"),
                           capacity=n_x),
        cams_s, targets_s, masks_s, steps=3, profile=1, render_config=exact)
    exact_launches = read_launches()
    calls = 1 + 3 + 1                      # warm-up, timed, profiled
    want = {k: 4 * calls if k in ("splat_v1_fwd", "splat_v1_bwd",
                                  "stage_fwd", "stage_bwd") else 0
            for k in exact_launches}
    log(f"scale ewa exact main path: kernel launches {exact_launches}")
    check(exact_launches == want, f"scale ewa exact: kernel launches "
          f"{exact_launches} in {calls} steps of 4 views, expected {want}")
    scale_exact_steps["launches"] = exact_launches
    log("fit step profile, 1M 512x512 x4 EWA exact "
        + json.dumps(scale_exact_steps))
    g_x = activate(state_x.raw)
    del state_x, arr_x

    # 18. K9a/K9b against their twins: at 1M on view 0 (one twin call
    # each; K5/K6 timed there too), and at 8,192 EWA gaussians on 512x512,
    # where K9 is also held against K5/K6
    v1_cases = [v1_case("1M_ewa_512x512", g_x, cams_s.view[0],
                        cams_s.proj[0], side, side, args.seed, reps=5,
                        plain_reps=1)]
    del g_x
    v1_cases.append(v1_case("8192_ewa_512x512", make_gaussians(
        **scene_arrays(8192, args.seed + 3),
        quats=np.random.default_rng(args.seed + 3).normal(
            size=(8192, 4)).astype(np.float32), device="cuda"),
        cams_s.view[0], cams_s.proj[0], side, side, args.seed, dense=True))

    # 19. between JAX's two v2 sizes (500,000 EWA gaussians), the mixed
    # route: the forward on the bands (K5) and the backward on the tile
    # grid (K9b, restaged from the saved columns), 4 launches each per step
    # and no other splat kernel; then view 0's gradients against both
    # directions on the tile grid
    n_m = 500_000
    arr_m = scene_arrays(n_m, args.seed + 4)
    arr_m["quats"] = np.random.default_rng(args.seed + 4).normal(
        size=(n_m, 4)).astype(np.float32)
    reset_launches()
    mixed_steps, state_m = train_steps(
        raw_from_gaussians(make_gaussians(**arr_m, device="cuda"),
                           capacity=n_m),
        cams_s, targets_s, masks_s, steps=1, profile=1, render_config=exact)
    mixed_launches = read_launches()
    calls_m = 1 + 1 + 1                    # warm-up, timed, profiled
    want = {k: 4 * calls_m if k in ("splat_v2_fwd", "splat_v1_bwd",
                                    "stage_fwd", "stage_bwd") else 0
            for k in mixed_launches}
    log(f"scale ewa mixed main path: kernel launches {mixed_launches}")
    check(mixed_launches == want, f"scale ewa mixed: kernel launches "
          f"{mixed_launches} in {calls_m} steps of 4 views, expected {want}")
    mixed_steps["launches"] = mixed_launches
    log("fit step profile, 500k 512x512 x4 EWA exact (mixed route) "
        + json.dumps(mixed_steps))
    g_m = activate(state_m.raw)
    del state_m, arr_m
    mixed_check = mixed_route_check("500k_ewa_512x512", g_m, cams_s.view[0],
                                    cams_s.proj[0], side, args.seed)
    del g_m

    # 20. parallel: the flagship fit as two ranks on the one card, one
    # sharded step of each factory against the single-process step and
    # phase 8's 100k scene over two ranks, render_tiled on phase 3's
    # scene, the native CPU rasterizer
    par_fit = parallel_fit_phase(Path(tmp.name), fit)
    par_steps = parallel_steps_phase(Path(tmp.name), args.seed, scale_steps)
    check(par_steps["fit_allreduce_bytes"]
          == par_fit["allreduce_bytes_per_step"],
          f"the 2-rank fit all-reduced {par_fit['allreduce_bytes_per_step']}"
          f" B a step, its buffer is {par_steps['fit_allreduce_bytes']} B")
    tiled_frames = tiled_phase(npz, Path(tmp.name))
    native_frames = native_phase(g_fit, cams, Path(tmp.name))
    log("parallel " + json.dumps({
        "fit_2ranks": par_fit, "steps": par_steps, "tiled": tiled_frames,
        "native": native_frames}))
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"after training phases: sm clock, power, limit, temperature: "
        f"{clocks.stdout.strip()}")
    tmp.cleanup()

    # 21. report
    def row(name, replaces, launches_, cases_, main_, **extra):
        return {"name": name, "route": "cuda",
                "source": f"tpu_gaussians_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches_,
                "max_abs_err": max(c["max_abs_err"] for c in cases_),
                "ms": main_["ms"], "kernel_ms": main_["ms"],
                "plain_ms": main_["plain_ms"], "bound_ms": main_["bound_ms"],
                "bound_by": main_["bound_by"], "library_ms": None,
                **extra,
                "cases": [{k: c[k] for k in ("case", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "max_abs_err")}
                          for c in cases_]}

    kernels = [row("sorted_fwd", "tpu_gaussians/ops/pallas/sorted.py:221",
                   launches["sorted_fwd"], cases, cases[0],
                   launches_fit_sorted=fit_s["launches"]["sorted_fwd"],
                   launches_render_tiled=tiled_frames["launches"][
                       "sorted_fwd"],
                   training_max_abs_err=max(
                       c["sorted_fwd_max_abs_err"] for c in bwd_cases),
                   training={c["case"]: {k: c[f"sorted_fwd_{k}"] for k in (
                       "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                       "slots_composited") + K3_LIVE_KEYS}
                       for c in bwd_cases},
                   serving={c["case"]: {k: c[k] for k in (
                       "device_ms",) + K3_LIVE_KEYS} for c in cases})]
    for name, kind_, line in (("splat_sep_fwd", "fwd", 697),
                              ("splat_sep_bwd", "bwd", 742)):
        sep = [{"case": c["case"], "ms": c[f"{kind_}_ms"],
                "plain_ms": c[f"{kind_}_plain_ms"],
                "bound_ms": c[f"{kind_}_bound_ms"],
                "bound_by": c[f"{kind_}_bound_by"],
                "max_abs_err": c[f"{kind_}_max_abs_err"]} for c in sep_cases]
        # library_ms stays null: no single PyTorch call computes K1's or
        # K2's function; cuBLAS on the products alone is reported beside it.
        keys = ("bound_term", "bound_terms_ms", "device_ms", "bound_ms_f32",
                "library_ms", "slices", "partial_bytes", "partial_ms")
        keys += (("slice_len", "live_slices") if kind_ == "fwd" else
                 ("device_ms_main", "device_ms_slice_sum"))
        extra = {k: {c["case"]: c[f"{kind_}_{k}"] for c in sep_cases}
                 for k in keys}
        extra["product_library_ms"] = extra.pop("library_ms")
        extra["hmma_in_sass"] = hmma[name]
        if name == "splat_sep_fwd":
            extra["launches_axis_binned_preview"] = fit_ab["launches"][name]
            extra["launches_render_tiled"] = tiled_frames["launches"][name]
        extra["launches_2rank_fit"] = {
            r: par_fit["launches"][r][name] for r in par_fit["launches"]}
        kernels.append(row(name, f"tpu_gaussians/ops/pallas/splat.py:{line}",
                           fit["launches"][name], sep, sep[0], **extra))
    kernels.append(row("sorted_bwd", "tpu_gaussians/ops/pallas/sorted.py:1013",
                       fit_s["launches"]["sorted_bwd"], bwd_cases,
                       bwd_cases[0], grad_max_err_over_scale=max(
                           grad_errs.values()),
                       blocks={c["case"]: [c["blocks"], c["tiles"]]
                               for c in bwd_cases},
                       **{k: {c["case"]: c[k] for c in bwd_cases} for k in (
                           "device_ms", "bound_share", "live_pairs",
                           "live_bound_ms", "live_bound_by",
                           "live_bound_share", "walked_share")}))
    extra = {k: {c["case"]: c[k] for c in v2_cases} for k in (
        "bound_term", "bound_terms_ms", "bound_ms_25flop", "sm_clock_mhz",
        "slices", "device_ms", "device_ms_main", "device_ms_slice_sum")}
    kernels.append(row("splat_v2_fwd", "tpu_gaussians/ops/pallas/splat.py:452",
                       fit_ea["launches"]["splat_v2_fwd"], v2_cases, v2_main,
                       launches_fit_sorted_preview=fit_s["launches"][
                           "splat_v2_fwd"],
                       launches_mixed_route=mixed_launches["splat_v2_fwd"],
                       ms_1M_ewa_view0=v1_cases[0]["k5_ms"],
                       # K5's sums against K9a's at 1M, off its route (one
                       # running f32 sum a pixel was 0.0089 off there).
                       k5_vs_k9a_max_abs_err_1M_ewa_view0=v1_cases[0][
                           "k5_vs_k9a_max_abs_err"],
                       mixed_route_500k_view0=mixed_check["k5"],
                       hmma_in_sass=hmma["splat_v2_fwd"],
                       ptxas=ptxas_lines("splat_v2_fwd"), **extra))
    v2b = [{"case": c["case"], "ms": c["bwd_ms"],
            "plain_ms": c["bwd_plain_ms"], "bound_ms": c["bwd_bound_ms"],
            "bound_by": c["bwd_bound_by"],
            "max_abs_err": c["bwd_max_abs_err"]} for c in v2_cases]
    extra = {k: {c["case"]: c[f"bwd_{k}"] for c in v2_cases} for k in (
        "bound_term", "bound_terms_ms", "bound_ms_52flop", "sm_clock_mhz",
        "slices", "device_ms", "device_ms_main", "device_ms_slice_sum")}
    kernels.append(row("splat_v2_bwd", "tpu_gaussians/ops/pallas/splat.py:510",
                       fit_ea["launches"]["splat_v2_bwd"], v2b, v2b[0],
                       ms_1M_ewa_view0=v1_cases[0]["k6_ms"],
                       hmma_in_sass=hmma["splat_v2_bwd"],
                       ptxas=ptxas_lines("splat_v2_bwd"), **extra))
    for name, kind_, line in (("binned_fwd", "fwd", 135),
                              ("binned_bwd", "bwd", 164)):
        bc = [{"case": c["case"], "ms": c[f"{kind_}_ms"],
               "plain_ms": c[f"{kind_}_plain_ms"],
               "bound_ms": c[f"{kind_}_bound_ms"],
               "bound_by": c[f"{kind_}_bound_by"],
               "max_abs_err": c[f"{kind_}_max_abs_err"]} for c in binned_cases]
        keys = (("bound_ms_22flop", "device_ms_slice_sum", "slice_len",
                 "slices", "live_slices") if name == "binned_fwd" else
                ("bound_ms_44flop", "device_ms_second_pass",
                 "device_launches_traced", "device_ms_per_launch",
                 "pixel_slices"))
        extra = {k: {c["case"]: c[f"{kind_}_{k}"] for c in binned_cases}
                 for k in ("bound_term", "bound_terms_ms", "device_ms",
                           "device_ms_main", "sm_clock_mhz", "partial_bytes",
                           "partial_ms") + keys}
        extra["hmma_in_sass"] = hmma[name]
        extra["ptxas"] = ptxas_lines(name)
        kernels.append(row(name, f"tpu_gaussians/ops/pallas/binned.py:{line}",
                           fit_eb["launches"][name], bc, bc[0], **extra))
    for name, kind_, line in (("binned_sep_fwd", "fwd", 258),
                              ("binned_sep_bwd", "bwd", 277)):
        bc = [{"case": c["case"], "ms": c[f"{kind_}_ms"],
               "plain_ms": c[f"{kind_}_plain_ms"],
               "bound_ms": c[f"{kind_}_bound_ms"],
               "bound_by": c[f"{kind_}_bound_by"],
               "max_abs_err": c[f"{kind_}_max_abs_err"]}
              for c in sep_binned_cases]
        keys = ("bound_term", "bound_terms_ms", "bound_ms_f32", "device_ms",
                "device_ms_main", "device_launches_traced",
                "device_ms_per_launch", "sm_clock_mhz")
        keys += (("device_ms_slice_sum", "slice_len", "slices",
                  "live_slices", "partial_bytes", "partial_ms", "library_ms",
                  "library_max_abs_diff") if name == "binned_sep_fwd" else
                 ("col_slices", "library_ms"))
        extra = {k: {c["case"]: c[f"{kind_}_{k}"] for c in sep_binned_cases}
                 for k in keys}
        # library_ms stays null: no single PyTorch call computes K7a's or
        # K7b's function; cuBLAS on their products alone is reported beside.
        extra["product_library_ms"] = extra.pop("library_ms")
        if name == "binned_sep_fwd":
            extra["product_library_max_abs_diff"] = extra.pop(
                "library_max_abs_diff")
        extra["hmma_in_sass"] = hmma[name]
        extra["ptxas"] = ptxas_lines(name)
        kernels.append(row(name, f"tpu_gaussians/ops/pallas/binned.py:{line}",
                           fit_ab["launches"][name], bc, bc[0], **extra))
    for name, kind_, line in (("splat_v1_fwd", "", 196),
                              ("splat_v1_bwd", "bwd_", 850)):
        vc = [{"case": c["case"], "ms": c[f"{kind_}ms"],
               "plain_ms": c[f"{kind_}plain_ms"],
               "bound_ms": c[f"{kind_}bound_ms"],
               "bound_by": c[f"{kind_}bound_by"],
               "max_abs_err": c[f"{kind_}max_abs_err"]} for c in v1_cases]
        extra = {k: v1_cases[0][f"{kind_}{k}"] for k in (
            "bound_term", "bound_terms_ms",
            "bound_ms_26flop" if name == "splat_v1_fwd" else
            "bound_ms_55flop")}
        extra["hmma_in_sass"] = hmma[name]
        if name == "splat_v1_bwd":
            extra["mixed_route_500k_view0"] = mixed_check["k9b"]
        kernels.append(row(name, f"tpu_gaussians/ops/pallas/splat.py:{line}",
                           exact_launches[name], vc, vc[0],
                           launches_per_step=exact_launches[name] // calls,
                           launches_mixed_route=mixed_launches[name],
                           **extra))
    for kind_ in ("fwd", "bwd"):
        sc = [{"case": c["case"], "ms": c[f"{kind_}_ms"],
               "plain_ms": c[f"{kind_}_plain_ms"],
               "bound_ms": c[f"{kind_}_bound_ms"],
               "bound_by": c[f"{kind_}_bound_by"],
               "max_abs_err": c[f"{kind_}_max_abs_err"]} for c in stage_cases]
        extra = {k: {c["case"]: c[f"{kind_}_{k}"] for c in stage_cases}
                 for k in ("device_ms", "device_launches_traced", "bytes",
                           "err_vs_float64")}
        extra["composition_autograd_ms"] = {
            c["case"]: c["composition_autograd_ms"] for c in stage_cases}
        extra["launches_fit_sorted"] = fit_s["launches"][f"stage_{kind_}"]
        extra["ptxas"] = ptxas_lines("stage")
        kernels.append(dict(row(
            "stage", "none (XLA fused tpu_gaussians/ops/common.py:"
            "prepare_splats)", fit["launches"][f"stage_{kind_}"], sc, sc[0],
            **extra), name=f"stage_{kind_}"))
    check([k["name"] for k in kernels] == [
        "sorted_fwd", "splat_sep_fwd", "splat_sep_bwd", "sorted_bwd",
        "splat_v2_fwd", "splat_v2_bwd", "binned_fwd", "binned_bwd",
        "binned_sep_fwd", "binned_sep_bwd", "splat_v1_fwd", "splat_v1_bwd",
        "stage_fwd", "stage_bwd"]
        and all(k["launches"] > 0 for k in kernels),
        "a kernel of the report was never launched on a main path")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
