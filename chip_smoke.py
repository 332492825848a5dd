#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and hold each of
its CUDA kernels against its plain PyTorch twin.

  python3 chip_smoke.py [--seed 0]

Run from the root of a checkout (it imports `tpu_gaussians_torch` from
beside itself and builds the kernels from `tpu_gaussians_torch/csrc/`).
Phases, each of which fails the run by raising:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc for every kernel source, all started together
  3. scene    a synthetic 100,000-gaussian scene from --seed, written as a
              reference-schema npz (means U(-1,1)^3, scales U(0.005,0.03),
              colors U(0,1), opacities U(0.2,0.9))
  4. serve    cli.serve's RenderService on cuda, interactive preset, behind
              its HTTP handler on 127.0.0.1: /info, then 960x540 frames as
              jpg, png and raw; the raw frame is held against the same pose
              rendered through the kernel's plain twin (<= 1 LSB on <= 0.1%
              of values)
  5. loop     cli.serve.run_loop, 50 frames (its JSON line)
  6. kernel   the compositing kernel vs its plain twin on the main path's
              inputs: 100k at 960x540 under both presets and 1M under the
              interactive one; image and alpha within rtol 1e-4 / atol 1e-5,
              and within exit_t on tiles whose whole-tile early-exit
              decision differs; CUDA-event times, median of 20 after
              warm-up; and a small scene through render(impl="tiled")
              against the whole-frame plain renderer
  7. report   one `kernels` JSON line, the nvidia-smi line, and last
              {"ok": true, "device": {...}}

The kernel launch counters are set to 0 just before phase 4 and read
just after phase 5: every kernel of the path must have launched there.
It exits non-zero, printing no result, without a CUDA device or outside a
checkout.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per (slot, pixel) the compositing evaluates: the alpha
# product and exponent terms, cutoff and clamp, T*a, four multiply-adds into
# r, g, b, z (two each) and the transmittance update.
SORTED_FLOPS_PER_EVAL = 16

def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def scene_arrays(n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return dict(
        means=rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.005, 0.03, (n, 3)).astype(np.float32),
        colors=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.9, (n,)).astype(np.float32))


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


def kernel_case(name, g, width, height, knobs, reps):
    """Kernel vs plain twin on one frame's compositing inputs."""
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import RenderConfig
    from tpu_gaussians_torch.kernels import sorted_fwd
    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.ops.binning import EXIT_T, NBS, TPS
    from tpu_gaussians_torch.ops.common import prepare_splats
    from tpu_gaussians_torch.ops.projection import camera_z

    cfg = RenderConfig(width=width, height=height, mode="sorted", **knobs)
    exit_t = cfg.sorted_exit_t or EXIT_T
    c = cam.orbit_cameras(8, width, height, device="cuda")[1]
    with torch.no_grad():
        s = prepare_splats(g, c.view, c.proj, width, height)
        gdense, cnt, tiles_x, tiles_y, stats = tiled.tile_lists(
            s, camera_z(g.means, c.view), height, width,
            cfg.sorted_band_capacity, cfg.sorted_pair_k)
        acc_k, chunks_k = sorted_fwd.sorted_tiles(gdense, cnt, tiles_x,
                                                  axis=True, exit_t=exit_t)
        acc_p, chunks_p = sorted_fwd.sorted_tiles_plain(
            gdense, cnt, tiles_x, axis=True, exit_t=exit_t)
        torch.cuda.synchronize()
        bg = torch.zeros(3, device="cuda")
        img_k, al_k, _ = tiled.resolve_sorted(acc_k, bg, tiles_y, tiles_x,
                                              height, width)
        img_p, al_p, _ = tiled.resolve_sorted(acc_p, bg, tiles_y, tiles_x,
                                              height, width)
        for t in (img_k, al_k):
            check(bool(torch.isfinite(t).all()), f"{name}: non-finite output")
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
        check(ok_same and ok_diff,
              f"{name}: kernel and plain twin disagree (max abs err "
              f"{max_err}, {tiles_differ} tiles with another exit)")

        k_ms = time_ms(lambda: sorted_fwd.sorted_tiles(
            gdense, cnt, tiles_x, axis=True, exit_t=exit_t), reps)
        p_ms = time_ms(lambda: sorted_fwd.sorted_tiles_plain(
            gdense, cnt, tiles_x, axis=True, exit_t=exit_t), reps)

    # The least the card could take for this run's work: the slots the
    # tiles composited (up to their exit), each read once (64 B), cnt
    # read and the (8, pixels) f32 output and chunk counts written once.
    n_tiles = cnt.shape[0]
    slots = int(torch.minimum(cnt, chunks_k * NBS).sum())
    nbytes = slots * 64 + n_tiles * 4 + 8 * 4 * n_tiles * TPS + n_tiles * 4
    flops = SORTED_FLOPS_PER_EVAL * slots * TPS
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / F32_FLOPS_PER_S
    case = {
        "case": name, "n": g.capacity, "width": width, "height": height,
        "tiles": n_tiles, "cap": gdense.shape[0] // n_tiles,
        "exit_t": exit_t, "slots_composited": slots,
        "slots_listed": int(cnt.sum()),
        "tiles_exit_differs": tiles_differ, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "stats": {k: int(v) for k, v in stats.items()},
    }
    log("kernel case " + json.dumps(case))
    return case


def profile_frames(svc, width: int, height: int, frames: int = 10) -> dict:
    """Device time per frame by CUDA kernel, from torch.profiler over
    `frames` back-to-back renders; the device's busy share of the wall
    time (the profiler's own host overhead included); and the top-level
    torch operations the host dispatches per frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(frames):
            svc.render_tensor(0.013 * (2000 + i), 0.2, 2.5, width, height,
                              "sorted")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / frames
    rows = [{"kernel": e.key[:90],
             "ms_per_frame": e.self_device_time_total / 1e3 / frames,
             "calls_per_frame": e.count / frames}
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["ms_per_frame"])
    busy = sum(r["ms_per_frame"] for r in rows)
    host_ops = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CPU and e.cpu_parent is None
                   and e.name.startswith("aten::"))
    return {"n": svc.n, "preset": svc.preset, "frames": frames,
            "wall_ms_per_frame": wall_ms,
            "device_busy_ms_per_frame": busy if rows else None,
            "device_busy_share": busy / wall_ms if rows else None,
            "kernels_per_frame": sum(r["calls_per_frame"] for r in rows),
            "host_ops_per_frame": host_ops / frames,
            "top": rows[:12]}


def small_reference_check() -> None:
    """render(impl="tiled") with the kernel against the whole-frame plain
    renderer on a small scene."""
    import numpy as np
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import (
        RenderConfig, gaussians_from_numpy)
    from tpu_gaussians_torch.ops.dispatch import render

    arr = scene_arrays(2000, 7)
    arr["scales"] *= 4.0
    g = gaussians_from_numpy(arr, device="cuda")
    c = cam.orbit_cameras(2, 256, 64, device="cuda")
    cfg = RenderConfig(width=256, height=64, mode="sorted", return_aux=True)
    with torch.no_grad():
        tiled = render(g, c, cfg.replace(impl="tiled"))
        plain = render(g, c, cfg.replace(impl="torch"))
    for t, p in zip(tiled[:2], plain[:2]):
        check(t.shape == p.shape and bool(torch.isfinite(t).all()),
              "small render: bad shape or non-finite values")
        check(bool(torch.allclose(t, p, rtol=1e-4, atol=1e-5)),
              "small render: tiled and plain renderers disagree "
              f"(max abs err {float((t - p).abs().max())})")
    log("small scene: render(impl='tiled') == render(impl='torch') "
        f"(max abs err {float((tiled[0] - plain[0]).abs().max())})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    check((ROOT / "tpu_gaussians_torch" / "__init__.py").exists(),
          "tpu_gaussians_torch/ not found beside chip_smoke.py: run it from "
          "the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False

    from tpu_gaussians_torch.cli.serve import (
        INTERACTIVE_KNOBS, RenderService, run_loop)
    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import (
        Camera, gaussians_from_numpy, make_gaussians)
    from tpu_gaussians_torch.io.npz import save_gaussians_npz
    from tpu_gaussians_torch.kernels import build, sorted_fwd
    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.ops.common import prepare_splats
    from tpu_gaussians_torch.ops.projection import camera_z

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
    sorted_fwd.launches = 0
    svc.frames = 0
    served = serve_phase(svc, width, height, pose)
    loop = run_loop(svc, frames=50, width=width, height=height,
                    mode="sorted", fmt="jpg")
    launches = {"sorted_fwd": sorted_fwd.launches}
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

    # 6. kernel vs plain twin at full size
    g_big = cells["1M_interactive"].gaussians
    cases = [
        kernel_case("100k_960x540_interactive", svc.gaussians, width,
                    height, INTERACTIVE_KNOBS, reps=20),
        kernel_case("100k_960x540_quality", svc.gaussians, width, height,
                    {}, reps=20),
        kernel_case("1M_960x540_interactive", g_big, width, height,
                    INTERACTIVE_KNOBS, reps=20),
    ]
    del g_big, cells
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"after kernel timing: sm clock, power, limit, temperature: "
        f"{clocks.stdout.strip()}")
    small_reference_check()
    tmp.cleanup()

    # 7. report
    main_case = cases[0]
    kernels = [{
        "name": "sorted_fwd", "route": "cuda",
        "source": "tpu_gaussians_torch/csrc/sorted_fwd.cu",
        "replaces": "tpu_gaussians/ops/pallas/sorted.py:221",
        "launches": launches["sorted_fwd"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "cases": [{k: c[k] for k in ("case", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "max_abs_err",
                                     "tiles_exit_differs")}
                  for c in cases],
    }]
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
