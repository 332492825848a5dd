"""Serve traffic: closed-loop viewer clients of tpu_gaussians_torch's
`cli.serve.RenderService`.

Set-up writes the configuration's scene as the npz `cli.serve` loads
(under TMPDIR, deleted once loaded), builds the service with the mix's
preset, and renders `warm_frames` frames. In the window each of `clients`
threads asks `render_frame` (the HTTP handler's call: the frame rendered
on the card and fetched as a host uint8 array) for its next frame only
once it holds the previous one, on its own seeded orbit path: yaw
advancing by `yaw_step`, pitch and radius from the mix's fixed lists.

A traced run first runs the clients, untraced, for `tail_seconds`, and
reads the 95th percentile of every frame's time from request to host
array there: a closed loop keeps the service saturated, so the rate is the
end-to-end metric and the tail a reading of the service layer. Then two
profiler windows follow (see `traced`).

The check renders a seeded sample of the run's frames (drawn from the one
in `keep_every` whose bytes the run holds) with the plain reference, under
the configuration's representation and the preset's knobs
(`reference.render.sorted_knobs`), and compares the served bytes with it.
"""

from __future__ import annotations

import gc
import os
import random
import threading
import time
from pathlib import Path

import numpy as np
import torch

from gsbench import counts, scene
from gsbench import trace as tr_mod
from gsbench.reference import render as R


def write_npz(g: dict, cfg: dict, path: Path) -> None:
    """The scene in the reference npz schema that cli.serve loads: colours
    the clamped DC term, quaternions only for the EWA footprint."""
    def host(t):
        return t.detach().cpu().numpy().astype(np.float32)

    sh = host(g["sh"])
    dc = (0.5 + scene.SH_C0 * sh[:, 0, :] if cfg["sh_basis"] == "3dgs"
          else sh[:, 0, :])
    arrays = {"means": host(g["means"]), "scales": host(g["scales"]),
              "opacities": host(g["opacities"]),
              "colors": np.clip(dc, 0.0, 1.0), "sh_coeffs": sh}
    if "quats" in g:
        q = host(g["quats"])
        arrays["quaternions"] = q / (np.linalg.norm(q, axis=1, keepdims=True)
                                     + 1e-12)
    np.savez(path, **arrays)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    s = sorted(values)
    return s[max(0, min(len(s) - 1, int(np.ceil(q / 100.0 * len(s))) - 1))]


class Run:
    def __init__(self, cell: dict, seed: int, device, tmpdir: Path, log):
        from tpu_gaussians_torch.cli.serve import RenderService
        from tpu_gaussians_torch.kernels import build

        self.cell, self.seed, self.device, self.tmpdir = cell, seed, device, tmpdir
        self.log = log
        tr = self.tr = cell["traffic"]
        if device.type == "cuda":
            prebuilt = {k: build.library_path(k).exists() for k in tr["kernels"]}
        self.scene = scene.make_scene(cell["config"], seed, device)
        path = Path(tmpdir) / f"gsbench_scene_{os.getpid()}.npz"
        try:
            write_npz(self.scene, cell["config"], path)
            self.svc = RenderService(str(path), impl="auto", fovy=tr["fovy"],
                                     preset=tr["preset"], device=device.type)
        finally:
            path.unlink(missing_ok=True)
        self.paths = [scene.orbit_path(tr["path"], seed, f"client{c}",
                                       tr["max_frames_per_client"])
                      for c in range(tr["clients"])]
        self.next = [0] * tr["clients"]
        self.frames = []          # (client, pose, t0, t1, host frame)
        for j in range(tr["warm_frames"]):
            self.frame(j % tr["clients"], keep=False)
        if device.type == "cuda":
            torch.cuda.synchronize()
            built = sorted(k for k, pre in prebuilt.items() if not pre)
            log("kernels: " + ("every library loaded from "
                               "tpu_gaussians_torch/_build/" if not built
                               and not build.logs else
                               f"built this run: {sorted(build.logs)}"))
        self.attempted = self.failed = 0
        self.traced_poses = {}

    def frame(self, c: int, keep: bool = True):
        tr = self.tr
        pose = self.paths[c][self.next[c] % len(self.paths[c])]
        self.next[c] += 1
        t0 = time.perf_counter()
        img = self.svc.render_frame(*pose, tr["width"], tr["height"], "sorted")
        t1 = time.perf_counter()
        if keep:
            # Every frame's timing is kept; its bytes only for the frames
            # a seeded draw may check (one in keep_every), which bounds
            # the host memory a long window holds.
            held = scene.subseed(self.seed, f"keep{c}:{self.next[c]}") \
                % tr["keep_every"] == 0
            self.frames.append((c, pose, t0, t1, img if held else None))
        return pose

    def clients(self, seconds: float = 0.0, per_client: int = 0):
        """Run every client until `seconds` have passed (or for
        `per_client` frames each); -> (frames, t_start, t_end)."""
        first = len(self.frames)
        errors = []
        t_start = time.perf_counter()
        end = t_start + seconds

        def client(c):
            try:
                j = 0
                while (time.perf_counter() < end if per_client == 0
                       else j < per_client):
                    self.frame(c)
                    j += 1
            except Exception as e:      # counted as failed, reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(self.tr["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_end = time.perf_counter()
        if errors:
            self.log(f"client errors: {errors[:3]}")
        self.attempted += len(self.frames) - first + len(errors)
        self.failed += len(errors)
        return self.frames[first:], t_start, t_end

    def window(self, seconds: float) -> dict:
        frames, t0, t1 = self.clients(seconds=seconds)
        lat = [(f[3] - f[2]) * 1e3 for f in frames]
        self.frame_ms_p95 = percentile(lat, 95)
        self.log(f"window: {len(frames)} frames in {t1 - t0:.4f} s, frame "
                 f"ms median {percentile(lat, 50):.3f}, p95 "
                 f"{self.frame_ms_p95:.3f}")
        self.window_frames = frames
        return {"serve_fps": {"value": len(frames) / (t1 - t0),
                              "unit": "frames/s"}}

    def traced(self) -> dict:
        tr = self.tr
        self.window(tr["tail_seconds"])
        facts = {"kind": "serve", "frame_ms_p95": self.frame_ms_p95}
        poses = {}

        def run_a():
            frames, _, _ = self.clients(per_client=tr["trace_frames_per_client"])
            poses["a"] = [f[1] for f in frames]
            return len(frames)

        def run_b():
            poses["b"] = [self.frame(0) for _ in range(tr["trace_frames_seq"])]
            self.attempted += len(poses["b"])
            return len(poses["b"])

        # (a) the card alone, the clients at their own pace: idle share,
        # mfu; (b) frames one after another with host operators and Python
        # frames: host operations, and which layer launched each kernel.
        facts["a"] = tr_mod.profile_window(run_a, False, tr["trace_pad_s"],
                                           self.tmpdir, host=False)
        facts["b"] = tr_mod.profile_window(run_b, True, tr["trace_pad_s"],
                                           self.tmpdir)
        self.window_frames = self.frames
        self.traced_poses = poses
        self.facts = facts
        return facts

    def release(self) -> None:
        self.svc = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_frame(self, pose):
        """The reference's frame (H, W, 3) u8 for a pose, and its counted
        pairs and listed rows."""
        tr, cfg = self.tr, self.cell["config"]
        w, h = tr["width"], tr["height"]
        k, cap, exit_t = R.sorted_knobs(cfg["num_gaussians"], tr["preset"])
        with torch.no_grad():
            view = R.look_at(R.orbit_eye(*pose), self.device)
            proj = R.perspective(tr["fovy"], w / h, 0.01, 100.0, self.device)
            st = R.screen_stage(self.scene, view, proj, w, h, cfg)
            slots, cnt = R.tile_lists(st, w, h, k, cap)
            acc, pairs = R.composite_frame(R.rows_table(st), slots, cnt, w, h,
                                           exit_t=exit_t)
            return (R.to_u8(R.resolve(acc, R.VIEWER_BACKGROUND)), pairs,
                    int(cnt.sum()))

    def count_work(self) -> None:
        tr, cfg = self.tr, self.cell["config"]
        for name, poses in self.traced_poses.items():
            fwd = frame = counts.Work()
            for pose in poses:
                _, pairs, listed = self.reference_frame(pose)
                pixels = tr["width"] * tr["height"]
                fwd = fwd + counts.composite_fwd(pairs, listed, pixels,
                                                 cfg["footprint"])
                frame = frame + counts.serve_frame(pairs, listed, pixels, cfg)
            self.facts[f"work_{name}"] = {"composite_fwd": fwd, "frame": frame}

    def sample(self):
        """The frames the check compares: a seeded sample of the window's."""
        frames = [f for f in self.window_frames if f[4] is not None]
        pick = random.Random(scene.subseed(self.seed, "sample")).sample(
            range(len(frames)), min(self.tr["check_frames"], len(frames)))
        return [frames[i] for i in pick]

    def outputs(self):
        return [f[4] for f in self.sample()]

    def reference_outputs(self, tf32: bool = False):
        """The plain reference's frames of the sample's poses; tf32 runs it
        with TF32 products, the control."""
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return [self.reference_frame(f[1])[0] for f in self.sample()]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def compare(self, prog, ref) -> list:
        return compare(list(zip(prog, ref)), self.cell["limits"])

    def check(self):
        return self.compare(self.outputs(), self.reference_outputs())


def compare(pairs, lim) -> list:
    """[(name, value, limit)] over (served u8, reference u8) frames: the
    largest share of a frame's values more than 1 apart, and the largest
    mean absolute difference in 8-bit steps."""
    over, mean = 0.0, 0.0
    for served, ref in pairs:
        d = (torch.as_tensor(served).cpu().to(torch.int32)
             - torch.as_tensor(ref).cpu().to(torch.int32)).abs().float()
        over = max(over, float((d > 1).float().mean()))
        mean = max(mean, float(d.mean()))
    return [("share_off_by_2_or_more", over, lim["share_off_by_2_or_more"]),
            ("mean_abs_lsb", mean, lim["mean_abs_lsb"])]
