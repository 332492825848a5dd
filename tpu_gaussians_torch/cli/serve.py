"""Render server: serve rendered frames of a fitted model over HTTP.

The server half of the split-viewer design, the counterpart of
`tpu_gaussians.cli.serve`. Loads a fitted npz once (resident on the device
across requests) and answers:

  GET /        -> the interactive mouse-orbit viewer client
                  (viewer_client.html; the reference viewer's controls)
  GET /render?yaw=0.5&pitch=0.2&radius=2.5&width=640&height=480
      &mode=sorted&format=jpg|png|raw
      -> one frame: jpg, png (lossless), or raw (RGBA bytes, no encode).
         The response carries X-Render-Ms / X-Encode-Ms timing headers.
  GET /info  -> application/json model + config summary

Usage:
  python -m tpu_gaussians_torch.cli.serve model.npz --port 8008 \
      [--impl auto] [--device cuda] [--footprint auto]
then open http://127.0.0.1:8008/ in a browser.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from tpu_gaussians_torch.core import camera as cam
from tpu_gaussians_torch.core.types import (
    Camera, RenderConfig, resolve_device, resolve_footprint, to_device)
from tpu_gaussians_torch.io.npz import load_gaussians_npz
from tpu_gaussians_torch.ops.dispatch import render
from tpu_gaussians_torch.utils.profiling import annotate

# The interactive preset's sorted-path forward-quality knobs: pair budget
# 8, early exit at T 1e-3, tile capacity 1024.
INTERACTIVE_KNOBS = dict(sorted_pair_k=8, sorted_exit_t=1e-3,
                         sorted_band_capacity=1024)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("npz", help="Fitted gaussians npz")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--impl", choices=["auto", "torch", "tiled"],
                    default="auto")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--fovy", type=float, default=60.0)
    ap.add_argument("--footprint", choices=["auto", "axis", "ewa"],
                    default="auto",
                    help="auto: ewa when the model carries quaternions "
                         "(cli.fit --footprint ewa, a 3DGS PLY), else axis")
    ap.add_argument("--preset", choices=["quality", "interactive"],
                    default="interactive",
                    help="interactive: sorted-path forward-quality knobs "
                         "(pair budget 8, early-exit 1e-3, tile cap 1024); "
                         "quality: exact-default knobs")
    ap.add_argument("--loop", type=int, default=0, metavar="FRAMES",
                    help="measure instead of serve: run FRAMES sustained "
                         "render+fetch+encode cycles server-side (no "
                         "HTTP, depth-2 pipeline so the device overlaps "
                         "the host fetch/encode), print a JSON timing "
                         "split incl. device ms/frame from CUDA events "
                         "and the co-located FPS bound, then exit")
    ap.add_argument("--loop-width", type=int, default=960)
    ap.add_argument("--loop-height", type=int, default=540)
    ap.add_argument("--loop-mode", default="sorted")
    ap.add_argument("--loop-format", default="jpg",
                    choices=["jpg", "png", "raw"])
    ap.add_argument("--encode-workers", type=int, default=2,
                    help="JPEG encode thread pool size for --loop "
                         "(frames are independent; PIL releases the GIL)")
    ap.add_argument("--jpg-quality", type=int, default=90)
    ap.add_argument("--jpg-subsampling", type=int, default=-1,
                    help="-1 encoder default (4:4:4), 2 = 4:2:0")
    return ap


class RenderService:
    """Holds the device-resident model and renders frames on demand.

    Renders are serialised by a lock: the server's threads share one
    device, and `frames` counts every frame rendered. Under a profiler a
    frame is the span `gs.serve.frame`, and its time in `render_tensor`
    the spans `gs.serve.lock_wait` (the queue for the lock) and
    `gs.serve.render` (camera, render and quantise, under the lock).
    Every frame is drawn with `footprint`, resolved once at load (see
    `core.types.resolve_footprint`)."""

    def __init__(self, npz_path: str, impl: str = "auto", fovy: float = 60.0,
                 preset: str = "interactive", device: str = "cuda",
                 footprint: str = "auto"):
        self.device = resolve_device(device)
        self.impl = impl
        self.fovy = fovy
        self.preset = preset
        self.gaussians = load_gaussians_npz(npz_path, device=self.device)
        self.footprint = resolve_footprint(footprint, self.gaussians)
        self.n = int(self.gaussians.means.shape[0])
        self.frames = 0
        self._lock = threading.Lock()
        self._configs = {}

    def config(self, width: int, height: int, mode: str) -> RenderConfig:
        key = (width, height, mode)
        if key not in self._configs:
            knobs = (INTERACTIVE_KNOBS
                     if self.preset == "interactive" and mode == "sorted"
                     else {})
            self._configs[key] = RenderConfig(
                width=width, height=height, mode=mode, impl=self.impl,
                footprint=self.footprint, background=(0.02, 0.02, 0.02),
                **knobs)
        return self._configs[key]

    def camera(self, yaw: float, pitch: float, radius: float, width: int,
               height: int) -> Camera:
        """The orbit camera of a request, built in f32 on the device."""
        yaw_t, pitch_t, radius_t = to_device([yaw, pitch, radius],
                                             self.device)
        eye = torch.stack([radius_t * torch.cos(pitch_t) * torch.sin(yaw_t),
                           radius_t * torch.sin(pitch_t),
                           radius_t * torch.cos(pitch_t) * torch.cos(yaw_t)])
        view = cam.look_at(eye, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
        proj = cam.perspective(self.fovy, width / height, 0.01, 100.0,
                               device=self.device)
        return Camera(view=view, proj=proj)

    def render_tensor(self, yaw: float, pitch: float, radius: float,
                      width: int, height: int, mode: str) -> torch.Tensor:
        """One frame as (H, W, 3) uint8 on the device, quantised there (the
        u8 frame is a quarter of the f32 one to fetch)."""
        for v in (yaw, pitch, radius):
            if not math.isfinite(v):
                raise ValueError(f"camera parameters must be finite, got {v}")
        with annotate("gs.serve.lock_wait"):
            self._lock.acquire()
        try:
            with annotate("gs.serve.render"), torch.no_grad():
                img = render(self.gaussians,
                             self.camera(yaw, pitch, radius, width, height),
                             self.config(width, height, mode))
                self.frames += 1
                return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
        finally:
            self._lock.release()

    def render_frame(self, yaw: float, pitch: float, radius: float,
                     width: int, height: int, mode: str) -> np.ndarray:
        """One frame fetched to the host; the span `gs.serve.frame`."""
        with annotate("gs.serve.frame", root=True):
            return self.render_tensor(yaw, pitch, radius, width, height,
                                      mode).cpu().numpy()


def encode_frame(img: np.ndarray, fmt: str, quality: int = 90,
                 subsampling: int = -1):
    """HWC image (uint8, or float [0,1]) -> (bytes, content_type) for
    `fmt` (raw = RGBA8 bytes for a canvas ImageData; jpg/png via PIL)."""
    u8 = (img if img.dtype == np.uint8
          else (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
    if fmt == "raw":
        rgba = np.concatenate(
            [u8, np.full(u8.shape[:2] + (1,), 255, np.uint8)], axis=2)
        return rgba.tobytes(), "application/octet-stream"
    from PIL import Image

    buf = io.BytesIO()
    if fmt == "jpg":
        Image.fromarray(u8).save(buf, "JPEG", quality=quality,
                                 subsampling=subsampling)
        return buf.getvalue(), "image/jpeg"
    Image.fromarray(u8).save(buf, "PNG")
    return buf.getvalue(), "image/png"


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path in ("/", "/index.html"):
                html = Path(__file__).parent / "viewer_client.html"
                self._send(200, html.read_bytes(), "text/html; charset=utf-8")
                return
            if url.path == "/info":
                body = json.dumps({
                    "num_gaussians": service.n,
                    "impl": service.impl,
                    "preset": service.preset,
                    "footprint": service.footprint,
                    "device": str(service.device),
                    "sh": service.gaussians.sh is not None,
                    "quats": service.gaussians.quats is not None,
                }).encode()
                self._send(200, body, "application/json")
                return
            if url.path != "/render":
                self.send_response(404)
                self.end_headers()
                return
            q = parse_qs(url.query)
            get = lambda k, d: float(q.get(k, [d])[0])
            try:
                t0 = time.perf_counter()
                img = service.render_frame(
                    yaw=get("yaw", 0.0), pitch=get("pitch", 0.2),
                    radius=get("radius", 2.5),
                    width=int(get("width", 640)),
                    height=int(get("height", 480)),
                    mode=q.get("mode", ["sorted"])[0],
                )
                t1 = time.perf_counter()
                body, ctype = encode_frame(img, q.get("format", ["png"])[0])
                t2 = time.perf_counter()
            except (ValueError, NotImplementedError) as e:  # bad params -> 400
                self._send(400, str(e).encode(), "text/plain")
                return
            self._send(200, body, ctype, extra=(
                ("X-Render-Ms", f"{(t1 - t0) * 1e3:.1f}"),
                ("X-Encode-Ms", f"{(t2 - t1) * 1e3:.1f}"),
                # The interactive preset is an approximation; say which.
                ("X-Preset", service.preset),
            ))

    return Handler


def run_loop(service: RenderService, frames: int, width: int, height: int,
             mode: str, fmt: str, encode_workers: int = 2,
             quality: int = 90, subsampling: int = -1) -> dict:
    """Sustained server-side render loop: no HTTP, a depth-2 pipeline
    (issue frame i+1 before fetching frame i, the fetch a non-blocking
    copy into pinned memory) so the device renders while the host fetches
    and encodes, then a timed re-run of back-to-back frames between CUDA
    events for the device ms per frame (None on the CPU: there is no
    device clock to read).

    Prints one JSON line and returns it as a dict: sustained fps through
    this host, the dispatch/fetch/encode wall split, device ms/frame, and
    the implied co-located bound 1/max(device, encode/workers) for a
    pipelined server. encode_workers > 1 runs the encodes in a thread
    pool (frames are independent and PIL's compressor releases the GIL).
    """
    on_cuda = service.device.type == "cuda"

    def issue(i):
        img = service.render_tensor(0.013 * i, 0.2, 2.5, width, height, mode)
        if not on_cuda:
            return img, None
        host = torch.empty(img.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(img, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def fetch(pending):
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy()

    def encode(host):
        te = time.perf_counter()
        encode_frame(host, fmt, quality=quality, subsampling=subsampling)
        return time.perf_counter() - te

    fetch(issue(0))  # build + warm

    workers = max(1, encode_workers)
    dispatch_s = fetch_s = 0.0
    pending, enc_futs = [], []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        t0 = time.perf_counter()

        def drain_one():
            nonlocal fetch_s
            tf = time.perf_counter()
            host = fetch(pending.pop(0))
            fetch_s += time.perf_counter() - tf
            enc_futs.append(pool.submit(encode, host))

        for i in range(frames):
            td = time.perf_counter()
            pending.append(issue(i))
            dispatch_s += time.perf_counter() - td
            if len(pending) > 1:
                drain_one()
        while pending:
            drain_one()
        encode_s = sum(f.result() for f in enc_futs)
        total_s = time.perf_counter() - t0

    device_ms = None
    if on_cuda:
        k = min(frames, 20)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for i in range(k):
            service.render_tensor(0.013 * (1000 + i), 0.2, 2.5, width,
                                  height, mode)
        end.record()
        end.synchronize()
        device_ms = start.elapsed_time(end) / k

    encode_ms = 1e3 * encode_s / frames
    out = {
        "frames": frames, "width": width, "height": height,
        "mode": mode, "format": fmt, "preset": service.preset,
        "n_gaussians": service.n, "encode_workers": workers,
        "jpg_quality": quality, "jpg_subsampling": subsampling,
        "device": (torch.cuda.get_device_name(service.device) if on_cuda
                   else "cpu"),
        "sustained_fps_this_host": frames / total_s,
        "dispatch_ms_per_frame": 1e3 * dispatch_s / frames,
        "fetch_ms_per_frame": 1e3 * fetch_s / frames,
        "encode_ms_per_frame": encode_ms,
        "device_ms_per_frame": device_ms,
        # Pipelined co-located server: device and host encode overlap.
        "colocated_fps_bound": (1e3 / max(device_ms, encode_ms / workers)
                                if device_ms is not None else None),
    }
    print(json.dumps(out))
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    service = RenderService(args.npz, args.impl, args.fovy, args.preset,
                            device=args.device, footprint=args.footprint)
    if args.loop:
        run_loop(service, args.loop, args.loop_width, args.loop_height,
                 args.loop_mode, args.loop_format,
                 encode_workers=args.encode_workers,
                 quality=args.jpg_quality,
                 subsampling=args.jpg_subsampling)
        return
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(service))
    print(f"serving {service.n} gaussians on http://{args.host}:{args.port} "
          f"(GET /render?yaw=..&pitch=..&radius=..)")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
