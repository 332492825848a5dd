"""COLMAP sparse-model import: cameras and SfM points, the port's own copy
of `tpu_gaussians.io.colmap` (pure numpy; the port imports nothing of the
JAX package).

Real multiview datasets (Mip-NeRF360, Tanks&Temples, anything
COLMAP-reconstructed) ship a `sparse/0` model with `cameras`, `images` and
`points3D` in binary or text form. This module reads both forms and
converts to this package's conventions:

  view  COLMAP is x-right / y-down / z-forward (camera looks +z); this
        package is OpenGL-style (camera looks -z, y-up; core/camera.look_at).
        view_gl = diag(1,-1,-1,1) @ [R | t]  with X_cam = R @ X_w + t.
  proj  OpenGL perspective from the pinhole focal lengths:
        fovy = 2*atan(h / (2*fy)), aspect chosen so m00 = 2*fx/w
        (aspect = w*fy / (h*fx)).
  Principal-point offsets and radial distortion are IGNORED (a warning
  is printed when they are significant): the renderer's pinhole model is
  centered.

`points3D` feed `models.gaussian_model.init_params_from_points`, the
standard 3DGS initialization from the SfM point cloud.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple, Union

import numpy as np

from tpu_gaussians_torch.core.camera import perspective

# COLMAP camera models: id -> (name, num_params); params layouts below.
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),    # f, cx, cy, k
    3: ("RADIAL", 5),           # f, cx, cy, k1, k2
    4: ("OPENCV", 8),           # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME_TO_ID = {name: mid for mid, (name, _) in _CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # float64


class ColmapImage(NamedTuple):
    image_id: int
    qvec: np.ndarray    # (4,) w,x,y,z  world->cam rotation
    tvec: np.ndarray    # (3,)          world->cam translation
    camera_id: int
    name: str


def _read_bytes(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: Path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read_bytes(f, "<Q")
        for _ in range(n):
            cid, mid, w, h = _read_bytes(f, "<iiQQ")
            name, np_ = _CAMERA_MODELS[mid]
            params = np.array(_read_bytes(f, f"<{np_}d"))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_bin(path: Path) -> List[ColmapImage]:
    out = []
    with open(path, "rb") as f:
        (n,) = _read_bytes(f, "<Q")
        for _ in range(n):
            iid = _read_bytes(f, "<i")[0]
            q = np.array(_read_bytes(f, "<4d"))
            t = np.array(_read_bytes(f, "<3d"))
            (cid,) = _read_bytes(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read_bytes(f, "<Q")
            f.seek(npts * 24, 1)  # skip 2D points (x, y double + id int64)
            out.append(ColmapImage(iid, q, t, cid, name.decode("utf-8")))
    return out


def read_points3d_bin(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    xyz, rgb = [], []
    with open(path, "rb") as f:
        (n,) = _read_bytes(f, "<Q")
        for _ in range(n):
            _read_bytes(f, "<q")                       # point id
            xyz.append(_read_bytes(f, "<3d"))
            rgb.append(_read_bytes(f, "<3B"))
            _read_bytes(f, "<d")                       # error
            (tl,) = _read_bytes(f, "<Q")
            f.seek(tl * 8, 1)                          # track elements
    return (np.asarray(xyz, np.float32).reshape(-1, 3),
            np.asarray(rgb, np.float32).reshape(-1, 3) / 255.0)


def _data_lines(path: Path):
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            yield line


def read_cameras_txt(path: Path) -> Dict[int, ColmapCamera]:
    out = {}
    for line in _data_lines(path):
        parts = line.split()
        cid = int(parts[0])
        model = parts[1]
        out[cid] = ColmapCamera(cid, model, int(parts[2]), int(parts[3]),
                                np.array([float(x) for x in parts[4:]]))
    return out


def read_images_txt(path: Path) -> List[ColmapImage]:
    out = []
    lines = list(_data_lines(path))
    for i in range(0, len(lines), 2):  # image line + points2D line
        parts = lines[i].split()
        out.append(ColmapImage(
            int(parts[0]),
            np.array([float(x) for x in parts[1:5]]),
            np.array([float(x) for x in parts[5:8]]),
            int(parts[8]), parts[9]))
    return out


def read_points3d_txt(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    xyz, rgb = [], []
    for line in _data_lines(path):
        parts = line.split()
        xyz.append([float(x) for x in parts[1:4]])
        rgb.append([float(x) for x in parts[4:7]])
    return (np.asarray(xyz, np.float32).reshape(-1, 3),
            np.asarray(rgb, np.float32).reshape(-1, 3) / 255.0)


def read_model(model_dir: Union[str, Path]):
    """Read a COLMAP sparse model dir (binary preferred, text fallback).

    Returns (cameras dict, images list sorted by image name,
    points_xyz (P,3) f32, points_rgb (P,3) f32 in [0,1])."""
    d = Path(model_dir)
    if (d / "cameras.bin").exists():
        cams = read_cameras_bin(d / "cameras.bin")
        images = read_images_bin(d / "images.bin")
        pts = (read_points3d_bin(d / "points3D.bin")
               if (d / "points3D.bin").exists()
               else (np.zeros((0, 3), np.float32),
                     np.zeros((0, 3), np.float32)))
    elif (d / "cameras.txt").exists():
        cams = read_cameras_txt(d / "cameras.txt")
        images = read_images_txt(d / "images.txt")
        pts = (read_points3d_txt(d / "points3D.txt")
               if (d / "points3D.txt").exists()
               else (np.zeros((0, 3), np.float32),
                     np.zeros((0, 3), np.float32)))
    else:
        raise FileNotFoundError(
            f"no cameras.bin/cameras.txt in {d} — point --colmap_dir at "
            "the sparse model directory (usually <scene>/sparse/0)")
    # Deterministic view order matching the fit CLI's sorted target glob.
    images = sorted(images, key=lambda im: im.name)
    return cams, images, pts[0], pts[1]


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w,x,y,z) quaternion -> 3x3 rotation (world->cam)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _intrinsics(cam: ColmapCamera) -> Tuple[float, float, float, float]:
    """(fx, fy, cx, cy) from any supported model's params."""
    p = cam.params
    if cam.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV",
                     "THIN_PRISM_FISHEYE"):
        return float(p[0]), float(p[1]), float(p[2]), float(p[3])
    # single-focal models: f, cx, cy [, distortion...]
    return float(p[0]), float(p[0]), float(p[1]), float(p[2])


def colmap_to_view_proj(
    cams: Dict[int, ColmapCamera], images: List[ColmapImage],
    znear: float = 0.01, zfar: float = 100.0,
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """COLMAP model -> (view (V,4,4), proj (V,4,4), (width, height)).

    Matrices are float32 row-major in this framework's OpenGL-style
    convention (see module docstring)."""
    flip = np.diag([1.0, -1.0, -1.0])
    views, projs = [], []
    wh = None
    warned = False
    for im in images:
        cam = cams[im.camera_id]
        fx, fy, cx, cy = _intrinsics(cam)
        w, h = cam.width, cam.height
        if wh is None:
            wh = (w, h)
        if not warned:
            off = max(abs(cx - w / 2) / w, abs(cy - h / 2) / h)
            dist = (np.max(np.abs(cam.params[4 if cam.model == "OPENCV"
                                             else 3:]))
                    if cam.model not in ("PINHOLE", "SIMPLE_PINHOLE")
                    and cam.params.size > 3 else 0.0)
            if off > 0.01 or dist > 1e-3:
                print(f"[colmap] WARNING: principal-point offset "
                      f"({off:.3f} of frame) and/or distortion "
                      f"({dist:.4f}) ignored (centered pinhole model)")
                warned = True

        rot = qvec_to_rotmat(im.qvec)
        view = np.eye(4, dtype=np.float64)
        view[:3, :3] = flip @ rot
        view[:3, 3] = flip @ im.tvec
        views.append(view.astype(np.float32))

        fovy_deg = float(np.degrees(2.0 * np.arctan(h / (2.0 * fy))))
        aspect = (w * fy) / (h * fx)
        projs.append(perspective(fovy_deg, float(aspect), znear, zfar,
                                 device="cpu").numpy())
    return (np.stack(views).astype(np.float32),
            np.stack(projs).astype(np.float32), wh)
