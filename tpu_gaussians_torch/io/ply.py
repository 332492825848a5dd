"""PLY import/export in the standard 3D-Gaussian-Splatting convention, as
`tpu_gaussians.io.ply` writes and reads it (the ecosystem format of
INRIA-3DGS-style tools and web splat viewers):

  x, y, z                    gaussian centers
  f_dc_0..2                  SH degree-0 color: (rgb - 0.5) / C0,
                             C0 = 0.28209479177387814
  f_rest_*                   higher SH terms, channel-major like 3DGS:
                             9 values for degree 1, 24 for degree 2, 45
                             for degree 3 (zeros when absent)
  opacity                    logit(opacity)   (they apply sigmoid)
  scale_0..2                 log(scale)       (they apply exp)
  rot_0..3                   wxyz quaternion  (they normalize)

Binary little-endian PLY, float32 properties, alive rows only. The file is
made and parsed with numpy (no plyfile), with the JAX package's arithmetic
in the same order, so both packages write the same bytes for one model.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from tpu_gaussians_torch.core.types import Device, Gaussians, make_gaussians

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def save_gaussians_ply(path: Union[str, Path], g: Gaussians) -> None:
    """Write activated Gaussians (alive rows only) as a 3DGS-style PLY."""
    alive = _host(g.alive_mask()) > 0.5
    means = _host(g.means)[alive]
    scales = _host(g.scales)[alive]
    opac = _host(g.opacities)[alive]
    n = means.shape[0]

    if g.use_sh and g.sh.shape[1] > 4:
        # 3DGS-convention coefficients (ops/sh.py): written verbatim.
        sh = _host(g.sh)[alive]                        # (N, 9|16, 3)
        f_dc = sh[:, 0, :]
        k_rest = sh.shape[1] - 1
        f_rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, 3 * k_rest)
    elif g.use_sh:
        sh = _host(g.sh)[alive]                        # (N,4,3) [dc,c1x,c1y,c1z]
        f_dc = (np.clip(sh[:, 0, :], 0.0, 1.0) - 0.5) / SH_C0
        # The reference SH-1 basis is the direction components directly
        # (ops/sh.py); 3DGS uses real SH Y1m with fixed signs:
        #   Y1-1 = -C1*y, Y10 = C1*z, Y11 = -C1*x.
        c1x, c1y, c1z = sh[:, 1, :], sh[:, 2, :], sh[:, 3, :]
        rest = np.stack([-c1y / SH_C1, c1z / SH_C1, -c1x / SH_C1], axis=1)
        # channel-major like 3DGS: (N, 3 coeffs, 3 channels) -> (N, 9)
        f_rest = rest.transpose(0, 2, 1).reshape(n, 9)
    else:
        colors = np.clip(_host(g.colors)[alive], 1e-6, 1 - 1e-6)
        f_dc = (colors - 0.5) / SH_C0
        f_rest = np.zeros((n, 9), np.float32)

    opac = np.clip(opac, 1e-6, 1 - 1e-6)
    logit_op = np.log(opac / (1.0 - opac)).astype(np.float32)
    log_scales = np.log(np.maximum(scales, 1e-9)).astype(np.float32)

    if g.quats is not None:
        quats = _host(g.quats)[alive]
        quats = quats / (np.linalg.norm(quats, axis=1, keepdims=True) + 1e-12)
    else:
        quats = np.zeros((n, 4), np.float32)
        quats[:, 0] = 1.0

    props = (["x", "y", "z"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    data = np.concatenate(
        [means, f_dc.astype(np.float32), f_rest.astype(np.float32),
         logit_op[:, None], log_scales, quats], axis=1).astype("<f4")

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {p}" for p in props]
    header += ["end_header"]
    with open(Path(path), "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def load_gaussians_ply(path: Union[str, Path],
                       device: Device = "cuda") -> Gaussians:
    """Load a 3DGS-style PLY (binary little-endian, float32 properties)
    into activated Gaussians on `device`."""
    raw = Path(path).read_bytes()
    end = raw.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a PLY file (no end_header)")
    header = raw[:end].decode("ascii", errors="replace").splitlines()
    body = raw[end + len(b"end_header\n"):]

    n = None
    props = []
    fmt = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property" and n is not None:
            if parts[1] != "float":
                raise ValueError(f"unsupported property type {parts[1]}")
            props.append(parts[2])
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    if n is None:
        raise ValueError("no vertex element")

    arr = np.frombuffer(body, dtype="<f4", count=n * len(props)).reshape(
        n, len(props))
    col = {p: i for i, p in enumerate(props)}

    def get(names):
        return arr[:, [col[x] for x in names]]

    means = get(["x", "y", "z"])
    dc_rgb = get([f"f_dc_{i}" for i in range(3)]) * SH_C0 + 0.5
    scales = np.exp(get([f"scale_{i}" for i in range(3)]))
    opac = 1.0 / (1.0 + np.exp(-arr[:, col["opacity"]]))
    quats = get([f"rot_{i}" for i in range(4)]) if "rot_0" in col else None

    sh = None
    rest_names = [p for p in props if p.startswith("f_rest_")]
    if rest_names:
        n_rest = len(rest_names)
        rest = get(sorted(rest_names, key=lambda s: int(s.split("_")[-1])))
        if n_rest >= 24 and np.abs(rest[:, 9:]).max() > 0:
            # Degree 2/3: the native 3DGS basis (ops/sh.py evaluates it
            # directly); f_dc is the raw degree-0 coefficient.
            k_rest = 15 if n_rest >= 45 else 8
            r = rest[:, : 3 * k_rest].reshape(n, 3, k_rest).transpose(0, 2, 1)
            f_dc = get([f"f_dc_{i}" for i in range(3)])
            sh = np.concatenate([f_dc[:, None, :], r], axis=1
                                ).astype(np.float32)
        elif n_rest >= 9 and np.abs(rest[:, :9]).max() > 0:
            # Degree 1: invert into the reference-linear convention.
            r9 = rest[:, :9].reshape(n, 3, 3).transpose(0, 2, 1)  # (N,3coef,3ch)
            c1y = -r9[:, 0, :] * SH_C1
            c1z = r9[:, 1, :] * SH_C1
            c1x = -r9[:, 2, :] * SH_C1
            sh = np.stack([dc_rgb, c1x, c1y, c1z], axis=1).astype(np.float32)

    if sh is not None:
        return make_gaussians(means, scales, opac, sh=sh, quats=quats,
                              device=device)
    return make_gaussians(means, scales, opac,
                          colors=np.clip(dc_rgb, 0.0, 1.0), quats=quats,
                          device=device)
