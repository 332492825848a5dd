"""Plain PyTorch reference of depth-sorted Gaussian splatting, as the
configurations state it. It imports nothing of the program under test.

Per gaussian (3D Gaussian Splatting, Kerbl et al. 2023, and this repo's
pixel mapping):
  p_cam = view [mean, 1], p_clip = proj p_cam, ndc = p_clip.xyz / w
  px = (ndc_x / 2 + 1/2)(W - 1), py = (1/2 - ndc_y / 2)(H - 1)
  visible where -1 <= ndc_z <= 1 and w != 0; z_abs = max(|p_cam_z|, 1e-6)
  footprint "ewa": Sigma2 = J V R diag(s^2) R^T V^T J^T + 0.3 I, conic =
    Sigma2^-1, culling sigmas sqrt(max(diag Sigma2, 0.09));
  footprint "axis": sigma = max(|s| W |P00| / (2 z_abs), 1) (H, P11 in y),
    conic diag(1 / sigma^2)
  colour, clamped to [0, 1], by the configuration's `sh_basis`:
    "3dgs": real SH of degree 2 or 3 (9 or 16 rows), 0.5 + sum c_lm
      Y_lm(normalize(mean - eye));
    "linear": degree 1 (4 rows), as Kirkice/3DGaussian's renderer:
      c_0 + c_1 d_x + c_2 d_y + c_3 d_z, d = normalize(eye - mean)
Binning, per 16 x 128 pixel tile: a gaussian covers the tiles of the box
  |dx| <= r sigma_x + 1, |dy| <= r sigma_y + 1 with r = sqrt(2 ln(op /
  1e-5)), cut to at most k tiles around its own tile; each tile keeps its
  `cap` nearest gaussians (camera z descending, ties by index). The knobs
  k, cap and the exit threshold are stated once, in sorted_knobs below.
Compositing, per pixel over its tile's list, near first:
  a = op exp(-(a dx^2 + 2 b dx dy + c dy^2) / 2), 0 below 1e-5, at most
  0.9999; colour += T a rgb, T *= 1 - a; alpha = 1 - T; image =
  clip(colour + (1 - alpha) bg, 0, 1). Pixel centres at +0.5.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

TH, TW = 16, 128
TPS = TH * TW
ALPHA_CUT = 1e-5
ALPHA_MAX = 0.9999
EXP_FLOOR = -30.0   # exp(-30) < 1e-13: every alpha it touches is under the cut
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def perspective(fovy_deg: float, aspect: float, znear: float, zfar: float,
                device) -> torch.Tensor:
    """OpenGL perspective, row-major, m[3, 2] = -1."""
    f = 1.0 / math.tan(math.radians(fovy_deg) * 0.5)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = (2.0 * zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    return m.to(device)


def look_at(eye: torch.Tensor, device) -> torch.Tensor:
    """Right-handed view matrix looking at the origin, y up: rows [s; u;
    -f] times the translation by -eye."""
    eye = eye.to(device=device, dtype=torch.float32)
    up = torch.tensor([0.0, 1.0, 0.0], device=device)
    f = -eye
    f = f / (torch.linalg.norm(f) + 1e-8)
    u = up / (torch.linalg.norm(up) + 1e-8)
    s = torch.linalg.cross(f, u)
    s = s / (torch.linalg.norm(s) + 1e-8)
    u2 = torch.linalg.cross(s, f)
    rot = torch.eye(4, device=device)
    rot[0, :3], rot[1, :3], rot[2, :3] = s, u2, -f
    trans = torch.eye(4, device=device)
    trans[:3, 3] = -eye
    return rot @ trans


def orbit_eye(yaw, pitch, radius) -> torch.Tensor:
    """The viewer's orbit: eye = r (cos p sin y, sin p, cos p cos y), each
    term in f32."""
    y, p, r = (torch.tensor(float(v), dtype=torch.float32)
               for v in (yaw, pitch, radius))
    return torch.stack([r * torch.cos(p) * torch.sin(y), r * torch.sin(p),
                        r * torch.cos(p) * torch.cos(y)])


def quat_rot(q: torch.Tensor) -> torch.Tensor:
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def sh3_colour(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """0.5 + sum_lm sh[:, lm] Y_lm(dirs) for sh (N, 9 or 16, 3)."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    xx, yy, zz = x * x, y * y, z * z
    basis = [SH_C0 + 0 * x, -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * x * y, SH_C2[1] * y * z,
             SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
             SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
             SH_C3[2] * y * (4 * zz - xx - yy),
             SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
             SH_C3[6] * x * (xx - 3 * yy)]
    out = 0.5 + basis[0] * sh[:, 0]
    for k in range(1, sh.shape[1]):
        out = out + basis[k] * sh[:, k]
    return out


def colour(sh: torch.Tensor, means: torch.Tensor, eye: torch.Tensor,
           basis: str) -> torch.Tensor:
    """Unclamped colour (N, 3) of coefficients sh (N, rows, 3) seen from
    eye, in the configuration's SH basis."""
    if basis == "3dgs" and sh.shape[1] in (9, 16):
        d = means - eye[None, :]
        return sh3_colour(sh, d / (torch.linalg.norm(d, dim=1, keepdim=True)
                                   + 1e-8))
    if basis == "linear" and sh.shape[1] == 4:
        d = eye[None, :] - means
        d = d / (torch.linalg.norm(d, dim=1, keepdim=True) + 1e-8)
        return (sh[:, 0] + sh[:, 1] * d[:, 0:1] + sh[:, 2] * d[:, 1:2]
                + sh[:, 3] * d[:, 2:3])
    raise ValueError(f"the reference has no SH basis {basis!r} with "
                     f"{sh.shape[1]} rows")


def screen_stage(g: Dict[str, torch.Tensor], view: torch.Tensor,
                 proj: torch.Tensor, width: int, height: int,
                 cfg: dict) -> Dict[str, torch.Tensor]:
    """Per-gaussian screen quantities of activated gaussians g (means,
    scales, opacities, sh, and quats for the EWA footprint) for one camera,
    under configuration cfg's `footprint` and `sh_basis`: px, py, conic a,
    b, c, op (0 where invisible), rgb (N, 3), z_abs, and the
    undifferentiated sx, sy (culling sigmas) and zc (camera z, the depth
    key)."""
    footprint = cfg["footprint"]
    if footprint not in ("ewa", "axis"):
        raise ValueError(f"the reference has no footprint {footprint!r}")
    means, scales = g["means"], g["scales"]
    n = means.shape[0]
    p_cam = torch.cat([means, torch.ones((n, 1), device=means.device)],
                      1) @ view.T
    p_clip = p_cam @ proj.T
    w = p_clip[:, 3:4]
    ndc = p_clip[:, :3] / torch.where(w.abs() < 1e-8, torch.ones_like(w), w)
    px = (ndc[:, 0] * 0.5 + 0.5) * (width - 1)
    py = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * (height - 1)
    visible = ((ndc[:, 2] >= -1.0) & (ndc[:, 2] <= 1.0) & (w[:, 0] != 0.0))
    z_abs = torch.clamp(p_cam[:, 2].abs(), min=1e-6)

    if footprint == "ewa":
        rot = quat_rot(g["quats"])
        sig3 = (rot * (scales * scales)[:, None, :]) @ rot.transpose(1, 2)
        vr = view[:3, :3]
        t = means @ vr.T + view[:3, 3]
        tx, ty, tz = t.unbind(-1)
        tz = torch.where(tz.abs() < 1e-6,
                         torch.sign(tz) * 1e-6 + (tz == 0).float() * 1e-6, tz)
        fx = proj[0, 0].abs() * 0.5 * (width - 1)
        fy = proj[1, 1].abs() * 0.5 * (height - 1)
        inv = 1.0 / (-tz)
        zero = torch.zeros_like(tx)
        jac = torch.stack([torch.stack([fx * inv, zero, fx * tx * inv * inv], -1),
                           torch.stack([zero, -fy * inv, -fy * ty * inv * inv], -1)],
                          -2)                                     # (N, 2, 3)
        m = jac @ (vr @ sig3 @ vr.T) @ jac.transpose(1, 2)        # (N, 2, 2)
        m00 = torch.clamp(m[:, 0, 0] + 0.3, 1e-8, 1e10)
        m11 = torch.clamp(m[:, 1, 1] + 0.3, 1e-8, 1e10)
        bound = 0.999 * torch.sqrt(m00 * m11)
        m01 = torch.clamp(m[:, 0, 1], -bound, bound)
        det = torch.clamp(m00 * m11 - m01 * m01, min=1e-12)
        ca, cb, cc = m11 / det, -m01 / det, m00 / det
        sx = torch.sqrt(torch.clamp(m00, min=0.09))
        sy = torch.sqrt(torch.clamp(m11, min=0.09))
    else:
        sx = torch.clamp(scales[:, 0].abs() * 0.5 * width * proj[0, 0].abs()
                         / z_abs, min=1.0)
        sy = torch.clamp(scales[:, 1].abs() * 0.5 * height * proj[1, 1].abs()
                         / z_abs, min=1.0)
        ca, cb, cc = 1.0 / (sx * sx), torch.zeros_like(sx), 1.0 / (sy * sy)

    rot_v, t_v = view[:3, :3], view[:3, 3]
    eye = -(rot_v.T @ t_v)
    rgb = torch.clamp(colour(g["sh"], means, eye, cfg["sh_basis"]), 0.0, 1.0)
    op = torch.clamp(g["opacities"], min=0.0) * visible.float()
    zc = means @ view[2, :3] + view[2, 3]
    return {"px": px, "py": py, "a": ca, "b": cb, "c": cc, "op": op,
            "rgb": rgb, "z_abs": z_abs, "sx": sx.detach(), "sy": sy.detach(),
            "zc": zc.detach()}


def tiles_of(width: int, height: int) -> Tuple[int, int]:
    return -(-width // TW), -(-height // TH)


def tile_rects(st, width: int, height: int, k: int):
    """(x0, y0, kx, ky) int64 of each gaussian's k-budgeted tile box, ky 0
    where it covers none."""
    tx_n, ty_n = tiles_of(width, height)
    op = st["op"].detach()
    px, py = st["px"].detach(), st["py"].detach()
    r = torch.sqrt(2.0 * torch.log(torch.clamp(op, min=ALPHA_CUT) / ALPHA_CUT))
    rx, ry = r * st["sx"] + 1.0, r * st["sy"] + 1.0
    gone = ((op <= ALPHA_CUT) | (px + rx < 0) | (px - rx >= width)
            | (py + ry < 0) | (py - ry >= height))

    def tile(v, size, count):
        return torch.clamp(torch.floor(v / size), 0, count - 1).long()

    x0, x1 = tile(px - rx, TW, tx_n), tile(px + rx, TW, tx_n)
    y0, y1 = tile(py - ry, TH, ty_n), tile(py + ry, TH, ty_n)
    kx = torch.clamp(x1 - x0 + 1, max=k)
    ky = torch.minimum(y1 - y0 + 1, torch.clamp(k // kx, min=1))
    # A box over the budget is re-centred on the gaussian's own tile.
    x0 = torch.minimum(torch.maximum(tile(px, TW, tx_n) - (kx - 1) // 2, x0),
                       x1 - kx + 1)
    y0 = torch.minimum(torch.maximum(tile(py, TH, ty_n) - (ky - 1) // 2, y0),
                       y1 - ky + 1)
    ky = torch.where(gone, 0, ky)
    return x0, y0, kx, ky


def full_box_tiles(st, width: int, height: int) -> torch.Tensor:
    """Tiles of each gaussian's uncut box (0 where it covers none)."""
    x0, y0, kx, ky = tile_rects(st, width, height, 1 << 30)
    return kx * ky


def most_pair_k(n: int) -> int:
    """The largest tile budget a gaussian gets at n gaussians:
    min(64, max(8, 12e6 // n)), the exact default."""
    return min(64, max(8, 12_000_000 // max(n, 1)))


def pair_budget(boxes_max: int, n: int) -> int:
    """The training tile budget: the largest box over the training
    cameras at the initial parameters, rounded up to a power of two,
    within [8, most_pair_k(n)]."""
    k = 1 << max(0, (int(boxes_max) - 1).bit_length())
    return int(min(max(8, k), most_pair_k(n)))


# The sorted route's forward-quality knobs. Exact: a tile list of
# min(n rounded up to 512, 2048) gaussians and an exit threshold of 1e-6;
# the tile budget is pair_budget's for training, most_pair_k(n) for a
# served frame. The viewer's "interactive" preset states a budget of 8,
# an exit at 1e-3 and lists of 1024; "quality" is exact. The viewer draws
# over VIEWER_BACKGROUND.
EXACT_EXIT_T = 1e-6
VIEWER_BACKGROUND = (0.02, 0.02, 0.02)
PRESETS = {"quality": {}, "interactive": {"k": 8, "exit_t": 1e-3,
                                          "cap": 1024}}


def tile_capacity(n: int) -> int:
    return min(-(-n // 512) * 512, 2048)


def sorted_knobs(n: int, preset: str = "quality") -> Tuple[int, int, float]:
    """(tile budget k, tile capacity, exit threshold) of a served frame of
    n gaussians under the viewer's preset; training takes the capacity and
    threshold, with its own budget (pair_budget)."""
    knobs = {"k": most_pair_k(n), "cap": tile_capacity(n),
             "exit_t": EXACT_EXIT_T, **PRESETS[preset]}
    return knobs["k"], knobs["cap"], knobs["exit_t"]


def tile_lists(st, width: int, height: int, k: int, cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slots (n_tiles, cap) int64 gaussian ids nearest first, n where
    empty; counts (n_tiles,)) of one camera."""
    n = st["px"].shape[0]
    dev = st["px"].device
    tx_n, ty_n = tiles_of(width, height)
    n_tiles = tx_n * ty_n
    order = torch.sort(-st["zc"], stable=True).indices        # near first
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    x0, y0, kx, ky = tile_rects(st, width, height, k)
    j = torch.arange(k, device=dev)[None, :]
    used = j < (kx * ky)[:, None]
    tile = (y0[:, None] + j // kx[:, None]) * tx_n + x0[:, None] + j % kx[:, None]
    key = (tile * n + rank[:, None])[used]
    key = torch.sort(key).values
    t_of = key // n
    counts = torch.bincount(t_of, minlength=n_tiles)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(key.shape[0], device=dev) - start[t_of]
    keep = pos < cap
    slots = torch.full((n_tiles, cap), n, dtype=torch.long, device=dev)
    slots[t_of[keep], pos[keep]] = order[key[keep] % n]
    return slots, torch.clamp(counts, max=cap)


def rows_table(st) -> torch.Tensor:
    """(n + 1, 10) rows [px, py, a, b, c, op, r, g, b, z_abs]; row n is an
    empty slot (op 0)."""
    rows = torch.cat([torch.stack([st["px"], st["py"], st["a"], st["b"],
                                   st["c"], st["op"]], 1), st["rgb"],
                      st["z_abs"][:, None]], 1)
    empty = torch.zeros((1, 10), device=rows.device)
    empty[0, 2] = empty[0, 4] = 1.0
    return torch.cat([rows, empty], 0)


def composite_tiles(rows: torch.Tensor, slots: torch.Tensor,
                    tile_ids: torch.Tensor, tiles_x: int, used: int,
                    width: int, height: int, chunk: int = 256,
                    exit_t: float = 0.0):
    """Front-to-back compositing of tiles `tile_ids` over their first
    `used` slots -> (out (T, 5, TPS) rows [r, g, b, alpha, z_sum], pairs
    (T,) the live pairs (a >= 1e-5) of pixels inside the width x height
    frame met while the pixel's transmittance before them is above
    exit_t). Differentiable in rows. With exit_t > 0
    it stops once every pixel's transmittance is at most exit_t, which
    leaves each pixel within exit_t of the whole list's result."""
    dev = rows.device
    n_t = tile_ids.shape[0]
    pix = torch.arange(TPS, device=dev)
    gx = ((tile_ids % tiles_x)[:, None] * TW + pix % TW).float() + 0.5
    gy = ((tile_ids // tiles_x)[:, None] * TH + pix // TW).float() + 0.5
    inside = ((gx < width) & (gy < height))[:, None, :]
    trans = torch.ones((n_t, TPS), device=dev)
    acc = torch.zeros((n_t, 4, TPS), device=dev)
    pairs = torch.zeros((n_t,), dtype=torch.long, device=dev)
    for c0 in range(0, used, chunk):
        if exit_t > 0 and float(trans.detach().max()) <= exit_t:
            break
        idx = slots[:, c0:c0 + chunk]
        r = torch.index_select(rows, 0, idx.reshape(-1)).reshape(
            *idx.shape, rows.shape[1])                       # (T, C, 10)
        dx = gx[:, None, :] - r[..., 0:1]
        dy = gy[:, None, :] - r[..., 1:2]
        e = -0.5 * (r[..., 2:3] * dx * dx + 2.0 * r[..., 3:4] * dx * dy
                    + r[..., 4:5] * dy * dy)
        a_raw = r[..., 5:6] * torch.exp(torch.clamp(e, min=EXP_FLOOR))
        live = a_raw >= ALPHA_CUT
        a = torch.where(live, torch.clamp(a_raw, max=ALPHA_MAX),
                        torch.zeros_like(a_raw))
        keep = torch.cumprod(1.0 - a, dim=1)
        before = trans[:, None, :] * torch.cat(
            [torch.ones_like(keep[:, :1]), keep[:, :-1]], 1)
        w = before * a                                       # (T, C, TPS)
        feats = torch.cat([r[..., 6:9], r[..., 9:10]], -1)   # (T, C, 4)
        acc = acc + torch.einsum("tcf,tcp->tfp", feats, w)
        pairs += (live & inside & (before.detach() > exit_t)).sum(dim=(1, 2))
        trans = before[:, -1] * (1.0 - a[:, -1])
    out = torch.cat([acc[:, :3], (1.0 - trans)[:, None], acc[:, 3:4]], 1)
    return out, pairs


def frame_from_tiles(out: torch.Tensor, tiles_x: int, tiles_y: int,
                     width: int, height: int) -> torch.Tensor:
    """(n_tiles, F, TPS) -> (H, W, F)."""
    f = out.shape[1]
    full = out.reshape(tiles_y, tiles_x, f, TH, TW).permute(0, 3, 1, 4, 2)
    return full.reshape(tiles_y * TH, tiles_x * TW, f)[:height, :width]


def composite_frame(rows: torch.Tensor, slots: torch.Tensor,
                    counts: torch.Tensor, width: int, height: int,
                    exit_t: float = 0.0, batch: int = 32):
    """The whole frame without gradient -> ((H, W, 5) [r, g, b, alpha,
    z_sum], live pairs met above exit_t)."""
    tx_n, ty_n = tiles_of(width, height)
    outs, total = [], 0
    with torch.no_grad():
        for t0 in range(0, tx_n * ty_n, batch):
            ids = torch.arange(t0, min(t0 + batch, tx_n * ty_n),
                               device=rows.device)
            used = int(counts[ids].max())
            o, p = composite_tiles(rows, slots[ids], ids, tx_n, used,
                                   width, height, exit_t=exit_t)
            outs.append(o)
            total += int(p.sum())
    return frame_from_tiles(torch.cat(outs), tx_n, ty_n, width, height), total


def resolve(acc: torch.Tensor, background) -> torch.Tensor:
    """(H, W, 5) composite -> image clip(rgb + (1 - alpha) bg, 0, 1)."""
    bg = torch.as_tensor(background, dtype=torch.float32, device=acc.device)
    return torch.clamp(acc[..., :3] + (1.0 - acc[..., 3:4]) * bg, 0.0, 1.0)


def to_u8(image: torch.Tensor) -> torch.Tensor:
    """The served quantisation: trunc(clip(x, 0, 1) * 255)."""
    return (torch.clamp(image, 0.0, 1.0) * 255.0).to(torch.uint8)
