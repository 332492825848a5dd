// The per-gaussian stage, forward and backward: projection, validity,
// z_abs, the footprint (the reference's axis sigmas, or the full EWA
// conic), the colour (RGB, the reference's linear SH1, or 3DGS SH2/SH3)
// clamped to [0, 1], and the effective opacity of every gaussian for one
// camera.
//
// It replaces no Pallas kernel: XLA fused the JAX package's stage
// (tpu_gaussians/ops/common.py:prepare_splats) into a few fusions of its
// own. In PyTorch the same stage was some 300 elementwise operations, three
// small einsums and four stacks a view forward, and about twice as many
// autograd nodes backward, each a launch the host dispatches; this file
// does each way in one launch. kernels/stage.py holds its plain twins
// (stage_fwd_plain, stage_bwd_plain), whose formulas these follow one for
// one.
//
// Forward, per gaussian i (view V, proj P, frame W x H):
//   p_cam = V [m, 1]; p_clip = P p_cam; w_safe = |w| < 1e-8 ? 1 : w
//   px = (ndc_x/2 + 1/2)(W - 1); py = (1 - (ndc_y/2 + 1/2))(H - 1)
//   valid = -1 <= ndc_z <= 1 and w != 0; z_abs = max(|p_cam_z|, 1e-6)
//   axis: sigma = max(|s| W|P00|/2 / z_abs, 1) (y with H, P11),
//         conic (1/sx^2, 0, 1/sy^2)
//   ewa:  R(q / (|q| + 1e-12)), Sigma3 = R diag(s^2) R^T, the Jacobian J of
//         the pixel mapping at t = V[:3] [m, 1] (|t_z| < 1e-6 replaced by
//         +-1e-6), M = J V Sigma3 V^T J^T + 0.3 I, clamps m00, m11 to [1e-8,
//         1e10] and m01 to +-0.999 sqrt(m00 m11), det = max(m00 m11 - m01^2,
//         1e-12), conic (m11, -m01, m00) / det, sigma = sqrt(max(m, 0.09))
//   colour: clamp(c, 0, 1); op_eff = max(op, 0) valid alive
// and writes rows (8, N) = [px, py, a, b, c, sigma_x, sigma_y, op_eff] and
// feats (N, 5) = [r, g, b, 1, z_abs].
//
// Backward: the forward recomputed in registers from the inputs (nothing
// is saved between the two), then the chain rule by hand with torch's
// conventions, so that the result is autograd's: clamp passes the
// gradient where min <= x <= max; a clamp whose bounds are tensors (m01's)
// sends it into the bound it is clamped to; abs passes sign(x), 0 at 0;
// where() picks a branch; the replaced t_z and w are constants. A null
// cotangent reads as zero; a null gradient output is not asked for.
//
// Bound: bytes. A gaussian reads its row (9-59 floats) and writes 13
// forward; backward it reads the row and 13 cotangents and writes the row's
// gradients. The arithmetic is a few hundred flops a gaussian forward (EWA
// SH3), about three times that backward, under 20% of the f32 rate at the
// memory's rate. So the design is one thread a gaussian with every
// intermediate in registers, and the camera loaded once a block into shared
// memory, read as a broadcast. Rows of 12 or 16 bytes (means, scales,
// quats) go by scalar loads and stores: a warp's 32 rows are contiguous, so
// they fill whole sectors through L1. The backward's SH rows (up to 192
// bytes) go through shared memory both ways (stage_bwd_kernel): there a
// thread's own row made each of its 48 stores touch 32 sectors, and 100k
// EWA SH3 took 0.107 ms on an H100 80GB HBM3 against 0.032 staged (the
// forward's loads of the same rows hit L1 and stay direct). The footprint
// and the colour kind are template parameters: each instance carries only
// its own arithmetic and registers.
//
// f32 throughout, IEEE division and square root (no fast-math flags or
// approximate intrinsics). Build: nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -std=c++17 -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr float BLUR = 0.3f;
constexpr float MIN_SIGMA2 = 0.09f;   // min_sigma 0.3, squared
constexpr float SH_C0 = 0.28209479177387814f;
constexpr float SH_C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f,
                C2_2 = 0.31539156525252005f, C2_3 = -1.0925484305920792f,
                C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;

struct Inputs {
  const float* means;    // (N, 3)
  const float* scales;   // (N, 3)
  const float* quats;    // (N, 4) wxyz, or null: the identity
  const float* color;    // (N, 3) RGB or (N, K, 3) SH
  const float* opac;     // (N,)
  const float* alive;    // (N,), or null: all alive
  const float* view;     // (4, 4) row-major, on the device
  const float* proj;     // (4, 4)
};

// Cotangents of rows 0-7 and of feats, each with its strides (elements);
// a null pointer is a zero cotangent.
struct Cotangents {
  const float* row[8];
  int row_stride[8];
  const float* feats;
  int feats_stride0, feats_stride1;
};

struct Grads {          // null: not asked for
  float* means;
  float* scales;
  float* quats;
  float* color;
  float* opac;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;       // NaN stays NaN, as torch.clamp
}

__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float cot(const float* p, int stride, int i) {
  return p ? p[(long long)i * stride] : 0.f;
}

// The camera of the launch: a block's first 32 threads copy view and proj
// to shared memory, which every thread then reads as a broadcast.
__device__ __forceinline__ void load_camera(const Inputs& in, float* cam) {
  if (threadIdx.x < 16) cam[threadIdx.x] = in.view[threadIdx.x];
  else if (threadIdx.x < 32) cam[threadIdx.x] = in.proj[threadIdx.x - 16];
  __syncthreads();
}

// Everything the forward computes that the backward needs again.
struct Fwd {
  float m[3], s[3];
  float pc[4];                 // camera space (t = pc[0..2])
  float w, ws;                 // clip w, and w_safe
  float ndc0, ndc1;
  float valid;
  float zraw, zabs;            // |p_cam_z| and its clamp
  float px, py, a, b, c, sx, sy;
  // axis
  float ux, uy;                // sigmas before their floor
  // ewa
  float q[4], qnorm, qden, qn[4];
  float R[3][3], s2[3];
  float tz;                    // t_z after the 1e-6 guard
  float inv;                   // 1 / (-tz)
  float fxe, fye, j00, j02, j11, j12;
  float C00, C01, C02, C11, C12, C22;   // V Sigma3 V^T (symmetric)
  float m00, m01, m11;         // before the clamps
  float m00c, m11c, m01c, bnd, D, det;
  // colour
  float dir[3], dvec[3], dnorm, dden;   // unit direction and its parts
  float col[3];                // before the clamp
};

// Floats of a gaussian's colour row: RGB, or SHK rows of 3.
template <int SHK>
__host__ __device__ constexpr int color_row() { return SHK ? SHK * 3 : 3; }

template <bool EWA, int SHK>
__device__ __forceinline__ void forward(const Inputs& in, const float* V,
                                        const float* P, int i, int width,
                                        int height, const float* col,
                                        Fwd& f) {
  for (int k = 0; k < 3; ++k) {
    f.m[k] = in.means[3 * i + k];
    f.s[k] = in.scales[3 * i + k];
  }
  for (int r = 0; r < 4; ++r)
    f.pc[r] = V[4 * r] * f.m[0] + V[4 * r + 1] * f.m[1] +
              V[4 * r + 2] * f.m[2] + V[4 * r + 3];
  float cl[4];
  for (int r = 0; r < 4; ++r)
    cl[r] = P[4 * r] * f.pc[0] + P[4 * r + 1] * f.pc[1] +
            P[4 * r + 2] * f.pc[2] + P[4 * r + 3] * f.pc[3];
  f.w = cl[3];
  f.ws = fabsf(f.w) < 1e-8f ? 1.f : f.w;
  f.ndc0 = cl[0] / f.ws;
  f.ndc1 = cl[1] / f.ws;
  const float ndc2 = cl[2] / f.ws;
  f.px = (f.ndc0 * 0.5f + 0.5f) * (float)(width - 1);
  f.py = (1.f - (f.ndc1 * 0.5f + 0.5f)) * (float)(height - 1);
  f.valid = (ndc2 >= -1.f && ndc2 <= 1.f && f.w != 0.f) ? 1.f : 0.f;
  f.zraw = fabsf(f.pc[2]);
  f.zabs = clamp_min(f.zraw, 1e-6f);

  if (!EWA) {
    f.ux = fabsf(f.s[0]) * 0.5f * (float)width * fabsf(P[0]) / f.zabs;
    f.uy = fabsf(f.s[1]) * 0.5f * (float)height * fabsf(P[5]) / f.zabs;
    f.sx = clamp_min(f.ux, 1.f);
    f.sy = clamp_min(f.uy, 1.f);
    f.a = 1.f / (f.sx * f.sx);
    f.b = 0.f;
    f.c = 1.f / (f.sy * f.sy);
  } else {
    if (in.quats) {
      for (int k = 0; k < 4; ++k) f.q[k] = in.quats[4 * i + k];
    } else {
      f.q[0] = 1.f;
      f.q[1] = f.q[2] = f.q[3] = 0.f;
    }
    f.qnorm = sqrtf(f.q[0] * f.q[0] + f.q[1] * f.q[1] + f.q[2] * f.q[2] +
                    f.q[3] * f.q[3]);
    f.qden = f.qnorm + 1e-12f;
    for (int k = 0; k < 4; ++k) f.qn[k] = f.q[k] / f.qden;
    const float w = f.qn[0], x = f.qn[1], y = f.qn[2], z = f.qn[3];
    f.R[0][0] = 1.f - 2.f * (y * y + z * z);
    f.R[0][1] = 2.f * (x * y - w * z);
    f.R[0][2] = 2.f * (x * z + w * y);
    f.R[1][0] = 2.f * (x * y + w * z);
    f.R[1][1] = 1.f - 2.f * (x * x + z * z);
    f.R[1][2] = 2.f * (y * z - w * x);
    f.R[2][0] = 2.f * (x * z - w * y);
    f.R[2][1] = 2.f * (y * z + w * x);
    f.R[2][2] = 1.f - 2.f * (x * x + y * y);
    for (int k = 0; k < 3; ++k) f.s2[k] = f.s[k] * f.s[k];
    // Sigma3 = R diag(s^2) R^T, upper triangle
    float S[3][3];
    for (int r = 0; r < 3; ++r)
      for (int k = r; k < 3; ++k) {
        S[r][k] = f.R[r][0] * f.s2[0] * f.R[k][0] +
                  f.R[r][1] * f.s2[1] * f.R[k][1] +
                  f.R[r][2] * f.s2[2] * f.R[k][2];
        S[k][r] = S[r][k];
      }
    // C = Vr Sigma3 Vr^T
    float T[3][3];
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k)
        T[r][k] = V[4 * r] * S[0][k] + V[4 * r + 1] * S[1][k] +
                  V[4 * r + 2] * S[2][k];
    float C[3][3];
    for (int r = 0; r < 3; ++r)
      for (int k = r; k < 3; ++k)
        C[r][k] = T[r][0] * V[4 * k] + T[r][1] * V[4 * k + 1] +
                  T[r][2] * V[4 * k + 2];
    f.C00 = C[0][0]; f.C01 = C[0][1]; f.C02 = C[0][2];
    f.C11 = C[1][1]; f.C12 = C[1][2]; f.C22 = C[2][2];

    const float tx = f.pc[0], ty = f.pc[1], tz = f.pc[2];
    f.tz = fabsf(tz) < 1e-6f ? (tz < 0.f ? -1e-6f : 1e-6f) : tz;
    f.fxe = fabsf(P[0]) * 0.5f * (float)(width - 1);
    f.fye = fabsf(P[5]) * 0.5f * (float)(height - 1);
    f.inv = 1.f / (-f.tz);
    f.j00 = f.fxe * f.inv;
    f.j02 = f.fxe * tx * f.inv * f.inv;
    f.j11 = -f.fye * f.inv;
    f.j12 = -f.fye * ty * f.inv * f.inv;

    f.m00 = f.j00 * f.j00 * f.C00 + 2.f * f.j00 * f.j02 * f.C02 +
            f.j02 * f.j02 * f.C22 + BLUR;
    f.m01 = f.j00 * f.j11 * f.C01 + f.j00 * f.j12 * f.C02 +
            f.j02 * f.j11 * f.C12 + f.j02 * f.j12 * f.C22;
    f.m11 = f.j11 * f.j11 * f.C11 + 2.f * f.j11 * f.j12 * f.C12 +
            f.j12 * f.j12 * f.C22 + BLUR;

    f.m00c = clamp2(f.m00, 1e-8f, 1e10f);
    f.m11c = clamp2(f.m11, 1e-8f, 1e10f);
    f.bnd = 0.999f * sqrtf(f.m00c * f.m11c);
    f.m01c = clamp2(f.m01, -f.bnd, f.bnd);
    f.D = f.m00c * f.m11c - f.m01c * f.m01c;
    f.det = clamp_min(f.D, 1e-12f);
    f.a = f.m11c / f.det;
    f.b = -f.m01c / f.det;
    f.c = f.m00c / f.det;
    f.sx = sqrtf(clamp_min(f.m00c, MIN_SIGMA2));
    f.sy = sqrtf(clamp_min(f.m11c, MIN_SIGMA2));
  }

  if (SHK == 0) {
    for (int k = 0; k < 3; ++k) f.col[k] = col[k];
  } else {
    // camera centre -R^T t of the view
    float cam[3];
    for (int k = 0; k < 3; ++k)
      cam[k] = -(V[k] * V[3] + V[4 + k] * V[7] + V[8 + k] * V[11]);
    for (int k = 0; k < 3; ++k)
      f.dvec[k] = SHK == 4 ? cam[k] - f.m[k] : f.m[k] - cam[k];
    f.dnorm = sqrtf(f.dvec[0] * f.dvec[0] + f.dvec[1] * f.dvec[1] +
                    f.dvec[2] * f.dvec[2]);
    f.dden = f.dnorm + 1e-8f;
    for (int k = 0; k < 3; ++k) f.dir[k] = f.dvec[k] / f.dden;
    const float x = f.dir[0], y = f.dir[1], z = f.dir[2];
    if (SHK == 4) {
      for (int ch = 0; ch < 3; ++ch)
        f.col[ch] = col[ch] + col[3 + ch] * x + col[6 + ch] * y +
                    col[9 + ch] * z;
    } else {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      for (int ch = 0; ch < 3; ++ch) {
        const float* c = col + ch;
        float o = 0.5f + SH_C0 * c[0];
        o = o - SH_C1 * y * c[3] + SH_C1 * z * c[6] - SH_C1 * x * c[9];
        o = o + C2_0 * xy * c[12] + C2_1 * yz * c[15] +
            C2_2 * (2.f * zz - xx - yy) * c[18] + C2_3 * xz * c[21] +
            C2_4 * (xx - yy) * c[24];
        if (SHK == 16)
          o = o + C3_0 * y * (3.f * xx - yy) * c[27] +
              C3_1 * xy * z * c[30] +
              C3_2 * y * (4.f * zz - xx - yy) * c[33] +
              C3_3 * z * (2.f * zz - 3.f * xx - 3.f * yy) * c[36] +
              C3_4 * x * (4.f * zz - xx - yy) * c[39] +
              C3_5 * z * (xx - yy) * c[42] +
              C3_6 * x * (xx - 3.f * yy) * c[45];
        f.col[ch] = o;
      }
    }
  }
}

template <bool EWA, int SHK>
__global__ void __launch_bounds__(THREADS)
stage_fwd_kernel(Inputs in, float* rows, float* feats, int n, int width,
                 int height) {
  __shared__ float cam[32];
  load_camera(in, cam);
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  Fwd f;
  forward<EWA, SHK>(in, cam, cam + 16, i, width, height,
                    in.color + (long long)i * color_row<SHK>(), f);
  const float op = in.opac[i];
  const float alive = in.alive ? in.alive[i] : 1.f;
  const float out[8] = {f.px, f.py, f.a, f.b, f.c, f.sx, f.sy,
                        clamp_min(op, 0.f) * f.valid * alive};
  for (int r = 0; r < 8; ++r) rows[(long long)r * n + i] = out[r];
  float* fe = feats + 5LL * i;
  for (int k = 0; k < 3; ++k) fe[k] = clamp2(f.col[k], 0.f, 1.f);
  fe[3] = 1.f;
  fe[4] = f.zabs;
}

// Gaussian i's backward; col is its colour row, dcol where its gradient
// goes (null: not asked for), both in shared memory for SH.
template <bool EWA, int SHK>
__device__ __forceinline__ void backward(const Inputs& in,
                                         const Cotangents& g, const Grads& d,
                                         const float* V, const float* P,
                                         int i, int width, int height,
                                         const float* col, float* dcol) {
  Fwd f;
  forward<EWA, SHK>(in, V, P, i, width, height, col, f);

  const float g_px = cot(g.row[0], g.row_stride[0], i);
  const float g_py = cot(g.row[1], g.row_stride[1], i);
  const float g_a = cot(g.row[2], g.row_stride[2], i);
  const float g_b = cot(g.row[3], g.row_stride[3], i);
  const float g_c = cot(g.row[4], g.row_stride[4], i);
  const float g_sx = cot(g.row[5], g.row_stride[5], i);
  const float g_sy = cot(g.row[6], g.row_stride[6], i);
  const float g_op = cot(g.row[7], g.row_stride[7], i);
  float g_f[5];
  for (int k = 0; k < 5; ++k)
    g_f[k] = g.feats ? g.feats[(long long)i * g.feats_stride0 +
                               k * g.feats_stride1] : 0.f;

  // opacity: max(op, 0) * valid * alive
  if (d.opac) {
    const float op = in.opac[i];
    const float alive = in.alive ? in.alive[i] : 1.f;
    d.opac[i] = op >= 0.f ? g_op * alive * f.valid : 0.f;
  }

  float g_pc[4] = {0.f, 0.f, 0.f, 0.f};
  float g_zabs = g_f[4];
  float g_s[3] = {0.f, 0.f, 0.f};

  // px, py through ndc = clip / w_safe
  {
    const float g_ndc0 = g_px * (0.5f * (float)(width - 1));
    const float g_ndc1 = g_py * (-0.5f * (float)(height - 1));
    const float g_cl0 = g_ndc0 / f.ws;
    const float g_cl1 = g_ndc1 / f.ws;
    const float g_w = fabsf(f.w) < 1e-8f
                          ? 0.f
                          : -(g_ndc0 * f.ndc0 + g_ndc1 * f.ndc1) / f.ws;
    for (int k = 0; k < 4; ++k)
      g_pc[k] = g_cl0 * P[k] + g_cl1 * P[4 + k] + g_w * P[12 + k];
  }

  if (!EWA) {
    // a = 1 / sx^2, sx = max(ux, 1), ux = |s0| W |P00| / 2 / z_abs
    const float g_sxt = g_sx - 2.f * g_a / (f.sx * f.sx * f.sx);
    const float g_syt = g_sy - 2.f * g_c / (f.sy * f.sy * f.sy);
    const float g_ux = f.ux >= 1.f ? g_sxt : 0.f;
    const float g_uy = f.uy >= 1.f ? g_syt : 0.f;
    g_s[0] = g_ux * sign_of(f.s[0]) * 0.5f * (float)width * fabsf(P[0]) /
             f.zabs;
    g_s[1] = g_uy * sign_of(f.s[1]) * 0.5f * (float)height * fabsf(P[5]) /
             f.zabs;
    g_zabs -= (g_ux * f.ux + g_uy * f.uy) / f.zabs;
  } else {
    // conic (m11, -m01, m00) / det and sigma = sqrt(max(m, 0.09))
    float g_m00c = g_c / f.det;
    float g_m11c = g_a / f.det;
    float g_m01c = -g_b / f.det;
    if (f.m00c >= MIN_SIGMA2) g_m00c += g_sx * 0.5f / f.sx;
    if (f.m11c >= MIN_SIGMA2) g_m11c += g_sy * 0.5f / f.sy;
    const float g_det = -(g_a * f.a + g_b * f.b + g_c * f.c) / f.det;
    const float g_D = f.D >= 1e-12f ? g_det : 0.f;
    g_m00c += g_D * f.m11c;
    g_m11c += g_D * f.m00c;
    g_m01c -= 2.f * g_D * f.m01c;
    // m01c = clamp(m01, -bnd, bnd), bnd = 0.999 sqrt(m00c m11c)
    const float lo = -f.bnd, hi = f.bnd;
    const float g_m01 = (f.m01 >= lo && f.m01 <= hi) ? g_m01c : 0.f;
    const float g_lo = (f.m01 < lo && lo < hi) ? g_m01c : 0.f;
    const float g_hi = (f.m01 > hi || hi < lo) ? g_m01c : 0.f;
    const float g_prod = (g_hi - g_lo) * 0.999f * 0.5f /
                         sqrtf(f.m00c * f.m11c);
    g_m00c += g_prod * f.m11c;
    g_m11c += g_prod * f.m00c;
    const float g00 = (f.m00 >= 1e-8f && f.m00 <= 1e10f) ? g_m00c : 0.f;
    const float g11 = (f.m11 >= 1e-8f && f.m11 <= 1e10f) ? g_m11c : 0.f;
    const float g01 = g_m01;

    // m = r^T C r' with r0 = (j00, 0, j02), r1 = (0, j11, j12)
    const float j00 = f.j00, j02 = f.j02, j11 = f.j11, j12 = f.j12;
    const float g_j00 = g00 * (2.f * j00 * f.C00 + 2.f * j02 * f.C02) +
                        g01 * (j11 * f.C01 + j12 * f.C02);
    const float g_j02 = g00 * (2.f * j00 * f.C02 + 2.f * j02 * f.C22) +
                        g01 * (j11 * f.C12 + j12 * f.C22);
    const float g_j11 = g11 * (2.f * j11 * f.C11 + 2.f * j12 * f.C12) +
                        g01 * (j00 * f.C01 + j02 * f.C12);
    const float g_j12 = g11 * (2.f * j11 * f.C12 + 2.f * j12 * f.C22) +
                        g01 * (j00 * f.C02 + j02 * f.C22);
    // the gradient of the symmetric C: g00 r0 r0^T + g11 r1 r1^T
    // + g01 (r0 r1^T + r1 r0^T) / 2
    const float r0[3] = {j00, 0.f, j02}, r1[3] = {0.f, j11, j12};
    float G[3][3];
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k)
        G[r][k] = g00 * r0[r] * r0[k] + g11 * r1[r] * r1[k] +
                  0.5f * g01 * (r0[r] * r1[k] + r1[r] * r0[k]);

    // the Jacobian's entries -> t
    const float tx = f.pc[0], ty = f.pc[1], inv = f.inv;
    const float g_inv = g_j00 * f.fxe + g_j02 * f.fxe * tx * 2.f * inv -
                        g_j11 * f.fye - g_j12 * f.fye * ty * 2.f * inv;
    g_pc[0] += g_j02 * f.fxe * inv * inv;
    g_pc[1] -= g_j12 * f.fye * inv * inv;
    if (!(fabsf(f.pc[2]) < 1e-6f)) g_pc[2] += g_inv * inv * inv;

    // Sigma3 = Vr^T G Vr
    float T[3][3], GS[3][3];
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k)
        T[r][k] = G[r][0] * V[k] + G[r][1] * V[4 + k] + G[r][2] * V[8 + k];
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k)
        GS[r][k] = V[r] * T[0][k] + V[4 + r] * T[1][k] + V[8 + r] * T[2][k];
    // Sigma3 = R diag(s^2) R^T: g_R = 2 GS R diag(s^2),
    // g_s2[b] = (R^T GS R)[b][b]
    float gR[3][3];
    for (int r = 0; r < 3; ++r)
      for (int b = 0; b < 3; ++b)
        gR[r][b] = 2.f * f.s2[b] * (GS[r][0] * f.R[0][b] +
                                    GS[r][1] * f.R[1][b] +
                                    GS[r][2] * f.R[2][b]);
    for (int b = 0; b < 3; ++b) {
      float acc = 0.f;
      for (int r = 0; r < 3; ++r)
        acc += f.R[r][b] * (GS[r][0] * f.R[0][b] + GS[r][1] * f.R[1][b] +
                            GS[r][2] * f.R[2][b]);
      g_s[b] = 2.f * f.s[b] * acc;
    }
    if (d.quats) {
      const float w = f.qn[0], x = f.qn[1], y = f.qn[2], z = f.qn[3];
      float gq[4];
      gq[0] = 2.f * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] -
                     x * gR[1][2] - y * gR[2][0] + x * gR[2][1]);
      gq[1] = 2.f * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] -
                     2.f * x * gR[1][1] - w * gR[1][2] + z * gR[2][0] +
                     w * gR[2][1] - 2.f * x * gR[2][2]);
      gq[2] = 2.f * (-2.f * y * gR[0][0] + x * gR[0][1] + w * gR[0][2] +
                     x * gR[1][0] + z * gR[1][2] - w * gR[2][0] +
                     z * gR[2][1] - 2.f * y * gR[2][2]);
      gq[3] = 2.f * (-2.f * z * gR[0][0] - w * gR[0][1] + x * gR[0][2] +
                     w * gR[1][0] - 2.f * z * gR[1][1] + y * gR[1][2] +
                     x * gR[2][0] + y * gR[2][1]);
      // qn = q / (|q| + 1e-12)
      const float dot = gq[0] * f.q[0] + gq[1] * f.q[1] + gq[2] * f.q[2] +
                        gq[3] * f.q[3];
      const float k = f.qnorm > 0.f ? dot / (f.qden * f.qden * f.qnorm) : 0.f;
      for (int c = 0; c < 4; ++c)
        d.quats[4 * i + c] = gq[c] / f.qden - f.q[c] * k;
    }
  }

  // z_abs = max(|p_cam_z|, 1e-6)
  if (f.zraw >= 1e-6f) g_pc[2] += g_zabs * sign_of(f.pc[2]);

  // colour
  float g_col[3];
  for (int k = 0; k < 3; ++k)
    g_col[k] = (f.col[k] >= 0.f && f.col[k] <= 1.f) ? g_f[k] : 0.f;
  float g_m[3];
  for (int k = 0; k < 3; ++k)
    g_m[k] = g_pc[0] * V[k] + g_pc[1] * V[4 + k] + g_pc[2] * V[8 + k] +
             g_pc[3] * V[12 + k];
  if (SHK == 0) {
    if (dcol)
      for (int k = 0; k < 3; ++k) dcol[k] = g_col[k];
  } else {
    const float x = f.dir[0], y = f.dir[1], z = f.dir[2];
    float g_dir[3] = {0.f, 0.f, 0.f};
    // G_k = sum over channels of g_col * coefficient k
    auto Gk = [&](int k) {
      return g_col[0] * col[3 * k] + g_col[1] * col[3 * k + 1] +
             g_col[2] * col[3 * k + 2];
    };
    if (SHK == 4) {
      const float basis[4] = {1.f, x, y, z};
      g_dir[0] = Gk(1);
      g_dir[1] = Gk(2);
      g_dir[2] = Gk(3);
      if (dcol)     // after the last read of col, which it may overwrite
        for (int k = 0; k < 4; ++k)
          for (int ch = 0; ch < 3; ++ch) dcol[3 * k + ch] = g_col[ch] * basis[k];
    } else {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      float basis[16];
      basis[0] = SH_C0;
      basis[1] = -SH_C1 * y;
      basis[2] = SH_C1 * z;
      basis[3] = -SH_C1 * x;
      basis[4] = C2_0 * xy;
      basis[5] = C2_1 * yz;
      basis[6] = C2_2 * (2.f * zz - xx - yy);
      basis[7] = C2_3 * xz;
      basis[8] = C2_4 * (xx - yy);
      float G1 = Gk(1), G2 = Gk(2), G3 = Gk(3), G4 = Gk(4), G5 = Gk(5),
            G6 = Gk(6), G7 = Gk(7), G8 = Gk(8);
      g_dir[0] = -SH_C1 * G3 + C2_0 * y * G4 -
                 2.f * C2_2 * x * G6 + C2_3 * z * G7 +
                 2.f * C2_4 * x * G8;
      g_dir[1] = -SH_C1 * G1 + C2_0 * x * G4 + C2_1 * z * G5 -
                 2.f * C2_2 * y * G6 - 2.f * C2_4 * y * G8;
      g_dir[2] = SH_C1 * G2 + C2_1 * y * G5 + 4.f * C2_2 * z * G6 +
                 C2_3 * x * G7;
      if (SHK == 16) {
        basis[9] = C3_0 * y * (3.f * xx - yy);
        basis[10] = C3_1 * xy * z;
        basis[11] = C3_2 * y * (4.f * zz - xx - yy);
        basis[12] = C3_3 * z * (2.f * zz - 3.f * xx - 3.f * yy);
        basis[13] = C3_4 * x * (4.f * zz - xx - yy);
        basis[14] = C3_5 * z * (xx - yy);
        basis[15] = C3_6 * x * (xx - 3.f * yy);
        const float G9 = Gk(9), G10 = Gk(10), G11 = Gk(11), G12 = Gk(12),
                    G13 = Gk(13), G14 = Gk(14), G15 = Gk(15);
        g_dir[0] += C3_0 * 6.f * xy * G9 + C3_1 * yz * G10 -
                    C3_2 * 2.f * xy * G11 - C3_3 * 6.f * xz * G12 +
                    C3_4 * (4.f * zz - 3.f * xx - yy) * G13 +
                    C3_5 * 2.f * xz * G14 +
                    C3_6 * 3.f * (xx - yy) * G15;
        g_dir[1] += C3_0 * 3.f * (xx - yy) * G9 + C3_1 * xz * G10 +
                    C3_2 * (4.f * zz - xx - 3.f * yy) * G11 -
                    C3_3 * 6.f * yz * G12 - C3_4 * 2.f * xy * G13 -
                    C3_5 * 2.f * yz * G14 - C3_6 * 6.f * xy * G15;
        g_dir[2] += C3_1 * xy * G10 + C3_2 * 8.f * yz * G11 +
                    C3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * G12 +
                    C3_4 * 8.f * xz * G13 + C3_5 * (xx - yy) * G14;
      }
      if (dcol)
        for (int k = 0; k < SHK; ++k)
          for (int ch = 0; ch < 3; ++ch) dcol[3 * k + ch] = g_col[ch] * basis[k];
    }
    // dir = dvec / (|dvec| + 1e-8), dvec = +-(m - cam)
    const float dot = g_dir[0] * f.dvec[0] + g_dir[1] * f.dvec[1] +
                      g_dir[2] * f.dvec[2];
    const float k = f.dnorm > 0.f ? dot / (f.dden * f.dden * f.dnorm) : 0.f;
    const float sgn = SHK == 4 ? -1.f : 1.f;
    for (int c = 0; c < 3; ++c)
      g_m[c] += sgn * (g_dir[c] / f.dden - f.dvec[c] * k);
  }

  if (d.means)
    for (int k = 0; k < 3; ++k) d.means[3 * i + k] = g_m[k];
  if (d.scales)
    for (int k = 0; k < 3; ++k) d.scales[3 * i + k] = g_s[k];
}

// A block's SH rows go through shared memory both ways: read whole from
// device memory into rows of ROW + 1 floats (an odd pitch: a warp's rows
// fall in distinct banks), each thread's gradient written over its row,
// and the block's gradients written out whole. A thread's own row, read
// and written at a stride of ROW floats, would cost a warp 32 sectors an
// instruction, ROW instructions each way.
template <bool EWA, int SHK>
__global__ void __launch_bounds__(THREADS)
stage_bwd_kernel(Inputs in, Cotangents g, Grads d, int n, int width,
                 int height) {
  constexpr int ROW = color_row<SHK>();
  constexpr int PITCH = ROW + 1;
  __shared__ float cam[32];
  __shared__ float rows[SHK ? THREADS * PITCH : 1];
  const int g0 = blockIdx.x * THREADS;
  const int count = min(THREADS, n - g0);
  if (SHK) {
    const float* src = in.color + (long long)g0 * ROW;
    for (int k = threadIdx.x; k < count * ROW; k += THREADS)
      rows[(k / ROW) * PITCH + k % ROW] = src[k];
  }
  load_camera(in, cam);          // its barrier also covers the rows
  const int i = g0 + threadIdx.x;
  float* row = rows + threadIdx.x * PITCH;
  if (i < n) {
    if (SHK)
      backward<EWA, SHK>(in, g, d, cam, cam + 16, i, width, height, row,
                         d.color ? row : nullptr);
    else
      backward<EWA, SHK>(in, g, d, cam, cam + 16, i, width, height,
                         in.color + 3LL * i,
                         d.color ? d.color + 3LL * i : nullptr);
  }
  if (SHK && d.color) {
    __syncthreads();
    float* dst = d.color + (long long)g0 * ROW;
    for (int k = threadIdx.x; k < count * ROW; k += THREADS)
      dst[k] = rows[(k / ROW) * PITCH + k % ROW];
  }
}

template <bool EWA>
cudaError_t launch_fwd(const Inputs& in, float* rows, float* feats, int n,
                       int width, int height, int sh_k, cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  switch (sh_k) {
    case 0: stage_fwd_kernel<EWA, 0><<<blocks, THREADS, 0, stream>>>(
                in, rows, feats, n, width, height); break;
    case 4: stage_fwd_kernel<EWA, 4><<<blocks, THREADS, 0, stream>>>(
                in, rows, feats, n, width, height); break;
    case 9: stage_fwd_kernel<EWA, 9><<<blocks, THREADS, 0, stream>>>(
                in, rows, feats, n, width, height); break;
    case 16: stage_fwd_kernel<EWA, 16><<<blocks, THREADS, 0, stream>>>(
                in, rows, feats, n, width, height); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool EWA>
cudaError_t launch_bwd(const Inputs& in, const Cotangents& g, const Grads& d,
                       int n, int width, int height, int sh_k,
                       cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  switch (sh_k) {
    case 0: stage_bwd_kernel<EWA, 0><<<blocks, THREADS, 0, stream>>>(
                in, g, d, n, width, height); break;
    case 4: stage_bwd_kernel<EWA, 4><<<blocks, THREADS, 0, stream>>>(
                in, g, d, n, width, height); break;
    case 9: stage_bwd_kernel<EWA, 9><<<blocks, THREADS, 0, stream>>>(
                in, g, d, n, width, height); break;
    case 16: stage_bwd_kernel<EWA, 16><<<blocks, THREADS, 0, stream>>>(
                in, g, d, n, width, height); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t stage_fwd_launch(
    const float* means, const float* scales, const float* quats,
    const float* color, const float* opac, const float* alive,
    const float* view, const float* proj, float* rows, float* feats, int n,
    int width, int height, int ewa, int sh_k, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const Inputs in{means, scales, quats, color, opac, alive, view, proj};
  return ewa ? launch_fwd<true>(in, rows, feats, n, width, height, sh_k,
                                stream)
             : launch_fwd<false>(in, rows, feats, n, width, height, sh_k,
                                 stream);
}

extern "C" cudaError_t stage_bwd_launch(
    const float* means, const float* scales, const float* quats,
    const float* color, const float* opac, const float* alive,
    const float* view, const float* proj,
    const float* g_px, const float* g_py, const float* g_a, const float* g_b,
    const float* g_c, const float* g_sx, const float* g_sy,
    const float* g_op, const float* g_feats,
    float* d_means, float* d_scales, float* d_quats, float* d_color,
    float* d_opac, int n, int width, int height, int ewa, int sh_k,
    int s_px, int s_py, int s_a, int s_b, int s_c, int s_sx, int s_sy,
    int s_op, int s_feats0, int s_feats1, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const Inputs in{means, scales, quats, color, opac, alive, view, proj};
  const Cotangents g{{g_px, g_py, g_a, g_b, g_c, g_sx, g_sy, g_op},
                     {s_px, s_py, s_a, s_b, s_c, s_sx, s_sy, s_op},
                     g_feats, s_feats0, s_feats1};
  const Grads d{d_means, d_scales, d_quats, d_color, d_opac};
  return ewa ? launch_bwd<true>(in, g, d, n, width, height, sh_k, stream)
             : launch_bwd<false>(in, g, d, n, width, height, sh_k, stream);
}
