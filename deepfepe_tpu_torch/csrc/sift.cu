// SIFT detection and description on the card: S1, S2a and S2b, float32.
//
// No TPU kernel is replaced: the JAX package runs OpenCV's SIFT on the host
// (deepfepe_tpu/data/dump_kitti.py:37, cv2.SIFT_create(nfeatures,
// contrastThreshold=1e-5), in `sift_detect`). These kernels compute what
// OpenCV's features2d SIFT computes after its Gaussian pyramid, and
// frontend/sift.py holds their plain twins (extrema_plain,
// orientation_plain, descriptor_plain), operation for operation:
//   S1 sift_extrema_kernel     a thread a DoG pixel of layers 1-3 of every
//                              octave: the 26-neighbour test (>= / <=, any
//                              nonzero value), up to 5 Newton steps on the
//                              3x3x3 differences (Matx33f::solve's closed
//                              form), the contrast and edge tests; each
//                              survivor appended through an atomic counter;
//   S2a sift_orientation_kernel  a block a candidate: its gradient samples
//                              in chunks of 256, the 36-bin histogram summed
//                              by 36 owner threads in raster order (OpenCV's
//                              order), smoothed, and one keypoint a peak,
//                              written together in bin order;
//   S2b sift_descriptor_kernel a block a kept keypoint: its samples in
//                              chunks of 384, the (4 + 2)^2 (8 + 2) = 360
//                              bins summed by 360 owner threads in raster
//                              order, folded, clipped, normalised, x512.
// The pyramid comes packed (frontend/sift.py `Pyramid`): octave o's layers
// [L, rows, cols] at g_off[o] (Gaussian, 6 layers) and d_off[o] (DoG, 5).
//
// Rounding. The library is built without contraction (-fmad=false,
// utils/build.py), so every product and sum rounds on its own as in the
// torch twins; the fused multiply-adds OpenCV's SIMD code takes (fastAtan2's
// polynomial, the gradient magnitude, the descriptor norm's lanes) are
// explicit __fmaf_rn, which the twins emulate in float64. exp, cos, sin
// and 2^x are taken in double and rounded to float, as the twins take
// them. So each kernel agrees with its twin bit for bit but for the rare
// double rounding of a float64-emulated fma.
//
// What bounds them. S1 reads each tested DoG pixel and its 26 neighbours
// (L1/L2 hits; one pass over the DoG's 3 inner layers from device memory,
// ~22 MB for a 376x1240 frame: ~7 us at 3.35 TB/s) and does a few hundred
// operations on the few candidates; S2a and S2b read a window of the
// Gaussian layer a keypoint (a few thousand samples each) and are bound by
// the owner threads' serial scans, not by bytes or FP32 rate. A simple
// design first: no tiling of the DoG, no warp-level histogram.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int MAX_OCT = 16;
constexpr int N_LAYERS = 3;
constexpr int BORDER = 5;
constexpr int MAX_INTERP = 5;
constexpr int ORI_BINS = 36;
constexpr int DW = 4;                                // descriptor width
constexpr int DN = 8;                                // descriptor orientation bins
constexpr int HIST_LEN = (DW + 2) * (DW + 2) * (DN + 2);  // 360
constexpr int DESC_LEN = DW * DW * DN;               // 128
constexpr int ORI_THREADS = 256;
constexpr int DESC_THREADS = 384;                    // >= HIST_LEN owners

// The float32 constants of frontend/sift.py, bit for bit.
constexpr float SIGMA = 0x1.99999ap+0f;              // 1.6f
constexpr float CONTRAST = 0x1.4f8b58p-17f;          // 1e-5f
constexpr float EDGE = 10.0f;
constexpr float IMG_SCALE = 0x1.010102p-8f;          // 1.f / 255
constexpr float DERIV_SCALE = 0x1.010102p-9f;
constexpr float CROSS_SCALE = 0x1.010102p-10f;
constexpr float INT_MAX_3 = 0x1.555556p+29f;         // (float)(INT_MAX / 3)
constexpr float ATAN_P1 = 0x1.ca44dep+5f;
constexpr float ATAN_P3 = -0x1.2aaddcp+4f;
constexpr float ATAN_P5 = 0x1.1d3f7ep+3f;
constexpr float ATAN_P7 = -0x1.4515b2p+1f;
constexpr float ATAN_EPS = 0x1.0p-52f;               // (float)DBL_EPSILON
constexpr float DEG2RAD = 0x1.1df46ap-6f;            // (float)(CV_PI / 180)
constexpr float SQRT2 = 0x1.6a09e6p+0f;
constexpr float ORI_RADIUS = 4.5f;
constexpr float ORI_SIG = 1.5f;
constexpr float PEAK_RATIO = 0x1.99999ap-1f;         // 0.8f
constexpr float ORI_BIN_SCALE = 0x1.99999ap-4f;      // 36 / 360.f
constexpr float DESC_BIN_SCALE = 0x1.6c16c2p-6f;     // 8 / 360.f
constexpr float MAG_THR = 0x1.99999ap-3f;            // 0.2f

struct Pyr {
  int n;
  int rows[MAX_OCT], cols[MAX_OCT];
  long long g_off[MAX_OCT], d_off[MAX_OCT];
  long long t_start[MAX_OCT + 1];  // S1: the first thread of each octave
};

__device__ __forceinline__ float fast_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float c = fminf(ax, ay) / (fmaxf(ax, ay) + ATAN_EPS);
  const float cc = c * c;
  float a = __fmaf_rn(__fmaf_rn(__fmaf_rn(cc, ATAN_P7, ATAN_P5), cc, ATAN_P3), cc, ATAN_P1) * c;
  if (!(ax >= ay)) a = 90.f - a;
  if (x < 0) a = 180.f - a;
  if (y < 0) a = 360.f - a;
  return a;
}

__device__ __forceinline__ float magnitude(float x, float y) {
  return sqrtf(__fmaf_rn(x, x, y * y));
}

__device__ __forceinline__ float exp_f(float x) {
  return static_cast<float>(exp(static_cast<double>(x)));
}

// dD (x, y, s), the Hessian's entries (xx, yy, ss, xy, xs, ys) and the value
// at (l, r, c) of one octave's DoG.
struct Deriv {
  float v, dx, dy, ds, dxx, dyy, dss, dxy, dxs, dys;
};

__device__ Deriv derivatives(const float* D, int H, int W, int l, int r, int c) {
  const long long HW = static_cast<long long>(H) * W;
  auto at = [&](int dl, int dr, int dc) {
    return D[(l + dl) * HW + static_cast<long long>(r + dr) * W + (c + dc)];
  };
  Deriv d;
  d.v = at(0, 0, 0);
  d.dx = (at(0, 0, 1) - at(0, 0, -1)) * DERIV_SCALE;
  d.dy = (at(0, 1, 0) - at(0, -1, 0)) * DERIV_SCALE;
  d.ds = (at(1, 0, 0) - at(-1, 0, 0)) * DERIV_SCALE;
  const float v2 = d.v * 2.0f;
  d.dxx = ((at(0, 0, 1) + at(0, 0, -1)) - v2) * IMG_SCALE;
  d.dyy = ((at(0, 1, 0) + at(0, -1, 0)) - v2) * IMG_SCALE;
  d.dss = ((at(1, 0, 0) + at(-1, 0, 0)) - v2) * IMG_SCALE;
  d.dxy = (((at(0, 1, 1) - at(0, 1, -1)) - at(0, -1, 1)) + at(0, -1, -1)) * CROSS_SCALE;
  d.dxs = (((at(1, 0, 1) - at(1, 0, -1)) - at(-1, 0, 1)) + at(-1, 0, -1)) * CROSS_SCALE;
  d.dys = (((at(1, 1, 0) - at(1, -1, 0)) - at(-1, 1, 0)) + at(-1, -1, 0)) * CROSS_SCALE;
  return d;
}

// Matx33f::solve(b, DECOMP_LU): Cramer's rule over the float determinant,
// x = 0 where it is exactly 0 (frontend/sift.py `solve3`).
__device__ void solve3(const float a[3][3], const float b[3], float x[3]) {
  const float det = (a[0][0] * (a[1][1] * a[2][2] - a[2][1] * a[1][2]) -
                     a[0][1] * (a[1][0] * a[2][2] - a[2][0] * a[1][2])) +
                    a[0][2] * (a[1][0] * a[2][1] - a[2][0] * a[1][1]);
  if (det == 0.f) {
    x[0] = x[1] = x[2] = 0.f;
    return;
  }
  const float d = 1.0f / det;
  x[0] = d * ((b[0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1]) -
               a[0][1] * (b[1] * a[2][2] - a[1][2] * b[2])) +
              a[0][2] * (b[1] * a[2][1] - a[1][1] * b[2]));
  x[1] = d * ((a[0][0] * (b[1] * a[2][2] - a[1][2] * b[2]) -
               b[0] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])) +
              a[0][2] * (a[1][0] * b[2] - b[1] * a[2][0]));
  x[2] = d * ((a[0][0] * (a[1][1] * b[2] - b[1] * a[2][1]) -
               a[0][1] * (a[1][0] * b[2] - b[1] * a[2][0])) +
              b[0] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]));
}

__global__ void sift_extrema_kernel(const float* __restrict__ dog, Pyr p, float* __restrict__ kp,
                                    int* __restrict__ idx, int* __restrict__ count, int capacity) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= p.t_start[p.n]) return;
  int o = 0;
  while (t >= p.t_start[o + 1]) ++o;
  const int H = p.rows[o], W = p.cols[o];
  const int iw = W - 2 * BORDER;
  const long long plane = static_cast<long long>(H - 2 * BORDER) * iw;
  const long long local = t - p.t_start[o];
  int layer = 1 + static_cast<int>(local / plane);
  const long long rem = local % plane;
  int r = BORDER + static_cast<int>(rem / iw), c = BORDER + static_cast<int>(rem % iw);
  const float* D = dog + p.d_off[o];
  const long long HW = static_cast<long long>(H) * W;
  const long long pix = layer * HW + static_cast<long long>(r) * W + c;
  const float val = D[pix];
  if (fabsf(val) <= 0.f) return;  // OpenCV's integer threshold is 0 at contrast 1e-5
  for (int dl = -1; dl <= 1; ++dl)
    for (int dr = -1; dr <= 1; ++dr)
      for (int dc = -1; dc <= 1; ++dc) {
        if (dl == 0 && dr == 0 && dc == 0) continue;
        const float v = D[pix + dl * HW + static_cast<long long>(dr) * W + dc];
        if (val > 0 ? v > val : v < val) return;
      }
  float xi = 0.f, xr = 0.f, xc = 0.f;
  int step = 0;
  for (; step < MAX_INTERP; ++step) {
    const Deriv d = derivatives(D, H, W, layer, r, c);
    const float A[3][3] = {{d.dxx, d.dxy, d.dxs}, {d.dxy, d.dyy, d.dys}, {d.dxs, d.dys, d.dss}};
    const float b[3] = {d.dx, d.dy, d.ds};
    float X[3];
    solve3(A, b, X);
    xi = -X[2];
    xr = -X[1];
    xc = -X[0];
    if (fabsf(xi) < 0.5f && fabsf(xr) < 0.5f && fabsf(xc) < 0.5f) break;
    if (fabsf(xi) > INT_MAX_3 || fabsf(xr) > INT_MAX_3 || fabsf(xc) > INT_MAX_3) return;
    c += __float2int_rn(xc);
    r += __float2int_rn(xr);
    layer += __float2int_rn(xi);
    if (layer < 1 || layer > N_LAYERS || c < BORDER || c >= W - BORDER || r < BORDER ||
        r >= H - BORDER)
      return;
  }
  if (step >= MAX_INTERP) return;
  const Deriv d = derivatives(D, H, W, layer, r, c);
  const float tdot = ((d.dx * xc) + (d.dy * xr)) + (d.ds * xi);
  const float contr = d.v * IMG_SCALE + tdot * 0.5f;
  if (fabsf(contr) * static_cast<float>(N_LAYERS) < CONTRAST) return;
  const float tr = d.dxx + d.dyy;
  const float det = d.dxx * d.dyy - d.dxy * d.dxy;
  if (det <= 0 || (tr * tr) * EDGE >= ((EDGE + 1) * (EDGE + 1)) * det) return;
  const float scale = static_cast<float>(1 << o);
  const float e = (static_cast<float>(layer) + xi) / static_cast<float>(N_LAYERS);
  const float size = ((static_cast<float>(exp2(static_cast<double>(e))) * SIGMA) * scale) * 2.0f;
  const int octave =
      o + (layer << 8) + (__double2int_rn((static_cast<double>(xi) + 0.5) * 255.0) << 16);
  const int slot = atomicAdd(count, 1);
  if (slot >= capacity) return;  // the wrapper sees the count and raises
  float* k = kp + 4 * static_cast<long long>(slot);
  k[0] = (static_cast<float>(c) + xc) * scale;
  k[1] = (static_cast<float>(r) + xr) * scale;
  k[2] = size;
  k[3] = fabsf(contr);
  int* q = idx + 5 * static_cast<long long>(slot);
  q[0] = octave;
  q[1] = layer;
  q[2] = r;
  q[3] = c;
  q[4] = static_cast<int>(p.d_off[o] + pix);
}

__global__ void __launch_bounds__(ORI_THREADS)
sift_orientation_kernel(const float* __restrict__ gauss, Pyr p, const float* __restrict__ ckp,
                        const int* __restrict__ cidx, float* __restrict__ okp,
                        int* __restrict__ osrc, int* __restrict__ count, int capacity) {
  __shared__ int s_bin[ORI_THREADS];
  __shared__ float s_w[ORI_THREADS];
  __shared__ float s_raw[ORI_BINS];
  __shared__ float s_hist[ORI_BINS];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int* ci = cidx + 5 * static_cast<long long>(k);
  const int o = ci[0] & 255, layer = ci[1], r = ci[2], c = ci[3];
  const int H = p.rows[o], W = p.cols[o];
  const float* G = gauss + p.g_off[o] + layer * static_cast<long long>(H) * W;
  const float size = ckp[4 * static_cast<long long>(k) + 2];
  const float scl = (size * 0.5f) / static_cast<float>(1 << o);
  const int radius = __float2int_rn(scl * ORI_RADIUS);
  const float sigma = scl * ORI_SIG;
  const float expf_scale = -1.0f / ((sigma * 2.0f) * sigma);
  const int side = 2 * radius + 1, len = side * side;
  float acc = 0.f;  // owner threads 0-35: the bin's sum, in raster order
  for (int base = 0; base < len; base += ORI_THREADS) {
    const int s = base + tid;
    int bin = -1;
    float w = 0.f;
    if (s < len) {
      const int i = s / side - radius, j = s % side - radius;
      const int y = r + i, x = c + j;
      if (y > 0 && y < H - 1 && x > 0 && x < W - 1) {
        const float* g = G + static_cast<long long>(y) * W + x;
        const float dx = g[1] - g[-1];
        const float dy = g[-W] - g[W];
        const float wt = exp_f(static_cast<float>(i * i + j * j) * expf_scale);
        bin = __float2int_rn(fast_atan2(dy, dx) * ORI_BIN_SCALE);
        if (bin >= ORI_BINS) bin -= ORI_BINS;
        if (bin < 0) bin += ORI_BINS;
        w = wt * magnitude(dx, dy);
      }
    }
    s_bin[tid] = bin;
    s_w[tid] = w;
    __syncthreads();
    if (tid < ORI_BINS) {
      const int m = min(ORI_THREADS, len - base);
      for (int q = 0; q < m; ++q)
        if (s_bin[q] == tid) acc += s_w[q];
    }
    __syncthreads();
  }
  if (tid < ORI_BINS) s_raw[tid] = acc;
  __syncthreads();
  if (tid < ORI_BINS) {
    const int n = ORI_BINS;
    const float tn2 = s_raw[(tid + n - 2) % n], tn1 = s_raw[(tid + n - 1) % n];
    const float tp1 = s_raw[(tid + 1) % n], tp2 = s_raw[(tid + 2) % n], t0 = s_raw[tid];
    // OpenCV's 8-lane SIMD loop for bins 0-31, its scalar tail for 32-35.
    s_hist[tid] = tid < (n / 8) * 8
                      ? (tn2 + tp2) * (1.f / 16.f) + ((tn1 + tp1) * 0.25f + t0 * 0.375f)
                      : ((tn2 + tp2) * (1.f / 16.f) + (tn1 + tp1) * 0.25f) + t0 * 0.375f;
  }
  __syncthreads();
  if (tid != 0) return;
  float omax = s_hist[0];
  for (int j = 1; j < ORI_BINS; ++j) omax = fmaxf(omax, s_hist[j]);
  const float thr = omax * PEAK_RATIO;
  float angles[ORI_BINS / 2];
  int np = 0;
  for (int j = 0; j < ORI_BINS; ++j) {
    const int l = j > 0 ? j - 1 : ORI_BINS - 1, r2 = j < ORI_BINS - 1 ? j + 1 : 0;
    const float hl = s_hist[l], hj = s_hist[j], hr = s_hist[r2];
    if (hj > hl && hj > hr && hj >= thr) {
      float bin = static_cast<float>(j) + ((hl - hr) * 0.5f) / ((hl - hj * 2.0f) + hr);
      bin = bin < 0 ? bin + ORI_BINS : bin >= ORI_BINS ? bin - ORI_BINS : bin;
      float angle = 360.f - bin * 10.f;
      if (fabsf(angle - 360.f) < FLT_EPSILON) angle = 0.f;
      angles[np++] = angle;
    }
  }
  if (np == 0) return;
  const int slot = atomicAdd(count, np);
  const float* ck = ckp + 4 * static_cast<long long>(k);
  for (int q = 0; q < np && slot + q < capacity; ++q) {
    float* out = okp + 6 * static_cast<long long>(slot + q);
    out[0] = ck[0];
    out[1] = ck[1];
    out[2] = ck[2];
    out[3] = angles[q];
    out[4] = ck[3];
    out[5] = static_cast<float>(ci[0]);
    osrc[slot + q] = k;
  }
}

__global__ void __launch_bounds__(DESC_THREADS)
sift_descriptor_kernel(const float* __restrict__ gauss, Pyr p, const float* __restrict__ kps,
                       float* __restrict__ des) {
  __shared__ int s_idx[DESC_THREADS];
  __shared__ float s_v[8][DESC_THREADS];
  __shared__ float s_hist[HIST_LEN];
  __shared__ float s_raw[DESC_LEN];
  __shared__ float s_lane[8];
  __shared__ float s_scale;
  const int k = blockIdx.x, tid = threadIdx.x;
  const float* kp = kps + 6 * static_cast<long long>(k);
  const int packed = static_cast<int>(kp[5]);
  int octave = packed & 255;
  const int layer = (packed >> 8) & 255;
  octave = octave < 128 ? octave : octave - 256;
  const float scale = octave >= 0 ? 1.f / static_cast<float>(1 << octave)
                                  : static_cast<float>(1 << -octave);
  const int oi = octave + 1;  // the first octave is -1
  const int H = p.rows[oi], W = p.cols[oi];
  const float* G = gauss + p.g_off[oi] + layer * static_cast<long long>(H) * W;
  const float size = kp[2] * scale;
  const float ptx = kp[0] * scale, pty = kp[1] * scale;
  float angle = 360.f - kp[3];
  if (fabsf(angle - 360.f) < FLT_EPSILON) angle = 0.f;
  const float scl = size * 0.5f;
  const int cx = __float2int_rn(ptx), cy = __float2int_rn(pty);
  const float theta = angle * DEG2RAD;
  const float hist_width = scl * 3.0f;
  const float cos_t = static_cast<float>(cos(static_cast<double>(theta))) / hist_width;
  const float sin_t = static_cast<float>(sin(static_cast<double>(theta))) / hist_width;
  int radius = __float2int_rn(((hist_width * SQRT2) * static_cast<float>(DW + 1)) * 0.5f);
  const int diag = static_cast<int>(sqrt(static_cast<double>(W) * W + static_cast<double>(H) * H));
  radius = min(radius, diag);
  const int side = 2 * radius + 1, len = side * side;
  float acc = 0.f;  // owner threads 0-359: the bin's sum, in raster order
  for (int base = 0; base < len; base += DESC_THREADS) {
    const int s = base + tid;
    int first = -1000;
    if (s < len) {
      const int i = s / side - radius, j = s % side - radius;
      const float c_rot = static_cast<float>(j) * cos_t - static_cast<float>(i) * sin_t;
      const float r_rot = static_cast<float>(j) * sin_t + static_cast<float>(i) * cos_t;
      float rbin = (r_rot + static_cast<float>(DW / 2)) - 0.5f;
      float cbin = (c_rot + static_cast<float>(DW / 2)) - 0.5f;
      const int rr = cy + i, cc = cx + j;
      if (rbin > -1 && rbin < DW && cbin > -1 && cbin < DW && rr > 0 && rr < H - 1 && cc > 0 &&
          cc < W - 1) {
        const float* g = G + static_cast<long long>(rr) * W + cc;
        const float dx = g[1] - g[-1];
        const float dy = g[-W] - g[W];
        const float w = exp_f((c_rot * c_rot + r_rot * r_rot) * -0.125f);
        const float mag = magnitude(dx, dy) * w;
        float obin = (fast_atan2(dy, dx) - angle) * DESC_BIN_SCALE;
        const float r0 = floorf(rbin), c0 = floorf(cbin), o0f = floorf(obin);
        rbin -= r0;
        cbin -= c0;
        obin -= o0f;
        int o0 = static_cast<int>(o0f);
        if (o0 < 0) o0 += DN;
        if (o0 >= DN) o0 -= DN;
        const float v_r1 = mag * rbin, v_r0 = mag - v_r1;
        const float v_rc11 = v_r1 * cbin, v_rc10 = v_r1 - v_rc11;
        const float v_rc01 = v_r0 * cbin, v_rc00 = v_r0 - v_rc01;
        const float v_rco111 = v_rc11 * obin, v_rco110 = v_rc11 - v_rco111;
        const float v_rco101 = v_rc10 * obin, v_rco100 = v_rc10 - v_rco101;
        const float v_rco011 = v_rc01 * obin, v_rco010 = v_rc01 - v_rco011;
        const float v_rco001 = v_rc00 * obin, v_rco000 = v_rc00 - v_rco001;
        first = ((static_cast<int>(r0) + 1) * (DW + 2) + static_cast<int>(c0) + 1) * (DN + 2) + o0;
        s_v[0][tid] = v_rco000;
        s_v[1][tid] = v_rco001;
        s_v[2][tid] = v_rco010;
        s_v[3][tid] = v_rco011;
        s_v[4][tid] = v_rco100;
        s_v[5][tid] = v_rco101;
        s_v[6][tid] = v_rco110;
        s_v[7][tid] = v_rco111;
      }
    }
    s_idx[tid] = first;
    __syncthreads();
    if (tid < HIST_LEN) {
      const int m = min(DESC_THREADS, len - base);
      for (int q = 0; q < m; ++q) {
        switch (tid - s_idx[q]) {  // the eight bins a sample feeds, from its first
          case 0: acc += s_v[0][q]; break;
          case 1: acc += s_v[1][q]; break;
          case DN + 2: acc += s_v[2][q]; break;
          case DN + 3: acc += s_v[3][q]; break;
          case (DW + 2) * (DN + 2): acc += s_v[4][q]; break;
          case (DW + 2) * (DN + 2) + 1: acc += s_v[5][q]; break;
          case (DW + 3) * (DN + 2): acc += s_v[6][q]; break;
          case (DW + 3) * (DN + 2) + 1: acc += s_v[7][q]; break;
          default: break;
        }
      }
    }
    __syncthreads();
  }
  if (tid < HIST_LEN) s_hist[tid] = acc;
  __syncthreads();
  if (tid < DESC_LEN) {
    const int cell = tid / DN, b = tid % DN;
    const int h0 = ((cell / DW + 1) * (DW + 2) + (cell % DW + 1)) * (DN + 2);
    float v = s_hist[h0 + b];
    if (b < 2) v = v + s_hist[h0 + DN + b];
    s_raw[tid] = v;
  }
  __syncthreads();
  if (tid < 8) {  // the norm's first sum: 8 SIMD lanes of fused multiply-adds
    float a = 0.f;
    for (int q = tid; q < DESC_LEN; q += 8) a = __fmaf_rn(s_raw[q], s_raw[q], a);
    s_lane[tid] = a;
  }
  __syncthreads();
  if (tid == 0) {
    const float s0 = s_lane[0] + s_lane[4], s1 = s_lane[1] + s_lane[5];
    const float s2 = s_lane[2] + s_lane[6], s3 = s_lane[3] + s_lane[7];
    const float thr = sqrtf((s0 + s1) + (s2 + s3)) * MAG_THR;
    float nrm2 = 0.f;
    for (int q = 0; q < DESC_LEN; ++q) {
      const float v = fminf(s_raw[q], thr);
      s_raw[q] = v;
      nrm2 = nrm2 + v * v;
    }
    s_scale = 512.f / fmaxf(sqrtf(nrm2), FLT_EPSILON);
  }
  __syncthreads();
  if (tid < DESC_LEN)
    des[static_cast<long long>(k) * DESC_LEN + tid] =
        fminf(fmaxf(rintf(s_raw[tid] * s_scale), 0.f), 255.f);
}

Pyr make_pyr(const long long* table, int n_oct) {
  Pyr p{};
  p.n = n_oct;
  p.t_start[0] = 0;
  for (int o = 0; o < n_oct; ++o) {
    p.rows[o] = static_cast<int>(table[4 * o]);
    p.cols[o] = static_cast<int>(table[4 * o + 1]);
    p.g_off[o] = table[4 * o + 2];
    p.d_off[o] = table[4 * o + 3];
    const bool inner = p.rows[o] > 2 * BORDER && p.cols[o] > 2 * BORDER;
    const long long tested =
        static_cast<long long>(N_LAYERS) * (p.rows[o] - 2 * BORDER) * (p.cols[o] - 2 * BORDER);
    p.t_start[o + 1] = p.t_start[o] + (inner ? tested : 0);
  }
  return p;
}

}  // namespace

// table: host [n_oct, 4] int64 (rows, cols, g_off, d_off). Each returns the
// launch's cudaError (0 when it was accepted).
extern "C" int sift_extrema(const float* dog, const long long* table, int n_oct, float* kp,
                            int* idx, int* count, int capacity, cudaStream_t stream) {
  if (n_oct < 1 || n_oct > MAX_OCT) return static_cast<int>(cudaErrorInvalidValue);
  const Pyr p = make_pyr(table, n_oct);
  const long long threads = p.t_start[n_oct];
  if (threads == 0) return 0;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  sift_extrema_kernel<<<static_cast<unsigned>(grid), block, 0, stream>>>(dog, p, kp, idx, count,
                                                                         capacity);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sift_orientation(const float* gauss, const long long* table, int n_oct,
                                const float* ckp, const int* cidx, int n_cand, float* okp,
                                int* osrc, int* count, int capacity, cudaStream_t stream) {
  if (n_oct < 1 || n_oct > MAX_OCT) return static_cast<int>(cudaErrorInvalidValue);
  if (n_cand == 0) return 0;
  const Pyr p = make_pyr(table, n_oct);
  sift_orientation_kernel<<<n_cand, ORI_THREADS, 0, stream>>>(gauss, p, ckp, cidx, okp, osrc,
                                                             count, capacity);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sift_descriptor(const float* gauss, const long long* table, int n_oct,
                               const float* kp, int n_kp, float* des, cudaStream_t stream) {
  if (n_oct < 1 || n_oct > MAX_OCT) return static_cast<int>(cudaErrorInvalidValue);
  if (n_kp == 0) return 0;
  const Pyr p = make_pyr(table, n_oct);
  sift_descriptor_kernel<<<n_kp, DESC_THREADS, 0, stream>>>(gauss, p, kp, des);
  return static_cast<int>(cudaGetLastError());
}
