// Fused 3x3 SAME convolution + per-channel affine + ReLU, float32: the
// forward (K5) and its backward (K5b).
//
// K5 replaces the TPU kernel `_fwd_kernel` of
// deepfepe_tpu/ops/pallas/conv_pallas.py (through `_fwd_pallas`, wrapper
// `conv3x3_affine_relu`). It computes, in NHWC,
//     y[b, i, j, c] = relu(scale[c] * sum_{ky, kx, ci} x[b, i+ky-1, j+kx-1, ci]
//                                                      * w[ky, kx, ci, c] + bias[c])
// with zero padding outside each image (SAME), so images never bleed into
// each other. Inference BatchNorm is folded into (scale, bias) by the caller
// (frontend/sp_fused.py); a plain conv + ReLU has scale 1 and bias = the
// conv bias. Products and sums are float32 FFMA (no TF32). The wrapper and
// the plain versions are in ops/conv.py.
//
// K5b replaces `_bwd_kernel` of the same file (through `_bwd_pallas`, the
// VJP of `_fused`). From x, w, scale, bias, the saved y and the cotangent dy
// it computes, with dz = dy * (y > 0) * scale and s_safe = scale where
// |scale| >= 1e-8, else 1 (`_safe`):
//     dbias[c]  = sum_{b, i, j} dz / s_safe
//     dscale[c] = sum_{b, i, j} (dz / s_safe) * (y - bias) / s_safe
//     dw[ky, kx, ci, c] = sum_{b, i, j} x[b, i+ky-1, j+kx-1, ci] * dz[b, i, j, c]
//     dx[b, i, j, ci]   = sum_{ky, kx, c} dz[b, i+1-ky, j+1-kx, c] * w[ky, kx, ci, c]
// and dx only when the caller asks for it (`need_dx`). dscale recovers the
// pre-affine sum as (y - bias) / s_safe, as the TPU kernel does.
//
// What bounds them. On the SuperPoint path (B = 8 frames of 376 x 1240) the
// 64 -> 64 full-resolution conv is 2 x 466,240 x 8 x 9 x 64 x 64 = 275
// GFLOP: 4.1 ms at the card's 67 TFLOP/s FP32 rate, against 1.9 GB of input
// and output (0.57 ms at 3.35 TB/s), so it is bound by operations. Its
// backward does that twice (dx and dw), 8.2 ms, against 3.8 GB. The
// image-input conv (Cin = 1, C = 64) does 4.3 GFLOP and moves 955 MB
// forward and 1.9 GB backward: bound by bytes.
//
// Forward design. A direct implicit GEMM: M = output pixels, N = output
// channels, K = 9 x Cin. A block owns an 8 x 16 tile of one image's output
// pixels by 64 output channels and walks Cin in chunks of 8. For each chunk
// it stages the (8 + 2) x (16 + 2) halo tile of x (loads outside the image
// give 0) and the chunk's 9 x 8 x 64 weights in shared memory, then each of
// 256 threads accumulates 8 pixels (one row, 8 neighbouring columns) x 4
// channels in registers from float4 shared-memory reads: per 4 input
// channels, 8 reads of x and 4 of w feed 128 FMAs. The affine + ReLU
// epilogue runs on the registers before the one store. Cin = 1 (the grey
// image into conv1a / inc.conv0) has its own kernel: a thread reads the 9
// neighbours once and writes 4 channels, with the 9 x C weights in shared
// memory; that conv is bound by its output bytes.
//
// Backward design. dx is the same implicit GEMM run over dz with the
// flipped, transposed kernel w[2-ky, 2-kx, c, ci]: the template flag DGRAD
// makes the halo loader form dz = dy * (y > 0) * scale from dy and y as the
// tile is staged, and drops the epilogue. Cin = 1 has its own dx kernel (a
// per-pixel reduction over the 9 taps x C). dw, dscale and dbias are
// reductions over all B H W pixels (3.7 M at inc.conv1). The pixels are
// split into G groups of 4 x 16-pixel tiles; a block owns one group, one
// kernel row ky, 64 input channels (4 when Cin <= 4) and 64 output
// channels, stages each tile's dz (formed from dy and y as above) and the
// x rows it needs in shared memory, and accumulates its 3 x 64 x 64 slice
// of dw in registers (a thread holds 3 taps x 4 input x 4 output
// channels, fed by four float4 reads a pixel). The blocks of kernel row 0
// and the first input-channel chunk also sum dscale and dbias. Each block
// writes its partial sums to a scratch buffer that the wrapper allocates,
// and a second kernel sums the G partials in a fixed order, so the result
// does not depend on the order the blocks ran in (no atomics). The TPU
// kernels' row folding and tile-height rule (`_fold_rows`, `_pick_th`)
// exist for VMEM and Mosaic and are not carried over. wgmma, TMA and a
// pipelined ring of tiles are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;            // output rows per block
constexpr int TW = 16;           // output columns per block
constexpr int CT = 64;           // output channels per block
constexpr int CK = 8;            // input channels per shared-memory chunk
constexpr int THREADS = 256;
constexpr int HR = TH + 2;       // halo tile rows
constexpr int HC = TW + 2;       // halo tile columns
constexpr int PX = 8;            // pixels per thread (one row, 8 columns)
constexpr int C1_MAX = 256;      // widest C of the Cin = 1 kernels
constexpr int WTH = 4;           // weight-gradient tile rows
constexpr int WTW = 16;          // weight-gradient tile columns
constexpr int WTP = WTH * WTW;   // pixels a weight-gradient tile
constexpr int WBLOCKS = 1024;    // weight-gradient blocks to aim for
constexpr float SAFE_EPS = 1e-8f;

__device__ __forceinline__ float safe_scale(float s) { return fabsf(s) < SAFE_EPS ? 1.0f : s; }

// out[b, i, j, n] = sum_{tap, k} in[b, i+ty-1, j+tx-1, k] * wt(tap, k, n), in
// [B, H, W, K] and out [B, H, W, N].
// DGRAD = false, K5: in = x, wt(tap, k, n) = w[tap][k][n], out = relu(acc *
//   scale[n] + bias[n]).
// DGRAD = true, K5b's dx: in = dz = dy * (ymask > 0) * scale[k] (formed as
//   the halo tile is staged), wt(tap, k, n) = w[8 - tap][n][k] for w of the
//   forward [3, 3, N, K], out = acc.
template <bool DGRAD>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const float* __restrict__ in, const float* __restrict__ ymask,
               const float* __restrict__ w, const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ out, int H, int W,
               int K, int N, int n_blocks) {
  __shared__ __align__(16) float xs[HR * HC * CK];  // [row][col][k]
  __shared__ __align__(16) float ws[9 * CK * CT];   // [tap][k][n]
  const int tid = threadIdx.x;
  const int tc = tid % 16;               // channels 4 tc .. 4 tc + 3
  const int tp = tid / 16;               // pixels: row tp / 2, columns 8 (tp % 2) + 0..7
  const int pr = tp / 2;
  const int pc = (tp % 2) * PX;
  const int b = blockIdx.z / n_blocks;
  const int c0 = (blockIdx.z % n_blocks) * CT;
  const int row0 = blockIdx.y * TH;
  const int col0 = blockIdx.x * TW;
  const size_t img = static_cast<size_t>(b) * H * W * K;

  float acc[PX][4];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += CK) {
    for (int i = tid; i < HR * HC * CK; i += THREADS) {
      const int ci = i % CK;
      const int pix = i / CK;
      const int gy = row0 + pix / HC - 1;
      const int gx = col0 + pix % HC - 1;
      const int gc = k0 + ci;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < K) {
        const size_t at = img + (static_cast<size_t>(gy) * W + gx) * K + gc;
        if (DGRAD) {
          const float m = ymask[at] > 0.0f ? 1.0f : 0.0f;
          v = in[at] * m * scale[gc];
        } else {
          v = in[at];
        }
      }
      xs[i] = v;
    }
    for (int i = tid; i < 9 * CK * CT; i += THREADS) {
      const int co = i % CT;
      const int r = i / CT;
      const int gc = k0 + r % CK;
      const int tap = r / CK;
      float v = 0.0f;
      if (gc < K && c0 + co < N)
        v = DGRAD ? w[(static_cast<size_t>(8 - tap) * N + c0 + co) * K + gc]
                  : w[(static_cast<size_t>(tap) * K + gc) * N + c0 + co];
      ws[i] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap % 3;
      const float* xrow = xs + ((pr + ky) * HC + pc + kx) * CK;
      const float* wtap = ws + tap * CK * CT + 4 * tc;
#pragma unroll
      for (int ci = 0; ci < CK; ci += 4) {
        float4 wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = *reinterpret_cast<const float4*>(wtap + (ci + q) * CT);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(xrow + j * CK + ci);
          acc[j][0] = fmaf(xv.x, wv[0].x, acc[j][0]);
          acc[j][1] = fmaf(xv.x, wv[0].y, acc[j][1]);
          acc[j][2] = fmaf(xv.x, wv[0].z, acc[j][2]);
          acc[j][3] = fmaf(xv.x, wv[0].w, acc[j][3]);
          acc[j][0] = fmaf(xv.y, wv[1].x, acc[j][0]);
          acc[j][1] = fmaf(xv.y, wv[1].y, acc[j][1]);
          acc[j][2] = fmaf(xv.y, wv[1].z, acc[j][2]);
          acc[j][3] = fmaf(xv.y, wv[1].w, acc[j][3]);
          acc[j][0] = fmaf(xv.z, wv[2].x, acc[j][0]);
          acc[j][1] = fmaf(xv.z, wv[2].y, acc[j][1]);
          acc[j][2] = fmaf(xv.z, wv[2].z, acc[j][2]);
          acc[j][3] = fmaf(xv.z, wv[2].w, acc[j][3]);
          acc[j][0] = fmaf(xv.w, wv[3].x, acc[j][0]);
          acc[j][1] = fmaf(xv.w, wv[3].y, acc[j][1]);
          acc[j][2] = fmaf(xv.w, wv[3].z, acc[j][2]);
          acc[j][3] = fmaf(xv.w, wv[3].w, acc[j][3]);
        }
      }
    }
    __syncthreads();
  }

  const int gy = row0 + pr;
  if (gy >= H) return;
  float s[4], t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int co = c0 + 4 * tc + k;
    s[k] = !DGRAD && co < N ? scale[co] : 0.0f;
    t[k] = !DGRAD && co < N ? bias[co] : 0.0f;
  }
  float* orow = out + ((static_cast<size_t>(b) * H + gy) * W) * N;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int gx = col0 + pc + j;
    if (gx >= W) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int co = c0 + 4 * tc + k;
      if (co < N)
        orow[static_cast<size_t>(gx) * N + co] =
            DGRAD ? acc[j][k] : fmaxf(acc[j][k] * s[k] + t[k], 0.0f);
    }
  }
}

// Cin = 1: one thread per (pixel, 4 channels), grid-stride over all of them.
__global__ void __launch_bounds__(THREADS)
conv3x3_cin1_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    float* __restrict__ y, long long npix, int H, int W, int C) {
  __shared__ float ws[9 * C1_MAX];  // [tap][co]
  __shared__ float ss[C1_MAX];
  __shared__ float ts[C1_MAX];
  for (int i = threadIdx.x; i < 9 * C; i += THREADS) ws[i] = w[i];
  for (int i = threadIdx.x; i < C; i += THREADS) {
    ss[i] = scale[i];
    ts[i] = bias[i];
  }
  __syncthreads();
  const int cq = (C + 3) / 4;
  const long long total = npix * cq;
  for (long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * THREADS) {
    const int q = static_cast<int>(idx % cq);
    const long long p = idx / cq;
    const int gx = static_cast<int>(p % W);
    const long long bi = p / W;
    const int gy = static_cast<int>(bi % H);
    const float* xb = x + (bi / H) * H * W;
    float v[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = gy + tap / 3 - 1;
      const int xx = gx + tap % 3 - 1;
      v[tap] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                   ? xb[static_cast<long long>(yy) * W + xx] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int co = 4 * q + k;
      if (co >= C) break;
      float a = 0.0f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) a = fmaf(v[tap], ws[tap * C + co], a);
      y[p * C + co] = fmaxf(a * ss[co] + ts[co], 0.0f);
    }
  }
}

// K5b's dx for Cin = 1: one thread per pixel, grid-stride, the sum over the
// 9 taps and C channels of dz at the pixel's neighbours.
__global__ void __launch_bounds__(THREADS)
conv3x3_dgrad_cin1_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                          const float* __restrict__ w, const float* __restrict__ scale,
                          float* __restrict__ dx, long long npix, int H, int W, int C) {
  __shared__ float ws[9 * C1_MAX];  // [tap][c]
  __shared__ float ss[C1_MAX];
  for (int i = threadIdx.x; i < 9 * C; i += THREADS) ws[i] = w[i];
  for (int i = threadIdx.x; i < C; i += THREADS) ss[i] = scale[i];
  __syncthreads();
  for (long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; p < npix;
       p += static_cast<long long>(gridDim.x) * THREADS) {
    const int gx = static_cast<int>(p % W);
    const long long bi = p / W;
    const int gy = static_cast<int>(bi % H);
    const long long base = (bi / H) * H;
    float a = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = gy + 1 - tap / 3;
      const int xx = gx + 1 - tap % 3;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      const size_t at = static_cast<size_t>((base + yy) * W + xx) * C;
      for (int c = 0; c < C; ++c) {
        const float m = y[at + c] > 0.0f ? 1.0f : 0.0f;
        a = fmaf(dy[at + c] * m * ss[c], ws[tap * C + c], a);
      }
    }
    dx[p] = a;
  }
}

// K5b's dw, dscale and dbias, partial sums of pixel group g = blockIdx.y.
// blockIdx.x = ky + 3 (kb + k_blocks nb): kernel row ky, input channels
// [kb WK, kb WK + WK), output channels [nb CT, nb CT + CT). A thread holds 3
// taps x 4 input x 4 output channels; with WK = 4 (Cin <= 4) 16 threads share
// each slot, each over its own pixels, and their sums are added in a fixed
// order at the end. part[g] is [9 Cin C] dw, then [C] dscale, then [C]
// dbias; every entry is written by exactly one block.
template <int WK>
__global__ void __launch_bounds__(THREADS)
conv3x3_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ y, const float* __restrict__ scale,
                     const float* __restrict__ bias, float* __restrict__ part, int H, int W,
                     int Cin, int C, int k_blocks, int tiles_y, int tiles_x, long long n_tiles,
                     int G) {
  constexpr int NIQ = WK / 4;                  // input-channel quads
  constexpr int SLOTS = 16 * NIQ;              // (input quad, output quad) slots
  constexpr int PS = THREADS / SLOTS;          // threads per slot, each on its own pixels
  constexpr int NACC = 3 * 4 * 4;
  __shared__ __align__(16) float xs[WTH * (WTW + 2) * WK];  // [row][col][ci], kernel row ky
  __shared__ __align__(16) float dzs[WTP * CT];             // [pixel][co]
  __shared__ float red[PS > 1 ? SLOTS * NACC : 1];
  __shared__ float asum[2][THREADS];
  const int tid = threadIdx.x;
  const int cq = tid % 16;                     // output channels c0 + 4 cq + 0..3
  const int iq = (tid / 16) % NIQ;             // input channels k0 + 4 iq + 0..3
  const int ps = tid / SLOTS;
  int slice = blockIdx.x;
  const int ky = slice % 3;
  slice /= 3;
  const int k0 = (slice % k_blocks) * WK;
  const int c0 = (slice / k_blocks) * CT;
  const bool affine = ky == 0 && k0 == 0;
  const int g = blockIdx.y;
  const long long t_begin = n_tiles * g / G;
  const long long t_end = n_tiles * (g + 1) / G;
  const long long per_image = static_cast<long long>(tiles_y) * tiles_x;

  // The loader's channel is fixed: THREADS is a multiple of CT.
  const int lc = tid % CT;
  const bool lc_ok = c0 + lc < C;
  const float s_l = lc_ok ? scale[c0 + lc] : 0.0f;
  const float ss_l = safe_scale(s_l);
  const float t_l = lc_ok ? bias[c0 + lc] : 0.0f;
  float sum_m = 0.0f, sum_mz = 0.0f;

  float acc[3][4][4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][i][j] = 0.0f;

  for (long long t = t_begin; t < t_end; ++t) {
    const int b = static_cast<int>(t / per_image);
    const int r = static_cast<int>(t % per_image);
    const int row0 = (r / tiles_x) * WTH;
    const int col0 = (r % tiles_x) * WTW;
    const size_t img = static_cast<size_t>(b) * H * W;
    for (int i = tid; i < WTH * (WTW + 2) * WK; i += THREADS) {
      const int ci = i % WK;
      const int pix = i / WK;
      const int gy = row0 + pix / (WTW + 2) + ky - 1;
      const int gx = col0 + pix % (WTW + 2) - 1;
      const int gc = k0 + ci;
      xs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Cin)
                  ? x[(img + static_cast<size_t>(gy) * W + gx) * Cin + gc] : 0.0f;
    }
    for (int i = tid; i < WTP * CT; i += THREADS) {
      const int p = i / CT;
      const int gy = row0 + p / WTW;
      const int gx = col0 + p % WTW;
      float dz = 0.0f;
      if (gy < H && gx < W && lc_ok) {
        const size_t at = (img + static_cast<size_t>(gy) * W + gx) * C + c0 + lc;
        const float yv = y[at];
        const float m = yv > 0.0f ? 1.0f : 0.0f;
        dz = dy[at] * m * s_l;
        if (affine) {
          const float mm = dz / ss_l;
          sum_m += mm;
          sum_mz += mm * (yv - t_l) / ss_l;
        }
      }
      dzs[i] = dz;
    }
    __syncthreads();
    for (int p = ps; p < WTP; p += PS) {
      const int pr = p / WTW;
      const int pc = p % WTW;
      const float4 d = *reinterpret_cast<const float4*>(dzs + p * CT + 4 * cq);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + (pr * (WTW + 2) + pc + kx) * WK + 4 * iq);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[kx][i][0] = fmaf(xa[i], d.x, acc[kx][i][0]);
          acc[kx][i][1] = fmaf(xa[i], d.y, acc[kx][i][1]);
          acc[kx][i][2] = fmaf(xa[i], d.z, acc[kx][i][2]);
          acc[kx][i][3] = fmaf(xa[i], d.w, acc[kx][i][3]);
        }
      }
    }
    __syncthreads();
  }

  if (PS > 1) {
    // Add the PS threads of each slot in the order of ps.
    const int slot = tid % SLOTS;
    for (int round = 0; round < PS; ++round) {
      if (ps == round) {
        float* r = red + slot * NACC;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int q = (a * 4 + i) * 4 + j;
              r[q] = round == 0 ? acc[a][i][j] : r[q] + acc[a][i][j];
              acc[a][i][j] = r[q];
            }
      }
      __syncthreads();
    }
  }
  const size_t E = static_cast<size_t>(9) * Cin * C + 2 * static_cast<size_t>(C);
  float* out = part + static_cast<size_t>(g) * E;
  if (ps == PS - 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = k0 + 4 * iq + i;
        if (ci >= Cin) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = c0 + 4 * cq + j;
          if (co < C) out[(static_cast<size_t>(ky * 3 + a) * Cin + ci) * C + co] = acc[a][i][j];
        }
      }
  }
  if (affine) {
    asum[0][tid] = sum_mz;
    asum[1][tid] = sum_m;
    __syncthreads();
    if (tid < CT && c0 + tid < C) {
      float ds = 0.0f, dt = 0.0f;
      for (int q = 0; q < THREADS / CT; ++q) {
        ds += asum[0][tid + q * CT];
        dt += asum[1][tid + q * CT];
      }
      out[static_cast<size_t>(9) * Cin * C + c0 + tid] = ds;
      out[static_cast<size_t>(9) * Cin * C + C + c0 + tid] = dt;
    }
  }
}

// out[e] = sum_{g < G} part[g E + e], in the order of g.
__global__ void __launch_bounds__(THREADS)
sum_groups_kernel(const float* __restrict__ part, float* __restrict__ out, int G, long long E) {
  for (long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; e < E;
       e += static_cast<long long>(gridDim.x) * THREADS) {
    float s = 0.0f;
    for (int g = 0; g < G; ++g) s += part[g * E + e];
    out[e] = s;
  }
}

struct WgradPlan {
  int wk, k_blocks, n_blocks, tiles_y, tiles_x, groups;
  long long n_tiles, entries;
};

WgradPlan wgrad_plan(int B, int H, int W, int Cin, int C) {
  WgradPlan p;
  p.wk = Cin <= 4 ? 4 : 64;
  p.k_blocks = (Cin + p.wk - 1) / p.wk;
  p.n_blocks = (C + CT - 1) / CT;
  p.tiles_y = (H + WTH - 1) / WTH;
  p.tiles_x = (W + WTW - 1) / WTW;
  p.n_tiles = static_cast<long long>(B) * p.tiles_y * p.tiles_x;
  const int slices = 3 * p.k_blocks * p.n_blocks;
  long long groups = WBLOCKS / slices;
  if (groups < 1) groups = 1;
  if (groups > p.n_tiles) groups = p.n_tiles;
  p.groups = static_cast<int>(groups);
  p.entries = 9LL * Cin * C + 2LL * C;
  return p;
}

}  // namespace

// x [B, H, W, Cin], w [3, 3, Cin, C], scale and bias [C], y [B, H, W, C]:
// float32, contiguous, on the device. Cin = 1 takes C <= 256. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int conv3x3_affine_relu_f32(const float* x, const float* w, const float* scale,
                                       const float* bias, float* y, int B, int H, int W,
                                       int Cin, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin == 1) {
    if (C > C1_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const long long npix = static_cast<long long>(B) * H * W;
    const long long total = npix * ((C + 3) / 4);
    const long long want = (total + THREADS - 1) / THREADS;
    const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
    conv3x3_cin1_kernel<<<blocks, THREADS, 0, st>>>(x, w, scale, bias, y, npix, H, W, C);
  } else {
    const int c_blocks = (C + CT - 1) / CT;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * c_blocks);
    conv3x3_kernel<false><<<grid, THREADS, 0, st>>>(x, nullptr, w, scale, bias, y, H, W, Cin,
                                                    C, c_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch that conv3x3_affine_relu_bwd_f32 takes for these shapes.
extern "C" long long conv3x3_bwd_scratch_floats(int B, int H, int W, int Cin, int C) {
  const WgradPlan p = wgrad_plan(B, H, W, Cin, C);
  return static_cast<long long>(p.groups) * p.entries;
}

// K5b. x, w, scale, bias as the forward; y its output and dy the cotangent
// [B, H, W, C]. Writes dw [9 Cin C], then dscale [C], then dbias [C] into
// `out` (9 Cin C + 2 C floats), using `part` (conv3x3_bwd_scratch_floats) for
// the partial sums, and dx [B, H, W, Cin] when dx is not null (no dx kernel
// is launched otherwise). Cin = 1 takes C <= 256. Launches on `stream`;
// returns the first launch's error, else 0.
extern "C" int conv3x3_affine_relu_bwd_f32(const float* x, const float* w, const float* scale,
                                           const float* bias, const float* y, const float* dy,
                                           float* dx, float* part, float* out, int B, int H,
                                           int W, int Cin, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cin <= 0) return 0;
  if (Cin == 1 && C > C1_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WgradPlan p = wgrad_plan(B, H, W, Cin, C);
  const dim3 wgrid(3 * p.k_blocks * p.n_blocks, p.groups);
  if (p.wk == 4)
    conv3x3_wgrad_kernel<4><<<wgrid, THREADS, 0, st>>>(x, dy, y, scale, bias, part, H, W, Cin,
                                                       C, p.k_blocks, p.tiles_y, p.tiles_x,
                                                       p.n_tiles, p.groups);
  else
    conv3x3_wgrad_kernel<64><<<wgrid, THREADS, 0, st>>>(x, dy, y, scale, bias, part, H, W,
                                                        Cin, C, p.k_blocks, p.tiles_y,
                                                        p.tiles_x, p.n_tiles, p.groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (p.entries + THREADS - 1) / THREADS;
  sum_groups_kernel<<<static_cast<int>(want < 4096 ? want : 4096), THREADS, 0, st>>>(
      part, out, p.groups, p.entries);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return static_cast<int>(err);
  if (Cin == 1) {
    const long long npix = static_cast<long long>(B) * H * W;
    const long long want_px = (npix + THREADS - 1) / THREADS;
    const int blocks = static_cast<int>(want_px < 132 * 32 ? want_px : 132 * 32);
    conv3x3_dgrad_cin1_kernel<<<blocks, THREADS, 0, st>>>(dy, y, w, scale, dx, npix, H, W, C);
  } else {
    const int k_blocks = (Cin + CT - 1) / CT;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * k_blocks);
    conv3x3_kernel<true><<<grid, THREADS, 0, st>>>(dy, y, w, scale, nullptr, dx, H, W, C, Cin,
                                                   k_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
