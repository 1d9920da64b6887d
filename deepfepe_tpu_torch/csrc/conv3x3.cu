// Fused 3x3 SAME convolution + per-channel affine + ReLU (K5), float32.
//
// Replaces the TPU kernel `_fwd_kernel` of
// deepfepe_tpu/ops/pallas/conv_pallas.py (through `_fwd_pallas`, wrapper
// `conv3x3_affine_relu`). It computes, in NHWC,
//     y[b, i, j, c] = relu(scale[c] * sum_{ky, kx, ci} x[b, i+ky-1, j+kx-1, ci]
//                                                      * w[ky, kx, ci, c] + bias[c])
// with zero padding outside each image (SAME), so images never bleed into
// each other. Inference BatchNorm is folded into (scale, bias) by the caller
// (frontend/sp_fused.py); a plain conv + ReLU has scale 1 and bias = the
// conv bias. Products and sums are float32 FFMA (no TF32). The wrapper and
// the plain version are in ops/conv.py.
//
// What bounds it. On the SuperPoint path (B = 8 frames of 376 x 1240) the
// 64 -> 64 full-resolution conv is 2 x 466,240 x 8 x 9 x 64 x 64 = 275
// GFLOP: 4.1 ms at the card's 67 TFLOP/s FP32 rate, against 1.9 GB of input
// and output (0.57 ms at 3.35 TB/s), so it is bound by operations. The
// image-input conv (Cin = 1, C = 64) does 4.3 GFLOP and writes 955 MB: bound
// by bytes (0.29 ms).
//
// Design. A direct implicit GEMM: M = output pixels, N = output channels,
// K = 9 x Cin. A block owns an 8 x 16 tile of one image's output pixels by
// 64 output channels and walks Cin in chunks of 8. For each chunk it stages
// the (8 + 2) x (16 + 2) halo tile of x (loads outside the image give 0) and
// the chunk's 9 x 8 x 64 weights in shared memory, then each of 256 threads
// accumulates 8 pixels (one row, 8 neighbouring columns) x 4 channels in
// registers from float4 shared-memory reads: per 4 input channels, 8 reads of
// x and 4 of w feed 128 FMAs. The affine + ReLU epilogue runs on the
// registers before the one store. Cin = 1 (the grey image into conv1a /
// inc.conv0) has its own kernel: a thread reads the 9 neighbours once and
// writes 4 channels, with the 9 x C weights in shared memory; that conv is
// bound by its output bytes. The TPU kernel's row folding and tile-height
// rule (`_fold_rows`, `_pick_th`) exist for VMEM and Mosaic and are not
// carried over. wgmma, TMA and a pipelined ring of tiles are later work.

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
constexpr int C1_MAX = 256;      // widest C of the Cin = 1 kernel

__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               float* __restrict__ y, int H, int W, int Cin, int C, int c_blocks) {
  __shared__ __align__(16) float xs[HR * HC * CK];  // [row][col][ci]
  __shared__ __align__(16) float ws[9 * CK * CT];   // [tap][ci][co]
  const int tid = threadIdx.x;
  const int tc = tid % 16;               // channels 4 tc .. 4 tc + 3
  const int tp = tid / 16;               // pixels: row tp / 2, columns 8 (tp % 2) + 0..7
  const int pr = tp / 2;
  const int pc = (tp % 2) * PX;
  const int b = blockIdx.z / c_blocks;
  const int c0 = (blockIdx.z % c_blocks) * CT;
  const int row0 = blockIdx.y * TH;
  const int col0 = blockIdx.x * TW;
  const float* xb = x + static_cast<size_t>(b) * H * W * Cin;

  float acc[PX][4];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;

  for (int k0 = 0; k0 < Cin; k0 += CK) {
    for (int i = tid; i < HR * HC * CK; i += THREADS) {
      const int ci = i % CK;
      const int pix = i / CK;
      const int gy = row0 + pix / HC - 1;
      const int gx = col0 + pix % HC - 1;
      const int gc = k0 + ci;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Cin)
        v = xb[(static_cast<size_t>(gy) * W + gx) * Cin + gc];
      xs[i] = v;
    }
    for (int i = tid; i < 9 * CK * CT; i += THREADS) {
      const int co = i % CT;
      const int r = i / CT;
      const int gc = k0 + r % CK;
      const int tap = r / CK;
      ws[i] = (gc < Cin && c0 + co < C)
                  ? w[(static_cast<size_t>(tap) * Cin + gc) * C + c0 + co] : 0.0f;
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
    s[k] = co < C ? scale[co] : 0.0f;
    t[k] = co < C ? bias[co] : 0.0f;
  }
  float* yrow = y + ((static_cast<size_t>(b) * H + gy) * W) * C;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int gx = col0 + pc + j;
    if (gx >= W) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int co = c0 + 4 * tc + k;
      if (co < C) yrow[static_cast<size_t>(gx) * C + co] = fmaxf(acc[j][k] * s[k] + t[k], 0.0f);
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
    conv3x3_kernel<<<grid, THREADS, 0, st>>>(x, w, scale, bias, y, H, W, Cin, C, c_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
