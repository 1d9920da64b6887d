// The 64 -> 64 fused 3x3 SAME convolution + per-channel affine + ReLU in
// bf16 on the tensor cores, in four formulations: the counterparts of the
// conv-formulation shootout tools/bench_conv_formulations.py (X1-X4).
//
// Every kernel computes, in NHWC with x [B, H, W, 64] and y [B, H, W, 64]
// bf16, w packed bf16, s and t [64] float32,
//     y[b, i, j, c] = bf16(relu(s[c] * sum_{ky, kx, ci} x[b, i+ky-1, j+kx-1, ci]
//                                             * w[ky, kx, ci, c] + t[c]))
// with zero padding outside each image. Products run through nvcuda::wmma
// bf16 16x16x16 fragments with float32 accumulators; the epilogue computes
// acc * s, then + t (two roundings, no FMA, as the plain versions in
// ops/conv_formulations.py do), the ReLU, and rounds once to bf16.
//
// They replace the TPU kernels of tools/bench_conv_formulations.py:
//   X4 conv_strip        `_k_taps9`, `_k_ky3`, `_k_im2col` (make_fn): a block per
//                        (image, th-row strip) that walks the strip tw columns at
//                        a time with synchronous loads. taps9 reads A straight
//                        from the halo tile at 9 shifted offsets (ldm 64); ky3
//                        stages a [th, tw+2, 192] ky-stacked patch (3 products of
//                        K = 192, ldm 192); im2col a [th*tw, 576] patch (one
//                        product of K = 576, ldm 576).
//   X1 conv_strip_async  `_k_dma` (make_dma_fn): X4's ky3 and im2col with the
//                        next chunk's halo copied by cp.async (zero-filling at
//                        the image's edges) into a second buffer while the
//                        current chunk computes: the counterpart of
//                        make_async_copy with two semaphores.
//   X3 conv_tile2d       `_k_t4` (make_t4_fn): one block per th x tw output tile
//                        with its halo, no loop inside the block; the grid
//                        (B x H/th x W/tw blocks) fills the 132 SMs.
//   X2 conv_s2d          `_k_s2d` (make_s2d_fn): on the free space-to-depth view
//                        [B, H, W/2, 128] of x, a block per th x tg group tile
//                        with 128-wide output rows (two pixels), from
//                        pack_w_s2d (s2dc: a [th+2, tg, 384] patch, 3 products
//                        of K = 384) or pack_w_s2d9 (s2d9: 9 products of K = 128
//                        straight from the halo). Half of the packed weights are
//                        structural zeros, so s2d does 2x the useful FLOPs by
//                        construction (the tool's "1.5x" comment is wrong).
//
// Every block reads its halo from the unpadded x and writes zeros outside
// the image: the TPU needs `_fold_rows` / `_fold_groups` only because a
// BlockSpec cannot express overlapping windows, and on the card they would
// add a full read and write of x. Only the weights are packed, by the
// wrapper; the kernels read them through L1 from device memory (s2d's are
// 288 KB, more than a block's shared memory).
//
// What bounds them. At SuperPointNetGauss2's inc.conv1 (B = 8, 376 x 1240,
// 64 -> 64) the useful work is 2.750e11 FLOP, 0.278 ms at 989 TFLOP/s bf16,
// and x and y are 954.9 MB, 0.285 ms at 3.35 TB/s: the function is bound by
// bytes, just. s2d's own floor is 0.556 ms (2x the FLOPs). These kernels are
// the simple first version: legacy mma.sync through wmma (not wgmma), B
// fragments from L1, A fragments from unpadded shared rows (bank
// conflicts), one 16-pixel M tile a warp at a time and an epilogue through
// a 1 KB shared scratch per warp. What they are for is the measured
// comparison of the formulations' staging on Hopper; wgmma, TMA and a
// persistent, warp-specialised pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int C = 64;                    // channels in and out
constexpr int PIECES = C * 2 / 16;       // 16-byte pieces of one pixel's channels
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int EPI_FLOATS = 16 * 16;      // epilogue scratch per warp
constexpr long long SMEM_MAX = 232448;   // a block's shared memory on Hopper

// Formulation codes of the C interface (ops/conv_formulations.py).
constexpr int TAPS9 = 0, KY3 = 1, IM2COL = 2, S2DC = 3, S2D9 = 4;
constexpr int STRIP = 0, STRIP_ASYNC = 1, TILE2D = 2, S2D = 3;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline long long halo_bytes(int th, int tw) {
  return 2LL * (th + 2) * (tw + 2) * C;
}

__host__ __device__ inline long long patch_bytes(int kind, int th, int tw) {
  if (kind == KY3) return 2LL * th * (tw + 2) * 3 * C;
  if (kind == IM2COL) return 2LL * th * tw * 9 * C;
  if (kind == S2DC) return 2LL * (th + 2) * tw * 3 * 2 * C;
  return 0;
}

// Shared memory a block of `family` takes at tile th x tw (tw: groups for
// s2d), or -1 for a combination the kernels do not take.
long long smem_bytes(int family, int kind, int th, int tw) {
  if (th < 1 || tw < 16 || tw % 16 != 0) return -1;
  const long long epi = 4LL * WARPS * EPI_FLOATS;
  switch (family) {
    case STRIP:
      if (kind != TAPS9 && kind != KY3 && kind != IM2COL) return -1;
      return halo_bytes(th, tw) + patch_bytes(kind, th, tw) + epi;
    case STRIP_ASYNC:
    case TILE2D:
      if (kind != KY3 && kind != IM2COL) return -1;
      return (family == STRIP_ASYNC ? 2 : 1) * halo_bytes(th, tw) + patch_bytes(kind, th, tw) + epi;
    case S2D:
      if (kind != S2DC && kind != S2D9) return -1;
      return 2 * halo_bytes(th, tw) + patch_bytes(kind, th, tw) + epi;
  }
  return -1;
}

__device__ __forceinline__ long long pixel(int b, int row, int col, int H, int W) {
  return (static_cast<long long>(b) * H + row) * W + col;
}

// The (th + 2) x (tw + 2) halo of output rows [r0, r0 + th) and columns
// [c0, c0 + tw) of image b: halo[(i (tw + 2) + j) C + ch] = x[b, r0-1+i,
// c0-1+j, ch], zero outside the image. Synchronous 16-byte loads.
__device__ void stage_halo(bf16* halo, const bf16* __restrict__ x, int b, int r0, int c0,
                           int th, int tw, int H, int W) {
  const int hc = tw + 2;
  const int n = (th + 2) * hc * PIECES;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int piece = idx % PIECES, p = idx / PIECES;
    const int row = r0 - 1 + p / hc, col = c0 - 1 + p % hc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0 && row < H && col >= 0 && col < W)
      v = *reinterpret_cast<const uint4*>(x + pixel(b, row, col, H, W) * C + piece * 8);
    reinterpret_cast<uint4*>(halo)[idx] = v;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// stage_halo's layout, copied by cp.async; the caller commits and waits.
__device__ void issue_halo(bf16* halo, const bf16* __restrict__ x, int b, int r0, int c0,
                           int th, int tw, int H, int W) {
  const int hc = tw + 2;
  const int n = (th + 2) * hc * PIECES;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int piece = idx % PIECES, p = idx / PIECES;
    const int row = r0 - 1 + p / hc, col = c0 - 1 + p % hc;
    const bool in = row >= 0 && row < H && col >= 0 && col < W;
    cp_async16(halo + idx * 8, in ? x + pixel(b, row, col, H, W) * C + piece * 8 : x, in);
  }
}

// ky3: patch[(r (tw+2) + c) 3C + ky C + ch] = halo[((r+ky) (tw+2) + c) C + ch].
// im2col: patch[(r tw + c) 9C + (3 ky + kx) C + ch] = halo[((r+ky) (tw+2) + c+kx) C + ch].
template <int KIND>
__device__ void build_patch(const bf16* halo, bf16* patch, int th, int tw) {
  const int hc = tw + 2;
  const uint4* src = reinterpret_cast<const uint4*>(halo);
  uint4* dst = reinterpret_cast<uint4*>(patch);
  if (KIND == KY3) {
    const int n = th * hc * 3 * PIECES;
    for (int idx = threadIdx.x; idx < n; idx += THREADS) {
      const int piece = idx % PIECES, q = idx / PIECES;
      const int ky = q % 3, pc = q / 3;
      dst[idx] = src[(pc + ky * hc) * PIECES + piece];
    }
  } else if (KIND == IM2COL) {
    const int n = th * tw * 9 * PIECES;
    for (int idx = threadIdx.x; idx < n; idx += THREADS) {
      const int piece = idx % PIECES, q = idx / PIECES;
      const int tap = q % 9, m = q / 9;
      const int r = m / tw, c = m % tw;
      dst[idx] = src[((r + tap / 3) * hc + c + tap % 3) * PIECES + piece];
    }
  }
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Epilogue of one warp's 16-row M tile: NF accumulator fragments of 16
// columns, through the warp's 16 x 16 float scratch. Row i of the tile goes
// to dst + i * row_stride; column col takes s and t of channel col % C.
// Rows at or past `valid` are not written.
template <int NF>
__device__ void store_tile(FragC (&acc)[NF], float* scratch, const float* __restrict__ s,
                           const float* __restrict__ t, bf16* dst, int row_stride, int valid) {
  const int lane = threadIdx.x & 31;
  const int i = lane >> 1, half = lane & 1;
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    wmma::store_matrix_sync(scratch, acc[n], 16, wmma::mem_row_major);
    __syncwarp();
    if (i < valid) {
      const int col = n * 16 + half * 8;
      const float* v = scratch + i * 16 + half * 8;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ch = (col + e) % C;
        f[e] = fmaxf(__fadd_rn(__fmul_rn(v[e], s[ch]), t[ch]), 0.f);
      }
      const uint4 out = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                                   pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(i) * row_stride + col) = out;
    }
    __syncwarp();
  }
}

// The products and epilogue of one staged chunk: output rows [r0, r0 + th)
// and columns [cb, cb + tw) of image b, from the halo (taps9) or the patch
// (ky3, im2col). A warp takes one 16-pixel row segment x 64 channels at a
// time; segments wholly outside the image are skipped.
template <int KIND>
__device__ void compute_chunk(const bf16* halo, const bf16* patch, const bf16* __restrict__ w,
                              const float* __restrict__ s, const float* __restrict__ t,
                              bf16* __restrict__ y, float* scratch, int b, int r0, int cb,
                              int th, int tw, int H, int W) {
  const int warp = threadIdx.x >> 5;
  const int hc = tw + 2, segs = tw / 16;
  for (int mt = warp; mt < th * segs; mt += WARPS) {
    const int r = mt / segs, c0 = (mt % segs) * 16;
    if (r0 + r >= H || cb + c0 >= W) continue;
    FragC acc[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
    FragA a;
    FragB bw;
    if (KIND == TAPS9) {
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const bf16* ap = halo + ((r + ky) * hc + c0 + kx) * C;
        const bf16* bp = w + tap * C * C;
#pragma unroll
        for (int k0 = 0; k0 < C; k0 += 16) {
          wmma::load_matrix_sync(a, ap + k0, C);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            wmma::load_matrix_sync(bw, bp + k0 * C + n * 16, C);
            wmma::mma_sync(acc[n], a, bw, acc[n]);
          }
        }
      }
    } else if (KIND == KY3) {
      for (int kx = 0; kx < 3; ++kx) {
        const bf16* ap = patch + (r * hc + c0 + kx) * (3 * C);
        const bf16* bp = w + kx * 3 * C * C;
#pragma unroll 4
        for (int k0 = 0; k0 < 3 * C; k0 += 16) {
          wmma::load_matrix_sync(a, ap + k0, 3 * C);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            wmma::load_matrix_sync(bw, bp + k0 * C + n * 16, C);
            wmma::mma_sync(acc[n], a, bw, acc[n]);
          }
        }
      }
    } else {
      const bf16* ap = patch + (r * tw + c0) * (9 * C);
#pragma unroll 4
      for (int k0 = 0; k0 < 9 * C; k0 += 16) {
        wmma::load_matrix_sync(a, ap + k0, 9 * C);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::load_matrix_sync(bw, w + k0 * C + n * 16, C);
          wmma::mma_sync(acc[n], a, bw, acc[n]);
        }
      }
    }
    const int valid = min(16, W - (cb + c0));
    store_tile<4>(acc, scratch, s, t, y + pixel(b, r0 + r, cb + c0, H, W) * C, C, valid);
  }
}

// X4: grid (ceil(H / th), B); the block walks its strip tw columns at a time.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
    conv_strip_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ s, const float* __restrict__ t,
                      bf16* __restrict__ y, int H, int W, int th, int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* patch = reinterpret_cast<bf16*>(smem + halo_bytes(th, tw));
  float* scratch = reinterpret_cast<float*>(smem + halo_bytes(th, tw) +
                                            patch_bytes(KIND, th, tw)) +
                   (threadIdx.x >> 5) * EPI_FLOATS;
  const int b = blockIdx.y, r0 = blockIdx.x * th;
  for (int cb = 0; cb < W; cb += tw) {
    stage_halo(halo, x, b, r0, cb, th, tw, H, W);
    __syncthreads();
    if (KIND != TAPS9) {
      build_patch<KIND>(halo, patch, th, tw);
      __syncthreads();
    }
    compute_chunk<KIND>(halo, patch, w, s, t, y, scratch, b, r0, cb, th, tw, H, W);
    __syncthreads();
  }
}

// X1: X4's ky3 and im2col with the next chunk's halo in flight (cp.async
// into the other buffer) while the current chunk builds its patch and
// computes. A buffer is refilled only after the barrier that follows the
// patch build which last read it.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
    conv_strip_async_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                            const float* __restrict__ s, const float* __restrict__ t,
                            bf16* __restrict__ y, int H, int W, int th, int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long hb = halo_bytes(th, tw);
  bf16* halos[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + hb)};
  bf16* patch = reinterpret_cast<bf16*>(smem + 2 * hb);
  float* scratch = reinterpret_cast<float*>(smem + 2 * hb + patch_bytes(KIND, th, tw)) +
                   (threadIdx.x >> 5) * EPI_FLOATS;
  const int b = blockIdx.y, r0 = blockIdx.x * th;
  const int chunks = (W + tw - 1) / tw;
  issue_halo(halos[0], x, b, r0, 0, th, tw, H, W);
  cp_async_commit();
  for (int j = 0; j < chunks; ++j) {
    if (j + 1 < chunks) {
      issue_halo(halos[(j + 1) & 1], x, b, r0, (j + 1) * tw, th, tw, H, W);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    build_patch<KIND>(halos[j & 1], patch, th, tw);
    __syncthreads();
    compute_chunk<KIND>(halos[j & 1], patch, w, s, t, y, scratch, b, r0, j * tw, th, tw, H, W);
  }
}

// X3: grid (ceil(W / tw), ceil(H / th), B), one output tile a block.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
    conv_tile2d_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ s, const float* __restrict__ t,
                       bf16* __restrict__ y, int H, int W, int th, int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* patch = reinterpret_cast<bf16*>(smem + halo_bytes(th, tw));
  float* scratch = reinterpret_cast<float*>(smem + halo_bytes(th, tw) +
                                            patch_bytes(KIND, th, tw)) +
                   (threadIdx.x >> 5) * EPI_FLOATS;
  const int cb = blockIdx.x * tw, r0 = blockIdx.y * th, b = blockIdx.z;
  stage_halo(halo, x, b, r0, cb, th, tw, H, W);
  __syncthreads();
  build_patch<KIND>(halo, patch, th, tw);
  __syncthreads();
  compute_chunk<KIND>(halo, patch, w, s, t, y, scratch, b, r0, cb, th, tw, H, W);
}

// X2: grid (ceil(G / tg), ceil(H / th), B) over the groups G = W / 2 of the
// view [B, H, G, 128]. The halo holds (th + 2) x (tg + 2) groups (one group,
// two pixels, of zeros or neighbours on each side); s2dc also stages the
// patch p[(r tg + g) 384 + k 128 + ch] = halo[(r (tg+2) + g + k) 128 + ch]
// for r in [0, th + 2). w is pack_w_s2d's [3, 384, 128], whose memory is
// pack_w_s2d9's [3, 3, 128, 128] as well.
template <bool CONCAT>
__global__ void __launch_bounds__(THREADS)
    conv_s2d_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ s, const float* __restrict__ t,
                    bf16* __restrict__ y, int H, int W, int th, int tg) {
  constexpr int CL = 2 * C, GP = 2 * PIECES;  // a group's channels and 16-byte pieces
  extern __shared__ __align__(128) unsigned char smem[];
  const long long hb = 2 * halo_bytes(th, tg);
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* patch = reinterpret_cast<bf16*>(smem + hb);
  float* scratch = reinterpret_cast<float*>(smem + hb + patch_bytes(CONCAT ? S2DC : S2D9, th, tg)) +
                   (threadIdx.x >> 5) * EPI_FLOATS;
  const int G = W / 2, hc = tg + 2;
  const int g0 = blockIdx.x * tg, r0 = blockIdx.y * th, b = blockIdx.z;
  const int n = (th + 2) * hc * GP;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int piece = idx % GP, p = idx / GP;
    const int row = r0 - 1 + p / hc, g = g0 - 1 + p % hc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0 && row < H && g >= 0 && g < G)
      v = *reinterpret_cast<const uint4*>(x + pixel(b, row, 2 * g, H, W) * C + piece * 8);
    reinterpret_cast<uint4*>(halo)[idx] = v;
  }
  __syncthreads();
  if (CONCAT) {
    const uint4* src = reinterpret_cast<const uint4*>(halo);
    uint4* dst = reinterpret_cast<uint4*>(patch);
    const int m = (th + 2) * tg * 3 * GP;
    for (int idx = threadIdx.x; idx < m; idx += THREADS) {
      const int piece = idx % GP, q = idx / GP;
      const int k = q % 3, pg = q / 3;
      dst[idx] = src[(pg + 2 * (pg / tg) + k) * GP + piece];
    }
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, segs = tg / 16;
  for (int mt = warp; mt < th * segs; mt += WARPS) {
    const int r = mt / segs, gl = (mt % segs) * 16;
    if (r0 + r >= H || g0 + gl >= G) continue;
    FragC acc[8];
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) wmma::fill_fragment(acc[nf], 0.f);
    FragA a;
    FragB bw;
    for (int ky = 0; ky < 3; ++ky) {
      if (CONCAT) {
        const bf16* ap = patch + ((r + ky) * tg + gl) * (3 * CL);
        const bf16* bp = w + ky * 3 * CL * CL;
#pragma unroll 2
        for (int k0 = 0; k0 < 3 * CL; k0 += 16) {
          wmma::load_matrix_sync(a, ap + k0, 3 * CL);
#pragma unroll
          for (int nf = 0; nf < 8; ++nf) {
            wmma::load_matrix_sync(bw, bp + k0 * CL + nf * 16, CL);
            wmma::mma_sync(acc[nf], a, bw, acc[nf]);
          }
        }
      } else {
        for (int k = 0; k < 3; ++k) {
          const bf16* ap = halo + ((r + ky) * hc + gl + k) * CL;
          const bf16* bp = w + (ky * 3 + k) * CL * CL;
#pragma unroll 2
          for (int k0 = 0; k0 < CL; k0 += 16) {
            wmma::load_matrix_sync(a, ap + k0, CL);
#pragma unroll
            for (int nf = 0; nf < 8; ++nf) {
              wmma::load_matrix_sync(bw, bp + k0 * CL + nf * 16, CL);
              wmma::mma_sync(acc[nf], a, bw, acc[nf]);
            }
          }
        }
      }
    }
    const int valid = min(16, G - (g0 + gl));
    store_tile<8>(acc, scratch, s, t, y + pixel(b, r0 + r, 2 * (g0 + gl), H, W) * C, CL, valid);
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, long long smem, void* stream, const void* x, const void* w,
           const float* s, const float* t, void* y, int H, int W, int th, int tw) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), s, t, static_cast<bf16*>(y), H,
      W, th, tw);
  return static_cast<int>(cudaGetLastError());
}

bool shapes_ok(int B, int H, int W) { return B >= 1 && B <= 65535 && H >= 1 && W >= 1; }

}  // namespace

// Shared memory of one block: family 0 conv_strip, 1 conv_strip_async,
// 2 conv_tile2d, 3 conv_s2d; kind 0 taps9, 1 ky3, 2 im2col, 3 s2dc, 4 s2d9;
// tw in pixels (groups for s2d). -1 for a combination no kernel takes.
extern "C" long long conv_formulations_smem_bytes(int family, int kind, int th, int tw) {
  return smem_bytes(family, kind, th, tw);
}

// X4. x [B, H, W, 64] bf16; w bf16 packed for `kind` (taps9 [3, 3, 64, 64],
// ky3 [3, 192, 64], im2col [576, 64]); s, t [64] float32; y [B, H, W, 64]
// bf16. Launches on `stream`; returns the launch's cudaError, else 0.
extern "C" int conv_strip_bf16(const void* x, const void* w, const float* s, const float* t,
                               void* y, int B, int H, int W, int kind, int th, int tw,
                               void* stream) {
  const long long smem = smem_bytes(STRIP, kind, th, tw);
  if (!shapes_ok(B, H, W) || smem < 0 || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H + th - 1) / th, B);
  if (kind == TAPS9)
    return launch(conv_strip_kernel<TAPS9>, grid, smem, stream, x, w, s, t, y, H, W, th, tw);
  if (kind == KY3)
    return launch(conv_strip_kernel<KY3>, grid, smem, stream, x, w, s, t, y, H, W, th, tw);
  return launch(conv_strip_kernel<IM2COL>, grid, smem, stream, x, w, s, t, y, H, W, th, tw);
}

// X1. As conv_strip_bf16, kind ky3 or im2col.
extern "C" int conv_strip_async_bf16(const void* x, const void* w, const float* s,
                                     const float* t, void* y, int B, int H, int W, int kind,
                                     int th, int tw, void* stream) {
  const long long smem = smem_bytes(STRIP_ASYNC, kind, th, tw);
  if (!shapes_ok(B, H, W) || smem < 0 || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H + th - 1) / th, B);
  if (kind == KY3)
    return launch(conv_strip_async_kernel<KY3>, grid, smem, stream, x, w, s, t, y, H, W, th,
                  tw);
  return launch(conv_strip_async_kernel<IM2COL>, grid, smem, stream, x, w, s, t, y, H, W, th,
                tw);
}

// X3. As conv_strip_bf16, kind ky3 or im2col.
extern "C" int conv_tile2d_bf16(const void* x, const void* w, const float* s, const float* t,
                                void* y, int B, int H, int W, int kind, int th, int tw,
                                void* stream) {
  const long long smem = smem_bytes(TILE2D, kind, th, tw);
  if (!shapes_ok(B, H, W) || smem < 0 || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  if (kind == KY3)
    return launch(conv_tile2d_kernel<KY3>, grid, smem, stream, x, w, s, t, y, H, W, th, tw);
  return launch(conv_tile2d_kernel<IM2COL>, grid, smem, stream, x, w, s, t, y, H, W, th, tw);
}

// X2. W even; w bf16 pack_w_s2d [3, 384, 128] (s2dc) or pack_w_s2d9
// [3, 3, 128, 128] (s2d9); tg groups of two pixels a tile.
extern "C" int conv_s2d_bf16(const void* x, const void* w, const float* s, const float* t,
                             void* y, int B, int H, int W, int kind, int th, int tg,
                             void* stream) {
  const long long smem = smem_bytes(S2D, kind, th, tg);
  if (!shapes_ok(B, H, W) || W % 2 != 0 || smem < 0 || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W / 2 + tg - 1) / tg, (H + th - 1) / th, B);
  if (kind == S2DC)
    return launch(conv_s2d_kernel<true>, grid, smem, stream, x, w, s, t, y, H, W, th, tg);
  return launch(conv_s2d_kernel<false>, grid, smem, stream, x, w, s, t, y, H, W, th, tg);
}
