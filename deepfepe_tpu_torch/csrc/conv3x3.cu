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
// conv bias. The wrapper and the plain versions are in ops/conv.py.
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
// 64 -> 64 full-resolution conv is 2 x 3.73 M x 9 x 64 x 64 = 275 GFLOP
// against 1.9 GB of input and output (0.57 ms at 3.35 TB/s): bound by
// operations, 4.1 ms at the card's 67 TFLOP/s FP32 rate. Its backward does
// that twice (dx and dw). The image-input conv (Cin = 1, C = 64) does 4.3
// GFLOP and moves 955 MB forward and 1.9 GB backward: bound by bytes.
//
// Arithmetic: three-pass TF32 on the tensor cores. Each float32 operand v
// is split into hi, v rounded to TF32 to nearest (cvt.rna.tf32.f32's bits),
// and lo = v - hi, and a product is taken as lo_a hi_b + hi_a lo_b + hi_a
// hi_b by mma.sync.m16n8k8.f32.tf32.tf32.f32; only lo_a lo_b (about 2^-22
// relative) is dropped, where one TF32 pass keeps about 11 bits. Three
// passes at the dense TF32 rate (495 TFLOP/s) take 1.67 ms at inc.conv1,
// under the FP32 FFMA time. The tensor cores' float32 accumulation drops
// bits below its sum's last place (a build without the fold below measured
// several times K5's error against the plain version), so each block sums a
// short run of products (one input-channel chunk, or one 128-pixel tile) in
// a fresh accumulator and adds it to a float32 register total with an
// ordinary rounded add. The three passes of a fragment go to one accumulator, so each
// pass runs over a group of fragments before the next (16 MMAs, or 6 in the
// weight gradient, between two on one accumulator).
//
// Forward and dx (`conv3x3_mma_kernel`). An implicit GEMM: M = output
// pixels, N = output channels, K = 9 x Cin. A block of 8 warps owns a 16 x
// 16 tile of one image's output pixels by 64 output channels; a warp owns
// two tile rows (two m16 fragments) by the 64 channels (eight n8
// fragments). Cin is walked in chunks of 8 through a ring of two stages: the
// (16 + 2) x (16 + 2) halo tile of x and the chunk's 9 x 8 x 64 weights come
// in by 16-byte cp.async (zero-filled outside the image: SAME padding
// without branches; 4-byte copies when Cin or C is not a multiple of 4)
// while the previous chunk's MMAs run. Each thread splits the weights it
// copied into hi and lo in shared memory once a chunk. Halo rows are padded
// to 12 floats, the forward's weight rows to 72 and dx's weights swizzled,
// so the A and B fragment loads of every tap are free of bank conflicts. The
// epilogue applies the affine and ReLU to the fragments and pairs lanes by a
// shuffle for 16-byte stores. dx is the same GEMM over dz with the flipped,
// transposed kernel w[2-ky, 2-kx, c, ci] (template flag DGRAD): dy and y
// come in by cp.async and each thread forms dz = dy * (y > 0) * scale on the
// elements it copied, once a chunk.
//
// Weight gradient, Cin >= 2 (`conv3x3_wgrad_mma_kernel`): M = 9 taps x 32
// input channels, N = 64 output channels, K = pixels. The pixels are split
// into G groups of 4 x 32-pixel tiles; a block owns one group, one slice of
// 32 input channels and 64 output channels, and stages each tile's dy and
// y (dz formed on arrival, once for all nine taps) and the x halo through a
// two-stage cp.async ring. Each warp holds 9 taps x 16 input x 16 output
// channels of dw and runs each pass over a kernel row's three taps.
// Blocks of the first input-channel slice also sum dscale and dbias. Cin = 1
// (`conv3x3_wgrad_cin1_kernel`) is bound by bytes: a warp reads a pixel's dy
// and y for 64 channels once, in 8-byte loads, the one-channel x halo from
// shared memory, and sums all 9 taps and the affine gradients in FP32
// registers, four blocks an SM. Both write partial sums per group to a
// scratch buffer the wrapper allocates, and `sum_groups_kernel` adds the G
// partials in a fixed order: no atomics, the same result every run.
//
// Cin = 1 forward and dx keep their own FP32 kernels (a thread per pixel and
// 4 channels, 16-byte stores; dx a per-pixel sum over 9 taps x C). The TPU
// kernels' row folding and tile-height rule (`_fold_rows`, `_pick_th`) exist
// for VMEM and Mosaic and are not carried over. wgmma and TMA are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float SAFE_EPS = 1e-8f;
constexpr unsigned FULL = 0xffffffffu;

// Forward and dx.
constexpr int TH = 16;               // output rows per block (two a warp)
constexpr int TW = 16;               // output columns per block (one m16 fragment)
constexpr int CT = 64;               // output channels per block, all of them a warp's
constexpr int NJ = CT / 8;           // n8 fragments a warp
constexpr int CK = 8;                // input channels a chunk (one k8 step a tap)
constexpr int HC = TW + 2;           // halo columns
constexpr int HPIX = (TH + 2) * HC;  // halo pixels
constexpr int CKP = 12;              // halo pixel stride, floats: 12 g + t hits 32 banks
// Weights of a chunk: the forward's as [tap][k][NP] (rows padded to 72
// floats), dx's as [tap][n][k ^ 4 ((n >> 2) & 1)] (unpadded, swizzled). Both
// put the 32 lanes' B fragment loads on 32 banks, keep every 16-byte piece
// whole, and give each lane a fixed offset plus a constant per fragment.
constexpr int NP = 72;
constexpr int A_STAGE = HPIX * CKP;
constexpr int B_ITEMS = 9 * CK * CT / 4;  // 16-byte pieces of a chunk's weights

// Weight gradient, Cin >= 2.
constexpr int WTH = 4;               // tile rows
constexpr int WTW = 32;              // tile columns
constexpr int WTP = WTH * WTW;       // pixels a tile: 16 k8 steps
constexpr int WHC = WTW + 2;
constexpr int WHPIX = (WTH + 2) * WHC;
constexpr int KS = 32;               // input channels a block
constexpr int XKP = 40;              // halo pixel stride: 40 t + g hits 32 banks
constexpr int DZP = 72;              // dz pixel stride: 72 t + g hits 32 banks
constexpr int WX = WHPIX * XKP;      // the x halo
constexpr int W_STAGE = WX + 2 * WTP * DZP;

// Cin = 1.
constexpr int C1_MAX = 256;          // widest C of the Cin = 1 kernels
constexpr int C1TH = 2;              // weight-gradient tile rows
constexpr int C1TW = 128;            // weight-gradient tile columns
constexpr int C1_WARPS = THREADS / 32;

constexpr int WAVES_BLOCKS = 132 * 4;  // weight-gradient blocks to aim for

__device__ __forceinline__ float safe_scale(float s) { return fabsf(s) < SAFE_EPS ? 1.0f : s; }

// a / b from r = 1 / b: the quotient a r refined by one FMA step, within a
// rounding of IEEE a / b, without the division's call into its slow path
// (which costs the per-pixel loops a stack frame and spills).
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

// hi: v rounded to TF32, to nearest with ties away from zero (the bits of
// cvt.rna.tf32.f32, in two integer operations, which measured faster than
// the cvt); lo: the rest, v - hi, exact in float32, of which the MMA reads
// the top 19 bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a b for one m16n8k8 TF32 fragment triple.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes (or 4) from global to shared memory; zero-filled when !valid,
// and then `src` is only a placeholder address.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Four consecutive floats [src, src + 4) into shared memory: one 16-byte
// copy with VEC = 4 (then `valid_n` is 0 or 4), else four 4-byte copies with
// the first `valid_n` real.
template <int VEC>
__device__ __forceinline__ void copy4(float* dst, const float* src, int valid_n,
                                      const float* base) {
  if (VEC == 4) {
    cp_async<16>(dst, valid_n > 0 ? src : base, valid_n > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async<4>(dst + e, e < valid_n ? src + e : base, e < valid_n);
  }
}

// Splits the 4 floats at `hi` into their TF32 hi (in place) and lo parts.
__device__ __forceinline__ void split4(float* hi, float* lo) {
  const float4 v = *reinterpret_cast<const float4*>(hi);
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Floats of a stage's weights.
template <bool DGRAD>
__host__ __device__ constexpr int b_stage() {
  return DGRAD ? 9 * CT * CK : 9 * CK * NP;
}

// Offset of weight (k, n) of tap `tap` in a stage.
template <bool DGRAD>
__device__ __forceinline__ int b_index(int tap, int k, int n) {
  return DGRAD ? (tap * CT + n) * CK + (k ^ (4 * ((n >> 2) & 1))) : (tap * CK + k) * NP + n;
}

// Piece i (of B_ITEMS) of a chunk's weights: its tap, first k and first n
// (four n from w[tap][k][n] for the forward, four k from w[8 - tap][n][k]
// for dx).
template <bool DGRAD>
__device__ __forceinline__ void b_piece(int i, int& tap, int& k, int& n) {
  if (DGRAD) {
    k = 4 * (i % (CK / 4));
    n = (i / (CK / 4)) % CT;
    tap = i / (CK / 4 * CT);
  } else {
    n = 4 * (i % (CT / 4));
    k = (i / (CT / 4)) % CK;
    tap = i / (CT / 4 * CK);
  }
}

// out[b, i, j, n] = sum_{tap, k} in[b, i+ty-1, j+tx-1, k] * wt(tap, k, n), in
// [B, H, W, K] and out [B, H, W, N].
// DGRAD = false, K5: in = x, wt(tap, k, n) = w[tap][k][n], out = relu(acc *
//   scale[n] + bias[n]).
// DGRAD = true, K5b's dx: in = dz = dy * (ymask > 0) * scale[k] (formed as
//   the halo tile arrives), wt(tap, k, n) = w[8 - tap][n][k] for w of the
//   forward [3, 3, N, K], out = acc.
// VEC = 4 takes K and N multiples of 4 (16-byte copies), VEC = 1 any.
template <bool DGRAD, int VEC>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_mma_kernel(const float* __restrict__ in, const float* __restrict__ ymask,
                   const float* __restrict__ w, const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out, int H, int W, int K,
                   int N, int n_blocks) {
  constexpr int B_STAGE = b_stage<DGRAD>();
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                                  // [2][HPIX][CKP]: x, or dz
  float* sbh = sa + 2 * A_STAGE;                     // [2][B_STAGE] weights: raw, then hi
  float* sbl = sbh + 2 * B_STAGE;                    // the same, lo
  float* sy = sbl + 2 * B_STAGE;                     // DGRAD: [2][HPIX][CKP] y
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int b = blockIdx.z / n_blocks;
  const int c0 = (blockIdx.z % n_blocks) * CT;
  const int row0 = blockIdx.y * TH;
  const int col0 = blockIdx.x * TW;
  const size_t img = static_cast<size_t>(b) * H * W * K;
  const int n_chunks = (K + CK - 1) / CK;

  // Chunk k0 into stage s: the halo (pixel quads i = tid + THREADS r,
  // always the same quad of channels) and the weights.
  auto load = [&](int s, int k0) {
    for (int i = tid; i < HPIX * (CK / 4); i += THREADS) {
      const int q = i % (CK / 4);
      const int pix = i / (CK / 4);
      const int gy = row0 + pix / HC - 1;
      const int gx = col0 + pix % HC - 1;
      const int gc = k0 + 4 * q;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int valid_n = inside ? min(4, max(0, K - gc)) : 0;
      const size_t at = img + (static_cast<size_t>(gy) * W + gx) * K + gc;
      copy4<VEC>(sa + s * A_STAGE + pix * CKP + 4 * q, in + at, valid_n, in);
      if (DGRAD) copy4<VEC>(sy + s * A_STAGE + pix * CKP + 4 * q, ymask + at, valid_n, ymask);
    }
    for (int i = tid; i < B_ITEMS; i += THREADS) {
      int tap, kk, n;
      b_piece<DGRAD>(i, tap, kk, n);
      const int gk = k0 + kk;
      const int gn = c0 + n;
      const int valid_n = DGRAD ? (gn < N ? min(4, max(0, K - gk)) : 0)
                                : (gk < K ? min(4, max(0, N - gn)) : 0);
      const float* src = DGRAD ? w + (static_cast<size_t>(8 - tap) * N + gn) * K + gk
                               : w + (static_cast<size_t>(tap) * K + gk) * N + gn;
      copy4<VEC>(sbh + s * B_STAGE + b_index<DGRAD>(tap, kk, n), src, valid_n, w);
    }
  };
  // On the pieces this thread copied: the weights split into hi and lo, and
  // for DGRAD dz = dy * (y > 0) * scale.
  auto prepare = [&](int s, int k0) {
    for (int i = tid; i < B_ITEMS; i += THREADS) {
      int tap, kk, n;
      b_piece<DGRAD>(i, tap, kk, n);
      const int at = s * B_STAGE + b_index<DGRAD>(tap, kk, n);
      split4(sbh + at, sbl + at);
    }
    if (DGRAD) {
      for (int i = tid; i < HPIX * (CK / 4); i += THREADS) {
        const int q = i % (CK / 4);
        float* d = sa + s * A_STAGE + (i / (CK / 4)) * CKP + 4 * q;
        const float* yv = sy + s * A_STAGE + (i / (CK / 4)) * CKP + 4 * q;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gc = k0 + 4 * q + e;
          const float m = yv[e] > 0.0f ? 1.0f : 0.0f;
          d[e] = d[e] * m * (gc < K ? scale[gc] : 0.0f);
        }
      }
    }
  };

  float tot[2][NJ][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mi][j][e] = 0.0f;

  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c & 1;
    cp_async_wait_all();
    prepare(s, c * CK);
    __syncthreads();
    if (c + 1 < n_chunks) {
      load(s ^ 1, (c + 1) * CK);
      cp_async_commit();
    }
    float acc[2][NJ][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
    const float* sas = sa + s * A_STAGE;
    const float* sbhs = sbh + s * B_STAGE;
    const float* sbls = sbl + s * B_STAGE;
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {  // a kernel row at a time
      const int ky = tap / 3;
      const int kx = tap % 3;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A: rows = the m-tile's 16 pixels (columns g, g + 8), cols = k.
        const float* arow = sas + ((2 * warp + mi + ky) * HC + kx) * CKP;
        split(arow[g * CKP + t], ah[mi][0], al[mi][0]);
        split(arow[(g + 8) * CKP + t], ah[mi][1], al[mi][1]);
        split(arow[g * CKP + t + 4], ah[mi][2], al[mi][2]);
        split(arow[(g + 8) * CKP + t + 4], ah[mi][3], al[mi][3]);
      }
      // B: k = t and t + 4, n = 8 j + g.
      auto b_at = [&](int j, int k) { return b_index<DGRAD>(tap, k, 8 * j + g); };
      uint32_t bh[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        bh[j][0] = __float_as_uint(sbhs[b_at(j, t)]);
        bh[j][1] = __float_as_uint(sbhs[b_at(j, t + 4)]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma(acc[mi][j], al[mi], bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t bl0 = __float_as_uint(sbls[b_at(j, t)]);
        const uint32_t bl1 = __float_as_uint(sbls[b_at(j, t + 4)]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma(acc[mi][j], ah[mi], bl0, bl1);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma(acc[mi][j], ah[mi], bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[mi][j][e] += acc[mi][j][e];
  }

  // Epilogue. Fragment element e of (mi, j): pixel column g (e < 2) or g + 8,
  // channel 8 j + 2 t + e % 2. Lanes t and t ^ 1 trade halves so that an
  // even t holds channels [8 j + 2 t, + 4) of pixel g and an odd t those
  // [8 j + 2 t - 2, + 4) of pixel g + 8.
  const bool odd = t & 1;
  const int gx = col0 + g + (odd ? 8 : 0);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int gy = row0 + 2 * warp + mi;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = tot[mi][j][e];
        if (!DGRAD) {
          const int co = c0 + 8 * j + 2 * t + e % 2;
          v[e] = co < N ? fmaxf(v[e] * scale[co] + bias[co], 0.0f) : 0.0f;
        }
      }
      const float send0 = odd ? v[0] : v[2];
      const float send1 = odd ? v[1] : v[3];
      const float got0 = __shfl_xor_sync(FULL, send0, 1);
      const float got1 = __shfl_xor_sync(FULL, send1, 1);
      const float4 o = odd ? make_float4(got0, got1, v[2], v[3])
                           : make_float4(v[0], v[1], got0, got1);
      const int co = c0 + 8 * j + 2 * t - (odd ? 2 : 0);
      if (gy >= H || gx >= W || co >= N) continue;
      float* dst = out + ((static_cast<size_t>(b) * H + gy) * W + gx) * N + co;
      if (VEC == 4 && co + 3 < N) {
        *reinterpret_cast<float4*>(dst) = o;
      } else {
        const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (co + e < N) dst[e] = ov[e];
      }
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
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int co = min(4 * q + k, C - 1);
      float a = 0.0f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) a = fmaf(v[tap], ws[tap * C + co], a);
      o[k] = fmaxf(a * ss[co] + ts[co], 0.0f);
    }
    float* dst = y + p * C + 4 * q;
    if (C % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      for (int k = 0; k < 4 && 4 * q + k < C; ++k) dst[k] = o[k];
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

// Tile t of a row-major [B, tiles_y, tiles_x] grid of th x tw tiles.
struct Tile {
  int b, row0, col0;
};

__device__ __forceinline__ Tile tile_at(long long t, int tiles_y, int tiles_x, int th, int tw) {
  const long long per_image = static_cast<long long>(tiles_y) * tiles_x;
  const int r = static_cast<int>(t % per_image);
  return {static_cast<int>(t / per_image), (r / tiles_x) * th, (r % tiles_x) * tw};
}

// K5b's dw (and, in the first input-channel slice, dscale and dbias) for Cin
// >= 2: the partial sums of pixel group g = blockIdx.y. blockIdx.x = kb +
// k_blocks nb: input channels [KS kb, + KS), output channels [CT nb, + CT).
// part[g] is [9 Cin C] dw, then [C] dscale, then [C] dbias; every entry is
// written by exactly one block. VEC = 4 takes Cin and C multiples of 4.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgrad_mma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                         const float* __restrict__ y, const float* __restrict__ scale,
                         const float* __restrict__ bias, float* __restrict__ part, int H, int W,
                         int Cin, int C, int k_blocks, int tiles_y, int tiles_x,
                         long long n_tiles, int G) {
  extern __shared__ __align__(16) float smem[];
  // Stage s: x halo [WHPIX][XKP], dz (dy on arrival) [WTP][DZP], y [WTP][DZP].
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g8 = lane / 4;
  const int t = lane % 4;
  const int mw = warp % 2;   // input channels 16 mw + 0..15 of the slice
  const int nw = warp / 2;   // output channels 16 nw + 0..15 of the block
  const int k0 = (blockIdx.x % k_blocks) * KS;
  const int c0 = (blockIdx.x / k_blocks) * CT;
  const bool affine = k0 == 0;
  const int g = blockIdx.y;
  const long long t_begin = n_tiles * g / G;
  const long long t_end = n_tiles * (g + 1) / G;
  const int n_here = static_cast<int>(t_end - t_begin);

  // The loader's output-channel quad is fixed: THREADS is a multiple of 16.
  const int lq = tid % 16;
  float s_l[4], ss_l[4], r_l[4], t_l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int co = c0 + 4 * lq + e;
    s_l[e] = co < C ? scale[co] : 0.0f;
    ss_l[e] = safe_scale(s_l[e]);
    r_l[e] = 1.0f / ss_l[e];
    t_l[e] = co < C ? bias[co] : 0.0f;
  }
  float sum_m[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sum_mz[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  auto load = [&](int s, long long tile) {
    const Tile tl = tile_at(tile, tiles_y, tiles_x, WTH, WTW);
    float* sx = smem + s * W_STAGE;
    float* sd = sx + WX;
    float* sy = sd + WTP * DZP;
    const size_t img = static_cast<size_t>(tl.b) * H * W;
    for (int i = tid; i < WHPIX * (KS / 4); i += THREADS) {
      const int q = i % (KS / 4);
      const int pix = i / (KS / 4);
      const int gy = tl.row0 + pix / WHC - 1;
      const int gx = tl.col0 + pix % WHC - 1;
      const int gc = k0 + 4 * q;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int valid_n = inside ? min(4, max(0, Cin - gc)) : 0;
      copy4<VEC>(sx + pix * XKP + 4 * q,
                 x + (img + static_cast<size_t>(gy) * W + gx) * Cin + gc, valid_n, x);
    }
    for (int i = tid; i < WTP * (CT / 4); i += THREADS) {
      const int p = i / (CT / 4);
      const int gy = tl.row0 + p / WTW;
      const int gx = tl.col0 + p % WTW;
      const int gc = c0 + 4 * lq;
      const int valid_n = gy < H && gx < W ? min(4, max(0, C - gc)) : 0;
      const size_t at = (img + static_cast<size_t>(gy) * W + gx) * C + gc;
      copy4<VEC>(sd + p * DZP + 4 * lq, dy + at, valid_n, dy);
      copy4<VEC>(sy + p * DZP + 4 * lq, y + at, valid_n, y);
    }
  };
  // dz = dy * (y > 0) * scale on the elements this thread copied, and the
  // affine sums over them.
  auto form_dz = [&](int s) {
    float* sd = smem + s * W_STAGE + WX;
    const float* sy = sd + WTP * DZP;
    for (int i = tid; i < WTP * (CT / 4); i += THREADS) {
      const int at = (i / (CT / 4)) * DZP + 4 * lq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float yv = sy[at + e];
        const float m = yv > 0.0f ? 1.0f : 0.0f;
        const float dz = sd[at + e] * m * s_l[e];
        sd[at + e] = dz;
        if (affine) {
          const float mm = div_by(dz, ss_l[e], r_l[e]);
          sum_m[e] += mm;
          sum_mz[e] += div_by(mm * (yv - t_l[e]), ss_l[e], r_l[e]);
        }
      }
    }
  };

  float tot[9][2][4];
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[a][j][e] = 0.0f;

  if (n_here > 0) {
    load(0, t_begin);
    cp_async_commit();
  }
  for (int it = 0; it < n_here; ++it) {
    const int s = it & 1;
    cp_async_wait_all();
    form_dz(s);
    __syncthreads();
    if (it + 1 < n_here) {
      load(s ^ 1, t_begin + it + 1);
      cp_async_commit();
    }
    const float* sx = smem + s * W_STAGE;
    const float* sd = sx + WX;
    float acc[9][2][4];
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.0f;
#pragma unroll 1
    for (int ks = 0; ks < WTP / 8; ++ks) {
      // k8 step: pixels p0 + 0..7, one tile row, 8 neighbouring columns.
      const int pr = ks / (WTW / 8);
      const int pc = (ks % (WTW / 8)) * 8;
      const int p0 = pr * WTW + pc;
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 16 * nw + 8 * j + g8;
        split(sd[(p0 + t) * DZP + n], bh[j][0], bl[j][0]);
        split(sd[(p0 + t + 4) * DZP + n], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // A of the kernel row's three taps: rows = input channels (g8, g8 +
        // 8), cols = the step's pixels (t, t + 4).
        uint32_t ah[3][4], al[3][4];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* xa = sx + ((pr + ky) * WHC + pc + kx) * XKP + 16 * mw + g8;
          split(xa[t * XKP], ah[kx][0], al[kx][0]);
          split(xa[t * XKP + 8], ah[kx][1], al[kx][1]);
          split(xa[(t + 4) * XKP], ah[kx][2], al[kx][2]);
          split(xa[(t + 4) * XKP + 8], ah[kx][3], al[kx][3]);
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma(acc[3 * ky + kx][j], al[kx], bh[j][0], bh[j][1]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma(acc[3 * ky + kx][j], ah[kx], bl[j][0], bl[j][1]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma(acc[3 * ky + kx][j], ah[kx], bh[j][0], bh[j][1]);
      }
    }
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[a][j][e] += acc[a][j][e];
  }

  const size_t E = static_cast<size_t>(9) * Cin * C + 2 * static_cast<size_t>(C);
  float* out = part + static_cast<size_t>(g) * E;
  // Fragment element e of (tap, j): input channel 16 mw + g8 (+ 8 for e >= 2),
  // output channel 16 nw + 8 j + 2 t + e % 2.
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = k0 + 16 * mw + g8 + (e >= 2 ? 8 : 0);
        const int co = c0 + 16 * nw + 8 * j + 2 * t + e % 2;
        if (ci < Cin && co < C) out[(static_cast<size_t>(a) * Cin + ci) * C + co] = tot[a][j][e];
      }
  if (affine) {
    // The 16 threads of each channel quad (tid / 16), added in that order.
    __syncthreads();  // every warp is done with the stages: reuse them
    float* red = smem;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[tid * 4 + e] = sum_mz[e];
      red[(THREADS + tid) * 4 + e] = sum_m[e];
    }
    __syncthreads();
    if (tid < CT) {
      const int q = tid / 4;
      const int e = tid % 4;
      float ds = 0.0f, dt = 0.0f;
      for (int r = 0; r < THREADS / 16; ++r) {
        ds += red[(r * 16 + q) * 4 + e];
        dt += red[(THREADS + r * 16 + q) * 4 + e];
      }
      if (c0 + tid < C) {
        out[static_cast<size_t>(9) * Cin * C + c0 + tid] = ds;
        out[static_cast<size_t>(9) * Cin * C + C + c0 + tid] = dt;
      }
    }
  }
}

// K5b's dw, dscale and dbias for Cin = 1, partial sums of pixel group g =
// blockIdx.y over output channels [CT blockIdx.x, + CT). Lane l owns
// channels 2 l and 2 l + 1, warp w every C1_WARPS-th pixel of a C1TH x C1TW
// tile: it reads the pixel's dy and y once (a warp: 256 contiguous bytes
// each), the 9 neighbours' x from the tile's halo in shared memory, and sums
// 9 x 2 taps of dw and the affine terms in FP32. The warps' sums are added
// in warp order at the end.
__global__ void __launch_bounds__(THREADS, 4)
conv3x3_wgrad_cin1_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          const float* __restrict__ y, const float* __restrict__ scale,
                          const float* __restrict__ bias, float* __restrict__ part, int H,
                          int W, int C, int tiles_y, int tiles_x, long long n_tiles, int G) {
  constexpr int HW = C1TW + 2;
  constexpr int UNR = 4;
  constexpr int NSUM = 11;  // 9 taps, dscale, dbias
  __shared__ float xs[(C1TH + 2) * HW];
  __shared__ float red[C1_WARPS * NSUM * CT];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int c0 = blockIdx.x * CT;
  const int c = c0 + 2 * lane;
  const int g = blockIdx.y;
  const long long t_begin = n_tiles * g / G;
  const long long t_end = n_tiles * (g + 1) / G;
  const bool vec = C % 2 == 0 && c + 1 < C;
  float s_l[2], ss_l[2], r_l[2], t_l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    s_l[e] = c + e < C ? scale[c + e] : 0.0f;
    ss_l[e] = safe_scale(s_l[e]);
    r_l[e] = 1.0f / ss_l[e];
    t_l[e] = c + e < C ? bias[c + e] : 0.0f;
  }
  float acc[NSUM][2];  // taps 0..8, then dscale's and dbias's sums
#pragma unroll
  for (int a = 0; a < NSUM; ++a) acc[a][0] = acc[a][1] = 0.0f;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const Tile tl = tile_at(tile, tiles_y, tiles_x, C1TH, C1TW);
    const size_t img = static_cast<size_t>(tl.b) * H * W;
    __syncthreads();  // the last tile's halo is no longer read
    for (int i = tid; i < (C1TH + 2) * HW; i += THREADS) {
      const int gy = tl.row0 + i / HW - 1;
      const int gx = tl.col0 + i % HW - 1;
      xs[i] = gy >= 0 && gy < H && gx >= 0 && gx < W ? x[img + static_cast<size_t>(gy) * W + gx]
                                                      : 0.0f;
    }
    __syncthreads();
#pragma unroll 1
    for (int p0 = warp; p0 < C1TH * C1TW; p0 += C1_WARPS * UNR) {
      float dv[UNR][2], yv[UNR][2];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int p = p0 + C1_WARPS * u;
        const int gy = tl.row0 + p / C1TW;
        const int gx = tl.col0 + p % C1TW;
        const size_t at = (img + static_cast<size_t>(gy) * W + gx) * C + c;
        dv[u][0] = dv[u][1] = yv[u][0] = yv[u][1] = 0.0f;
        if (gy < H && gx < W) {
          if (vec) {
            const float2 a = __ldg(reinterpret_cast<const float2*>(dy + at));
            const float2 b = __ldg(reinterpret_cast<const float2*>(y + at));
            dv[u][0] = a.x, dv[u][1] = a.y, yv[u][0] = b.x, yv[u][1] = b.y;
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (c + e < C) dv[u][e] = __ldg(dy + at + e), yv[u][e] = __ldg(y + at + e);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int p = p0 + C1_WARPS * u;
        const float* xp = xs + (p / C1TW) * HW + p % C1TW;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = yv[u][e] > 0.0f ? 1.0f : 0.0f;
          const float dz = dv[u][e] * m * s_l[e];
          const float mm = div_by(dz, ss_l[e], r_l[e]);
          acc[9][e] += div_by(mm * (yv[u][e] - t_l[e]), ss_l[e], r_l[e]);
          acc[10][e] += mm;
#pragma unroll
          for (int a = 0; a < 9; ++a) acc[a][e] = fmaf(xp[(a / 3) * HW + a % 3], dz, acc[a][e]);
        }
      }
    }
  }
  // part[g]: dw [9][C] (Cin = 1), dscale [C], dbias [C]: entry a C + c.
  float* out = part + static_cast<size_t>(g) * NSUM * C;
#pragma unroll
  for (int a = 0; a < NSUM; ++a) {
    red[(warp * NSUM + a) * CT + 2 * lane] = acc[a][0];
    red[(warp * NSUM + a) * CT + 2 * lane + 1] = acc[a][1];
  }
  __syncthreads();
  for (int i = tid; i < NSUM * CT; i += THREADS) {
    const int a = i / CT;
    const int cc = i % CT;
    float s = 0.0f;
    for (int r = 0; r < C1_WARPS; ++r) s += red[(r * NSUM + a) * CT + cc];
    if (c0 + cc < C) out[static_cast<size_t>(a) * C + c0 + cc] = s;
  }
}

// out[e] = sum_{g < G} part[g E + e], in the order of g.
__global__ void __launch_bounds__(THREADS)
sum_groups_kernel(const float* __restrict__ part, float* __restrict__ out, int G, long long E) {
  for (long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; e < E;
       e += static_cast<long long>(gridDim.x) * THREADS) {
    float s = 0.0f;
#pragma unroll 8
    for (int g = 0; g < G; ++g) s += part[g * E + e];  // every group, in order
    out[e] = s;
  }
}

struct WgradPlan {
  int k_blocks, n_blocks, tiles_y, tiles_x, groups;
  long long n_tiles, entries;
};

WgradPlan wgrad_plan(int B, int H, int W, int Cin, int C) {
  WgradPlan p;
  const int th = Cin == 1 ? C1TH : WTH;
  const int tw = Cin == 1 ? C1TW : WTW;
  p.k_blocks = Cin == 1 ? 1 : (Cin + KS - 1) / KS;
  p.n_blocks = (C + CT - 1) / CT;
  p.tiles_y = (H + th - 1) / th;
  p.tiles_x = (W + tw - 1) / tw;
  p.n_tiles = static_cast<long long>(B) * p.tiles_y * p.tiles_x;
  long long groups = WAVES_BLOCKS / (p.k_blocks * p.n_blocks);
  if (groups < 1) groups = 1;
  if (groups > p.n_tiles) groups = p.n_tiles;
  p.groups = static_cast<int>(groups);
  p.entries = 9LL * Cin * C + 2LL * C;
  return p;
}

template <bool DGRAD>
constexpr size_t mma_smem_bytes() {
  return sizeof(float) * (2 * A_STAGE * (DGRAD ? 2 : 1) + 4 * b_stage<DGRAD>());
}
constexpr size_t WGRAD_SMEM_BYTES = sizeof(float) * 2 * W_STAGE;
static_assert(WGRAD_SMEM_BYTES >= sizeof(float) * 2 * THREADS * 4, "the affine sums' scratch");
static_assert(mma_smem_bytes<true>() <= 232448 && WGRAD_SMEM_BYTES <= 232448,
              "a block's shared memory");

// One conv3x3_mma_kernel launch: out [B, H, W, N] from in [B, H, W, K].
template <bool DGRAD>
cudaError_t launch_mma(const float* in, const float* ymask, const float* w, const float* scale,
                       const float* bias, float* out, int B, int H, int W, int K, int N,
                       cudaStream_t st) {
  const int n_blocks = (N + CT - 1) / CT;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_blocks);
  const size_t bytes = mma_smem_bytes<DGRAD>();
  const bool vec = K % 4 == 0 && N % 4 == 0;
  auto kernel = vec ? conv3x3_mma_kernel<DGRAD, 4> : conv3x3_mma_kernel<DGRAD, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, bytes, st>>>(in, ymask, w, scale, bias, out, H, W, K, N,
                                           n_blocks);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, Cin], w [3, 3, Cin, C], scale and bias [C], y [B, H, W, C]:
// float32, contiguous, on the device. Cin = 1 takes C <= 256. Launches on
// `stream` and returns the launch's error (cudaGetLastError()), else 0.
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
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(launch_mma<false>(x, nullptr, w, scale, bias, y, B, H, W, Cin, C, st));
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
  const dim3 wgrid(p.k_blocks * p.n_blocks, p.groups);
  cudaError_t err;
  if (Cin == 1) {
    conv3x3_wgrad_cin1_kernel<<<wgrid, THREADS, 0, st>>>(x, dy, y, scale, bias, part, H, W, C,
                                                         p.tiles_y, p.tiles_x, p.n_tiles,
                                                         p.groups);
    err = cudaGetLastError();
  } else {
    const bool vec = Cin % 4 == 0 && C % 4 == 0;
    auto kernel = vec ? conv3x3_wgrad_mma_kernel<4> : conv3x3_wgrad_mma_kernel<1>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WGRAD_SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<wgrid, THREADS, WGRAD_SMEM_BYTES, st>>>(x, dy, y, scale, bias, part, H, W, Cin, C,
                                                     p.k_blocks, p.tiles_y, p.tiles_x,
                                                     p.n_tiles, p.groups);
    err = cudaGetLastError();
  }
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
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(launch_mma<true>(dy, y, w, scale, nullptr, dx, B, H, W, C, Cin, st));
}
