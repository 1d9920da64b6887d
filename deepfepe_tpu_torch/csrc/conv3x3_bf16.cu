// Fused 3x3 SAME convolution + per-channel affine + ReLU in bf16: the
// forward (K5) and its backward (K5b) at the SuperPoint's production dtype.
//
// K5 replaces the TPU kernel `_fwd_kernel` of
// deepfepe_tpu/ops/pallas/conv_pallas.py (through `_fwd_pallas`) with bf16
// x and w: in NHWC, x [B, H, W, Cin] and y [B, H, W, C] bf16, w [3, 3, Cin,
// C] bf16, scale and bias [C] float32,
//     y[b, i, j, c] = bf16(relu(scale[c] * sum_{ky, kx, ci} x[b, i+ky-1, j+kx-1, ci]
//                                                 * w[ky, kx, ci, c] + bias[c]))
// with zero padding outside each image: bf16 products summed in float32,
// then acc * scale, then + bias (two roundings, no FMA), the ReLU, and one
// rounding to bf16, as the TPU kernel does (:111-132).
//
// K5b replaces `_bwd_kernel` of the same file (through `_bwd_pallas`). From
// x, w, scale, bias, the saved y and the cotangent dy (bf16) it computes,
// with dz = bf16(dy * (y > 0) * scale) held in bf16 as the TPU kernel holds
// it in dy's dtype (:196-202, :313-318) and s_safe = scale where |scale| >=
// 1e-8, else 1:
//     dbias[c]  = sum_{b, i, j} dz / s_safe                        (float32)
//     dscale[c] = sum_{b, i, j} (dz / s_safe) * (y - bias) / s_safe  (float32)
//     dw[ky, kx, ci, c] = bf16(sum_{b, i, j} x[b, i+ky-1, j+kx-1, ci] * dz[b, i, j, c])
//     dx[b, i, j, ci]   = bf16(sum_{ky, kx, c} dz[b, i+1-ky, j+1-kx, c] * w[ky, kx, ci, c])
// dw leaves in w's dtype (bf16) and dx in x's, as the TPU kernel's (:327);
// dx only when asked for (`need_dx`; the image input of the first conv
// needs none). The wrapper and the plain versions are in ops/conv_bf16.py.
//
// Channels: (Cin, C) in {1, 64} x {64, 128} and (128, 128): every layer of the
// SuperPoint that takes the kernel (inc 1 -> 64 and 64 -> 64 at 376 x 1240,
// down1 64 -> 64 at 188 x 620, down2 64 -> 128 and 128 -> 128 at 94 x 310,
// with B = 8 frames).
//
// What bounds them. At inc.conv1 (B = 8, 376 x 1240, 64 -> 64) the forward
// is 2.750e11 FLOP (0.278 ms at 989 TFLOP/s bf16) against 954.9 MB of x and
// y (0.285 ms at 3.35 TB/s): bytes, just. The backward reads x, y and dy and
// writes dx (1,909.8 MB, 0.570 ms) for twice the products (0.556 ms).
//
// Forward, Cin >= 64 (`k5_wgmma_kernel`): the taps9 strip kernel of the
// conv-formulation tool (csrc/conv_formulations.cu, X4 taps9_4_64, its
// fastest kind), widened to C = 128 outputs and Cin = 128 inputs. A block
// owns one th-row strip of one image and walks its chunks of th x 64
// pixels left to right. A producer warp brings each chunk's halo [th + 2,
// 66, 64] by TMA (one box a 64-channel half of Cin) into a ring of
// mbarrier stages; TMA's zero fill outside the tensor gives the SAME
// padding, and the epilogue masks the stores of the ragged right and
// bottom chunks (1240, 620 and 310 are no multiples of 64). nwg consumer
// warpgroups each take a 64-pixel M tile and run `wgmma.m64n64k16` (two a
// k step for C = 128) over 9 (Cin 64) or 18 (Cin 128) K slices of 64, A by
// ldmatrix from the swizzled halo, B the weights [9 Cin, C] (w as it is,
// no packing) in [64 k][64 n] boxes. The weights stay resident where they
// fit beside two halo stages (64 -> 64 at th = 4, four warpgroups, as X4;
// 64 -> 128, 147,456 bytes, at th = 2); 128 -> 128's 294,912 bytes do not,
// and stream per K slice through their own ring of mbarrier stages, as
// X2's do. Cin = 1 (`k5_cin1_kernel`) is bound by bytes: FFMA, a thread a
// pixel and 8 channels, 16-byte stores.
//
// Backward: `mma.sync.m16n8k16` bf16 with float32 accumulators, the f32
// K5b's structure (csrc/conv3x3.cu) with bf16 operands fed by ldmatrix.
//   dx (`k5b_dgrad_kernel`): an implicit GEMM, M = 16 x 16 output pixels,
//     N = 64 channels of x a block, K = 9 x C through chunks of 32 channels
//     of dz: each chunk's (16 + 2)^2 halo of dy and y and its weights
//     w[8 - tap][n][k] arrive by 16-byte cp.async into a two-stage ring,
//     and each thread forms dz in bf16 on the pieces it copied.
//   dw (`k5b_wgrad_kernel`): M = 9 taps x 32 input channels, N = 64 output
//     channels, K = pixels, over groups of 4 x 32-pixel tiles; dz is formed
//     in bf16 on each tile once for all nine taps, and blocks of the first
//     input-channel slice also sum dscale and dbias from that bf16 dz. A
//     and B come by ldmatrix.trans from the pixel-major tiles. Cin = 1
//     (`k5b_wgrad_cin1_kernel`) is bound by bytes and sums in FP32 as the
//     f32 kernel's does.
// Each writes float32 partial sums a pixel group; `sum_groups_kernel` adds
// the groups in a fixed order and rounds dw once to bf16: no atomics, the
// same bits every run (so `remat` reruns and repeats agree).

#include "hopper_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float SAFE_EPS = 1e-8f;
constexpr long long SMEM_MAX = 232448;  // a block's shared memory on Hopper
constexpr int BOX = 8192;               // a [64][64] bf16 tile: 64 rows of 128 bytes
constexpr int MAX_HALO_STAGES = 4;
constexpr int MAX_W_STAGES = 6;
constexpr int TAIL_BYTES = 1280;        // the barriers (256 bytes), then s and t [128] each
constexpr int ERR_TENSOR_MAP = 9001;    // cuTensorMapEncodeTiled missing or refused
constexpr int MAX_C = 128;
constexpr int TW = 64;                  // forward chunk width

inline long long round1024(long long v) { return (v + 1023) / 1024 * 1024; }

bool channels_ok(int Cin, int C) {
  return (C == 64 || C == 128) && (Cin == 1 || Cin == 64 || (Cin == 128 && C == 128));
}

// ----------------------------------------------------------------- forward

// The shared memory of a forward block, from its 1024-aligned base: the halo
// ring, the weights (resident, or a ring of K slices), the barriers with s
// and t. total = -1 where nothing fits.
struct FLayout {
  int nwg, th, halo_stages, w_stages;
  bool stream;
  long long halo_stage, weights, total;
};

FLayout fwd_layout(int cin, int cout) {
  FLayout l{0, 0, 0, 0, false, 0, 0, -1};
  const int kh = cin / 64, nh = cout / 64;
  const long long room = SMEM_MAX - 1024 - TAIL_BYTES;
  const long long resident = 9LL * kh * nh * BOX;
  for (int nwg = 4; nwg >= 2; nwg -= 2) {  // th = nwg rows of 64 pixels
    const long long stage = kh * round1024(128LL * (nwg + 2) * (TW + 2));
    const long long n = room > resident ? (room - resident) / stage : 0;
    if (n >= 2) {
      l = {nwg, nwg, static_cast<int>(n < MAX_HALO_STAGES ? n : MAX_HALO_STAGES), 0, false,
           stage, resident, -1};
      l.total = 1024 + l.halo_stages * stage + resident + TAIL_BYTES;
      return l;
    }
  }
  const long long stage = kh * round1024(128LL * 4 * (TW + 2));  // th = 2
  const long long n = (room - 2 * stage) / (nh * BOX);
  if (n < 2) return l;
  const int ws = static_cast<int>(n < MAX_W_STAGES ? n : MAX_W_STAGES);
  l = {2, 2, 2, ws, true, stage, 1LL * ws * nh * BOX, -1};
  l.total = 1024 + 2 * stage + l.weights + TAIL_BYTES;
  return l;
}

struct FParams {
  const float* s;
  const float* t;
  bf16* y;
  int H, W, th, n_chunks, n_strips;
  int halo_box;  // bytes of one [th + 2, 66, 64] box
  int halo_stage, halo_stages, w_stages;
  int weights_off, bar_off;  // from the block's 1024-aligned base
};

// Block: warps 0 .. 4 NWG - 1 the consumer warpgroups (M tiles: the chunk's
// pixels 64 wg .. 64 wg + 63, row-major over th x 64), warp 4 NWG the
// producer. STREAM: the weights through a ring of K slices.
template <int CIN, int COUT, int NWG, bool STREAM>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
    k5_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const FParams p) {
  constexpr int KH = CIN / 64;  // 64-channel halves of the input: halo boxes a stage
  constexpr int NH = COUT / 64;  // 64-column halves of N
  constexpr int NS = 9 * KH;     // K slices of 64: tap-major, then the half
  constexpr int CONSUMERS = 128 * NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* halo = smem;
  unsigned char* wsm = smem + p.weights_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + MAX_HALO_STAGES;
  uint64_t* wfull = empty + MAX_HALO_STAGES;
  uint64_t* wempty = wfull + MAX_W_STAGES;
  uint64_t* wres = wempty + MAX_W_STAGES;
  float* sst = reinterpret_cast<float*>(smem + p.bar_off + 256);  // s[COUT], then t[COUT]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half_bytes = p.halo_stage / KH;
  const int b = blockIdx.x / p.n_strips;
  const int r0 = (blockIdx.x % p.n_strips) * p.th;
  for (int i = tid; i < COUT; i += blockDim.x) {
    sst[i] = p.s[i];
    sst[COUT + i] = p.t[i];
  }
  if (tid == 0) {
    for (int i = 0; i < p.halo_stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    for (int i = 0; i < p.w_stages; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], CONSUMERS);
    }
    mbar_init(wres, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer
    if (lane == 0) {
      if (!STREAM) {  // the resident weights: NS x NH boxes of [64 k][64 n]
        mbar_expect(wres, NS * NH * BOX);
        for (int s = 0; s < NS; ++s)
          for (int j = 0; j < NH; ++j) tma_load(wsm + (s * NH + j) * BOX, &wmap, wres, 64 * j, 64 * s);
      }
      int u = 0;  // weight slices issued
      for (int i = 0; i < p.n_chunks; ++i) {
        const int hs = i % p.halo_stages;
        if (i >= p.halo_stages) mbar_wait(&empty[hs], ((i / p.halo_stages) + 1) & 1);
        mbar_expect(&full[hs], KH * p.halo_box);  // the boxes' bytes, zero fill included
        const int hr0 = r0 - 1;      // the halo's top row: one above the strip's rows
        const int hc0 = i * TW - 1;  // the halo's left column: one left of the chunk's
        for (int h = 0; h < KH; ++h)
          tma_load_4d(halo + hs * p.halo_stage + h * half_bytes, &xmap, &full[hs], 64 * h, hc0,
                      hr0, b);
        if (STREAM) {
          for (int s = 0; s < NS; ++s, ++u) {
            const int ws = u % p.w_stages;
            if (u >= p.w_stages) mbar_wait(&wempty[ws], ((u / p.w_stages) + 1) & 1);
            mbar_expect(&wfull[ws], NH * BOX);
            for (int j = 0; j < NH; ++j)
              tma_load(wsm + (ws * NH + j) * BOX, &wmap, &wfull[ws], 64 * j, 64 * s);
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg, warp q in it; accumulator rows g, g + 8 of
  // the warp's 16, columns 8 c + 2 t and + 1 of each 64-column half.
  const int wg = warp >> 2, q = warp & 3, g = lane >> 2, t4 = lane & 3;
  constexpr int HC = TW + 2;
  // The halo row at tap (0, 0) of this lane's ldmatrix row (lanes 8 m ..
  // 8 m + 7 address matrix m: rows 0-7, 8-15, then the same at k + 8).
  const int arow = 16 * q + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int apx = 64 * wg + arow;
  const int hr0 = (apx / TW) * HC + apx % TW;
  const int kc = lane >> 4;  // the lane's 8-column half of a k step

  if (!STREAM) mbar_wait(wres, 0);
  int u = 0;  // weight slices consumed
  for (int i = 0; i < p.n_chunks; ++i) {
    const int c0 = i * TW;
    const int hs = i % p.halo_stages;
    mbar_wait(&full[hs], (i / p.halo_stages) & 1);
    const unsigned char* hb = halo + hs * p.halo_stage;
    // Opaque copies of the chunk-invariant bases (as in conv_wgmma_kernel):
    // without them the compiler hoists every slice's addresses out of the
    // chunk loop and spills.
    int hrb = hr0;
    const unsigned char* wbase = wsm;
    asm volatile("" : "+r"(hrb), "+l"(wbase));
    float acc[NH][32];
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
    uint32_t a[2][4][4];
    // A of slice s (tap s / KH, channel half s % KH) into register set s & 1.
    auto prepare = [&](int s) {
      const int tap = s / KH, h = s % KH;
      const int hr = hrb + (tap / 3) * HC + tap % 3;
      const unsigned char* src = hb + h * half_bytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(a[s & 1][kk], smem_addr(src + swz(hr, 2 * kk + kc)));
    };
    prepare(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const unsigned char* wb;
      if (!STREAM) {
        wb = wbase + s * NH * BOX;
      } else {  // no products are in flight across this wait
        const int ws = (u + s) % p.w_stages;
        mbar_wait(&wfull[ws], ((u + s) / p.w_stages) & 1);
        wb = wbase + ws * NH * BOX;
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const uint64_t db = sdesc(wb + j * BOX + 2048 * kk, BOX, 1024);
          wgmma_rs(acc[j], a[s & 1][kk], db);  // every tap of every slice
        }
      wg_commit();
      // Slice s + 1's A while slice s's products run: its registers last
      // served slice s - 1, whose products are done.
      if (s + 1 < NS) prepare(s + 1);
      wg_wait<0>();
      if (STREAM) mbar_arrive(&wempty[(u + s) % p.w_stages]);  // slice s is done
    }
    keep(acc);
    u += NS;
    mbar_arrive(&empty[hs]);  // this thread's products on the halo are done

    // Epilogue: rows g and g + 8 of the warp, each 64-column half in two
    // blocks of four 16-byte chunks; a quad's transpose gives lane t chunk
    // t of each block. Rows and columns past the image are not stored.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int px = 64 * wg + 16 * q + g + 8 * hh;
      const int row = r0 + px / TW, col = c0 + px % TW;
      const bool inside = row < p.H && col < p.W;
      bf16* dst = p.y + ((static_cast<long long>(b) * p.H + row) * p.W + col) * COUT;
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int blk = 0; blk < 2; ++blk) {
          uint32_t in[4];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int c = 4 * blk + qq;
            const int ch = 64 * j + 8 * c + 2 * t4;
            const float2 sc = *reinterpret_cast<const float2*>(sst + ch);
            const float2 sh = *reinterpret_cast<const float2*>(sst + COUT + ch);
            __nv_bfloat162 v =
                __floats2bfloat162_rn(affine_relu(acc[j][4 * c + 2 * hh], sc.x, sh.x),
                                      affine_relu(acc[j][4 * c + 2 * hh + 1], sc.y, sh.y));
            in[qq] = *reinterpret_cast<uint32_t*>(&v);
          }
          const uint4 o = quad_transpose(in, lane);
          if (inside) *reinterpret_cast<uint4*>(dst + 64 * j + 8 * (4 * blk + t4)) = o;
        }
    }
  }
}

template <int CIN, int COUT, int NWG, bool STREAM>
int launch_fwd(const void* x, const void* w, const float* s, const float* t, void* y, int B,
               int H, int W, cudaStream_t st) {
  const FLayout l = fwd_layout(CIN, COUT);
  if (l.total < 0 || l.nwg != NWG || l.stream != STREAM)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, wm;
  const cuuint64_t xdims[4] = {CIN, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                               static_cast<cuuint64_t>(B)};
  const cuuint32_t xbox[4] = {64, TW + 2, static_cast<cuuint32_t>(l.th + 2), 1};
  const cuuint64_t wdims[2] = {COUT, 9 * CIN};
  const cuuint32_t wbox[2] = {64, 64};
  if (!tensor_map(&xm, x, 4, xdims, xbox) || !tensor_map(&wm, w, 2, wdims, wbox))
    return ERR_TENSOR_MAP;
  FParams p{};
  p.s = s;
  p.t = t;
  p.y = static_cast<bf16*>(y);
  p.H = H;
  p.W = W;
  p.th = l.th;
  p.n_chunks = (W + TW - 1) / TW;
  p.n_strips = (H + l.th - 1) / l.th;
  p.halo_box = 128 * (l.th + 2) * (TW + 2);
  p.halo_stage = static_cast<int>(l.halo_stage);
  p.halo_stages = l.halo_stages;
  p.w_stages = l.w_stages;
  p.weights_off = static_cast<int>(l.halo_stages * l.halo_stage);
  p.bar_off = static_cast<int>(p.weights_off + l.weights);
  const long long blocks = static_cast<long long>(p.n_strips) * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = k5_wgmma_kernel<CIN, COUT, NWG, STREAM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_MAX));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(blocks), 128 * NWG + 32, static_cast<size_t>(l.total), st>>>(
      xm, wm, p);
  return static_cast<int>(cudaGetLastError());
}

// Cin = 1: one thread per (pixel, 8 channels), grid-stride; the nine taps
// summed by FMA in tap order (every bf16 product is exact in float32).
__global__ void __launch_bounds__(THREADS)
    k5_cin1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   bf16* __restrict__ y, long long npix, int H, int W, int C) {
  __shared__ float ws[9 * MAX_C];  // [tap][co]
  __shared__ float ss[MAX_C];
  __shared__ float ts[MAX_C];
  for (int i = threadIdx.x; i < 9 * C; i += THREADS) ws[i] = __bfloat162float(w[i]);
  for (int i = threadIdx.x; i < C; i += THREADS) {
    ss[i] = scale[i];
    ts[i] = bias[i];
  }
  __syncthreads();
  const int cq = C / 8;
  const long long total = npix * cq;
  for (long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * THREADS) {
    const int q = static_cast<int>(idx % cq);
    const long long p = idx / cq;
    const int gx = static_cast<int>(p % W);
    const long long bi = p / W;
    const int gy = static_cast<int>(bi % H);
    const bf16* xb = x + (bi / H) * H * W;
    float v[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = gy + tap / 3 - 1;
      const int xx = gx + tap % 3 - 1;
      v[tap] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                   ? __bfloat162float(xb[static_cast<long long>(yy) * W + xx]) : 0.0f;
    }
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float r[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = 8 * q + 2 * k + e;
        float a = 0.0f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) a = fmaf(v[tap], ws[tap * C + co], a);
        r[e] = affine_relu(a, ss[co], ts[co]);
      }
      __nv_bfloat162 pr = __floats2bfloat162_rn(r[0], r[1]);
      o[k] = *reinterpret_cast<uint32_t*>(&pr);
    }
    *reinterpret_cast<uint4*>(y + p * C + 8 * q) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// ---------------------------------------------------------------- backward

// dz = bf16(dy * (y > 0) * scale): dy times the ReLU's mask, then the
// scale, in float32, rounded once to bf16.
__device__ __forceinline__ bf16 form_dz(bf16 dy, bf16 y, float s) {
  const float m = __bfloat162float(y) > 0.0f ? 1.0f : 0.0f;
  return __float2bfloat16_rn(__fmul_rn(__fmul_rn(__bfloat162float(dy), m), s));
}

__device__ __forceinline__ float safe_scale(float s) { return fabsf(s) < SAFE_EPS ? 1.0f : s; }

// a / b from r = 1 / b: the quotient a r refined by one FMA step, within a
// rounding of IEEE a / b (csrc/conv3x3.cu's `div_by`).
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

// d += a b for one m16n8k16 bf16 fragment triple, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices, transposed: lane i gets rows 2 (i % 4) and
// 2 (i % 4) + 1 of column i / 4 of each.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes from global to shared memory; zero-filled when !valid, and then
// `src` is only a placeholder address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// dx, Cin >= 64.
constexpr int DTH = 16, DTW = 16;       // output pixels a block
constexpr int DHC = DTW + 2;            // halo columns
constexpr int DHPIX = (DTH + 2) * DHC;  // halo pixels
constexpr int DCK = 32;                 // channels of dz a chunk: two k16 steps
constexpr int DRP = 40;                 // bf16 a row (80 bytes: 8 rows on 8 bank groups)
constexpr int DNT = 64;                 // channels of dx a block
constexpr int D_HALO = DHPIX * DRP;
constexpr int D_STAGE = 2 * D_HALO + 9 * DNT * DRP;  // dz (dy on arrival), y, weights
constexpr size_t DGRAD_SMEM_BYTES = sizeof(bf16) * 2 * D_STAGE;

// dx[b, i, j, n] = sum_{tap, k} dz[b, i+ty-1, j+tx-1, k] * w[8 - tap][n][k],
// w [3, 3, Cin, C]: blockIdx.z = image x (Cin / 64) + channel block; a warp
// owns tile rows 2 warp and 2 warp + 1 by the block's 64 channels.
__global__ void __launch_bounds__(THREADS, 1)
    k5b_dgrad_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ y,
                     const bf16* __restrict__ w, const float* __restrict__ scale,
                     bf16* __restrict__ dx, int H, int W, int Cin, int C, int n_blocks) {
  extern __shared__ __align__(16) bf16 dsm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mat = lane >> 3, rr = lane & 7;  // the lane's ldmatrix matrix and row
  const int b = blockIdx.z / n_blocks;
  const int n0 = (blockIdx.z % n_blocks) * DNT;
  const int row0 = blockIdx.y * DTH, col0 = blockIdx.x * DTW;
  const size_t img = static_cast<size_t>(b) * H * W;
  const int n_chunks = C / DCK;

  auto load = [&](int st, int k0) {
    bf16* sd = dsm + st * D_STAGE;
    bf16* sy = sd + D_HALO;
    bf16* sw = sy + D_HALO;
    for (int i = tid; i < DHPIX * (DCK / 8); i += THREADS) {
      const int pc = i % (DCK / 8), pix = i / (DCK / 8);
      const int gy = row0 + pix / DHC - 1, gx = col0 + pix % DHC - 1;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const size_t at = (img + static_cast<size_t>(gy) * W + gx) * C + k0 + 8 * pc;
      cp_async16(sd + pix * DRP + 8 * pc, inside ? dy + at : dy, inside);
      cp_async16(sy + pix * DRP + 8 * pc, inside ? y + at : y, inside);
    }
    for (int i = tid; i < 9 * DNT * (DCK / 8); i += THREADS) {
      const int pc = i % (DCK / 8), n = (i / (DCK / 8)) % DNT, tap = i / (DCK / 8 * DNT);
      const bf16* src = w + (static_cast<size_t>(8 - tap) * Cin + n0 + n) * C + k0 + 8 * pc;
      cp_async16(sw + (tap * DNT + n) * DRP + 8 * pc, src, true);
    }
  };
  // dz on the pieces this thread copied.
  auto make_dz = [&](int st, int k0) {
    bf16* sd = dsm + st * D_STAGE;
    const bf16* sy = sd + D_HALO;
    for (int i = tid; i < DHPIX * (DCK / 8); i += THREADS) {
      const int pc = i % (DCK / 8), at = (i / (DCK / 8)) * DRP + 8 * pc;
      uint4 dv = *reinterpret_cast<const uint4*>(sd + at);
      const uint4 yv = *reinterpret_cast<const uint4*>(sy + at);
      bf16* d = reinterpret_cast<bf16*>(&dv);
      const bf16* yy = reinterpret_cast<const bf16*>(&yv);
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = form_dz(d[e], yy[e], __ldg(scale + k0 + 8 * pc + e));
      *reinterpret_cast<uint4*>(sd + at) = dv;
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;

  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    cp_async_wait_all();
    make_dz(st, c * DCK);
    __syncthreads();
    if (c + 1 < n_chunks) {
      load(st ^ 1, (c + 1) * DCK);
      cp_async_commit();
    }
    const bf16* sd = dsm + st * D_STAGE;
    const bf16* sw = sd + 2 * D_HALO;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < DCK / 16; ++ks) {
        // A: rows = the m16 tile's pixels (columns of tile row r), cols = k.
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int pix = (2 * warp + mi + ky) * DHC + rr + 8 * (mat & 1) + kx;
          ldmatrix_x4(a[mi], smem_addr(sd + pix * DRP + 16 * ks + 8 * (mat >> 1)));
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          // B of n8 fragments 2 jj and 2 jj + 1, rows n with k contiguous.
          uint32_t bb[4];
          const int n = 8 * (2 * jj + (mat >> 1)) + rr;
          ldmatrix_x4(bb, smem_addr(sw + (tap * DNT + n) * DRP + 16 * ks + 8 * (mat & 1)));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * jj], a[mi], bb[0], bb[1]);
            mma_bf16(acc[mi][2 * jj + 1], a[mi], bb[2], bb[3]);
          }
        }
      }
    }
  }

  // Element e of fragment (mi, j): pixel column g (e < 2) or g + 8, channel
  // 8 j + 2 t + e % 2.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int gy = row0 + 2 * warp + mi;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gx = col0 + g + 8 * hh;
        if (gy >= H || gx >= W) continue;
        *reinterpret_cast<__nv_bfloat162*>(
            dx + (img + static_cast<size_t>(gy) * W + gx) * Cin + n0 + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[mi][j][2 * hh], acc[mi][j][2 * hh + 1]);
      }
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

// dw, Cin >= 64.
constexpr int WTH = 4, WTW = 32;    // tile rows and columns
constexpr int WTP = WTH * WTW;      // pixels a tile: 8 k16 steps
constexpr int WHC = WTW + 2;
constexpr int WHPIX = (WTH + 2) * WHC;
constexpr int KS = 32;              // input channels a block
constexpr int CT = 64;              // output channels a block
constexpr int XRP = 40;             // bf16 a halo pixel row of 32 channels (80 bytes)
constexpr int ZRP = 72;             // bf16 a tile pixel row of 64 channels (144 bytes)
constexpr int WX = WHPIX * XRP;
constexpr int W_STAGE = WX + 2 * WTP * ZRP;  // x halo, dz (dy on arrival), y
constexpr size_t WGRAD_SMEM_BYTES = sizeof(bf16) * 2 * W_STAGE;
static_assert(WGRAD_SMEM_BYTES >= sizeof(float) * 2 * THREADS * 8, "the affine sums' scratch");
static_assert(DGRAD_SMEM_BYTES <= SMEM_MAX && WGRAD_SMEM_BYTES <= SMEM_MAX,
              "a block's shared memory");

// Partial sums of pixel group g = blockIdx.y; blockIdx.x = kb + k_blocks
// nb: input channels [KS kb, + KS), output channels [CT nb, + CT). part[g]
// is [9 Cin C] dw, then [C] dscale, then [C] dbias; every entry is written
// by exactly one block. Warp: input channels 16 mw + 0..15 of the slice by
// output channels 16 nw + 0..15 of the block, all nine taps.
__global__ void __launch_bounds__(THREADS, 1)
    k5b_wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     const bf16* __restrict__ y, const float* __restrict__ scale,
                     const float* __restrict__ bias, float* __restrict__ part, int H, int W,
                     int Cin, int C, int k_blocks, int tiles_y, int tiles_x, long long n_tiles,
                     int G) {
  extern __shared__ __align__(16) bf16 wsm2[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t = lane % 4;
  const int mat = lane >> 3, rr = lane & 7;
  const int mw = warp % 2, nw = warp / 2;
  const int k0 = (blockIdx.x % k_blocks) * KS;
  const int c0 = (blockIdx.x / k_blocks) * CT;
  const bool affine = k0 == 0;
  const int g = blockIdx.y;
  const long long t_begin = n_tiles * g / G;
  const long long t_end = n_tiles * (g + 1) / G;
  const int n_here = static_cast<int>(t_end - t_begin);

  // The thread's 8-channel piece of a tile pixel is fixed: THREADS is a
  // multiple of 8.
  const int lq = tid % 8;
  float s_l[8], ss_l[8], r_l[8], t_l[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int co = c0 + 8 * lq + e;
    s_l[e] = scale[co];
    ss_l[e] = safe_scale(s_l[e]);
    r_l[e] = 1.0f / ss_l[e];
    t_l[e] = bias[co];
  }
  float sum_m[8], sum_mz[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum_m[e] = sum_mz[e] = 0.0f;

  auto load = [&](int st, long long tile) {
    const Tile tl = tile_at(tile, tiles_y, tiles_x, WTH, WTW);
    bf16* sx = wsm2 + st * W_STAGE;
    bf16* sd = sx + WX;
    bf16* sy = sd + WTP * ZRP;
    const size_t img = static_cast<size_t>(tl.b) * H * W;
    for (int i = tid; i < WHPIX * (KS / 8); i += THREADS) {
      const int pc = i % (KS / 8), pix = i / (KS / 8);
      const int gy = tl.row0 + pix / WHC - 1, gx = tl.col0 + pix % WHC - 1;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bf16* src = x + (img + static_cast<size_t>(gy) * W + gx) * Cin + k0 + 8 * pc;
      cp_async16(sx + pix * XRP + 8 * pc, inside ? src : x, inside);
    }
    for (int i = tid; i < WTP * (CT / 8); i += THREADS) {
      const int p = i / (CT / 8);
      const int gy = tl.row0 + p / WTW, gx = tl.col0 + p % WTW;
      const bool inside = gy < H && gx < W;
      const size_t at = (img + static_cast<size_t>(gy) * W + gx) * C + c0 + 8 * lq;
      cp_async16(sd + p * ZRP + 8 * lq, inside ? dy + at : dy, inside);
      cp_async16(sy + p * ZRP + 8 * lq, inside ? y + at : y, inside);
    }
  };
  // dz in bf16 on the pieces this thread copied, and the affine sums over
  // them from that bf16 dz.
  auto make_dz = [&](int st) {
    bf16* sd = wsm2 + st * W_STAGE + WX;
    const bf16* sy = sd + WTP * ZRP;
    for (int i = tid; i < WTP * (CT / 8); i += THREADS) {
      const int at = (i / (CT / 8)) * ZRP + 8 * lq;
      uint4 dv = *reinterpret_cast<const uint4*>(sd + at);
      const uint4 yv = *reinterpret_cast<const uint4*>(sy + at);
      bf16* d = reinterpret_cast<bf16*>(&dv);
      const bf16* yy = reinterpret_cast<const bf16*>(&yv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bf16 dyv = d[e];
        d[e] = form_dz(dyv, yy[e], s_l[e]);
        if (affine) {
          const float dzf = __bfloat162float(d[e]);  // the sums take the bf16 dz
          const float mm = div_by(dzf, ss_l[e], r_l[e]);
          sum_m[e] += mm;
          sum_mz[e] += div_by(mm * (__bfloat162float(yy[e]) - t_l[e]), ss_l[e], r_l[e]);
        }
      }
      *reinterpret_cast<uint4*>(sd + at) = dv;
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
    const int st = it & 1;
    cp_async_wait_all();
    make_dz(st);
    __syncthreads();
    if (it + 1 < n_here) {
      load(st ^ 1, t_begin + it + 1);
      cp_async_commit();
    }
    const bf16* sx = wsm2 + st * W_STAGE;
    const bf16* sd = sx + WX;
    float acc[9][2][4];
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.0f;
#pragma unroll 1
    for (int ks = 0; ks < WTP / 16; ++ks) {
      // k16 step: pixels p0 + 0..15, one tile row, 16 neighbouring columns.
      const int pr = ks / (WTW / 16);
      const int pc = (ks % (WTW / 16)) * 16;
      const int p0 = pr * WTW + pc;
      // B (k = pixels, n = output channels): both n8 fragments of the warp.
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, smem_addr(sd + (p0 + rr + 8 * (mat & 1)) * ZRP + 16 * nw +
                                      8 * (mat >> 1)));
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        // A (m = input channels, k = the step's pixels shifted by the tap).
        uint32_t a[4];
        const int hp = (pr + tap / 3) * WHC + pc + tap % 3 + rr + 8 * (mat >> 1);
        ldmatrix_x4_trans(a, smem_addr(sx + hp * XRP + 16 * mw + 8 * (mat & 1)));
        mma_bf16(acc[tap][0], a, bb[0], bb[1]);
        mma_bf16(acc[tap][1], a, bb[2], bb[3]);
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
  // Element e of fragment (tap, j): input channel 16 mw + g8 (+ 8 for e >=
  // 2), output channel 16 nw + 8 j + 2 t + e % 2.
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = k0 + 16 * mw + g8 + (e >= 2 ? 8 : 0);
        const int co = c0 + 16 * nw + 8 * j + 2 * t + e % 2;
        out[(static_cast<size_t>(a) * Cin + ci) * C + co] = tot[a][j][e];
      }
  if (affine) {
    // The 32 threads of each channel piece (tid % 8), added in tid order.
    __syncthreads();  // every warp is done with the stages: reuse them
    float* red = reinterpret_cast<float*>(wsm2);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[tid * 8 + e] = sum_mz[e];
      red[(THREADS + tid) * 8 + e] = sum_m[e];
    }
    __syncthreads();
    if (tid < CT) {
      const int q = tid / 8, e = tid % 8;
      float ds = 0.0f, dt = 0.0f;
      for (int r = 0; r < THREADS / 8; ++r) {
        ds += red[(r * 8 + q) * 8 + e];
        dt += red[(THREADS + r * 8 + q) * 8 + e];
      }
      out[static_cast<size_t>(9) * Cin * C + c0 + tid] = ds;
      out[static_cast<size_t>(9) * Cin * C + C + c0 + tid] = dt;
    }
  }
}

// dw, dscale and dbias for Cin = 1: partial sums of pixel group g =
// blockIdx.y over output channels [CT blockIdx.x, + CT), as the f32
// kernel's: lane l owns channels 2 l and 2 l + 1, warp w every 8th pixel of
// a C1TH x C1TW tile; it reads the pixel's dy and y once (4 bytes each), the
// nine neighbours' x from the tile's halo, forms dz in bf16 and sums in
// FP32. The warps' sums are added in warp order at the end.
constexpr int C1TH = 2, C1TW = 128, C1_WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS, 4)
    k5b_wgrad_cin1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                          const bf16* __restrict__ y, const float* __restrict__ scale,
                          const float* __restrict__ bias, float* __restrict__ part, int H, int W,
                          int C, int tiles_y, int tiles_x, long long n_tiles, int G) {
  constexpr int HW = C1TW + 2;
  constexpr int UNR = 4;
  constexpr int NSUM = 11;  // 9 taps, dscale, dbias
  __shared__ float xs[(C1TH + 2) * HW];
  __shared__ float red[C1_WARPS * NSUM * CT];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.x * CT;
  const int c = c0 + 2 * lane;
  const int g = blockIdx.y;
  const long long t_begin = n_tiles * g / G;
  const long long t_end = n_tiles * (g + 1) / G;
  float s_l[2], ss_l[2], r_l[2], t_l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    s_l[e] = scale[c + e];
    ss_l[e] = safe_scale(s_l[e]);
    r_l[e] = 1.0f / ss_l[e];
    t_l[e] = bias[c + e];
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
      xs[i] = gy >= 0 && gy < H && gx >= 0 && gx < W
                  ? __bfloat162float(x[img + static_cast<size_t>(gy) * W + gx]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 1
    for (int p0 = warp; p0 < C1TH * C1TW; p0 += C1_WARPS * UNR) {
      __nv_bfloat162 dv[UNR], yv[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int p = p0 + C1_WARPS * u;
        const int gy = tl.row0 + p / C1TW;
        const int gx = tl.col0 + p % C1TW;
        const size_t at = (img + static_cast<size_t>(gy) * W + gx) * C + c;
        dv[u] = yv[u] = __floats2bfloat162_rn(0.0f, 0.0f);
        if (gy < H && gx < W) {
          dv[u] = *reinterpret_cast<const __nv_bfloat162*>(dy + at);
          yv[u] = *reinterpret_cast<const __nv_bfloat162*>(y + at);
        }
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int p = p0 + C1_WARPS * u;
        const float* xp = xs + (p / C1TW) * HW + p % C1TW;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bf16 dyb = e ? dv[u].y : dv[u].x;
          const bf16 yb = e ? yv[u].y : yv[u].x;
          const float dz = __bfloat162float(form_dz(dyb, yb, s_l[e]));
          const float mm = div_by(dz, ss_l[e], r_l[e]);
          acc[9][e] += div_by(mm * (__bfloat162float(yb) - t_l[e]), ss_l[e], r_l[e]);
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
    const int a = i / CT, cc = i % CT;
    float s = 0.0f;
    for (int r = 0; r < C1_WARPS; ++r) s += red[(r * NSUM + a) * CT + cc];
    out[static_cast<size_t>(a) * C + c0 + cc] = s;
  }
}

// dx for Cin = 1: one thread per pixel, grid-stride, the sum over the nine
// taps and C channels of dz at the pixel's neighbours.
__global__ void __launch_bounds__(THREADS)
    k5b_dgrad_cin1_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ y,
                          const bf16* __restrict__ w, const float* __restrict__ scale,
                          bf16* __restrict__ dx, long long npix, int H, int W, int C) {
  __shared__ float ws[9 * MAX_C];  // [tap][c]
  __shared__ float ss[MAX_C];
  for (int i = threadIdx.x; i < 9 * C; i += THREADS) ws[i] = __bfloat162float(w[i]);
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
      for (int c = 0; c < C; ++c)
        a = fmaf(__bfloat162float(form_dz(dy[at + c], y[at + c], ss[c])), ws[tap * C + c], a);
    }
    dx[p] = __float2bfloat16_rn(a);
  }
}

// dw[e] = bf16(sum_{g < G} part[g E + e]) for e < n_w, then dscale and
// dbias in float32: every group, in order.
__global__ void __launch_bounds__(THREADS)
    sum_groups_kernel(const float* __restrict__ part, bf16* __restrict__ dw,
                      float* __restrict__ dst, int G, long long E, long long n_w) {
  for (long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; e < E;
       e += static_cast<long long>(gridDim.x) * THREADS) {
    float s = 0.0f;
#pragma unroll 8
    for (int g = 0; g < G; ++g) s += part[g * E + e];  // every group, in order
    if (e < n_w)
      dw[e] = __float2bfloat16_rn(s);
    else
      dst[e - n_w] = s;
  }
}

constexpr int WAVES_BLOCKS = 132 * 4;  // weight-gradient blocks to aim for

struct WgradPlan {
  int k_blocks, n_blocks, tiles_y, tiles_x, groups;
  long long n_tiles, entries;
};

WgradPlan wgrad_plan(int B, int H, int W, int Cin, int C) {
  WgradPlan p;
  const int th = Cin == 1 ? C1TH : WTH;
  const int tw = Cin == 1 ? C1TW : WTW;
  p.k_blocks = Cin == 1 ? 1 : Cin / KS;
  p.n_blocks = C / CT;
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

bool shapes_ok(int B, int H, int W, int Cin, int C) {
  return B >= 1 && H >= 1 && W >= 1 && channels_ok(Cin, C) &&
         static_cast<long long>(B) * (Cin > 64 ? Cin / 64 : 1) <= 65535;
}

int grid_stride_blocks(long long work) {
  const long long want = (work + THREADS - 1) / THREADS;
  return static_cast<int>(want < 132 * 32 ? want : 132 * 32);
}

}  // namespace

// x [B, H, W, Cin] and w [3, 3, Cin, C] bf16, 16-byte aligned; scale and
// bias [C] float32; y [B, H, W, C] bf16; all contiguous on the device.
// (Cin, C) in {1, 64} x {64, 128} or (128, 128). Launches on `stream`; returns the
// launch's cudaError, else 0, and 9001 when a tensor map could not be made.
extern "C" int conv3x3_affine_relu_bf16(const void* x, const void* w, const float* scale,
                                        const float* bias, void* y, int B, int H, int W,
                                        int Cin, int C, void* stream) {
  if (!shapes_ok(B, H, W, Cin, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin == 1) {
    const long long npix = static_cast<long long>(B) * H * W;
    k5_cin1_kernel<<<grid_stride_blocks(npix * (C / 8)), THREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, bias,
        static_cast<bf16*>(y), npix, H, W, C);
    return static_cast<int>(cudaGetLastError());
  }
  if (Cin == 64 && C == 64) return launch_fwd<64, 64, 4, false>(x, w, scale, bias, y, B, H, W, st);
  if (Cin == 64) return launch_fwd<64, 128, 2, false>(x, w, scale, bias, y, B, H, W, st);
  return launch_fwd<128, 128, 2, true>(x, w, scale, bias, y, B, H, W, st);
}

// The forward's block for (Cin, C): out[0..5] = warpgroups, strip rows,
// halo stages, weight stages (0: resident), shared bytes, 1 when the
// weights stream; returns 0, or -1 for channels it does not take.
extern "C" int conv3x3_bf16_fwd_layout(int Cin, int C, long long* out) {
  if (!channels_ok(Cin, C) || Cin == 1) return -1;
  const FLayout l = fwd_layout(Cin, C);
  out[0] = l.nwg;
  out[1] = l.th;
  out[2] = l.halo_stages;
  out[3] = l.w_stages;
  out[4] = l.total;
  out[5] = l.stream ? 1 : 0;
  return l.total < 0 ? -1 : 0;
}

// Floats of scratch that conv3x3_affine_relu_bwd_bf16 takes for these shapes.
extern "C" long long conv3x3_bwd_bf16_scratch_floats(int B, int H, int W, int Cin, int C) {
  if (!shapes_ok(B, H, W, Cin, C)) return 0;
  const WgradPlan p = wgrad_plan(B, H, W, Cin, C);
  return static_cast<long long>(p.groups) * p.entries;
}

// K5b. x, w, scale, bias as the forward; y its output and dy the cotangent
// [B, H, W, C] bf16. Writes dw [3, 3, Cin, C] bf16 and dst = [dscale C,
// dbias C] float32, using `part` (conv3x3_bwd_bf16_scratch_floats) for the
// partial sums, and dx [B, H, W, Cin] bf16 when dx is not null (no dx
// kernel is launched otherwise). Launches on `stream`; returns the first
// launch's error, else 0.
extern "C" int conv3x3_affine_relu_bwd_bf16(const void* x, const void* w, const float* scale,
                                            const float* bias, const void* y, const void* dy,
                                            void* dx, float* part, void* dw, float* dst, int B,
                                            int H, int W, int Cin, int C, void* stream) {
  if (!shapes_ok(B, H, W, Cin, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* yb = static_cast<const bf16*>(y);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const WgradPlan p = wgrad_plan(B, H, W, Cin, C);
  const dim3 wgrid(p.k_blocks * p.n_blocks, p.groups);
  cudaError_t err;
  if (Cin == 1) {
    k5b_wgrad_cin1_kernel<<<wgrid, THREADS, 0, st>>>(xb, dyb, yb, scale, bias, part, H, W, C,
                                                      p.tiles_y, p.tiles_x, p.n_tiles, p.groups);
    err = cudaGetLastError();
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        k5b_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(WGRAD_SMEM_BYTES));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    k5b_wgrad_kernel<<<wgrid, THREADS, WGRAD_SMEM_BYTES, st>>>(
        xb, dyb, yb, scale, bias, part, H, W, Cin, C, p.k_blocks, p.tiles_y, p.tiles_x,
        p.n_tiles, p.groups);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (p.entries + THREADS - 1) / THREADS;
  sum_groups_kernel<<<static_cast<int>(want < 4096 ? want : 4096), THREADS, 0, st>>>(
      part, static_cast<bf16*>(dw), dst, p.groups, p.entries, 9LL * Cin * C);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return static_cast<int>(err);
  if (Cin == 1) {
    const long long npix = static_cast<long long>(B) * H * W;
    k5b_dgrad_cin1_kernel<<<grid_stride_blocks(npix), THREADS, 0, st>>>(
        dyb, yb, wb, scale, static_cast<bf16*>(dx), npix, H, W, C);
    return static_cast<int>(cudaGetLastError());
  }
  static const cudaError_t dattr = cudaFuncSetAttribute(
      k5b_dgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(DGRAD_SMEM_BYTES));
  if (dattr != cudaSuccess) return static_cast<int>(dattr);
  const int n_blocks = Cin / DNT;
  const dim3 grid((W + DTW - 1) / DTW, (H + DTH - 1) / DTH, B * n_blocks);
  k5b_dgrad_kernel<<<grid, THREADS, DGRAD_SMEM_BYTES, st>>>(dyb, yb, wb, scale,
                                                            static_cast<bf16*>(dx), H, W, Cin, C,
                                                            n_blocks);
  return static_cast<int>(cudaGetLastError());
}
