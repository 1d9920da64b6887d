// Fused PointNet weight MLP, forward (K2) and backward (K2b), for Hopper.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// deepfepe_tpu/ops/pallas/mlp_pallas.py (wrapper `fused_pointnet_mlp`,
// `_fwd_rule`, `_bwd_rule`). The network is the ErrorEstimator stack:
// L hidden layers of Dense -> InstanceNorm (over the N points of one item)
// -> affine -> LeakyReLU, then a final Dense. Matrix products take bf16
// inputs and sum exact products in f32; the hidden Dense biases are never
// read (InstanceNorm cancels them).
//
// What bounds it. At the main path's shapes (B = 8 items, N = 1000 points,
// widths C_in -> 64 -> 128 -> 1024 -> 512 -> 256 -> 1) one forward is
// 2 B N sum(C_i C_{i+1}) = 12.7 GFLOP of bf16 products, 12.9 us at the
// card's 989 TFLOP/s, against a few MB of inputs and outputs (about 1 us
// at 3.35 TB/s): bound by operations. The backward recomputes the forward
// and adds the weight-gradient and input-gradient products, about three
// times that: 38 GFLOP, 38.6 us.
//
// Design. The TPU kernel holds one item's whole stack in ~100 MB of VMEM;
// an SM has 227 KB, so here each layer is a short sequence of launches
// that the wrapper (ops/mlp.py) issues on PyTorch's current stream, with
// every buffer allocated by the wrapper:
//   forward, per layer:  gemm    h = x_in @ W^T            (f32 out)
//                        in_stats  per (item, channel) sum of bf16(h) and
//                                  of bf16(bf16(h)^2), over N rows
//                        in_apply  y = bf16(LeakyReLU(h*scale + shift)),
//                                  and in the backward's recompute also
//                                  xhat = bf16((h - mean) * inv)
//   final:               gemm    logits = y @ Wf^T + bf
//   backward, per layer: bwd_reduce  r1 = sum dz, r2 = sum bf16(dz*xhat)
//                                    per item, and the folded constants
//                        sum_items   dgamma, dbeta (sums over items)
//                        bwd_dh      dh = dz*a - xhat*c2 - c1 (bf16)
//                        gemm        dW = dh^T @ x_in (split over rows,
//                                    partial sums added in a fixed order)
//                        gemm        dy = dh @ W (f32; bf16 on read)
// The statistics are a pass of their own over each item's rows, so a GEMM
// tile may straddle two items without harm, and N needs no padding. The
// GEMM is a 64x64x32 tile on four warps of nvcuda::wmma bf16 16x16x16
// fragments with f32 accumulators; tiles are staged in shared memory with
// the ragged edges (M, N and K, including the first layer's K = 5 or 8)
// zero-filled, and the operands' transposes are read through wmma's
// row- or column-major layouts. Every sum runs in a fixed order (no
// atomics), so results repeat from run to run.
// Rounding points mirror the TPU kernel: h is rounded to bf16 only for the
// statistics; z uses the f32 h; y, xhat, dz, dh and the backward's
// transients are bf16; the backward's ReLU mask comes from
// zb = bf16(bf16(xhat * bf16(gamma)) + bf16(beta)); r1, r2 and the weight
// gradients are f32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;   // GEMM tile rows
constexpr int BN = 64;   // GEMM tile columns
constexpr int BK = 32;   // GEMM tile depth
constexpr int PAD = 8;   // bf16 elements of padding per shared row
constexpr int GEMM_THREADS = 128;
constexpr int TILE_ELEMS = BM * (BK + PAD);  // >= BK * (BM + PAD)
constexpr int LDC_S = BN + 4;
constexpr int SMEM_BYTES = 2 * TILE_ELEMS * 2 + BM * LDC_S * 4;
constexpr int RED_X = 32;  // channels per reduction block
constexpr int RED_Y = 8;   // row slices per reduction block
constexpr int EW_THREADS = 256;
constexpr float IN_EPS = 1e-5f;

static_assert(BK * (BM + PAD) <= TILE_ELEMS, "A tile does not fit");
static_assert(BK * (BN + PAD) <= TILE_ELEMS, "B tile does not fit");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <bool T>
struct Layout {
  using type = wmma::row_major;
};
template <>
struct Layout<true> {
  using type = wmma::col_major;
};

// C[z] = A[:, Kz] @ B[Kz, :] (+ bias[n]) over the z-th slice Kz of the
// depth. A is [M, K] row-major (A[m*lda + k]) or, with A_T, stored [K, M]
// (A[k*lda + m]); B is [K, N] row-major (B[k*ldb + n]) or, with B_T,
// stored [N, K] (B[n*ldb + k]). C[z] is f32 [M, N] with row stride ldc, at
// C + z * split_stride.
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 float* __restrict__ C, const float* __restrict__ bias,
                 int M, int N, int K, int lda, int ldb, int ldc,
                 int k_per_split, long long split_stride) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + TILE_ELEMS;
  float* sC = reinterpret_cast<float*>(smem + 2 * TILE_ELEMS * sizeof(bf16));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const bf16 zero = __float2bfloat16(0.0f);
  constexpr int lda_s = A_T ? BM + PAD : BK + PAD;
  constexpr int ldb_s = B_T ? BK + PAD : BN + PAD;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int i = tid; i < BM * BK; i += GEMM_THREADS) {
      if constexpr (A_T) {
        const int r = i / BM, c = i % BM;  // r: k, c: m
        const int k = k0 + r, m = m0 + c;
        sA[r * lda_s + c] =
            (k < kend && m < M) ? A[static_cast<long long>(k) * lda + m] : zero;
      } else {
        const int r = i / BK, c = i % BK;  // r: m, c: k
        const int m = m0 + r, k = k0 + c;
        sA[r * lda_s + c] =
            (m < M && k < kend) ? A[static_cast<long long>(m) * lda + k] : zero;
      }
    }
    for (int i = tid; i < BK * BN; i += GEMM_THREADS) {
      if constexpr (B_T) {
        const int r = i / BK, c = i % BK;  // r: n, c: k
        const int n = n0 + r, k = k0 + c;
        sB[r * ldb_s + c] =
            (n < N && k < kend) ? B[static_cast<long long>(n) * ldb + k] : zero;
      } else {
        const int r = i / BN, c = i % BN;  // r: k, c: n
        const int k = k0 + r, n = n0 + c;
        sB[r * ldb_s + c] =
            (k < kend && n < N) ? B[static_cast<long long>(k) * ldb + n] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, typename Layout<A_T>::type> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, typename Layout<B_T>::type> b[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int mo = wm * 32 + mi * 16;
        const bf16* pa = A_T ? sA + kk * lda_s + mo : sA + mo * lda_s + kk;
        wmma::load_matrix_sync(a[mi], pa, lda_s);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int no = wn * 32 + ni * 16;
        const bf16* pb = B_T ? sB + no * ldb_s + kk : sB + kk * ldb_s + no;
        wmma::load_matrix_sync(b[ni], pb, ldb_s);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) wmma::mma_sync(acc[mi][ni], a[mi], b[ni], acc[mi][ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      wmma::store_matrix_sync(sC + (wm * 32 + mi * 16) * LDC_S + wn * 32 + ni * 16,
                              acc[mi][ni], LDC_S, wmma::mem_row_major);
  __syncthreads();
  float* Cz = C + blockIdx.z * split_stride;
  for (int i = tid; i < BM * BN; i += GEMM_THREADS) {
    const int r = i / BN, c = i % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      Cz[static_cast<long long>(m) * ldc + n] = sC[r * LDC_S + c] + (bias ? bias[n] : 0.0f);
  }
}

// out[i] = sum over z of part[z * mn + i], z in order.
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long long mn, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < mn;
       i += stride) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[z * mn + i];
    out[i] = s;
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ x, bf16* __restrict__ y,
                                 long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    y[i] = __float2bfloat16(x[i]);
}

// Per (item b = blockIdx.y, channel c): mean and variance over the item's
// Nn rows of the bf16-rounded h, E[h^2] on bf16-rounded squares, then the
// folded affine scale = gamma * inv, shift = beta - mean * scale.
__global__ void __launch_bounds__(RED_X * RED_Y)
in_stats_kernel(const float* __restrict__ h, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ mean,
                float* __restrict__ inv, float* __restrict__ scale,
                float* __restrict__ shift, int Nn, int C) {
  __shared__ float s1[RED_Y][RED_X + 1];
  __shared__ float s2[RED_Y][RED_X + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * RED_X + tx;
  const int b = blockIdx.y;
  float a1 = 0.0f, a2 = 0.0f;
  if (c < C) {
    const float* hb = h + static_cast<long long>(b) * Nn * C + c;
    for (int n = ty; n < Nn; n += RED_Y) {
      const float v = round_bf16(hb[static_cast<long long>(n) * C]);
      a1 += v;
      a2 += round_bf16(v * v);
    }
  }
  s1[ty][tx] = a1;
  s2[ty][tx] = a2;
  __syncthreads();
  if (ty == 0 && c < C) {
    float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int j = 0; j < RED_Y; ++j) {
      t1 += s1[j][tx];
      t2 += s2[j][tx];
    }
    const float m = t1 / Nn;
    const float var = fmaxf(t2 / Nn - m * m, 0.0f);
    const float iv = 1.0f / sqrtf(var + IN_EPS);
    const float sc = gamma[c] * iv;
    const long long p = static_cast<long long>(b) * C + c;
    mean[p] = m;
    inv[p] = iv;
    scale[p] = sc;
    shift[p] = beta[c] - m * sc;
  }
}

// y = bf16(LeakyReLU(h * scale + shift)); xhat = bf16((h - mean) * inv)
// when xhat is given. h, y, xhat: [Bt * Nn, C]; statistics: [Bt, C].
__global__ void in_apply_kernel(const float* __restrict__ h, const float* __restrict__ mean,
                                const float* __restrict__ inv,
                                const float* __restrict__ scale,
                                const float* __restrict__ shift, bf16* __restrict__ y,
                                bf16* __restrict__ xhat, long long total, int Nn, int C,
                                float slope) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long r = i / C;
    const int c = static_cast<int>(i - r * C);
    const long long p = (r / Nn) * C + c;
    const float hv = h[i];
    const float z = hv * scale[p] + shift[p];
    y[i] = __float2bfloat16(z >= 0.0f ? z : slope * z);
    if (xhat) xhat[i] = __float2bfloat16((hv - mean[p]) * inv[p]);
  }
}

// dz from the upstream gradient dy (f32, rounded to bf16 here) and the
// mask of zb = bf16(bf16(xhat * bf16(gamma)) + bf16(beta)) >= 0.
__device__ __forceinline__ float leaky_grad(float dy, float xh, float gb, float bb, float sl) {
  const float d = round_bf16(dy);
  const float zb = round_bf16(round_bf16(xh * gb) + bb);
  return zb >= 0.0f ? d : round_bf16(sl * d);
}

// Per (item b = blockIdx.y, channel c): r1 = sum dz, r2 = sum bf16(dz *
// xhat) over the item's rows, and the folded constants a_b = bf16(gamma *
// inv), c2_b = bf16(a * r2 / Nn), c1_b = bf16(a * r1 / Nn).
__global__ void __launch_bounds__(RED_X * RED_Y)
bwd_reduce_kernel(const float* __restrict__ dy, const bf16* __restrict__ xhat,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ inv, float* __restrict__ r1o,
                  float* __restrict__ r2o, float* __restrict__ ab, float* __restrict__ c1b,
                  float* __restrict__ c2b, int Nn, int C, float slope) {
  __shared__ float s1[RED_Y][RED_X + 1];
  __shared__ float s2[RED_Y][RED_X + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * RED_X + tx;
  const int b = blockIdx.y;
  float a1 = 0.0f, a2 = 0.0f;
  if (c < C) {
    const float gb = round_bf16(gamma[c]), bb = round_bf16(beta[c]), sl = round_bf16(slope);
    const long long base = static_cast<long long>(b) * Nn * C + c;
    for (int n = ty; n < Nn; n += RED_Y) {
      const long long i = base + static_cast<long long>(n) * C;
      const float xh = __bfloat162float(xhat[i]);
      const float dz = leaky_grad(dy[i], xh, gb, bb, sl);
      a1 += dz;
      a2 += round_bf16(dz * xh);
    }
  }
  s1[ty][tx] = a1;
  s2[ty][tx] = a2;
  __syncthreads();
  if (ty == 0 && c < C) {
    float r1 = 0.0f, r2 = 0.0f;
#pragma unroll
    for (int j = 0; j < RED_Y; ++j) {
      r1 += s1[j][tx];
      r2 += s2[j][tx];
    }
    const long long p = static_cast<long long>(b) * C + c;
    const float a = gamma[c] * inv[p];
    r1o[p] = r1;
    r2o[p] = r2;
    ab[p] = round_bf16(a);
    c2b[p] = round_bf16(a * (r2 / Nn));
    c1b[p] = round_bf16(a * (r1 / Nn));
  }
}

// dgamma[c] = sum_b r2[b, c], dbeta[c] = sum_b r1[b, c], b in order.
__global__ void sum_items_kernel(const float* __restrict__ r1, const float* __restrict__ r2,
                                 float* __restrict__ dgamma, float* __restrict__ dbeta,
                                 int Bt, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s1 = 0.0f, s2 = 0.0f;
  for (int b = 0; b < Bt; ++b) {
    s1 += r1[static_cast<long long>(b) * C + c];
    s2 += r2[static_cast<long long>(b) * C + c];
  }
  dbeta[c] = s1;
  dgamma[c] = s2;
}

// dh = bf16(bf16(bf16(dz * a_b) - bf16(xhat * c2_b)) - c1_b).
__global__ void bwd_dh_kernel(const float* __restrict__ dy, const bf16* __restrict__ xhat,
                              const float* __restrict__ gamma, const float* __restrict__ beta,
                              const float* __restrict__ ab, const float* __restrict__ c1b,
                              const float* __restrict__ c2b, bf16* __restrict__ dh,
                              long long total, int Nn, int C, float slope) {
  const float sl = round_bf16(slope);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long r = i / C;
    const int c = static_cast<int>(i - r * C);
    const long long p = (r / Nn) * C + c;
    const float xh = __bfloat162float(xhat[i]);
    const float dz = leaky_grad(dy[i], xh, round_bf16(gamma[c]), round_bf16(beta[c]), sl);
    const float t1 = round_bf16(dz * ab[p]);
    const float t2 = round_bf16(xh * c2b[p]);
    const float t3 = round_bf16(t1 - t2);
    dh[i] = __float2bfloat16(t3 - c1b[p]);
  }
}

// out[c] = sum over rows of x[row, c] (bf16 in, f32 sums).
__global__ void __launch_bounds__(RED_X * RED_Y)
colsum_bf16_kernel(const bf16* __restrict__ x, float* __restrict__ out, long long rows, int C) {
  __shared__ float s[RED_Y][RED_X + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * RED_X + tx;
  float a = 0.0f;
  if (c < C)
    for (long long r = ty; r < rows; r += RED_Y) a += __bfloat162float(x[r * C + c]);
  s[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && c < C) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < RED_Y; ++j) t += s[j][tx];
    out[c] = t;
  }
}

int ew_blocks(long long n) {
  const long long b = (n + EW_THREADS - 1) / EW_THREADS;
  return static_cast<int>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Every function launches on `stream`, allocates nothing and returns
// cudaGetLastError() after its launches. Tensors are contiguous device
// buffers; bf16 is __nv_bfloat16.

extern "C" int mlp_gemm(const void* A, const void* B, float* C, const float* bias, int M, int N,
                        int K, int lda, int ldb, int ldc, int a_t, int b_t, int splits,
                        long long split_stride, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int kps = (K + splits - 1) / splits;
  kps = (kps + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const auto s = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  if (!a_t && b_t)
    gemm_bf16_kernel<false, true><<<grid, GEMM_THREADS, 0, s>>>(a, b, C, bias, M, N, K, lda,
                                                                ldb, ldc, kps, split_stride);
  else if (a_t && !b_t)
    gemm_bf16_kernel<true, false><<<grid, GEMM_THREADS, 0, s>>>(a, b, C, bias, M, N, K, lda,
                                                                ldb, ldc, kps, split_stride);
  else if (!a_t && !b_t)
    gemm_bf16_kernel<false, false><<<grid, GEMM_THREADS, 0, s>>>(a, b, C, bias, M, N, K, lda,
                                                                 ldb, ldc, kps, split_stride);
  else
    gemm_bf16_kernel<true, true><<<grid, GEMM_THREADS, 0, s>>>(a, b, C, bias, M, N, K, lda,
                                                               ldb, ldc, kps, split_stride);
  return last_error();
}

extern "C" int mlp_sum_splits(const float* part, float* out, long long mn, int splits,
                              void* stream) {
  sum_splits_kernel<<<ew_blocks(mn), EW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      part, out, mn, splits);
  return last_error();
}

extern "C" int mlp_cast_bf16(const float* x, void* y, long long n, void* stream) {
  cast_bf16_kernel<<<ew_blocks(n), EW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<bf16*>(y), n);
  return last_error();
}

extern "C" int mlp_in_stats(const float* h, const float* gamma, const float* beta, float* mean,
                            float* inv, float* scale, float* shift, int Bt, int Nn, int C,
                            void* stream) {
  const dim3 grid((C + RED_X - 1) / RED_X, Bt);
  in_stats_kernel<<<grid, dim3(RED_X, RED_Y), 0, static_cast<cudaStream_t>(stream)>>>(
      h, gamma, beta, mean, inv, scale, shift, Nn, C);
  return last_error();
}

extern "C" int mlp_in_apply(const float* h, const float* mean, const float* inv,
                            const float* scale, const float* shift, void* y, void* xhat,
                            int Bt, int Nn, int C, float slope, void* stream) {
  const long long total = static_cast<long long>(Bt) * Nn * C;
  in_apply_kernel<<<ew_blocks(total), EW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      h, mean, inv, scale, shift, static_cast<bf16*>(y), static_cast<bf16*>(xhat), total, Nn,
      C, slope);
  return last_error();
}

extern "C" int mlp_bwd_reduce(const float* dy, const void* xhat, const float* gamma,
                              const float* beta, const float* inv, float* r1, float* r2,
                              float* ab, float* c1b, float* c2b, int Bt, int Nn, int C,
                              float slope, void* stream) {
  const dim3 grid((C + RED_X - 1) / RED_X, Bt);
  bwd_reduce_kernel<<<grid, dim3(RED_X, RED_Y), 0, static_cast<cudaStream_t>(stream)>>>(
      dy, static_cast<const bf16*>(xhat), gamma, beta, inv, r1, r2, ab, c1b, c2b, Nn, C,
      slope);
  return last_error();
}

extern "C" int mlp_sum_items(const float* r1, const float* r2, float* dgamma, float* dbeta,
                             int Bt, int C, void* stream) {
  sum_items_kernel<<<(C + EW_THREADS - 1) / EW_THREADS, EW_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(r1, r2, dgamma, dbeta, Bt, C);
  return last_error();
}

extern "C" int mlp_bwd_dh(const float* dy, const void* xhat, const float* gamma,
                          const float* beta, const float* ab, const float* c1b,
                          const float* c2b, void* dh, int Bt, int Nn, int C, float slope,
                          void* stream) {
  const long long total = static_cast<long long>(Bt) * Nn * C;
  bwd_dh_kernel<<<ew_blocks(total), EW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dy, static_cast<const bf16*>(xhat), gamma, beta, ab, c1b, c2b, static_cast<bf16*>(dh),
      total, Nn, C, slope);
  return last_error();
}

extern "C" int mlp_colsum_bf16(const void* x, float* out, long long rows, int C, void* stream) {
  colsum_bf16_kernel<<<(C + RED_X - 1) / RED_X, dim3(RED_X, RED_Y), 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(x), out,
                                                            rows, C);
  return last_error();
}
