// Batched eigendecomposition of symmetric 9x9 matrices by cyclic Jacobi.
//
// Replaces the TPU kernel `_eigh9_kernel` in
// deepfepe_tpu/ops/pallas/eigh9_pallas.py (wrapper `eigh9_pallas`). It
// computes what `eigh9_pallas` returns: G = (A + A^T) / 2, `sweeps` fixed
// cyclic sweeps of the 36 (p, q) rotations, then the eigenvalues (the
// diagonal) sorted ascending with their eigenvector columns and the
// largest-|.| component of each eigenvector made positive. Its plain
// version is ops/jacobi.py `jacobi_eigh`, and the epilogue follows it:
// a stable ascending sort (torch.argsort(stable=True): equal values keep
// their order, NaN last) and the pivot of torch.argmax (first index on
// equal |V|, NaN first). A call is one launch; no torch operation follows.
//
// What bounds it. Per matrix: 7 sweeps x 36 rotations x ~180 flops, about
// 45 kFLOP, against 324 B read and 360 B written. At B = 4096 that is
// 2.8 us of the card's 67 TFLOP/s FP32 rate against 0.84 us of 3.35 TB/s,
// so on paper it is bound by operations. At the solver's small batches
// (B = 4 to 800) the card is nearly empty and the time is the latency of
// one matrix's 252 dependent rotations. Each rotation's angle is a chain
// of three IEEE divisions and two IEEE square roots (tau, t, c), each one
// waiting on the last and on the previous rotation's G: several hundred
// cycles that no layout removes while the rotations and their rounding
// stay the plain version's.
//
// Design. Two kernels in one source, picked by the wrapper from B
// (ops/eigh9.py `route`), with the same arithmetic in the same order, so
// they agree bit for bit with each other and with the plain version:
// - `eigh9_warp_kernel`, small B: a warp owns a matrix, and lane k < 9
//   holds row k of G and of V in registers (each sweep's 36 rotations
//   unrolled, so every index is static). Every lane takes app, aqq and
//   apq by shuffles from lanes p and q and computes c and s; lanes p and
//   q trade their rows by 9 shuffles and rotate them; then every lane
//   rotates columns p and q of its own rows of G and V. So a rotation adds
//   two shuffle round trips to its angle chain, where the thread kernel
//   adds 54 serial shared-memory read-modify-writes. The cyclic (p, q)
//   order is kept: the rotations are the plain version's.
// - `eigh9_thread_kernel`, large B: one thread owns one matrix, so 32
//   matrices share a warp's instructions. G and V live in shared memory
//   entry-major with a stride of TPB + 1 words, s[e * (TPB + 1) + tid]:
//   consecutive threads touch consecutive banks in the rotation loops, and
//   the odd stride keeps the coalesced loads and stores free of bank
//   conflicts. The sweep and (p, q) loops stay rolled.
// Both fuse what the TPU kernel's wrapper does around it: the symmetrize
// on load and, after the sweeps, the stable sort and the sign fix.
// The numerics are the TPU kernel's: small = |apq| <= 1e-12 sqrt(|app aqq|
// + 1e-12); t = sign(tau) / (|tau| + sqrt(1 + tau^2)), t = 1 at tau == 0;
// c = 1 / sqrt(1 + t^2), s = t c. Every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: no contraction into FMA), with IEEE sqrtf and
// division, as the plain version's separate tensor operations round. The
// approximate rsqrtf (2 ulp) once left V about 3e-6 from orthogonal, and
// the safe_eigh backward amplified that into a float32 train step's
// gradients 1.6% from float64 (NVIDIA H100 80GB HBM3, 700 W; ROADMAP.md
// Queue 3).

#include <cuda_runtime.h>

namespace {

constexpr int N = 9;
constexpr int N2 = N * N;
constexpr float EPS = 1e-12f;
constexpr int TPB = 64;        // thread kernel: matrices (threads) per block
constexpr int LD = TPB + 1;    // thread kernel: shared-memory stride of one entry
constexpr int WPB = 4;         // warp kernel: matrices (warps) per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sym(float a, float b) {
  return __fmul_rn(__fadd_rn(a, b), 0.5f);
}

// The rotation that annihilates G[p, q].
__device__ __forceinline__ void angle(float app, float aqq, float apq, float& c, float& s) {
  const bool small =
      fabsf(apq) <= __fmul_rn(EPS, sqrtf(__fadd_rn(fabsf(__fmul_rn(app, aqq)), EPS)));
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), __fmul_rn(2.0f, small ? 1.0f : apq));
  float t = __fdiv_rn(copysignf(1.0f, tau),
                      __fadd_rn(fabsf(tau), sqrtf(__fadd_rn(1.0f, __fmul_rn(tau, tau)))));
  if (tau == 0.0f) t = 1.0f;
  c = __fdiv_rn(1.0f, sqrtf(__fadd_rn(1.0f, __fmul_rn(t, t))));
  s = __fmul_rn(t, c);
  if (small) {
    c = 1.0f;
    s = 0.0f;
  }
}

// (x, y) <- (c x - s y, s x + c y).
__device__ __forceinline__ void rotate(float c, float s, float& x, float& y) {
  const float a = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
  const float b = __fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y));
  x = a;
  y = b;
}

// torch.sort's order for floats: NaN after every number.
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (b != b && a == a);
}

// Position of eigenvalue j (wj = w[j]) after a stable ascending sort of
// w[0..8].
__device__ __forceinline__ int rank_of(const float* w, float wj, int j) {
  int r = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float wi = w[i];
    r += before(wi, wj) || (i < j && !before(wj, wi));
  }
  return r;
}

// Whether eigenvector column x[0..8] flips: its pivot, the first entry of
// largest |.| (the first NaN if any, as torch.argmax), is negative.
__device__ __forceinline__ bool flips(const float* x) {
  float best = fabsf(x[0]), pivot = x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const float a = fabsf(x[k]);
    if (a > best || (a != a && best == best)) {
      best = a;
      pivot = x[k];
    }
  }
  return pivot < 0.0f;
}

__global__ void __launch_bounds__(WPB * 32)
eigh9_warp_kernel(const float* __restrict__ A, float* __restrict__ w,
                  float* __restrict__ V, int B, int sweeps) {
  __shared__ float st[WPB][N2];  // the epilogue's transpose of V
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long m = static_cast<long long>(blockIdx.x) * WPB + warp;
  if (m >= B) return;  // a whole warp; the block never synchronizes
  // Lane k < 9 holds row k of G and of V; lanes 9-31 shadow row 0 and
  // store nothing.
  const int k = lane < N ? lane : 0;
  const float* a = A + m * N2;
  float g[N], v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    g[j] = sym(a[k * N + j], a[j * N + k]);
    v[j] = j == k ? 1.0f : 0.0f;
  }

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float app = __shfl_sync(FULL, g[p], p);
        const float aqq = __shfl_sync(FULL, g[q], q);
        const float apq = __shfl_sync(FULL, g[q], p);
        float c, s;
        angle(app, aqq, apq, c, s);
        // Rows p and q of G: lanes p and q trade their rows.
        const int partner = lane == p ? q : p;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float o = __shfl_sync(FULL, g[j], partner);
          float x = lane == q ? o : g[j];  // G[p, j]
          float y = lane == q ? g[j] : o;  // G[q, j]
          rotate(c, s, x, y);
          g[j] = lane == p ? x : lane == q ? y : g[j];
        }
        // Columns p and q of G (keeps it symmetric) and of V: each lane
        // its own row.
        rotate(c, s, g[p], g[q]);
        rotate(c, s, v[p], v[q]);
      }
    }
  }

  // Every lane reads the diagonal; lane j < 9 finds eigenvector j's sign
  // from the transposed V; lane k < 9 stores row k at the sorted columns.
  float d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = __shfl_sync(FULL, g[i], i);
  float* t = st[warp];
  if (lane < N) {
#pragma unroll
    for (int j = 0; j < N; ++j) t[lane * N + j] = v[j];
  }
  __syncwarp();
  bool flip = false;
  if (lane < N) {
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = t[i * N + lane];
    flip = flips(x);
  }
  const unsigned flipped = __ballot_sync(FULL, flip);
  if (lane < N) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int r = rank_of(d, d[j], j);
      if (lane == j) w[m * N + r] = d[j];
      V[m * N2 + lane * N + r] = (flipped >> j) & 1u ? -v[j] : v[j];
    }
  }
}

__global__ void __launch_bounds__(TPB)
eigh9_thread_kernel(const float* __restrict__ A, float* __restrict__ w,
                    float* __restrict__ V, int B, int sweeps) {
  __shared__ float sg[N2 * LD];
  __shared__ float sv[N2 * LD];
  __shared__ float sw[N * LD];
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * TPB;
  const int count = min(TPB, static_cast<int>(B - first));

  // Coalesced load of the block's matrices (contiguous [count, 81] floats);
  // the ragged tail of the last block is zero-filled and never written out.
  const float* a = A + first * N2;
  for (int i = tid; i < TPB * N2; i += TPB) {
    const int m = i / N2;
    const int e = i - m * N2;
    sg[e * LD + m] = (m < count) ? a[i] : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < N2; ++e) {
    sv[e * LD + tid] = (e / N == e % N) ? 1.0f : 0.0f;
  }
  __syncthreads();

  float* g = sg + tid;
  float* v = sv + tid;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) {
      const float x = sym(g[(i * N + j) * LD], g[(j * N + i) * LD]);
      g[(i * N + j) * LD] = x;
      g[(j * N + i) * LD] = x;
    }
  }
#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll 1
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll 1
      for (int q = p + 1; q < N; ++q) {
        float c, s;
        angle(g[(p * N + p) * LD], g[(q * N + q) * LD], g[(p * N + q) * LD], c, s);
        // Rows p and q of G.
#pragma unroll
        for (int k = 0; k < N; ++k) {
          float x = g[(p * N + k) * LD], y = g[(q * N + k) * LD];
          rotate(c, s, x, y);
          g[(p * N + k) * LD] = x;
          g[(q * N + k) * LD] = y;
        }
        // Columns p and q of G (keeps it symmetric).
#pragma unroll
        for (int k = 0; k < N; ++k) {
          float x = g[(k * N + p) * LD], y = g[(k * N + q) * LD];
          rotate(c, s, x, y);
          g[(k * N + p) * LD] = x;
          g[(k * N + q) * LD] = y;
        }
        // V <- V @ J: columns p and q.
#pragma unroll
        for (int k = 0; k < N; ++k) {
          float x = v[(k * N + p) * LD], y = v[(k * N + q) * LD];
          rotate(c, s, x, y);
          v[(k * N + p) * LD] = x;
          v[(k * N + q) * LD] = y;
        }
      }
    }
  }

  // Each thread writes its sorted, sign-fixed eigenpairs over its own G
  // column (V) and into sw (w); then the block stores them coalesced.
  float d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = g[(i * N + i) * LD];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = v[(i * N + j) * LD];
    const int r = rank_of(d, d[j], j);
    const bool neg = flips(x);
    sw[r * LD + tid] = d[j];
#pragma unroll
    for (int i = 0; i < N; ++i) g[(i * N + r) * LD] = neg ? -x[i] : x[i];
  }
  __syncthreads();

  float* vo = V + first * N2;
  for (int i = tid; i < TPB * N2; i += TPB) {
    const int m = i / N2;
    const int e = i - m * N2;
    if (m < count) vo[i] = sg[e * LD + m];
  }
  float* wo = w + first * N;
  for (int i = tid; i < TPB * N; i += TPB) {
    const int m = i / N;
    const int d = i - m * N;
    if (m < count) wo[i] = sw[d * LD + m];
  }
}

}  // namespace

// A: [B, 81] row-major, symmetrized here; w: [B, 9] ascending; V: [B, 81]
// (V[b, k*9 + j] is component k of eigenvector j). All float32,
// contiguous, on the device. Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int eigh9_warp_f32(const float* A, float* w, float* V, int B, int sweeps,
                              void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + WPB - 1) / WPB;
  eigh9_warp_kernel<<<blocks, WPB * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      A, w, V, B, sweeps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int eigh9_thread_f32(const float* A, float* w, float* V, int B, int sweeps,
                                void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + TPB - 1) / TPB;
  eigh9_thread_kernel<<<blocks, TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      A, w, V, B, sweeps);
  return static_cast<int>(cudaGetLastError());
}
