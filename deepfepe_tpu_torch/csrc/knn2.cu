// Brute-force two nearest neighbours over L2 (S3), float32 descriptors.
//
// No TPU kernel is replaced: the JAX package matches SIFT descriptors with
// OpenCV on the host (deepfepe_tpu/data/dump_kitti.py:56,
// cv2.BFMatcher().knnMatch(des1, des2, k=2), in `knn_match`). For each
// query row i of des1 [N1, D] this finds the two train rows j of des2
// [N2, D] nearest in sqrt(sum (des1[i] - des2[j])^2), as OpenCV's
// batchDistance does: distances compared as floats with a strict <, rows
// visited in ascending j, so of equal distances the lower train index comes
// first. SIFT descriptors hold integers up to 255, so every partial sum of
// squared differences is an integer below 2^24 and exact in float32 in any
// order; the square root is IEEE's (no fast math), so the distances equal
// OpenCV's bit for bit. Lowe's ratio test and the quality columns are left
// to the wrapper (ops/knn2.py), in float64 as the JAX package's Python does.
//
// What bounds it. The function needs N1 N2 D multiply-adds, in the form
// |a|^2 + |b|^2 - 2 a.b (the norms are O((N1 + N2) D)). Descriptors hold
// integers 0-255, so one pass of u8 tensor-core products with int32 sums is
// exact: at N1 = N2 = 2000, D = 128 that is 1.0 TOP, 0.52 us at the card's
// 1,979 TOP/s, under the 2.1 MB of descriptors and results at 3.35 TB/s,
// 0.62 us. Bound by bytes. This kernel takes the difference form on the
// CUDA cores (3 FP32 operations an entry: 23 us at 67 TFLOP/s alone), so
// it stays far from that bound; a tensor-core form is its redesign.
//
// Design. Two launches a call.
// - `knn2_tile_kernel`: a block per (128 query rows, CHUNK train rows),
//   a thread a query row held in registers; the chunk's train rows stream
//   through shared memory TILE rows at a time; each thread keeps its best
//   two (distance, index) of the chunk and writes them as a partial.
// - `knn2_fold_kernel`: a thread a query row folds the chunks' partials in
//   ascending chunk order with the same strict <, which keeps OpenCV's
//   order among equal distances. No atomics: the result is deterministic.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int D = 128;        // SIFT's descriptor length
constexpr int ROWS = 128;     // query rows a block (one a thread)
constexpr int CHUNK = 256;    // train rows a block
constexpr int TILE = 32;      // train rows in shared memory at a time

struct Best2 {
  float d0, d1;
  int i0, i1;
};

__device__ __forceinline__ void insert(Best2& b, float d, int j) {
  if (d < b.d1) {
    if (d < b.d0) {
      b.d1 = b.d0;
      b.i1 = b.i0;
      b.d0 = d;
      b.i0 = j;
    } else {
      b.d1 = d;
      b.i1 = j;
    }
  }
}

__global__ void __launch_bounds__(ROWS)
knn2_tile_kernel(const float* __restrict__ q, const float* __restrict__ t, int n1, int n2,
                 float4* __restrict__ part) {
  __shared__ float4 tile[TILE][D / 4];
  const int row = blockIdx.x * ROWS + threadIdx.x;
  const int j0 = blockIdx.y * CHUNK, j1 = min(n2, j0 + CHUNK);
  float4 x[D / 4];
  const float* qr = q + static_cast<long long>(min(row, n1 - 1)) * D;
  const float4* qrow = reinterpret_cast<const float4*>(qr);
#pragma unroll
  for (int k = 0; k < D / 4; ++k) x[k] = qrow[k];
  Best2 b{FLT_MAX, FLT_MAX, -1, -1};
  for (int base = j0; base < j1; base += TILE) {
    const int rows = min(TILE, j1 - base);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * (D / 4); e += ROWS) {
      const float* tr = t + static_cast<long long>(base + e / (D / 4)) * D;
      tile[e / (D / 4)][e % (D / 4)] = reinterpret_cast<const float4*>(tr)[e % (D / 4)];
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < D / 4; ++k) {
        const float4 y = tile[r][k];
        const float a = x[k].x - y.x, bb = x[k].y - y.y, c = x[k].z - y.z, d = x[k].w - y.w;
        s = fmaf(a, a, s);
        s = fmaf(bb, bb, s);
        s = fmaf(c, c, s);
        s = fmaf(d, d, s);
      }
      insert(b, sqrtf(s), base + r);
    }
  }
  if (row < n1)
    part[static_cast<long long>(blockIdx.y) * n1 + row] =
        make_float4(b.d0, b.d1, __int_as_float(b.i0), __int_as_float(b.i1));
}

__global__ void knn2_fold_kernel(const float4* __restrict__ part, int n1, int chunks,
                                 int* __restrict__ nn, float* __restrict__ dist) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n1) return;
  Best2 b{FLT_MAX, FLT_MAX, -1, -1};
  for (int c = 0; c < chunks; ++c) {
    const float4 p = part[static_cast<long long>(c) * n1 + row];
    const int i0 = __float_as_int(p.z), i1 = __float_as_int(p.w);
    if (i0 >= 0) insert(b, p.x, i0);
    if (i1 >= 0) insert(b, p.y, i1);
  }
  nn[2 * row] = b.i0;
  nn[2 * row + 1] = b.i1;
  dist[2 * row] = b.d0;
  dist[2 * row + 1] = b.d1;
}

}  // namespace

extern "C" long long knn2_scratch_bytes(int n1, int n2) {
  const long long chunks = (n2 + CHUNK - 1) / CHUNK;
  return chunks * n1 * static_cast<long long>(sizeof(float4));
}

// q [n1, 128], t [n2, 128] float32, 16-byte aligned; nn [n1, 2] int32 and
// dist [n1, 2] float32 (index -1 and FLT_MAX where the train set has fewer
// rows). Returns the launches' cudaError (0 when both were accepted).
extern "C" int knn2_f32(const float* q, const float* t, int n1, int n2, int* nn, float* dist,
                        void* scratch, cudaStream_t stream) {
  if (n1 <= 0 || n2 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n2 + CHUNK - 1) / CHUNK;
  float4* part = static_cast<float4*>(scratch);
  knn2_tile_kernel<<<dim3((n1 + ROWS - 1) / ROWS, chunks), ROWS, 0, stream>>>(q, t, n1, n2, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  knn2_fold_kernel<<<(n1 + 255) / 256, 256, 0, stream>>>(part, n1, chunks, nn, dist);
  return static_cast<int>(cudaGetLastError());
}
