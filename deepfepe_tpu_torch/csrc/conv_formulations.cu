// The 64 -> 64 fused 3x3 SAME convolution + per-channel affine + ReLU in
// bf16 on the tensor cores, in four formulations: the counterparts of the
// conv-formulation shootout tools/bench_conv_formulations.py (X1-X4).
//
// Every kernel computes, in NHWC with x [B, H, W, 64] and y [B, H, W, 64]
// bf16, w packed bf16, s and t [64] float32,
//     y[b, i, j, c] = bf16(relu(s[c] * sum_{ky, kx, ci} x[b, i+ky-1, j+kx-1, ci]
//                                             * w[ky, kx, ci, c] + t[c]))
// with zero padding outside each image. Products take bf16 operands with
// float32 accumulators; the epilogue computes acc * s, then + t (two
// roundings, no FMA, as the plain versions in ops/conv_formulations.py do),
// the ReLU, and rounds once to bf16.
//
// They replace the TPU kernels of tools/bench_conv_formulations.py:
//   X4 conv_strip        `_k_taps9`, `_k_ky3`, `_k_im2col` (make_fn): a block per
//                        (image, th-row strip) that walks the strip's chunks of
//                        th x tw = 128 or 256 pixels left to right.
//   X3 conv_tile2d       `_k_t4` (make_t4_fn): one block per th x tw = 128
//                        output tile with its halo, no loop inside the block.
//   X1 conv_strip_async  `_k_dma` (make_dma_fn): ky3 and im2col, persistent
//                        blocks over th x tw = 128-pixel items: the halo by
//                        TMA into a ring of mbarrier stages, the counterpart
//                        of make_async_copy with two semaphores.
//   X2 conv_s2d          `_k_s2d` (make_s2d_fn): X1 on the free
//                        space-to-depth view [B, H, W/2, 128] of x, th x tg =
//                        128 group items with 128-wide output rows (two
//                        pixels), from pack_w_s2d (s2dc: K = 3 x 384 through a
//                        patch) or pack_w_s2d9 (s2d9: 9 products of K = 128
//                        straight from the halo). Half of the packed weights
//                        are structural zeros, so s2d does 2x the useful FLOPs
//                        by construction (the tool's "1.5x" comment is wrong).
//
// Every block reads its halo from the unpadded x and writes zeros outside
// the image: the TPU needs `_fold_rows` / `_fold_groups` only because a
// BlockSpec cannot express overlapping windows, and on the card they would
// add a full read and write of x. Only the weights are packed, by the
// wrapper.
//
// What bounds them. At SuperPointNetGauss2's inc.conv1 (B = 8, 376 x 1240,
// 64 -> 64) the useful work is 2.750e11 FLOP, 0.278 ms at 989 TFLOP/s bf16,
// and x and y are 954.9 MB, 0.285 ms at 3.35 TB/s: the function is bound by
// bytes, just. s2d's own floor is 0.556 ms (2x the FLOPs).
//
// All four run one kernel, `conv_wgmma_kernel`, built for Hopper:
//   * Work items of th x tw output pixels (X2: groups), 64 nwg of them for
//     nwg consumer warpgroups: 128, or 256 for X4. The formulations differ
//     in how blocks take items (the kernel's FAMILY): X1 and X2 persistent,
//     one block an SM walking items k, k + grid, ...; X4 a block per strip
//     walking its chunks in order; X3 a block per item.
//   * A producer warp: one thread issues, per item, one TMA load of the
//     4-D box [1, th+2, tw+2, 64] of x (two, one per 64-channel half, for
//     X2's 128-channel groups) at (b, r0-1, c0-1); TMA's zero fill outside
//     the tensor gives the SAME padding. The box lands under the 128-byte
//     swizzle (one pixel's 64 channels a 128-byte row) in a ring of 2-4
//     stages (X3: one), each with a full and an empty mbarrier. X4's
//     producer so brings the strip's next chunks while the consumers run
//     this one.
//   * Weights by TMA in wgmma's MN-major layout ([64 k][64 n] boxes, 128-byte
//     swizzle): for 64 channels 73,728 bytes once a block, resident; X2's
//     294,912 bytes (more than a block's shared memory) streamed per K slice
//     of 64 rows (16 KB) through their own ring of full and empty mbarriers.
//     X3's blocks each load all nine boxes for one item of 128 pixels, 3.2x
//     the item's x and y. Clusters of 2 blocks along W sharing them by TMA
//     multicast (half the L2 reads) took 4-19% longer than no clusters,
//     and 4 longer still: the blocks are bound by their own fill and round
//     trips, not by L2, and a cluster adds its barriers and co-scheduling
//     (PERF.md).
//   * nwg consumer warpgroups, each one 64-row M tile of the item, run
//     `wgmma.m64n64k16` (two of them a k step for X2's N = 128) with float32
//     accumulators in registers, over K slices of 64 (9: one a tap, for 64
//     channels; 18 for X2: a tap's two channel halves). A comes either
//       - from registers, by `ldmatrix` on the swizzled halo (taps9, ky3,
//         s2d9): any 8 consecutive pixels at one 16-byte chunk fall in 8
//         distinct bank groups at any kx shift, so the reads are free of
//         conflicts; taps9 and ky3 differ only in the order of their K
//         slices (tap-major, as pack_w's [3, 3, 64, 64]; kx-major); or
//       - from a patch (im2col, s2dc), built per K slice into a two-slot ring
//         of swizzled [64][64] tiles, each warp its own 16 rows, and read by
//         descriptor; building slice k+1 overlaps slice k's products (X3:
//         one slot, `patch_slots`, rebuilt after them).
//     A ring slot, a patch slot or a weight stage is reused only after every
//     consumer's last `wgmma` on it has completed: each consumer thread
//     arrives on the empty barrier after its `wgmma.wait_group`.
//   * The epilogue from registers: the affine, the ReLU, bf16 packing, a
//     transpose within each quad of lanes by shuffles, 16-byte stores of
//     the rows inside the image.
// A warpgroup waits for each slice's products (wait_group 0) once the next
// slice's A is issued; keeping a slice in flight (wait_group 1) measured no
// faster. Occupancy: X1, X2 and X4 fill a block's shared memory (one an
// SM; X4's 752 blocks at th = 4 are 5.7 waves); X3's blocks (ky3 99 KB,
// im2col 115 KB with its one patch slot a warpgroup; at most 112
// registers a thread) fit two an SM, so one block's prologue and weight
// wait overlap the other's products.
//
// Where the time goes (NVIDIA H100 80GB HBM3, 700 W; variants of this file
// with parts cut out, tools/xconv_variants.py): X1's ky3 takes about 0.72
// ms, of which the halo's TMA stream alone is 0.36 and the ldmatrix reads
// add 0.18 that the products do not hide; X4 the same work in 0.63 ms
// (taps9 at 4 x 64: four warpgroups, the halo stream alone 0.28) to 0.80
// (ky3 at 4 x 32); s2d9 about 1.2 ms, of which 0.72 is the stream of the
// halo and the 18 weight slices an item, bound by their round trips
// through the ring rather than their bytes (half the weight bytes saved
// 2-4%). X3 (0.80 ms ky3, 1.03 im2col) splits as X1 does: its blocks'
// weight and halo fills alone take 0.38-0.39 ms (every block fills 72 KB
// of weights for 128 pixels), the A reads 0.21 more (im2col's patch
// 0.33), the products 0.15-0.27.

#include "hopper_common.cuh"

namespace {

constexpr int C = 64;                    // channels in and out
constexpr long long SMEM_MAX = 232448;   // a block's shared memory on Hopper

// Formulation and family codes of the C interface (ops/conv_formulations.py).
constexpr int TAPS9 = 0, KY3 = 1, IM2COL = 2, S2DC = 3, S2D9 = 4;
constexpr int STRIP = 0, STRIP_ASYNC = 1, TILE2D = 2, S2D = 3;

constexpr int TILE_ROWS = 128;           // output pixels (groups for X2) of a two-warpgroup item
constexpr int BOX = 8192;                // a [64][64] bf16 tile: 64 rows of 128 bytes
constexpr int MAX_HALO_STAGES = 4;
constexpr int MAX_W_STAGES = 6;
constexpr int TAIL_BYTES = 768;          // the barriers (256 bytes), then s and t
constexpr int ERR_TENSOR_MAP = 9001;     // cuTensorMapEncodeTiled missing or refused

// The shared memory of a block, in bytes from its 1024-aligned base: the
// halo ring, the weights (resident for 64 channels, X2's ring of K slices),
// the patch slots, the barriers with s and t. nwg consumer warpgroups take
// an item of 64 nwg pixels (groups): total = -1 where no kernel takes the
// tile.
struct Layout {
  long long halo_stage;   // one stage: a box a 64-channel half, each rounded up to 1024 bytes
  int halo_stages, w_stages, nwg;
  long long weights, patch, total;
};

inline long long round1024(long long v) { return (v + 1023) / 1024 * 1024; }

// A consumer warpgroup's 8 KB patch slots (im2col, s2dc): two, slice s + 1
// built while slice s's products run; one for X3, whose block so fits two
// an SM.
__host__ __device__ constexpr int patch_slots(int family) { return family == TILE2D ? 1 : 2; }

bool takes(int family, int kind) {
  switch (family) {
    case STRIP:
      return kind == TAPS9 || kind == KY3 || kind == IM2COL;
    case STRIP_ASYNC:
    case TILE2D:
      return kind == KY3 || kind == IM2COL;
    case S2D:
      return kind == S2DC || kind == S2D9;
  }
  return false;
}

// Items of th x tw = 128 pixels (groups), or 256 for X4. Patch kinds
// (im2col, s2dc) take `patch_slots` of 8 KB a warpgroup. 64 channels: the weights
// resident beside up to 4 halo stages (at least 2; X3's one item a block
// takes 1). X2: 2 halo stages and the rest up to 6 weight stages of 16 KB.
Layout wgmma_layout(int family, int kind, int th, int tw) {
  Layout l{0, 0, 0, 0, 0, 0, -1};
  const long long rows = static_cast<long long>(th) * tw;
  if (th < 1 || tw < 1 || (rows != TILE_ROWS && !(family == STRIP && rows == 2 * TILE_ROWS)))
    return l;
  const int cin = family == S2D ? 2 * C : C;
  l.nwg = static_cast<int>(rows / 64);
  l.halo_stage = (cin / 64) * round1024(128LL * (th + 2) * (tw + 2));
  l.patch = kind == IM2COL || kind == S2DC ? 1LL * patch_slots(family) * l.nwg * BOX : 0;
  const long long room = SMEM_MAX - 1024 - TAIL_BYTES - l.patch;
  int least = 2;
  if (cin == C) {
    const long long cap = family == TILE2D ? 1 : MAX_HALO_STAGES;
    if (family == TILE2D) least = 1;
    l.weights = 9LL * BOX;
    const long long n = (room - l.weights) / l.halo_stage;
    l.halo_stages = static_cast<int>(n < cap ? n : cap);
  } else {
    l.halo_stages = 2;
    const long long n = (room - 2 * l.halo_stage) / (2 * BOX);
    l.w_stages = static_cast<int>(n < MAX_W_STAGES ? n : MAX_W_STAGES);
    l.weights = 2LL * BOX * l.w_stages;
    if (l.w_stages < 2) return l;
  }
  if (l.halo_stages < least) return l;
  l.total = 1024 + l.halo_stages * l.halo_stage + l.weights + l.patch + TAIL_BYTES;
  return l;
}

// Shared memory a block of `family` takes at tile th x tw (tw: groups for
// s2d), or -1 for a combination the kernels do not take.
long long smem_bytes(int family, int kind, int th, int tw) {
  return takes(family, kind) ? wgmma_layout(family, kind, th, tw).total : -1;
}

struct XParams {
  const float* s;
  const float* t;
  bf16* y;
  int H, Wc;                 // rows and columns (pixels, or groups for X2) of the view
  int th, tw;                // the item's tile
  int n_chunks, n_strips, per_image, n_items;
  int halo_box;              // bytes of one [th+2, tw+2, 64] box
  int halo_stage, halo_stages, w_stages;
  int weights_off, patch_off, bar_off;  // from the block's 1024-aligned base
};

// Work item `item`: image b, output rows [r0, r0 + th), columns [c0, c0 + tw).
struct Item {
  int b, r0, c0;
};

__device__ __forceinline__ Item item_at(const XParams& p, int item) {
  const int rem = item % p.per_image;
  return {item / p.per_image, (rem / p.n_chunks) * p.th, (rem % p.n_chunks) * p.tw};
}

// The block's items: first + i step for i < count. Items run image-major,
// then strip, then chunk.
struct Walk {
  int first, step, count;
};

template <int FAMILY>
__device__ __forceinline__ Walk block_walk(const XParams& p) {
  const int bx = blockIdx.x;
  if (FAMILY == STRIP)  // X4: strip bx (image-major), its chunks left to right
    return {bx * p.n_chunks, 1, p.n_chunks};
  if (FAMILY == TILE2D)  // X3: chunk bx, strip, image
    return {(static_cast<int>(blockIdx.z) * p.n_strips + static_cast<int>(blockIdx.y)) *
                    p.n_chunks + bx, 1, 1};
  const int g = gridDim.x;  // X1, X2: items bx, bx + g, ...
  return {bx, g, (p.n_items - bx + g - 1) / g};
}

// K slice s (64 rows of the packed weights, rows [64 s, 64 s + 64)) reads
// the halo at tap (ky, kx), channel half h. taps9 and im2col: [9 (ky, kx)
// 64, 64]; ky3: [3(kx), 3(ky) 64, 64]; s2dc and s2d9: [3(ky), 3(k), 2(h)
// 64, 128], kx the group offset k.
template <int KIND>
__device__ __forceinline__ void slice_tap(int s, int& ky, int& kx, int& h) {
  if (KIND == S2DC || KIND == S2D9) {
    h = s & 1;
    ky = (s >> 1) / 3;
    kx = (s >> 1) % 3;
  } else if (KIND == KY3) {
    h = 0;
    ky = s % 3;
    kx = s / 3;
  } else {  // taps9, im2col
    h = 0;
    ky = s / 3;
    kx = s % 3;
  }
}

// KIND: the formulation (s2dc and s2d9: X2's view [B, H, W/2, 128], N =
// 128; else x [B, H, W, 64], N = 64). Block: warps 0 .. 4 NWG - 1 the
// consumer warpgroups (M tiles: the item's pixels 64 wg .. 64 wg + 63,
// row-major over th x tw), warp 4 NWG the producer. A from the patch slots
// for im2col and s2dc, else by ldmatrix from the halo. FAMILY: how the
// blocks take items; X3's registers must allow two blocks an SM.
template <int KIND, int NWG, int FAMILY>
__global__ void __launch_bounds__(128 * NWG + 32, FAMILY == TILE2D ? 2 : 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const XParams p) {
  constexpr int CIN = KIND == S2DC || KIND == S2D9 ? 2 * C : C;
  constexpr bool PATCH = KIND == IM2COL || KIND == S2DC;
  constexpr int NS = CIN == C ? 9 : 18;  // K slices of 64
  constexpr int NJ = CIN / 64;            // 64-column halves of N = CIN; halo halves
  constexpr int CONSUMERS = 128 * NWG;
  constexpr int SLOTS = patch_slots(FAMILY);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* halo = smem;
  unsigned char* wsm = smem + p.weights_off;
  unsigned char* patch = smem + p.patch_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + MAX_HALO_STAGES;
  uint64_t* wfull = empty + MAX_HALO_STAGES;
  uint64_t* wempty = wfull + MAX_W_STAGES;
  uint64_t* wres = wempty + MAX_W_STAGES;
  float* sst = reinterpret_cast<float*>(smem + p.bar_off + 256);  // s[64], then t[64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half_bytes = p.halo_stage / NJ;
  const Walk wk = block_walk<FAMILY>(p);
  if (tid < C) {
    sst[tid] = p.s[tid];
    sst[C + tid] = p.t[tid];
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
      if (CIN == C) {  // the resident weights: nine [64 k][64 n] boxes
        mbar_expect(wres, NS * BOX);
        for (int s = 0; s < NS; ++s) tma_load(wsm + s * BOX, &wmap, wres, 0, 64 * s);
      }
      int u = 0;  // X2's weight slices issued
      for (int i = 0; i < wk.count; ++i) {
        const int item = wk.first + i * wk.step;  // the item whose halo this stage takes
        const Item it = item_at(p, item);
        const int hs = i % p.halo_stages;
        if (i >= p.halo_stages) mbar_wait(&empty[hs], ((i / p.halo_stages) + 1) & 1);
        mbar_expect(&full[hs], NJ * p.halo_box);  // the boxes' bytes, zero fill included
        const int hr0 = it.r0 - 1;  // the halo's top row: one above the item's rows
        const int hc0 = it.c0 - 1;  // the halo's left column: one left of the item's
        for (int h = 0; h < NJ; ++h)
          tma_load_4d(halo + hs * p.halo_stage + h * half_bytes, &xmap, &full[hs], 64 * h, hc0,
                      hr0, it.b);
        if (CIN == 2 * C) {
          for (int s = 0; s < NS; ++s, ++u) {
            const int ws = u % p.w_stages;
            if (u >= p.w_stages) mbar_wait(&wempty[ws], ((u / p.w_stages) + 1) & 1);
            mbar_expect(&wfull[ws], 2 * BOX);
            const int krow = 64 * s;  // the slice's rows of the packed weights
            tma_load(wsm + ws * 2 * BOX, &wmap, &wfull[ws], 0, krow);
            tma_load(wsm + ws * 2 * BOX + BOX, &wmap, &wfull[ws], 64, krow);
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg, warp q in it; accumulator rows g, g + 8
  // of the warp's 16, columns 8 c + 2 t and + 1 of each 64-column half.
  const int wg = warp >> 2, q = warp & 3, g = lane >> 2, t4 = lane & 3;
  // The halo row (pixel, or group) at tap (0, 0) of this lane's A row:
  // ldmatrix's rows (lanes 8 m .. 8 m + 7 address matrix m: rows 0-7, 8-15,
  // then the same at k + 8), or the patch row the lane copies.
  const int hc = p.tw + 2;
  const int arow = PATCH ? 16 * q + (lane >> 1) : 16 * q + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int apx = 64 * wg + arow;
  const int hr0 = (apx / p.tw) * hc + apx % p.tw;
  const int kc = lane >> 4;  // ldmatrix: the lane's 8-column half of a k step

  if (CIN == C) mbar_wait(wres, 0);
  int u = 0;  // X2's weight slices consumed
  for (int i = 0; i < wk.count; ++i) {
    const Item it = item_at(p, wk.first + i * wk.step);
    const int hs = i % p.halo_stages;
    mbar_wait(&full[hs], (i / p.halo_stages) & 1);
    const unsigned char* hb = halo + hs * p.halo_stage;
    // Opaque copies of the item-invariant bases: without them the compiler
    // hoists every slice's addresses and descriptors out of the item loop
    // and spills.
    int hrb = hr0;
    const unsigned char* wbase = wsm;
    asm volatile("" : "+r"(hrb), "+l"(wbase));
    float acc[NJ][32];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
    // A of slice s into register set s & 1 (taps9, ky3, s2d9: ldmatrix from
    // the halo) or patch slot s % SLOTS (im2col, s2dc: this warp's 16 rows,
    // four 16-byte chunks a lane, then the warpgroup's barrier).
    uint32_t a[2][4][4];
    auto prepare = [&](int s) {
      int ky, kx, h;
      slice_tap<KIND>(s, ky, kx, h);
      const int hr = hrb + ky * hc + kx;
      const unsigned char* src = hb + h * half_bytes;
      if (PATCH) {
        unsigned char* pb = patch + (SLOTS * wg + s % SLOTS) * BOX;
        const int j0 = (lane & 1) * 4;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          *reinterpret_cast<uint4*>(pb + swz(arow, j0 + jj)) =
              *reinterpret_cast<const uint4*>(src + swz(hr, j0 + jj));
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        wg_barrier(wg);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(a[s & 1][kk], smem_addr(src + swz(hr, 2 * kk + kc)));
      }
    };
    prepare(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const unsigned char* wb;
      if (CIN == C) {
        wb = wbase + s * BOX;
      } else {  // no products are in flight across this wait
        const int ws = (u + s) % p.w_stages;
        mbar_wait(&wfull[ws], ((u + s) / p.w_stages) & 1);
        wb = wbase + ws * 2 * BOX;
      }
      const unsigned char* pb = patch + (SLOTS * wg + s % SLOTS) * BOX;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint64_t db = sdesc(wb + j * BOX + 2048 * kk, BOX, 1024);
          if (PATCH)
            wgmma_ss(acc[j], sdesc(pb + 32 * kk, 16, 1024), db);
          else
            wgmma_rs(acc[j], a[s & 1][kk], db);
        }
      wg_commit();
      // Slice s + 1's A while slice s's products run: its registers or
      // slot last served slice s - 1, whose products are done. A single
      // slot is rebuilt once slice s's products are.
      if (s + 1 < NS && SLOTS == 2) prepare(s + 1);
      wg_wait<0>();
      if (s + 1 < NS && SLOTS == 1) prepare(s + 1);
      if (CIN == 2 * C) mbar_arrive(&wempty[(u + s) % p.w_stages]);  // slice s is done
    }
    keep(acc);
    u += NS;
    mbar_arrive(&empty[hs]);  // this thread's products on the halo are done

    // Epilogue: rows g and g + 8 of the warp, each 64-column half in two
    // blocks of four 16-byte chunks; a quad's transpose gives lane t chunk
    // t of each block.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int px = 64 * wg + 16 * q + g + 8 * hh;
      const int row = it.r0 + px / p.tw, col = it.c0 + px % p.tw;
      const bool inside = row < p.H && col < p.Wc;
      bf16* dst = p.y + ((static_cast<long long>(it.b) * p.H + row) * p.Wc + col) * CIN;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int blk = 0; blk < 2; ++blk) {
          uint32_t in[4];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int c = 4 * blk + qq;
            const float2 sc = *reinterpret_cast<const float2*>(sst + 8 * c + 2 * t4);
            const float2 sh = *reinterpret_cast<const float2*>(sst + C + 8 * c + 2 * t4);
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

bool shapes_ok(int B, int H, int W) { return B >= 1 && B <= 65535 && H >= 1 && W >= 1; }

// --- Host side -----------------------------------------------------------------

// A block of FAMILY on the view x [B, H, Wc, CIN] with the packed
// weights w [9 CIN][CIN].
template <int KIND, int NWG, int FAMILY>
int launch_wgmma(const void* x, const void* w, const float* s, const float* t, void* y, int B,
                 int H, int Wc, int th, int tw, void* stream) {
  constexpr int CIN = KIND == S2DC || KIND == S2D9 ? 2 * C : C;
  const Layout l = wgmma_layout(FAMILY, KIND, th, tw);
  const long long n_strips = (H + th - 1) / th, n_chunks = (Wc + tw - 1) / tw;
  const long long per_image = n_strips * n_chunks;
  if (l.total < 0 || l.nwg != NWG || per_image * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (FAMILY == TILE2D && n_strips > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, wm;
  const cuuint64_t xdims[4] = {CIN, static_cast<cuuint64_t>(Wc), static_cast<cuuint64_t>(H),
                               static_cast<cuuint64_t>(B)};
  const cuuint32_t xbox[4] = {64, static_cast<cuuint32_t>(tw + 2),
                              static_cast<cuuint32_t>(th + 2), 1};
  const cuuint64_t wdims[2] = {CIN, 9 * CIN};
  const cuuint32_t wbox[2] = {64, 64};
  if (!tensor_map(&xm, x, 4, xdims, xbox) || !tensor_map(&wm, w, 2, wdims, wbox))
    return ERR_TENSOR_MAP;
  XParams p{};
  p.s = s;
  p.t = t;
  p.y = static_cast<bf16*>(y);
  p.H = H;
  p.Wc = Wc;
  p.th = th;
  p.tw = tw;
  p.n_chunks = static_cast<int>(n_chunks);
  p.n_strips = static_cast<int>(n_strips);
  p.per_image = static_cast<int>(per_image);
  p.n_items = static_cast<int>(per_image * B);
  p.halo_box = 128 * (th + 2) * (tw + 2);
  p.halo_stage = static_cast<int>(l.halo_stage);
  p.halo_stages = l.halo_stages;
  p.w_stages = l.w_stages;
  p.weights_off = static_cast<int>(l.halo_stages * l.halo_stage);
  p.patch_off = static_cast<int>(p.weights_off + l.weights);
  p.bar_off = static_cast<int>(p.patch_off + l.patch);
  auto kernel = conv_wgmma_kernel<KIND, NWG, FAMILY>;
  static const cudaError_t attr = [kernel] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_MAX));
    if (e != cudaSuccess) return e;
    // All of the SM's 228 KB as shared memory: X3's ky3 blocks fit two an SM.
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                static_cast<int>(cudaSharedmemCarveoutMaxShared));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid;
  if (FAMILY == STRIP) {
    grid = dim3(static_cast<unsigned>(n_strips * B));
  } else if (FAMILY == TILE2D) {
    grid = dim3(static_cast<unsigned>(n_chunks), static_cast<unsigned>(n_strips),
                static_cast<unsigned>(B));
  } else {  // X1, X2: one block an SM, at most one an item
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    grid = dim3(p.n_items < sms ? p.n_items : sms);
  }
  kernel<<<grid, 128 * NWG + 32, static_cast<size_t>(l.total),
           static_cast<cudaStream_t>(stream)>>>(xm, wm, p);
  return static_cast<int>(cudaGetLastError());
}

// X4 at 128-pixel chunks (two warpgroups) or 256 (four).
template <int KIND>
int launch_strip(const void* x, const void* w, const float* s, const float* t, void* y, int B,
                 int H, int W, int th, int tw, void* stream) {
  if (static_cast<long long>(th) * tw == 2 * TILE_ROWS)
    return launch_wgmma<KIND, 4, STRIP>(x, w, s, t, y, B, H, W, th, tw, stream);
  return launch_wgmma<KIND, 2, STRIP>(x, w, s, t, y, B, H, W, th, tw, stream);
}

}  // namespace

// Shared memory of one block: family 0 conv_strip, 1 conv_strip_async,
// 2 conv_tile2d, 3 conv_s2d; kind 0 taps9, 1 ky3, 2 im2col, 3 s2dc, 4 s2d9;
// tw in pixels (groups for s2d). -1 for a combination no kernel takes.
extern "C" long long conv_formulations_smem_bytes(int family, int kind, int th, int tw) {
  return smem_bytes(family, kind, th, tw);
}

// X4. x [B, H, W, 64] bf16, 16-byte aligned; w bf16 packed for `kind`
// (taps9 [3, 3, 64, 64], ky3 [3, 192, 64], im2col [576, 64]), 16-byte
// aligned; s, t [64] float32; y [B, H, W, 64] bf16; th x tw = 128 or 256.
// Launches on `stream`; returns the launch's cudaError, else 0, and 9001
// when a tensor map could not be made.
extern "C" int conv_strip_bf16(const void* x, const void* w, const float* s, const float* t,
                               void* y, int B, int H, int W, int kind, int th, int tw,
                               void* stream) {
  if (!shapes_ok(B, H, W) || smem_bytes(STRIP, kind, th, tw) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == TAPS9) return launch_strip<TAPS9>(x, w, s, t, y, B, H, W, th, tw, stream);
  if (kind == KY3) return launch_strip<KY3>(x, w, s, t, y, B, H, W, th, tw, stream);
  return launch_strip<IM2COL>(x, w, s, t, y, B, H, W, th, tw, stream);
}

// X1. As conv_strip_bf16, kind ky3 or im2col, th x tw = 128.
extern "C" int conv_strip_async_bf16(const void* x, const void* w, const float* s,
                                     const float* t, void* y, int B, int H, int W, int kind,
                                     int th, int tw, void* stream) {
  if (!shapes_ok(B, H, W) || smem_bytes(STRIP_ASYNC, kind, th, tw) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == KY3)
    return launch_wgmma<KY3, 2, STRIP_ASYNC>(x, w, s, t, y, B, H, W, th, tw, stream);
  return launch_wgmma<IM2COL, 2, STRIP_ASYNC>(x, w, s, t, y, B, H, W, th, tw, stream);
}

// X3. As conv_strip_async_bf16.
extern "C" int conv_tile2d_bf16(const void* x, const void* w, const float* s, const float* t,
                                void* y, int B, int H, int W, int kind, int th, int tw,
                                void* stream) {
  if (!shapes_ok(B, H, W) || smem_bytes(TILE2D, kind, th, tw) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == KY3) return launch_wgmma<KY3, 2, TILE2D>(x, w, s, t, y, B, H, W, th, tw, stream);
  return launch_wgmma<IM2COL, 2, TILE2D>(x, w, s, t, y, B, H, W, th, tw, stream);
}

// X2. W even; w bf16 pack_w_s2d [3, 384, 128] (s2dc) or pack_w_s2d9
// [3, 3, 128, 128] (s2d9), the same memory; tg groups of two pixels a
// tile, th x tg = 128. Otherwise as conv_strip_async_bf16.
extern "C" int conv_s2d_bf16(const void* x, const void* w, const float* s, const float* t,
                             void* y, int B, int H, int W, int kind, int th, int tg,
                             void* stream) {
  if (!shapes_ok(B, H, W) || W % 2 != 0 || smem_bytes(S2D, kind, th, tg) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == S2DC)
    return launch_wgmma<S2DC, 2, S2D>(x, w, s, t, y, B, H, W / 2, th, tg, stream);
  return launch_wgmma<S2D9, 2, S2D>(x, w, s, t, y, B, H, W / 2, th, tg, stream);
}
