// Gradient histograms for Hopper (sm_90a): kernels K2, K3, K4 and K5.
//
// K2 (`xtt_hist_int8x2`) replaces the TPU kernel
// `xgboost_tpu/ops/pallas/histogram.py _make_int8_kernel` (pallas_call at
// :621 in `build_hist_pallas`). K3 (`xtt_hist_f32`) replaces the f32
// variant of `_make_kernel` (pallas_call at :634). K4 (`xtt_hist_scan`)
// replaces `_make_scan_kernel` (pallas_call at :478 in `scan_hist_pallas`)
// and K5 (`xtt_fused_advance_coarse`) replaces `_make_fused_kernel`
// (pallas_call at :344 in `fused_advance_coarse_pallas`); both are
// described with their code below. K2, K3 and K4 compute
// [n_nodes, F, B, 2] (g, h) sums by (node, feature, bin) over rows whose
// rel[row] < n_nodes, the function of the JAX package's
// `ops/histogram.py build_hist`.
//
// K2: the wrapper quantises the gradients (q = round(g * 32512/max|g|));
// each row splits q into hi = (q + 128) >> 8 and lo = q - 256*hi and adds
// the four values (g_hi, h_hi, g_lo, h_lo) to int32 counters. The result
// is (f32(sum hi) * 256 + f32(sum lo)) * inv. Integer sums do not depend
// on the order of the adds, so the result is deterministic and equals the
// plain version (and the JAX package's `prehot`) bit for bit. The TPU
// kernel instead adds 2048-row blocks in f32, which agrees with this only
// while the per-bin sums stay below 2^24.
//
// K3: each component is scaled by a power of two 2^k (chosen by the
// wrapper so that n * max|x| * 2^k <= 2^62), rounded to int64 and summed
// exactly; each sum is converted to f32 once and multiplied by 2^-k. f32
// atomics would make a trained model change from run to run; this is
// deterministic and within about one f32 rounding of the exact sum.
//
// What bounds them: the least traffic is the bins (n*F bytes), the
// gradients and rel read once and the histogram written once (14 us at
// 1M x 28, N = 128, on 3.35 TB/s; at 200k rows and N = 512 the 29 MB f32
// table is most of it). The work is n*F scatter-adds of 4 (K2) or 2 (K3)
// counters into a table that does not fit in shared memory at depth (128
// nodes x 28 features x 256 bins x 16 B = 14.7 MB), so what a design has
// to avoid is re-reading rows per tile and scattering atomics over the
// device table. What bounds this design on an H100 is the shared-memory
// pipe: four 32-bit atomics an element (K3's two int64 sums are kept as
// 32-bit words with an explicit carry, as 64-bit shared atomics cost
// several times more), at 7-10% of the bytes bound at 1M x 28 (PERF.md).
//
// Design (K2 and K3 share it; the policy structs below differ): the level
// is cut into groups of G consecutive nodes whose [G, F, B] cells of 16
// bytes (4 x 32-bit words) fit one 112.5 KB shared-memory tile (at 28
// features x 256 bins one node, at 36 slots six); where one node
// does not fit, features and then bins are cut into tiles (grid y). The
// plan (G, the tiles, R rows an item) is computed by the wrapper
// (`ops/cuda/hist.py hist_plan`), where the CPU tests reach it.
// - One group (the whole level fits a tile, e.g. the root, or the 20-slot
//   coarse ids at a few nodes): no sort. Item i reads rows [iR, iR + R) in
//   their own order, each row's rel, gradients and bins once.
// - Several groups: the rows are counting-sorted by node with K4's count
//   and scatter kernels; `level_plan` (one block) turns the counts into
//   the runs' offsets and cuts each group's run into items of at most R
//   rows (one item for an empty group).
// A block zeroes its tile, adds its item's (row, feature) elements with
// shared-memory integer atomics, and then, if its item is its group's
// only one, converts the tile to f32 and writes the group's part of the
// output once (empty nodes get zeros). Otherwise it stores its tile as a
// partial, and `combine_partials` adds a split group's partials in
// integers and converts once. No global atomics, no memset of the table,
// no f32 partial sums.
// Lanes walk (row, feature) elements in row-major order, so a warp reads
// about 32 consecutive bin ids (one or two rows) per load and its lanes
// mostly add into different features' cells: one bin slot that holds most
// rows (the missing slot, the refine ids' slot 35) does not serialise a
// warp. The tile keeps each word plane apart and a feature's bins at an
// odd stride, so those cells fall in different banks. Each thread issues
// kBatch elements' loads before their atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileBytes = 96 * 1024;   // shared memory of one K5 tile
constexpr int kCellBytes = 16;          // 4 x 32-bit words a cell

// K5's tiles of (node chunk x feature chunk x B) cells in kTileBytes.
struct Plan {
  int nc, fc;              // nodes and features of one tile
  int n_ftiles, n_tiles;   // feature tiles, all tiles
  long long rows_per_split;
  int splits;
};

Plan make_plan(long long n, int F, int B, int N, int num_sms) {
  Plan p;
  const int pairs = kTileBytes / (kCellBytes * B);   // (node, feature) pairs
  p.fc = F;
  if (F > pairs) {
    const int nft = (F + pairs - 1) / pairs;
    p.fc = (F + nft - 1) / nft;
  }
  const int nc = pairs / p.fc;
  p.nc = nc < 1 ? 1 : (nc < N ? nc : N);
  p.n_ftiles = (F + p.fc - 1) / p.fc;
  p.n_tiles = ((N + p.nc - 1) / p.nc) * p.n_ftiles;
  // about two resident blocks per SM
  const long long target = 2LL * num_sms;
  long long splits = (target + p.n_tiles - 1) / p.n_tiles;
  const long long by_rows = (n + 4095) / 4096;   // at least 4096 rows each
  if (splits > by_rows) splits = by_rows;
  if (splits < 1) splits = 1;
  long long rps = (n + splits - 1) / splits;
  if (rps < 1) rps = 1;
  p.rows_per_split = rps;
  p.splits = static_cast<int>((n + rps - 1) / rps);
  return p;
}

// K2's row values: the hi/lo byte planes of the quantised (g, h).
struct Int8x2 {
  using Counter = int;
  using Raw = int2;
  static constexpr int kPlanes = 4;
  const int2* q;
  __device__ __forceinline__ void init() {}
  __device__ __forceinline__ Raw raw(long long row) const { return q[row]; }
  __device__ __forceinline__ void expand(Raw x, Counter v[4]) const {
    const int ghi = (x.x + 128) >> 8;   // arithmetic shift: round to nearest
    const int hhi = (x.y + 128) >> 8;
    v[0] = ghi;
    v[1] = hhi;
    v[2] = x.x - 256 * ghi;
    v[3] = x.y - 256 * hhi;
  }
  __device__ __forceinline__ void load(long long row, Counter v[4]) const {
    expand(raw(row), v);
  }
  // K2 and K3's tiles: plane p of cell c in word p * cells + c
  using Word = int;
  static __device__ __forceinline__ void add(Word* cell, int cells,
                                             const Counter v[4]) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (v[p] != 0) atomicAdd(cell + p * cells, v[p]);
  }
  static __device__ __forceinline__ void read(const Word* base, int i,
                                              int cells, Counter a[4]) {
#pragma unroll
    for (int p = 0; p < 4; ++p) a[p] = base[p * cells + i];
  }
  // (f32(sum hi) * 256 + f32(sum lo)) * inv; the product by 256 is exact
  // and __fmul_rn/__fadd_rn keep the compiler from contracting into an FMA
  static __device__ __forceinline__ float2 to_f32(const Counter a[4],
                                                  float i0, float i1) {
    const float g = __fadd_rn(__fmul_rn(__int2float_rn(a[0]), 256.0f),
                              __int2float_rn(a[2]));
    const float h = __fadd_rn(__fmul_rn(__int2float_rn(a[1]), 256.0f),
                              __int2float_rn(a[3]));
    return make_float2(__fmul_rn(g, i0), __fmul_rn(h, i1));
  }
};

// K3's row values: round(x * 2^k) as int64, per component.
struct Fixed64 {
  using Counter = unsigned long long;   // two's complement: signed sums
  using Raw = float2;
  static constexpr int kPlanes = 2;
  const float2* g;
  const float* qscale;
  float s0, s1;
  __device__ __forceinline__ void init() {
    s0 = qscale[0];
    s1 = qscale[1];
  }
  __device__ __forceinline__ Raw raw(long long row) const { return g[row]; }
  __device__ __forceinline__ void expand(Raw x, Counter v[2]) const {
    // x * 2^k is exact; __float2ll_rn rounds half to even like torch.round
    v[0] = static_cast<Counter>(__float2ll_rn(__fmul_rn(x.x, s0)));
    v[1] = static_cast<Counter>(__float2ll_rn(__fmul_rn(x.y, s1)));
  }
  // Tiles hold each int64 counter as two 32-bit words (low word of
  // component p at 2p * cells + c, high word a plane later): 32-bit
  // shared-memory atomics cost a fraction of 64-bit ones. A value's low
  // word is added first and the carry it makes goes with its high word,
  // so the two words hold the exact sum modulo 2^64.
  using Word = unsigned;
  static __device__ __forceinline__ void add(Word* cell, int cells,
                                             const Counter v[2]) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (v[p] == 0) continue;
      Word* lo = cell + 2 * p * cells;
      const Word l = static_cast<Word>(v[p]);
      Word h = static_cast<Word>(v[p] >> 32);
      if (l != 0) {
        const Word old = atomicAdd(lo, l);
        h += old + l < old ? 1u : 0u;   // the carry out of the low word
      }
      if (h != 0) atomicAdd(lo + cells, h);
    }
  }
  static __device__ __forceinline__ void read(const Word* base, int i,
                                              int cells, Counter a[2]) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
      a[p] = (static_cast<Counter>(base[(2 * p + 1) * cells + i]) << 32)
             | base[2 * p * cells + i];
  }
  // f32(sum) * 2^-k: one rounding of the exact int64 sum
  static __device__ __forceinline__ float2 to_f32(const Counter a[2],
                                                  float i0, float i1) {
    return make_float2(
        __fmul_rn(__ll2float_rn(static_cast<long long>(a[0])), i0),
        __fmul_rn(__ll2float_rn(static_cast<long long>(a[1])), i1));
  }
};

// (f32(sum hi) * 256 + f32(sum lo)) * inv over a table of int32 planes
// (K4 and K5, whose blocks flush into one device table).
__global__ void dequant_int8x2(const int4* __restrict__ acc,
                               const float* __restrict__ inv, long long cells,
                               float2* __restrict__ out) {
  const float i0 = inv[0], i1 = inv[1];
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < cells; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int4 a = acc[i];   // (g_hi, h_hi, g_lo, h_lo)
    const int v[4] = {a.x, a.y, a.z, a.w};
    out[i] = Int8x2::to_f32(v, i0, i1);
  }
}

int grid_for(long long cells) {
  long long blocks = (cells + 255) / 256;
  return static_cast<int>(blocks > 4096 ? 4096 : (blocks < 1 ? 1 : blocks));
}

// ---- K2 and K3: node-group tiles ------------------------------------------

// The wrapper's plan (`ops/cuda/hist.py hist_plan`), in the order of the
// host array the C entry points take.
struct TilePlan {
  int G;                  // nodes of one group
  int fc, bc;             // features and bins of one tile
  int bs;                 // a feature's stride in the tile: bc, made odd
  int n_ftiles, n_btiles;
  int n_groups;
  long long R;            // rows of one item
  int sorted;             // 1: rows sorted by node; 0: one group, no sort
  int max_items;          // grid x of the tile kernel
  int max_split;          // grid x of the combine kernel
};

constexpr int kBatch = 4;     // elements a thread loads before its atomics
constexpr int kTilePlanBytes = 115200;   // two blocks a SM, as K4's tile

// Exclusive prefix sum of one value a thread over the block; *total gets
// the sum of all. Every thread of the block must call it.
__device__ __forceinline__ int block_scan(int v, int* warp_sums,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[n_warps - 1];
  __syncthreads();                        // warp_sums is reused next
  return excl;
}

constexpr int kPlanThreads = 1024;
constexpr int kPlanPer = 4;               // N and n_groups <= 4096

// One block: the sorted runs' offsets [N + 1] and the scatter's cursors
// from the counts (K4's scan_offsets, in parallel), then the items of
// every group of G nodes: a group of c rows takes max(1, ceil(c / R))
// items; a group of more than one item gets the next partial slots and
// a place in the split list (in group order). Entry n_groups of
// item_start is the item count; *n_split the split groups.
// `ops/cuda/hist.py group_items` is the same arithmetic in Python.
__global__ void __launch_bounds__(kPlanThreads) level_plan(
    const int* __restrict__ counts, int N, int G, int n_groups, long long R,
    int* __restrict__ offsets, int* __restrict__ cursor,
    int* __restrict__ item_start, int* __restrict__ pslot,
    int* __restrict__ split_list, int* __restrict__ n_split) {
  __shared__ int off[kPlanThreads * kPlanPer + 1];
  __shared__ int warp_sums[32];
  const int t0 = threadIdx.x * kPlanPer;
  int c[kPlanPer], sum = 0, total;
#pragma unroll
  for (int k = 0; k < kPlanPer; ++k) {
    c[k] = t0 + k < N ? counts[t0 + k] : 0;
    sum += c[k];
  }
  int run = block_scan(sum, warp_sums, &total);
#pragma unroll
  for (int k = 0; k < kPlanPer; ++k) {
    if (t0 + k < N) {
      off[t0 + k] = run;
      offsets[t0 + k] = run;
      cursor[t0 + k] = run;
    }
    run += c[k];
  }
  if (threadIdx.x == 0) {
    off[N] = total;
    offsets[N] = total;
  }
  __syncthreads();
  int s[kPlanPer], items = 0, slots = 0, splits = 0;
#pragma unroll
  for (int k = 0; k < kPlanPer; ++k) {
    const int g = t0 + k;
    s[k] = 0;
    if (g < n_groups) {
      const int hi = (g + 1) * G < N ? (g + 1) * G : N;
      const long long rows = off[hi] - off[g * G];
      s[k] = rows > R ? static_cast<int>((rows + R - 1) / R) : 1;
    }
    items += s[k];
    slots += s[k] > 1 ? s[k] : 0;
    splits += s[k] > 1 ? 1 : 0;
  }
  int t_items, t_slots, t_splits;
  int i_run = block_scan(items, warp_sums, &t_items);
  int s_run = block_scan(slots, warp_sums, &t_slots);
  int f_run = block_scan(splits, warp_sums, &t_splits);
#pragma unroll
  for (int k = 0; k < kPlanPer; ++k) {
    const int g = t0 + k;
    if (g >= n_groups) break;
    item_start[g] = i_run;
    i_run += s[k];
    if (s[k] > 1) {
      pslot[g] = s_run;
      s_run += s[k];
      split_list[f_run++] = g;
    } else {
      pslot[g] = -1;
    }
  }
  if (threadIdx.x == 0) {
    item_start[n_groups] = t_items;
    *n_split = t_splits;
  }
}

// Add the (row, feature) elements of sorted positions (or rows) [a, e)
// into the tile. Sorted: idx is perm and every row is at group node gi.
// Unsorted: idx is rel and a row's node is its rel (inactive when outside
// [0, N)). Elements run row-major over the tile's fcur features; thread t
// starts at element t and steps by blockDim.x. A thread issues the loads
// of kBatch elements before their adds; unsorted, a row's rel, bins and
// gradients are loaded together. The tile keeps each plane's words apart
// (the policies' `add`) and a feature's bins at an odd stride, so that the lanes of a warp, which mostly add into different
// features, spread over the banks even where they add into one slot.
template <bool kSorted, typename BinT, typename Pol>
__device__ __forceinline__ void add_elements(
    const BinT* __restrict__ bins, const int* __restrict__ idx,
    const Pol& pol, long long a, long long e, int F, int N, int gi, int f0,
    int fcur, int fc, int b0, int bcur, int bs, int cells,
    typename Pol::Word* __restrict__ tile) {
  using C = typename Pol::Counter;
  constexpr int P = Pol::kPlanes;
  const int dq = blockDim.x / fcur, dr = blockDim.x % fcur;
  long long r = a + threadIdx.x / fcur;
  int j = threadIdx.x % fcur;
  while (r < e) {
    long long row[kBatch];
    int feat[kBatch], node[kBatch];
    unsigned bin[kBatch];
    typename Pol::Raw x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {   // element positions
      row[u] = r < e ? r : -1;
      feat[u] = j;
      j += dr;
      r += dq;
      if (j >= fcur) {
        j -= fcur;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {   // loads
      if (row[u] < 0) continue;
      if (kSorted) {
        row[u] = idx[row[u]];
        node[u] = gi;
      } else {
        node[u] = idx[row[u]];
      }
      bin[u] = static_cast<unsigned>(bins[row[u] * F + f0 + feat[u]]);
      x[u] = pol.raw(row[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {   // shared-memory integer adds
      if (row[u] < 0) continue;
      const unsigned b = bin[u] - static_cast<unsigned>(b0);
      if (b >= static_cast<unsigned>(bcur)) continue;             // other tile
      if (!kSorted && (node[u] < 0 || node[u] >= N)) continue;   // inactive
      C v[P];
      pol.expand(x[u], v);
      Pol::add(tile + (node[u] * fc + feat[u]) * bs + static_cast<int>(b),
               cells, v);
    }
  }
}

// Write tile cells [0, cells) of group g, tile (f0, b0) as f32 pairs.
template <typename Pol>
__device__ __forceinline__ void write_tile(
    const typename Pol::Word* __restrict__ tile, const TilePlan& tp,
    int g, int f0, int b0, int N, int F, int B, float i0, float i1,
    float2* __restrict__ out) {
  using C = typename Pol::Counter;
  constexpr int P = Pol::kPlanes;
  const int per_node = tp.fc * tp.bs;
  const int cells = tp.G * per_node;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int gi = i / per_node;
    const int j = (i - gi * per_node) / tp.bs;
    const int b = i - gi * per_node - j * tp.bs;
    const int node = g * tp.G + gi;
    if (node >= N || f0 + j >= F || b >= tp.bc || b0 + b >= B) continue;
    C a[P];
    Pol::read(tile, i, cells, a);
    out[(static_cast<long long>(node) * F + f0 + j) * B + b0 + b] =
        Pol::to_f32(a, i0, i1);
  }
}

template <bool kSorted, typename BinT, typename Pol>
__global__ void __launch_bounds__(kThreads, 2) hist_tiles(
    const BinT* __restrict__ bins, const int* __restrict__ rel,
    const int* __restrict__ perm, const int* __restrict__ offsets,
    const int* __restrict__ item_start, const int* __restrict__ pslot,
    Pol pol, const float* __restrict__ inv, long long n, int F, int B,
    int N, TilePlan tp, typename Pol::Word* __restrict__ partial,
    float2* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename Pol::Word* tile = reinterpret_cast<typename Pol::Word*>(smem_raw);

  const int item = blockIdx.x;
  int g = 0, seg = item, n_seg = gridDim.x, slot = 0;
  if (kSorted) {
    if (item >= item_start[tp.n_groups]) return;
    int lo = 0, hi = tp.n_groups;       // the group whose items hold `item`
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (item_start[mid] <= item) lo = mid; else hi = mid;
    }
    g = lo;
    seg = item - item_start[g];
    n_seg = item_start[g + 1] - item_start[g];
    slot = pslot[g];
  }
  const int t = blockIdx.y;
  const int f0 = (t / tp.n_btiles) * tp.fc;
  const int b0 = (t % tp.n_btiles) * tp.bc;
  const int fcur = tp.fc < F - f0 ? tp.fc : F - f0;
  const int bcur = tp.bc < B - b0 ? tp.bc : B - b0;
  const int cells = tp.G * tp.fc * tp.bs;

  uint4* tile16 = reinterpret_cast<uint4*>(tile);   // cells * 16 bytes
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    tile16[i] = make_uint4(0, 0, 0, 0);
  pol.init();
  __syncthreads();

  if (kSorted) {
    const int k0 = g * tp.G;
    const int k1 = k0 + tp.G < N ? k0 + tp.G : N;
    const long long s0 = offsets[k0] + static_cast<long long>(seg) * tp.R;
    const long long gend = offsets[k1];
    const long long s1 = s0 + tp.R < gend ? s0 + tp.R : gend;
    for (int k = k0; k < k1; ++k) {
      const long long a = offsets[k] > s0 ? offsets[k] : s0;
      const long long e = offsets[k + 1] < s1 ? offsets[k + 1] : s1;
      if (a < e)
        add_elements<true>(bins, perm, pol, a, e, F, N, k - k0, f0, fcur,
                           tp.fc, b0, bcur, tp.bs, cells, tile);
    }
  } else {
    const long long a = static_cast<long long>(item) * tp.R;
    const long long e = a + tp.R < n ? a + tp.R : n;
    if (a < e)
      add_elements<false>(bins, rel, pol, a, e, F, N, 0, f0, fcur, tp.fc, b0,
                          bcur, tp.bs, cells, tile);
  }
  __syncthreads();

  if (n_seg == 1) {                      // the group's only item
    write_tile<Pol>(tile, tp, g, f0, b0, N, F, B, inv[0], inv[1], out);
    return;
  }
  const int n_tiles = tp.n_ftiles * tp.n_btiles;
  uint4* dst = reinterpret_cast<uint4*>(
      partial + (static_cast<long long>(slot + seg) * n_tiles + t) * cells * 4);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = tile16[i];
}

// The split groups: each cell's partials (one per item) added in integers
// and converted once. Grid: (a stride over the split groups, 32-cell
// chunk, tile). For a group of n_seg partials, ws warps (a power of two,
// at most kCombineWarps and n_seg) share a 32-cell chunk and take every
// ws-th partial; lane l reads counter chunk + l of each plane, so a warp
// reads 32 consecutive counters; their sums meet in shared memory.
// Unsorted (one group): unsorted_items partials at slot 0.
constexpr int kCombineWarps = 8;

template <typename Pol>
__global__ void __launch_bounds__(32 * kCombineWarps) combine_partials(
    const typename Pol::Word* __restrict__ partial,
    const int* __restrict__ item_start, const int* __restrict__ pslot,
    const int* __restrict__ split_list, const int* __restrict__ n_split,
    int unsorted_items, const float* __restrict__ inv, int F, int B, int N,
    TilePlan tp, float2* __restrict__ out) {
  using C = typename Pol::Counter;
  constexpr int P = Pol::kPlanes;
  __shared__ C sums[kCombineWarps][P][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.z;
  const int f0 = (t / tp.n_btiles) * tp.fc;
  const int b0 = (t % tp.n_btiles) * tp.bc;
  const int per_node = tp.fc * tp.bs;
  const int cells = tp.G * per_node;
  const int n_tiles = tp.n_ftiles * tp.n_btiles;
  const int groups = unsorted_items > 0 ? 1 : *n_split;
  for (int js = blockIdx.x; js < groups; js += gridDim.x) {
    int g = 0, slot = 0, n_seg = unsorted_items;
    if (unsorted_items == 0) {
      g = split_list[js];
      slot = pslot[g];
      n_seg = item_start[g + 1] - item_start[g];
    }
    int ws = 1;
    while (2 * ws <= kCombineWarps && 2 * ws <= n_seg) ws *= 2;
    const int per_block = kCombineWarps / ws;      // 32-cell chunks a block
    if (static_cast<int>(blockIdx.y) * per_block * 32 >= cells) continue;
    const int i = (blockIdx.y * per_block + warp / ws) * 32 + lane;
    C a[P];
#pragma unroll
    for (int p = 0; p < P; ++p) a[p] = 0;
    if (i < cells) {
      int s = warp % ws;
      for (; s + 3 * ws < n_seg; s += 4 * ws) {
        C x[4][P];                        // four partials' loads in flight
#pragma unroll
        for (int k = 0; k < 4; ++k)
          Pol::read(partial + (static_cast<long long>(slot + s + k * ws)
                               * n_tiles + t) * cells * 4,
                    i, cells, x[k]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int p = 0; p < P; ++p) a[p] += x[k][p];
      }
      for (; s < n_seg; s += ws) {
        C x[P];
        Pol::read(partial + (static_cast<long long>(slot + s) * n_tiles + t)
                                * cells * 4,
                  i, cells, x);
#pragma unroll
        for (int p = 0; p < P; ++p) a[p] += x[p];
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) sums[warp][p][lane] = a[p];
    __syncthreads();
    if (warp % ws == 0 && i < cells) {
      for (int w = 1; w < ws; ++w)
#pragma unroll
        for (int p = 0; p < P; ++p) a[p] += sums[warp + w][p][lane];
      const int gi = i / per_node;
      const int j = (i - gi * per_node) / tp.bs;
      const int b = i - gi * per_node - j * tp.bs;
      const int node = g * tp.G + gi;
      if (node < N && f0 + j < F && b < tp.bc && b0 + b < B)
        out[(static_cast<long long>(node) * F + f0 + j) * B + b0 + b] =
            Pol::to_f32(a, inv[0], inv[1]);
    }
    __syncthreads();                      // sums is reused next
  }
}

// ---- K4: the int8x2 histogram over rows sorted by node ---------------------
//
// The TPU kernel streams 2048-row blocks of rows that its wrapper
// counting-sorted by node (`ops/partition.py counting_sort_by_node`), so
// each block belongs to one node and its accumulator tile is one node's
// [F, B, 4] int32 sums, however many nodes the level has. K4 keeps that
// design and K2's arithmetic: the same quantised q, the same hi/lo planes,
// exact int32 sums, the same dequantisation, so it computes K2's function
// bit for bit. What it changes is the bound at depth: one tile of one
// node holds its counters however many nodes the level has. K2 and K3
// share its count and scatter kernels.
//
// Steps, all on one stream:
// 1. count: each block counts its rows per node in shared memory and adds
//    the counts to the global ones (one atomic per block and node);
// 2. offsets: one thread turns the counts into the start of every node's
//    run (N + 1 entries; entry N is the number of active rows);
// 3. scatter: each block counts again, reserves its place in every node's
//    run with one global atomic per node, and writes its active rows' ids
//    there. The order inside a run depends on the atomics; the integer sums
//    do not, so the result is deterministic;
// 4. accumulate: block b owns sorted positions [b*R, (b+1)*R) and walks
//    them run by run: zero the tile, add the run's rows with shared-memory
//    atomics, add the tile's non-zero counters to the node's row of the
//    global table. A run crosses few block borders, so the table sees
//    about (blocks + N) tile flushes in all;
// 5. dequantise, as K2.
// Inactive rows (rel outside [0, N)) are dropped by the sort.

constexpr int kScanThreads = 512;
constexpr int kSortRowsPerThread = 8;
// one node's tile: 28 features x 257 bins x 16 B = 115,136 B, and two
// blocks of 115,200 B (plus 1 KB each for the system) fit the 228 KB of an
// SM
constexpr int kScanTileBytes = 115200;

__global__ void __launch_bounds__(kScanThreads) scan_count(
    const int* __restrict__ rel, long long n, int N, int* __restrict__ counts) {
  extern __shared__ int cnt[];                              // [N]
  for (int i = threadIdx.x; i < N; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const long long r0 =
      static_cast<long long>(blockIdx.x) * blockDim.x * kSortRowsPerThread;
#pragma unroll
  for (int k = 0; k < kSortRowsPerThread; ++k) {
    const long long r = r0 + static_cast<long long>(k) * blockDim.x
                        + threadIdx.x;
    if (r < n) {
      const int v = rel[r];
      if (v >= 0 && v < N) atomicAdd(&cnt[v], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    if (cnt[i] != 0) atomicAdd(&counts[i], cnt[i]);
}

__global__ void scan_offsets(const int* __restrict__ counts, int N,
                             int* __restrict__ offsets,
                             int* __restrict__ cursor) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  int run = 0;
  for (int i = 0; i < N; ++i) {
    offsets[i] = run;
    cursor[i] = run;
    run += counts[i];
  }
  offsets[N] = run;
}

__global__ void __launch_bounds__(kScanThreads) scan_scatter(
    const int* __restrict__ rel, long long n, int N, int* __restrict__ cursor,
    int* __restrict__ perm) {
  extern __shared__ int sh[];                               // [2N]
  int* cnt = sh;
  int* base = sh + N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const long long r0 =
      static_cast<long long>(blockIdx.x) * blockDim.x * kSortRowsPerThread;
  int node[kSortRowsPerThread], rank[kSortRowsPerThread];
#pragma unroll
  for (int k = 0; k < kSortRowsPerThread; ++k) {
    const long long r = r0 + static_cast<long long>(k) * blockDim.x
                        + threadIdx.x;
    node[k] = r < n ? rel[r] : -1;
    if (node[k] >= 0 && node[k] < N) rank[k] = atomicAdd(&cnt[node[k]], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    base[i] = cnt[i] != 0 ? atomicAdd(&cursor[i], cnt[i]) : 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSortRowsPerThread; ++k) {
    if (node[k] >= 0 && node[k] < N) {
      const long long r = r0 + static_cast<long long>(k) * blockDim.x
                          + threadIdx.x;
      perm[base[node[k]] + rank[k]] = static_cast<int>(r);
    }
  }
}

template <typename BinT>
__global__ void __launch_bounds__(kScanThreads, 2) scan_accumulate(
    const BinT* __restrict__ bins, const int2* __restrict__ q,
    const int* __restrict__ perm, const int* __restrict__ offsets, int F,
    int B, int N, int fc, long long rows_per_block, int* __restrict__ acc) {
  extern __shared__ __align__(16) int tile[];               // [fc, B, 4]
  const long long n_active = offsets[N];
  long long s = static_cast<long long>(blockIdx.x) * rows_per_block;
  if (s >= n_active) return;
  const long long e =
      s + rows_per_block < n_active ? s + rows_per_block : n_active;
  const int f0 = blockIdx.y * fc;
  const int fcur = fc < F - f0 ? fc : F - f0;
  const int cells = fcur * B * 4;
  while (s < e) {
    // the run holding sorted position s: the first node whose run ends
    // after s (runs may be empty)
    int lo = 1, hi = N;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (offsets[mid] > s) hi = mid; else lo = mid + 1;
    }
    const int node = lo - 1;
    const long long run_end = offsets[lo] < e ? offsets[lo] : e;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) tile[i] = 0;
    __syncthreads();
    for (long long i = s + threadIdx.x; i < run_end; i += blockDim.x) {
      const long long row = perm[i];
      const int2 x = q[row];
      const int ghi = (x.x + 128) >> 8;   // arithmetic shift: round to nearest
      const int hhi = (x.y + 128) >> 8;
      const int v[4] = {ghi, hhi, x.x - 256 * ghi, x.y - 256 * hhi};
      const BinT* brow = bins + row * F + f0;
      for (int j = 0; j < fcur; ++j) {
        const unsigned b = static_cast<unsigned>(brow[j]);
        if (b >= static_cast<unsigned>(B)) continue;   // never for valid bins
        int* cell = tile + (j * B + b) * 4;
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (v[p] != 0) atomicAdd(cell + p, v[p]);
      }
    }
    __syncthreads();
    int* dst = acc + (static_cast<long long>(node) * F + f0) * B * 4;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int v = tile[i];
      if (v != 0) atomicAdd(dst + i, v);
    }
    __syncthreads();                      // the tile is zeroed again next
    s = run_end;
  }
}

template <typename BinT>
cudaError_t launch_scan_accumulate(const void* bins, const int* q,
                                   const int* perm, const int* offsets,
                                   long long n, int F, int B, int N,
                                   int num_sms, int* acc,
                                   cudaStream_t stream) {
  int fc = kScanTileBytes / (B * 16);
  if (fc < 1) return cudaErrorInvalidValue;   // one feature's bins must fit
  if (fc > F) fc = F;
  const int n_ftiles = (F + fc - 1) / fc;
  fc = (F + n_ftiles - 1) / n_ftiles;         // balance the feature tiles
  // about two blocks per SM over all rows (inactive ones included: their
  // count is on the device), at least 1024 rows each
  const long long target = 2LL * num_sms;
  long long rpb = (n + target - 1) / target;
  if (rpb < 1024) rpb = 1024;
  const long long blocks = (n + rpb - 1) / rpb;
  if (blocks > 0x7fffffffLL || n_ftiles > 65535)
    return cudaErrorInvalidConfiguration;
  auto kernel = scan_accumulate<BinT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScanTileBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), n_ftiles);
  kernel<<<grid, kScanThreads, fc * B * 16, stream>>>(
      static_cast<const BinT*>(bins), reinterpret_cast<const int2*>(q), perm,
      offsets, F, B, N, fc, rpb, acc);
  return cudaGetLastError();
}

// ---- K5: the level advance fused with the next level's coarse histogram --
//
// One pass over the rows at a level boundary of the `fused` schedule. For
// each row: if it sits at a node of the previous level that split, read
// its bin at that node's split feature and move it to 2p + 1 + go_right
// (the missing bin goes the default way, otherwise right when bin > thr);
// write the new position; if that lies in the new level, add the row's four
// int8x2 planes at every feature's coarse id (bin >> shift, the missing bin
// on slot B - 1) to the [N, F, B, 4] int32 table. One dequantisation as
// K2's. The caller gives the geometry (ops/split.py: shift 4, B = 20).
// Rows above the previous level, and rows at its nodes that did not split,
// stay put and fall outside the new level.
//
// The TPU kernel adds 2048-row blocks of each coarse bin's sums in f32, so
// it equals this exact-int32 function only while those sums stay below
// 2^24 quanta; K5 is K2's function over the coarse ids at every size.
//
// Design: shared-memory tiles at 20 bins (a 96 KB tile holds 10 nodes x
// 28 features, so a level of 128 nodes takes 13 tiles). Measured once on
// an H100 at 1M x 28 (PERF.md): the tiles beat global atomics at every
// level width of the path, 0.147 against 4.14 ms at N = 2 and 1.03
// against 1.24 ms at N = 128. Each tile's blocks recompute the advance of
// their rows (one payload lookup in shared memory and one bin read a
// row); only the first tile writes the positions. What bounds it: the least traffic is ~52 MB at 1M x 28
// (bins, q and the positions read, the positions and the table written),
// ~16 us; the scatter of 4 integer adds per (row, feature) into 20 slots
// contends more than K2's into 256, and at 128 nodes each of the 13 tiles
// re-reads every row's position and split bin.

constexpr int kFusedMaxPrev = 64;   // the TPU's gate: levels of <= 128 nodes

template <typename BinT>
__global__ void __launch_bounds__(kThreads, 2) fused_accumulate(
    const BinT* __restrict__ bins, const long long* __restrict__ pos_in,
    const int* __restrict__ payload, int n_prev, long long lo_prev,
    long long lo, int missing_bin, int B, int shift, Int8x2 pol, long long n,
    int F, int N, int nc, int fc, int n_ftiles, long long rows_per_split,
    long long* __restrict__ pos_out, int* __restrict__ acc) {
  constexpr int P = Int8x2::kPlanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* tile = reinterpret_cast<int*>(smem_raw);
  // the previous level's payload: feature, threshold, default_left,
  // can_split, n_prev entries each
  __shared__ int split[4 * kFusedMaxPrev];

  const int t = blockIdx.y;
  const int n0 = (t / n_ftiles) * nc;
  const int f0 = (t % n_ftiles) * fc;
  const int ncur = nc < N - n0 ? nc : N - n0;
  const int fcur = fc < F - f0 ? fc : F - f0;
  const int tile_cells = nc * fc * B * P;

  for (int i = threadIdx.x; i < 4 * n_prev; i += blockDim.x)
    split[i] = payload[i];
  for (int i = threadIdx.x; i < tile_cells; i += blockDim.x) tile[i] = 0;
  __syncthreads();

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_split;
  const long long r1 = r0 + rows_per_split < n ? r0 + rows_per_split : n;
  for (long long row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    long long p = pos_in[row];
    const long long j = p - lo_prev;
    if (j >= 0 && j < n_prev && split[3 * n_prev + j] != 0) {
      const int b = static_cast<int>(bins[row * F + split[j]]);
      const bool right = b == missing_bin ? split[2 * n_prev + j] == 0
                                          : b > split[n_prev + j];
      p = 2 * p + 1 + (right ? 1 : 0);
    }
    if (t == 0) pos_out[row] = p;
    const long long node = p - lo - n0;
    if (node < 0 || node >= ncur) continue;   // other tile, or not in level
    int v[P];
    pol.load(row, v);
    const BinT* brow = bins + row * F + f0;
    for (int k = 0; k < fcur; ++k) {
      const int b = static_cast<int>(brow[k]);
      const int c = b == missing_bin ? B - 1 : b >> shift;
      int* cell = tile + ((node * fc + k) * B + c) * P;
#pragma unroll
      for (int q = 0; q < P; ++q)
        if (v[q] != 0) atomicAdd(cell + q, v[q]);
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < tile_cells; i += blockDim.x) {
    const int v = tile[i];
    if (v == 0) continue;
    const int q = i % P;
    const int cell = i / P;
    const int c = cell % B;
    const int rest = cell / B;
    const int k = rest % fc;
    const int node = rest / fc;
    if (node >= ncur || k >= fcur) continue;
    atomicAdd(acc + ((static_cast<long long>(n0 + node) * F + f0 + k) * B
                     + c) * P + q, v);
  }
}

template <typename BinT>
cudaError_t launch_fused(const void* bins, const long long* pos_in,
                         const int* payload, int n_prev, long long lo_prev,
                         long long lo, int missing_bin, int B, int shift,
                         const int* q, long long n, int F, int N, int num_sms,
                         long long* pos_out, int* acc, cudaStream_t stream) {
  if (B * kCellBytes > kTileBytes) return cudaErrorInvalidValue;
  const Plan p = make_plan(n, F, B, N, num_sms);
  if (p.n_tiles > 65535) return cudaErrorInvalidConfiguration;
  auto kernel = fused_accumulate<BinT>;
  const int smem = p.nc * p.fc * B * kCellBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.splits, p.n_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), pos_in, payload, n_prev, lo_prev, lo,
      missing_bin, B, shift, Int8x2{reinterpret_cast<const int2*>(q)}, n, F,
      N, p.nc,
      p.fc, p.n_ftiles, p.rows_per_split, pos_out, acc);
  return cudaGetLastError();
}

// Two blocks of a full tile a SM: the shared-memory limit and carveout,
// set once for each kernel and device (the caller keeps a bit a device).
template <typename Kernel>
cudaError_t allow_tile(Kernel kernel, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTilePlanBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

template <typename BinT, typename Pol>
cudaError_t launch_tiles(const void* bins_v, const int* rel, Pol pol,
                         const float* inv, long long n, int F, int B, int N,
                         const TilePlan& tp, int* work,
                         typename Pol::Word* partial, float* out,
                         cudaStream_t stream) {
  const BinT* bins = static_cast<const BinT*>(bins_v);
  float2* out2 = reinterpret_cast<float2*>(out);
  const int cells = tp.G * tp.fc * tp.bs;
  const int n_tiles = tp.n_ftiles * tp.n_btiles;
  const dim3 grid(static_cast<unsigned>(tp.max_items), n_tiles);
  const unsigned chunks = static_cast<unsigned>((cells + 31) / 32);
  cudaError_t err;
  if (tp.sorted) {
    int* counts = work;
    int* offsets = counts + N;
    int* cursor = offsets + N + 1;
    int* perm = cursor + N;
    int* item_start = perm + n;
    int* pslot = item_start + tp.n_groups + 1;
    int* split_list = pslot + tp.n_groups;
    int* n_split = split_list + tp.n_groups;
    err = cudaMemsetAsync(counts, 0, N * sizeof(int), stream);
    if (err != cudaSuccess) return err;
    const long long per_block =
        static_cast<long long>(kScanThreads) * kSortRowsPerThread;
    const unsigned sort_blocks =
        static_cast<unsigned>((n + per_block - 1) / per_block);
    if (n > 0)
      scan_count<<<sort_blocks, kScanThreads, N * sizeof(int), stream>>>(
          rel, n, N, counts);
    level_plan<<<1, kPlanThreads, 0, stream>>>(
        counts, N, tp.G, tp.n_groups, tp.R, offsets, cursor, item_start,
        pslot, split_list, n_split);
    if (n > 0)
      scan_scatter<<<sort_blocks, kScanThreads, 2 * N * sizeof(int),
                     stream>>>(rel, n, N, cursor, perm);
    static unsigned ready = 0;   // per instantiation
    auto kernel = hist_tiles<true, BinT, Pol>;
    err = allow_tile(kernel, &ready);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, cells * kCellBytes, stream>>>(
        bins, rel, perm, offsets, item_start, pslot, pol, inv, n, F, B, N, tp,
        partial, out2);
    // about 2048 blocks over the split groups' chunks, looping over groups
    const unsigned stride = static_cast<unsigned>(
        tp.max_split < 2048 / chunks ? tp.max_split : (2048 + chunks - 1)
                                                          / chunks);
    if (tp.max_split > 0)
      combine_partials<Pol><<<dim3(stride, chunks, n_tiles),
                              32 * kCombineWarps, 0, stream>>>(
          partial, item_start, pslot, split_list, n_split, 0, inv, F, B, N,
          tp, out2);
  } else {
    static unsigned ready = 0;   // per instantiation
    auto kernel = hist_tiles<false, BinT, Pol>;
    err = allow_tile(kernel, &ready);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, cells * kCellBytes, stream>>>(
        bins, rel, nullptr, nullptr, nullptr, nullptr, pol, inv, n, F, B, N,
        tp, partial, out2);
    if (tp.max_items > 1)
      combine_partials<Pol><<<dim3(1, chunks, n_tiles), 32 * kCombineWarps,
                              0, stream>>>(
          partial, nullptr, nullptr, nullptr, nullptr, tp.max_items, inv, F, B,
          N, tp, out2);
  }
  return cudaGetLastError();
}

// Reads and checks the wrapper's plan, then launches K2's or K3's kernels
// for the bin width.
template <typename Pol>
cudaError_t run_tiles(const void* bins, int bin_bytes, const int* rel,
                      Pol pol, const float* inv, long long n, int F, int B,
                      int N, const long long* plan, int* work, int* partial,
                      float* out, cudaStream_t stream) {
  TilePlan tp;
  tp.G = static_cast<int>(plan[0]);
  tp.fc = static_cast<int>(plan[1]);
  tp.bc = static_cast<int>(plan[2]);
  tp.bs = static_cast<int>(plan[3]);
  tp.n_ftiles = static_cast<int>(plan[4]);
  tp.n_btiles = static_cast<int>(plan[5]);
  tp.n_groups = static_cast<int>(plan[6]);
  tp.R = plan[7];
  tp.sorted = static_cast<int>(plan[8]);
  tp.max_items = static_cast<int>(plan[9]);
  tp.max_split = static_cast<int>(plan[10]);
  const long long cells = static_cast<long long>(tp.G) * tp.fc * tp.bs;
  if (tp.G < 1 || tp.fc < 1 || tp.bc < 1 || tp.bs < tp.bc || tp.R < 1 ||
      tp.max_items < 1 ||
      cells * kCellBytes > kTilePlanBytes ||
      static_cast<long long>(tp.n_ftiles) * tp.fc < F ||
      static_cast<long long>(tp.n_btiles) * tp.bc < B ||
      static_cast<long long>(tp.n_groups) * tp.G < N ||
      tp.n_ftiles * tp.n_btiles > 65535 || (tp.sorted && N > 4096) ||
      (tp.sorted && tp.n_groups > kPlanThreads * kPlanPer) ||
      (!tp.sorted && tp.n_groups != 1) || n >= (1LL << 31))
    return cudaErrorInvalidValue;
  auto* words = reinterpret_cast<typename Pol::Word*>(partial);
  switch (bin_bytes) {
    case 1:
      return launch_tiles<uint8_t>(bins, rel, pol, inv, n, F, B, N, tp, work,
                                   words, out, stream);
    case 2:
      return launch_tiles<uint16_t>(bins, rel, pol, inv, n, F, B, N, tp,
                                    work, words, out, stream);
    case 4:
      return launch_tiles<int32_t>(bins, rel, pol, inv, n, F, B, N, tp, work,
                                   words, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K2. bins [n, F] (1, 2 or 4 bytes per id), rel [n] int32, q [n, 2] int32,
// inv [2] f32 on the device; plan: the host array of TilePlan's eleven
// fields that `ops/cuda/hist.py hist_plan` makes; work: int32 scratch of
// `hist_work_ints` entries; partial: 16-byte aligned 32-bit scratch of
// `hist_partial_words` entries; out [N, F, B, 2] f32, every entry
// written. Returns a
// cudaError_t (0 on success). Launches on `stream` and does not
// synchronise.
extern "C" int xtt_hist_int8x2(const void* bins, int bin_bytes,
                               const int* rel, const int* q, const float* inv,
                               long long n, int F, int B, int N,
                               const long long* plan, int* work, int* partial,
                               float* out, cudaStream_t stream) {
  return run_tiles(bins, bin_bytes, rel,
                   Int8x2{reinterpret_cast<const int2*>(q)}, inv, n, F, B, N,
                   plan, work, partial, out, stream);
}

// K3: the same with gpair [n, 2] f32, qscale [2] (2^k) and inv [2] (2^-k)
// f32.
extern "C" int xtt_hist_f32(const void* bins, int bin_bytes, const int* rel,
                            const float* gpair, const float* qscale,
                            const float* inv, long long n, int F, int B,
                            int N, const long long* plan, int* work,
                            int* partial, float* out, cudaStream_t stream) {
  return run_tiles(bins, bin_bytes, rel,
                   Fixed64{reinterpret_cast<const float2*>(gpair), qscale,
                           0.0f, 0.0f},
                   inv, n, F, B, N, plan, work, partial, out, stream);
}


// K4: the same arguments as xtt_hist_int8x2, with `work` an int32 scratch
// of 3*N + 1 + n entries (counts [N], offsets [N + 1], cursor [N],
// perm [n]). Returns a cudaError_t (0 on success). Launches on `stream`
// and does not synchronise.
extern "C" int xtt_hist_scan(const void* bins, int bin_bytes, const int* rel,
                             const int* q, const float* inv, long long n,
                             int F, int B, int N, int num_sms, int* work,
                             int* acc, float* out, cudaStream_t stream) {
  const long long cells = static_cast<long long>(N) * F * B;
  int* counts = work;
  int* offsets = work + N;
  int* cursor = offsets + N + 1;
  int* perm = cursor + N;
  if (N > 4096) return cudaErrorInvalidValue;   // the sort's shared counts
  cudaError_t err = cudaMemsetAsync(acc, 0, cells * 4 * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(counts, 0, N * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    const long long per_block =
        static_cast<long long>(kScanThreads) * kSortRowsPerThread;
    const unsigned sort_blocks =
        static_cast<unsigned>((n + per_block - 1) / per_block);
    scan_count<<<sort_blocks, kScanThreads, N * sizeof(int), stream>>>(
        rel, n, N, counts);
    scan_offsets<<<1, 32, 0, stream>>>(counts, N, offsets, cursor);
    scan_scatter<<<sort_blocks, kScanThreads, 2 * N * sizeof(int), stream>>>(
        rel, n, N, cursor, perm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    switch (bin_bytes) {
      case 1:
        err = launch_scan_accumulate<uint8_t>(bins, q, perm, offsets, n, F, B,
                                              N, num_sms, acc, stream);
        break;
      case 2:
        err = launch_scan_accumulate<uint16_t>(bins, q, perm, offsets, n, F,
                                               B, N, num_sms, acc, stream);
        break;
      case 4:
        err = launch_scan_accumulate<int32_t>(bins, q, perm, offsets, n, F, B,
                                              N, num_sms, acc, stream);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  dequant_int8x2<<<grid_for(cells), 256, 0, stream>>>(
      reinterpret_cast<const int4*>(acc), inv, cells,
      reinterpret_cast<float2*>(out));
  return cudaGetLastError();
}

// K5: bins [n, F] (1, 2 or 4 bytes per id), pos_in [n] int64 heap ids,
// payload [4, n_prev] int32 (feature >= 0, threshold bin, default_left,
// can_split) of the previous level starting at heap node lo_prev, q [n, 2]
// int32, inv [2] f32; the new level has N nodes from heap node lo. The
// coarse geometry comes from the caller (ops/split.py): B coarse slots,
// coarse id bin >> shift, the missing bin on slot B - 1. Writes pos_out
// [n] int64 and out [N, F, B, 2] f32; acc [N*F*B*4] int32 scratch.
// Returns a cudaError_t (0 on success). Launches on `stream` and does not
// synchronise.
extern "C" int xtt_fused_advance_coarse(
    const void* bins, int bin_bytes, const long long* pos_in,
    const int* payload, int n_prev, long long lo_prev, long long lo,
    int missing_bin, int B, int shift, const int* q, const float* inv,
    long long n, int F, int N, int num_sms, int* acc, long long* pos_out,
    float* out, cudaStream_t stream) {
  if (n_prev < 1 || n_prev > kFusedMaxPrev) return cudaErrorInvalidValue;
  if (B < 2 || shift < 0 || shift > 15) return cudaErrorInvalidValue;
  const long long cells = static_cast<long long>(N) * F * B;
  cudaError_t err = cudaMemsetAsync(acc, 0, cells * 4 * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    switch (bin_bytes) {
      case 1:
        err = launch_fused<uint8_t>(bins, pos_in, payload, n_prev, lo_prev, lo,
                                    missing_bin, B, shift, q, n, F, N,
                                    num_sms, pos_out, acc, stream);
        break;
      case 2:
        err = launch_fused<uint16_t>(bins, pos_in, payload, n_prev, lo_prev,
                                     lo, missing_bin, B, shift, q, n, F, N,
                                     num_sms, pos_out, acc, stream);
        break;
      case 4:
        err = launch_fused<int32_t>(bins, pos_in, payload, n_prev, lo_prev, lo,
                                    missing_bin, B, shift, q, n, F, N,
                                    num_sms, pos_out, acc, stream);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  dequant_int8x2<<<grid_for(cells), 256, 0, stream>>>(
      reinterpret_cast<const int4*>(acc), inv, cells,
      reinterpret_cast<float2*>(out));
  return cudaGetLastError();
}
