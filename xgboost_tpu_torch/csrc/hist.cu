// Gradient histograms for Hopper (sm_90a): kernels K2, K3, K4 and K5.
//
// K2 (`xtt_hist_int8x2`) replaces the TPU kernel
// `xgboost_tpu/ops/pallas/histogram.py _make_int8_kernel` (pallas_call at
// :621 in `build_hist_pallas`). K3 (`xtt_hist_f32`) replaces the f32
// variant of `_make_kernel` (pallas_call at :634). K4 (`xtt_hist_scan`)
// replaces `_make_scan_kernel` (pallas_call at :478 in `scan_hist_pallas`)
// with its `with_coarse` fold (:493-513), and K5
// (`xtt_fused_advance_coarse`) replaces `_make_fused_kernel` (pallas_call
// at :344 in `fused_advance_coarse_pallas`); K4 and K5 are described with
// their entry points at the end. K2, K3 and K4 compute [n_nodes, F, B, 2]
// (g, h) sums by (node, feature, bin) over rows whose rel[row] < n_nodes,
// the function of the JAX package's `ops/histogram.py build_hist`.
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
// K3's bf16 and bf16x2 precisions (`xtt_hist_bf16`, `xtt_hist_bf16x2`,
// the `precision` branch of `_make_kernel`, :92-112) are the same kernel
// with each component rounded to bfloat16 as it is loaded (round to
// nearest even, as the TPU kernel's astype(bfloat16)): hi = bf16(x), and
// for bf16x2 also lo = bf16(x - hi); a row's hi and lo are scaled and
// rounded to int64 apart and added into the same counter. The TPU kernel
// adds its rounded values in f32 on the matrix unit, 1,024-row blocks
// under bf16x2; here the sum is exact and converted once.
//
// K2's and K3's `packed_u4` bodies (`_make_int8_kernel(u4=True)` and
// `_make_kernel(u4=True)`, which read each feature's row of a packed block
// through `_u4_row`, histogram.py:62) are the same kernels over a u4-packed
// page, the external-memory tier's compressed transport (bin ids < 16):
// bins [n, W = ceil(F/2)] bytes, feature f in byte f >> 1 of its row, the
// low nibble for even f and the high one for odd f (bin_bytes 0, the `U4`
// bin type below). Only the element load changes, to
// (bins[row * W + (f >> 1)] >> 4 * (f & 1)) & 0xF; the tiles, the plan
// (over the logical F) and the sums are the unpacked kernel's, so the
// result is bit for bit that of the kernel on the unpacked page. Two
// neighbouring lanes read one byte; a row's bytes are half as many, so
// the least traffic falls by n * F / 2 bytes.
//
// What bounds them: the least traffic is the bins (n*F bytes), the
// gradients and rel read once and the histogram written once (14 us at
// 1M x 28, N = 128, on 3.35 TB/s; at 200k rows and N = 512 the 29 MB f32
// table is most of it). The work is n*F scatter-adds of 4 (K2, K4, K5) or
// 2 (K3) counters into a table that does not fit in shared memory at
// depth (128 nodes x 28 features x 256 bins x 16 B = 14.7 MB), so what a
// design has to avoid is re-reading rows per tile and scattering atomics
// over the device table. What bounds this design on an H100 is the
// shared-memory pipe: four 32-bit atomics an element (K3's two int64 sums
// are kept as 32-bit words with an explicit carry, as 64-bit shared
// atomics cost several times more), at 7-10% of the bytes bound at
// 1M x 28 (PERF.md).
//
// Design (all four kernels share it; the policy structs below say what a
// row adds, the bin maps which slot a bin id lands in): the level is cut
// into groups of G consecutive nodes whose [G, F, B] cells of 16 bytes
// (4 x 32-bit words) fit one 112.5 KB shared-memory tile (at 28 features x
// 256 bins one node, at 36 slots six, at K5's 20 coarse slots twelve);
// where one node does not fit, features and then bins are cut into tiles
// (grid y). The plan (G, the tiles, R rows an item) is computed by the
// wrapper (`ops/cuda/hist.py hist_plan`), where the CPU tests reach it.
// - One group (the whole level fits a tile, e.g. the root, or the 20-slot
//   coarse ids at a few nodes): no sort. Item i reads rows [iR, iR + R) in
//   their own order, each row's rel, gradients and bins once.
// - Several groups: the rows are counting-sorted by node (`scan_count`,
//   `level_plan`, `scan_scatter`); `level_plan` (one block) turns the
//   counts into the runs' offsets and cuts each group's run into items of
//   at most R rows (one item for an empty group).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kCellBytes = 16;          // 4 x 32-bit words a cell

// K2, K4 and K5's row values: the hi/lo byte planes of the quantised
// (g, h).
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
  // the tiles: plane p of cell c in word p * cells + c
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
  static __device__ __forceinline__ void write(Word* base, int i, int cells,
                                               const Counter a[4]) {
#pragma unroll
    for (int p = 0; p < 4; ++p) base[p * cells + i] = a[p];
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
  static __device__ __forceinline__ void write(Word* base, int i, int cells,
                                               const Counter a[2]) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      base[2 * p * cells + i] = static_cast<Word>(a[p]);
      base[(2 * p + 1) * cells + i] = static_cast<Word>(a[p] >> 32);
    }
  }
  // f32(sum) * 2^-k: one rounding of the exact int64 sum
  static __device__ __forceinline__ float2 to_f32(const Counter a[2],
                                                  float i0, float i1) {
    return make_float2(
        __fmul_rn(__ll2float_rn(static_cast<long long>(a[0])), i0),
        __fmul_rn(__ll2float_rn(static_cast<long long>(a[1])), i1));
  }
};

// K3's bf16 (kTwo false) and bf16x2 (kTwo true) precisions: Fixed64 over
// each component's bfloat16 rounding, hi = bf16(x), plus lo = bf16(x - hi)
// for bf16x2, each scaled by 2^k and rounded to int64 apart. A rounded
// value is at most 2^e (max|x| < 2^e), so the wrapper's 2^k keeps the
// int64 sums within range.
template <bool kTwo>
struct RoundedFixed64 : Fixed64 {
  static __device__ __forceinline__ float bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ Counter part(float x, float s) {
    const float hi = bf16(x);
    long long q = __float2ll_rn(__fmul_rn(hi, s));
    if (kTwo) q += __float2ll_rn(__fmul_rn(bf16(__fsub_rn(x, hi)), s));
    return static_cast<Counter>(q);
  }
  __device__ __forceinline__ void expand(Raw x, Counter v[2]) const {
    v[0] = part(x.x, s0);
    v[1] = part(x.y, s1);
  }
};

// Bin maps: the slot a loaded bin id adds into. K2, K3 and K4 add at the
// bin itself; K5 at its coarse id (`ops/split.py coarse_bin_ids`).
struct SameBin {
  __device__ __forceinline__ unsigned operator()(unsigned b) const {
    return b;
  }
};

struct CoarseBin {
  unsigned missing;   // the missing bin (never matches when >= the width)
  unsigned last;      // its coarse slot, B - 1
  int shift;          // the coarse id of any other bin: bin >> shift
  __device__ __forceinline__ unsigned operator()(unsigned b) const {
    return b == missing ? last : b >> shift;
  }
};

// The bin source of a launch: `BinT` bins [n, F] of 1, 2 or 4 bytes an id,
// or `U4`, two ids a byte ([n, ceil(F/2)] bytes, feature f in byte f >> 1,
// the low nibble for even f). load_bin reads feature f of a row.
struct U4 {
  unsigned char byte;
};

template <typename BinT>
__device__ __forceinline__ unsigned load_bin(const BinT* __restrict__ bins,
                                             long long row, int F, int f) {
  return static_cast<unsigned>(bins[row * F + f]);
}

__device__ __forceinline__ unsigned load_bin(const U4* __restrict__ bins,
                                             long long row, int F, int f) {
  const unsigned byte = bins[row * ((F + 1) >> 1) + (f >> 1)].byte;
  return (byte >> (4 * (f & 1))) & 0xFu;
}

// K5's advance of one row below the previous level's splits: a row at a
// node of that level that split reads its bin at the node's split feature
// and moves to 2p + 1 + go_right (the missing bin goes the default way,
// otherwise right when bin > threshold); every other row stays put.
struct Advance {
  const long long* pos_in;
  // the previous level's nodes (`ops/partition.py LevelSplits`, n_prev
  // each): split feature and threshold bin (read where the node split),
  // default_left and can_split
  const long long* feat;
  const long long* thr;
  const unsigned char* dleft;
  const unsigned char* can_split;
  int n_prev;
  long long lo_prev;      // the previous level's first heap node
  long long lo;           // the new level's
  int missing;
  long long* pos_out;
  template <typename BinT>
  __device__ __forceinline__ long long step(const BinT* __restrict__ bins,
                                            long long row, int F) const {
    long long p = pos_in[row];
    const long long j = p - lo_prev;
    if (j >= 0 && j < n_prev && __ldg(can_split + j) != 0) {
      const long long b =
          load_bin(bins, row, F, static_cast<int>(__ldg(feat + j)));
      const bool right = b == missing ? __ldg(dleft + j) == 0
                                      : b > __ldg(thr + j);
      p = 2 * p + 1 + (right ? 1 : 0);
    }
    return p;
  }
  // the row's node in the new level of N nodes; N when outside it
  __device__ __forceinline__ int node(long long p, int N) const {
    const long long k = p - lo;
    return k >= 0 && k < N ? static_cast<int>(k) : N;
  }
};

// K4's `with_coarse` fold (`ops/histogram.py coarse_fold`), taken from a
// node's integer sums while they are in one tile: real slot k < coarse_b
// - 1 holds bins [k << shift, (k + 1) << shift) but the missing one, the
// last slot the missing bin; dequantised once, as the fine cells.
struct Fold {
  float2* out;        // [N, F, coarse_b, 2] (read by kFold kernels only)
  int missing;        // the missing bin (>= B when there is none)
  int coarse_b;
  int shift;
};

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
// two blocks a SM: two blocks of 115,200 B (plus 1 KB each for the
// system) fill the 228 KB of an SM
constexpr int kTilePlanBytes = 115200;
// K5's one-group route keeps the nodes of this many rows (one byte each)
// in shared memory beside its tile (`ops/cuda/hist.py ADVANCE_CHUNK`)
constexpr int kAdvanceChunk = 1024;

// ---- the sort by node ---------------------------------------------------

constexpr int kScanThreads = 512;
constexpr int kSortRowsPerThread = 8;

// Where scan_count finds a row's node: rel, or (K5's sorted route) the
// row's advance, which also writes its new position and its node.
struct RelOf {
  const int* rel;
  __device__ __forceinline__ int operator()(long long r, int) const {
    return __ldg(rel + r);
  }
};

template <typename BinT>
struct AdvanceOf {
  const BinT* bins;
  Advance adv;
  int F;
  int* rel;               // written: each row's node in the new level
  __device__ __forceinline__ int operator()(long long r, int N) const {
    const long long p = adv.step(bins, r, F);
    adv.pos_out[r] = p;
    const int v = adv.node(p, N);
    rel[r] = v;
    return v;
  }
};

// Each block counts its rows per node in shared memory and adds the
// counts to the global ones (one atomic per block and node).
template <typename NodeOf>
__global__ void __launch_bounds__(kScanThreads) scan_count(
    NodeOf node_of, long long n, int N, int* __restrict__ counts) {
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
      const int v = node_of(r, N);
      if (v >= 0 && v < N) atomicAdd(&cnt[v], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    if (cnt[i] != 0) atomicAdd(&counts[i], cnt[i]);
}

// Each block counts again, reserves its place in every node's run with one
// global atomic per node, and writes its active rows' ids there. The order
// inside a run depends on the atomics; the integer sums do not, so the
// result is deterministic.
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
// from the counts, then the items of every group of G nodes: a group of c
// rows takes max(1, ceil(c / R)) items; a group of more than one item gets
// the next partial slots and a place in the split list (in group order).
// Entry n_groups of item_start is the item count; *n_split the split
// groups. `ops/cuda/hist.py group_items` is the same arithmetic in Python.
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

// ---- the tiles -------------------------------------------------------------

// Where add_elements finds the row and the tile node of position i.
struct SortedNodes {        // rows sorted by node, all at group node gi
  static constexpr bool kAllActive = true;
  const int* perm;
  int gi;
  __device__ __forceinline__ void at(long long i, long long& row,
                                     int& node) const {
    row = __ldg(perm + i);
    node = gi;
  }
};

struct RelNodes {           // rows in their order, nodes from rel
  static constexpr bool kAllActive = false;
  const int* rel;
  __device__ __forceinline__ void at(long long i, long long& row,
                                     int& node) const {
    row = i;
    node = __ldg(rel + i);
  }
};

struct ChunkNodes {         // rows in their order, nodes in shared memory
  static constexpr bool kAllActive = false;
  const unsigned char* node_of;   // of rows [c0, c0 + kAdvanceChunk)
  long long c0;
  __device__ __forceinline__ void at(long long i, long long& row,
                                     int& node) const {
    row = i;
    node = node_of[i - c0];
  }
};

// Add the (row, feature) elements of positions [a, e) into the tile;
// `nodes` gives each position's row and tile node (inactive when outside
// [0, N)). Elements run row-major over the tile's fcur features; thread t
// starts at element t and steps by blockDim.x. A thread issues the loads
// of kBatch elements before their adds. The tile keeps each plane's words
// apart (the policies' `add`) and a feature's bins at an odd stride, so
// that the lanes of a warp, which mostly add into different features,
// spread over the banks even where they add into one slot.
template <typename Nodes, typename BinT, typename Pol, typename Map>
__device__ __forceinline__ void add_elements(
    const BinT* __restrict__ bins, const Nodes& nodes, const Pol& pol,
    const Map& map, long long a, long long e, int F, int N, int f0,
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
      nodes.at(row[u], row[u], node[u]);
      bin[u] = load_bin(bins, row[u], F, f0 + feat[u]);
      x[u] = pol.raw(row[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {   // shared-memory integer adds
      if (row[u] < 0) continue;
      const unsigned b = map(bin[u]) - static_cast<unsigned>(b0);
      if (b >= static_cast<unsigned>(bcur)) continue;             // other tile
      if (!Nodes::kAllActive &&
          static_cast<unsigned>(node[u]) >= static_cast<unsigned>(N))
        continue;                                                 // inactive
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

// The fold's work: for each (node, feature) row of a group's tile,
// fold_passes(fd) warp tasks of 32 bins each, the last the missing slot.
__device__ __forceinline__ int fold_passes(const Fold& fd) {
  return ((((fd.coarse_b - 1) << fd.shift) + 31) >> 5) + 1;
}

// Fold task i (< G * fc * fold_passes) of group g's tile (f0; one bin tile;
// in shared memory, or a combined partial in device memory), by one warp
// (all its lanes call it): lane l reads bin 32 * pass + l of row r (a warp
// reads 32 consecutive counters of a plane), and the lanes of one slot's
// span (1 << shift <= 32) sum them by shuffles; the last pass reads the
// missing bin.
template <typename Pol>
__device__ __forceinline__ void fold_task(
    const typename Pol::Word* tile, const TilePlan& tp, int g, int f0, int i,
    int N, int F, int B, const Fold& fd, float i0, float i1) {
  using C = typename Pol::Counter;
  constexpr int P = Pol::kPlanes;
  const int n_pass = fold_passes(fd);
  const int r = i / n_pass;               // (group node, feature) row
  const int pass = i - r * n_pass;
  const int gi = r / tp.fc;
  const int j = r - gi * tp.fc;
  const int node = g * tp.G + gi;
  if (node >= N || f0 + j >= F) return;                  // warp-uniform
  const int cells = tp.G * tp.fc * tp.bs;
  const int lane = threadIdx.x & 31;
  const int n_real = fd.coarse_b - 1;     // slots below the missing one
  const int real_bins = n_real << fd.shift;
  float2* dst = fd.out + (static_cast<long long>(node) * F + f0 + j)
                             * fd.coarse_b;
  C x[P];
#pragma unroll
  for (int p = 0; p < P; ++p) x[p] = 0;
  if (pass == n_pass - 1) {               // the missing slot, or zeros
    if (lane == 0) {
      if (fd.missing < B) Pol::read(tile, r * tp.bs + fd.missing, cells, x);
      dst[n_real] = Pol::to_f32(x, i0, i1);
    }
    return;
  }
  const int b = 32 * pass + lane;
  if (b < B && b < real_bins && b != fd.missing)
    Pol::read(tile, r * tp.bs + b, cells, x);
  const int span = 1 << fd.shift;
  for (int d = span >> 1; d > 0; d >>= 1)
#pragma unroll
    for (int p = 0; p < P; ++p)
      x[p] += __shfl_down_sync(0xffffffffu, x[p], d, span);
  if ((lane & (span - 1)) == 0 && b < real_bins)
    dst[b >> fd.shift] = Pol::to_f32(x, i0, i1);
}

// Row sources of hist_tiles.
enum { kRel, kSorted, kAdvance };

// One block per (item, tile). kRel: one group, rows in their order, nodes
// from rel. kSorted: rows sorted by node (perm, offsets), the item's group
// found from item_start. kAdvance (K5, one group): rows in their order,
// each advanced once as it is loaded (adv): its new position written by
// the first tile's block, its node kept in shared memory beside the tile
// for kAdvanceChunk rows at a time. kFold (K4's fold): a group of one item
// also folds its tile into fold.out.
template <int kRows, typename BinT, typename Pol, typename Map, bool kFold>
__global__ void __launch_bounds__(kThreads, 2) hist_tiles(
    const BinT* __restrict__ bins, const int* __restrict__ rel,
    const int* __restrict__ perm, const int* __restrict__ offsets,
    const int* __restrict__ item_start, const int* __restrict__ pslot,
    Advance adv, Pol pol, Map map, const float* __restrict__ inv,
    long long n, int F, int B, int N, TilePlan tp, Fold fold,
    typename Pol::Word* __restrict__ partial, float2* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename Pol::Word* tile = reinterpret_cast<typename Pol::Word*>(smem_raw);

  const int item = blockIdx.x;
  int g = 0, seg = item, n_seg = gridDim.x, slot = 0;
  if (kRows == kSorted) {
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

  if constexpr (kRows == kSorted) {
    const int k0 = g * tp.G;
    const int k1 = k0 + tp.G < N ? k0 + tp.G : N;
    const long long s0 = offsets[k0] + static_cast<long long>(seg) * tp.R;
    const long long gend = offsets[k1];
    const long long s1 = s0 + tp.R < gend ? s0 + tp.R : gend;
    for (int k = k0; k < k1; ++k) {
      const long long a = offsets[k] > s0 ? offsets[k] : s0;
      const long long e = offsets[k + 1] < s1 ? offsets[k + 1] : s1;
      if (a < e)
        add_elements(bins, SortedNodes{perm, k - k0}, pol, map, a, e, F, N,
                     f0, fcur, tp.fc, b0, bcur, tp.bs, cells, tile);
    }
  } else {
    const long long a = static_cast<long long>(item) * tp.R;
    const long long e = a + tp.R < n ? a + tp.R : n;
    if constexpr (kRows == kRel) {
      if (a < e)
        add_elements(bins, RelNodes{rel}, pol, map, a, e, F, N, f0, fcur,
                     tp.fc, b0, bcur, tp.bs, cells, tile);
    } else {
      unsigned char* node_of = smem_raw + cells * kCellBytes;
      for (long long c0 = a; c0 < e; c0 += kAdvanceChunk) {
        const long long c1 = c0 + kAdvanceChunk < e ? c0 + kAdvanceChunk : e;
        for (long long r = c0 + threadIdx.x; r < c1; r += blockDim.x) {
          const long long p = adv.step(bins, r, F);
          if (t == 0) adv.pos_out[r] = p;
          node_of[r - c0] = static_cast<unsigned char>(adv.node(p, N));
        }
        __syncthreads();
        add_elements(bins, ChunkNodes{node_of, c0}, pol, map, c0, c1, F, N,
                     f0, fcur, tp.fc, b0, bcur, tp.bs, cells, tile);
        __syncthreads();                  // node_of is reused next
      }
    }
  }
  __syncthreads();

  if (n_seg == 1) {                      // the group's only item
    const float i0 = inv[0], i1 = inv[1];
    write_tile<Pol>(tile, tp, g, f0, b0, N, F, B, i0, i1, out);
    if constexpr (kFold)
      for (int i = threadIdx.x >> 5; i < tp.G * tp.fc * fold_passes(fold);
           i += blockDim.x >> 5)
        fold_task<Pol>(tile, tp, g, f0, i, N, F, B, fold, i0, i1);
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
// Unsorted (one group): unsorted_items partials at slot 0. kKeepSums (K4's
// fold): the sums also go back into the group's first partial for
// `fold_partials`; otherwise the partials are read-only here.
constexpr int kCombineWarps = 8;

template <typename Pol, bool kKeepSums>
__global__ void __launch_bounds__(32 * kCombineWarps) combine_partials(
    std::conditional_t<kKeepSums, typename Pol::Word,
                       const typename Pol::Word>* __restrict__ partial,
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
    __syncthreads();                      // every partial has been read
    if (warp % ws == 0 && i < cells) {
      for (int w = 1; w < ws; ++w)
#pragma unroll
        for (int p = 0; p < P; ++p) a[p] += sums[warp + w][p][lane];
      if constexpr (kKeepSums)
        Pol::write(partial + (static_cast<long long>(slot) * n_tiles + t)
                                 * cells * 4,
                   i, cells, a);
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

// K4's fold of the split groups, from the sums `combine_partials` left in
// each group's first partial. Grid: (a stride over the split groups,
// chunk of kFoldWarps fold tasks, feature tile); a warp a task.
constexpr int kFoldWarps = 8;

template <typename Pol>
__global__ void __launch_bounds__(32 * kFoldWarps) fold_partials(
    const typename Pol::Word* __restrict__ partial,
    const int* __restrict__ pslot, const int* __restrict__ split_list,
    const int* __restrict__ n_split, int unsorted, const float* __restrict__
    inv, int F, int B, int N, TilePlan tp, Fold fold) {
  const int t = blockIdx.z;
  const int f0 = t * tp.fc;               // one bin tile (the wrapper's check)
  const int cells = tp.G * tp.fc * tp.bs;
  const int i = blockIdx.y * kFoldWarps + (threadIdx.x >> 5);
  if (i >= tp.G * tp.fc * fold_passes(fold)) return;     // warp-uniform
  const int groups = unsorted ? 1 : *n_split;
  for (int js = blockIdx.x; js < groups; js += gridDim.x) {
    const int g = unsorted ? 0 : split_list[js];
    const int slot = unsorted ? 0 : pslot[g];
    fold_task<Pol>(partial + (static_cast<long long>(slot) * tp.n_ftiles + t)
                                 * cells * 4,
                   tp, g, f0, i, N, F, B, fold, inv[0], inv[1]);
  }
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

// The launches of one level, all on `stream`. kFused (K5): the rows are
// advanced first (adv), in the sort's count or in the one-group tiles.
// kFold (K4's fold): the tiles and the split groups' sums are folded into
// fold.out. marks (optional, for timing): three events recorded after the
// sort (count or advance, plan, scatter), after the tiles and after the
// combine and fold.
template <typename BinT, typename Pol, typename Map, bool kFused, bool kFold>
cudaError_t launch_tiles(const BinT* bins, const int* rel, const Advance& adv,
                         Pol pol, Map map, const float* inv, long long n,
                         int F, int B, int N, const TilePlan& tp,
                         const Fold& fold, int* work,
                         typename Pol::Word* partial, float2* out,
                         cudaEvent_t const* marks, cudaStream_t stream) {
  const int cells = tp.G * tp.fc * tp.bs;
  const int n_tiles = tp.n_ftiles * tp.n_btiles;
  const dim3 grid(static_cast<unsigned>(tp.max_items), n_tiles);
  const unsigned chunks = static_cast<unsigned>((cells + 31) / 32);
  const int fold_tasks =
      tp.G * tp.fc * (((((fold.coarse_b - 1) << fold.shift) + 31) >> 5) + 1);
  const unsigned fold_chunks = static_cast<unsigned>(
      (fold_tasks + kFoldWarps - 1) / kFoldWarps);
  auto mark = [&](int i) {
    if (marks != nullptr) cudaEventRecord(marks[i], stream);
  };
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
    if (n > 0) {
      if constexpr (kFused) {
        int* rel_w = n_split + 1;         // the advanced rows' nodes
        scan_count<<<sort_blocks, kScanThreads, N * sizeof(int), stream>>>(
            AdvanceOf<BinT>{bins, adv, F, rel_w}, n, N, counts);
        rel = rel_w;
      } else {
        scan_count<<<sort_blocks, kScanThreads, N * sizeof(int), stream>>>(
            RelOf{rel}, n, N, counts);
      }
    }
    level_plan<<<1, kPlanThreads, 0, stream>>>(
        counts, N, tp.G, tp.n_groups, tp.R, offsets, cursor, item_start,
        pslot, split_list, n_split);
    if (n > 0)
      scan_scatter<<<sort_blocks, kScanThreads, 2 * N * sizeof(int),
                     stream>>>(rel, n, N, cursor, perm);
    mark(0);
    static unsigned ready = 0;   // per instantiation
    auto kernel = hist_tiles<kSorted, BinT, Pol, Map, kFold>;
    err = allow_tile(kernel, &ready);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, cells * kCellBytes, stream>>>(
        bins, rel, perm, offsets, item_start, pslot, adv, pol, map, inv, n, F,
        B, N, tp, fold, partial, out);
    mark(1);
    // about 2048 blocks over the split groups' chunks, looping over groups
    const unsigned stride = static_cast<unsigned>(
        tp.max_split < 2048 / chunks ? tp.max_split : (2048 + chunks - 1)
                                                          / chunks);
    if (tp.max_split > 0) {
      combine_partials<Pol, kFold><<<dim3(stride, chunks, n_tiles),
                                     32 * kCombineWarps, 0, stream>>>(
          partial, item_start, pslot, split_list, n_split, 0, inv, F, B, N,
          tp, out);
      if constexpr (kFold) {
        // the fold's own stride over the groups: about 2048 blocks too
        const unsigned fold_stride = static_cast<unsigned>(
            tp.max_split < 2048 / fold_chunks ? tp.max_split
                                              : 2048 / fold_chunks + 1);
        fold_partials<Pol><<<dim3(fold_stride, fold_chunks, n_tiles),
                             32 * kFoldWarps, 0, stream>>>(
            partial, pslot, split_list, n_split, 0, inv, F, B, N, tp, fold);
      }
    }
  } else {
    mark(0);
    if constexpr (kFused) {
      static unsigned ready = 0;   // per instantiation
      auto kernel = hist_tiles<kAdvance, BinT, Pol, Map, kFold>;
      err = allow_tile(kernel, &ready);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, cells * kCellBytes + kAdvanceChunk, stream>>>(
          bins, nullptr, nullptr, nullptr, nullptr, nullptr, adv, pol, map,
          inv, n, F, B, N, tp, fold, partial, out);
    } else {
      static unsigned ready = 0;   // per instantiation
      auto kernel = hist_tiles<kRel, BinT, Pol, Map, kFold>;
      err = allow_tile(kernel, &ready);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, cells * kCellBytes, stream>>>(
          bins, rel, nullptr, nullptr, nullptr, nullptr, adv, pol, map, inv,
          n, F, B, N, tp, fold, partial, out);
    }
    mark(1);
    if (tp.max_items > 1) {
      combine_partials<Pol, kFold><<<dim3(1, chunks, n_tiles),
                                     32 * kCombineWarps, 0, stream>>>(
          partial, nullptr, nullptr, nullptr, nullptr, tp.max_items, inv, F,
          B, N, tp, out);
      if constexpr (kFold)
        fold_partials<Pol><<<dim3(1, fold_chunks, n_tiles), 32 * kFoldWarps,
                             0, stream>>>(
            partial, nullptr, nullptr, nullptr, 1, inv, F, B, N, tp, fold);
    }
  }
  mark(2);
  return cudaGetLastError();
}

// Reads and checks the wrapper's plan, then launches the kernels for the
// bin width.
template <typename Pol, typename Map, bool kFused, bool kFold>
cudaError_t run_tiles(const void* bins, int bin_bytes, const int* rel,
                      const Advance& adv, Pol pol, Map map, const float* inv,
                      long long n, int F, int B, int N, const long long* plan,
                      const Fold& fold, int* work, int* partial, float* out,
                      cudaEvent_t const* marks, cudaStream_t stream) {
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
  // K5's one-group route keeps a chunk's node ids beside its tile
  const long long extra = kFused && !tp.sorted ? kAdvanceChunk : 0;
  if (tp.G < 1 || tp.fc < 1 || tp.bc < 1 || tp.bs < tp.bc || tp.R < 1 ||
      tp.max_items < 1 ||
      cells * kCellBytes + extra > kTilePlanBytes ||
      static_cast<long long>(tp.n_ftiles) * tp.fc < F ||
      static_cast<long long>(tp.n_btiles) * tp.bc < B ||
      static_cast<long long>(tp.n_groups) * tp.G < N ||
      tp.n_ftiles * tp.n_btiles > 65535 || (tp.sorted && N > 4096) ||
      (tp.sorted && tp.n_groups > kPlanThreads * kPlanPer) ||
      (!tp.sorted && tp.n_groups != 1) || n >= (1LL << 31) ||
      (kFused && N > 255) ||                 // byte node ids
      (kFold &&                              // a feature's bins in one tile
       (fold.out == nullptr || tp.n_btiles != 1 || fold.coarse_b < 2 ||
        fold.shift < 0 || fold.shift > 5)))
    return cudaErrorInvalidValue;
  auto* words = reinterpret_cast<typename Pol::Word*>(partial);
  float2* out2 = reinterpret_cast<float2*>(out);
  switch (bin_bytes) {
    case 0:                                  // u4-packed pages: K2 and K3
      if constexpr (kFused || kFold) return cudaErrorInvalidValue;
      else
        return launch_tiles<U4, Pol, Map, kFused, kFold>(
            static_cast<const U4*>(bins), rel, adv, pol, map, inv, n, F, B,
            N, tp, fold, work, words, out2, marks, stream);
    case 1:
      return launch_tiles<uint8_t, Pol, Map, kFused, kFold>(
          static_cast<const uint8_t*>(bins), rel, adv, pol, map, inv, n, F, B,
          N, tp, fold, work, words, out2, marks, stream);
    case 2:
      return launch_tiles<uint16_t, Pol, Map, kFused, kFold>(
          static_cast<const uint16_t*>(bins), rel, adv, pol, map, inv, n, F,
          B, N, tp, fold, work, words, out2, marks, stream);
    case 4:
      return launch_tiles<int32_t, Pol, Map, kFused, kFold>(
          static_cast<const int32_t*>(bins), rel, adv, pol, map, inv, n, F, B,
          N, tp, fold, work, words, out2, marks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

constexpr Advance kNoAdvance{nullptr, nullptr, nullptr, nullptr, nullptr,
                             0,       0,       0,       0,       nullptr};
constexpr Fold kNoFold{nullptr, 0, 0, 0};

}  // namespace

// K2. bins [n, F] (bin_bytes 1, 2 or 4 bytes per id; 0: u4-packed,
// [n, ceil(F/2)] bytes, at most 16 bin slots), rel [n] int32, q [n, 2] int32,
// inv [2] f32 on the device; plan: the host array of TilePlan's eleven
// fields that `ops/cuda/hist.py hist_plan` makes; work: int32 scratch of
// `hist_work_ints` entries; partial: 16-byte aligned 32-bit scratch of
// `hist_partial_words` entries; out [N, F, B, 2] f32, every entry
// written. Returns a cudaError_t (0 on success). Launches on `stream` and
// does not synchronise.
extern "C" int xtt_hist_int8x2(const void* bins, int bin_bytes,
                               const int* rel, const int* q, const float* inv,
                               long long n, int F, int B, int N,
                               const long long* plan, int* work, int* partial,
                               float* out, cudaStream_t stream) {
  return run_tiles<Int8x2, SameBin, false, false>(
      bins, bin_bytes, rel, kNoAdvance,
      Int8x2{reinterpret_cast<const int2*>(q)}, SameBin{}, inv, n, F, B, N,
      plan, kNoFold, work, partial, out, nullptr, stream);
}

// K3: the same with gpair [n, 2] f32, qscale [2] (2^k) and inv [2] (2^-k)
// f32 (u4-packed bins too, in each precision).
extern "C" int xtt_hist_f32(const void* bins, int bin_bytes, const int* rel,
                            const float* gpair, const float* qscale,
                            const float* inv, long long n, int F, int B,
                            int N, const long long* plan, int* work,
                            int* partial, float* out, cudaStream_t stream) {
  return run_tiles<Fixed64, SameBin, false, false>(
      bins, bin_bytes, rel, kNoAdvance,
      Fixed64{reinterpret_cast<const float2*>(gpair), qscale, 0.0f, 0.0f},
      SameBin{}, inv, n, F, B, N, plan, kNoFold, work, partial, out, nullptr,
      stream);
}

// K3's bf16 and bf16x2 precisions: K3's arguments; each component of
// gpair is rounded to bfloat16 (bf16x2: also its remainder) before it is
// summed (RoundedFixed64).
extern "C" int xtt_hist_bf16(const void* bins, int bin_bytes, const int* rel,
                             const float* gpair, const float* qscale,
                             const float* inv, long long n, int F, int B,
                             int N, const long long* plan, int* work,
                             int* partial, float* out, cudaStream_t stream) {
  return run_tiles<RoundedFixed64<false>, SameBin, false, false>(
      bins, bin_bytes, rel, kNoAdvance,
      RoundedFixed64<false>{
          {reinterpret_cast<const float2*>(gpair), qscale, 0.0f, 0.0f}},
      SameBin{}, inv, n, F, B, N, plan, kNoFold, work, partial, out, nullptr,
      stream);
}

extern "C" int xtt_hist_bf16x2(const void* bins, int bin_bytes,
                               const int* rel, const float* gpair,
                               const float* qscale, const float* inv,
                               long long n, int F, int B, int N,
                               const long long* plan, int* work, int* partial,
                               float* out, cudaStream_t stream) {
  return run_tiles<RoundedFixed64<true>, SameBin, false, false>(
      bins, bin_bytes, rel, kNoAdvance,
      RoundedFixed64<true>{
          {reinterpret_cast<const float2*>(gpair), qscale, 0.0f, 0.0f}},
      SameBin{}, inv, n, F, B, N, plan, kNoFold, work, partial, out, nullptr,
      stream);
}

// ---- K4: the int8x2 histogram over rows sorted by node, with its fold ----
//
// The TPU kernel streams 2048-row blocks of rows that its wrapper
// counting-sorted by node (`ops/partition.py counting_sort_by_node`), so
// each block's accumulator tile is one node's [F, B, 4] int32 sums however
// many nodes the level has; `with_coarse` folds those sums into the
// 20-slot coarse histogram of the two-level search before one
// dequantisation. On the H100, K2's tiles do exactly that: at 28 features
// x 257 slots one node fills one tile (G = 1), so K4 is K2's instantiation
// over the same plan (the same function, bit for bit), sorted from two
// nodes up and read in row order at the root. What bounds it is K2's
// bound and K2's shared-memory pipe. Its fold runs where the node's sums
// are integers in one place: in the tile's epilogue for a node of one
// item, after `combine_partials` (which leaves the summed integers in the
// node's first partial) in `fold_partials` for a split node. Each coarse
// cell is written once, as each fine one; no table is zeroed, no global
// atomic, no second dequantisation.
//
// K2's arguments, then missing_bin (>= B when there is none), coarse_b and
// shift (`ops/split.py`: 20 slots, ids bin >> 4; shift <= 5) and coarse
// [N, F, coarse_b, 2] f32 (nullptr: no fold; otherwise no bin tiles, which
// holds for B <= 257); marks: nullptr, or three events recorded after the
// sort, the tiles and the combine (for timing). Returns a cudaError_t (0
// on success). Launches on `stream` and does not synchronise.
extern "C" int xtt_hist_scan(const void* bins, int bin_bytes, const int* rel,
                             const int* q, const float* inv, long long n,
                             int F, int B, int N, const long long* plan,
                             int* work, int* partial, float* out,
                             int missing_bin, int coarse_b, int shift,
                             float* coarse, cudaEvent_t const* marks,
                             cudaStream_t stream) {
  const Fold fold{reinterpret_cast<float2*>(coarse), missing_bin, coarse_b,
                  shift};
  const Int8x2 pol{reinterpret_cast<const int2*>(q)};
  if (coarse == nullptr)
    return run_tiles<Int8x2, SameBin, false, false>(
        bins, bin_bytes, rel, kNoAdvance, pol, SameBin{}, inv, n, F, B, N,
        plan, fold, work, partial, out, marks, stream);
  return run_tiles<Int8x2, SameBin, false, true>(
      bins, bin_bytes, rel, kNoAdvance, pol, SameBin{}, inv, n, F, B, N, plan,
      fold, work, partial, out, marks, stream);
}

// ---- K5: the level advance fused with the next level's coarse histogram --
//
// One sweep at a level boundary of the `fused` schedule: each row below a
// split of the previous level moves to 2p + 1 + go_right, the positions
// are written, and the rows in the new level add their four int8x2 planes
// at every feature's coarse id (bin >> shift, the missing bin on slot
// B - 1). The TPU kernel adds 2048-row blocks of each coarse bin's sums
// in f32, so it equals this exact-int32 function only while those sums
// stay below 2^24 quanta; K5 is K2's function over the coarse ids at
// every size.
//
// Design: K2's tiles with the coarse map applied to each bin id as it is
// loaded (at 20 slots and stride 21, twelve nodes a group at 28
// features). A level whose nodes fit one or two feature tiles (up to 24
// nodes at 28 features) is read in row order: each item advances its
// rows as it loads them, kAdvanceChunk rows at a time, once per feature
// tile (the first tile's blocks write the positions); a second tile costs
// less than the sort. At a wider level the advance is fused into the
// sort's count (`scan_count` with `AdvanceOf` writes the positions and
// each row's node), and the tiles read the sorted rows. So each row's
// position and split bin are read once or twice, not once per tile of a
// few nodes. What bounds it: the least traffic is ~52 MB at 1M x 28
// (bins, q and the positions read, the positions and the table written),
// ~16 us; what sets its pace is K2's: four shared-memory atomics per
// (row, feature), which cost the same at 20 slots as at 256 (PERF.md).
//
// bins [n, F] (1, 2 or 4 bytes per id), pos_in [n] int64 heap ids; the
// previous level's n_prev nodes from heap node lo_prev: feat and thr
// [n_prev] int64, dleft and can_split [n_prev] bool (one byte each);
// q [n, 2] int32, inv [2] f32; the new level has N <= 255 nodes from heap
// node lo.
// The coarse geometry comes from the caller (`ops/split.py`): B coarse
// slots, coarse id bin >> shift, the missing bin on slot B - 1. plan, work
// and partial as K2's over [N, F, B] (`ops/cuda/hist.py fused_plan`,
// `fused_work_ints`). Writes pos_out [n] int64 and out [N, F, B, 2] f32;
// marks as K4's. Returns a cudaError_t (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int xtt_fused_advance_coarse(
    const void* bins, int bin_bytes, const long long* pos_in,
    const long long* feat, const long long* thr, const unsigned char* dleft,
    const unsigned char* can_split, int n_prev, long long lo_prev,
    long long lo, int missing_bin, int B, int shift, const int* q,
    const float* inv, long long n, int F, int N, const long long* plan,
    int* work, int* partial, long long* pos_out, float* out,
    cudaEvent_t const* marks, cudaStream_t stream) {
  if (n_prev < 1 || B < 2 || shift < 0 || shift > 15)
    return cudaErrorInvalidValue;
  const Advance adv{pos_in, feat, thr, dleft, can_split, n_prev, lo_prev, lo,
                    missing_bin, pos_out};
  const CoarseBin map{static_cast<unsigned>(missing_bin),
                      static_cast<unsigned>(B - 1), shift};
  return run_tiles<Int8x2, CoarseBin, true, false>(
      bins, bin_bytes, nullptr, adv, Int8x2{reinterpret_cast<const int2*>(q)},
      map, inv, n, F, B, N, plan, kNoFold, work, partial, out, marks, stream);
}
