// Packed-forest walk for Hopper (sm_90a), kernel K1.
//
// Replaces the TPU kernel `xgboost_tpu/ops/pallas/walk.py _walk_kernel`
// (pallas_call in `_walk_pallas`), and computes the function of the JAX
// package's `ops/walk.py walk_packed`: categorical splits and node pools
// of any size included, which the TPU kernel refused.
//
// What bounds it: every (row, tree slot) pair walks up to max_depth
// dependent node visits, each a node (word and threshold) and a feature
// value at data-dependent addresses. The least possible traffic (pool
// once, X once, the output once) takes a few microseconds at 3.35 TB/s,
// so the walk is bound by its dependent loads. The TPU kernel pins the
// whole pool in VMEM and streams row blocks through it; a serving
// forest's pool (1.5 MB for 500 depth-8 trees) does not fit a block's
// 227 KB of shared memory, so there are two schedules, chosen by the plan
// in `ops/cuda/walk.py walk_plan`:
//
// - spread (small batches, and trees too large to stage): a block takes
//   one row or a few, its threads take tree slots, each thread walks its
//   tree out of L1/L2 (the pool stays in the 50 MB L2 across launches).
//   A row costs max_depth dependent trips, not Tp/32 rounds of them.
// - staged (large batches): one block a SM, a thread a row of its tile of
//   T rows, whose features sit in shared memory column-major ([F][T]: the
//   32 rows of a warp read 32 banks at any features). The forest streams
//   through shared memory in chunks of consecutive tree slots, each one
//   contiguous span of the pool (a node's word and threshold side by
//   side, one 8-byte load a visit), copied with cp.async into a double
//   buffer while the previous chunk is walked; each chunk's slots (local
//   root, weight, group) beside it. A thread walks kChains trees at once
//   (step_shared: predicated shared loads on 32-bit addresses). Pad slots
//   point at the inert leaf after the last tree, which the last chunk's
//   span holds. What sets its pace: the shared-memory wavefronts of the
//   node loads (the rows of a warp meet at the top levels of a tree, but
//   reach random nodes of the deep ones, in conflicting banks) and the
//   instructions of a step; restaging the pool once a tile costs < 10%.
//
// One summation order for both schedules, so that a row's margin does
// not depend on its batch or schedule (ops/walk.py walk_fold_kernel_order
// replays it in PyTorch):
// - one group: partial l (l = 0..31) folds the terms of slots t = l mod 32
//   in increasing t, from 0.0f; then a[l] += a[l + o] for o = 16, 8, 4,
//   2, 1 (a warp's xor butterfly, or the same adds in one thread); then
//   base.
// - several groups: a left fold of each group's terms in slot order, from
//   0.0f; then base.
// A term is __fmul_rn(leaf value, tree weight); every add is __fadd_rn,
// so the compiler contracts nothing into an FMA. No float atomics.
//
// Layout (serve/packed.py):
//   bits  0..15  left-child offset (right child = left + 1); 0 at leaves
//   bits 16..28  split feature id
//   bit   29     default-left       bit 30  categorical       bit 31  leaf

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr uint32_t kOffMask = 0xFFFFu;
constexpr int kFeatShift = 16;
constexpr uint32_t kFeatMask = 0x1FFFu;
constexpr int kDlBit = 29;
constexpr int kCatBit = 30;
constexpr uint32_t kLeaf = 1u << 31;
// ops/cuda/walk.py SPREAD_THREADS, STAGED_MAX_ROWS, SMEM_MAX
constexpr int kSpreadThreads = 512;
constexpr int kStagedMaxThreads = 768;
constexpr int kSmemMax = 232448;
// trees a staged thread walks at once
constexpr int kChains = 4;
// tree slots of a staged chunk, at most (ops/cuda/walk.py CHUNK_MAX_SLOTS)
constexpr int kChunkMaxSlots = 256;

// ops/cuda/walk.py WalkPlan, field for field (the host array the entry
// point reads)
struct WalkPlan {
  long long staged;     // 0: spread, 1: staged
  long long threads;    // of a block
  long long rows;       // rows of a block
  long long slots;      // spread: tree slots a round
  long long stage_x;    // features staged in shared memory
  long long n_chunks;   // staged: chunks of tree slots
  long long capacity;   // staged: nodes of one chunk buffer
  long long smem;       // dynamic shared memory of a block
};

// A node as the walk reads it: (word, threshold or leaf value bits),
// interleaved from `words` and `values` (serve/packed.py device_arrays
// "nodes"), so a visit is one 8-byte load.
struct Forest {
  const uint2* nodes;
  const uint32_t* cat_words;   // null unless categorical
  int n_words;
  const int* tree_offsets;
  const float* tree_weight;
  const int* tree_group;
  int n_trees;                 // slots, Tp
};

// Whether a feature value xv goes right at internal node `gidx` (word w,
// threshold v): NaN, and at a categorical node an out-of-range code =
// trunc(x), go the default way. Default left: right iff x > v (false for
// NaN); default right: right iff !(x <= v) (true for NaN).
template <bool kCat>
__device__ __forceinline__ bool goes_right(uint32_t w, float v, float xv,
                                           const Forest& f, long long gidx) {
  const bool dl = (w >> kDlBit) & 1u;
  bool go_right = dl ? xv > v : !(xv <= v);
  if (kCat && ((w >> kCatBit) & 1u)) {
    // in range when 0 <= code < n_words*32, compared in float so NaN and
    // huge values never reach an int conversion
    const float xt = truncf(xv);
    if (xt >= 0.0f && xt < static_cast<float>(f.n_words) * 32.0f) {
      const int code = static_cast<int>(xt);
      const uint32_t word =
          __ldg(f.cat_words + gidx * f.n_words + (code >> 5));
      go_right = ((word >> (code & 31)) & 1u) == 0u;
    } else {
      go_right = !dl;   // out-of-range code at a categorical node
    }
  }
  return go_right;
}

// ---- spread: a block's threads take tree slots of its rows ----------------

// Block of RB rows x S slots (S a multiple of 32). Rounds of S slots: each
// thread walks its slot's tree from global memory and leaves its term in
// shared memory; then, for one group, the row's first 32 threads fold the
// round's terms into their partials (thread l: slots l, l + 32, ... in
// order) and finish with the warp's butterfly; for several groups, thread
// g folds group g's terms of the round in slot order.
template <bool kCat, bool kMulti>
__global__ void __launch_bounds__(kSpreadThreads)
walk_spread(Forest f, const float* __restrict__ X, long long n_rows, int F,
            const float* __restrict__ base, int G, int max_depth, int S,
            int stage_x, float* __restrict__ out,
            int* __restrict__ leaf_index) {
  extern __shared__ __align__(16) float smem[];
  const int RB = blockDim.x / S;
  const int rb = threadIdx.x / S;
  const int s = threadIdx.x - rb * S;
  const long long row = static_cast<long long>(blockIdx.x) * RB + rb;
  const bool live = row < n_rows;
  float* terms = smem;                                    // [RB, S]
  int* groups = reinterpret_cast<int*>(terms + RB * S);   // [S]
  float* acc =                                            // [RB, G]
      reinterpret_cast<float*>(groups + (kMulti ? S : 0));
  float* xs = acc + (kMulti ? RB * G : 0);                // [RB, F]
  const float* xr = X + (live ? row : 0) * F;
  if (stage_x) {
    for (int e = s; e < F; e += S)
      xs[rb * F + e] = live ? __ldg(xr + e) : 0.0f;
    xr = xs + rb * F;
  }
  if (kMulti)
    for (int g = s; g < G; g += S) acc[rb * G + g] = 0.0f;
  __syncthreads();

  const int Tp = f.n_trees;
  float part = 0.0f;
  for (int t0 = 0; t0 < Tp; t0 += S) {
    const int t = t0 + s;
    float term = 0.0f;
    if (live && t < Tp) {
      int idx = __ldg(f.tree_offsets + t);
      uint2 nd = __ldg(f.nodes + idx);
      for (int d = 0; d < max_depth && !(nd.x & kLeaf); ++d) {
        const float xv = xr[(nd.x >> kFeatShift) & kFeatMask];
        idx += static_cast<int>(nd.x & kOffMask) +
               goes_right<kCat>(nd.x, __uint_as_float(nd.y), xv, f, idx);
        nd = __ldg(f.nodes + idx);
      }
      term = __fmul_rn(__uint_as_float(nd.y), __ldg(f.tree_weight + t));
      if (leaf_index) leaf_index[row * Tp + t] = idx;
    }
    terms[threadIdx.x] = term;
    if (kMulti && rb == 0) groups[s] = t < Tp ? __ldg(f.tree_group + t) : -1;
    __syncthreads();
    const float* rt = terms + rb * S;
    if (!kMulti) {
      if (s < kWarp)
        for (int k = s; k < S && t0 + k < Tp; k += kWarp)
          part = __fadd_rn(part, rt[k]);
    } else {
      const int cnt = min(S, Tp - t0);
      for (int g = s; g < G; g += S) {
        float a = acc[rb * G + g];
        for (int k = 0; k < cnt; ++k)
          if (groups[k] == g) a = __fadd_rn(a, rt[k]);
        acc[rb * G + g] = a;
      }
    }
    __syncthreads();
  }

  if (!kMulti) {
    if (s < kWarp) {   // a whole warp: S is a multiple of 32
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
      if (s == 0 && live) out[row] = __fadd_rn(part, __ldg(base));
    }
  } else if (live) {
    for (int g = s; g < G; g += S)
      out[row * G + g] = __fadd_rn(acc[rb * G + g], __ldg(base + g));
  }
}

// ---- staged: a thread a row, the forest through shared memory ------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of chunk `ch` (first slot, end slot, span start aligned
// to 2 nodes, span nodes) into nd: 16-byte pieces of two nodes, then an
// odd last node alone, so that nothing past the span is read. Its slots'
// (chunk-local root, weight bits, group) go to mt, read back as one
// broadcast load a slot.
__device__ __forceinline__ void stage_chunk(const Forest& f, int4 ch,
                                            uint2* nd, int4* mt) {
  const int pairs = ch.w >> 1;
  for (int k = threadIdx.x; k < pairs; k += blockDim.x)
    cp_async16(nd + 2 * k, f.nodes + ch.z + 2 * k);
  if ((ch.w & 1) && threadIdx.x == 0)
    cp_async8(nd + ch.w - 1, f.nodes + ch.z + ch.w - 1);
  for (int i = threadIdx.x; i < ch.y - ch.x; i += blockDim.x) {
    const int t = ch.x + i;
    mt[i] = make_int4(__ldg(f.tree_offsets + t) - ch.z,
                      __float_as_int(__ldg(f.tree_weight + t)),
                      __ldg(f.tree_group + t), 0);
  }
}

// One step of a numeric walk out of shared memory, on 32-bit shared
// addresses: at an internal node (w, vb: word, threshold bits) read x at
// xa, go to the child, load it; at a leaf do nothing. goes_right's
// routing, as predicates: right = (x > v and default left) or (!(x <= v)
// and default right).
__device__ __forceinline__ void step_shared(uint32_t& w, uint32_t& vb,
                                            int& idx, uint32_t xa,
                                            uint32_t nd_s) {
  asm(
      "{\n"
      " .reg .pred pl, pd, pg, pu;\n"
      " .reg .b32 t, a;\n"
      " .reg .f32 x, v;\n"
      " setp.ge.s32 pl, %0, 0;\n"
      " mov.b32 x, 0f00000000;\n"
      " @pl ld.shared.f32 x, [%3];\n"
      " mov.b32 v, %1;\n"
      " and.b32 t, %0, 0x20000000;\n"
      " setp.ne.b32 pd, t, 0;\n"
      " setp.gt.and.f32 pg, x, v, pd;\n"
      " setp.gtu.and.f32 pu, x, v, !pd;\n"
      " or.pred pg, pg, pu;\n"
      " and.pred pg, pg, pl;\n"
      " and.b32 t, %0, 0xFFFF;\n"
      " add.s32 %2, %2, t;\n"
      " @pg add.s32 %2, %2, 1;\n"
      " shl.b32 a, %2, 3;\n"
      " add.u32 a, a, %4;\n"
      " @pl ld.shared.v2.u32 {%0, %1}, [a];\n"
      "}\n"
      : "+r"(w), "+r"(vb), "+r"(idx)
      : "r"(xa), "r"(nd_s));
}

// Walks kChains trees of one row out of a staged chunk `nd`, all at once:
// idx (chunk-local) and node hold each root on entry and each leaf on
// exit. A chain on a leaf (an unused chain is given a leaf word) stays,
// and loads nothing. xcol: this row's feature 0 in the [F][T] tile,
// feature f at xstride * f bytes from it.
template <bool kCat, bool kStageX>
__device__ __forceinline__ void walk_chains(
    const Forest& f, const uint2* nd, int span_start, const char* xcol,
    int xstride, const float* xrow, int max_depth, int (&idx)[kChains],
    uint2 (&node)[kChains]) {
  const uint32_t nd_s = static_cast<uint32_t>(__cvta_generic_to_shared(nd));
  const uint32_t xs_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(xcol));
  for (int d = 0; d < max_depth; ++d) {
    uint32_t all = kLeaf;
#pragma unroll
    for (int k = 0; k < kChains; ++k) all &= node[k].x;
    if (all) break;
    if (!kCat && kStageX) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        const uint32_t feat = (node[k].x >> kFeatShift) & kFeatMask;
        step_shared(node[k].x, node[k].y, idx[k], xs_s + feat * xstride,
                    nd_s);
      }
      continue;
    }
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      const uint32_t w = node[k].x;
      if (w & kLeaf) continue;   // no loads for a finished chain
      const int feat = static_cast<int>((w >> kFeatShift) & kFeatMask);
      const float xv =
          kStageX ? *reinterpret_cast<const float*>(xcol + feat * xstride)
                  : __ldg(xrow + feat);
      idx[k] += static_cast<int>(w & kOffMask) +
                goes_right<kCat>(w, __uint_as_float(node[k].y), xv, f,
                                 static_cast<long long>(span_start) + idx[k]);
      node[k] = nd[idx[k]];
    }
  }
}

// Tile of T rows (blockDim.x), one thread a row; the chunks of `chunks`
// [n_chunks] in turn, each walked as 32-slot groups (slots t0 .. t0 + 31,
// t0 a multiple of 32) so that, for one group, term j of a group goes to
// the register acc[j] by a static index. Shared memory: nodes [2][cap],
// slot metadata [2][M] (M = min(Tp, kChunkMaxSlots)), then X [F][T]
// (kStageX), then the group sums [G][T] (kMulti).
template <bool kCat, bool kMulti, bool kStageX>
__global__ void __launch_bounds__(kStagedMaxThreads, 1)
walk_staged(Forest f, const int4* __restrict__ chunks, int n_chunks, int cap,
            const float* __restrict__ X, long long n_rows, int F,
            const float* __restrict__ base, int G, int max_depth,
            float* __restrict__ out, int* __restrict__ leaf_index) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int r = threadIdx.x;
  const int M = min(f.n_trees, kChunkMaxSlots);
  uint2* nd0 = reinterpret_cast<uint2*>(smem);
  int4* mt0 = reinterpret_cast<int4*>(nd0 + 2 * cap);
  float* xs = reinterpret_cast<float*>(mt0 + 2 * M);
  float* accs = xs + (kStageX ? F * T : 0);
  const long long row0 = static_cast<long long>(blockIdx.x) * T;
  const long long row = row0 + r;
  const bool live = row < n_rows;
  const int Tp = f.n_trees;

  stage_chunk(f, __ldg(chunks), nd0, mt0);
  cp_async_commit();
  if (kStageX) {
    const int rows_here = static_cast<int>(min(static_cast<long long>(T),
                                               n_rows - row0));
    const float* xt = X + row0 * F;
#pragma unroll 4
    for (int e = r; e < rows_here * F; e += T) {
      const int rr = e / F;
      xs[(e - rr * F) * T + rr] = __ldg(xt + e);
    }
  }
  if (kMulti)
    for (int g = 0; g < G; ++g) accs[g * T + r] = 0.0f;
  const float* xrow = X + (live ? row : 0) * F;
  const char* xcol = reinterpret_cast<const char*>(xs + r);
  const int xstride = 4 * T;
  int* li = leaf_index != nullptr && live ? leaf_index + row * Tp : nullptr;

  float acc[kWarp];
#pragma unroll
  for (int j = 0; j < kWarp; ++j) acc[j] = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage_chunk(f, __ldg(chunks + c + 1), nd0 + ((c + 1) & 1) * cap,
                  mt0 + ((c + 1) & 1) * M);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int4 ch = __ldg(chunks + c);
    const uint2* nd = nd0 + (c & 1) * cap;
    const int4* mt = mt0 + (c & 1) * M;
    if (live) {
      for (int t0 = ch.x & ~(kWarp - 1); t0 < ch.y; t0 += kWarp) {
#pragma unroll
        for (int j = 0; j < kWarp; j += kChains) {
          int4 m[kChains];
          int idx[kChains];
          uint2 node[kChains];
#pragma unroll
          for (int k = 0; k < kChains; ++k) {
            const int t = t0 + j + k;
            m[k] = t >= ch.x && t < ch.y ? mt[t - ch.x]
                                         : make_int4(-1, 0, 0, 0);
            idx[k] = max(m[k].x, 0);
            node[k] = m[k].x >= 0 ? nd[idx[k]] : make_uint2(kLeaf, 0u);
          }
          walk_chains<kCat, kStageX>(f, nd, ch.z, xcol, xstride, xrow,
                                     max_depth, idx, node);
#pragma unroll
          for (int k = 0; k < kChains; ++k) {
            if (m[k].x >= 0) {
              const float term = __fmul_rn(__uint_as_float(node[k].y),
                                           __int_as_float(m[k].y));
              if (kMulti) {
                float* a = accs + m[k].z * T + r;
                *a = __fadd_rn(*a, term);
              } else {
                acc[j + k] = __fadd_rn(acc[j + k], term);
              }
              if (li) li[t0 + j + k] = ch.z + idx[k];
            }
          }
        }
      }
    }
    __syncthreads();   // the next iteration's copy overwrites this buffer
  }

  if (!live) return;
  if (kMulti) {
    for (int g = 0; g < G; ++g)
      out[row * G + g] = __fadd_rn(accs[g * T + r], __ldg(base + g));
  } else {
    // the warp butterfly's adds, in one thread
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
#pragma unroll
      for (int l = 0; l < o; ++l) acc[l] = __fadd_rn(acc[l], acc[l + o]);
    out[row] = __fadd_rn(acc[0], __ldg(base));
  }
}

// The shared-memory limit (and for the staged kernels the carveout), set
// once for each kernel and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool carveout, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess && carveout)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

using SpreadKernel = void (*)(Forest, const float*, long long, int,
                              const float*, int, int, int, int, float*, int*);
using StagedKernel = void (*)(Forest, const int4*, int, int, const float*,
                              long long, int, const float*, int, int, float*,
                              int*);

SpreadKernel spread_kernel(int i) {
  static const SpreadKernel k[4] = {
      walk_spread<false, false>, walk_spread<false, true>,
      walk_spread<true, false>, walk_spread<true, true>};
  return k[i];
}

StagedKernel staged_kernel(int i) {
  static const StagedKernel k[8] = {
      walk_staged<false, false, false>, walk_staged<false, false, true>,
      walk_staged<false, true, false>,  walk_staged<false, true, true>,
      walk_staged<true, false, false>,  walk_staged<true, false, true>,
      walk_staged<true, true, false>,   walk_staged<true, true, true>};
  return k[i];
}

unsigned spread_done[4];
unsigned staged_done[8];

}  // namespace

// Margin [n_rows, n_groups] (and optionally the final flat node index
// [n_rows, n_trees]) of a packed forest, on the schedule of `plan` (a
// host array of WalkPlan's eight int64s; `chunks`, device int32
// [n_chunks, 4], for the staged schedule). Pointers are device pointers;
// cat_words and leaf_index may be null. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int xtt_walk_packed(
    const void* nodes, const void* cat_words, int n_words,
    const void* tree_offsets, const void* tree_weight,
    const void* tree_group, int n_trees, const void* X, long long n_rows,
    int n_features, const void* base, int n_groups, int max_depth,
    const long long* plan, const void* chunks, void* out, void* leaf_index,
    void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const WalkPlan& p = *reinterpret_cast<const WalkPlan*>(plan);
  const bool cat = cat_words != nullptr && n_words > 0;
  const Forest f{static_cast<const uint2*>(nodes),
                 cat ? static_cast<const uint32_t*>(cat_words) : nullptr,
                 cat ? n_words : 0,
                 static_cast<const int*>(tree_offsets),
                 static_cast<const float*>(tree_weight),
                 static_cast<const int*>(tree_group), n_trees};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>((n_rows + p.rows - 1) / p.rows);
  const int multi = n_groups > 1 ? 1 : 0;
  cudaError_t err;
  if (!p.staged) {
    const int i = (cat ? 2 : 0) + multi;
    const SpreadKernel kernel = spread_kernel(i);
    err = allow_smem(kernel, false, &spread_done[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, static_cast<unsigned>(p.threads),
                       static_cast<size_t>(p.smem), s>>>(
        f, static_cast<const float*>(X), n_rows, n_features,
        static_cast<const float*>(base), n_groups, max_depth,
        static_cast<int>(p.slots), static_cast<int>(p.stage_x),
        static_cast<float*>(out), static_cast<int*>(leaf_index));
  } else {
    const int i = (cat ? 4 : 0) + 2 * multi + (p.stage_x ? 1 : 0);
    const StagedKernel kernel = staged_kernel(i);
    err = allow_smem(kernel, true, &staged_done[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, static_cast<unsigned>(p.threads),
                       static_cast<size_t>(p.smem), s>>>(
        f, static_cast<const int4*>(chunks), static_cast<int>(p.n_chunks),
        static_cast<int>(p.capacity), static_cast<const float*>(X), n_rows,
        n_features, static_cast<const float*>(base), n_groups, max_depth,
        static_cast<float*>(out), static_cast<int*>(leaf_index));
  }
  return static_cast<int>(cudaGetLastError());
}
