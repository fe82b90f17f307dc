// Packed-forest walk for Hopper (sm_90a).
//
// Replaces the TPU kernel `xgboost_tpu/ops/pallas/walk.py _walk_kernel`
// (pallas_call in `_walk_pallas`), and computes the function of the JAX
// package's `ops/walk.py walk_packed`: categorical splits and node pools
// of any size included, which the TPU kernel refused.
//
// What bounds it: every (row, tree) pair walks up to max_depth dependent
// node visits, each a 4-byte word load and a 4-byte value load at a
// data-dependent address. The least possible traffic (pool once, X once,
// the output once) would take a few microseconds at 3.35 TB/s, but the
// walk is a chain of dependent gathers, so in practice it is bound by
// the latency of L1/L2 hits. The design keeps those hits cheap: the
// node pool of a serving forest (about 1.5 MB for 500 depth-8 trees)
// stays resident in the 50 MB L2 across launches, the row's features
// are staged in shared memory once per row, and 32 lanes walk 32
// independent trees at a time so the warp always has loads in flight.
//
// Layout (serve/packed.py):
//   bits  0..15  left-child offset (right child = left + 1); 0 at leaves
//   bits 16..28  split feature id
//   bit   29     default-left       bit 30  categorical       bit 31  leaf
//
// Design: one warp per row, grid-stride over rows. Lane l walks trees
// l, l+32, ... For one output group each lane keeps a running sum in a
// register and the warp reduces with __shfl_xor_sync in a fixed order.
// For several groups the warp takes trees in rounds of 32: each lane
// stages its (group, leaf*weight) in shared memory, then lane g%32 folds
// the round into the row's shared [G] accumulator in tree order. No
// float atomics: a row's result is the same from run to run and does not
// depend on the batch it rides in. base is added after the sum, as the
// JAX walk does. Products and sums use __fmul_rn/__fadd_rn so the
// compiler does not contract them into FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr uint32_t kOffMask = 0xFFFFu;
constexpr int kFeatShift = 16;
constexpr uint32_t kFeatMask = 0x1FFFu;
constexpr int kDlBit = 29;
constexpr int kCatBit = 30;
constexpr int kLeafBit = 31;
// stage a row's features in shared memory up to this width
constexpr int kMaxStagedFeatures = 1024;

// Walks one tree from flat node `idx`; returns the final node and sets
// `value` to values[final node]. A node's word and value are loaded
// together, so each level costs one round trip to L2, not two.
__device__ __forceinline__ int walk_tree(
    const uint32_t* __restrict__ words, const float* __restrict__ values,
    const uint32_t* __restrict__ cat_words, int n_words,
    const float* __restrict__ x, int idx, int max_depth, float& value) {
  const float n_cats = static_cast<float>(n_words) * 32.0f;
  uint32_t w = __ldg(words + idx);
  float v = __ldg(values + idx);
  for (int d = 0; d < max_depth && !(w >> kLeafBit); ++d) {
    const int feat = static_cast<int>((w >> kFeatShift) & kFeatMask);
    const float xv = x[feat];
    bool missing = isnan(xv);
    bool go_right = xv > v;
    if (n_words > 0 && ((w >> kCatBit) & 1u)) {
      // code = trunc(x); in range when 0 <= code < n_words*32, compared in
      // float so NaN and huge values never reach an int conversion
      const float xt = truncf(xv);
      if (xt >= 0.0f && xt < n_cats) {
        const int code = static_cast<int>(xt);
        const uint32_t word =
            __ldg(cat_words + static_cast<size_t>(idx) * n_words + (code >> 5));
        go_right = ((word >> (code & 31)) & 1u) == 0u;
      } else {
        missing = true;   // out-of-range code at a categorical node
      }
    }
    if (missing) go_right = ((w >> kDlBit) & 1u) == 0u;
    idx += static_cast<int>(w & kOffMask) + (go_right ? 1 : 0);
    w = __ldg(words + idx);
    v = __ldg(values + idx);
  }
  value = v;
  return idx;
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
walk_kernel(const uint32_t* __restrict__ words,
            const float* __restrict__ values,
            const uint32_t* __restrict__ cat_words, int n_words,
            const int* __restrict__ tree_offsets,
            const float* __restrict__ tree_weight,
            const int* __restrict__ tree_group, int n_trees,
            const float* __restrict__ X, long long n_rows, int n_features,
            const float* __restrict__ base, int n_groups, int max_depth,
            int stage_x, float* __restrict__ out,
            int* __restrict__ leaf_index) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int x_words = stage_x ? n_features : 0;
  const int g_words = n_groups > 1 ? n_groups + 2 * kWarp : 0;
  float* wsm = smem + static_cast<size_t>(warp) * (x_words + g_words);
  float* xs = wsm;
  float* acc = wsm + x_words;              // [G]   row accumulator
  float* round_v = acc + n_groups;         // [32]  this round's leaf*weight
  int* round_g = reinterpret_cast<int*>(round_v + kWarp);  // [32] groups

  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                       warp;
       row < n_rows; row += stride) {
    const float* xg = X + row * n_features;
    const float* xr = xg;
    if (stage_x) {
      for (int f = lane; f < n_features; f += kWarp) xs[f] = __ldg(xg + f);
      __syncwarp();
      xr = xs;
    }
    int* li = leaf_index ? leaf_index + row * n_trees : nullptr;

    if (n_groups == 1) {
      float s = 0.0f;
      for (int t = lane; t < n_trees; t += kWarp) {
        float leaf_v;
        const int leaf = walk_tree(words, values, cat_words, n_words, xr,
                                   __ldg(tree_offsets + t), max_depth,
                                   leaf_v);
        s = __fadd_rn(s, __fmul_rn(leaf_v, __ldg(tree_weight + t)));
        if (li) li[t] = leaf;
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      if (lane == 0) out[row] = __fadd_rn(s, __ldg(base));
    } else {
      for (int g = lane; g < n_groups; g += kWarp) acc[g] = 0.0f;
      for (int t0 = 0; t0 < n_trees; t0 += kWarp) {
        const int t = t0 + lane;
        float v = 0.0f;
        int g = -1;
        if (t < n_trees) {
          float leaf_v;
          const int leaf = walk_tree(words, values, cat_words, n_words, xr,
                                     __ldg(tree_offsets + t), max_depth,
                                     leaf_v);
          v = __fmul_rn(leaf_v, __ldg(tree_weight + t));
          g = __ldg(tree_group + t);
          if (li) li[t] = leaf;
        }
        round_v[lane] = v;
        round_g[lane] = g;
        __syncwarp();
        const int cnt = min(kWarp, n_trees - t0);
        for (int k = 0; k < cnt; ++k) {
          const int gk = round_g[k];
          if ((gk & (kWarp - 1)) == lane) acc[gk] = __fadd_rn(acc[gk], round_v[k]);
        }
        __syncwarp();
      }
      for (int g = lane; g < n_groups; g += kWarp)
        out[row * n_groups + g] = __fadd_rn(acc[g], __ldg(base + g));
    }
    __syncwarp();   // xs and acc are reused by the warp's next row
  }
}

}  // namespace

// Margin [n_rows, n_groups] (and optionally the final flat node index
// [n_rows, n_trees]) of a packed forest. Pointers are device pointers;
// cat_words and leaf_index may be null. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int xtt_walk_packed(
    const void* words, const void* values, const void* cat_words,
    int n_words, const void* tree_offsets, const void* tree_weight,
    const void* tree_group, int n_trees, const void* X, long long n_rows,
    int n_features, const void* base, int n_groups, int max_depth,
    void* out, void* leaf_index, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int stage_x = n_features <= kMaxStagedFeatures ? 1 : 0;
  const size_t per_warp =
      static_cast<size_t>(stage_x ? n_features : 0) +
      static_cast<size_t>(n_groups > 1 ? n_groups + 2 * kWarp : 0);
  const size_t smem = per_warp * sizeof(float) * kWarpsPerBlock;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  walk_kernel<<<blocks, kWarp * kWarpsPerBlock, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(values),
      static_cast<const uint32_t*>(cat_words), cat_words ? n_words : 0,
      static_cast<const int*>(tree_offsets),
      static_cast<const float*>(tree_weight),
      static_cast<const int*>(tree_group), n_trees,
      static_cast<const float*>(X), n_rows, n_features,
      static_cast<const float*>(base), n_groups, max_depth, stage_x,
      static_cast<float*>(out), static_cast<int*>(leaf_index));
  return static_cast<int>(cudaGetLastError());
}
