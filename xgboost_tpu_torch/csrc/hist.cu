// Gradient histograms for Hopper (sm_90a): kernels K2, K3 and K4.
//
// K2 (`xtt_hist_int8x2`) replaces the TPU kernel
// `xgboost_tpu/ops/pallas/histogram.py _make_int8_kernel` (pallas_call at
// :621 in `build_hist_pallas`). K3 (`xtt_hist_f32`) replaces the f32
// variant of `_make_kernel` (pallas_call at :634). K4 (`xtt_hist_scan`)
// replaces `_make_scan_kernel` (pallas_call at :478 in `scan_hist_pallas`);
// it is described with its code below. All three compute
// [n_nodes, F, B, 2] (g, h) sums by (node, feature, bin) over rows whose
// rel[row] < n_nodes, the function of the JAX package's
// `ops/histogram.py build_hist`.
//
// K2: the wrapper quantises the gradients (q = round(g * 32512/max|g|));
// each row splits q into hi = (q + 128) >> 8 and lo = q - 256*hi and adds
// the four values (g_hi, h_hi, g_lo, h_lo) to int32 counters. One pass then
// writes (f32(sum hi) * 256 + f32(sum lo)) * inv. Integer sums do not
// depend on the order of the adds, so the result is deterministic and
// equals the plain version (and the JAX package's `prehot`) bit for bit.
// The TPU kernel instead adds 2048-row blocks in f32, which agrees with
// this only while the per-bin sums stay below 2^24.
//
// K3: each component is scaled by a power of two 2^k (chosen by the
// wrapper so that n * max|x| * 2^k <= 2^62), rounded to int64 and summed
// with 64-bit integer atomics; one pass converts each sum to f32 once and
// multiplies by 2^-k. f32 atomics would make a trained model change from
// run to run; this is deterministic and within about one f32 rounding of
// the exact sum.
//
// What bounds them: the least traffic is the bins (n*F bytes), the
// gradients and rel read once and the histogram written once, about
// 14 us at 1M x 28 on 3.35 TB/s. The work is n*F scatter-adds of 4 (K2)
// or 2 (K3) counters into a table that does not fit in shared memory at
// depth (128 nodes x 28 features x 256 bins x 16 B = 14.7 MB), so the
// scatter's atomics, not the bytes, bound the kernel.
//
// Design: the table is cut into tiles of (node chunk x feature chunk x B)
// cells of 16 bytes that fit in 96 KB of shared memory. Grid y walks the
// tiles; grid x splits the rows so that about two blocks per SM run. A
// block zeroes its tile, reads rel for its rows (int4 loads, four rows at
// a time), adds every active row of its node chunk into the tile with
// shared-memory atomics, and flushes the non-zero cells with global
// atomics. At depth a tile holds one node, so each block reads all rel of
// its rows and touches few of them; past a few tiles (and for bins wider
// than a tile) the kernel instead reads each row once and adds straight
// into global memory. K4 sorts the rows by node first, so that deep
// levels keep a tile. No float atomics anywhere.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileBytes = 96 * 1024;   // shared memory of one tile
constexpr int kCellBytes = 16;          // 4 x int32 (K2) or 2 x int64 (K3)

struct Plan {
  int nc, fc;              // nodes and features of one tile
  int n_ftiles, n_tiles;   // feature tiles, all tiles
  long long rows_per_split;
  int splits;
  bool smem;
};

// Past kMaxTiles tiles (a constant of each kernel's row values below)
// every block reads rel for rows it mostly skips, and adding straight
// into global memory costs less. Measured on an H100 at every level width
// of a depth-8 tree at 1M x 28 (PERF.md): the tiles win up to 32 tiles for
// K2 and up to 8 for K3, whose two 64-bit global atomics a cell cost less
// than K2's four 32-bit ones.
Plan make_plan(long long n, int F, int B, int N, int num_sms, int max_tiles) {
  Plan p;
  const int pairs = kTileBytes / (kCellBytes * B);   // (node, feature) pairs
  p.nc = N;
  p.fc = F;
  p.smem = pairs >= 1;
  if (p.smem) {
    if (F > pairs) {
      const int nft = (F + pairs - 1) / pairs;
      p.fc = (F + nft - 1) / nft;
    }
    const int nc = pairs / p.fc;
    p.nc = nc < 1 ? 1 : (nc < N ? nc : N);
    const int tiles = ((N + p.nc - 1) / p.nc) * ((F + p.fc - 1) / p.fc);
    if (tiles > max_tiles) {
      p.smem = false;
      p.nc = N;
      p.fc = F;
    }
  }
  p.n_ftiles = (F + p.fc - 1) / p.fc;
  p.n_tiles = ((N + p.nc - 1) / p.nc) * p.n_ftiles;
  // about two resident blocks per SM in the tile plan; the global plan
  // is one tile, so it splits rows into four times as many blocks
  const long long target = (p.smem ? 2LL : 8LL) * num_sms;
  long long splits = (target + p.n_tiles - 1) / p.n_tiles;
  const long long min_rows = p.smem ? 4096 : 1024;   // rows of one block
  const long long by_rows = (n + min_rows - 1) / min_rows;
  if (splits > by_rows) splits = by_rows;
  if (splits < 1) splits = 1;
  long long rps = (n + splits - 1) / splits;
  rps = (rps + 3) / 4 * 4;                  // int4 loads of rel stay aligned
  if (rps < 4) rps = 4;
  p.rows_per_split = rps;
  p.splits = static_cast<int>((n + rps - 1) / rps);
  return p;
}

__device__ __forceinline__ void atomic_add(int* p, int v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(unsigned long long* p,
                                           unsigned long long v) {
  atomicAdd(p, v);   // two's complement: signed int64 sums wrap alike
}

// K2's row values: the hi/lo byte planes of the quantised (g, h).
struct Int8x2 {
  using Counter = int;
  static constexpr int kPlanes = 4;
  static constexpr int kMaxTiles = 32;
  const int2* q;
  __device__ __forceinline__ void init() {}
  __device__ __forceinline__ void load(long long row, Counter v[4]) const {
    const int2 x = q[row];
    const int ghi = (x.x + 128) >> 8;   // arithmetic shift: round to nearest
    const int hhi = (x.y + 128) >> 8;
    v[0] = ghi;
    v[1] = hhi;
    v[2] = x.x - 256 * ghi;
    v[3] = x.y - 256 * hhi;
  }
};

// K3's row values: round(x * 2^k) as int64, per component.
struct Fixed64 {
  using Counter = unsigned long long;
  static constexpr int kPlanes = 2;
  static constexpr int kMaxTiles = 8;
  const float2* g;
  const float* qscale;
  float s0, s1;
  __device__ __forceinline__ void init() {
    s0 = qscale[0];
    s1 = qscale[1];
  }
  __device__ __forceinline__ void load(long long row, Counter v[2]) const {
    const float2 x = g[row];
    // x * 2^k is exact; __float2ll_rn rounds half to even like torch.round
    v[0] = static_cast<Counter>(__float2ll_rn(__fmul_rn(x.x, s0)));
    v[1] = static_cast<Counter>(__float2ll_rn(__fmul_rn(x.y, s1)));
  }
};

template <typename BinT, typename Pol>
__global__ void __launch_bounds__(kThreads, 2) hist_accumulate(
    const BinT* __restrict__ bins, const int* __restrict__ rel, Pol pol,
    long long n, int F, int B, int N, int nc, int fc, int n_ftiles,
    long long rows_per_split, bool use_smem,
    typename Pol::Counter* __restrict__ acc) {
  using C = typename Pol::Counter;
  constexpr int P = Pol::kPlanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* tile = reinterpret_cast<C*>(smem_raw);

  const int t = blockIdx.y;
  const int n0 = (t / n_ftiles) * nc;
  const int f0 = (t % n_ftiles) * fc;
  const int ncur = nc < N - n0 ? nc : N - n0;
  const int fcur = fc < F - f0 ? fc : F - f0;
  const int tile_cells = nc * fc * B * P;

  if (use_smem) {
    for (int i = threadIdx.x; i < tile_cells; i += blockDim.x) tile[i] = 0;
    __syncthreads();
  }
  pol.init();

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_split;
  const long long r1 = r0 + rows_per_split < n ? r0 + rows_per_split : n;
  for (long long base = r0 + 4LL * threadIdx.x; base < r1;
       base += 4LL * blockDim.x) {
    int rr[4];
    if (base + 4 <= r1) {
      const int4 v = *reinterpret_cast<const int4*>(rel + base);
      rr[0] = v.x;
      rr[1] = v.y;
      rr[2] = v.z;
      rr[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) rr[k] = base + k < r1 ? rel[base + k] : -1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int node = rr[k] - n0;
      if (node < 0 || node >= ncur) continue;   // other tile, or inactive
      const long long row = base + k;
      C v[P];
      pol.load(row, v);
      const BinT* brow = bins + row * F + f0;
      for (int j = 0; j < fcur; ++j) {
        const unsigned b = static_cast<unsigned>(brow[j]);
        if (b >= static_cast<unsigned>(B)) continue;   // never for valid bins
        C* cell = use_smem
            ? tile + (static_cast<long long>(node * fc + j) * B + b) * P
            : acc + ((static_cast<long long>(n0 + node) * F + f0 + j) * B + b)
                  * P;
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (v[p] != 0) atomic_add(cell + p, v[p]);
      }
    }
  }

  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < tile_cells; i += blockDim.x) {
      const C v = tile[i];
      if (v == 0) continue;
      const int p = i % P;
      const int cell = i / P;
      const int b = cell % B;
      const int rest = cell / B;
      const int j = rest % fc;
      const int node = rest / fc;
      if (node >= ncur || j >= fcur) continue;
      atomic_add(acc + ((static_cast<long long>(n0 + node) * F + f0 + j) * B
                        + b) * P + p, v);
    }
  }
}

// (f32(sum hi) * 256 + f32(sum lo)) * inv; the product by 256 is exact and
// __fmul_rn/__fadd_rn keep the compiler from contracting into an FMA.
__global__ void dequant_int8x2(const int4* __restrict__ acc,
                               const float* __restrict__ inv, long long cells,
                               float2* __restrict__ out) {
  const float i0 = inv[0], i1 = inv[1];
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < cells; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int4 a = acc[i];   // (g_hi, h_hi, g_lo, h_lo)
    const float g = __fadd_rn(__fmul_rn(__int2float_rn(a.x), 256.0f),
                              __int2float_rn(a.z));
    const float h = __fadd_rn(__fmul_rn(__int2float_rn(a.y), 256.0f),
                              __int2float_rn(a.w));
    out[i] = make_float2(__fmul_rn(g, i0), __fmul_rn(h, i1));
  }
}

// f32(sum) * 2^-k: one rounding of the exact int64 sum.
__global__ void dequant_fixed64(const longlong2* __restrict__ acc,
                                const float* __restrict__ inv,
                                long long cells, float2* __restrict__ out) {
  const float i0 = inv[0], i1 = inv[1];
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < cells; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const longlong2 a = acc[i];
    out[i] = make_float2(__fmul_rn(__ll2float_rn(a.x), i0),
                         __fmul_rn(__ll2float_rn(a.y), i1));
  }
}

template <typename BinT, typename Pol>
cudaError_t launch_accumulate(const void* bins, const int* rel, Pol pol,
                              long long n, int F, int B, int N, int num_sms,
                              typename Pol::Counter* acc,
                              cudaStream_t stream) {
  const Plan p = make_plan(n, F, B, N, num_sms, Pol::kMaxTiles);
  if (p.n_tiles > 65535) return cudaErrorInvalidConfiguration;
  auto kernel = hist_accumulate<BinT, Pol>;
  const int smem = p.smem ? p.nc * p.fc * B * kCellBytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.splits, p.n_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), rel, pol, n, F, B, N, p.nc, p.fc,
      p.n_ftiles, p.rows_per_split, p.smem, acc);
  return cudaGetLastError();
}

template <typename Pol>
cudaError_t dispatch_bins(const void* bins, int bin_bytes, const int* rel,
                          Pol pol, long long n, int F, int B, int N,
                          int num_sms, typename Pol::Counter* acc,
                          cudaStream_t stream) {
  switch (bin_bytes) {
    case 1:
      return launch_accumulate<uint8_t>(bins, rel, pol, n, F, B, N, num_sms,
                                        acc, stream);
    case 2:
      return launch_accumulate<uint16_t>(bins, rel, pol, n, F, B, N,
                                         num_sms, acc, stream);
    case 4:
      return launch_accumulate<int32_t>(bins, rel, pol, n, F, B, N, num_sms,
                                        acc, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int grid_for(long long cells) {
  long long blocks = (cells + 255) / 256;
  return static_cast<int>(blocks > 4096 ? 4096 : (blocks < 1 ? 1 : blocks));
}

// ---- K4: the int8x2 histogram over rows sorted by node ---------------------
//
// The TPU kernel streams 2048-row blocks of rows that its wrapper
// counting-sorted by node (`ops/partition.py counting_sort_by_node`), so
// each block belongs to one node and its accumulator tile is one node's
// [F, B, 4] int32 sums, however many nodes the level has. K4 keeps that
// design and K2's arithmetic: the same quantised q, the same hi/lo planes,
// exact int32 sums, the same dequantisation, so it computes K2's function
// bit for bit. What it changes is the bound at depth: K2 needs 2N tiles at
// N nodes (28 features x 256 bins) and falls back to global atomics past
// 32, where one tile of one node is enough here.
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

}  // namespace

// bins [n, F] (1, 2 or 4 bytes per id), rel [n] int32, q [n, 2] int32,
// inv [2] f32 on the device; acc [N*F*B*4] int32 scratch; out [N, F, B, 2]
// f32. Returns a cudaError_t (0 on success). Launches on `stream` and
// does not synchronise.
extern "C" int xtt_hist_int8x2(const void* bins, int bin_bytes,
                               const int* rel, const int* q, const float* inv,
                               long long n, int F, int B, int N, int num_sms,
                               int* acc, float* out, cudaStream_t stream) {
  const long long cells = static_cast<long long>(N) * F * B;
  cudaError_t err = cudaMemsetAsync(acc, 0, cells * 4 * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    Int8x2 pol{reinterpret_cast<const int2*>(q)};
    err = dispatch_bins(bins, bin_bytes, rel, pol, n, F, B, N, num_sms, acc,
                        stream);
    if (err != cudaSuccess) return err;
  }
  dequant_int8x2<<<grid_for(cells), 256, 0, stream>>>(
      reinterpret_cast<const int4*>(acc), inv, cells,
      reinterpret_cast<float2*>(out));
  return cudaGetLastError();
}

// The same with gpair [n, 2] f32, qscale [2] (2^k) and inv [2] (2^-k) f32;
// acc [N*F*B*2] int64 scratch.
extern "C" int xtt_hist_f32(const void* bins, int bin_bytes, const int* rel,
                            const float* gpair, const float* qscale,
                            const float* inv, long long n, int F, int B,
                            int N, int num_sms, long long* acc, float* out,
                            cudaStream_t stream) {
  const long long cells = static_cast<long long>(N) * F * B;
  cudaError_t err =
      cudaMemsetAsync(acc, 0, cells * 2 * sizeof(long long), stream);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    Fixed64 pol{reinterpret_cast<const float2*>(gpair), qscale, 0.0f, 0.0f};
    err = dispatch_bins(bins, bin_bytes, rel, pol, n, F, B, N, num_sms,
                        reinterpret_cast<unsigned long long*>(acc), stream);
    if (err != cudaSuccess) return err;
  }
  dequant_fixed64<<<grid_for(cells), 256, 0, stream>>>(
      reinterpret_cast<const longlong2*>(acc), inv, cells,
      reinterpret_cast<float2*>(out));
  return cudaGetLastError();
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
