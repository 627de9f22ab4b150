// Row-wise top-k of float32 candidates, for Hopper (sm_90a).
//
// Replaces the TPU kernel reflow_tpu/kernels/topk.py::_topk_kernel (the
// Pallas body launched by _topk_pallas). Same function, not the same
// blocks. Two entries:
//
// - reflow_topk_f32: for each row of x[rows, n], the k largest values and
//   their column ids, larger value first and, on equal values, the lower
//   column first. Every id is a distinct column in [0, n).
// - reflow_topk_merge_f32: one step of the corpus scan. A row's candidates
//   are its k carry entries (carry_vals, carry_ids), then chunk column j
//   with value scores[row, j] if live[j] else NEG and id lo + j. Returns
//   the top k of that concatenation with the ids carried along; ties go to
//   the earlier candidate. The candidates are read where they lie: the
//   concatenated matrix, the masked scores and the id matrix are never
//   built.
//
// Order: each candidate is the 64-bit composite (order key << 32 |
// ~position). The order key is the float's bits remapped so that unsigned
// comparison is numeric order (NaN above +inf, -0 equal to +0, the order
// torch.sort uses); the low word makes the lower position win a tie. The
// composites of a row are distinct, so "the k largest composites" is the
// exact answer, and any subset's k-th largest is a lower bound for it.
//
// Bound on the H100: bytes. The kernel must read each candidate once and
// write k (value, id) pairs per row; at the k-NN main-path shape (256 x
// 8208, k = 16) that is 8.4 MB, 2.52 us at 3.35 TB/s. The operations (one
// comparison per candidate) are far below the float32 rate.
//
// Design (k <= kMaxK = 32): threshold, filter, rank.
// - A row is split over a thread-block cluster of C <= 8 blocks, C =
//   ceil(n / 4480): the main-path rows (8208 and 16 + 8192 candidates)
//   take C = 2, so a 256-row launch is 512 blocks of 160 threads, one
//   wave on the 132 SMs: 330 clusters of 2 fit at once, but only 203 of
//   3, and a launch with fewer resident clusters than rows takes two
//   waves (kernels/topk_stages.py prints the counts). Each block walks
//   its segment in tiles of 4480 candidates; each thread issues its
//   seven 16-byte
//   loads of a tile before using any (scalar loads where a row is not
//   16-byte aligned) and keeps the 28 order keys in registers. Each
//   candidate is read from device memory once.
// - Threshold: the block's lane maxima, grouped by lane slot (lane l of
//   every warp), give 32 candidates of distinct lanes; the k-th largest
//   of their keys, tk, found by one 15-shuffle sort in each warp, bounds
//   the k-th largest key of the tile from below. "key >= tk" keeps every
//   candidate the row's top k can hold and passes only those of lanes in
//   groups whose maximum reaches tk (about 20 of 4480 on random scores).
//   When several groups tie at tk (rows of equal values), each warp
//   also takes the k-th largest of its own lane-max composites, which
//   bounds its passes to k lanes.
// - Filter: each thread marks its passes in a 32-bit mask; one prefix
//   sum and one shared-memory atomic per warp place them.
// - Rank: a survivor's rank is the count of survivors above it; those of
//   rank < k are the block's top k, in order (ranks are distinct). Each
//   block ranks straight into its k slots of block 0's shared memory
//   (distributed shared memory); after one cluster barrier block 0 ranks
//   the C * k entries the same way and writes the k outputs, reading
//   each winner's value and id back from its source.
// A streaming selection needs no row in shared memory, so long rows (the
// preload tick's 65552 columns) take the same path: a tile's survivors
// are ranked against the running top k before the next tile.
//
// Why this and not WarpSelect's register queues or a radix select: the
// threshold costs one warp sort per tile and leaves so few survivors that
// a quadratic rank count over them is cheaper than the insertion sorts of
// WarpSelect or the histogram passes of a radix select; and on distinct
// composites it needs no tie rule of its own.
//
// k > kMaxK (never on the k-NN path, whose k is 16) takes a second path:
// one block per row and k rounds, each a block-wide max over the
// composites strictly below the previous round's pick, streaming the row
// from device memory (it stays in L2 between rounds).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 160;                 // threads of a cluster block
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 7;                     // 16-byte loads per thread
constexpr int kPerThread = 4 * kQuads;        // candidates per thread
static_assert(kPerThread <= 32, "a thread's passes are a 32-bit mask");
constexpr int kTile = kThreads * kPerThread;  // candidates per block pass
constexpr int kMaxK = 32;                     // the cluster path's k limit
constexpr int kMaxCluster = 8;                // the portable cluster size
// survivors a block can hold: a running top k (or the k carry entries)
// plus one tile's passes (at most every candidate of 4k lanes)
constexpr int kCap = 2 * kMaxK + kTile;

constexpr int kRoundThreads = 256;
constexpr int kRoundWarps = kRoundThreads / 32;

constexpr unsigned kFull = 0xFFFFFFFFu;
// the NEG sentinel of the Python side: float32's lowest finite value
constexpr float kNeg = -3.4028234663852886e38f;

__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v + 0.0f);   // -0 ties with +0
  // negative: all bits flipped; positive: the sign bit set
  const uint32_t key =
      u ^ (static_cast<uint32_t>(static_cast<int32_t>(u) >> 31) |
           0x80000000u);
  return v != v ? 0xFFFFFFFFu : key;   // NaN sorts above everything
}

// > 0 for every candidate (a position is below 2^31), so 0 means "none"
__device__ __forceinline__ u64 composite(uint32_t key, uint32_t pos) {
  return (static_cast<u64>(key) << 32) | static_cast<u64>(0xFFFFFFFFu - pos);
}

__device__ __forceinline__ uint32_t position(u64 c) {
  return 0xFFFFFFFFu - static_cast<uint32_t>(c);
}

__device__ __forceinline__ u64 u64max(u64 a, u64 b) { return a > b ? a : b; }

// the 32 lanes' values, sorted descending across the lanes (a bitonic
// network: 15 shuffles)
__device__ __forceinline__ uint32_t warp_sort_desc(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint32_t o = __shfl_xor_sync(kFull, x, stride);
      const bool desc = (lane & size) == 0;    // every lane at size 32
      const bool lower = (lane & stride) == 0;
      x = lower == desc ? max(x, o) : min(x, o);
    }
  }
  return x;
}

// the cluster barrier in two halves: arrive early, wait when needed
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The candidates of a row: `prefix()` leading entries, then `body()`
// columns read in aligned quads where `vec` allows. Position p counts
// from the first leading entry.

// x[rows, n]: candidate p is column p
struct RowSource {
  const float* x;
  int n;
  __device__ int prefix() const { return 0; }
  __device__ int body() const { return n; }
  __device__ float prefix_value(int, int) const { return 0.0f; }
  __device__ float body_value(int row, int j) const {
    return x[static_cast<size_t>(row) * n + j];
  }
  __device__ float4 body_quad(int row, int j) const {
    return *reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * n +
                                            j);
  }
  __device__ float value(int row, int p) const { return body_value(row, p); }
  __device__ int id(int, int p) const { return p; }
};

// the scan step: k carry entries, then the chunk's n masked columns
struct MergeSource {
  const float* carry_vals;
  const int* carry_ids;
  const float* s;
  const uint8_t* live;
  int k, n, lo;
  __device__ int prefix() const { return k; }
  __device__ int body() const { return n; }
  __device__ float prefix_value(int row, int i) const {
    return carry_vals[static_cast<size_t>(row) * k + i];
  }
  __device__ float body_value(int row, int j) const {
    const float v = s[static_cast<size_t>(row) * n + j];   // both loads
    return live[j] ? v : kNeg;                            // in flight
  }
  __device__ float4 body_quad(int row, int j) const {
    float4 v = *reinterpret_cast<const float4*>(s + static_cast<size_t>(row) *
                                                n + j);
    const uchar4 m = *reinterpret_cast<const uchar4*>(live + j);
    if (!m.x) v.x = kNeg;
    if (!m.y) v.y = kNeg;
    if (!m.z) v.z = kNeg;
    if (!m.w) v.w = kNeg;
    return v;
  }
  __device__ float value(int row, int p) const {
    return p < k ? prefix_value(row, p) : body_value(row, p - k);
  }
  __device__ int id(int row, int p) const {
    return p < k ? carry_ids[static_cast<size_t>(row) * k + p] : lo + (p - k);
  }
};

// how many of cand[0, cnt) are above c
__device__ __forceinline__ int count_above(const u64* cand, int cnt, u64 c) {
  int r = 0;
#pragma unroll 8
  for (int j = 0; j < cnt; ++j) r += cand[j] > c;   // 8 loads in flight
  return r;
}

// Rank the `cnt` distinct composites of `cand` (zeros skipped): the one
// with r larger ones goes to out[r] when r < k. Barrier-free; the caller
// syncs.
__device__ __forceinline__ void rank_into(const u64* cand, int cnt, int k,
                                          u64* out) {
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const u64 c = cand[i];
    if (c == 0) continue;
    const int r = count_above(cand, cnt, c);
    if (r < k) out[r] = c;
  }
}

// the sum of v over lanes 0..lane (5 shuffles)
__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// One cluster of blockDim.x-wide blocks per row; block `rank` of the
// cluster selects from body columns [rank * seg, (rank + 1) * seg).
template <class Src>
__global__ void __launch_bounds__(kThreads)
topk_cluster_kernel(Src src, float* __restrict__ vals, int* __restrict__ ids,
                    int k, int seg, int vec) {
  __shared__ u64 buf[kCap];
  __shared__ u64 top[kMaxK];
  __shared__ u64 merged[kMaxCluster * kMaxK];
  __shared__ uint32_t lanemax[kThreads];
  __shared__ int count;

  // paired with the wait before this block writes into block 0's
  // shared memory: every block of the cluster must have started
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int pre = src.prefix();
  const int n = src.body();
  const int s0 = static_cast<int>(
      min(static_cast<long long>(n), static_cast<long long>(rank) * seg));
  const int s1 = static_cast<int>(
      min(static_cast<long long>(n), static_cast<long long>(s0) + seg));

  // the leading entries (the scan's carry) are survivors of block 0 from
  // the start: they take part in its first rank step
  if (rank == 0) {
    for (int i = tid; i < pre; i += kThreads)
      buf[i] = composite(order_key(src.prefix_value(row, i)), i);
  }
  if (tid == 0) count = rank == 0 ? pre : 0;
  u64 theta_run = 0;   // the running k-th best of earlier tiles
  __syncthreads();

  for (int t0 = s0; t0 < s1; t0 += kTile) {
    // load: kPerThread order keys per thread, 0 where past the segment.
    // With `vec`, n and seg are multiples of 4, so a quad is wholly
    // inside or wholly past the segment, and all the loads are issued
    // before any is used.
    uint32_t key[kPerThread];
    if (vec) {
      float4 v[kQuads];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int j = t0 + 4 * (tid + kThreads * q);
        v[q] = j < s1 ? src.body_quad(row, j) : make_float4(0.f, 0.f, 0.f,
                                                            0.f);
      }
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const bool in = t0 + 4 * (tid + kThreads * q) < s1;
        key[4 * q + 0] = in ? order_key(v[q].x) : 0u;
        key[4 * q + 1] = in ? order_key(v[q].y) : 0u;
        key[4 * q + 2] = in ? order_key(v[q].z) : 0u;
        key[4 * q + 3] = in ? order_key(v[q].w) : 0u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int j = t0 + 4 * (tid + kThreads * (i / 4)) + i % 4;
        key[i] = j < s1 ? order_key(src.body_value(row, j)) : 0u;
      }
    }

    // threshold: a lower bound for the k-th best candidate. Group the
    // block's lane maxima by lane slot (lane l of each warp): the 32
    // group maxima are candidates of distinct lanes, so their k-th largest
    // key tk bounds the k-th largest key of the tile, and "key >= tk"
    // keeps every candidate the row's top k can hold. It passes only the
    // candidates of lanes in groups whose maximum reaches tk: k groups
    // when one group alone holds tk. When several groups tie at tk (rows
    // of equal values), each warp adds the k-th largest of its own
    // lane-max composites, which bounds its passes to k lanes again.
    uint32_t mk = 0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) mk = max(mk, key[i]);
    lanemax[tid] = mk;
    __syncthreads();
    uint32_t g = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) g = max(g, lanemax[32 * w + lane]);
    const uint32_t tk = __shfl_sync(kFull, warp_sort_desc(g), k - 1);
    u64 th = u64max(theta_run, static_cast<u64>(tk) << 32);
    if (__popc(__ballot_sync(kFull, tk != 0 && g == tk)) > 1) {
      u64 m = 0;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int j = t0 + 4 * (tid + kThreads * (i / 4)) + i % 4;
        if (key[i]) m = u64max(m, composite(key[i], pre + j));
      }
      int r = 0;
#pragma unroll
      for (int l = 0; l < 32; ++l) r += __shfl_sync(kFull, m, l) > m;
      const unsigned hit = __ballot_sync(kFull, r == k - 1);
      if (hit) th = u64max(th, __shfl_sync(kFull, m, __ffs(hit) - 1));
    }

    // filter: append the passing candidates, one atomic per warp. A bound
    // that is a bare key (the usual case) compares keys alone.
    unsigned pass = 0;
    const uint32_t th_key = static_cast<uint32_t>(th >> 32);
    if (static_cast<uint32_t>(th) == 0 && th_key != 0) {
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        if (key[i] >= th_key) pass |= 1u << i;
    } else {
      if (th == 0) th = 1;   // no bound: every real candidate passes
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int j = t0 + 4 * (tid + kThreads * (i / 4)) + i % 4;
        if (key[i] && composite(key[i], pre + j) >= th) pass |= 1u << i;
      }
    }
    const int mine = __popc(pass);
    const int incl = warp_inclusive_sum(mine);
    if (__any_sync(kFull, mine != 0)) {
      int base = 0;
      if (lane == 31) base = atomicAdd(&count, incl);
      base = __shfl_sync(kFull, base, 31) + incl - mine;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (pass >> i & 1u) {
          const int j = t0 + 4 * (tid + kThreads * (i / 4)) + i % 4;
          buf[base++] = composite(key[i], pre + j);
        }
      }
    }
    __syncthreads();

    if (t0 + kTile < s1) {
      // not the last tile: keep the survivors' top k as the running list
      const int cnt = count;
      rank_into(buf, cnt, k, top);
      __syncthreads();
      const int nk = min(k, cnt);
      if (tid < nk) buf[tid] = top[tid];
      if (tid == 0) count = nk;
      theta_run = nk == k ? top[k - 1] : 0ull;
      __syncthreads();
    }
  }

  // rank the survivors straight into this block's k slots of block 0's
  // list (distributed shared memory), zero-padded
  cluster_wait();
  u64* dst = cluster.map_shared_rank(merged, 0) + rank * k;
  const int cnt = count;
  rank_into(buf, cnt, k, dst);
  for (int i = min(k, cnt) + tid; i < k; i += kThreads) dst[i] = 0ull;
  cluster.sync();   // block 0 sees every list; no later remote access
  if (rank != 0) return;
  for (int i = tid; i < csize * k; i += kThreads) {
    const u64 c = merged[i];
    if (c == 0) continue;
    const int rr = count_above(merged, csize * k, c);
    if (rr < k) {
      const int p = static_cast<int>(position(c));
      vals[static_cast<size_t>(row) * k + rr] = src.value(row, p);
      ids[static_cast<size_t>(row) * k + rr] = src.id(row, p);
    }
  }
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = u64max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// k > kMaxK: one block per row, k rounds over the row in device memory
template <class Src>
__global__ void __launch_bounds__(kRoundThreads)
topk_rounds_kernel(Src src, float* __restrict__ vals, int* __restrict__ ids,
                   int k) {
  __shared__ u64 red[kRoundWarps];
  __shared__ u64 pick;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int total = src.prefix() + src.body();
  u64 prev = ~0ull;
  for (int r = 0; r < k; ++r) {
    u64 best = 0ull;
    for (int p = tid; p < total; p += kRoundThreads) {
      const u64 c = composite(order_key(src.value(row, p)), p);
      // round 0 takes any candidate (the top composite may equal ~0ull)
      if ((r == 0 || c < prev) && c > best) best = c;
    }
    best = warp_max(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      u64 b = lane < kRoundWarps ? red[lane] : 0ull;
      b = warp_max(b);
      if (lane == 0) {
        pick = b;
        const int p = static_cast<int>(position(b));
        vals[static_cast<size_t>(row) * k + r] = src.value(row, p);
        ids[static_cast<size_t>(row) * k + r] = src.id(row, p);
      }
    }
    __syncthreads();
    prev = pick;
  }
}

template <class Src>
int launch(const Src& src, float* vals, int* ids, int rows, int n, int k,
           int vec, int device, void* stream) {
  if (device < 0) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) {
    topk_rounds_kernel<Src><<<rows, kRoundThreads, 0, s>>>(src, vals, ids, k);
    return static_cast<int>(cudaGetLastError());
  }
  int c = (n + kTile - 1) / kTile;
  c = c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
  // a multiple of 4, so every block's quads stay 16-byte aligned
  const int seg = static_cast<int>(
      ((static_cast<long long>(n) + c - 1) / c + 3) / 4 * 4);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(c) * static_cast<unsigned>(rows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, topk_cluster_kernel<Src>, src, vals, ids, k,
                           seg, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns the cudaError_t of the launch (0 = launched). The caller checks
// shapes: 1 <= k <= n for the row entry, k >= 1 for the merge entry,
// rows * 8 and lo + n below 2^31, and outputs that alias no input.

extern "C" int reflow_topk_f32(const float* x, float* vals, int* idx,
                               int rows, int n, int k, int device,
                               void* stream) {
  RowSource src{x, n};
  const int vec = n % 4 == 0 && aligned(x, 16);
  return launch(src, vals, idx, rows, n, k, vec, device, stream);
}

extern "C" int reflow_topk_merge_f32(const float* carry_vals,
                                     const int* carry_ids,
                                     const float* scores,
                                     const uint8_t* live, int lo, float* vals,
                                     int* idx, int rows, int n, int k,
                                     int device, void* stream) {
  MergeSource src{carry_vals, carry_ids, scores, live, k, n, lo};
  const int vec = n % 4 == 0 && aligned(scores, 16) && aligned(live, 4);
  return launch(src, vals, idx, rows, n, k, vec, device, stream);
}
