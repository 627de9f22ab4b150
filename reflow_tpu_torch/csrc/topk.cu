// Row-wise top-k of a float32 score matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernel reflow_tpu/kernels/topk.py::_topk_kernel (the
// Pallas body launched by _topk_pallas). Same function, not the same
// blocks: for each row of x[rows, n] it returns the k largest values and
// their column ids, larger value first and, on equal values, the lower
// column first. Every returned id is a distinct column in [0, n).
//
// Design: one thread block per row. The row is loaded once into dynamic
// shared memory as 32-bit order keys (a float's bits remapped so that
// unsigned comparison is numeric order; NaN above +inf, -0 equal to +0,
// the order torch.sort uses). Each of the k rounds is one block-wide
// max over the 64-bit composites (key << 32 | ~column), restricted to
// composites strictly below the previous round's pick -- the total order
// makes "not yet taken" a comparison, so nothing is written back between
// rounds. The max reduces with warp shuffles, then across warps through
// shared memory. The ragged edge is the loop bound: no padding, no NEG
// fill, so an id >= n cannot come out.
//
// Rows too long for shared memory (n * 4 bytes above the 227 KB a block
// can take) take the same rounds reading the row from device memory (it
// stays in the 50 MB L2 between rounds).
//
// Bound on the H100: bytes. The kernel must read rows * n * 4 bytes and
// write rows * k * 8; at the k-NN main-path shape (256 x 8208, k = 16)
// that is 8.4 MB, about 2.5 us at 3.35 TB/s. The k rounds re-read the
// row from shared memory, not device memory, so device traffic stays at
// that minimum; what the design spends beyond it is k block-wide
// reductions per row (two __syncthreads each).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t order_key(float v) {
  if (v != v) return 0xFFFFFFFFu;      // NaN sorts above everything
  if (v == 0.0f) v = 0.0f;             // -0 ties with +0
  uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long composite(uint32_t key,
                                                        int col) {
  // larger key first, then lower column: the lower column gets the
  // larger low word
  return (static_cast<unsigned long long>(key) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - (uint32_t)col);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ idx, int n, int k) {
  extern __shared__ uint32_t skey[];
  __shared__ unsigned long long red[kWarps];
  __shared__ unsigned long long pick;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xr = x + static_cast<size_t>(row) * n;

  if (kShared) {
    for (int j = tid; j < n; j += kThreads) skey[j] = order_key(xr[j]);
    __syncthreads();
  }

  // composites are > 0 for every column, so 0 means "none seen"
  unsigned long long prev = ~0ull;
  for (int r = 0; r < k; ++r) {
    unsigned long long best = 0ull;
    for (int j = tid; j < n; j += kThreads) {
      uint32_t key = kShared ? skey[j] : order_key(xr[j]);
      unsigned long long c = composite(key, j);
      // round 0 takes any column (the top composite may equal ~0ull)
      if ((r == 0 || c < prev) && c > best) best = c;
    }
    best = warp_max(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      unsigned long long b = lane < kWarps ? red[lane] : 0ull;
      b = warp_max(b);
      if (lane == 0) {
        pick = b;
        const int col = static_cast<int>(0xFFFFFFFFu -
                                         static_cast<uint32_t>(b));
        vals[static_cast<size_t>(row) * k + r] = xr[col];
        idx[static_cast<size_t>(row) * k + r] = col;
      }
    }
    __syncthreads();
    prev = pick;
  }
}

constexpr int kMaxDevices = 64;
// per device, queried once: the opt-in shared memory a block may take,
// and the dynamic size the shared-memory kernel is currently allowed
// (0 = not yet queried / the 48 KB default)
int g_optin_smem[kMaxDevices];
int g_allowed_smem[kMaxDevices];

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` for the
// current rows; returns the cudaError_t of the attribute set and the
// launch (0 = launched). The caller checks shapes: 1 <= k <= n.
extern "C" int reflow_topk_f32(const float* x, float* vals, int* idx,
                               int rows, int n, int k, int device,
                               void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  if (g_optin_smem[device] == 0) {
    err = cudaDeviceGetAttribute(&g_optin_smem[device],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // static shared memory of the kernel: red[] and pick
  const size_t static_smem = (kWarps + 1) * sizeof(unsigned long long);
  const size_t row_smem = static_cast<size_t>(n) * sizeof(uint32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_smem + static_smem <= static_cast<size_t>(g_optin_smem[device])) {
    if (row_smem > 48 * 1024 &&
        row_smem > static_cast<size_t>(g_allowed_smem[device])) {
      err = cudaFuncSetAttribute(topk_rows_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(row_smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      g_allowed_smem[device] = static_cast<int>(row_smem);
    }
    topk_rows_kernel<true><<<rows, kThreads, row_smem, s>>>(x, vals, idx,
                                                            n, k);
  } else {
    topk_rows_kernel<false><<<rows, kThreads, 0, s>>>(x, vals, idx, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
