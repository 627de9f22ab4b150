// One corpus chunk's scores for the k-NN scan, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package scores a chunk with
// jnp.dot(..., preferred_element_type=f32) inside
// reflow_tpu/kernels/topk.py chunked_corpus_topk, which XLA compiles into
// a bf16 product with float32 sums. The port first did the same with
// torch.matmul, which rounds a bf16 product's output to bf16; so it
// upcast both operands to float32 (three elementwise passes over each
// chunk) and multiplied on the FMA units. This kernel takes that place:
// the rescan's topk_merge reads its output in place.
//
// reflow_scan_score_bf16: out[r, j] = sum_k q[r, k] * dq(d[j, k]) over
// k < dim, a float32 [nq, nd] row-major matrix, from bf16 queries
// q[nq, dim] and a doc block d[nd, dim] of int8 or bf16 rows. An int8
// value v dequantizes as kernels/topk.py score_form does: bf16(float(v) *
// bf16(1/127)), rounded once to nearest-even, so the operands are the
// plain version's bit for bit; bf16 docs are taken as they are. Products
// of bf16 values are exact in float32; the sums are float32, in the
// tensor cores' order rather than cuBLAS's.
//
// Bound on the H100 at the k-NN main-path shape (256 queries, a chunk of
// 8192 int8 docs, dim 768): 3.22 GFLOP, 3.26 us at 989.4 TFLOP/s (bf16
// dense); bytes 6.29 MB of int8 docs + 0.39 MB of queries read and 8.39
// MB of scores written, 4.50 us at 3.35 TB/s. So bytes bound it, at 4.50
// us; a bf16 doc block (12.6 MB) at 6.38 us.
//
// Design: wgmma with the docs as the A operand, from registers, and the
// queries as B, from shared memory; float32 accumulators in registers.
// - A block of 256 threads, two warpgroups, scores 128 docs x 128 queries
//   over all of dim; each warpgroup 64 docs, one m64n128k16 product per
//   16 dims. A chunk of 8192 docs against 256 queries is 128 blocks: one
//   wave on the 132 SMs, one block an SM. The two blocks of a doc tile are
//   adjacent in launch order, so the second finds the tile in L2; the
//   queries (393 KB) stay in L2 for the whole launch.
// - dim runs in slices of 64 through a 6-stage cp.async ring of query and
//   raw doc tiles (144 KB with int8 docs, 192 KB with bf16). An int8 tile
//   is copied as stored, 1 byte a value. The ragged edges (queries, docs,
//   the last slice) are zero-filled by the copy itself.
// - Shared memory's bandwidth is what the tensor cores contend for, so
//   the docs take the short way: each thread reads its fragment of the
//   int8 tile (16-byte reads the warp's four lanes of a row share) and
//   dequantizes it in registers, 4 values a 16-dim step; a bf16 tile is
//   read by ldmatrix. Queries are K-major tiles of 128-byte rows, their
//   16-byte chunks XOR-swizzled by the row (what a 128-byte-swizzle
//   descriptor reads), int8 doc tiles 64-byte rows swizzled by row / 2:
//   free of bank conflicts.
// - Dequantization: a byte becomes the float 2^23 + (v + 128) by one byte
//   permute, and one fused multiply-add by bf16(1/127) less the bias
//   gives float(v) * bf16(1/127) exactly (the bias (2^23 + 128) *
//   bf16(1/127) is a float32 value); one conversion rounds two of them to
//   a bf16 pair.
// - A slice's fragments are made while the tensor cores run the slice
//   before it (two register sets, wgmma.wait_group 1).
// - Each score is summed by one thread in a fixed order (no split of
//   dim), so a launch repeats itself bit for bit, and a score does not
//   depend on where its query or doc lies in the block.
// - The accumulators hold scores^T; they are transposed through shared
//   memory (the emptied ring) so that each warp stores 512 contiguous
//   bytes of a query's row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;            // queries a block
constexpr int kBN = 128;            // docs a block
constexpr int kBK = 64;             // dims a slice: one 128-byte bf16 row
constexpr int kStages = 6;          // slices in flight
constexpr int kThreads = 256;       // 2 warpgroups of 64 docs each
constexpr int kRow = 128;           // bytes of a bf16 tile row
constexpr int kTile = kBM * kRow;   // a 128 x 64 bf16 tile (16 KB)
constexpr int kOutPitch = kBN + 4;  // floats of a staged query row
constexpr int kMaxDevices = 64;

// shared memory of a block (offsets from a 1024-byte aligned base): the
// ring's stages, each a query tile and then a raw doc tile; the scores
// are staged in the emptied ring at the end
template <bool kInt8>
struct Smem {
  static constexpr int kStage = kTile + kBN * (kInt8 ? kBK : kRow);
  static constexpr int kBytes = kStages * kStage + 1024;
  static_assert(kStages * kStage >= kBM * kOutPitch * 4, "staging room");
};

// bf16(1/127) = 129 * 2^-14, and -(2^23 + 128) * bf16(1/127), a float32
// value (24 significant bits): fmaf(2^23 + v + 128, kScale, kBias) is
// float(v) * bf16(1/127), exactly
constexpr float kScale = 0.00787353515625f;
constexpr float kBias = -66049.0078125f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `ch` of row `row` in a bf16 tile
__device__ __forceinline__ int swz(int row, int ch) {
  return row * kRow + ((ch ^ (row & 7)) << 4);
}

// byte offset of 16-byte chunk `ch` of row `row` in an int8 tile
__device__ __forceinline__ int swz8(int row, int ch) {
  return row * kBK + ((ch ^ ((row >> 1) & 3)) << 4);
}

// 16 bytes from device to shared memory, the last 16 - bytes zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes, seen by the tensor cores' reads
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a K-major operand tile of 128-byte rows with the 128-byte swizzle: the
// 8-row groups 1024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d[64 x 128] += a[64 x 16] (registers) * b[16 x 128] (shared memory)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the compiler may not move the accumulators across this point (they
// are in flight inside the tensor cores until a wait)
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the compiler may not reuse a fragment's registers before this point
// (the tensor cores read them until a wait)
__device__ __forceinline__ void keep(const uint32_t (&f)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(f[s][i]) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// byte `sel & 3` of w (four int8 values) dequantized: the byte plus 128
// as the float 2^23 + (v + 128), times bf16(1/127), less the bias
__device__ __forceinline__ float dequant(uint32_t w, uint32_t sel) {
  return fmaf(
      __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, sel)),
      kScale, kBias);
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
scan_score_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ d,
                  float* __restrict__ out, int nq, int nd, int dim) {
  using L = Smem<kInt8>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle and the descriptors need 1024-byte aligned tiles
  const uint32_t raw_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t base = smem_addr(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // this thread's doc rows of the block: r0 and r0 + 8
  const int r0 = (tid >> 5) * 16 + g;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int slices = (dim + kBK - 1) / kBK;
  const size_t qpitch = static_cast<size_t>(dim) * 2;
  const size_t dpitch = static_cast<size_t>(dim) * (kInt8 ? 1 : 2);

  // slice `kt` into ring slot `stage`: a 16-byte chunk is wholly inside
  // or wholly past dim (the wrapper holds dim to a multiple of 8 bf16 or
  // 16 int8 values), and rows past nq or nd read nothing
  auto load = [&](int stage, int kt) {
    const uint32_t sq = base + stage * L::kStage;
    const uint32_t sd = sq + kTile;
    const int kb = kt * kBK;
#pragma unroll
    for (int i = 0; i < kBM * 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 3, ch = idx & 7;
      const int gr = m0 + row, gk = kb + ch * 8;
      const bool ok = gr < nq && gk < dim;
      cp_async16(sq + swz(row, ch), ok ? q + gr * qpitch + gk * 2 : q,
                 ok ? 16 : 0);
    }
    if (kInt8) {
#pragma unroll
      for (int i = 0; i < kBN * 4 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int row = idx >> 2, ch = idx & 3;
        const int gr = n0 + row, gk = kb + ch * 16;
        const bool ok = gr < nd && gk < dim;
        cp_async16(sd + swz8(row, ch), ok ? d + gr * dpitch + gk : d,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBN * 8 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int row = idx >> 3, ch = idx & 7;
        const int gr = n0 + row, gk = kb + ch * 8;
        const bool ok = gr < nd && gk < dim;
        cp_async16(sd + swz(row, ch), ok ? d + gr * dpitch + gk * 2 : d,
                   ok ? 16 : 0);
      }
    }
  };

  // this thread's A fragments of the slice in ring slot `stage`, one
  // 16-dim step each: {row r0, dims 2t, 2t + 1}, {r0 + 8, 2t, 2t + 1},
  // {r0, 2t + 8, 2t + 9}, {r0 + 8, 2t + 8, 2t + 9}
  auto frags = [&](uint32_t (&f)[4][4], int stage) {
    const uint8_t* sd = smem + stage * L::kStage + kTile;
    if (kInt8) {
      // bytes 2t, 2t + 1 of a 16-byte step: word t / 2, half t % 2
      const uint32_t sel = 0x7440u | (2u * (t & 1));
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint4 x =
            *reinterpret_cast<const uint4*>(sd + swz8(r0, s));
        const uint4 y =
            *reinterpret_cast<const uint4*>(sd + swz8(r0 + 8, s));
        const uint32_t xl = t & 2 ? x.y : x.x, xh = t & 2 ? x.w : x.z;
        const uint32_t yl = t & 2 ? y.y : y.x, yh = t & 2 ? y.w : y.z;
        f[s][0] = pack_bf16(dequant(xl, sel), dequant(xl, sel + 1));
        f[s][1] = pack_bf16(dequant(yl, sel), dequant(yl, sel + 1));
        f[s][2] = pack_bf16(dequant(xh, sel), dequant(xh, sel + 1));
        f[s][3] = pack_bf16(dequant(yh, sel), dequant(yh, sel + 1));
      }
    } else {
      // ldmatrix: lanes 8i .. 8i + 7 address matrix i's rows
      const int row = (tid >> 5) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const uint32_t sa = smem_addr(sd);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(f[s][0]), "=r"(f[s][1]), "=r"(f[s][2]), "=r"(f[s][3])
            : "r"(sa + swz(row, 2 * s + (lane >> 4))));
      }
    }
  };

  // the products of slice `kt` (its queries in ring slot kt % kStages)
  auto issue = [&](float (&acc)[64], const uint32_t (&f)[4][4], int kt) {
    const uint64_t db = tile_desc(base + (kt % kStages) * L::kStage);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s)   // 16 dims = 32 bytes a step
      wgmma_m64n128k16(acc, f[s], db + 2 * s);
    wgmma_commit();
  };

  // slice kt + 1, while slice kt's products (on `done`) are in flight
  auto step = [&](float (&acc)[64], uint32_t (&next)[4][4],
                  const uint32_t (&done)[4][4], int kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of kt + 1
    fence_to_async();
    __syncthreads();                // everyone's copies of kt + 1
    frags(next, (kt + 1) % kStages);
    issue(acc, next, kt + 1);
    wgmma_wait<1>();   // slice kt's products done
    keep(done);
    __syncthreads();   // every warpgroup is done with ring slot kt
    if (kt + kStages < slices) load(kt % kStages, kt + kStages);
    cp_async_commit();
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  uint32_t fa[4][4], fb[4][4];

#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < slices) load(s, s);
    cp_async_commit();
  }
  // slices >= 1 (the wrapper holds dim >= 1). No branch inside the loop
  // holds a product: a branch would make the compiler move the
  // accumulators, and wait for the tensor cores to do so
  cp_async_wait<kStages - 1>();
  fence_to_async();
  __syncthreads();
  frags(fa, 0);
  issue(acc, fa, 0);
  int kt = 0;
  for (; kt + 2 < slices; kt += 2) {
    step(acc, fb, fa, kt);
    step(acc, fa, fb, kt + 1);
  }
  if (kt + 1 < slices) step(acc, fb, fa, kt);
  wgmma_wait<0>();
  hold(acc);

  // scores^T -> the query rows of the block, through shared memory:
  // acc[4j + e] is (doc r0, query 8j + 2t + e), acc[4j + 2 + e] the same
  // for doc r0 + 8; a staged row is padded to 132 floats, so neither the
  // writes nor the reads meet a bank conflict
  cp_async_wait<0>();
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kBM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = 8 * j + 2 * t + e;
      st[qi * kOutPitch + r0] = acc[4 * j + e];
      st[qi * kOutPitch + r0 + 8] = acc[4 * j + 2 + e];
    }
  }
  __syncthreads();
  const int c = n0 + 4 * lane;
  const bool vec = (nd & 3) == 0 && c + 3 < nd;
  for (int row = tid >> 5; row < kBM && m0 + row < nq; row += kThreads / 32) {
    const float4 v =
        *reinterpret_cast<const float4*>(st + row * kOutPitch + 4 * lane);
    float* o = out + static_cast<size_t>(m0 + row) * nd + c;
    if (vec) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      if (c < nd) o[0] = v.x;
      if (c + 1 < nd) o[1] = v.y;
      if (c + 2 < nd) o[2] = v.z;
      if (c + 3 < nd) o[3] = v.w;
    }
  }
}

template <bool kInt8>
int launch(const void* q, const void* d, float* out, int nq, int nd, int dim,
           int device, void* stream) {
  constexpr int smem = Smem<kInt8>::kBytes;
  // the opt-in above 48 KB of shared memory, once a device (a repeat by
  // a racing thread is harmless)
  static bool ready[kMaxDevices];
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_score_kernel<kInt8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const dim3 grid(static_cast<unsigned>((nq + kBM - 1) / kBM),
                  static_cast<unsigned>((nd + kBN - 1) / kBN));
  scan_score_kernel<kInt8><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(d), out,
      nq, nd, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns the cudaError_t of the launch (0 = launched). The caller checks
// the rest: q a contiguous bf16 [nq, dim] matrix, d a contiguous [nd, dim]
// block of int8 (doc_int8 = 1) or bf16 (0) rows, both 16-byte aligned,
// dim a positive multiple of 16 (int8) or 8 (bf16), out a contiguous
// 16-byte aligned float32 [nq, nd] matrix aliasing neither, nq and nd >= 1
// and nd / 128 below 65536.

extern "C" int reflow_scan_score_bf16(const void* q, const void* d,
                                      int doc_int8, float* out, int nq,
                                      int nd, int dim, int device,
                                      void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return doc_int8 ? launch<true>(q, d, out, nq, nd, dim, device, stream)
                  : launch<false>(q, d, out, nq, nd, dim, device, stream);
}
