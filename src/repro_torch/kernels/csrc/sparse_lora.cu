// Neuron-masked LoRA products of FibecFed (paper §4.3.2), single-adapter,
// gather-packed and multi-adapter, written for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/sparse_lora.py::sparse_lora_matmul          (_kernel)
//   src/repro/kernels/sparse_lora.py::sparse_lora_matmul_packed   (_packed_kernel)
//   src/repro/kernels/sparse_lora.py::batched_sparse_lora_matmul  (_batched_kernel)
//
// Each row m of x (M, K) gets an adapter i(m): 0 for the single-adapter
// product, idx[m] for the multi-adapter one (a row whose idx lies outside
// [0, A) comes out as zeros, as the TPU kernel gives it). Then, in f32,
//   xa[m] = x[m] @ a[i]                              (K -> r)
//   y[m]  = scale · (xa[m] @ (b[i] ⊙ mask[i]))       (r -> N), in x's dtype
// with a (K, r), b (r, N) and mask (N,) per adapter, all f32, and x f32 or
// bf16. The packed product is the same kernel with no mask (mask == null)
// on the kept columns of b, which the wrapper gathers and scatters back.
// A masked column multiplies b by 0 before the sum, as the plain version
// does, so it comes out exactly 0 for finite b.
//
// Bound: memory. With r = 8 the two products do ~4 flops per byte of x and
// y moved (2·K·r + 2·r·N flops for 2·(K + N) bytes of a bf16 row), below the
// H100's ~20 f32 flops per byte of HBM bandwidth, so the least time is the
// bytes of x and y (a, b and mask are small and stay in L2) over 3.35 TB/s.
// Design: one block owns 16 rows and all N columns. Phase 1 streams its x
// rows through shared memory in 256-column chunks with 16-byte loads where
// the rows allow them; the loads of the next chunk are issued before the
// current one is multiplied, so they are in flight meanwhile. It
// accumulates xa in registers: a lane owns 4 rank components of one k per
// step, each warp two rows, so every x element is read from device memory
// once. A single adapter's a (rank up to 16) is staged beside x, so the
// block reads it once from L2 and its 8 warps from shared memory (read
// from L2 by every warp, the 28 KB of a qwen2-0.5b leaf made 8x the bytes
// of x in L2 traffic); multi-adapter rows and larger ranks read a with
// float4 loads, coalesced across the warp, from L1/L2;
// a shuffle reduction leaves xa in shared memory. Phase 2 walks N: a
// thread owns a column, loads its (b ⊙ mask) column once per adapter and
// writes that column of all 16 rows, so y is written once and nothing
// between the two products reaches device memory. The TPU kernel's padding
// to 128/512 tiles has no counterpart: ragged M, N and K are masked here.
// Sums use fused multiply-adds (explicit fmaf, which the build's
// -fmad=false leaves alone) and run in another order than the plain
// version's matmuls, so the two agree at a tolerance, not bit for bit.
// Multi-adapter rows gather their own adapter (BGMV style): the block
// orders its 16 rows by adapter, and a warp reloads a and b only when the
// adapter changes. Sorting the whole batch by adapter (SGMV) and wgmma
// tiles are later work.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a rank above kMaxRank.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows per block
constexpr int kChunk = 256;                   // x columns staged per step
constexpr int kMaxRank = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// RP: the rank rounded up to a power of two >= 4. A lane owns rank entries
// [rr0, rr0 + 4) of one k per step; LK lanes cover a k, KS k's per step.
template <typename T, int RP>
__global__ void __launch_bounds__(kThreads)
    sparse_lora_kernel(T* __restrict__ y, const T* __restrict__ x, const int* __restrict__ idx,
                       const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ mask, int64_t M, int64_t K, int64_t N, int r,
                       int n_adapters, float scale, bool x_vec, bool a_vec) {
  constexpr int LK = RP / 4;
  constexpr int KS = 32 / LK;
  constexpr int VX = 16 / sizeof(T);                        // x values per 16-byte load
  constexpr int kLoads = kRows * kChunk / VX / kThreads;    // 16-byte loads per thread and chunk
  // a single adapter's a is staged per chunk too, read by all 16 rows
  constexpr int kStageRows = RP <= 16 ? kChunk : 1;
  __shared__ __align__(16) T xs[kRows][kChunk];
  __shared__ __align__(16) float a_s[kStageRows][RP];
  __shared__ float xa_s[kRows][RP];
  __shared__ int ad_s[kRows];
  __shared__ int order_s[kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t m0 = (int64_t)blockIdx.x * kRows;

  // the first chunk of x is in flight while the rows' adapters are read
  uint4 buf[kLoads];
  auto load_chunk = [&](int64_t k0) {
#pragma unroll
    for (int p = 0; p < kLoads; ++p) {
      const int i = tid + p * kThreads;
      const int row = i / (kChunk / VX), c = i % (kChunk / VX);
      const int64_t m = m0 + row, k = k0 + (int64_t)c * VX;
      buf[p] = (m < M && k < K) ? *reinterpret_cast<const uint4*>(x + m * K + k)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (x_vec) load_chunk(0);
  if (tid < kRows) {
    const int64_t m = m0 + tid;
    int ad = -1;
    if (m < M) {
      if (idx == nullptr) {
        ad = 0;
      } else {
        const int v = idx[m];
        ad = (v >= 0 && v < n_adapters) ? v : -1;
      }
    }
    ad_s[tid] = ad;
  }
  __syncthreads();
  if (tid == 0) {
    // rows in order of their adapter (stable), so that a warp's two rows
    // and consecutive rows of phase 2 share an adapter where they can
    for (int i = 0; i < kRows; ++i) {
      int j = i;
      while (j > 0 && ad_s[order_s[j - 1]] > ad_s[i]) {
        order_s[j] = order_s[j - 1];
        --j;
      }
      order_s[j] = i;
    }
  }
  __syncthreads();

  // --- phase 1: xa = x @ a, x staged through shared memory ---
  int my_row[kRowsPerWarp], ad_row[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    my_row[j] = order_s[warp * kRowsPerWarp + j];
    ad_row[j] = ad_s[my_row[j]];
  }
  const int kq = lane / LK;
  const int rr0 = (lane % LK) * 4;
  const bool stage_a = RP <= 16 && idx == nullptr;
  float acc[kRowsPerWarp][4];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;

  for (int64_t k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = (int)(K - k0 < kChunk ? K - k0 : kChunk);
    if (x_vec) {
      // store this chunk, then start loading the next one, which stays in
      // flight while this one is multiplied
#pragma unroll
      for (int p = 0; p < kLoads; ++p) {
        const int i = tid + p * kThreads;
        *reinterpret_cast<uint4*>(&xs[i / (kChunk / VX)][(i % (kChunk / VX)) * VX]) = buf[p];
      }
      if (k0 + kChunk < K) load_chunk(k0 + kChunk);
    } else {
      for (int i = tid; i < kRows * kc; i += kThreads) {
        const int row = i / kc, c = i - row * kc;
        const int64_t m = m0 + row;
        xs[row][c] = m < M ? x[m * K + k0 + c] : from_f32<T>(0.0f);
      }
    }
    if (stage_a) {
      const float* ap = a + k0 * r;
#pragma unroll 4
      for (int i = tid; i < kc * RP; i += kThreads) {
        const int kk = i / RP, rr = i % RP;
        a_s[kk][rr] = rr < r ? ap[(int64_t)kk * r + rr] : 0.0f;
      }
    }
    __syncthreads();
    if (stage_a) {
#pragma unroll 4
      for (int kk = kq; kk < kc; kk += KS) {
        const float4 q = *reinterpret_cast<const float4*>(&a_s[kk][rr0]);
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          if (ad_row[j] < 0) continue;
          const float xv = to_f32(xs[my_row[j]][kk]);
          acc[j][0] = fmaf(xv, q.x, acc[j][0]);
          acc[j][1] = fmaf(xv, q.y, acc[j][1]);
          acc[j][2] = fmaf(xv, q.z, acc[j][2]);
          acc[j][3] = fmaf(xv, q.w, acc[j][3]);
        }
      }
      __syncthreads();
      continue;
    }
#pragma unroll 4
    for (int kk = kq; kk < kc; kk += KS) {
      const int64_t k = k0 + kk;
      float av[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int cur = -1;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int ad = ad_row[j];  // the same for the whole warp
        if (ad < 0) continue;
        if (ad != cur) {
          const float* ap = a + ((int64_t)ad * K + k) * r;
          if (a_vec) {
            if (rr0 < r) {
              const float4 q = *reinterpret_cast<const float4*>(ap + rr0);
              av[0] = q.x; av[1] = q.y; av[2] = q.z; av[3] = q.w;
            }
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) av[q] = rr0 + q < r ? ap[rr0 + q] : 0.0f;
          }
          cur = ad;
        }
        const float xv = to_f32(xs[my_row[j]][kk]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = fmaf(xv, av[q], acc[j][q]);
      }
    }
    __syncthreads();
  }
  // lanes with the same rr0 hold partial sums over different k's
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int off = LK; off < 32; off <<= 1)
        acc[j][q] += __shfl_xor_sync(0xffffffffu, acc[j][q], off);
  if (lane < LK) {
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) xa_s[my_row[j]][rr0 + q] = acc[j][q];
  }
  __syncthreads();

  // --- phase 2: y = scale · xa @ (b ⊙ mask), one column per thread ---
  for (int64_t n = tid; n < N; n += kThreads) {
    float bm[RP];
    int cur = -1;
    for (int t = 0; t < kRows; ++t) {
      const int row = order_s[t];
      const int64_t m = m0 + row;
      if (m >= M) continue;
      const int ad = ad_s[row];
      float out = 0.0f;
      if (ad >= 0) {
        if (ad != cur) {
          const float* bp = b + (int64_t)ad * r * N + n;
          const float mk = mask != nullptr ? mask[(int64_t)ad * N + n] : 1.0f;
#pragma unroll
          for (int rr = 0; rr < RP; ++rr)
            bm[rr] = rr < r ? (mask != nullptr ? bp[(int64_t)rr * N] * mk : bp[(int64_t)rr * N])
                            : 0.0f;
          cur = ad;
        }
        float s = 0.0f;
#pragma unroll
        for (int rr = 0; rr < RP; ++rr) s = fmaf(xa_s[row][rr], bm[rr], s);
        out = scale * s;
      }
      y[m * N + n] = from_f32<T>(out);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p % bytes) == 0; }

template <typename T, int RP>
int launch_rank(void* y, const void* x, const int* idx, const float* a, const float* b,
                const float* mask, int64_t M, int64_t K, int64_t N, int r, int n_adapters,
                float scale, cudaStream_t stream) {
  const bool x_vec = (K % (16 / (int64_t)sizeof(T))) == 0 && aligned(x, 16);
  const bool a_vec = (r % 4) == 0 && aligned(a, 16);
  const int64_t blocks = (M + kRows - 1) / kRows;
  sparse_lora_kernel<T, RP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (T*)y, (const T*)x, idx, a, b, mask, M, K, N, r, n_adapters, scale, x_vec, a_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* y, const void* x, const int* idx, const float* a, const float* b,
           const float* mask, int64_t M, int64_t K, int64_t N, int r, int n_adapters,
           float scale, cudaStream_t stream) {
#define REPRO_LORA(RP) \
  return launch_rank<T, RP>(y, x, idx, a, b, mask, M, K, N, r, n_adapters, scale, stream)
  if (r <= 4) REPRO_LORA(4);
  if (r <= 8) REPRO_LORA(8);
  if (r <= 16) REPRO_LORA(16);
  if (r <= 32) REPRO_LORA(32);
  REPRO_LORA(64);
#undef REPRO_LORA
}

}  // namespace

extern "C" {

// y (M, N) and x (M, K): contiguous, dtype 0 (float32) or 1 (bfloat16).
// a (A, K, r), b (A, r, N), mask (A, N) or null: contiguous float32.
// idx (M,) int32, or null for a single adapter (A = 1).
int repro_sparse_lora(void* y, const void* x, const void* idx, const void* a, const void* b,
                      const void* mask, int64_t M, int64_t K, int64_t N, int r, int n_adapters,
                      int dtype, float scale, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || r < 1 || r > kMaxRank || n_adapters < 1)
    return (int)cudaErrorInvalidValue;
  if ((M + kRows - 1) / kRows > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const float *af = (const float*)a, *bf = (const float*)b, *mf = (const float*)mask;
  if (dtype == 0)
    return launch<float>(y, x, ix, af, bf, mf, M, K, N, r, n_adapters, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(y, x, ix, af, bf, mf, M, K, N, r, n_adapters, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
