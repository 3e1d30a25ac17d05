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
// bf16. The packed product is the same product with no mask (mask ==
// null) on the kept columns of b, which the wrapper gathers and scatters
// back.
//
// Bound: memory. With r = 8 the two products do ~4 flops per byte of x and
// y moved (2·K·r + 2·r·N flops for 2·(K + N) bytes of a bf16 row), far below
// the ~20 f32 flops per byte of HBM bandwidth of the CUDA cores and the ~295
// of the tensor cores, so the least time is the bytes of x and y (a, b and
// mask are small) over 3.35 TB/s. The math stays on the CUDA cores, in f32
// fused multiply-adds (explicit fmaf, which the build's -fmad=false leaves
// alone): at 4 flops a byte the tensor cores would buy nothing, and f32 sums
// keep x@a unrounded between the products. The sums run in another order
// than the plain version's matmuls, so the two agree at a tolerance, not
// bit for bit. A masked column multiplies b by 0 before the sum, as the
// plain version does, so it comes out exactly 0 for finite b.
//
// Two kernels:
//
// sparse_lora_resident_kernel: the single-adapter product (B5, and B6 on the
// kept columns), when r <= 16 and a, b ⊙ mask and a tile per team fit one
// block's shared memory (team_stages() > 0: at K = N = 896, bf16 x with r
// up to 16, f32 x with r up to 8). Persistent: as many blocks as the SMs
// hold at once (one an SM at qwen2-0.5b's widths), each walking row tiles
// of 16 rows strided by the grid, with two teams of 8 warps that take
// alternate tiles (one team for r > 8, whose sums need the registers), so
// that one team's loads and stores run while the other multiplies.
//   - a (K x r) and b ⊙ mask (r x N) are staged in shared memory once per
//     block (28 KB each at qwen2-0.5b's wq, r 8), so L2 sees them once per
//     block, not once per 16 rows. Both come as bulk copies (the TMA's 1-D
//     form, counted by an mbarrier); a lands as it lies and is rearranged so
//     that a warp's 16-byte reads of it are contiguous; b ⊙ mask is formed
//     as phase 2 reads b and the mask.
//   - x comes through each team's ring of 1-2 tiles (16 rows x K), one bulk
//     copy per row issued by the team's first warp, so the tiles after the
//     current one stay in flight while it is multiplied and no thread waits
//     on copies it issued. Rows that do not allow 16-byte copies (K not a
//     multiple of 16 bytes, x off a 16-byte boundary) are copied element by
//     element instead; a and b likewise.
//   - xa = x @ a: warp (rg, kw) of a team owns 8 rows and every fourth block
//     of 8 pairs of k; a lane accumulates 2 rows x r over its pairs, so each
//     a value read from shared memory serves 2 rows and each x pair 2·r
//     sums. A reduce-scatter over the 8 lanes of a row pair and a sum over
//     the 4 warps of a row group leave xa in shared memory.
//   - y = scale · xa @ (b ⊙ mask): a thread owns 8 neighbouring columns,
//     holds their b ⊙ mask in registers for the tile, and writes two rows
//     at a time with one 16-byte store each (bf16; two for f32) where N
//     allows.
//   - At 4096 rows a block has about 2 tiles, so the time goes to the wait
//     for the first tile and a, then to the two products of one tile per
//     team with few warps to hide their latencies (PERF.md).
//
// sparse_lora_kernel: every other case. The multi-adapter product (B7), and
// the single-adapter product at ranks above 16 or widths whose a and b do
// not fit, which read a and b from L2 per step. One block owns 16 rows and
// all N columns. Phase 1 streams its x rows through shared memory in
// 256-column chunks with 16-byte loads where the rows allow them; the loads
// of the next chunk are issued before the current one is multiplied. It
// accumulates xa in registers: a lane owns 4 rank components of one k per
// step, each warp two rows, so every x element is read from device memory
// once. A single adapter's a (rank up to 16) is staged beside x chunk by
// chunk; multi-adapter rows and larger ranks read a with float4 loads,
// coalesced across the warp, from L1/L2; a shuffle reduction leaves xa in
// shared memory. Phase 2 walks N: a thread owns a column, loads its
// (b ⊙ mask) column once per adapter and writes that column of all 16
// rows. Multi-adapter rows gather their own adapter (BGMV style): the
// block orders its 16 rows by adapter, and a warp reloads a and b only
// when the adapter changes. Sorting the whole batch by adapter (SGMV) is
// later work.
// The TPU kernels' padding to 128/512 tiles has no counterpart: ragged M, N
// and K are masked here.
//
// C interface (loaded with ctypes): repro_sparse_lora returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a rank
// above kMaxRank; repro_sparse_lora_stages says which kernel a
// single-adapter launch takes (its ring depth, or 0).

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

// ---- the single-adapter product with a and b ⊙ mask resident ----

constexpr int kResRows = 16;          // rows per tile: two row groups of 8
constexpr int kResMaxRank = 16;       // a lane's 2 rows x r partial sums
constexpr int kResMaxStages = 4;      // x tiles in the ring, all teams together
constexpr int kTeamThreads = 256;     // a team: 8 warps on one tile at a time
constexpr int kKSplit = kTeamThreads / 64;  // warps sharing a row group's k's

// Teams of a block: two, which take alternate tiles, where a lane's
// registers allow it (rank up to 8), else one.
__host__ __device__ constexpr int res_teams(int RP) { return RP <= 8 ? 2 : 1; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void load_pair(const float* p, float& v0, float& v1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  v0 = v.x;
  v1 = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& v0, float& v1) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v0 = v.x;
  v1 = v.y;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162 h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  u.x = *reinterpret_cast<uint32_t*>(&h[0]);
  u.y = *reinterpret_cast<uint32_t*>(&h[1]);
  u.z = *reinterpret_cast<uint32_t*>(&h[2]);
  u.w = *reinterpret_cast<uint32_t*>(&h[3]);
  *reinterpret_cast<uint4*>(p) = u;
}

// One step of a reduce-scatter over the lanes: lanes with bit `off` set keep
// the upper HALF of v[0, 2 HALF), the others the lower, each summed with its
// partner's copy; the kept values move to v[0, HALF).
template <int HALF>
__device__ __forceinline__ void reduce_half(float* v, int lane, int off) {
  const bool up = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// mbarriers and bulk copies (the Tensor Memory Accelerator's 1-D form)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// bytes (a multiple of 16) global -> shared, both 16-byte aligned; completes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Shared-memory layout of the resident kernel, in bytes from the start:
//   a_s    float4 [RP/4][2][KP/2]: (c, h, p) holds a[2p + h][4c .. 4c + 3]
//   b_s    float  [RP][NB]: b's rows, N rounded up to NB = 8 NG
//   mask_s float  [NB]
//   red_s  float  [teams][kResRows][kKSplit][RP]: the partial sums of each warp
//   xa_s   float  [teams][kResRows][RP]
//   bars   uint64 [kResMaxStages + 2]: one per ring stage, then b's and a's
//   a_tmp  float  [K][r]: a as it lies in device memory, rearranged into a_s
//   ring   T      [teams][stages per team][kResRows][KX]
// KP: K rounded up to even (pairs of k); KX: K rounded up to 8 (16-byte
// rows), and 8 more elements, so that the 4 row pairs a warp reads at once
// start on other banks; NG: N / 8 rounded up. Rows past K, ranks past r and
// columns past N are 0.
struct ResLayout {
  int KP, KX, NG, a, b, mask, red, xa, bars, a_tmp, ring, tile;
  __host__ __device__ ResLayout(int64_t K, int64_t N, int r, int RP, int size) {
    const int teams = res_teams(RP);
    KP = (int)((K + 1) & ~1LL);
    KX = (int)((K + 7) & ~7LL) + 8;
    NG = (int)((N + 7) / 8);
    a = 0;
    b = a + RP * KP * 4;
    mask = b + RP * NG * 32;
    red = mask + NG * 32;
    xa = red + teams * kResRows * kKSplit * RP * 4;
    bars = xa + teams * kResRows * RP * 4;
    a_tmp = bars + 8 * (kResMaxStages + 2);
    ring = a_tmp + (int)(((K * r * 4) + 15) & ~15LL);
    tile = kResRows * KX * size;
  }
  // shared memory for `stages` ring stages per team
  __host__ __device__ int bytes(int RP, int stages) const { return ring + res_teams(RP) * stages * tile; }
};

__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(kTeamThreads) : "memory");
}

template <typename T, int RP>
__global__ void __launch_bounds__(kTeamThreads * res_teams(RP))
    sparse_lora_resident_kernel(T* __restrict__ y, const T* __restrict__ x, const float* __restrict__ a,
                                const float* __restrict__ b, const float* __restrict__ mask, int64_t M,
                                int K, int N, int r, float scale, int stages, bool x_vec, bool a_vec,
                                bool b_vec, bool y_vec) {
  constexpr int TEAMS = res_teams(RP);
  constexpr int V = 2 * RP;   // a lane's partial sums: 2 rows x RP
  constexpr int VL = V / 8;   // what each lane keeps after the reduce-scatter
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const ResLayout lay(K, N, r, RP, (int)sizeof(T));
  float4* a_s = reinterpret_cast<float4*>(base + lay.a);
  float* b_s = reinterpret_cast<float*>(base + lay.b);
  float* mask_s = reinterpret_cast<float*>(base + lay.mask);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + lay.bars);  // [stages], then b's, then a's
  const float* a_tmp = reinterpret_cast<const float*>(base + lay.a_tmp);
  const int KP = lay.KP, KP2 = lay.KP / 2, KX = lay.KX, NG = lay.NG, NB = 8 * lay.NG;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = tid / kTeamThreads, ttid = tid % kTeamThreads, twarp = ttid >> 5;
  const int64_t ntiles = (M + kResRows - 1) / kResRows;
  uint64_t* b_bar = bars + kResMaxStages;
  uint64_t* a_bar = bars + kResMaxStages + 1;
  float* red_s = reinterpret_cast<float*>(base + lay.red) + team * kResRows * kKSplit * RP;
  float* xa_s = reinterpret_cast<float*>(base + lay.xa) + team * kResRows * RP;
  T* ring = reinterpret_cast<T*>(base + lay.ring) + team * stages * kResRows * KX;
  uint64_t* tbars = bars + team * stages;

  if (tid == 0) {
    for (int i = 0; i < kResMaxStages + 2; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block's tiles are blockIdx.x + j gridDim.x; team t takes those with
  // j % TEAMS == t, its k-th into its ring stage k % stages. With 16-byte
  // rows, the team's first warp copies them (lane i row i, as bulk copies
  // that the stage's mbarrier counts), so no thread waits on a copy it
  // issued; otherwise the team's threads copy elements, synchronously.
  auto issue = [&](int k) {
    const int64_t tile = blockIdx.x + ((int64_t)k * TEAMS + team) * gridDim.x;
    if (tile >= ntiles) return;
    T* dst = ring + (k % stages) * kResRows * KX;
    const int64_t m0 = tile * kResRows;
    const int rows = M - m0 < kResRows ? (int)(M - m0) : kResRows;
    if (x_vec) {
      if (twarp == 0) {
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after this stage's last reads
          mbar_expect_tx(tbars + k % stages, rows * K * (int)sizeof(T));
        }
        __syncwarp();
        if (lane < rows)
          bulk_copy(dst + lane * KX, x + (m0 + lane) * K, K * (int)sizeof(T), tbars + k % stages);
      }
    } else {
      for (int e = ttid; e < kResRows * KX; e += kTeamThreads) {
        const int row = e / KX, c = e % KX;
        dst[row * KX + c] = (row < rows && c < K) ? x[(m0 + row) * K + c] : from_f32<T>(0.0f);
      }
    }
  };
  // what the first products need comes first: a (a bulk copy where its rows
  // allow) and the first team's first tiles; b, the mask and the other
  // team's tiles once a has landed
  if (tid == 0 && a_vec) {
    mbar_expect_tx(a_bar, K * r * 4);
    bulk_copy(const_cast<float*>(a_tmp), a, K * r * 4, a_bar);
  }
  if (team == 0)
    for (int k = 0; k < stages - 1; ++k) issue(k);
  // what the bulk copies leave: b's rows past r and columns past N; all of
  // b and the mask when the copies cannot take them
  for (int e = tid; e < RP * NB; e += TEAMS * kTeamThreads) {
    const int rr = e / NB, n = e % NB;
    if (rr >= r || n >= N) b_s[e] = 0.f;
    else if (!b_vec) b_s[e] = b[(int64_t)rr * N + n];
  }
  if (mask != nullptr) {
    for (int n = tid; n < NB; n += TEAMS * kTeamThreads)
      if (n >= N) mask_s[n] = 0.f;
      else if (!b_vec) mask_s[n] = mask[n];
  }
  // a into the layout phase 1 reads: 16-byte pieces (c, h, p)
  if (a_vec) mbar_wait(a_bar, 0);
  for (int e = tid; e < RP / 4 * KP; e += TEAMS * kTeamThreads) {
    const int c = e / KP, k = e % KP;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < K && 4 * c < r) {
      if (a_vec) {
        v = *reinterpret_cast<const float4*>(a_tmp + k * r + 4 * c);
      } else {
        const float* src = a + (int64_t)k * r + 4 * c;
        v = make_float4(src[0], 4 * c + 1 < r ? src[1] : 0.f, 4 * c + 2 < r ? src[2] : 0.f,
                        4 * c + 3 < r ? src[3] : 0.f);
      }
    }
    a_s[(2 * c + (k & 1)) * KP2 + (k >> 1)] = v;
  }
  __syncthreads();  // a_s, the zeros and the element copies visible to both teams
  if (warp == 0 && b_vec) {  // lane i copies b's row i; lane r the mask
    if (lane == 0) mbar_expect_tx(b_bar, (r + (mask != nullptr)) * N * 4);
    __syncwarp();
    if (lane < r) bulk_copy(b_s + lane * NB, b + (int64_t)lane * N, N * 4, b_bar);
    if (lane == r && mask != nullptr) bulk_copy(mask_s, mask, N * 4, b_bar);
  }
  if (team == 1)
    for (int k = 0; k < stages - 1; ++k) issue(k);

  // phase 1's lanes: warp (rg, kw) of the team owns rows 8 rg .. 8 rg + 7
  // and pairs of k p = kp + 8 (kw + kKSplit j); lane (rq, kp) rows 8 rg + 2 rq and + 1
  const int rg = twarp / kKSplit, kw = twarp % kKSplit, rq = lane >> 3, kp = lane & 7;
  int k = 0;
  for (int64_t tile = blockIdx.x + (int64_t)team * gridDim.x; tile < ntiles;
       tile += (int64_t)TEAMS * gridDim.x, ++k) {
    issue(k + stages - 1);  // into the stage that the team's tile k - 1 used
    if (x_vec) mbar_wait(tbars + k % stages, (k / stages) & 1);
    team_sync(team);  // tile k visible to the whole team
    const T* xt = ring + (k % stages) * kResRows * KX + (8 * rg + 2 * rq) * KX;

    // xa partial sums over this lane's pairs of k, for its 2 rows
    float v[V];  // v[i * RP + q]: row i, rank q
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.f;
#pragma unroll 2
    for (int p = kp + 8 * kw; p < KP2; p += 8 * kKSplit) {
      float4 a0[RP / 4], a1[RP / 4];
#pragma unroll
      for (int c = 0; c < RP / 4; ++c) {
        a0[c] = a_s[(2 * c) * KP2 + p];
        a1[c] = a_s[(2 * c + 1) * KP2 + p];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x0, x1;
        load_pair(xt + i * KX + 2 * p, x0, x1);
#pragma unroll
        for (int c = 0; c < RP / 4; ++c) {
          float* o = v + i * RP + 4 * c;
          o[0] = fmaf(x1, a1[c].x, fmaf(x0, a0[c].x, o[0]));
          o[1] = fmaf(x1, a1[c].y, fmaf(x0, a0[c].y, o[1]));
          o[2] = fmaf(x1, a1[c].z, fmaf(x0, a0[c].z, o[2]));
          o[3] = fmaf(x1, a1[c].w, fmaf(x0, a0[c].w, o[3]));
        }
      }
    }
    // reduce-scatter over the 8 lanes of a row pair: lane kp ends with
    // entries [kp·VL, (kp+1)·VL) of the flattened (row, rank) sums
    reduce_half<V / 2>(v, lane, 4);
    reduce_half<V / 4>(v, lane, 2);
    reduce_half<V / 8>(v, lane, 1);
#pragma unroll
    for (int i = 0; i < VL; ++i) {
      const int e = kp * VL + i, row = 8 * rg + 2 * rq + e / RP;
      red_s[(row * kKSplit + kw) * RP + e % RP] = v[i];
    }
    team_sync(team);  // and this tile's stage is consumed: the next issue may refill it
    if (ttid < kResRows * RP) {  // the sum over the k-splitting warps
      const float* src = red_s + ttid / RP * kKSplit * RP + ttid % RP;
      float s = src[0];
#pragma unroll
      for (int w = 1; w < kKSplit; ++w) s += src[w * RP];
      xa_s[ttid] = s;
    }
    if (k == 0 && b_vec) mbar_wait(b_bar, 0);
    team_sync(team);

    // y = scale · xa @ (b ⊙ mask): 8 columns of RL-strided rows per item
    const int64_t m0 = tile * kResRows;
    const int RL = NG >= kTeamThreads ? 1 : kTeamThreads / NG;
    for (int item = ttid; item < NG * RL; item += kTeamThreads) {
      const int g = item % NG, rl = item / NG;
      float bm[RP][8];
      float4 mlo = make_float4(1.f, 1.f, 1.f, 1.f), mhi = mlo;
      if (mask != nullptr) {
        mlo = reinterpret_cast<const float4*>(mask_s)[2 * g];
        mhi = reinterpret_cast<const float4*>(mask_s)[2 * g + 1];
      }
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        const float4 lo = reinterpret_cast<const float4*>(b_s + rr * NB)[2 * g];
        const float4 hi = reinterpret_cast<const float4*>(b_s + rr * NB)[2 * g + 1];
        const float bv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const float mv[8] = {mlo.x, mlo.y, mlo.z, mlo.w, mhi.x, mhi.y, mhi.z, mhi.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) bm[rr][q] = mask != nullptr ? bv[q] * mv[q] : bv[q];
      }
      const int n0 = 8 * g;
      const bool full = y_vec && n0 + 8 <= N;
      // two rows at a time, 16 independent sums (a row past the tile or
      // past M is computed and not stored)
      for (int row = rl; row < kResRows && m0 + row < M; row += 2 * RL) {
        const int row2 = row + RL < kResRows ? row + RL : row;
        float out[2][8];
#pragma unroll
        for (int q = 0; q < 8; ++q) out[0][q] = out[1][q] = 0.f;
#pragma unroll
        for (int c = 0; c < RP / 4; ++c) {
          const float4 xv = reinterpret_cast<const float4*>(xa_s + row * RP)[c];
          const float4 xw = reinterpret_cast<const float4*>(xa_s + row2 * RP)[c];
          const float xs4[2][4] = {{xv.x, xv.y, xv.z, xv.w}, {xw.x, xw.y, xw.z, xw.w}};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              out[0][q] = fmaf(xs4[0][u], bm[4 * c + u][q], out[0][q]);
              out[1][q] = fmaf(xs4[1][u], bm[4 * c + u][q], out[1][q]);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rw = h ? row + RL : row;
          if (rw >= kResRows || m0 + rw >= M) break;
#pragma unroll
          for (int q = 0; q < 8; ++q) out[h][q] = scale * out[h][q];
          T* yp = y + (m0 + rw) * N + n0;
          if (full) {
            store8(yp, out[h]);
          } else {
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (n0 + q < N) yp[q] = from_f32<T>(out[h][q]);
          }
        }
      }
    }
  }
}

// the current device's SM count and opt-in shared memory per block, read once per device
struct DeviceInfo {
  int sms, smem_optin;
};
DeviceInfo device_info() {
  static DeviceInfo cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return DeviceInfo{0, 0};
  DeviceInfo& d = cache[dev];
  if (d.sms == 0 && (cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
                     cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
                         cudaSuccess))
    d = DeviceInfo{0, 0};
  return d;
}

int rank_pad(int r) { return r <= 4 ? 4 : r <= 8 ? 8 : 16; }

// ring stages per team of the resident kernel for these widths (1..kResMaxStages
// / teams), or 0 when a, b ⊙ mask and a team's tile do not fit one block's
// shared memory
int team_stages(int64_t K, int64_t N, int r, int size) {
  if (r > kResMaxRank || K < 1 || K > (1 << 24) || N > (1 << 24)) return 0;
  const int RP = rank_pad(r);
  const ResLayout lay(K, N, r, RP, size);
  const int64_t room = device_info().smem_optin;
  const int64_t stages = (room - lay.ring) / ((int64_t)res_teams(RP) * lay.tile);
  const int64_t most = kResMaxStages / res_teams(RP);
  return (int)(stages < 1 ? 0 : stages < most ? stages : most);
}


template <typename T, int RP>
int launch_resident(void* y, const void* x, const float* a, const float* b, const float* mask, int64_t M,
                    int64_t K, int64_t N, int r, float scale, int stages, cudaStream_t stream) {
  const ResLayout lay(K, N, r, RP, (int)sizeof(T));
  const int bytes = lay.bytes(RP, stages);
  // the attribute and the occupancy query only when the shared memory changes
  static int opted_in = 0, last_bytes = -1, per_sm = 0;
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(sparse_lora_resident_kernel<T, RP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  if (bytes != last_bytes) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sparse_lora_resident_kernel<T, RP>, kTeamThreads * res_teams(RP), bytes);
    if (err != cudaSuccess) return (int)err;
    last_bytes = bytes;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t ntiles = (M + kResRows - 1) / kResRows;
  const int64_t resident = (int64_t)per_sm * device_info().sms;
  const int64_t blocks = ntiles < resident ? ntiles : resident;
  const bool x_vec = (K * (int64_t)sizeof(T)) % 16 == 0 && aligned(x, 16);
  const bool a_vec = r % 4 == 0 && aligned(a, 16);  // K r 4 bytes: a multiple of 16
  const bool b_vec = N % 4 == 0 && aligned(b, 16) && (mask == nullptr || aligned(mask, 16));
  const bool y_vec = (N * (int64_t)sizeof(T)) % 16 == 0 && aligned(y, 16);
  sparse_lora_resident_kernel<T, RP><<<(unsigned)blocks, kTeamThreads * res_teams(RP), bytes, stream>>>(
      (T*)y, (const T*)x, a, b, mask, M, (int)K, (int)N, r, scale, stages, x_vec, a_vec, b_vec, y_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_single(void* y, const void* x, const float* a, const float* b, const float* mask, int64_t M,
                  int64_t K, int64_t N, int r, float scale, cudaStream_t stream) {
  const int stages = team_stages(K, N, r, (int)sizeof(T));
  if (stages == 0) return launch<T>(y, x, nullptr, a, b, mask, M, K, N, r, 1, scale, stream);
  const int RP = rank_pad(r);
  if (RP == 4) return launch_resident<T, 4>(y, x, a, b, mask, M, K, N, r, scale, stages, stream);
  if (RP == 8) return launch_resident<T, 8>(y, x, a, b, mask, M, K, N, r, scale, stages, stream);
  return launch_resident<T, 16>(y, x, a, b, mask, M, K, N, r, scale, stages, stream);
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
  if (dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if (ix == nullptr) {
    if (dtype == 0) return launch_single<float>(y, x, af, bf, mf, M, K, N, r, scale, s);
    return launch_single<__nv_bfloat16>(y, x, af, bf, mf, M, K, N, r, scale, s);
  }
  if (dtype == 0)
    return launch<float>(y, x, ix, af, bf, mf, M, K, N, r, n_adapters, scale, s);
  return launch<__nv_bfloat16>(y, x, ix, af, bf, mf, M, K, N, r, n_adapters, scale, s);
}

// The ring depth (all teams' stages) that the single-adapter product takes
// at these widths on the current device: 1..4 for the resident kernel, 0 for
// the kernel that reads a and b from L2 per step.
int repro_sparse_lora_stages(int64_t K, int64_t N, int r, int dtype) {
  if (K < 0 || N <= 0 || r < 1 || r > kMaxRank || dtype < 0 || dtype > 1) return -1;
  return team_stages(K, N, r, dtype == 0 ? 4 : 2) * res_teams(rank_pad(r));
}

}  // extern "C"
