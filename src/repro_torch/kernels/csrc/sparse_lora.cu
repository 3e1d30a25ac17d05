// Neuron-masked LoRA products of FibecFed (paper §4.3.2), single-adapter,
// gather-packed and multi-adapter, written for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/sparse_lora.py::sparse_lora_matmul          (_kernel)
//   src/repro/kernels/sparse_lora.py::sparse_lora_matmul_packed   (_packed_kernel,
//       with the gather and scatter of its wrapper, src/repro/kernels/ops.py)
//   src/repro/kernels/sparse_lora.py::batched_sparse_lora_matmul  (_batched_kernel)
//
// Each row m of x (M, K) gets an adapter i(m): 0 for the single-adapter
// products, idx[m] for the multi-adapter one (a row whose idx lies outside
// [0, A) comes out as zeros, as the TPU kernel gives it). Then, in f32,
//   xa[m] = x[m] @ a[i]                              (K -> r)
//   y[m]  = scale · (xa[m] @ (b[i] ⊙ mask[i]))       (r -> N), in x's dtype
// with a (K, r), b (r, N) and mask (N,) per adapter, all f32, and x f32 or
// bf16. The packed product (B6) is the same product on the kept columns
// (mask != 0), with b as it is there, and an exact 0 in every frozen
// column: it never reads b at a frozen column, so a non-finite value there
// does not reach y (the masked product's b · 0 gives NaN there, as the TPU
// kernel's does), and it writes all of y once, with no gather, zero fill or
// scatter around the launch and no host sync.
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
// plain version does, so it comes out exactly 0 for finite b. A row's sums
// do not depend on where in a tile the row sits, so every path that shares
// the per-tile code gives a row the same bits.
//
// The kernels:
//
// sparse_lora_resident_kernel: a and b ⊙ mask resident in shared memory.
// It takes the single-adapter products (B5, B6) where r <= 16 and a,
// b ⊙ mask and a tile per team fit one block's shared memory (team_stages()
// > 0: at K = N = 896, bf16 x with r up to 16, f32 x with r up to 8), and
// the multi-adapter product (B7) where, besides, A <= kMaxSgmvAdapters and
// M >= 16·A (a tile's rows per adapter on average; sgmv_stages()). As many
// blocks as the SMs hold at once (one an SM at qwen2-0.5b's widths), each
// taking an even share [g·T/G, (g+1)·T/G) of the T row tiles of 16, with two
// teams of 8 warps that take alternate tiles (one team for r > 8, whose sums
// need the registers), so that one team's loads and stores run while the
// other multiplies.
//   - B7 is an SGMV kernel, the first of two designs: one launch, and the
//     plan stays on the device. Every block reads idx (16 KB at 4096 rows,
//     from L2, with 16-byte loads) and counts the rows of each segment,
//     adapters 0..A-1 and then segment A, the rows out of range, with
//     warp-aggregated shared-memory atomics; its first warp scans the counts
//     into each segment's first row and first tile in the order sorted by
//     segment and cuts the block's tiles into pieces at segment boundaries.
//     The block then lists each piece's rows in row order (stable) from
//     per-thread counts and a block prefix sum, two pieces a pass; up to
//     8 NT rows the segments read for the counts stay in registers, so idx
//     is read once. Tiles, not adapters, are shared out, so a skewed batch
//     keeps every SM busy. Per piece the block stages that adapter's a and
//     b ⊙ mask once (the first piece's a is copied in while the rows are
//     listed, the next piece's while the current one runs; b after a has
//     landed, which PERF.md found faster than both at once) and streams the
//     piece's rows through the ring: x rows are gathered by bulk copies from
//     their places, y rows written back to theirs. Segment A is last; its
//     tiles read nothing and write zero rows. The second design, a
//     counting-sort kernel that writes a permutation for a second launch,
//     was not taken: at the main path's 4096 rows the kernel boundary and a
//     one-block sort would add as much latency as the plan, and a launch.
//     What this one costs (PERF.md): the plan's chain of loads and block
//     barriers before the first tile can be copied, and a block whose tiles
//     span two adapters runs them one team at a time with a restage between.
//     The plan's rows and segment offsets can be written out (plan != null)
//     to be held against the plain twin of the plan.
//   - The single-adapter products are one piece of one segment with no
//     plan, their tiles strided by the grid; each of the three products is
//     compiled apart (ResMode), so B5 carries none of the plan's code. A
//     batch whose rows are all on one adapter gives B5's bits.
//   - a (K x r) and b ⊙ mask (r x N) are staged in shared memory once per
//     piece (28 KB each at qwen2-0.5b's wq, r 8), so L2 sees them once per
//     block and adapter, not once per 16 rows. Both come as bulk copies (the
//     TMA's 1-D form, counted by an mbarrier); a lands as it lies and is
//     rearranged so that a warp's 16-byte reads of it are contiguous;
//     b ⊙ mask is formed as phase 2 reads b and the mask. The packed product
//     reads the mask first, then only b's kept columns, element by element
//     (the last team, while the first multiplies its first tile).
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
// sparse_lora_kernel: the single-adapter products that the resident kernel
// does not take (ranks above 16, widths whose a and b do not fit), reading
// a and b from L2 per step; and a multi-adapter launch of the few-row or
// split path's widths made without their scratch (chip_smoke.py times it
// there beside them, as the kernel those launches took before). One block
// owns 16 rows and all N columns. Phase 1 streams its x rows through
// shared memory in 256-column chunks with 16-byte loads where the rows allow
// them; the loads of the next chunk are issued before the current one is
// multiplied. It accumulates xa in registers: a lane owns 4 rank components
// of one k per step, each warp two rows, so every x element is read from
// device memory once. A single adapter's a (rank up to 16) is staged beside
// x chunk by chunk; multi-adapter rows and larger ranks read a with float4
// loads, coalesced across the warp, from L1/L2; a shuffle reduction leaves
// xa in shared memory. Phase 2 walks N: a thread owns a column, loads its
// (b ⊙ mask) column once per adapter and writes that column of all 16
// rows. Multi-adapter rows gather their own adapter (BGMV): the block orders
// its 16 rows by adapter, and a warp reloads a and b only when the adapter
// changes. The packed product reads no b at a frozen column and writes 0.
// The TPU kernels' padding to 128/512 tiles has no counterpart: ragged M, N
// and K are masked here.
//
// sparse_lora_few_rows_xa_kernel + sparse_lora_few_rows_y_kernel: the
// multi-adapter product with at most kFewMaxRows (64) rows that the SGMV kernel does not take (fewer than
// 16 rows an adapter), a decode step's shape (one row a serving slot, each
// slot its own adapter). BGMV would give all of them one block, so one
// SM of 132 would read every adapter's a and b (at mamba2-1.3b's in_proj,
// K 2048, N 8512, rank 8, 8 adapters: 3.1 MB, 0.94 µs of HBM time, and the
// BGMV kernel took 0.227 ms). The work is split in two launches over the
// whole card instead:
//   1. xa = x @ a[idx], split over K: block s takes a slice of K (at most
//      64 slices) for every row and writes f32 partials (M x r a slice) to a
//      scratch the wrapper allocates; a warp takes a row, its lanes k's and
//      rank quads, and reads a with 16-byte loads.
//   2. y = scale · xa @ (b[idx] ⊙ mask[idx]), split over N: a thread owns
//      4 columns (1 at ranks above 16) of one distinct adapter of the rows,
//      so rows that share an adapter read its columns once, with 16-byte
//      loads. It is launched with programmatic stream serialization: its
//      blocks start while the first phase runs, list the rows' adapters and
//      load b ⊙ mask, then wait (griddepcontrol.wait) for the partials, sum
//      the splits of their rows in a fixed order (a warp a row and rank
//      quad) and write y.
// Both launches are enqueued with no host sync, so a CUDA graph captures
// them (the graph keeps the programmatic edge). A row out of range is
// exactly 0; a masked column is 0 for finite b (b · 0 summed). Bound:
// memory; the least time is a, b and mask of the adapters in use, x and y
// over the HBM rate; what is left is two dependent launches' latency.
//
// sparse_lora_split_xa_kernel + sparse_lora_split_y_kernel: the split path,
// the multi-adapter product (the TPU kernel batched_sparse_lora_matmul) of
// more than kFewMaxRows rows that the SGMV kernel does not take: a and
// b ⊙ mask too wide to stage (a wide model's prefill: mamba2-1.3b's in_proj,
// K 2048 and N 8512), more than kMaxSgmvAdapters adapters, or fewer than 16
// rows an adapter. Bound: memory, x read once and y written once (86 MB at
// mamba2's in_proj over 4096 bf16 rows, 26 µs at 3.35 TB/s); at rank 8 the
// work is ~4 flops a byte, which the CUDA cores carry in f32 fmaf (x @ a
// stays unrounded between the products, as in the plain version). No
// tensor core or TMA is used: the products are f32 (bf16 or TF32 operands
// would round a, b or xa), and x and y move as plain 16-byte loads and
// stores. The L2 kernel that these launches took before reached 6-14% of
// that bound: 64 blocks at 1024 rows, its two products one after the other
// in each block, b ⊙ mask re-read from L2 across N, 2-byte stores. Two
// launches over the whole card instead, no host sync:
//   1. Shrink, xa = x @ a[idx] in f32 over (row tile, K-slice) blocks
//      (32-row tiles at rank 8; as few slices of whole steps as give about
//      four blocks an SM), f32 partials to a scratch from PyTorch's caching
//      allocator. x is read from HBM once, with one 16-byte load a row and
//      lane two steps ahead of its use, into registers; a is staged a step
//      at a time for each adapter of the tile (one on the serve path, whose
//      rows are slot-contiguous) by cp.async copies through a ring, read
//      from L2, each staged value serving a warp's rows.
//   2. Expand, y = scale · xa @ (b ⊙ mask) over (row chunk, 256-column)
//      blocks, about four an SM, launched with programmatic stream
//      serialization: before griddepcontrol.wait a block stages its column
//      tile of b and the mask (8 KB at rank 8) for its first row's adapter
//      and each warp takes its columns' b ⊙ mask into registers, while the
//      shrink runs; then each warp sums its rows' partials (the next group's
//      loading meanwhile) and writes y, each thread 8 neighbouring columns
//      with one 16-byte store (bf16).
// Sum order, fixed by the shapes alone (no atomics): a row's xa is, in each
// K-slice, each lane's sum over its k's in step order, then a reduce-scatter
// over the warp's 32 lanes; the slices are added in order; y's r products
// are summed in rank order. So a launch gives the same bits every time, and
// a CUDA graph captures both launches. The ring's depth, the grids' blocks
// an SM and the expand's row groups are the best of an on-card sweep
// (scripts/torch_split_sweep.py; PERF.md), which also times each
// launch alone: neither reaches the HBM rate yet, and they do not overlap
// (the expand waits for the whole shrink).
//
// C interface (loaded with ctypes): repro_sparse_lora picks the kernel and
// launches it, returning cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take;
// repro_sparse_lora_stages gives the resident kernel's ring depth (0 where
// a launch reads a and b from L2), and repro_sparse_lora_path which kernel
// a multi-adapter launch takes and the floats of the few-row or split
// path's scratch.

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
                       int n_adapters, float scale, bool packed, bool x_vec, bool a_vec) {
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
    bool frozen = false;  // the packed product: no b read, an exact 0
    for (int t = 0; t < kRows; ++t) {
      const int row = order_s[t];
      const int64_t m = m0 + row;
      if (m >= M) continue;
      const int ad = ad_s[row];
      float out = 0.0f;
      if (ad >= 0) {
        if (ad != cur) {
          const float* bp = b + (int64_t)ad * r * N + n;
          const float mk = mask[(int64_t)ad * N + n];
          frozen = packed && mk == 0.0f;
#pragma unroll
          for (int rr = 0; rr < RP; ++rr)
            bm[rr] = rr < r && !frozen ? (packed ? bp[(int64_t)rr * N] : bp[(int64_t)rr * N] * mk) : 0.0f;
          cur = ad;
        }
        float s = 0.0f;
#pragma unroll
        for (int rr = 0; rr < RP; ++rr) s = fmaf(xa_s[row][rr], bm[rr], s);
        out = frozen ? 0.0f : scale * s;
      }
      y[m * N + n] = from_f32<T>(out);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p % bytes) == 0; }

template <typename T, int RP>
int launch_rank(void* y, const void* x, const int* idx, const float* a, const float* b, const float* mask,
                int64_t M, int64_t K, int64_t N, int r, int n_adapters, float scale, bool packed,
                cudaStream_t stream) {
  const bool x_vec = (K % (16 / (int64_t)sizeof(T))) == 0 && aligned(x, 16);
  const bool a_vec = (r % 4) == 0 && aligned(a, 16);
  const int64_t blocks = (M + kRows - 1) / kRows;
  sparse_lora_kernel<T, RP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (T*)y, (const T*)x, idx, a, b, mask, M, K, N, r, n_adapters, scale, packed, x_vec, a_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* y, const void* x, const int* idx, const float* a, const float* b, const float* mask,
           int64_t M, int64_t K, int64_t N, int r, int n_adapters, float scale, bool packed,
           cudaStream_t stream) {
#define REPRO_LORA(RP) \
  return launch_rank<T, RP>(y, x, idx, a, b, mask, M, K, N, r, n_adapters, scale, packed, stream)
  if (r <= 4) REPRO_LORA(4);
  if (r <= 8) REPRO_LORA(8);
  if (r <= 16) REPRO_LORA(16);
  if (r <= 32) REPRO_LORA(32);
  REPRO_LORA(64);
#undef REPRO_LORA
}

// ---- a and b ⊙ mask resident: the single-adapter products and SGMV ----

constexpr int kResRows = 16;          // rows per tile: two row groups of 8
constexpr int kResMaxRank = 16;       // a lane's 2 rows x r partial sums
constexpr int kResMaxStages = 4;      // x tiles in the ring, all teams together
constexpr int kTeamThreads = 256;     // a team: 8 warps on one tile at a time
constexpr int kKSplit = kTeamThreads / 64;  // warps sharing a row group's k's
constexpr int kListTiles = 64;        // a planning block's tiles at most
constexpr int kMaxSgmvAdapters = 1024;

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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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
// after the generic proxy's last access to shared memory that a bulk copy
// is about to overwrite
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// bytes (a multiple of 16) global -> shared, both 16-byte aligned; completes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// The segment of an adapter index: itself in [0, A), else A (out of range).
__device__ __forceinline__ int segment(int v, int A) { return (unsigned)v < (unsigned)A ? v : A; }

// Shared-memory layout of the resident kernel, in bytes from the start:
//   a_s    float4 [RP/4][2][KP/2]: (c, h, p) holds a[2p + h][4c .. 4c + 3]
//   b_s    float  [RP][NB]: b's rows, N rounded up to NB = 8 NG
//   mask_s float  [NB]
//   red_s  float  [teams][kResRows][kKSplit][RP]: the partial sums of each warp
//   xa_s   float  [teams][kResRows][RP]
//   bars   uint64 [kResMaxStages + 2]: one per ring stage, then b's and a's
//   a_tmp  float  [K][r]: a as it lies in device memory, rearranged into a_s
//   ring   T      [teams][stages per team][kResRows][KX]
//   plan   int    (the multi-adapter product only) the segments' row counts
//                 [A + 1], first tiles [A + 2] and first rows [A + 2]; the
//                 block's rows [kListTiles][kResRows], each tile's row count
//                 [kListTiles]; each piece's first tile [kListTiles + 1] and
//                 segment [kListTiles]; 40 words of block sums
// KP: K rounded up to even (pairs of k); KX: K rounded up to 8 (16-byte
// rows), and 8 more elements, so that the 4 row pairs a warp reads at once
// start on other banks; NG: N / 8 rounded up. Rows past K, ranks past r and
// columns past N are 0.
struct ResLayout {
  int KP, KX, NG, a, b, mask, red, xa, bars, a_tmp, ring, tile, plan_bytes;
  __host__ __device__ ResLayout(int64_t K, int64_t N, int r, int RP, int size, int A) {
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
    plan_bytes = A > 0 ? 4 * (3 * A + 5 + kListTiles * (kResRows + 3) + 1 + 40) : 0;
  }
  // where the plan starts, and the shared memory of a block, with `stages`
  // ring stages per team
  __host__ __device__ int plan(int RP, int stages) const { return ring + res_teams(RP) * stages * tile; }
  __host__ __device__ int bytes(int RP, int stages) const { return plan(RP, stages) + plan_bytes; }
};

__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(kTeamThreads) : "memory");
}

// The products it takes, each compiled apart: B5 (the masked single-adapter
// product), B6 (packed) and B7 (SGMV, with idx).
enum ResMode { kMasked, kPacked, kSgmv };

template <typename T, int RP, int MODE>
__global__ void __launch_bounds__(kTeamThreads * res_teams(RP))
    sparse_lora_resident_kernel(T* __restrict__ y, const T* __restrict__ x, const int* __restrict__ idx,
                                const float* __restrict__ a, const float* __restrict__ b,
                                const float* __restrict__ mask, int* __restrict__ plan_out, int64_t M, int K,
                                int N, int r, int A, float scale, int stages, bool x_vec,
                                bool a_vec, bool b_vec, bool y_vec) {
  constexpr int TEAMS = res_teams(RP);
  constexpr int NT = kTeamThreads * TEAMS;
  constexpr int V = 2 * RP;   // a lane's partial sums: 2 rows x RP
  constexpr int VL = V / 8;   // what each lane keeps after the reduce-scatter
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  constexpr bool multi = MODE == kSgmv, packed = MODE == kPacked;
  const ResLayout lay(K, N, r, RP, (int)sizeof(T), multi ? A : 0);
  float4* a_s = reinterpret_cast<float4*>(base + lay.a);
  float* b_s = reinterpret_cast<float*>(base + lay.b);
  float* mask_s = reinterpret_cast<float*>(base + lay.mask);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + lay.bars);  // [stages], then b's, then a's
  float* a_tmp = reinterpret_cast<float*>(base + lay.a_tmp);
  const int KP = lay.KP, KP2 = lay.KP / 2, KX = lay.KX, NG = lay.NG, NB = 8 * lay.NG;
  int* cnt_s = reinterpret_cast<int*>(base + lay.plan(RP, stages));  // [A + 1] rows per segment
  int* toff_s = cnt_s + (A + 1);                    // [A + 2] first tile of each segment
  int* roff_s = toff_s + (A + 2);                   // [A + 2] first row of each segment
  int* list_s = roff_s + (A + 2);                   // [kListTiles][kResRows] the block's rows
  int* tr_s = list_s + kListTiles * kResRows;       // [kListTiles] rows in each tile
  int* pj_s = tr_s + kListTiles;                    // [kListTiles + 1] first tile of each piece
  int* ps_s = pj_s + kListTiles + 1;                // [kListTiles] segment of each piece
  int* sum_s = ps_s + kListTiles;  // [40] the pieces' count, warp sums [1, 33), the block's share

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = tid / kTeamThreads, ttid = tid % kTeamThreads, twarp = ttid >> 5;
  uint64_t* b_bar = bars + kResMaxStages;
  uint64_t* a_bar = bars + kResMaxStages + 1;
  float* red_s = reinterpret_cast<float*>(base + lay.red) + team * kResRows * kKSplit * RP;
  float* xa_s = reinterpret_cast<float*>(base + lay.xa) + team * kResRows * RP;
  T* ring = reinterpret_cast<T*>(base + lay.ring) + team * stages * kResRows * KX;
  uint64_t* tbars = bars + team * stages;

  // --- the plan (B7): the segments' counts and offsets, then the block's share ---
  // The segments (-1 past M) of a thread's rows of a batch of 8 NT: rows
  // 4 tid + u of its first half and 4 NT + 4 tid + u of its second, so that
  // a warp's 16-byte loads are contiguous.
  int sv[8];
  const bool idx_vec = ((uintptr_t)idx & 15) == 0;
  auto load_segments = [&](int64_t m0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + 4 * ((int64_t)h * NT + tid);
      if (idx_vec && m + 4 <= M) {
        const int4 v = *reinterpret_cast<const int4*>(idx + m);
        sv[4 * h] = segment(v.x, A);
        sv[4 * h + 1] = segment(v.y, A);
        sv[4 * h + 2] = segment(v.z, A);
        sv[4 * h + 3] = segment(v.w, A);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) sv[4 * h + u] = m + u < M ? segment(idx[m + u], A) : -1;
      }
    }
  };
  if (multi) load_segments(0);  // in flight while the barriers are set up
  if (tid == 0) {
    for (int i = 0; i < kResMaxStages; ++i) mbar_init(bars + i, 1);
    // the packed product's b is gathered by a team whose threads all arrive
    mbar_init(b_bar, packed ? kTeamThreads : 1);
    mbar_init(a_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (multi)
    for (int i = tid; i <= A; i += NT) cnt_s[i] = 0;
  __syncthreads();

  int P = 1;  // pieces: runs of the block's tiles in one segment
  auto adapter = [&](int p) { return multi ? ps_s[p] : 0; };
  // a (a bulk copy into a_tmp where its rows allow) for piece p, if it has
  // one, by one thread
  auto issue_a = [&](int p) {
    if (!a_vec || p >= P || adapter(p) == A) return;
    fence_async();
    mbar_expect_tx(a_bar, K * r * 4);
    bulk_copy(a_tmp, a + (int64_t)adapter(p) * K * r, K * r * 4, a_bar);
  };
  // b's rows and the mask of piece p as bulk copies, by one warp: lane i
  // copies b's row i, lane r the mask
  auto issue_b = [&](int p) {
    const int64_t ad = adapter(p);
    if (lane == 0) {
      fence_async();
      mbar_expect_tx(b_bar, (r + 1) * N * 4);
    }
    __syncwarp();
    if (lane < r) bulk_copy(b_s + lane * NB, b + (ad * r + lane) * N, N * 4, b_bar);
    if (lane == r) bulk_copy(mask_s, mask + ad * N, N * 4, b_bar);
  };
  // n · g / gridDim.x, in 32 bits where it fits (64-bit division is long)
  auto part = [&](uint64_t n, uint64_t g) -> int64_t {
    const uint64_t prod = n * g;
    return prod >> 32 ? (int64_t)(prod / gridDim.x) : (int64_t)((uint32_t)prod / gridDim.x);
  };
  // the block's tiles: a single adapter's strided by the grid (gridDim.x <=
  // ntiles); with a plan, an even share [t0, t0 + nt) of its tiles, in order
  int64_t t0 = 0;
  int nt = (int)part((M + kResRows - 1) / kResRows - blockIdx.x + gridDim.x - 1, 1);
  if (multi) {
    for (int64_t m0 = 0; m0 < M; m0 += 8 * NT) {
      if (m0 > 0) load_segments(m0);
      // counts into shared memory, one atomic per segment and warp where the
      // warp's rows share a segment or there are few segments, else one per
      // run of a segment in a thread's rows (match_any is slow over many)
      const int first = __shfl_sync(0xffffffffu, sv[0], 0);  // every lane, before any branch
      bool single = sv[0] == first;
#pragma unroll
      for (int u = 1; u < 8; ++u) single &= sv[u] == first;
      if (__all_sync(0xffffffffu, single)) {
        if (lane == 0 && sv[0] >= 0) atomicAdd(cnt_s + sv[0], 8 * 32);
      } else if (A < 32) {
        for (int sg = 0; sg <= A; ++sg) {
          int c = 0;
#pragma unroll
          for (int u = 0; u < 8; ++u) c += sv[u] == sg;
          c = __reduce_add_sync(0xffffffffu, c);
          if (lane == 0 && c) atomicAdd(cnt_s + sg, c);
        }
      } else {
        int run = 1;
#pragma unroll
        for (int u = 1; u <= 8; ++u) {
          if (u < 8 && sv[u] == sv[u - 1]) {
            ++run;
            continue;
          }
          if (sv[u - 1] >= 0) atomicAdd(cnt_s + sv[u - 1], run);
          run = 1;
        }
      }
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scans of rows and tiles over the A + 1 segments
      const int per = (A + 1 + 31) / 32, s0 = lane * per, s1 = min(s0 + per, A + 1);
      int rows = 0, tiles = 0;
      for (int s = s0; s < s1; ++s) {
        rows += cnt_s[s];
        tiles += (cnt_s[s] + kResRows - 1) / kResRows;
      }
      int ri = rows, ti = tiles;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int ru = __shfl_up_sync(0xffffffffu, ri, off), tu = __shfl_up_sync(0xffffffffu, ti, off);
        if (lane >= off) {
          ri += ru;
          ti += tu;
        }
      }
      int rr = ri - rows, tt = ti - tiles;
      for (int s = s0; s < s1; ++s) {
        roff_s[s] = rr;
        toff_s[s] = tt;
        rr += cnt_s[s];
        tt += (cnt_s[s] + kResRows - 1) / kResRows;
      }
      if (lane == 31) {
        roff_s[A + 1] = ri;
        toff_s[A + 1] = ti;
      }
      __syncwarp();
      t0 = part(toff_s[A + 1], blockIdx.x);
      nt = (int)(part(toff_s[A + 1], blockIdx.x + 1) - t0);
      if (lane == 0) {
        sum_s[33] = (int)t0;
        sum_s[34] = nt;
      }
      if (lane == 0 && nt > 0) {  // the pieces, and each tile's row count
        int p = 0;
        for (int64_t t = t0; t < t0 + nt; ++p) {
          int lo = 0, hi = A;  // the last segment that starts at or before tile t holds it
          while (lo < hi) {
            const int mid = (lo + hi + 1) / 2;
            if (toff_s[mid] <= t) lo = mid;
            else hi = mid - 1;
          }
          const int64_t end = min((int64_t)toff_s[lo + 1], t0 + nt);
          ps_s[p] = lo;
          pj_s[p] = (int)(t - t0);
          for (; t < end; ++t) tr_s[t - t0] = min(kResRows, cnt_s[lo] - (int)(t - toff_s[lo]) * kResRows);
        }
        pj_s[p] = nt;
        sum_s[0] = p;
        P = p;
        // the first piece's a is in flight while the rows are listed
        issue_a(0);
      }
    }
    __syncthreads();
    t0 = sum_s[33];
    nt = sum_s[34];
    if (plan_out != nullptr && blockIdx.x == 0)
      for (int i = tid; i < A + 2; i += NT) plan_out[M + i] = roff_s[i];
    if (nt == 0) return;
    P = sum_s[0];
    // each piece's rows in row order, two pieces a pass: a thread counts its
    // rows of each piece in each half of the batch (16 bits a half), a block
    // prefix sum ranks them (with one batch of rows the histogram's segments
    // are still in registers)
    for (int p0 = 0; p0 < P; p0 += 2) {
      int seg[2], lo[2], hi[2], seen[2] = {0, 0};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool here = p0 + q < P;
        seg[q] = here ? ps_s[p0 + q] : -2;
        lo[q] = here ? (int)(t0 + pj_s[p0 + q] - toff_s[seg[q]]) * kResRows : 0;
        hi[q] = here ? min(lo[q] + (pj_s[p0 + q + 1] - pj_s[p0 + q]) * kResRows, cnt_s[seg[q]]) : 0;
      }
      for (int64_t m0 = 0; m0 < M && (seen[0] < hi[0] || seen[1] < hi[1]); m0 += 8 * NT) {
        if (M > 8 * NT) load_segments(m0);
        unsigned bits[2] = {0u, 0u};  // piece q's rows: bit 4 h + u
        int c[2], inc[2];             // their counts, half h in bits 16 h
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int u = 0; u < 8; ++u) bits[q] |= (unsigned)(sv[u] == seg[q]) << u;
          c[q] = __popc(bits[q] & 15u) | __popc(bits[q] >> 4) << 16;
          inc[q] = c[q];
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int v = __shfl_up_sync(0xffffffffu, inc[q], off);
            if (lane >= off) inc[q] += v;
          }
        }
        if (lane == 31) {
          sum_s[1 + 2 * warp] = inc[0];
          sum_s[2 + 2 * warp] = inc[1];
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          int before = 0, total = 0;
#pragma unroll
          for (int w = 0; w < NT / 32; ++w) {
            const int v = sum_s[1 + 2 * w + q];
            total += v;
            before += w < warp ? v : 0;
          }
          const int ex = before + inc[q] - c[q];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // rows before: the earlier pieces' passes, the first half's, then this half's
            int rank = seen[q] + (h ? (total & 0xffff) + (ex >> 16) : ex & 0xffff);
            for (unsigned bq = bits[q] >> (4 * h) & 15u; bq; bq &= bq - 1, ++rank) {
              const int m = (int)(m0 + 4 * ((int64_t)h * NT + tid)) + __ffs(bq) - 1;
              if (rank >= lo[q] && rank < hi[q]) {
                list_s[(pj_s[p0 + q] * kResRows) + rank - lo[q]] = m;
                if (plan_out != nullptr) plan_out[roff_s[seg[q]] + rank] = m;
              }
            }
          }
          seen[q] += (total & 0xffff) + (total >> 16);
        }
        __syncthreads();  // the sums read; the last pass's lists visible
      }
    }
  } else if (nt == 0) {
    return;
  }
  // the first tile of piece p (nt past the last); the first of segment A's tiles
  auto piece_start = [&](int p) { return multi ? pj_s[p] : (p == 0 ? 0 : nt); };
  const int zj = multi && ps_s[P - 1] == A ? pj_s[P - 1] : nt;
  auto tile_of = [&](int j) { return blockIdx.x + (int64_t)j * gridDim.x; };  // a single adapter's
  auto rows_of = [&](int j) {
    return multi ? tr_s[j] : (int)min((int64_t)kResRows, M - tile_of(j) * kResRows);
  };
  auto row_of = [&](int j, int i) -> int64_t {
    return multi ? (int64_t)list_s[j * kResRows + i] : tile_of(j) * kResRows + i;
  };

  // Team t takes the block's tiles j with j % TEAMS == t, its k-th into its
  // ring stage k % stages. With 16-byte rows, the team's first warp copies
  // them (lane i row i, as bulk copies that the stage's mbarrier counts), so
  // no thread waits on a copy it issued; otherwise the team's threads copy
  // elements, synchronously. Segment A's tiles (the last) are not copied.
  auto issue = [&](int k) {
    const int j = k * TEAMS + team;
    if (j >= zj) return;
    T* dst = ring + (k % stages) * kResRows * KX;
    const int rows = rows_of(j);
    if (x_vec) {
      if (twarp == 0) {
        if (lane == 0) {
          fence_async();  // after this stage's last reads
          mbar_expect_tx(tbars + k % stages, rows * K * (int)sizeof(T));
        }
        __syncwarp();
        if (lane < rows)
          bulk_copy(dst + lane * KX, x + row_of(j, lane) * K, K * (int)sizeof(T), tbars + k % stages);
      }
    } else {
      for (int e = ttid; e < kResRows * KX; e += kTeamThreads) {
        const int row = e / KX, c = e % KX;
        dst[row * KX + c] = (row < rows && c < K) ? x[row_of(j, row) * K + c] : from_f32<T>(0.0f);
      }
    }
  };
  // What piece p's products read, by the whole block: b's columns and the
  // mask where the bulk copies cannot take them, and a into the layout
  // phase 1 reads, 16-byte pieces (c, h, p), from a_tmp once it has landed.
  auto stage = [&](int p) {
    const int64_t ad = adapter(p);
    if (!b_vec && !packed)
      for (int e = tid; e < r * N; e += NT) b_s[e / N * NB + e % N] = b[ad * r * N + e];
    if (!b_vec || packed)
      for (int n = tid; n < N; n += NT) mask_s[n] = mask[ad * N + n];
    if (a_vec) mbar_wait(a_bar, p & 1);
    const float* ap = a + ad * K * r;
    for (int e = tid; e < RP / 4 * KP; e += NT) {
      const int c = e / KP, k = e % KP;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K && 4 * c < r) {
        if (a_vec) {
          v = *reinterpret_cast<const float4*>(a_tmp + k * r + 4 * c);
        } else {
          const float* src = ap + (int64_t)k * r + 4 * c;
          v = make_float4(src[0], 4 * c + 1 < r ? src[1] : 0.f, 4 * c + 2 < r ? src[2] : 0.f,
                          4 * c + 3 < r ? src[3] : 0.f);
        }
      }
      a_s[(2 * c + (k & 1)) * KP2 + (k >> 1)] = v;
    }
    __syncthreads();  // a_s, the element copies visible to both teams; a_tmp read
    if (warp == 0) {
      if (b_vec && !packed) issue_b(p);
      if (lane == 0) issue_a(p + 1);  // in flight while this piece runs
    }
  };
  // From piece p - 1 to piece p, by the whole block: once every read of the
  // last adapter is done, the next one's. Segment A's piece stages nothing.
  auto restage = [&](int p) {
    if (adapter(p) == A) return;
    __syncthreads();
    stage(p);
  };

  // Piece 0: what the first products need comes first: a and the first
  // team's first tiles; b, the mask and the other team's tiles once a has
  // landed. b's rows past r and columns past N, and the mask past N, are 0
  // for every piece.
  if (adapter(0) != A) {
    if (tid == 0 && !multi) issue_a(0);
    if (team == 0)
      for (int k = 0; k < stages - 1; ++k) issue(k);
    for (int e = tid; e < RP * NB; e += NT) {
      const int rr = e / NB, n = e % NB;
      if (rr >= r || n >= N) b_s[e] = 0.f;
    }
    for (int n = N + tid; n < NB; n += NT) mask_s[n] = 0.f;
    stage(0);
    if (TEAMS == 2 && team == 1)
      for (int k = 0; k < stages - 1; ++k) issue(k);
    if (packed && team == TEAMS - 1) {
      // b's kept columns only (0 in the frozen ones), 4 columns of every row
      // a thread with their loads all in flight, while the first team
      // multiplies its first tile
      for (int n0 = ttid; n0 < N; n0 += 4 * kTeamThreads) {
        float v[4][RP];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n0 + c * kTeamThreads;
          const bool kept = n < N && mask_s[n] != 0.f;
#pragma unroll
          for (int rr = 0; rr < RP; ++rr) v[c][rr] = kept && rr < r ? b[(int64_t)rr * N + n] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n0 + c * kTeamThreads;
#pragma unroll
          for (int rr = 0; rr < RP; ++rr)
            if (n < N && rr < r) b_s[rr * NB + n] = v[c][rr];
        }
      }
      mbar_arrive(b_bar);
    }
  }

  // phase 1's lanes: warp (rg, kw) of the team owns rows 8 rg .. 8 rg + 7
  // and pairs of k p = kp + 8 (kw + kKSplit j); lane (rq, kp) rows 8 rg + 2 rq and + 1
  const int rg = twarp / kKSplit, kw = twarp % kKSplit, rq = lane >> 3, kp = lane & 7;
  const int RL = NG >= kTeamThreads ? 1 : kTeamThreads / NG;
  int pc = 0;       // the piece staged
  int b_seen = -1;  // the last piece whose b this team waited for
  for (int k = 0;; ++k) {
    const int j = k * TEAMS + team;
    if (j >= nt) break;
    while (j >= piece_start(pc + 1)) restage(++pc);
    if (j >= zj) {  // segment A: zero rows
      const int rows = rows_of(j);
      if (y_vec) {
        const int per = N * (int)sizeof(T) / 16;
        for (int e = ttid; e < rows * per; e += kTeamThreads)
          reinterpret_cast<uint4*>(y + row_of(j, e / per) * N)[e % per] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (int e = ttid; e < rows * N; e += kTeamThreads) y[row_of(j, e / N) * N + e % N] = from_f32<T>(0.f);
      }
      continue;
    }
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
    if (b_seen != pc && (b_vec || packed)) {
      mbar_wait(b_bar, pc & 1);
      b_seen = pc;
    }
    team_sync(team);

    // y = scale · xa @ (b ⊙ mask): 8 columns of RL-strided rows per item
    const int rows = rows_of(j);
    for (int item = ttid; item < NG * RL; item += kTeamThreads) {
      const int g = item % NG, rl = item / NG;
      float bm[RP][8];
      const float4 mlo = reinterpret_cast<const float4*>(mask_s)[2 * g];
      const float4 mhi = reinterpret_cast<const float4*>(mask_s)[2 * g + 1];
      const float mv[8] = {mlo.x, mlo.y, mlo.z, mlo.w, mhi.x, mhi.y, mhi.z, mhi.w};
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        const float4 lo = reinterpret_cast<const float4*>(b_s + rr * NB)[2 * g];
        const float4 hi = reinterpret_cast<const float4*>(b_s + rr * NB)[2 * g + 1];
        const float bv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) bm[rr][q] = packed ? bv[q] : bv[q] * mv[q];
      }
      const int n0 = 8 * g;
      const bool full = y_vec && n0 + 8 <= N;
      // two rows at a time, 16 independent sums (a row past the tile's rows
      // is computed and not stored)
      for (int row = rl; row < rows; row += 2 * RL) {
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
          if (rw >= rows) break;
#pragma unroll
          for (int q = 0; q < 8; ++q) out[h][q] = packed && mv[q] == 0.f ? 0.f : scale * out[h][q];
          T* yp = y + row_of(j, rw) * N + n0;
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
  while (pc + 1 < P) restage(++pc);  // the boundaries the other team still passes
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

// Ring stages per team of the resident kernel for these widths (1..kResMaxStages
// / teams), or 0 when a, b ⊙ mask, the plan (A > 0 adapters) and a team's tile
// do not fit one block's shared memory.
int team_stages(int64_t K, int64_t N, int r, int size, int A) {
  if (r > kResMaxRank || K < 1 || K > (1 << 24) || N > (1 << 24)) return 0;
  const int RP = rank_pad(r);
  const ResLayout lay(K, N, r, RP, size, A);
  const int64_t room = device_info().smem_optin;
  const int64_t stages = (room - lay.ring - lay.plan_bytes) / ((int64_t)res_teams(RP) * lay.tile);
  const int64_t most = kResMaxStages / res_teams(RP);
  return (int)(stages < 1 ? 0 : stages < most ? stages : most);
}

// The multi-adapter product's stages on the SGMV path, or 0 for the L2 kernel:
// at most kMaxSgmvAdapters adapters, and at least a tile's rows per adapter.
int sgmv_stages(int64_t M, int64_t K, int64_t N, int r, int A, int size) {
  if (A < 1 || A > kMaxSgmvAdapters || M > 2147483647LL || M < (int64_t)kResRows * A) return 0;
  return team_stages(K, N, r, size, A);
}

template <typename T, int RP, int MODE>
int launch_resident(void* y, const void* x, const int* idx, const float* a, const float* b, const float* mask,
                    int* plan, int64_t M, int64_t K, int64_t N, int r, int A, float scale, int stages,
                    cudaStream_t stream) {
  const ResLayout lay(K, N, r, RP, (int)sizeof(T), idx ? A : 0);
  const int bytes = lay.bytes(RP, stages);
  // the attribute and the occupancy query only when the shared memory changes
  static int opted_in = 0, last_bytes = -1, per_sm = 0;
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(sparse_lora_resident_kernel<T, RP, MODE>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  if (bytes != last_bytes) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sparse_lora_resident_kernel<T, RP, MODE>, kTeamThreads * res_teams(RP), bytes);
    if (err != cudaSuccess) return (int)err;
    last_bytes = bytes;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // the most tiles the plan can make: each segment ends in at most one partial tile
  const int64_t ntiles = (M + kResRows - 1) / kResRows + (idx ? A + 1 : 0);
  const int64_t resident = (int64_t)per_sm * device_info().sms;
  int64_t blocks = ntiles < resident ? ntiles : resident;
  const int64_t listed = (ntiles + kListTiles - 1) / kListTiles;  // a planning block lists its rows
  if (idx && blocks < listed) blocks = listed;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool x_vec = (K * (int64_t)sizeof(T)) % 16 == 0 && aligned(x, 16);
  const bool a_vec = r % 4 == 0 && aligned(a, 16);  // K r 4 bytes: a multiple of 16
  const bool b_vec = N % 4 == 0 && aligned(b, 16) && aligned(mask, 16);
  const bool y_vec = (N * (int64_t)sizeof(T)) % 16 == 0 && aligned(y, 16);
  sparse_lora_resident_kernel<T, RP, MODE><<<(unsigned)blocks, kTeamThreads * res_teams(RP), bytes, stream>>>(
      (T*)y, (const T*)x, idx, a, b, mask, plan, M, (int)K, (int)N, r, A, scale, stages, x_vec, a_vec, b_vec,
      y_vec);
  return (int)cudaGetLastError();
}

// ---- few rows, many adapters: the decode shape, spread over the card ----

constexpr int kFewMaxRows = 64;     // the largest M this path takes
constexpr int kFewThreads = 256;
constexpr int kFewMaxSplits = 64;   // K-splits of the first phase at most

int few_rank_pad(int r) { return r <= 4 ? 4 : r <= 8 ? 8 : r <= 16 ? 16 : r <= 32 ? 32 : 64; }

// Programmatic dependent launch (sm_90): the first phase lets the second be
// scheduled at once; the second runs what needs only the inputs, then waits
// for the whole first grid and its writes.
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// The first phase's K-split: kc values of k a block (a multiple of the k
// lanes of a warp, 128 / RP), at most kFewMaxSplits blocks.
int64_t few_split_k(int64_t K, int RP) {
  const int64_t kl = 128 / RP;
  const int64_t steps = (K + kl - 1) / kl;
  const int64_t per = (steps + kFewMaxSplits - 1) / kFewMaxSplits;
  return (per < 1 ? 1 : per) * kl;
}
int few_splits(int64_t K, int RP) {
  const int64_t kc = few_split_k(K, RP);
  const int64_t s = (K + kc - 1) / kc;
  return (int)(s < 1 ? 1 : s);
}

// Phase 1: part[s][m][0..RP) = x[m, ks] @ a[idx[m], ks, :] over block s's
// slice ks of K, in f32 (0 for a row out of range and rank entries >= r).
// Warp w takes rows w, w + 8, ...; lane (kl, q) the k's kl, kl + KL, ... of
// the slice and rank entries [4q, 4q + 4): a warp reads 32 16-byte pieces
// of a, contiguous; a shuffle sum over the KL lanes that share q leaves the
// row's partial.
template <typename T, int RP>
__global__ void __launch_bounds__(kFewThreads)
    sparse_lora_few_rows_xa_kernel(float* __restrict__ part, const T* __restrict__ x,
                                   const int* __restrict__ idx, const float* __restrict__ a, int M, int64_t K,
                                   int r, int A, int64_t kc, bool a_vec) {
  pdl_trigger();
  constexpr int Q = RP / 4, KL = 32 / Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane % Q, kl = lane / Q;
  const int64_t k0 = (int64_t)blockIdx.x * kc, k1 = K < k0 + kc ? K : k0 + kc;
  for (int m = warp; m < M; m += kFewThreads / 32) {  // warp-uniform
    const int v = idx[m];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (v >= 0 && v < A) {
      const float* ap = a + (int64_t)v * K * r + 4 * q;
      const T* xp = x + (int64_t)m * K;
#pragma unroll 4
      for (int64_t k = k0 + kl; k < k1; k += KL) {
        const float xv = to_f32(xp[k]);
        float av[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (a_vec) {
          if (4 * q < r) {
            const float4 t = *reinterpret_cast<const float4*>(ap + k * r);
            av[0] = t.x; av[1] = t.y; av[2] = t.z; av[3] = t.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) av[c] = 4 * q + c < r ? ap[k * r + c] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(xv, av[c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int off = Q; off < 32; off <<= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    if (kl == 0)
      *reinterpret_cast<float4*>(part + ((int64_t)blockIdx.x * M + m) * RP + 4 * q) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// four neighbouring values of y in one store (16 bytes f32, 8 bf16)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Phase 2: y[m, n] = scale · xa[m] @ (b ⊙ mask)[idx[m], :, n]. An item is
// (d, g): the d-th distinct adapter of the rows (in order of its first
// row) and CW neighbouring columns from g·CW; item i of the grid is
// (i / groups, i % groups), so a block covers one or two adapters of a
// wide N. Before its wait a thread lists the adapters and loads its
// item's b ⊙ mask (rows that share an adapter read it once), while the
// first phase runs. After it, the block sums the partials of its
// adapters' rows (a warp a (row, rank quad), its lanes over the splits,
// then a shuffle sum: a fixed order), and each thread writes its columns
// of those rows; items of the first adapter also write the zero rows of
// indices out of range.
template <typename T, int RP, int CW>
__global__ void __launch_bounds__(kFewThreads)
    sparse_lora_few_rows_y_kernel(T* __restrict__ y, const float* __restrict__ part,
                                  const int* __restrict__ idx, const float* __restrict__ b,
                                  const float* __restrict__ mask, int M, int64_t N, int r, int A, int splits,
                                  float scale, bool vec) {
  constexpr int RQ = RP / 4;
  __shared__ int ad_s[kFewMaxRows];    // a row's adapter, -1 out of range
  __shared__ int dist_s[kFewMaxRows];  // the distinct adapters
  __shared__ int rowd_s[kFewMaxRows];  // a row's place in dist_s, -1 out of range
  __shared__ int nd_s;
  __shared__ __align__(16) float xa_s[kFewMaxRows][RP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < M) {
    const int v = idx[tid];
    ad_s[tid] = (v >= 0 && v < A) ? v : -1;
  }
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int c = 0; c < kFewMaxRows; c += 32) {  // warp-uniform; the ballot outside any condition
      const int m = c + lane;
      int ad = -1;
      bool first = false;
      if (m < M) {
        ad = ad_s[m];
        first = ad >= 0;
        for (int j = 0; j < m && first; ++j) first = ad_s[j] != ad;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, first);
      if (first) dist_s[base + __popc(bal & ((1u << lane) - 1u))] = ad;
      base += __popc(bal);
    }
    if (lane == 0) nd_s = base;
  }
  __syncthreads();
  const int nd = nd_s;
  if (tid < M) {
    int d = -1;
    for (int j = 0; j < nd && d < 0; ++j)
      if (dist_s[j] == ad_s[tid]) d = j;
    rowd_s[tid] = d;
  }
  const int64_t groups = (N + CW - 1) / CW;
  const int64_t item = (int64_t)blockIdx.x * kFewThreads + tid;
  const int d = (int)(item / groups);
  const int64_t n0 = (item % groups) * CW;
  const bool live = d < nd;
  float bm[RP][CW];
#pragma unroll
  for (int rr = 0; rr < RP; ++rr)
#pragma unroll
    for (int c = 0; c < CW; ++c) bm[rr][c] = 0.0f;
  if (live) {
    const int ad = dist_s[d];
    const float* bp = b + (int64_t)ad * r * N + n0;
    const float* mp = mask + (int64_t)ad * N + n0;
    bool done = false;
    if constexpr (CW == 4) {
      if (vec) {
        const float4 mk = *reinterpret_cast<const float4*>(mp);
#pragma unroll
        for (int rr = 0; rr < RP; ++rr) {
          if (rr < r) {
            const float4 t = *reinterpret_cast<const float4*>(bp + (int64_t)rr * N);
            bm[rr][0] = t.x * mk.x;
            bm[rr][1] = t.y * mk.y;
            bm[rr][2] = t.z * mk.z;
            bm[rr][3] = t.w * mk.w;
          }
        }
        done = true;
      }
    }
    if (!done) {
      float mk[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) mk[c] = n0 + c < N ? mp[c] : 0.0f;
#pragma unroll
      for (int rr = 0; rr < RP; ++rr)
#pragma unroll
        for (int c = 0; c < CW; ++c)
          if (rr < r && n0 + c < N) bm[rr][c] = bp[(int64_t)rr * N + c] * mk[c];
    }
  }
  pdl_wait();  // the first phase's partials have landed
  __syncthreads();  // rowd_s

  const int64_t first_item = (int64_t)blockIdx.x * kFewThreads;
  const int d_lo = (int)(first_item / groups);
  const int d_hi = (int)((first_item + kFewThreads - 1) / groups);
  for (int e = warp; e < M * RQ; e += kFewThreads / 32) {  // warp-uniform
    const int m = e / RQ, qq = e % RQ;
    const int rd = rowd_s[m];
    if (rd < d_lo || rd > d_hi) continue;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = lane; s < splits; s += 32) {
      const float4 t = *reinterpret_cast<const float4*>(part + ((int64_t)s * M + m) * RP + 4 * qq);
      sum.x += t.x; sum.y += t.y; sum.z += t.z; sum.w += t.w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum.x += __shfl_xor_sync(0xffffffffu, sum.x, off);
      sum.y += __shfl_xor_sync(0xffffffffu, sum.y, off);
      sum.z += __shfl_xor_sync(0xffffffffu, sum.z, off);
      sum.w += __shfl_xor_sync(0xffffffffu, sum.w, off);
    }
    if (lane == 0) *reinterpret_cast<float4*>(&xa_s[m][4 * qq]) = sum;
  }
  __syncthreads();

  if (d >= (nd > 0 ? nd : 1)) return;
  for (int m = 0; m < M; ++m) {
    const int rd = rowd_s[m];
    if (rd != d && !(rd < 0 && d == 0)) continue;
    float out[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      float s = 0.0f;
      if (rd >= 0) {
#pragma unroll
        for (int rr = 0; rr < RP; ++rr) s = fmaf(xa_s[m][rr], bm[rr][c], s);
        s *= scale;
      }
      out[c] = s;
    }
    T* yp = y + (int64_t)m * N + n0;
    bool stored = false;
    if constexpr (CW == 4) {
      if (vec) {
        store4(yp, out);
        stored = true;
      }
    }
    if (!stored) {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (n0 + c < N) yp[c] = from_f32<T>(out[c]);
    }
  }
}

template <typename T, int RP>
int launch_few_rank(void* y, const void* x, const int* idx, const float* a, const float* b, const float* mask,
                    float* part, int M, int64_t K, int64_t N, int r, int A, float scale, cudaStream_t stream) {
  constexpr int CW = RP <= 16 ? 4 : 1;  // columns a thread owns: b ⊙ mask stays in RP·CW registers
  const int64_t kc = few_split_k(K, RP);
  const int splits = few_splits(K, RP);
  const bool a_vec = r % 4 == 0 && aligned(a, 16);
  const bool vec = N % 4 == 0 && aligned(b, 16) && aligned(mask, 16) && aligned(y, 4 * sizeof(T));
  sparse_lora_few_rows_xa_kernel<T, RP><<<(unsigned)splits, kFewThreads, 0, stream>>>(part, (const T*)x, idx, a,
                                                                                      M, K, r, A, kc, a_vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t groups = (N + CW - 1) / CW;
  const int64_t items = (int64_t)(M < A ? M : A) * groups;
  const int64_t blocks = (items + kFewThreads - 1) / kFewThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kFewThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sparse_lora_few_rows_y_kernel<T, RP, CW>, (T*)y, (const float*)part, idx, b,
                           mask, M, N, r, A, splits, scale, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_few(void* y, const void* x, const int* idx, const float* a, const float* b, const float* mask,
               float* part, int M, int64_t K, int64_t N, int r, int A, float scale, cudaStream_t stream) {
#define REPRO_FEW(RP) \
  return launch_few_rank<T, RP>(y, x, idx, a, b, mask, part, M, K, N, r, A, scale, stream)
  switch (few_rank_pad(r)) {
    case 4: REPRO_FEW(4);
    case 8: REPRO_FEW(8);
    case 16: REPRO_FEW(16);
    case 32: REPRO_FEW(32);
    default: REPRO_FEW(64);
  }
#undef REPRO_FEW
}

// ---- many rows, widths that do not stage: the split path ----

constexpr int kSplitThreads = 256;
constexpr int kSplitMaxSplits = 8;  // K-slices of the shrink at most
constexpr int kSplitStages = 3;     // the shrink's ring of a's steps (two at ranks above 16)
constexpr int kSplitXaBlocks = 4;   // the shrink's grid: about this many blocks an SM
constexpr int kSplitYBlocks = 4;    // the expand's grid: likewise
constexpr int kSplitGroup = 8;      // rows an expand warp takes at a time (fewer above rank 8)

// columns an expand thread owns: their b ⊙ mask stays in RP·CW <= 64 registers
__host__ __device__ constexpr int split_cw(int RP) { return RP <= 8 ? 8 : 64 / RP; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows a shrink warp sums: RW x RP f32 accumulators a lane, 32 (64 at rank 64)
__host__ __device__ constexpr int split_rw(int RP) { return RP >= 32 ? 1 : 32 / RP; }
// k values of a shrink step: a lane's 16 bytes of each of its rows
__host__ __device__ constexpr int split_ks(int size) { return 32 * (16 / size); }
// ring stages of a: a step's a is RP x KS f32, 8 KB at rank 8 and bf16
__host__ __device__ constexpr int split_stages(int RP) { return RP >= 32 ? 2 : kSplitStages; }

// The shrink's K-slice: whole steps, as few slices as give about
// kSplitXaBlocks blocks an SM over the row tiles, at most kSplitMaxSplits.
int64_t split_slice(int64_t M, int64_t K, int RP, int size) {
  const int64_t KS = split_ks(size);
  const int64_t steps = K > 0 ? (K + KS - 1) / KS : 1;
  const int64_t tiles = (M + 8 * split_rw(RP) - 1) / (8 * split_rw(RP));
  const int64_t want = (kSplitXaBlocks * (int64_t)device_info().sms + tiles - 1) / tiles;
  const int64_t most = steps < kSplitMaxSplits ? steps : kSplitMaxSplits;
  const int64_t s = want < 1 ? 1 : want > most ? most : want;
  return (steps + s - 1) / s * KS;
}
int split_count(int64_t M, int64_t K, int RP, int size) {
  const int64_t kc = split_slice(M, K, RP, size);
  const int64_t s = (K + kc - 1) / kc;
  return (int)(s < 1 ? 1 : s);
}
// The expand's rows a block: a multiple of its warps' groups, so that the
// grid holds about kSplitYBlocks blocks an SM.
__host__ __device__ constexpr int split_group(int RP) {
  return RP >= 64 ? 1 : 64 / RP < kSplitGroup ? 64 / RP : kSplitGroup;
}
int64_t split_rows(int64_t M, int64_t N, int RP) {
  const int64_t cols = (N + 32 * split_cw(RP) - 1) / (32 * split_cw(RP));
  const int64_t want = (kSplitYBlocks * (int64_t)device_info().sms + cols - 1) / cols;
  const int64_t chunks = want < 1 ? 1 : want;
  const int64_t unit = (kSplitThreads / 32) * split_group(RP);
  const int64_t rows = (M + chunks - 1) / chunks;
  return (rows + unit - 1) / unit * unit;
}

// 16 bytes of row p from k (VX values of T), or zeros where the row is not
// read; element by element where vec does not hold
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int64_t k, int64_t k_hi, bool live, bool vec) {
  constexpr int VX = 16 / sizeof(T);
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (!live || k >= k_hi) return u;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + k));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < VX; ++i) {
    if (k + i >= k_hi) break;
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(to_f32(p[k + i]));
    } else {
      w[i >> 1] |= (uint32_t)__bfloat16_as_ushort(p[k + i]) << (16 * (i & 1));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
// value i of those 16 bytes, in f32
template <typename T>
__device__ __forceinline__ float value16(const uint4& u, int i) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[i]);
  } else {
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
  }
}

// Shrink: part[s][m][0..RP) = x[m, ks] @ a[idx[m], ks, :] over block
// (t, s)'s 8·RW rows from 8·RW·t and K-slice ks = [s·kc, (s + 1)·kc), in
// f32. Warp w owns rows 8·RW·t + RW·w .. + RW; a step covers KS = 32·VX
// k's, lane l the VX = 16 / size neighbouring k's from VX·l, read from
// device memory with one 16-byte load a row (element by element where K or
// x do not allow it) two steps ahead of their use, straight into registers.
// a is staged a step at a time in shared memory for the tile's first
// adapter, by cp.async copies through a ring of split_stages(RP), laid out
// [quad][i][lane] so that lane l's value i is contiguous across the warp;
// another adapter in the tile (a mixed tile) is staged in its turn, and
// each pass sums only its own rows. Each staged a value serves RW rows, and
// a lane's RW·RP sums go, after the slice, through a reduce-scatter over
// the warp's lanes (a fixed order) into the partials. Rows out of range are
// neither read nor written.
template <typename T, int RP>
__global__ void __launch_bounds__(kSplitThreads, 2)
    sparse_lora_split_xa_kernel(float* __restrict__ part, const T* __restrict__ x, const int* __restrict__ idx,
                                const float* __restrict__ a, int64_t M, int64_t K, int r, int A, int64_t kc,
                                int splits, bool x_vec, bool a_vec) {
  pdl_trigger();
  constexpr int VX = 16 / sizeof(T);
  constexpr int KS = split_ks(sizeof(T));
  constexpr int NQ = RP / 4;  // rank quads
  constexpr int RW = split_rw(RP);
  constexpr int ROWS = 8 * RW;
  constexpr int S = split_stages(RP);
  constexpr int V = RW * RP;  // a lane's sums
  extern __shared__ __align__(16) unsigned char split_smem[];
  float4* as = reinterpret_cast<float4*>(split_smem);  // [S][NQ][VX][32]
  __shared__ int ad_s[ROWS], dist_s[ROWS];
  __shared__ int nd_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tile = blockIdx.x / splits;  // a tile's slices on neighbouring blocks
  const int slice = (int)(blockIdx.x % splits);
  const int64_t m0 = tile * ROWS;
  const int64_t k_lo = (int64_t)slice * kc, k_hi = K < k_lo + kc ? K : k_lo + kc;
  if (tid < ROWS) {
    const int64_t m = m0 + tid;
    int ad = -1;
    if (m < M) {
      const int v = idx[m];
      ad = (v >= 0 && v < A) ? v : -1;
    }
    ad_s[tid] = ad;
  }
  __syncthreads();
  if (warp == 0) {  // the distinct adapters, in order of their first row
    int base = 0;
    for (int c = 0; c < ROWS; c += 32) {  // warp-uniform; the ballot outside any condition
      bool first = false;
      int ad = -1;
      if (c + lane < ROWS) {
        ad = ad_s[c + lane];
        first = ad >= 0;
        for (int j = 0; j < c + lane && first; ++j) first = ad_s[j] != ad;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, first);
      if (first) dist_s[base + __popc(bal & ((1u << lane) - 1u))] = ad;
      base += __popc(bal);
    }
    if (lane == 0) nd_s = base;
  }
  __syncthreads();
  const int nd = nd_s;
  if (nd == 0) return;  // every row out of range: the expand reads no partial of them

  // a[ad] at k0..k0+KS into stage s: element (q, i, l) is a[k0 + VX·l + i]'s
  // quad q; ranks >= r and k's past the slice are zeros (x there is 0, but
  // 0 · garbage could be NaN)
  auto load_a = [&](int ad, int64_t k0, int s, bool async) {
    float4* dst = as + s * NQ * VX * 32;
    const float* ap = a + (int64_t)ad * K * r;
    for (int e = tid; e < KS * NQ; e += kSplitThreads) {
      const int kk = e / NQ, q = e % NQ;
      const int64_t k = k0 + kk;
      float4* d = dst + (q * VX + kk % VX) * 32 + kk / VX;
      if (a_vec) {
        const bool ok = 4 * q < r && k < k_hi;
        if (async)
          cp_async16(d, ok ? ap + k * r + 4 * q : a, ok ? 16 : 0);
        else
          *d = ok ? *reinterpret_cast<const float4*>(ap + k * r + 4 * q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = k < k_hi && 4 * q + c < r ? ap[k * r + 4 * q + c] : 0.0f;
        *d = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  int my_ad[RW];
  const T* xp[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    my_ad[j] = ad_s[RW * warp + j];
    xp[j] = x + (m0 + RW * warp + j) * K;  // read only where the row is in range
  }
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;

  const int64_t steps = k_hi > k_lo ? (k_hi - k_lo + KS - 1) / KS : 0;
  const int64_t kl = (int64_t)VX * lane;
  uint4 x0[RW], x1[RW];  // this step's and the next one's 16 bytes a row
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    x0[j] = load16(xp[j], k_lo + kl, k_hi, my_ad[j] >= 0, x_vec);
    x1[j] = load16(xp[j], k_lo + KS + kl, k_hi, my_ad[j] >= 0, x_vec);
  }
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {  // the ring's first steps of a in flight
    if (p < steps) load_a(dist_s[0], k_lo + (int64_t)p * KS, p, true);
    cp_async_commit();
  }
  for (int64_t c = 0; c < steps; ++c) {
    const int s = (int)(c % S);
    const int64_t k0 = k_lo + c * KS;
    cp_async_wait<S - 2>();  // step c's a has landed
    __syncthreads();         // ... for every thread, and step c - 1's stage is read
    if (c + S - 1 < steps) load_a(dist_s[0], k0 + (int64_t)(S - 1) * KS, (int)((c + S - 1) % S), true);
    cp_async_commit();
    uint4 xc[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) {  // step c + 2's rows in flight while step c is multiplied
      xc[j] = x0[j];
      x0[j] = x1[j];
      x1[j] = load16(xp[j], k0 + 2 * KS + kl, k_hi, my_ad[j] >= 0, x_vec);
    }
    const float4* aq = as + s * NQ * VX * 32 + lane;
    for (int d = 0; d < nd; ++d) {  // block-uniform
      if (d > 0) {  // a mixed tile: the next adapter's a over this step
        __syncthreads();
        load_a(dist_s[d], k0, s, false);
        __syncthreads();
      }
      const int ad = dist_s[d];
      bool use[RW], any = false;
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        use[j] = my_ad[j] == ad;
        any = any || use[j];
      }
      if (!any) continue;
#pragma unroll
      for (int i = 0; i < VX; ++i) {
        float xv[RW];
#pragma unroll
        for (int j = 0; j < RW; ++j) xv[j] = use[j] ? value16<T>(xc[j], i) : 0.0f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 t = aq[(q * VX + i) * 32];
#pragma unroll
          for (int j = 0; j < RW; ++j) {
            acc[j * RP + 4 * q] = fmaf(xv[j], t.x, acc[j * RP + 4 * q]);
            acc[j * RP + 4 * q + 1] = fmaf(xv[j], t.y, acc[j * RP + 4 * q + 1]);
            acc[j * RP + 4 * q + 2] = fmaf(xv[j], t.z, acc[j * RP + 4 * q + 2]);
            acc[j * RP + 4 * q + 3] = fmaf(xv[j], t.w, acc[j * RP + 4 * q + 3]);
          }
        }
      }
    }
  }

  // the warp's lanes summed (a reduce-scatter, a fixed order): lane l then
  // holds entries [P·l, P·l + P) of its rows x ranks
  reduce_half<V / 2>(acc, lane, 16);
  reduce_half<V / 4>(acc, lane, 8);
  reduce_half<V / 8>(acc, lane, 4);
  reduce_half<V / 16>(acc, lane, 2);
  reduce_half<V / 32>(acc, lane, 1);
  constexpr int P = V / 32;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int e = P * lane + p, j = e / RP, q = e % RP;
    if (ad_s[RW * warp + j] >= 0) part[((int64_t)slice * M + m0 + RW * warp + j) * RP + q] = acc[p];
  }
}

// CW neighbouring values of y from column n: one or two 16-byte stores
// (fewer bytes where CW·size is less) where vec and the columns lie below
// N, else one value at a time
template <int CW, typename T>
__device__ __forceinline__ void store_cols(T* p, const float (&v)[CW], int64_t n, int64_t N, bool vec) {
  if (vec && n + CW <= N) {
    if constexpr (CW == 8) {
      store8(p, v);
      return;
    } else if constexpr (CW == 4) {
      store4(p, v);
      return;
    } else if constexpr (CW == 2) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < CW; ++c)
    if (n + c < N) p[c] = from_f32<T>(v[c]);
}

// Expand: y = scale · xa @ (b ⊙ mask) over blocks of `rows` rows and
// CT = 32·CW columns (a row chunk's column tiles on neighbouring blocks);
// thread `lane` of every warp owns CW neighbouring columns and holds their
// b ⊙ mask for one adapter in registers. Launched with programmatic stream
// serialization: before its wait a block stages its column tile of b and
// the mask for the adapter of its first row (RP x CT f32, 8 KB at rank 8)
// in shared memory and each warp takes its copy into registers, while the
// shrink runs. After it, each warp takes groups of G = split_group(RP)
// rows (warp w the groups w, w + 8, ... of the block), with no barrier of
// the block: the group's xa, each row's partials summed over the K-slices
// in order (a lane a (row, rank)), goes through the warp's slice of shared
// memory, the next group's partials already loading; then each row is
// written with one 16-byte store a thread (bf16, CW 8). A row whose adapter differs from the one in registers (a mixed
// tile, or a slot boundary) loads that adapter's columns from L2 first; a
// row out of range is written as zeros. A row's sums do not depend on its
// block, so the result is the same for every launch of these inputs.
template <typename T, int RP>
__global__ void __launch_bounds__(kSplitThreads)
    sparse_lora_split_y_kernel(T* __restrict__ y, const float* __restrict__ part, const int* __restrict__ idx,
                               const float* __restrict__ b, const float* __restrict__ mask, int64_t M, int64_t N,
                               int r, int A, int splits, int64_t rows, int64_t col_blocks, float scale, bool b_vec,
                               bool y_vec) {
  constexpr int CW = split_cw(RP);
  constexpr int CT = 32 * CW;
  constexpr int G = split_group(RP);
  __shared__ __align__(16) float b_s[RP][CT];
  __shared__ __align__(16) float m_s[CT];
  __shared__ __align__(16) float xa_s[kSplitThreads / 32][G][RP];
  __shared__ int first_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t chunk = blockIdx.x / col_blocks, col = blockIdx.x % col_blocks;
  const int64_t r_lo = chunk * rows, r_hi = M < r_lo + rows ? M : r_lo + rows;
  const int64_t n0 = col * CT, n = n0 + (int64_t)lane * CW;

  float bm[RP][CW];
  int cur = -1;  // the adapter whose b ⊙ mask the registers hold
  // this thread's columns of b[ad] ⊙ mask[ad], from L2
  auto load_bm = [&](int ad) {
    const float* bp = b + (int64_t)ad * r * N + n;
    const float* mp = mask + (int64_t)ad * N + n;
#pragma unroll
    for (int c4 = 0; c4 < (CW + 3) / 4; ++c4) {
      constexpr int V = CW < 4 ? CW : 4;
      float mk[V], bv[RP][V];
      if (b_vec && CW >= 4 && n + 4 * c4 + 4 <= N) {
        const float4 t = *reinterpret_cast<const float4*>(mp + 4 * c4);
        const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int c = 0; c < V; ++c) mk[c] = tv[c];
#pragma unroll
        for (int rr = 0; rr < RP; ++rr) {
          float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (rr < r) u = *reinterpret_cast<const float4*>(bp + (int64_t)rr * N + 4 * c4);
          const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int c = 0; c < V; ++c) bv[rr][c] = uv[c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const bool in = n + 4 * c4 + c < N;
          mk[c] = in ? mp[4 * c4 + c] : 0.0f;
#pragma unroll
          for (int rr = 0; rr < RP; ++rr) bv[rr][c] = in && rr < r ? bp[(int64_t)rr * N + 4 * c4 + c] : 0.0f;
        }
      }
#pragma unroll
      for (int rr = 0; rr < RP; ++rr)
#pragma unroll
        for (int c = 0; c < V; ++c) bm[rr][4 * c4 + c] = bv[rr][c] * mk[c];
    }
  };

  // before the wait: the first row's adapter, its columns staged once for
  // the block and copied into every warp's registers
  if (tid == 0) {
    const int v = r_lo < r_hi ? idx[r_lo] : -1;
    first_s = (v >= 0 && v < A) ? v : -1;
  }
  __syncthreads();
  const int first = first_s;
  if (first >= 0) {
    const float* bp = b + (int64_t)first * r * N;
    const float* mp = mask + (int64_t)first * N;
    if (b_vec) {
      for (int i = tid; i < (RP + 1) * (CT / 4); i += kSplitThreads) {
        const int rr = i / (CT / 4), c = (i % (CT / 4)) * 4;  // rr == RP: the mask
        const int64_t nn = n0 + c;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (nn < N && rr < r) v = *reinterpret_cast<const float4*>(bp + (int64_t)rr * N + nn);
        if (nn < N && rr == RP) v = *reinterpret_cast<const float4*>(mp + nn);
        *reinterpret_cast<float4*>(rr < RP ? &b_s[rr][c] : &m_s[c]) = v;
      }
    } else {
      for (int i = tid; i < (RP + 1) * CT; i += kSplitThreads) {
        const int rr = i / CT, c = i % CT;
        const int64_t nn = n0 + c;
        if (rr < RP)
          b_s[rr][c] = nn < N && rr < r ? bp[(int64_t)rr * N + nn] : 0.0f;
        else
          m_s[c] = nn < N ? mp[nn] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RP; ++rr)
#pragma unroll
      for (int c = 0; c < CW; ++c) bm[rr][c] = b_s[rr][lane * CW + c] * m_s[lane * CW + c];
    cur = first;
  }
  pdl_wait();  // the shrink's partials have landed

  // a group's rows: their adapters (-1 out of range, -2 past the block) and
  // the partials of their xa over the K-slices, a lane (row, rank) entries
  // of the group, loaded for the next group while this one is written
  constexpr int NI = (G * RP + 31) / 32;
  int ad_l = -2;
  float pv[NI][kSplitMaxSplits];
  auto load_group = [&](int64_t m0) {
    ad_l = -2;
    if (lane < G && m0 + lane < r_hi) {
      const int v = idx[m0 + lane];
      ad_l = (v >= 0 && v < A) ? v : -1;
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int e = lane + 32 * i, j = e / RP;
      const bool live = e < G * RP && m0 + j < r_hi;
      const float* p = part + (m0 + j) * RP + e % RP;
#pragma unroll
      for (int sp = 0; sp < kSplitMaxSplits; ++sp) pv[i][sp] = live && sp < splits ? p[(int64_t)sp * M * RP] : 0.0f;
    }
  };
  const int64_t stride = (int64_t)(kSplitThreads / 32) * G;
  int64_t m0 = r_lo + (int64_t)warp * G;
  if (m0 < r_hi) load_group(m0);
  while (m0 < r_hi) {  // warp-uniform
    // this group's xa: each entry its partials summed over the slices in order
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int e = lane + 32 * i;
      float sum = pv[i][0];
#pragma unroll
      for (int sp = 1; sp < kSplitMaxSplits; ++sp) sum += pv[i][sp];  // + 0.0 past the slices
      if (e < G * RP) xa_s[warp][e / RP][e % RP] = sum;
    }
    const int ad_g = ad_l;
    const int64_t next = m0 + stride;
    if (next < r_hi) load_group(next);
    __syncwarp();
#pragma unroll 1
    for (int j = 0; j < G; ++j) {
      const int ad = __shfl_sync(0xffffffffu, ad_g, j);
      if (ad == -2) break;  // warp-uniform: the block's rows end
      float out[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) out[c] = 0.0f;
      if (ad >= 0) {
        if (ad != cur) {  // warp-uniform
          load_bm(ad);
          cur = ad;
        }
#pragma unroll
        for (int q = 0; q < RP / 4; ++q) {
          const float4 xv = *reinterpret_cast<const float4*>(&xa_s[warp][j][4 * q]);
          const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int c = 0; c < CW; ++c) out[c] = fmaf(xq[u], bm[4 * q + u][c], out[c]);
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) out[c] *= scale;
      }
      store_cols<CW>(y + (m0 + j) * N + n, out, n, N, y_vec);
    }
    __syncwarp();  // xa_s is read before the next group rewrites it
    m0 = next;
  }
}

template <typename T, int RP>
int launch_split_rank(void* y, const void* x, const int* idx, const float* a, const float* b, const float* mask,
                      float* part, int64_t M, int64_t K, int64_t N, int r, int A, float scale,
                      cudaStream_t stream) {
  constexpr int CW = split_cw(RP), ROWS = 8 * split_rw(RP);
  const int64_t kc = split_slice(M, K, RP, (int)sizeof(T));
  const int splits = split_count(M, K, RP, (int)sizeof(T));
  const int bytes = split_stages(RP) * RP * split_ks((int)sizeof(T)) * 4;
  static int opted_in = 0;  // the static shared memory counts against 48 KB too: always opt in
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(sparse_lora_split_xa_kernel<T, RP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  const int64_t tiles = (M + ROWS - 1) / ROWS;
  const int64_t rows = split_rows(M, N, RP);
  const int64_t row_blocks = (M + rows - 1) / rows, col_blocks = (N + 32 * CW - 1) / (32 * CW);
  if (tiles * splits > 2147483647LL || row_blocks * col_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool x_vec = (K * (int64_t)sizeof(T)) % 16 == 0 && aligned(x, 16);
  const bool a_vec = r % 4 == 0 && aligned(a, 16);
  sparse_lora_split_xa_kernel<T, RP><<<(unsigned)(tiles * splits), kSplitThreads, bytes, stream>>>(
      part, (const T*)x, idx, a, M, K, r, A, kc, splits, x_vec, a_vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool b_vec = N % 4 == 0 && aligned(b, 16) && aligned(mask, 16);
  const int64_t vbytes = CW * (int64_t)sizeof(T) < 16 ? CW * (int64_t)sizeof(T) : 16;
  const bool y_vec = aligned(y, 16) && (N * (int64_t)sizeof(T)) % vbytes == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(row_blocks * col_blocks));
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sparse_lora_split_y_kernel<T, RP>, (T*)y, (const float*)part, idx, b, mask, M, N,
                           r, A, splits, rows, col_blocks, scale, b_vec, y_vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split(void* y, const void* x, const int* idx, const float* a, const float* b, const float* mask,
                 float* part, int64_t M, int64_t K, int64_t N, int r, int A, float scale, cudaStream_t stream) {
#define REPRO_SPLIT(RP) \
  return launch_split_rank<T, RP>(y, x, idx, a, b, mask, part, M, K, N, r, A, scale, stream)
  switch (few_rank_pad(r)) {
    case 4: REPRO_SPLIT(4);
    case 8: REPRO_SPLIT(8);
    case 16: REPRO_SPLIT(16);
    case 32: REPRO_SPLIT(32);
    default: REPRO_SPLIT(64);
  }
#undef REPRO_SPLIT
}

// The multi-adapter product's kernel at these widths: the resident (SGMV)
// kernel where sgmv_stages > 0 (its ring depth in *stages), else the
// few-row path at most kFewMaxRows rows, else the split path (either's
// scratch floats in *scratch); the L2 (BGMV) kernel takes a launch of
// those two paths' widths that is given no scratch.
enum Path { kPathL2 = 0, kPathResident = 1, kPathFew = 2, kPathSplit = 3 };

Path route(int64_t M, int64_t K, int64_t N, int r, int A, int size, int* stages, int64_t* scratch) {
  *stages = sgmv_stages(M, K, N, r, A, size);
  *scratch = 0;
  if (*stages > 0) return kPathResident;
  if (M < 1 || A < 1) return kPathL2;
  const int RP = few_rank_pad(r);
  if (M > kFewMaxRows) {
    *scratch = (int64_t)split_count(M, K, RP, size) * M * RP;
    return kPathSplit;
  }
  *scratch = (int64_t)few_splits(K, RP) * M * RP;
  return kPathFew;
}

template <typename T>
int launch_any(void* y, const void* x, const int* idx, const float* a, const float* b, const float* mask, int* plan,
               float* scratch, int64_t M, int64_t K, int64_t N, int r, int A, float scale, bool packed,
               cudaStream_t stream) {
  const int size = (int)sizeof(T);
  int stages = 0;
  int64_t floats = 0;
  Path path = kPathL2;
  if (idx)
    path = route(M, K, N, r, A, size, &stages, &floats);
  else
    stages = team_stages(K, N, r, size, 0);
  // the scratch only on the few-row and split paths; without it, their launches take the L2 kernel
  if (scratch != nullptr && ((path != kPathFew && path != kPathSplit) || plan != nullptr || !aligned(scratch, 16)))
    return (int)cudaErrorInvalidValue;
  if (path == kPathFew && scratch != nullptr)
    return launch_few<T>(y, x, idx, a, b, mask, scratch, (int)M, K, N, r, A, scale, stream);
  if (path == kPathSplit && scratch != nullptr)
    return launch_split<T>(y, x, idx, a, b, mask, scratch, M, K, N, r, A, scale, stream);
  if (stages == 0) {
    if (plan != nullptr) return (int)cudaErrorInvalidValue;  // the L2 kernel makes no plan
    return launch<T>(y, x, idx, a, b, mask, M, K, N, r, idx ? A : 1, scale, packed, stream);
  }
  const int mode = idx ? kSgmv : packed ? kPacked : kMasked;
#define REPRO_RES(RP, MODE)                                                                                       \
  if (rank_pad(r) == RP && mode == MODE)                                                                         \
  return launch_resident<T, RP, MODE>(y, x, idx, a, b, mask, plan, M, K, N, r, A, scale, stages, stream)
#define REPRO_RES_RANKS(MODE) \
  REPRO_RES(4, MODE);         \
  REPRO_RES(8, MODE);         \
  REPRO_RES(16, MODE)
  REPRO_RES_RANKS(kMasked);
  REPRO_RES_RANKS(kPacked);
  REPRO_RES_RANKS(kSgmv);
#undef REPRO_RES_RANKS
#undef REPRO_RES
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y (M, N) and x (M, K): contiguous, dtype 0 (float32) or 1 (bfloat16).
// a (A, K, r), b (A, r, N), mask (A, N): contiguous float32.
// idx (M,) int32, or null for a single adapter (A = 1). packed (single
// adapter only): the kept columns of b as they are, 0 in the frozen ones.
// plan (M + A + 2,) int32 or null (the multi-adapter product on the SGMV
// path only): the rows in the order sorted by segment, then each segment's
// first row in that order, and the end. scratch (16-byte aligned, the
// floats repro_sparse_lora_path gives) or null (the multi-adapter product
// on the few-row and split paths only): that path's partials of x @ a; a
// launch of those paths' widths without it takes the L2 kernel.
int repro_sparse_lora(void* y, const void* x, const void* idx, const void* a, const void* b, const void* mask,
                      void* plan, void* scratch, int64_t M, int64_t K, int64_t N, int r, int n_adapters, int dtype,
                      int packed, float scale, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || r < 1 || r > kMaxRank || n_adapters < 1 || mask == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((M + kRows - 1) / kRows > 2147483647LL || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if (idx != nullptr ? packed != 0 : plan != nullptr || scratch != nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const float *af = (const float*)a, *bf = (const float*)b, *mf = (const float*)mask;
  float* part = (float*)scratch;
  const int A = ix ? n_adapters : 1;
  if (dtype == 0)
    return launch_any<float>(y, x, ix, af, bf, mf, (int*)plan, part, M, K, N, r, A, scale, packed, s);
  return launch_any<__nv_bfloat16>(y, x, ix, af, bf, mf, (int*)plan, part, M, K, N, r, A, scale, packed, s);
}

// The ring depth (all teams' stages) of the resident kernel that a launch
// takes at these widths on the current device (1..4), or 0 where it takes the
// kernel that reads a and b from L2. n_adapters 0: the single-adapter
// products (M unused); else the multi-adapter product over M rows.
int repro_sparse_lora_stages(int64_t M, int64_t K, int64_t N, int r, int n_adapters, int dtype) {
  if (K < 0 || N <= 0 || M < 0 || r < 1 || r > kMaxRank || n_adapters < 0 || dtype < 0 || dtype > 1) return -1;
  const int size = dtype == 0 ? 4 : 2;
  const int stages = n_adapters == 0 ? team_stages(K, N, r, size, 0) : sgmv_stages(M, K, N, r, n_adapters, size);
  return stages * res_teams(rank_pad(r));
}

// The kernel a multi-adapter launch of M rows takes at these widths on the
// current device: 0 the L2 (BGMV) kernel, 1 the resident (SGMV) kernel, 2
// the few-row path, 3 the split path; the last two take *scratch floats of
// scratch (0 on the others); -1 for widths no launch takes.
int repro_sparse_lora_path(int64_t M, int64_t K, int64_t N, int r, int n_adapters, int dtype, int64_t* scratch) {
  if (K < 0 || N <= 0 || M <= 0 || r < 1 || r > kMaxRank || n_adapters < 1 || dtype < 0 || dtype > 1 ||
      scratch == nullptr)
    return -1;
  int stages = 0;
  return (int)route(M, K, N, r, n_adapters, dtype == 0 ? 4 : 2, &stages, scratch);
}

}  // extern "C"
