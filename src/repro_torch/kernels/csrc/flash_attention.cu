// Causal / sliding-window / bidirectional flash attention (forward), written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bhsd (_kernel)
//
// For each batch b, query head h and query position i, with g = H / KVH
// and the KV head h / g (the order jnp.repeat gives):
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / g],
//   s_ij = q[b, i, h] . k[b, j, h / g] / sqrt(D) where the mask allows,
//          NEG_INF (-1e30) where it does not,
// the mask being j <= i when causal and j > i - window with a window
// (window 0: none). q, k, v and o keep the (B, S, H, D) / (B, S, KVH, D)
// layouts, read and written in place; f32 or bf16, one dtype for all four.
// Scores, the running max and denominator and the output accumulator are
// f32; the output is acc / max(l, 1e-30), as in the TPU kernel.
//
// Bound: operations. Each visited (query, key) pair costs 4·D flops (q·k
// and p·v), against 2·D bytes of q and o and 4·D bytes of k and v per row,
// so at the served shapes the work over the bf16 tensor cores' 989 TFLOP/s
// exceeds the bytes over 3.35 TB/s (f32 inputs: the f32 line, 67 TFLOP/s,
// for a kernel outside the tensor cores).
//
// Both kernels visit, for a query tile starting at q0, only the KV tiles in
// [max(0, q0 - window + 1), min(S, q0 + rows)) (the masks leave nothing
// outside it: half of the tiles at S 16384, window 8192), the heaviest
// causal tiles first. A row whose first visited tile is wholly masked for
// it holds m = -1e30 until its first real score, where alpha = 0 erases
// whatever it summed, as on the TPU. Keys past S (a ragged last tile) are
// read as zeros and masked; rows past S are not written. Multiply-adds are
// explicit fmaf (the build turns off contraction, which only the bit-exact
// kernels need).
//
// bf16 (q, k, v, out all bf16 and 16-byte aligned): FlashAttention-3's shape
// on Hopper's tensor cores. A persistent grid, one block of 384 threads an
// SM (at most one per query tile), in three warpgroups whose registers
// setmaxnreg rebalances (24 a thread for the producer, 240 for the
// consumers). A block walks query tiles of 128 rows (tile, head, batch) in
// a snake over the tiles ordered heaviest first (near a longest-first
// schedule), so that the next tile's Q and K/V loads run under this tile's
// last products and its epilogue.
// - the producer: one thread issues TMA loads of each tile's Q (once Q's
//   empty barrier says both consumers' last q·kᵀ has read the previous one)
//   and of its K and V tiles into a ring of kStages* stages, each with a
//   full mbarrier (the copy's bytes) and an empty one (every consumer warp
//   done with it). The tensor maps are 4-D over (D, heads, S, B), encoded
//   on the host per launch and passed by value (__grid_constant__), so a
//   CUDA graph of launches captures them; a box is 64 columns (128 bytes)
//   by the tile's rows, 128-byte swizzled, rows past S zero-filled.
// - two consumer warpgroups of 64 query rows each. q·kᵀ is wgmma
//   m64nBKk16 with Q and K both read from shared memory (K-major
//   descriptors; a k-step moves the start 32 bytes inside a swizzle atom).
//   A product of two bf16 values is exact in f32, so a raw score is the TPU
//   kernel's f32 dot product up to the order of summation. The online
//   softmax runs on the accumulator fragments: the raw row max m (four
//   partial maxima a row, then the 4 lanes of a quad), p = 2^(s·c - m·c)
//   for c = scale·log2(e) as one fma into one ex2.approx (relative error
//   below 2^-22), l as per-thread partial sums of the f32 p, reduced at the
//   end; only tiles that straddle the diagonal, the window's edge or S
//   compare positions against the masks.
// - p·v keeps the TPU kernel's f32 p: the scores' accumulator fragment is
//   the A register fragment of an RS wgmma, and each p is split into
//   hi = bf16(p) and lo = bf16(p - hi), both multiplied by the exact bf16 v
//   (V read from shared memory as a transposed, MN-major B operand: 8-key
//   atoms 1024 bytes apart, 64-column blocks BK·128 apart). hi + lo is
//   within 2^-18·p of p, so an output moves by at most 3.8e-6 of max|v|; a
//   single rounding of p to bf16 (2^-9) would not meet the attention
//   tolerance of 1e-5·max|v|. The split costs half again the tensor work
//   that the 4·D-flops bound counts (6·D a pair) and 6 instructions a pair
//   of scores.
// - overlap: tile t+1's q·kᵀ is issued before tile t's p·v, and its
//   softmax runs while that p·v is in flight (wgmma.wait_group 1; a
//   barrier wait between the softmax and the next wait_group keeps ptxas
//   from hoisting that wait above the softmax); O is rescaled just before
//   the next p·v is issued. Two named barriers order the consumers' issues
//   (ping-pong), so that one warpgroup's softmax runs under the other's
//   products.
// Key tiles (BK) are 128 keys at D 64-128 and 64 at D 256, where the output
// accumulator alone is D/2 = 128 registers a thread, beside BK/2 of scores
// and BK/2 of hi/lo fragments (64-key tiles at D 64-128 and 80 at D 256
// were no faster, nor a third ring stage: scripts/torch_attention_sweep.py).
// Shared memory: Q (128 rows) and two stages of K and V: 80 KB at D 64,
// 160 KB at D 80-128 and 192 KB at D 256 (one block an SM).
// D 80 (stablelm-3b) and D 112 (zamba2-7b): their rows (160 and 224 bytes)
// are not a whole number of 128-byte swizzle atoms, so they are padded to
// 128 columns in shared memory only: the tensor maps keep the true D
// extent and TMA fills the columns past it with zeros, reading no more
// bytes from device memory. q·kᵀ stops at the last k-step holding a real
// column (5 of 8 at D 80, 7 at D 112) and p·v runs at N = D (an
// instruction over one whole 64-column block and part of the next), so
// the padding does no tensor work: it costs shared memory (160 KB where
// unpadded tiles would take 100 KB at D 80 and 140 KB at D 112) and the
// zero fill's writes.
// What holds it back (NVIDIA H100 80GB HBM3, 700 W; the ablations of
// scripts/torch_attention_sweep.py): at D 64 the softmax (S 4096 causal
// 0.108 ms, 0.049 without it); the split's lo product 6-24% (0.082 without
// it); at D 80-256 taking the softmax or p·v out does not shorten the run:
// each warpgroup's chain of q·kᵀ, softmax and next issue bounds it.
//
// f32: the CUDA cores. The query tile is staged once in shared memory,
// transposed; each KV tile in its range is staged in turn (k transposed, v
// as it is). A thread owns 8 query rows x 4 keys of a score tile (keys
// strided by 16, so that 16 lanes read 16 neighbouring words) and 8 rows x
// D/16 columns of the accumulator; the 16 lanes that share rows reduce the
// row max and sum with shuffles. p goes through shared memory (transposed)
// to the p.v product. Shared memory: 66 KB at D 64, 79 KB at D 80, 103 KB
// at D 112, 116 KB at D 128, 214 KB at D 256 (one block an SM).
//
// Both take their dynamic shared memory through the opt-in attribute.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for a shape the kernel does not take (or a
// tensor map cuTensorMapEncodeTiled refuses), cudaErrorMisalignedAddress for
// a bf16 pointer off a 16-byte boundary, or cudaErrorNotSupported where
// cuTensorMapEncodeTiled cannot be found.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block: 8 row groups of 8
constexpr int kBK = 64;  // keys per KV tile: 16 lanes x 4
constexpr int kLdQ = kBQ + 4;  // qt[d][i], pt[j][i]: 16-byte aligned rows
constexpr int kLdK = kBK + 1;  // kt[d][j]: lanes on neighbouring banks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr int smem_floats() {
  return D * kLdQ + D * kLdK + kBK * D + kBK * kLdQ;
}

__device__ __forceinline__ float row_max16(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The CUDA-core kernel is launched for T = float only (bf16 inputs take the
// tensor-core kernel below).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, int S, int H, int KVH, int causal, int window,
                       float scale) {
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kLdQ]
  float* kt = qt + D * kLdQ;                     // [D][kLdK]
  float* vs = kt + D * kLdK;                     // [kBK][D]
  float* pt = vs + kBK * D;                      // [kBK][kLdQ]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int kvh = h / (H / KVH);
  const int64_t q_row = (int64_t)H * D, kv_row = (int64_t)KVH * D;
  const int64_t q_base = (int64_t)blockIdx.z * S * q_row + (int64_t)h * D;
  const int64_t kv_base = (int64_t)blockIdx.z * S * kv_row + (int64_t)kvh * D;
  const int tid = threadIdx.x;
  const int ri = tid / 16, ci = tid % 16;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D;
    qt[d * kLdQ + i] = q0 + i < S ? to_f32(q[q_base + (int64_t)(q0 + i) * q_row + d]) : 0.f;
  }

  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_lo = k_lo / kBK, t_hi = (k_hi + kBK - 1) / kBK;

  float m[8], l[8], acc[8][DC];
  for (int r = 0; r < 8; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    for (int dc = 0; dc < DC; ++dc) acc[r][dc] = 0.f;
  }

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's kt, vs and pt are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < S;
      const int64_t off = kv_base + (int64_t)(k0 + j) * kv_row + d;
      kt[d * kLdK + j] = in ? to_f32(k[off]) : 0.f;
      vs[j * D + d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[8][4];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kLdQ + 8 * ri);
      const float4 qb = *reinterpret_cast<const float4*>(qt + d * kLdQ + 8 * ri + 4);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float kv[4];
      for (int c = 0; c < 4; ++c) kv[c] = kt[d * kLdK + ci + 16 * c];
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

    for (int r = 0; r < 8; ++r) {
      const int qpos = q0 + 8 * ri + r;
      float mx = kNegInf;
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + ci + 16 * c;
        const bool ok = kpos < S && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        s[r][c] = ok ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max16(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      l[r] = l[r] * alpha + row_sum16(sum);
      for (int dc = 0; dc < DC; ++dc) acc[r][dc] *= alpha;
      m[r] = m_new;
    }

    for (int c = 0; c < 4; ++c) {
      float* row = pt + (ci + 16 * c) * kLdQ + 8 * ri;
      *reinterpret_cast<float4*>(row) = make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
    }
    __syncthreads();
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + j * kLdQ + 8 * ri);
      const float4 pb = *reinterpret_cast<const float4*>(pt + j * kLdQ + 8 * ri + 4);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[DC];
      for (int dc = 0; dc < DC; ++dc) vv[dc] = vs[j * D + ci + 16 * dc];
      for (int r = 0; r < 8; ++r)
        for (int dc = 0; dc < DC; ++dc) acc[r][dc] = fmaf(pv[r], vv[dc], acc[r][dc]);
    }
  }

  for (int r = 0; r < 8; ++r) {
    const int qpos = q0 + 8 * ri + r;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* o = out + q_base + (int64_t)qpos * q_row;
    for (int dc = 0; dc < DC; ++dc) store(o + ci + 16 * dc, acc[r][dc] / denom);
  }
}

template <typename T, int D>
int launch(void* out, const void* q, const void* k, const void* v, int B, int S, int H, int KVH,
           int causal, int window, float scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  static bool opted_in = false;  // one attribute call per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (T*)out, (const T*)q, (const T*)k, (const T*)v, S, H, KVH, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on Hopper's tensor cores (wgmma from TMA-fed shared memory) ----

using bf16 = __nv_bfloat16;

constexpr int kWgBQ = 128;         // query rows per block: two consumer warpgroups of 64
constexpr int kWgThreads = 384;    // the producer warpgroup and the two consumers
constexpr int kBkNarrow = 128;     // keys per K/V tile at D 64 to 128
constexpr int kBkWide = 64;        // at D 256
constexpr int kStagesNarrow = 2;   // K/V ring stages at D 64 to 128
constexpr int kStagesWide = 2;     // at D 256
constexpr int kPingPong = 1;       // order the two consumers' wgmma issues with named barriers
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240 <= 65536
constexpr int kConsumerRegs = 240;

template <int D>
struct Tiles {
  static constexpr int DP = D <= 64 ? 64 : D <= 128 ? 128 : 256;  // the row width in shared memory
  static constexpr int NB = DP / 64;                              // 128-byte column blocks of a row
  static constexpr int BK = D <= 128 ? kBkNarrow : kBkWide;
  static constexpr int ST = D <= 128 ? kStagesNarrow : kStagesWide;
  static constexpr int KS = (D + 15) / 16;                // k-steps of q·kᵀ: none over the padding
  static constexpr int Q_BYTES = kWgBQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;            // one K or V tile
  static constexpr int BARRIERS = 2 + 4 * ST;             // Q full, Q empty; K/V full and empty per stage
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * ST * KV_BYTES + 8 * BARRIERS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 2^x (MUFU.EX2; relative error below 2^-22, results below 2^-126 flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

// two f32 p's as bf16 pairs hi = bf16(p) and lo = bf16(p - hi); p - hi is exact in f32
__device__ __forceinline__ void split_bf16x2(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// -- mbarriers and TMA --

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// until the phase of this parity has completed (a fresh barrier: parity 1 at once)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// a box of the 4-D tensor map at coordinates (column, head, row, batch) into
// shared memory; its bytes complete the transaction on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- warpgroups --

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// named barriers 1 and 2, one per consumer, each met by both consumers (256 threads)
__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes across its issue or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units). K-major tiles (Q, K): rows of 128
// bytes, 8-row atoms 1024 bytes apart (stride), the leading offset unused.
// MN-major (V as p·v's B): 8 keys of 128 bytes an atom, atoms along the keys
// 1024 bytes apart (stride), 64-column blocks BK·128 bytes apart (leading).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t leading, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(leading >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         (1ull << 62);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d (64 x 64 f32) = a . b (+ d if scale_d): a and b bf16, both from shared memory, K-major
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x 64 f32) = a . b (+ d if scale_d): a bf16 from registers (the accumulator layout of a
  // 64 x 16 tile), b bf16 from shared memory, MN-major (transposed)
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<80> {
  // d (64 x 80 f32) = a . b (+ d if scale_d): a and b bf16, both from shared memory, K-major
  __device__ __forceinline__ static void ss(float (&d)[40], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x 80 f32) = a . b (+ d if scale_d): a bf16 from registers (the accumulator layout of a
  // 64 x 16 tile), b bf16 from shared memory, MN-major (transposed)
  __device__ __forceinline__ static void rs(float (&d)[40], const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<112> {
  // d (64 x 112 f32) = a . b (+ d if scale_d): a bf16 from registers (the accumulator layout of a
  // 64 x 16 tile), b bf16 from shared memory, MN-major (transposed)
  __device__ __forceinline__ static void rs(float (&d)[56], const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128 f32) = a . b (+ d if scale_d): a and b bf16, both from shared memory, K-major
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x 128 f32) = a . b (+ d if scale_d): a bf16 from registers (the accumulator layout of a
  // 64 x 16 tile), b bf16 from shared memory, MN-major (transposed)
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  // d (64 x 256 f32) = a . b (+ d if scale_d): a bf16 from registers (the accumulator layout of a
  // 64 x 16 tile), b bf16 from shared memory, MN-major (transposed)
  __device__ __forceinline__ static void rs(float (&d)[128], const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The block: threads 0-127 the producer, 128-255 consumer 0 (query rows q0
// to q0 + 63), 256-383 consumer 1 (q0 + 64 to q0 + 127).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int B, int S, int H,
                             int KVH, int causal, int window, float scale) {
  using T = Tiles<D>;
  constexpr int BK = T::BK, ST = T::ST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [NB][128 rows][64]
  const uint32_t sk = sq + T::Q_BYTES;                        // [ST][NB][BK rows][64]
  const uint32_t sv = sk + ST * T::KV_BYTES;                  // [ST][NB][BK rows][64]
  const uint32_t bars = sv + ST * T::KV_BYTES;
  const uint32_t bar_q = bars, bar_q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 + ST + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + 2 * ST + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 + 3 * ST + s); };

  // the block's work: query tiles w = blockIdx.x, then in passes of
  // gridDim.x, forwards and backwards in turn (a snake over the tiles,
  // heaviest causal tiles first: near a longest-first schedule)
  const int n_q = (S + kWgBQ - 1) / kWgBQ, n_work = n_q * H * B;
  auto work = [&](int pass) {
    return pass * (int)gridDim.x + ((pass & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  int q0 = 0, h = 0, b = 0, kvh = 0, t_lo = 0, n_tiles = 0;
  auto decode = [&](int w) {
    q0 = (n_q - 1 - w / (H * B)) * kWgBQ;
    h = w % (H * B) % H;
    b = w % (H * B) / H;
    kvh = h / (H / KVH);
    int k_lo = 0, k_hi = S;
    if (causal) k_hi = min(S, q0 + kWgBQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
    t_lo = k_lo / BK;
    n_tiles = (k_hi + BK - 1) / BK - t_lo;
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, 8);  // one arrival from each consumer warp
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival from each consumer warp
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread keeps the ring full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles through the ring so far
      for (int pass = 0; work(pass) < n_work; ++pass) {
        decode(work(pass));
        mbar_wait(bar_q_empty, (pass & 1) ^ 1);  // the consumers are done with the last Q tile
        mbar_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
        for (int c = 0; c < T::NB; ++c) tma_load(sq + c * kWgBQ * 128, &tq, bar_q, 64 * c, h, q0, b);
        for (int i = 0; i < n_tiles; ++i, ++it) {
          const int s = it % ST;
          const uint32_t phase = (it / ST) & 1;
          const int k0 = (t_lo + i) * BK;
          mbar_wait(k_empty(s), phase ^ 1);
          mbar_expect_tx(k_full(s), T::KV_BYTES);
#pragma unroll
          for (int c = 0; c < T::NB; ++c)
            tma_load(sk + s * T::KV_BYTES + c * BK * 128, &tk, k_full(s), 64 * c, kvh, k0, b);
          mbar_wait(v_empty(s), phase ^ 1);
          mbar_expect_tx(v_full(s), T::KV_BYTES);
#pragma unroll
          for (int c = 0; c < T::NB; ++c)
            tma_load(sv + s * T::KV_BYTES + c * BK * 128, &tv, v_full(s), 64 * c, kvh, k0, b);
        }
      }
    }
    return;
  }

  // a consumer: 64 query rows, 16 a warp; this thread's rows qr + g and qr + g + 8
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  int qr = 0;
  const uint32_t sq_mine = sq + cw * 64 * 128;
  // exp(x·scale - m·scale) = 2^(x·c - m·c); -1e30 marks a masked raw score
  // (and m its row until the first real one, where alpha = 0)
  const float scale_log2 = scale * 1.4426950408889634f;

  float o[D / 2];
  float s[BK / 2];                          // a 64 x BK score tile: 8-key chunk i in s[4i .. 4i + 3]
  uint32_t hi[BK / 4], lo[BK / 4];          // p split, as the A fragments of BK / 16 k-steps
  float m[2], l[2], alpha[2];  // rows qr + g and qr + g + 8; l: this thread's share of each row's sum

  // descriptors differ only in their start address (bits 0-13, in 16-byte
  // units): a k-step or a stage adds its offset to a base
  const uint64_t desc_q = smem_desc(sq_mine, 16, 1024);
  const uint64_t desc_k = smem_desc(sk, 16, 1024);
  const uint64_t desc_v = smem_desc(sv, BK * 128, 1024);
  // s = q·kᵀ over the tile in stage st (issued, not waited for)
  auto issue_qk = [&](int st) {
    const uint64_t dk = desc_k + ((uint32_t)(st * T::KV_BYTES) >> 4);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk) {
      // the k-step's 32 bytes inside its 128-byte column block
      const uint32_t col = (kk % 4) * 32;
      Wgmma<BK>::ss(s, desc_q + (((kk / 4) * kWgBQ * 128 + col) >> 4), dk + (((kk / 4) * BK * 128 + col) >> 4),
                    kk > 0);
    }
    wgmma_commit();
  };
  // o += hi·v + lo·v over the tile in stage st (issued, not waited for)
  auto issue_pv = [&](int st) {
    const uint64_t dv = desc_v + ((uint32_t)(st * T::KV_BYTES) >> 4);
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      Wgmma<D>::rs(o, hi + 4 * kk, dv + ((kk * 16 * 128) >> 4), 1);
      Wgmma<D>::rs(o, lo + 4 * kk, dv + ((kk * 16 * 128) >> 4), 1);
    }
    wgmma_commit();
  };
  // the online softmax on the raw scores of the tile at k0: p in s, alpha,
  // m (the raw row max) and l updated. p = 2^(s·c - m·c), c = scale·log2(e),
  // is one fma into one ex2; a row with no real score yet takes m·c = 0,
  // so that its masked p are 0
  auto softmax = [&](int k0) {
    const bool edge = (causal && k0 + BK - 1 > qr) || (window > 0 && k0 <= qr + 15 - window) || k0 + BK > S;
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = qr + g + 8 * (e >> 1);
          const int key = k0 + 8 * i + 2 * t4 + (e & 1);
          const bool ok = key < S && (!causal || key <= row) && (window <= 0 || key > row - window);
          if (!ok) s[4 * i + e] = kNegInf;
        }
      }
    }
    // four partial maxima and sums a row: short dependency chains
    float part[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) part[r][0] = part[r][1] = part[r][2] = part[r][3] = m[r];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      part[0][i % 4] = fmaxf(part[0][i % 4], fmaxf(s[4 * i], s[4 * i + 1]));
      part[1][i % 4] = fmaxf(part[1][i % 4], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = exp2_approx((m[r] - mx) * scale_log2);
      m[r] = mx;
      mc[r] = mx == kNegInf ? 0.f : mx * scale_log2;
      part[r][0] = part[r][1] = part[r][2] = part[r][3] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * i + e] = exp2_approx(fmaf(s[4 * i + e], scale_log2, -mc[e >> 1]));
        part[e >> 1][i % 4] += s[4 * i + e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = fmaf(l[r], alpha[r], (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
  };
  // p's A fragments: k-step kk holds keys 16kk to 16kk + 15, chunks 2kk and 2kk + 1
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) split_bf16x2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], hi[4 * kk + j], lo[4 * kk + j]);
    }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
  };

  // ping-pong: consumer c issues after barrier 1 + c and then lets the
  // other one go (barrier 2 - c); consumer 1 lets consumer 0 go first, and
  // skips its last arrival, so that every arrival meets a sync
  if (kPingPong && cw == 1) named_arrive(1);
  int it = 0;  // K/V tiles through the ring so far
  for (int pass = 0; work(pass) < n_work; ++pass) {
    decode(work(pass));
    qr = q0 + 64 * cw + 16 * warp;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    mbar_wait(bar_q, pass & 1);

    mbar_wait(k_full(it % ST), (it / ST) & 1);
    if (kPingPong) named_sync(1 + cw);
    issue_qk(it % ST);
    if (kPingPong) named_arrive(2 - cw);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) {
      mbar_arrive(k_empty(it % ST));
      if (n_tiles == 1) mbar_arrive(bar_q_empty);
    }
    softmax(t_lo * BK);
    split_p();
    if (n_tiles > 1) mbar_wait(k_full((it + 1) % ST), ((it + 1) / ST) & 1);

    for (int i = 1; i < n_tiles; ++i) {
      const int j = it + i, st = j % ST, prev = (j - 1) % ST;
      if (kPingPong) named_sync(1 + cw);
      issue_qk(st);
      rescale_o();
      mbar_wait(v_full(prev), ((j - 1) / ST) & 1);
      issue_pv(prev);
      if (kPingPong) named_arrive(2 - cw);
      wgmma_wait<1>();  // q·kᵀ of tile i has landed; p·v of tile i - 1 runs on
      fence_regs(s);
      if (lane == 0) {
        mbar_arrive(k_empty(st));
        if (i + 1 == n_tiles) mbar_arrive(bar_q_empty);  // the last q·kᵀ: Q may be refilled
      }
      softmax((t_lo + i) * BK);
      // the wait for the next K tile (or this V tile) is a loop, and so ends
      // the softmax's basic block: ptxas hoists a wgmma wait to the top of
      // its block, and the softmax would no longer run under the p·v
      if (i + 1 < n_tiles)
        mbar_wait(k_full((j + 1) % ST), ((j + 1) / ST) & 1);
      else
        mbar_wait(v_full(st), (j / ST) & 1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(hi);
      fence_regs(lo);
      if (lane == 0) mbar_arrive(v_empty(prev));
      split_p();
    }

    const int j = it + n_tiles - 1, last = j % ST;
    rescale_o();
    mbar_wait(v_full(last), (j / ST) & 1);
    if (kPingPong) named_sync(1 + cw);
    issue_pv(last);
    // consumer 1's last arrival of the block would meet no sync
    if (kPingPong && (cw == 0 || work(pass + 1) < n_work)) named_arrive(2 - cw);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(v_empty(last));
    it += n_tiles;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = qr + g + 8 * r;
      if (row >= S) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      bf16* op = out + ((int64_t)b * S + row) * H * D + (int64_t)h * D + 2 * t4;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * i) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] / denom, o[4 * i + 2 * r + 1] / denom);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the build
// links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 4-D map of a contiguous bf16 (B, S, heads, D) tensor: boxes of 64
// columns by `rows` sequence positions of one head and batch, 128-byte
// swizzled; columns past D and rows past S read as zeros
bool encode_bshd(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2, (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(void* out, const void* q, const void* k, const void* v, int B, int S, int H, int KVH,
                 int causal, int window, float scale, cudaStream_t stream) {
  using T = Tiles<D>;
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(encode, &tq, q, B, S, H, D, kWgBQ) || !encode_bshd(encode, &tk, k, B, S, KVH, D, T::BK) ||
      !encode_bshd(encode, &tv, v, B, S, KVH, D, T::BK))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  static int sms = 0;  // one block an SM, each walking its share of the query tiles
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int work = ((S + kWgBQ - 1) / kWgBQ) * H * B, blocks = work < sms ? work : sms;
  flash_attention_wgmma_kernel<D><<<blocks, kWgThreads, T::SMEM, stream>>>(tq, tk, tv, (bf16*)out, B, S, H, KVH,
                                                                        causal, window, scale);
  return (int)cudaGetLastError();
}

// the launch layout of a head_dim and dtype: query rows a block, keys a
// tile, ring stages, the row width in shared memory, threads a block,
// dynamic shared memory (bytes), and the compiled kernel's registers a
// thread at launch and local (spilled) bytes
template <int D>
int layout_bf16(int* outv) {
  using T = Tiles<D>;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, flash_attention_wgmma_kernel<D>);
  if (err != cudaSuccess) return (int)err;
  const int vals[8] = {kWgBQ, T::BK, T::ST, T::DP, kWgThreads, T::SMEM, attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 8; ++i) outv[i] = vals[i];
  return 0;
}

template <int D>
int layout_f32(int* outv) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, flash_attention_kernel<float, D>);
  if (err != cudaSuccess) return (int)err;
  const int vals[8] = {kBQ, kBK, 1, D, kThreads, smem_floats<D>() * (int)sizeof(float), attr.numRegs,
                       (int)attr.localSizeBytes};
  for (int i = 0; i < 8; ++i) outv[i] = vals[i];
  return 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// out, q: (B, S, H, D); k, v: (B, S, KVH, D); contiguous, all of dtype 0
// (float32, on the CUDA cores) or 1 (bfloat16, on the tensor cores, every
// pointer 16-byte aligned). D 64, 80, 112, 128 or 256; H a multiple of KVH; window 0 for
// none, else >= 1. scale is 1/sqrt(D) in float32. out must not alias an
// input.
int repro_flash_attention(void* out, const void* q, const void* k, const void* v, int B, int S,
                          int H, int KVH, int D, int causal, int window, int dtype, float scale,
                          void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535 || KVH < 1 || H % KVH || window < 0 ||
      dtype < 0 || dtype > 1 || (D != 64 && D != 80 && D != 112 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (D == 64) return launch<float, 64>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
    if (D == 80) return launch<float, 80>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
    if (D == 112) return launch<float, 112>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
    if (D == 128) return launch<float, 128>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
    return launch<float, 256>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  }
  if (!(aligned16(out) && aligned16(q) && aligned16(k) && aligned16(v))) return (int)cudaErrorMisalignedAddress;
  if (D == 64) return launch_wgmma<64>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  if (D == 80) return launch_wgmma<80>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  if (D == 112) return launch_wgmma<112>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  if (D == 128) return launch_wgmma<128>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  return launch_wgmma<256>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
}

// The launch layout of this head_dim and dtype into out[8] (see layout_bf16);
// returns 0, a CUDA error, or -1 for a head_dim without a kernel.
int repro_flash_attention_layout(int D, int dtype, int* out) {
  if (dtype == 0) {
    if (D == 64) return layout_f32<64>(out);
    if (D == 80) return layout_f32<80>(out);
    if (D == 112) return layout_f32<112>(out);
    if (D == 128) return layout_f32<128>(out);
    if (D == 256) return layout_f32<256>(out);
  } else if (dtype == 1) {
    if (D == 64) return layout_bf16<64>(out);
    if (D == 80) return layout_bf16<80>(out);
    if (D == 112) return layout_bf16<112>(out);
    if (D == 128) return layout_bf16<128>(out);
    if (D == 256) return layout_bf16<256>(out);
  }
  return -1;
}

}  // extern "C"
