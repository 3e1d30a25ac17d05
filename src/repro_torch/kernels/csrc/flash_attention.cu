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
// Bound: operations. A query tile of 64 rows against a KV tile of 64 keys
// does 2 * 64 * 64 * D multiply-adds for 2 * 64 * D values read, ~64 flops
// per byte at D 64, far above the card's byte rate, so the bound is the
// work over the bf16 tensor cores' 989 TFLOP/s (f32 inputs: the f32 line,
// 67 TFLOP/s, for a kernel outside the tensor cores).
//
// Two kernels share the launch geometry: one block of 128 threads per
// (query tile of 64 rows, head, batch), the heaviest causal tiles first,
// and only the KV tiles in [max(0, q0 - window + 1), min(S, q0 + 64)) are
// visited (the masks leave nothing outside it: half of the tiles at S
// 16384, window 8192). A row whose first visited tile is wholly masked for
// it holds m = -1e30 and junk in l and acc until its first real score: then
// alpha = exp(-1e30 - m) = 0 erases the junk, as on the TPU. Keys past S (a
// ragged last tile) are read as zeros and masked; rows past S are not
// written. Multiply-adds are explicit fmaf (the build turns off
// contraction, which only the bit-exact kernels need).
//
// bf16 (q, k, v, out all bf16 and 16-byte aligned): the tensor cores, in
// FlashAttention-2's shape. Each of the 4 warps owns 16 query rows. Q is
// copied once into shared memory and held in registers as mma A fragments
// (ldmatrix); K and V tiles of 64 keys come through a 2-stage ring of
// cp.async.cg 16-byte copies (rows past S zero-filled), tile t+1's copies in
// flight while tile t is computed. Shared rows are XOR-swizzled (16-byte
// chunk c of row r at c ^ (r % 8)) so that ldmatrix reads 8 rows without
// bank conflicts; V is read with ldmatrix.trans. q·kᵀ is mma.sync
// m16n8k16 with bf16 operands and f32 accumulators: a product of two bf16
// values is exact in f32, so a score is the TPU kernel's f32 dot product up
// to the order of summation. The online softmax stays in registers (row
// max over the 4 lanes of a quad with shuffles; l as per-thread partial
// sums of the f32 p, reduced at the end), with scores in log2 units so
// that exp(s - m) is one ex2.approx (relative error below 2^-22); only
// tiles that straddle the diagonal, the window's edge or S compare
// positions against the masks.
// p·v keeps the TPU kernel's f32 p: the accumulator fragment of the scores
// maps onto the A fragment of the next mma, and each p is split into
// hi = bf16(p) and lo = bf16(p - hi), both multiplied by the exact bf16 v.
// hi + lo is within 2^-18·p of p, so an output moves by at most 3.8e-6 of
// max|v|; a single rounding of p to bf16 (2^-9) would not meet the
// attention tolerance of 1e-5·max|v|. Shared memory: Q plus two stages of K
// and V, 40 KB at D 64, 50 KB at D 80, 70 KB at D 112, 80 KB at D 128 and
// 160 KB at D 256 (paligemma-3b; one block an SM). At D 256 the output
// accumulator alone is 128 registers a thread, and Q's fragments would add
// 64: Q stays in shared memory and each k-step of q·kᵀ ldmatrixes its
// fragment there (FlashAttention-2's choice at large head dims).
// D 80 (stablelm-3b) is 10 chunks of 16 bytes a row: 5 k-steps of 16 for
// q·kᵀ and 10 output tiles of 8 for p·v; D 112 (zamba2-7b) 14 chunks: 7
// k-steps and 14 output tiles. Both take the swizzle of rows whose chunk
// count is 2 mod 4 (swz); nothing is padded to 128, which would move 60%
// (D 80) or 14% (D 112) more bytes and do as much more work.
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
// Later: wgmma with P from registers, TMA-fed K/V tiles with mbarriers and a
// producer warp (FlashAttention-3's shape).
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for a shape the kernel does not take, or
// cudaErrorMisalignedAddress for a bf16 pointer off a 16-byte boundary.

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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


// ---- bf16 on the tensor cores (mma.sync m16n8k16, cp.async K/V ring) ----

using bf16 = __nv_bfloat16;
constexpr int kTcStages = 2;

template <int D>
constexpr int tc_smem_bytes() {
  return (kBQ + 2 * kTcStages * kBK) * D * (int)sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// element offset of 16-byte chunk c of row r in a tile with D values per
// row. ldmatrix reads one chunk column of 8 neighbouring rows (the first a
// multiple of 8); the swizzle puts those 8 chunks in 8 different groups of 4
// banks, and keeps every chunk inside its own row. D 64 and 128 (8 and 16
// chunks a row, rows of a multiple of 128 bytes): c ^ (r % 8). D 80 and 112
// (C = 10 and 14 chunks, C = 2 mod 4): row r starts at bank group C·r mod 8,
// which runs through the 4 even groups in rows 0-3 (0, 2, 4, 6 at D 80; 0,
// 6, 4, 2 at D 112) and again in rows 4-7. c ^ ((r / 4) % 2) swaps the
// chunks of each pair in rows 4-7 of 8, moving them to the 4 odd groups;
// C is even, so the swapped chunk stays in its row.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(D % 64 == 0 || (D % 16 == 0 && (D / 8) % 4 == 2), "no swizzle for this head_dim");
  if constexpr (D % 64 == 0) return r * D + ((c ^ (r & 7)) << 3);
  return r * D + ((c ^ ((r >> 2) & 1)) << 3);
}

// cp.async copies of a 64-row tile from sequence position row0 (rows >= S: zeros)
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, int64_t row_stride, int row0, int S) {
  constexpr int C = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < 64 * C / kThreads; ++i) {
    const int e = (int)threadIdx.x + i * kThreads;
    const int r = e / C, c = e % C;
    const bool in = row0 + r < S;
    cp_async16(smem_u32(tile + swz<D>(r, c)), base + (int64_t)(in ? row0 + r : 0) * row_stride + 8 * c,
               in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_tc_kernel(bf16* __restrict__ out, const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, int S, int H, int KVH, int causal, int window,
                          float scale) {
  constexpr int KS = D / 16;  // k-steps of q.k^T
  constexpr int DT = D / 8;   // 8-column tiles of the output
  extern __shared__ float4 smem4[];
  bf16* sq = reinterpret_cast<bf16*>(smem4);  // [kBQ][D]
  bf16* sk = sq + kBQ * D;                    // [kTcStages][kBK][D]
  bf16* sv = sk + kTcStages * kBK * D;        // [kTcStages][kBK][D]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int kvh = h / (H / KVH);
  const int64_t q_row = (int64_t)H * D, kv_row = (int64_t)KVH * D;
  const bf16* qb = q + (int64_t)blockIdx.z * S * q_row + (int64_t)h * D;
  const bf16* kb = k + (int64_t)blockIdx.z * S * kv_row + (int64_t)kvh * D;
  const bf16* vb = v + (int64_t)blockIdx.z * S * kv_row + (int64_t)kvh * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // a fragment's row (and row + 8) and column pair
  const int qw = q0 + 16 * warp;          // the warp's first query row

  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_lo = k_lo / kBK, t_hi = (k_hi + kBK - 1) / kBK;
  // scores in log2 units: exp(x - m) = 2^(x·log2(e) - m·log2(e)), one
  // multiply per score; -1e30 still marks a masked score (and m its row
  // until the first real one, where x - m = 0 and alpha = 0 then erases the junk)
  const float scale_log2 = scale * 1.4426950408889634f;

  load_tile<D>(sq, qb, q_row, q0, S);
  load_tile<D>(sk, kb, kv_row, t_lo * kBK, S);
  load_tile<D>(sv, vb, kv_row, t_lo * kBK, S);
  cp_async_commit();

  // Q's A fragments stay in registers up to D 128; at D 256 they would take
  // 64 registers beside the 128 of the output accumulator, so each k-step
  // ldmatrixes its fragment from the staged Q tile instead
  constexpr bool kQRegs = D <= 128;
  uint32_t qf[kQRegs ? KS : 1][4];
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows qw + g and qw + g + 8
  float l[2] = {0.f, 0.f};          // this thread's share of each row's sum

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int stage = (tile - t_lo) & 1;
    if (tile + 1 < t_hi) {
      load_tile<D>(sk + (stage ^ 1) * kBK * D, kb, kv_row, (tile + 1) * kBK, S);
      load_tile<D>(sv + (stage ^ 1) * kBK * D, vb, kv_row, (tile + 1) * kBK, S);
    }
    cp_async_commit();  // empty on the last tile: one group per tile all the same
    cp_async_wait<1>();  // this tile's copies (and Q's, with the first) have landed
    __syncthreads();
    if constexpr (kQRegs) {
      if (tile == t_lo) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(smem_u32(sq + swz<D>(16 * warp + (lane & 15), 2 * ks + (lane >> 4))), qf[ks][0], qf[ks][1],
                  qf[ks][2], qf[ks][3]);
      }
    }

    // s = q.k^T: 8 fragments of 16 rows x 8 keys
    const bf16* kt = sk + stage * kBK * D;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
        qa[0] = qf[ks][0], qa[1] = qf[ks][1], qa[2] = qf[ks][2], qa[3] = qf[ks][3];
      } else {
        ldsm_x4(smem_u32(sq + swz<D>(16 * warp + (lane & 15), 2 * ks + (lane >> 4))), qa[0], qa[1], qa[2], qa[3]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        const int key = 16 * np + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(smem_u32(kt + swz<D>(key, 2 * ks + ((lane >> 3) & 1))), b0, b1, b2, b3);
        mma_bf16(s[2 * np], qa, b0, b1);
        mma_bf16(s[2 * np + 1], qa, b2, b3);
      }
    }

    // scale into log2 units, and the masks where the tile straddles an edge of them
    const int k0 = tile * kBK;
    const bool edge = (causal && k0 + kBK - 1 > qw) || (window > 0 && k0 <= qw + 15 - window) || k0 + kBK > S;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= scale_log2;
        if (edge) {
          const int row = qw + g + 8 * (e >> 1);
          const int key = k0 + 8 * nt + 2 * t4 + (e & 1);
          const bool ok = key < S && (!causal || key <= row) && (window <= 0 || key > row - window);
          if (!ok) s[nt][e] = kNegInf;
        }
      }
    }

    // online softmax: row max over the quad, p = exp(s - m), alpha rescales
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2_approx(s[nt][e] - m[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], sum[r]);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // acc += p.v, p = hi + lo in two bf16 products on the exact bf16 v
    const bf16* vt = sv + stage * kBK * D;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t hi[4], lo[4];
      split_bf16x2(s[2 * ks][0], s[2 * ks][1], hi[0], lo[0]);
      split_bf16x2(s[2 * ks][2], s[2 * ks][3], hi[1], lo[1]);
      split_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1], hi[2], lo[2]);
      split_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        const int key = 16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_trans(smem_u32(vt + swz<D>(key, 2 * dp + (lane >> 4))), b0, b1, b2, b3);
        mma_bf16(acc[2 * dp], hi, b0, b1);
        mma_bf16(acc[2 * dp], lo, b0, b1);
        mma_bf16(acc[2 * dp + 1], hi, b2, b3);
        mma_bf16(acc[2 * dp + 1], lo, b2, b3);
      }
    }
    __syncthreads();  // this stage is consumed: the next tile's copies may refill it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = qw + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* o = out + (int64_t)blockIdx.z * S * q_row + (int64_t)row * q_row + (int64_t)h * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * dt) =
          __floats2bfloat162_rn(acc[dt][2 * r] / denom, acc[dt][2 * r + 1] / denom);
  }
}

template <int D>
int launch_tc(void* out, const void* q, const void* k, const void* v, int B, int S, int H, int KVH, int causal,
              int window, float scale, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<D>();
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_tc_kernel<D><<<grid, kThreads, bytes, stream>>>((bf16*)out, (const bf16*)q, (const bf16*)k,
                                                                  (const bf16*)v, S, H, KVH, causal, window,
                                                                  scale);
  return (int)cudaGetLastError();
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
  if (D == 64) return launch_tc<64>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  if (D == 80) return launch_tc<80>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  if (D == 112) return launch_tc<112>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  if (D == 128) return launch_tc<128>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  return launch_tc<256>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
}

// The dynamic shared memory a launch at this head_dim and dtype opts into,
// in bytes, or -1 for a head_dim without a kernel.
int repro_flash_attention_smem(int D, int dtype) {
  if (dtype == 0) {
    if (D == 64) return smem_floats<64>() * (int)sizeof(float);
    if (D == 80) return smem_floats<80>() * (int)sizeof(float);
    if (D == 112) return smem_floats<112>() * (int)sizeof(float);
    if (D == 128) return smem_floats<128>() * (int)sizeof(float);
    if (D == 256) return smem_floats<256>() * (int)sizeof(float);
  } else if (dtype == 1) {
    if (D == 64) return tc_smem_bytes<64>();
    if (D == 80) return tc_smem_bytes<80>();
    if (D == 112) return tc_smem_bytes<112>();
    if (D == 128) return tc_smem_bytes<128>();
    if (D == 256) return tc_smem_bytes<256>();
  }
  return -1;
}

}  // extern "C"
