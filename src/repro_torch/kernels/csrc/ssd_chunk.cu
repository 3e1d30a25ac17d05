// Mamba2 SSD intra-chunk kernel (the quadratic part of state-space
// duality within one chunk), written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_chunk.py::ssd_chunk_intra_kernel (_kernel)
//
// For each group g (batch x chunk x head), with cs = cumsum(a[g, 0, :]):
//   y[g, i, :] = sum_{j <= i} exp(cs_i - cs_j) * (c_i . b_j) * x[g, j, :]
// x (G, Q, hd), a (G, 1, Q), b and c (G / heads, Q, N), y (G, Q, hd) in
// f32; group g reads row g / heads of b and c (the heads of a chunk share
// them, as Mamba2's single B/C group does; heads = 1 is the TPU kernel's
// contract, b and c per group). x, b
// and c share one dtype, f32 or bf16; a is f32 or bf16. The scan, the
// decays and every sum are f32: the decays reach exp(-200) and below.
//
// Bound: memory. Per group it reads x, b, c once and writes y (with
// heads > 1, b and c once per row of them): at Q 128,
// N 128, hd 64 that is 197 KB in f32 (118 KB with bf16 inputs) for 3.2
// MFLOP on the triangle. On the CUDA cores (67 TFLOP/s in f32) those flops
// alone take 80% of the f32 byte bound, leaving no room for the loads, so
// both products run on the tensor cores (mma.sync):
//   - bf16 inputs: c.b^T in bf16 m16n8k16 with f32 sums (a product of two
//     bf16 values is exact in f32). M = exp(cs_i - cs_j) * score is f32; it
//     is split into hi = bf16(M) and lo = bf16(M - hi), and M.x is hi.x +
//     lo.x on the exact bf16 x: within 2^-18 of M per term, where one
//     bf16 rounding (2^-9) would miss the tolerance of 1e-5 of the sum of
//     absolute terms (as the flash-attention kernel splits p for p.v).
//   - f32 inputs: 3xTF32. Every operand is split into a TF32 hi
//     (cvt.rna.tf32.f32) and a TF32 lo of the rest, and each m16n8k8 step
//     adds lo.hi, hi.lo and hi.hi: within ~2^-21 per term, where one TF32
//     product (2^-11) would miss the tolerance.
// tests/test_torch_ssd_tc.py emulates this arithmetic step by step on the
// CPU and holds it to the JAX kernel.
//
// Design: one block of 4 warps per group, a warp per pair of 16-row strips.
//   - Only the lower triangle, evenly: the (128, 128) matrix is cut into 8
//     strips of 16 rows, strip s needing 16(s+1) columns. Warp w owns strips
//     w and 7-w, so every warp has 9 strip-columns of 16 (18 m16n8 tiles).
//     Each warp's body is compiled for its own strips (a switch on the warp
//     index), so the unrolled tile loops have no branch between tiles. A Q
//     below 128 is padded with zero rows to 128 (the contract's small chunks
//     are not the main path). The scores stay in registers as mma
//     accumulators, become M in place, and feed the M.x mma as its A operand
//     without leaving the registers (bf16: two accumulator tiles are one A
//     fragment, as in FlashAttention-2; TF32: the k index of a fragment is
//     permuted to match the accumulator's, and x's B fragment is read with
//     the same permutation). Above the diagonal and past Q, M is exactly 0.
//   - Decays: cs is scaled into log2 units once, so exp(cs_i - cs_j) is one
//     ex2.approx (relative error below 2^-22; the scaling moves it by about
//     1e-7·|cs|, inside the tolerance's 1e-6·max|cs| for the decays' order).
//   - Loads in flight during the math: x (all of it) and the first two
//     chunks of N of c and b (16 columns in f32, 32 in bf16) are issued at
//     once with 16-byte cp.async; chunk k+2 is issued as soon as chunk k is
//     consumed, so one chunk is always in flight while one is multiplied.
//     Rows are padded by 16 bytes, so fragment reads (ldmatrix for bf16,
//     32-bit loads for TF32) hit distinct banks. Shared memory: 75 KB a
//     group in f32 and 59 KB in bf16 at hd 64; with the registers, 2 groups
//     an SM in f32 and 3 in bf16, so the other resident groups' loads run
//     while one group finishes its M.x and stores. A third stage (tried in
//     throwaway builds) was slower in f32 and within 3% in bf16, where it
//     costs the third group an SM.
//   - TF32 operands: a warp splits its c and b fragments as it reads them,
//     one split b fragment serving both of its strips; x is split once per
//     group after the scores (hi in place, lo where the chunks were), since
//     every warp reads most of it. Registers (ptxas): 160 bf16 and 182 f32
//     at hd 64, no spill; the f32 M.x takes 4 column tiles at a time, in a
//     loop kept rolled, which is what keeps it under the 255 a thread may
//     have at 2 groups an SM (unrolled, it spilled and ran slower).
//   - Ragged shapes: N pads to the chunk width and hd to 64 or 128, with zeros in
//     shared memory; a row past Q and a column past hd are not stored. Rows
//     that do not allow 16-byte copies (N or hd not a multiple of 16 bytes,
//     or a pointer off a 16-byte boundary) are copied element by element.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxQ = 128;
constexpr int kMaxHd = 128;
constexpr int kStrips = kMaxQ / 16;           // strips of 16 rows: every chunk is padded to kMaxQ rows
constexpr int kMaxTiles = 2 * (kStrips + 1);  // m16n8 score tiles of a warp: 18
constexpr int kThreads = 32 * kStrips / 2;    // a warp per two strips: 4 warps
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col); not volatile:
// a register-only operation that the compiler may schedule among the others
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16x8 f32) += a (16x8 tf32, row) . b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32 (x - hi is exact in f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

// two f32 values as bf16 pairs hi = bf16(p) and lo = bf16(p - hi); p - hi is exact in f32
__device__ __forceinline__ void split_bf16x2(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// Shared-memory layout, in elements of T: NS stages of (c, b) chunks of
// kMaxQ rows x NC columns (a region at least as large as x, whose f32 lo
// half lands there after the scores), then x (kMaxQ rows x 8*HT columns),
// then cs (f32). f32 takes chunks of 16 columns, bf16 of 32: the narrower
// f32 chunk is a shorter wait for the first products.
// Every row is padded by 16 bytes (E elements).
template <typename T, int HT>
struct Layout {
  static constexpr int E = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int NC = sizeof(T) == 4 ? 16 : 32;  // columns of N per stage
  static constexpr int NS = 2;                         // stages
  static constexpr int LDC = NC + E;
  static constexpr int LDX = 8 * HT + E;
  static constexpr int kStages = NS * 2 * kMaxQ * LDC > kMaxQ * LDX ? NS * 2 * kMaxQ * LDC : kMaxQ * LDX;
  static constexpr int kBytes = (kStages + kMaxQ * LDX) * (int)sizeof(T) + kMaxQ * (int)sizeof(float);
};

// rows [0, kMaxQ) x columns [col0, col0 + width) of a (rows, ld) matrix into
// dst (row stride ldd); rows >= Q and columns >= ncols as zeros. vec: the
// 16-byte path (ld, ncols and col0 multiples of E, src 16-byte aligned);
// otherwise element by element, synchronously.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ldd, const T* src, int ld, int Q, int col0, int ncols,
                                          int width, bool vec) {
  constexpr int Qp = kMaxQ;
  constexpr int E = 16 / (int)sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec) {
    const int chunks = width / E;
    for (int e = tid; e < Qp * chunks; e += nt) {
      const int r = e / chunks, c = e % chunks;
      const int col = col0 + c * E;
      const bool in = r < Q && col < ncols;
      cp_async16(dst + r * ldd + c * E, in ? src + (int64_t)r * ld + col : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < Qp * width; e += nt) {
      const int r = e / width, c = e % width;
      const int col = col0 + c;
      dst[r * ldd + c] = (r < Q && col < ncols) ? src[(int64_t)r * ld + col] : zero<T>();
    }
  }
}

// Warp W's work: strips W and kStrips-1-W of 16 rows; its score slots
// [0, nA) are strip W's m16n8 tiles (columns 8*slot), [nA, kMaxTiles)
// strip kStrips-1-W's (columns 8*(slot - nA)). All compile-time, so the
// unrolled loops below have no branch between tiles.
template <int W>
struct Strips {
  static constexpr int sA = W, sB = kStrips - 1 - W, nA = 2 * (W + 1);
  __host__ __device__ static constexpr bool inA(int slot) { return slot < nA; }
  __host__ __device__ static constexpr int j0(int slot) { return inA(slot) ? 8 * slot : 8 * (slot - nA); }
};

// Scores of one chunk of NC columns of N on warp W's tiles.
template <int W>
__device__ __forceinline__ void score_chunk(float (&acc)[kMaxTiles][4], const bf16* cst, const bf16* bst,
                                            int lane) {
  using S = Strips<W>;
  constexpr int LDC = Layout<bf16, 8>::LDC;
  const int arow = lane & 15, brow = (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
  for (int ks = 0; ks < Layout<bf16, 8>::NC / 16; ++ks) {
    uint32_t fa[4], fb[4];
    const int acol = 16 * ks + 8 * (lane >> 4), bcol = 16 * ks + 8 * ((lane >> 3) & 1);
    ldsm_x4(cst + (16 * S::sA + arow) * LDC + acol, fa);
    ldsm_x4(cst + (16 * S::sB + arow) * LDC + acol, fb);
#pragma unroll
    for (int p = 0; p < kMaxTiles / 2; ++p) {
      uint32_t bb[4];
      ldsm_x4(bst + (S::j0(2 * p) + brow) * LDC + bcol, bb);
      const uint32_t(&f)[4] = S::inA(2 * p) ? fa : fb;
      mma_bf16(acc[2 * p], f, bb[0], bb[1]);
      mma_bf16(acc[2 * p + 1], f, bb[2], bb[3]);
    }
  }
}

template <int W>
__device__ __forceinline__ void score_chunk(float (&acc)[kMaxTiles][4], const float* cst, const float* bst,
                                            int lane) {
  using S = Strips<W>;
  constexpr int LDC = Layout<float, 8>::LDC;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1  // one k step at a time: the 18 tiles' products fill the registers
  for (int ks = 0; ks < Layout<float, 8>::NC / 8; ++ks) {
    const int k0 = 8 * ks;
    // A fragments (rows g, g+8; columns t, t+4) of both strips, split
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = g + 8 * (q & 1), col = k0 + t + 4 * (q >> 1);
      split_tf32(cst[(16 * S::sA + r) * LDC + col], ah[0][q], al[0][q]);
      split_tf32(cst[(16 * S::sB + r) * LDC + col], ah[1][q], al[1][q]);
    }
    // two column tiles at a time: strip sB needs all of its columns, strip
    // sA the first nA of them, so each split b fragment serves both; each
    // product kind over both tiles before the next, so that consecutive mma
    // write different accumulators
#pragma unroll
    for (int cp = 0; cp < (kMaxTiles - S::nA) / 2; ++cp) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* brow = bst + (8 * (2 * cp + u) + g) * LDC + k0 + t;
        split_tf32(brow[0], bh[u][0], bl[u][0]);
        split_tf32(brow[4], bh[u][1], bl[u][1]);
      }
#pragma unroll
      for (int st = 1; st >= 0; --st) {
        if (st == 0 && 2 * cp >= S::nA) continue;
        float(&c0)[4] = acc[st ? S::nA + 2 * cp : 2 * cp];
        float(&c1)[4] = acc[st ? S::nA + 2 * cp + 1 : 2 * cp + 1];
        mma_tf32(c0, al[st], bh[0][0], bh[0][1]);
        mma_tf32(c1, al[st], bh[1][0], bh[1][1]);
        mma_tf32(c0, ah[st], bl[0][0], bl[0][1]);
        mma_tf32(c1, ah[st], bl[1][0], bl[1][1]);
        mma_tf32(c0, ah[st], bh[0][0], bh[0][1]);
        mma_tf32(c1, ah[st], bh[1][0], bh[1][1]);
      }
    }
  }
}

// ya += M (slots [LO, HI) of acc: columns 0, 8, ... of the strip) . x
template <int HT, int LO, int HI>
__device__ __forceinline__ void mx_product(float (&ya)[HT][4], const float (&acc)[kMaxTiles][4], const bf16* xs,
                                           const bf16*, int lane) {
  constexpr int LDX = Layout<bf16, HT>::LDX;
  const int xrow = (lane & 7) + (((lane >> 3) & 1) << 3), xcol = 8 * (lane >> 4);
#pragma unroll
  for (int p = LO / 2; p < HI / 2; ++p) {
    const int j0 = 8 * (2 * p - LO);
    uint32_t mh[4], ml[4], bb[HT / 2][4];
    split_bf16x2(acc[2 * p][0], acc[2 * p][1], mh[0], ml[0]);
    split_bf16x2(acc[2 * p][2], acc[2 * p][3], mh[1], ml[1]);
    split_bf16x2(acc[2 * p + 1][0], acc[2 * p + 1][1], mh[2], ml[2]);
    split_bf16x2(acc[2 * p + 1][2], acc[2 * p + 1][3], mh[3], ml[3]);
#pragma unroll
    for (int dp = 0; dp < HT / 2; ++dp) ldsm_x4_trans(xs + (j0 + xrow) * LDX + 16 * dp + xcol, bb[dp]);
#pragma unroll
    for (int dp = 0; dp < HT / 2; ++dp) {
      mma_bf16(ya[2 * dp], mh, bb[dp][0], bb[dp][1]);
      mma_bf16(ya[2 * dp + 1], mh, bb[dp][2], bb[dp][3]);
    }
#pragma unroll
    for (int dp = 0; dp < HT / 2; ++dp) {
      mma_bf16(ya[2 * dp], ml, bb[dp][0], bb[dp][1]);
      mma_bf16(ya[2 * dp + 1], ml, bb[dp][2], bb[dp][3]);
    }
  }
}

// f32: x is already split, hi in xs and lo in xlo (TF32 bit patterns); the
// product covers the 4 column tiles from xs/xlo's first column, so that a
// strip's M stays in registers while its y goes out a quarter or half at a time
template <int HT, int LO, int HI>
__device__ __forceinline__ void mx_product(float (&ya)[4][4], const float (&acc)[kMaxTiles][4],
                                           const float* xs, const float* xlo, int lane) {
  constexpr int LDX = Layout<float, HT>::LDX;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = LO; s < HI; ++s) {
    const int j0 = 8 * (s - LO);
    // the accumulator holds columns 2t, 2t+1 where an A fragment holds t,
    // t+4: k index t stands for column 2t and t+4 for 2t+1, in x's rows too
    uint32_t mh[4], ml[4];
    split_tf32(acc[s][0], mh[0], ml[0]);
    split_tf32(acc[s][2], mh[1], ml[1]);
    split_tf32(acc[s][1], mh[2], ml[2]);
    split_tf32(acc[s][3], mh[3], ml[3]);
    const float* x0 = xs + (j0 + 2 * t) * LDX + g;
    const float* x1 = xlo + (j0 + 2 * t) * LDX + g;
    uint32_t xh[4][2], xl[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xh[u][0] = __float_as_uint(x0[8 * u]);
      xh[u][1] = __float_as_uint(x0[LDX + 8 * u]);
      xl[u][0] = __float_as_uint(x1[8 * u]);
      xl[u][1] = __float_as_uint(x1[LDX + 8 * u]);
    }
    // each product kind over the 4 column tiles before the next
#pragma unroll
    for (int u = 0; u < 4; ++u) mma_tf32(ya[u], ml, xh[u][0], xh[u][1]);
#pragma unroll
    for (int u = 0; u < 4; ++u) mma_tf32(ya[u], mh, xl[u][0], xl[u][1]);
#pragma unroll
    for (int u = 0; u < 4; ++u) mma_tf32(ya[u], mh, xh[u][0], xh[u][1]);
  }
}

// Strip STRIP from slots [LO, HI): M = exp(cs_i - cs_j) * score in place (0
// above the diagonal and past Q), then y = M . x, stored. cs is in log2
// units, so exp(cs_i - cs_j) is one ex2.approx.
template <typename T, int HT, int STRIP, int LO, int HI>
__device__ __forceinline__ void finish_strip(float (&acc)[kMaxTiles][4], const float* cs, const T* xs,
                                             const T* xlo, float* __restrict__ y, int Q, int hd, int lane) {
  const int gr = lane >> 2, t = lane & 3;
  const int i0 = 16 * STRIP + gr, i1 = i0 + 8;
  const float cs0 = cs[i0], cs1 = cs[i1];
#pragma unroll
  for (int q = LO; q < HI; ++q) {
    const int j = 8 * (q - LO) + 2 * t;
    const float csj0 = cs[j], csj1 = cs[j + 1];
    acc[q][0] = (j <= i0 && i0 < Q) ? exp2_approx(cs0 - csj0) * acc[q][0] : 0.f;
    acc[q][1] = (j + 1 <= i0 && i0 < Q) ? exp2_approx(cs0 - csj1) * acc[q][1] : 0.f;
    acc[q][2] = (j <= i1 && i1 < Q) ? exp2_approx(cs1 - csj0) * acc[q][2] : 0.f;
    acc[q][3] = (j + 1 <= i1 && i1 < Q) ? exp2_approx(cs1 - csj1) * acc[q][3] : 0.f;
  }
  // y a block of column tiles at a time: all HT (bf16), 4 (f32, whose
  // split operands take more registers)
  constexpr int NB = sizeof(T) == 2 ? HT : 4;
#pragma unroll 1  // one block at a time: its operands and the strip's M fill the registers
  for (int n0 = 0; n0 < HT; n0 += NB) {
    float ya[NB][4];
#pragma unroll
    for (int nd = 0; nd < NB; ++nd) ya[nd][0] = ya[nd][1] = ya[nd][2] = ya[nd][3] = 0.f;
    mx_product<HT, LO, HI>(ya, acc, xs + 8 * n0, xlo + 8 * n0, lane);
#pragma unroll
    for (int nd = 0; nd < NB; ++nd) {
      const int d = 8 * (n0 + nd) + 2 * t;
      if (d < hd) {
        if (i0 < Q) *reinterpret_cast<float2*>(y + (int64_t)i0 * hd + d) = make_float2(ya[nd][0], ya[nd][1]);
        if (i1 < Q) *reinterpret_cast<float2*>(y + (int64_t)i1 * hd + d) = make_float2(ya[nd][2], ya[nd][3]);
      }
    }
  }
}

template <typename T, int HT, int W>
__device__ __forceinline__ void finish(float (&acc)[kMaxTiles][4], const float* cs, const T* xs, const T* xlo,
                                       float* __restrict__ y, int Q, int hd, int lane) {
  using S = Strips<W>;
  finish_strip<T, HT, S::sA, 0, S::nA>(acc, cs, xs, xlo, y, Q, hd, lane);
  finish_strip<T, HT, S::sB, S::nA, kMaxTiles>(acc, cs, xs, xlo, y, Q, hd, lane);
}

template <typename T, int HT>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)
ssd_chunk_kernel(float* __restrict__ y, const T* __restrict__ x, const void* __restrict__ a,
                 const T* __restrict__ b, const T* __restrict__ c, int Q, int hd, int N, int heads,
                 int a_bf16, int vec_bc, int vec_x) {
  using L = Layout<T, HT>;
  extern __shared__ float4 smem4[];
  T* stages = reinterpret_cast<T*>(smem4);  // stage k: c at k * 2 * kMaxQ * LDC, b after it
  T* xs = stages + L::kStages;
  float* cs = reinterpret_cast<float*>(xs + kMaxQ * L::LDX);

  const int64_t g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  x += g * Q * hd;
  const int64_t row = blockIdx.x / (unsigned)heads;  // 32-bit division: G < 2^31
  b += row * Q * N;
  c += row * Q * N;
  y += g * Q * hd;

  // x and the first NS chunks of c and b in flight before anything else,
  // one cp.async group per chunk (x with the first)
  const int nchunks = (N + L::NC - 1) / L::NC;
  auto load_chunk = [&](int k) {
    T* st = stages + (k % L::NS) * 2 * kMaxQ * L::LDC;
    load_rows<T>(st, L::LDC, c, N, Q, k * L::NC, N, L::NC, vec_bc);
    load_rows<T>(st + kMaxQ * L::LDC, L::LDC, b, N, Q, k * L::NC, N, L::NC, vec_bc);
  };
  load_chunk(0);
  load_rows<T>(xs, L::LDX, x, hd, Q, 0, hd, 8 * HT, vec_x);
  cp_async_commit();
#pragma unroll
  for (int k = 1; k < L::NS; ++k) {
    if (k < nchunks) load_chunk(k);
    cp_async_commit();
  }

  // cs = cumsum(a): 4 values per lane of warp 0, then a shuffle scan
  if (warp == 0) {
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;
      if (i < Q)
        run += a_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(a)[g * Q + i])
                      : reinterpret_cast<const float*>(a)[g * Q + i];
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) cs[4 * lane + k] = (excl + v[k]) * kLog2e;
  }

  float acc[kMaxTiles][4];
#pragma unroll
  for (int s = 0; s < kMaxTiles; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;

  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<L::NS - 1>();  // chunk k (and x, with chunk 0) has landed
    __syncthreads();
    const T* cst = stages + (k % L::NS) * 2 * kMaxQ * L::LDC;
    const T* bst = cst + kMaxQ * L::LDC;
    switch (warp) {
      case 0: score_chunk<0>(acc, cst, bst, lane); break;
      case 1: score_chunk<1>(acc, cst, bst, lane); break;
      case 2: score_chunk<2>(acc, cst, bst, lane); break;
      default: score_chunk<3>(acc, cst, bst, lane); break;
    }
    __syncthreads();  // this stage is consumed: chunk k + NS may refill it
    if (k + L::NS < nchunks) load_chunk(k + L::NS);
    cp_async_commit();  // empty near the end: one group per chunk all the same
  }

  // f32: x split once for every warp's M.x, hi in place and lo where the
  // chunks were (every stage is consumed)
  T* xlo = stages;
  if (sizeof(T) == 4) {
    float* xf = reinterpret_cast<float*>(xs);
    float* xl = reinterpret_cast<float*>(xlo);
    for (int e = tid; e < kMaxQ * L::LDX; e += kThreads) {
      uint32_t hi, lo;
      split_tf32(xf[e], hi, lo);
      xf[e] = __uint_as_float(hi);
      xl[e] = __uint_as_float(lo);
    }
    __syncthreads();
  }
  switch (warp) {
    case 0: finish<T, HT, 0>(acc, cs, xs, xlo, y, Q, hd, lane); break;
    case 1: finish<T, HT, 1>(acc, cs, xs, xlo, y, Q, hd, lane); break;
    case 2: finish<T, HT, 2>(acc, cs, xs, xlo, y, Q, hd, lane); break;
    default: finish<T, HT, 3>(acc, cs, xs, xlo, y, Q, hd, lane); break;
  }
}

bool aligned(const void* p, uintptr_t n) { return ((uintptr_t)p % n) == 0; }

template <typename T, int HT>
int launch_ht(float* y, const void* x, const void* a, const void* b, const void* c, int64_t G, int Q, int hd,
              int N, int heads, int a_bf16, cudaStream_t stream) {
  using L = Layout<T, HT>;
  static bool opted_in = false;  // one attribute call per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<T, HT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int vec_bc = N % L::E == 0 && aligned(b, 16) && aligned(c, 16);
  const int vec_x = hd % L::E == 0 && aligned(x, 16);
  ssd_chunk_kernel<T, HT><<<(unsigned)G, kThreads, L::kBytes, stream>>>(
      y, (const T*)x, a, (const T*)b, (const T*)c, Q, hd, N, heads, a_bf16, vec_bc, vec_x);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(float* y, const void* x, const void* a, const void* b, const void* c, int64_t G, int Q, int hd,
           int N, int heads, int a_bf16, cudaStream_t stream) {
  if (hd <= 64) return launch_ht<T, 8>(y, x, a, b, c, G, Q, hd, N, heads, a_bf16, stream);
  return launch_ht<T, 16>(y, x, a, b, c, G, Q, hd, N, heads, a_bf16, stream);
}

}  // namespace

extern "C" {

// y: (G, Q, hd) float32, 8-byte aligned; x: (G, Q, hd), b and c:
// (G / heads, Q, N), all of dtype 0 (float32) or 1 (bfloat16); a: (G, Q) of
// a_dtype (same codes). All contiguous. Q a multiple of 8 up to 128, hd a
// multiple of 4 up to 128, N >= 1, G a multiple of heads >= 1. y must not
// alias an input.
int repro_ssd_chunk(void* y, const void* x, const void* a, const void* b, const void* c, int64_t G,
                    int Q, int hd, int N, int heads, int dtype, int a_dtype, void* stream) {
  if (G <= 0 || G > 0x7fffffff || Q < 8 || Q > kMaxQ || Q % 8 || hd < 4 || hd > kMaxHd || hd % 4 ||
      N < 1 || heads < 1 || G % heads || dtype < 0 || dtype > 1 || a_dtype < 0 || a_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned(y, 8)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>((float*)y, x, a, b, c, G, Q, hd, N, heads, a_dtype, s);
  return launch<bf16>((float*)y, x, a, b, c, G, Q, hd, N, heads, a_dtype, s);
}

}  // extern "C"
