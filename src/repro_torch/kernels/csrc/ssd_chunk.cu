// Mamba2 SSD intra-chunk kernel (the quadratic part of state-space
// duality within one chunk), written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_chunk.py::ssd_chunk_intra_kernel (_kernel)
//
// For each row r (a batch x chunk) and head h, with cs = cumsum(a[r, h, :]):
//   y[r, h, i, :] = sum_{j <= i} exp(cs_i - cs_j) * (c[r, i] . b[r, j]) * x[r, h, j, :]
// The heads of a row share its b and c, as Mamba2's single B/C group does
// (the TPU kernel's contract is one head a row: b and c per group). x
// (R, heads, Q, hd), a (R, heads, Q), b and c (R, Q, N) and y (R, heads, Q,
// hd) are read and written in place at the strides the caller gives (the
// last dimension contiguous): the JAX contract's (G, Q, hd) groups and the
// model's (B, S, nh, hd) sequence are both such views, so the model's
// prefill copies nothing before the launch. x, b and c share one dtype,
// f32 or bf16; a is f32 or bf16; y is f32. The scan, the decays and every
// sum are f32: the decays reach exp(-200) and below.
//
// Bound: memory. Per head it reads x and writes y (f32), per row b and c
// once: at mamba2-1.3b's serve prefill (Q 128, 64 heads of 64, N 128, bf16)
// 48 KB a head against 64 KB of b and c a row. The tensor work is c.b^T
// once a row and M.x per head (plus its lo half), under a tenth of the
// bytes' time at the bf16 rate.
//
// Design: a persistent grid of one block of 384 threads an SM, a producer
// warpgroup and two consumer warpgroups, each consumer with its own rings.
//   - Work units: a row and a block of H <= 16 of its heads. H is chosen on
//     the host so that the units fill the card's consumers in as few waves
//     as possible (the cost of a unit counted as H heads plus one for its
//     scores); consumer k of block b takes units 2b + k, then every
//     2 x gridDim.x-th. A unit computes the scores S = c.b^T once, over the
//     lower triangle at the granularity of the 64-row tiles that wgmma takes
//     (rows 0-63 against columns 0-63, rows 64-127 against 0-127), keeps
//     them in registers (96 a thread), and for each head forms M =
//     exp(cs_i - cs_j) * S (exactly 0 above the diagonal and past Q) and
//     y = M.x. heads = 1 is a unit of one head a row: the same code, the
//     same sums.
//   - Loads (TMA route): lane 0 of producer warp k feeds consumer k: b and c
//     in chunks of one 128-byte column block (64 columns bf16, 32 f32) and
//     each head's x in blocks of 64 columns, all as TMA boxes of 128 rows
//     (rows past Q and columns past N or hd are zero-filled) into rings
//     counted by full/empty mbarriers, 128-byte swizzled. The next unit's b
//     and c load as soon as this unit's scores are in registers, under its
//     heads; the next head's x under this head's products. The tensor maps
//     are encoded on the host at each launch and passed by value, so a CUDA
//     graph captures them.
//   - Loads (copy route): where a base is off a 16-byte boundary or a stride
//     not a multiple of 16 bytes (N or hd ragged in bytes, unaligned views),
//     TMA cannot take the tensor; the consumers then copy the same tiles
//     element by element into the same swizzled layout (zeros where TMA
//     fills zeros), so both routes give the same bits.
//   - bf16: S in bf16 SS wgmma (m64n64k16 and m64n128k16; a product of two
//     bf16 values is exact in f32, sums in f32). M.x is RS wgmma m64n64k16
//     with M in registers split into hi = bf16(M) and lo = bf16(M - hi)
//     against x from shared memory as an MN-major operand: within 2^-18 of
//     M per term, where one bf16 rounding (2^-9) would miss the tolerance
//     of 1e-5 of the sum of absolute terms (as the flash-attention kernel
//     splits p for p.v). Each k-step adds hi.x, then lo.x.
//   - f32: 3xTF32 on TF32 wgmma for both products; every operand is split
//     into a TF32 hi (cvt.rna.tf32.f32) and a TF32 lo of the rest, and
//     each k-step of 8 adds lo.hi, hi.lo and hi.hi: within ~2^-21 per
//     term, where one TF32 product (2^-11) would miss the tolerance. S: SS
//     m64n64k8 and m64n128k8, each chunk of c and b split once in shared
//     memory (hi in place, lo beside it). M.x: TF32 wgmma reads both
//     operands K-major and x is N-major (hd contiguous), so each 64-column
//     block of x is transposed in shared memory once a head and split on
//     the way: hi into the unit's last b/c stage (held, its scores done,
//     until the unit's heads are: the next unit's first b/c chunk then
//     loads under nothing), lo where the b/c lo halves were; the x stage is
//     then free for the next block's TMA load under this block's products.
//     x^T's positions are permuted within each 8 to match M's accumulator
//     fragments used as RS wgmma's A (k index t4 for position 2t4, t4 + 4
//     for 2t4 + 1); two k-steps at a time, their hi and lo in 16 registers
//     beside the scores (four spill more and run 3-6% slower, eight 25-40%:
//     scripts/torch_ssd_sweep.py --variants, NVIDIA H100 80GB HBM3, 700 W).
//     Why not the other option, M.x on mma.sync from x as loaded: its
//     warps' shares of the triangle run from 12 to 24 chunks (the accumulator
//     layout fixes which rows a warp holds), and beside the scores it
//     spilled.
//   - Decays: cs is computed once a unit for its heads (a warp's shuffle
//     scan over 4 values a lane) and scaled into log2 units, so exp(cs_i -
//     cs_j) is one ex2.approx (relative error below 2^-22; the scaling moves
//     it by about 1e-7·|cs|, inside the tolerance's 1e-6·max|cs|).
//   - Shared memory a consumer: bf16 two stages of b and c (64 KB), two
//     stages of x (32 KB), the decays (8 KB); f32 one stage of b and c and
//     its lo halves (64 KB, x^T's hi and lo under the heads), one stage of
//     x (32 KB), the decays: 104 KB, 209 KB a block.
//     Registers: setmaxnreg gives the consumers 232 a thread and the
//     producer 40.
// tests/test_torch_ssd_tc.py emulates this arithmetic step by step on the
// CPU and holds it to the JAX kernel.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for a shape the kernel does not take or for
// tensors whose bases and strides TMA takes but whose maps
// cuTensorMapEncodeTiled refuses, cudaErrorMisalignedAddress for y off an 8-byte boundary or with
// an odd stride, or cudaErrorNotSupported where cuTensorMapEncodeTiled
// cannot be found. repro_ssd_chunk_copy_launches() counts the launches that
// took the copy route.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kQ = 128;             // rows of a chunk tile: every chunk is padded to it
constexpr int kMaxHd = 128;
constexpr int kMaxHeadBlock = 16;   // heads a work unit (their decays in shared memory)
constexpr int kThreads = 384;       // the producer warpgroup and two consumers
constexpr int kProducerRegs = 40;   // setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kTile = kQ * 128;     // bytes of a 128-row x 128-byte tile
constexpr int kTf32Steps = 2;       // f32 M.x: k-steps of 8 positions issued together
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Cfg {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int CW = 128 / (int)sizeof(T);         // columns of a 128-byte swizzle atom
  static constexpr int CB_STAGES = BF16 ? 2 : 1;          // b/c ring stages, each one column block
  static constexpr int CB_BYTES = 2 * kTile;              // a stage: c's tile, then b's
  static constexpr int LO_BYTES = BF16 ? 0 : 2 * kTile;   // f32: the TF32 lo halves of a stage
  static constexpr int X_TILES = 64 / CW;                 // tiles of a 64-column block of x
  static constexpr int X_BYTES = X_TILES * kTile;
  static constexpr int X_STAGES = BF16 ? 2 : 1;
  static constexpr int CS_BYTES = kMaxHeadBlock * kQ * 4;
  static constexpr int X_OFF = CB_STAGES * CB_BYTES + LO_BYTES;
  static constexpr int CS_OFF = X_OFF + X_STAGES * X_BYTES;
  static constexpr int WG_BYTES = CS_OFF + CS_BYTES;      // a consumer's region, a multiple of 1024
  static constexpr int BARRIERS = 2 * (CB_STAGES + X_STAGES);  // a full and an empty barrier a stage
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period
  static constexpr int SMEM = 1024 + 2 * WG_BYTES + 2 * 8 * BARRIERS;
};

struct Params {
  float* y;
  const void* x;
  const void* a;
  const void* b;
  const void* c;
  // strides in elements: x, y and a by (row, head, position); b and c by (row, position)
  long long xs_r, xs_h, xs_i, ys_r, ys_h, ys_i, as_r, as_h, as_i, bs_r, bs_i, cs_r, cs_i;
  int R, heads, Q, hd, N;
  int head_block, blocks_per_row, units;
  int a_bf16, tma, x_heads_inner;
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// the byte offset of (row, byte column) in a 1024-byte-aligned tile of
// 128-byte rows, 128-byte swizzled as TMA writes it: the 16-byte chunk index
// XORed with the row's index within its 8-row atom
__device__ __forceinline__ int swizzled(int row, int byte) { return (row * 128 + byte) ^ ((row & 7) << 4); }

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma and TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// -- warpgroups --

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// named barrier 1 + k: consumer k's 128 threads
__device__ __forceinline__ void wg_sync(int cw) { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory"); }

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
// and stride byte offsets (16-byte units). K-major tiles (c, b): rows of 128
// bytes, 8-row atoms 1024 bytes apart (stride), the leading offset unused; a
// k-step moves the start 32 bytes inside the atom. MN-major (x as M.x's
// B): 8 positions of 128 bytes an atom, atoms 1024 bytes apart (stride).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t leading, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(leading >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 64 f32) (+)= a . b: a and b bf16 from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_bf16_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
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

// d (64 x 128 f32) (+)= a . b: a and b bf16 from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_bf16_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
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

// d (64 x 64 f32) (+)= a . b: a and b tf32 from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_tf32_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 f32) (+)= a . b: a and b tf32 from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_tf32_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
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

// d (64 x 64 f32) (+)= a . b: a bf16 from registers (the accumulator layout of a 64 x 16 tile),
// b bf16 from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_bf16_n64(float (&d)[32], const uint32_t* a, uint64_t b, int scale_d) {
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

// d (64 x 64 f32) (+)= a . b: a tf32 from registers (the accumulator layout of
// a 64 x 8 tile, its k indices permuted as mx_tf32 says), b tf32 from shared
// memory, K-major
__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[32], const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// rows [0, kQ) x one 128-byte column block (columns col0, ...) of a matrix
// with row stride ld (elements) into a swizzled tile, as TMA writes it:
// rows >= rows_in and columns >= ncols as zeros (the copy route)
template <typename T>
__device__ __forceinline__ void copy_tile(uint8_t* dst, const T* src, long long ld, int rows_in, int col0, int ncols,
                                          int tid) {
  constexpr int CW = 128 / (int)sizeof(T);
  for (int e = tid; e < kQ * CW; e += 128) {
    const int row = e / CW, cc = e % CW, col = col0 + cc;
    const T v = (row < rows_in && col < ncols) ? src[(long long)row * ld + col] : zero<T>();
    *reinterpret_cast<T*>(dst + swizzled(row, cc * (int)sizeof(T))) = v;
  }
}

// M = exp(cs_i - cs_j) * S on this thread's four entries of the 8-column
// chunk at column 8c of a 64-row tile (rows i0 and i0 + 8): 0 above the
// diagonal and past Q. cs is in log2 units, so a decay is one ex2.approx.
struct Decay {
  int i0, i1, Q, t4;
  float ci0, ci1;
  __device__ __forceinline__ void operator()(const float* csh, int c, float s0, float s1, float s2, float s3,
                                             float& m0, float& m1, float& m2, float& m3) const {
    const int j = 8 * c + 2 * t4;
    const float2 cj = *reinterpret_cast<const float2*>(csh + j);
    m0 = (j <= i0 && i0 < Q) ? exp2_approx(ci0 - cj.x) * s0 : 0.f;
    m1 = (j + 1 <= i0 && i0 < Q) ? exp2_approx(ci0 - cj.y) * s1 : 0.f;
    m2 = (j <= i1 && i1 < Q) ? exp2_approx(ci1 - cj.x) * s2 : 0.f;
    m3 = (j + 1 <= i1 && i1 < Q) ? exp2_approx(ci1 - cj.y) * s3 : 0.f;
  }
};

// y rows i0 and i1 of a 64-row tile, columns 64·xb + 8u + 2t4 (+1), from
// accumulator fragments in the mma layout (u the 8-column chunk)
__device__ __forceinline__ void store_rows(float* yh, const Params& p, int xb, const Decay& d, int u, float y0,
                                           float y1, float y2, float y3) {
  const int col = 64 * xb + 8 * u + 2 * d.t4;
  if (col >= p.hd) return;
  if (d.i0 < p.Q) *reinterpret_cast<float2*>(yh + (long long)d.i0 * p.ys_i + col) = make_float2(y0, y1);
  if (d.i1 < p.Q) *reinterpret_cast<float2*>(yh + (long long)d.i1 * p.ys_i + col) = make_float2(y2, y3);
}

// bf16: rows 64·TILE to 64·TILE + 63 of y = M.x for one 64-column block of
// x: M from the scores S (NS = 32 or 64 a thread: 64 or 128 columns) split
// hi/lo into RS wgmma's A fragments, x at xs (MN-major). Each k-step of 16
// positions adds hi.x, then lo.x.
template <int TILE, int NS>
__device__ __forceinline__ void mx_bf16(const float (&s)[NS], const float* csh, uint32_t xs, float* yh, int xb,
                                        const Params& p, int warp, int g, int t4) {
  constexpr int KS = NS / 8;
  Decay d{64 * TILE + 16 * warp + g, 64 * TILE + 16 * warp + g + 8, p.Q, t4, 0.f, 0.f};
  d.ci0 = csh[d.i0];
  d.ci1 = csh[d.i1];
  uint32_t hi[4 * KS], lo[4 * KS];
#pragma unroll
  for (int c = 0; c < 2 * KS; ++c) {
    float m0, m1, m2, m3;
    d(csh, c, s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3], m0, m1, m2, m3);
    // k-step c / 2 holds chunks c and c + 1: rows g and g + 8 of each
    const int f = 4 * (c / 2) + 2 * (c % 2);
    split_bf16x2(m0, m1, hi[f], lo[f]);
    split_bf16x2(m2, m3, hi[f + 1], lo[f + 1]);
  }
  float y[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) y[i] = 0.f;
  fence_regs(y);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t dx = smem_desc(xs + kk * 16 * 128, kTile, 1024);
    wgmma_rs_bf16_n64(y, hi + 4 * kk, dx, 1);
    wgmma_rs_bf16_n64(y, lo + 4 * kk, dx, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(y);
  fence_regs(hi);
  fence_regs(lo);
#pragma unroll
  for (int u = 0; u < 8; ++u) store_rows(yh, p, xb, d, u, y[4 * u], y[4 * u + 1], y[4 * u + 2], y[4 * u + 3]);
}

// f32: the same rows on TF32 RS wgmma (3xTF32): M's accumulator fragments
// are the A fragments, split into TF32 hi and lo, against x^T split
// beforehand (hi at xs, lo at xlo; see transpose_split_x). The accumulator
// holds positions 2t4 and 2t4 + 1 of a chunk where an A fragment holds k
// indices t4 and t4 + 4, so k index t4 stands for position 2t4 and t4 + 4
// for 2t4 + 1, and x^T's positions are stored in that order. kTf32Steps
// k-steps of 8 positions at a time (their hi and lo in registers beside the
// scores); each k-step adds lo.hi, hi.lo, hi.hi.
template <int TILE, int NS>
__device__ __forceinline__ void mx_tf32(const float (&s)[NS], const float* csh, uint32_t xs, uint32_t xlo, float* yh,
                                        int xb, const Params& p, int warp, int g, int t4) {
  constexpr int NC = NS / 4;
  Decay d{64 * TILE + 16 * warp + g, 64 * TILE + 16 * warp + g + 8, p.Q, t4, 0.f, 0.f};
  d.ci0 = csh[d.i0];
  d.ci1 = csh[d.i1];
  float y[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) y[i] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < NC; c0 += kTf32Steps) {
    uint32_t mh[4 * kTf32Steps], ml[4 * kTf32Steps];
#pragma unroll
    for (int c = c0; c < c0 + kTf32Steps; ++c) {
      float m0, m1, m2, m3;
      d(csh, c, s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3], m0, m1, m2, m3);
      const int f = 4 * (c - c0);
      split_tf32(m0, mh[f], ml[f]);
      split_tf32(m2, mh[f + 1], ml[f + 1]);
      split_tf32(m1, mh[f + 2], ml[f + 2]);
      split_tf32(m3, mh[f + 3], ml[f + 3]);
    }
    fence_regs(y);
    fence_regs(mh);
    fence_regs(ml);
    wgmma_fence();
#pragma unroll
    for (int c = c0; c < c0 + kTf32Steps; ++c) {
      // k-step c: positions 8c to 8c + 7, in x^T's tile c / 4 at byte 32 (c % 4)
      const uint32_t off = (c / 4) * (64 * 128) + (c % 4) * 32;
      const uint64_t dh = smem_desc(xs + off, 16, 1024), dl = smem_desc(xlo + off, 16, 1024);
      const int f = 4 * (c - c0);
      wgmma_rs_tf32_n64(y, ml + f, dh, 1);
      wgmma_rs_tf32_n64(y, mh + f, dl, 1);
      wgmma_rs_tf32_n64(y, mh + f, dh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
    fence_regs(mh);
    fence_regs(ml);
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) store_rows(yh, p, xb, d, u, y[4 * u], y[4 * u + 1], y[4 * u + 2], y[4 * u + 3]);
}

// f32: the 64-column block of x at xs (two swizzled tiles of 128 positions
// by 32 columns, as loaded) as x^T for TF32 wgmma, which reads its B operand
// K-major only: 64 rows (x's columns) of 128 positions, in four swizzled
// tiles of 32 positions (8 KB each), each position's 8-group permuted as
// mx_tf32's k indices are (position 2q at q, 2q + 1 at 4 + q). The TF32 hi
// goes to hi, the lo to lo. Neighbouring threads take neighbouring
// positions, so that the writes fill rows of x^T.
__device__ __forceinline__ void transpose_split_x(const uint8_t* xs, uint8_t* hi, uint8_t* lo, int tid) {
#pragma unroll 8
  for (int e = tid; e < kQ * 64; e += 128) {
    const int j = e % kQ, col = e / kQ;
    const float v = *reinterpret_cast<const float*>(xs + (col / 32) * kTile + swizzled(j, (col % 32) * 4));
    const int jp = (j & ~7) + (j & 1) * 4 + ((j & 7) >> 1);
    const int off = (jp / 32) * (64 * 128) + swizzled(col, (jp % 32) * 4);
    uint32_t h, l;
    split_tf32(v, h, l);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    *reinterpret_cast<uint32_t*>(lo + off) = l;
  }
}

// f32: `bytes` of shared memory at hi split into TF32 hi (in place) and lo
// (at lo), 16 bytes a step over the consumer's 128 threads
__device__ __forceinline__ void split_tf32_tile(uint8_t* hi, uint8_t* lo, int bytes, int tid) {
  float4* hi4 = reinterpret_cast<float4*>(hi);
  float4* lo4 = reinterpret_cast<float4*>(lo);
  for (int e = tid; e < bytes / 16; e += 128) {
    float4 v = hi4[e], l;
    uint32_t hb, lb;
    split_tf32(v.x, hb, lb);
    v.x = __uint_as_float(hb);
    l.x = __uint_as_float(lb);
    split_tf32(v.y, hb, lb);
    v.y = __uint_as_float(hb);
    l.y = __uint_as_float(lb);
    split_tf32(v.z, hb, lb);
    v.z = __uint_as_float(hb);
    l.z = __uint_as_float(lb);
    split_tf32(v.w, hb, lb);
    v.w = __uint_as_float(hb);
    l.w = __uint_as_float(lb);
    hi4[e] = v;
    lo4[e] = l;
  }
}

// The block: threads 0-127 the producer (lane 0 of warp k feeds consumer
// k), 128-255 consumer 0, 256-383 consumer 1.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc, const __grid_constant__ Params p) {
  using C = Cfg<T>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bars = base + 2 * C::WG_BYTES;
  // consumer k's barriers: b/c full and empty, then x full and empty, a stage each
  auto cb_full = [&](int k, int s) { return bars + 8 * (k * C::BARRIERS + s); };
  auto cb_empty = [&](int k, int s) { return bars + 8 * (k * C::BARRIERS + C::CB_STAGES + s); };
  auto x_full = [&](int k, int s) { return bars + 8 * (k * C::BARRIERS + 2 * C::CB_STAGES + s); };
  auto x_empty = [&](int k, int s) { return bars + 8 * (k * C::BARRIERS + 2 * C::CB_STAGES + C::X_STAGES + s); };
  const int nk = (p.N + C::CW - 1) / C::CW;  // column blocks of b and c
  const int nxb = (p.hd + 63) / 64;          // 64-column blocks of x and y
  const int slots = 2 * (int)gridDim.x;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int s = 0; s < C::CB_STAGES; ++s) {
        mbar_init(cb_full(k, s), 1);
        mbar_init(cb_empty(k, s), 4);  // one arrival from each consumer warp
      }
#pragma unroll
      for (int s = 0; s < C::X_STAGES; ++s) {
        mbar_init(x_full(k, s), 1);
        mbar_init(x_empty(k, s), 4);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread a consumer keeps its rings full (TMA route)
    setmaxnreg_dec<kProducerRegs>();
    if (p.tma && threadIdx.x % 32 == 0 && threadIdx.x < 64) {
      const int k = threadIdx.x / 32;
      const uint32_t region = base + k * C::WG_BYTES;
      int cb_it = 0, x_it = 0;
      for (int u = 2 * (int)blockIdx.x + k; u < p.units; u += slots) {
        const int r = u / p.blocks_per_row, h0 = u % p.blocks_per_row * p.head_block;
        const int h1 = min(h0 + p.head_block, p.heads);
        for (int n = 0; n < nk; ++n, ++cb_it) {
          const int s = cb_it % C::CB_STAGES;
          const uint32_t dst = region + s * C::CB_BYTES;
          mbar_wait(cb_empty(k, s), ((cb_it / C::CB_STAGES) & 1) ^ 1);
          mbar_expect_tx(cb_full(k, s), C::CB_BYTES);
          tma_load_3d(dst, &tc, cb_full(k, s), n * C::CW, 0, r);
          tma_load_3d(dst + kTile, &tb, cb_full(k, s), n * C::CW, 0, r);
        }
        for (int h = h0; h < h1; ++h) {
          for (int xb = 0; xb < nxb; ++xb, ++x_it) {
            const int s = x_it % C::X_STAGES;
            const uint32_t dst = region + C::X_OFF + s * C::X_BYTES;
            mbar_wait(x_empty(k, s), ((x_it / C::X_STAGES) & 1) ^ 1);
            mbar_expect_tx(x_full(k, s), C::X_BYTES);
#pragma unroll
            for (int t = 0; t < C::X_TILES; ++t) {
              const int col = 64 * xb + C::CW * t;
              if (p.x_heads_inner)
                tma_load_4d(dst + t * kTile, &tx, x_full(k, s), col, h, 0, r);
              else
                tma_load_4d(dst + t * kTile, &tx, x_full(k, s), col, 0, h, r);
            }
          }
        }
      }
    }
    return;
  }

  // a consumer: its units one after the other
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const uint32_t region = base + cw * C::WG_BYTES;
  uint8_t* const gregion = gbase + cw * C::WG_BYTES;
  float* const cs_s = reinterpret_cast<float*>(gregion + C::CS_OFF);  // [head][position], log2 units
  const bool two = p.Q > 64;  // rows 64-127 hold a real row
  const bool heads_fast = p.as_h == 1;
  int cb_it = 0, x_it = 0;
  for (int u = 2 * (int)blockIdx.x + cw; u < p.units; u += slots) {
    const int r = u / p.blocks_per_row, h0 = u % p.blocks_per_row * p.head_block;
    const int nh = min(p.head_block, p.heads - h0);

    // the unit's decays: loaded now, stored after the scores (heads
    // fastest where they are a's contiguous dimension)
    float av[kMaxHeadBlock];
#pragma unroll
    for (int q = 0; q < kMaxHeadBlock; ++q) {
      const int e = tid + 128 * q;
      const int hh = heads_fast ? e % kMaxHeadBlock : e / kQ, i = heads_fast ? e / kMaxHeadBlock : e % kQ;
      av[q] = 0.f;
      if (hh < nh && i < p.Q) {
        const long long off = (long long)r * p.as_r + (long long)(h0 + hh) * p.as_h + (long long)i * p.as_i;
        av[q] = p.a_bf16 ? __bfloat162float(static_cast<const bf16*>(p.a)[off]) : static_cast<const float*>(p.a)[off];
      }
    }

    // the scores S = c.b^T, rows 0-63 (columns 0-63) in s0, rows 64-127
    // (columns 0-127) in s1, over the column blocks of b and c in order
    float s0[32], s1[64];
#pragma unroll
    for (int i = 0; i < 32; ++i) s0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s1[i] = 0.f;
    for (int n = 0; n < nk; ++n, ++cb_it) {
      const int s = cb_it % C::CB_STAGES;
      const uint32_t st = region + s * C::CB_BYTES;
      uint8_t* const gst = gregion + s * C::CB_BYTES;
      if (p.tma) {
        mbar_wait(cb_full(cw, s), (cb_it / C::CB_STAGES) & 1);
        if (!C::BF16) wg_sync(cw);  // every warp's products are done with the lo halves
      } else {
        wg_sync(cw);  // every warp's products are done with this stage
        copy_tile<T>(gst, static_cast<const T*>(p.c) + (long long)r * p.cs_r, p.cs_i, p.Q, n * C::CW, p.N, tid);
        copy_tile<T>(gst + kTile, static_cast<const T*>(p.b) + (long long)r * p.bs_r, p.bs_i, p.Q, n * C::CW, p.N,
                     tid);
        fence_proxy_async();
        wg_sync(cw);
      }
      const uint32_t c_hi = st, b_hi = st + kTile;
      if constexpr (C::BF16) {
        fence_regs(s0);
        fence_regs(s1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = smem_desc(b_hi + 32 * kk, 16, 1024);
          wgmma_ss_bf16_n64(s0, smem_desc(c_hi + 32 * kk, 16, 1024), db, 1);
          if (two) wgmma_ss_bf16_n128(s1, smem_desc(c_hi + 64 * 128 + 32 * kk, 16, 1024), db, 1);
        }
      } else {
        // the stage split once: TF32 hi in place, lo beside it
        split_tf32_tile(gst, gregion + C::CB_STAGES * C::CB_BYTES, C::CB_BYTES, tid);
        fence_proxy_async();
        wg_sync(cw);
        const uint32_t c_lo = region + C::CB_STAGES * C::CB_BYTES, b_lo = c_lo + kTile;
        fence_regs(s0);
        fence_regs(s1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dbh = smem_desc(b_hi + 32 * kk, 16, 1024), dbl = smem_desc(b_lo + 32 * kk, 16, 1024);
          wgmma_ss_tf32_n64(s0, smem_desc(c_lo + 32 * kk, 16, 1024), dbh, 1);
          wgmma_ss_tf32_n64(s0, smem_desc(c_hi + 32 * kk, 16, 1024), dbl, 1);
          wgmma_ss_tf32_n64(s0, smem_desc(c_hi + 32 * kk, 16, 1024), dbh, 1);
          if (two) {
            wgmma_ss_tf32_n128(s1, smem_desc(c_lo + 64 * 128 + 32 * kk, 16, 1024), dbh, 1);
            wgmma_ss_tf32_n128(s1, smem_desc(c_hi + 64 * 128 + 32 * kk, 16, 1024), dbl, 1);
            wgmma_ss_tf32_n128(s1, smem_desc(c_hi + 64 * 128 + 32 * kk, 16, 1024), dbh, 1);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s0);
      fence_regs(s1);
      // the next unit's b and c may load into this stage; f32 keeps the
      // unit's last one, where x^T's hi goes under its heads
      if (p.tma && (C::BF16 || n + 1 < nk)) {
        __syncwarp();
        if (lane == 0) mbar_arrive(cb_empty(cw, s));
      }
    }

    // cs = cumsum(a) in log2 units: a warp a head, 4 positions a lane, a
    // shuffle scan across the lanes
    wg_sync(cw);  // every warp is done with the last unit's decays
#pragma unroll
    for (int q = 0; q < kMaxHeadBlock; ++q) {
      const int e = tid + 128 * q;
      const int hh = heads_fast ? e % kMaxHeadBlock : e / kQ, i = heads_fast ? e / kMaxHeadBlock : e % kQ;
      cs_s[hh * kQ + i] = av[q];
    }
    wg_sync(cw);
    for (int hh = warp; hh < nh; hh += 4) {
      float* row = cs_s + hh * kQ + 4 * lane;
      const float4 a4 = *reinterpret_cast<const float4*>(row);
      const float in[4] = {a4.x, a4.y, a4.z, a4.w};
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * lane + k < p.Q) run += in[k];
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
      *reinterpret_cast<float4*>(row) =
          make_float4((excl + v[0]) * kLog2e, (excl + v[1]) * kLog2e, (excl + v[2]) * kLog2e, (excl + v[3]) * kLog2e);
    }
    wg_sync(cw);

    // each head: M = exp(cs_i - cs_j) * S and y = M.x, a 64-column block
    // of x at a time
    for (int hh = 0; hh < nh; ++hh) {
      const float* csh = cs_s + hh * kQ;
      float* yh = p.y + (long long)r * p.ys_r + (long long)(h0 + hh) * p.ys_h;
      for (int xb = 0; xb < nxb; ++xb, ++x_it) {
        const int s = x_it % C::X_STAGES;
        const uint32_t xs = region + C::X_OFF + s * C::X_BYTES;
        uint8_t* const gxs = gregion + C::X_OFF + s * C::X_BYTES;
        if (p.tma) {
          mbar_wait(x_full(cw, s), (x_it / C::X_STAGES) & 1);
        } else {
          wg_sync(cw);  // every warp's products are done with this stage
          const T* src = static_cast<const T*>(p.x) + (long long)r * p.xs_r + (long long)(h0 + hh) * p.xs_h;
#pragma unroll
          for (int t = 0; t < C::X_TILES; ++t)
            copy_tile<T>(gxs + t * kTile, src, p.xs_i, p.Q, 64 * xb + C::CW * t, p.hd, tid);
          fence_proxy_async();
          wg_sync(cw);
        }
        if constexpr (C::BF16) {
          if (two) mx_bf16<1>(s1, csh, xs, yh, xb, p, warp, g, t4);
          mx_bf16<0>(s0, csh, xs, yh, xb, p, warp, g, t4);
          if (p.tma) {
            __syncwarp();
            if (lane == 0) mbar_arrive(x_empty(cw, s));
          }
        } else {
          // x^T split once for the four warps, hi into the b/c stage (its
          // scores are done), lo where its lo halves were; then the x stage
          // may load the next block under this one's products
          const uint32_t xhi = region, xlo = region + C::CB_STAGES * C::CB_BYTES;
          if (p.tma) wg_sync(cw);  // every warp's products are done with the last block's x^T
          transpose_split_x(gxs, gregion, gregion + C::CB_STAGES * C::CB_BYTES, tid);
          fence_proxy_async();  // the writes for wgmma
          wg_sync(cw);
          if (p.tma && lane == 0) mbar_arrive(x_empty(cw, s));
          if (two) mx_tf32<1>(s1, csh, xhi, xlo, yh, xb, p, warp, g, t4);
          mx_tf32<0>(s0, csh, xhi, xlo, yh, xb, p, warp, g, t4);
        }
      }
    }
    if (!C::BF16 && p.tma) {  // the unit's last b/c stage, held for x^T, is free
      __syncwarp();
      if (lane == 0) mbar_arrive(cb_empty(cw, (cb_it - 1) % C::CB_STAGES));
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
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a map of `rank` dimensions (the first contiguous) in boxes of one 128-byte
// column block by 128 positions, 128-byte swizzled; out of bounds reads as
// zeros. dims and box innermost first; strides in bytes for dims 1..rank-1.
bool encode(EncodeTiled enc, CUtensorMap* map, int esize, int rank, const void* ptr, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return enc(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a stride TMA takes: a multiple of 16 bytes below 2^40; a dimension of
// extent 1 is never stepped, so its stride is replaced by `fallback`
bool tma_stride(long long stride, int extent, int esize, long long fallback, cuuint64_t* out) {
  const long long bytes = (extent == 1 ? fallback : stride) * esize;
  *out = (cuuint64_t)bytes;
  return bytes > 0 && bytes % 16 == 0 && bytes < (1ll << 40);
}

// The maps of x, b and c: 0 with the maps encoded (the TMA route), 1 where
// TMA cannot take a tensor (a base off 16 bytes, a stride not a multiple of
// 16 bytes: the copy route), or a CUDA error: cudaErrorNotSupported without
// the encoder, cudaErrorInvalidValue where the encoder refuses a map whose
// bases and strides TMA takes.
template <typename T>
int tensor_maps(EncodeTiled enc, Params& p, CUtensorMap* tx, CUtensorMap* tb, CUtensorMap* tc) {
  constexpr int es = (int)sizeof(T), CW = 128 / es;
  if (!enc) return (int)cudaErrorNotSupported;
  if ((uintptr_t)p.x % 16 || (uintptr_t)p.b % 16 || (uintptr_t)p.c % 16) return 1;
  cuuint64_t sb[2], sc[2], sx[3];
  const long long qs = (long long)p.Q;
  if (!tma_stride(p.bs_i, p.Q, es, p.N, &sb[0]) || !tma_stride(p.bs_r, p.R, es, qs * p.bs_i, &sb[1]) ||
      !tma_stride(p.cs_i, p.Q, es, p.N, &sc[0]) || !tma_stride(p.cs_r, p.R, es, qs * p.cs_i, &sc[1]))
    return 1;
  // x: (hd, heads, Q, R) where a head's rows are further apart than its
  // neighbour's (the model's sequence layout), else (hd, Q, heads, R): the
  // strides ascending either way
  p.x_heads_inner = p.heads > 1 && p.xs_h < p.xs_i;
  const cuuint32_t box4[4] = {(cuuint32_t)CW, p.x_heads_inner ? 1u : (cuuint32_t)kQ, p.x_heads_inner ? (cuuint32_t)kQ : 1u, 1};
  cuuint64_t dx[4] = {(cuuint64_t)p.hd, 0, 0, (cuuint64_t)p.R};
  bool ok;
  if (p.x_heads_inner) {
    dx[1] = p.heads;
    dx[2] = p.Q;
    ok = tma_stride(p.xs_h, p.heads, es, p.hd, &sx[0]) && tma_stride(p.xs_i, p.Q, es, p.heads * p.xs_h, &sx[1]) &&
         tma_stride(p.xs_r, p.R, es, qs * p.xs_i, &sx[2]);
  } else {
    dx[1] = p.Q;
    dx[2] = p.heads;
    ok = tma_stride(p.xs_i, p.Q, es, p.hd, &sx[0]) && tma_stride(p.xs_h, p.heads, es, qs * p.xs_i, &sx[1]) &&
         tma_stride(p.xs_r, p.R, es, p.heads * p.xs_h, &sx[2]);
  }
  if (!ok) return 1;
  const cuuint64_t dbc[3] = {(cuuint64_t)p.N, (cuuint64_t)p.Q, (cuuint64_t)p.R};
  const cuuint32_t box3[3] = {(cuuint32_t)CW, (cuuint32_t)kQ, 1};
  if (!encode(enc, tb, es, 3, p.b, dbc, sb, box3) || !encode(enc, tc, es, 3, p.c, dbc, sc, box3) ||
      !encode(enc, tx, es, 4, p.x, dx, sx, box4))
    return (int)cudaErrorInvalidValue;
  return 0;
}

unsigned long long g_copy_launches = 0;  // launches that took the copy route

int sm_count(int* sms) {
  static int cached = 0;
  if (!cached) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = cached;
  return 0;
}

// The work split: the head block H (at most kMaxHeadBlock) that takes the
// fewest waves of the card's 2 x sms consumers, a unit's cost counted as its
// H heads plus one for its scores; units = R x ceil(heads / H) and the grid
// min(sms, ceil(units / 2)) blocks.
void plan(int R, int heads, int sms, int* H, int* per_row, long long* units, int* blocks) {
  const long long slots = 2ll * sms;
  long long best = -1;
  for (int h = 1; h <= (heads < kMaxHeadBlock ? heads : kMaxHeadBlock); ++h) {
    const long long n = (long long)R * ((heads + h - 1) / h);
    const long long cost = (n + slots - 1) / slots * (h + 1);
    if (best < 0 || cost < best) {
      best = cost;
      *H = h;
    }
  }
  *per_row = (heads + *H - 1) / *H;
  *units = (long long)R * *per_row;
  const long long b = (*units + 1) / 2;
  *blocks = (int)(b < sms ? b : sms);
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  using C = Cfg<T>;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  long long units = 0;
  int blocks = 0;
  plan(p.R, p.heads, sms, &p.head_block, &p.blocks_per_row, &units, &blocks);
  if (units >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  CUtensorMap tx, tb, tc;
  memset(&tx, 0, sizeof(tx));
  memset(&tb, 0, sizeof(tb));
  memset(&tc, 0, sizeof(tc));
  p.x_heads_inner = 0;
  const int maps = tensor_maps<T>(tensor_map_encoder(), p, &tx, &tb, &tc);
  if (maps > 1) return maps;
  p.tma = maps == 0;
  static bool opted_in = false;  // one attribute call per instantiation
  if (!opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  ssd_chunk_kernel<T><<<blocks, kThreads, C::SMEM, stream>>>(tx, tb, tc, p);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && !p.tma) ++g_copy_launches;
  return (int)e;
}

// the launch layout of a dtype at R rows of `heads` heads: rows a tile,
// columns of b and c a stage, b/c and x ring stages, the head block, work
// units, blocks, threads, dynamic shared memory (bytes), and the compiled
// kernel's registers a thread at launch and local (spilled) bytes
template <typename T>
int layout(int R, int heads, int* out) {
  using C = Cfg<T>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ssd_chunk_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  int H = 0, per_row = 0, blocks = 0;
  long long units = 0;
  plan(R, heads, sms, &H, &per_row, &units, &blocks);
  const int vals[11] = {kQ, C::CW, C::CB_STAGES, C::X_STAGES, H, (int)units, blocks, kThreads, C::SMEM,
                        attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace

extern "C" {

// y[r, h, i, d] for r < R, h < heads, i < Q, d < hd (f32, 8-byte aligned,
// even strides); x (R, heads, Q, hd) and b, c (R, Q, N) of dtype 0
// (float32) or 1 (bfloat16); a (R, heads, Q) of a_dtype (the same codes).
// strides: 13 element strides, x, y and a by (row, head, position), then b
// and c by (row, position); the last dimension of x, y, b and c is
// contiguous. Q a multiple of 8 up to 128, hd a multiple of 4 up to 128,
// N >= 1. y must not alias an input.
int repro_ssd_chunk(void* y, const void* x, const void* a, const void* b, const void* c, int R, int heads, int Q,
                    int hd, int N, int dtype, int a_dtype, const long long* strides, void* stream) {
  if (R < 1 || heads < 1 || Q < 8 || Q > kQ || Q % 8 || hd < 4 || hd > kMaxHd || hd % 4 || N < 1 || dtype < 0 ||
      dtype > 1 || a_dtype < 0 || a_dtype > 1 || !strides)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y = (float*)y;
  p.x = x;
  p.a = a;
  p.b = b;
  p.c = c;
  long long* s[13] = {&p.xs_r, &p.xs_h, &p.xs_i, &p.ys_r, &p.ys_h, &p.ys_i, &p.as_r,
                      &p.as_h, &p.as_i, &p.bs_r, &p.bs_i, &p.cs_r, &p.cs_i};
  for (int i = 0; i < 13; ++i) *s[i] = strides[i];
  if ((uintptr_t)y % 8 || p.ys_r % 2 || p.ys_h % 2 || p.ys_i % 2) return (int)cudaErrorMisalignedAddress;
  p.R = R;
  p.heads = heads;
  p.Q = Q;
  p.hd = hd;
  p.N = N;
  p.a_bf16 = a_dtype;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(p, st);
  return launch<bf16>(p, st);
}

// The launches so far that took the copy route (a tensor TMA cannot take).
unsigned long long repro_ssd_chunk_copy_launches() { return g_copy_launches; }

// The launch layout of a dtype at R rows of `heads` heads into out[11] (see
// layout above); returns 0 or a CUDA error.
int repro_ssd_chunk_layout(int dtype, int R, int heads, int* out) {
  if (R < 1 || heads < 1 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  return dtype == 0 ? layout<float>(R, heads, out) : layout<bf16>(R, heads, out);
}

}  // extern "C"
