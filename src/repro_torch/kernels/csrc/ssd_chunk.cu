// Mamba2 SSD intra-chunk kernel (the quadratic part of state-space
// duality within one chunk), written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_chunk.py::ssd_chunk_intra_kernel (_kernel)
//
// For each group g (batch x chunk x head), with cs = cumsum(a[g, 0, :]):
//   y[g, i, :] = sum_{j <= i} exp(cs_i - cs_j) * (c_i . b_j) * x[g, j, :]
// x (G, Q, hd), a (G, 1, Q), b and c (G, Q, N), y (G, Q, hd) in f32. x, b
// and c share one dtype, f32 or bf16; a is f32 or bf16. All arithmetic is
// f32: the decays reach exp(-200) and below, which bf16 cannot hold.
//
// Bound: memory. Per group it reads x, b, c once and writes y: at Q 128,
// N 128, hd 64 in f32 that is 192 KB for 3.2 MFLOP (the triangle only),
// about 17 flops per byte, under the H100's ~20 f32 flops per byte of HBM
// bandwidth on CUDA cores.
//
// Design: one block of 256 threads per group; nothing crosses blocks.
//   1. warp 0 scans a into cs (shared memory, f32).
//   2. scores: the (Q, Q) matrix is cut into 8x8 tiles, one per thread;
//      tiles above the diagonal are never computed (the triangle that the
//      TPU kernel masks with exp(NEG_INF)). c and b stream through shared
//      memory 32 columns of N at a time, stored transposed so that a
//      thread reads its 8 rows of c and 8 rows of b as 16-byte vectors.
//      Each tile becomes M[i][j] = exp(cs_i - cs_j) * (c_i . b_j) for
//      j <= i and 0 above the diagonal, stored transposed (mt[j][i]).
//   3. x is staged in the space that c and b used; each thread owns 8x4
//      output tiles and sums M[i][j] * x[j][:] over j up to its tile's last
//      row.
// Shared memory: cs, mt (Q x (Q+4) f32, 66 KB at Q 128) and the larger of
// the c/b chunks (33 KB) and x (Q x (hd+4), 34 KB at hd 64): about 100 KB
// at hd 64, 133 KB at hd 128, above the 48 KB of static shared memory, so
// the kernel opts in to dynamic shared memory. Multiply-adds are explicit
// fmaf (the build turns off contraction for the kernels that must equal
// their plain versions bit for bit; this one is held to a tolerance).
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;   // (kMaxQ / 8)^2 score tiles: one per thread
constexpr int kMaxHd = 128;
constexpr int kNChunk = 32;  // columns of b and c staged at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

int smem_bytes(int Q, int hd) {
  const int ld = Q + 4;
  const int chunks = 2 * kNChunk * ld;
  const int xs = Q * (hd + 4);
  return (Q + Q * ld + (chunks > xs ? chunks : xs)) * (int)sizeof(float);
}

template <typename T, typename TA>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(float* __restrict__ y, const T* __restrict__ x, const TA* __restrict__ a,
                 const T* __restrict__ b, const T* __restrict__ c, int Q, int hd, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = Q + 4;  // a multiple of 4 (Q % 8 == 0): rows stay 16-byte aligned
  const int ldx = hd + 4;
  float* cs = smem;
  float* mt = cs + Q;
  float* ct = mt + Q * ld;
  float* bt = ct + kNChunk * ld;
  float* xs = ct;  // x reuses the c/b chunks' space once the scores are done

  const int64_t g = blockIdx.x;
  const int tid = threadIdx.x;
  x += g * Q * hd;
  a += g * Q;
  b += g * Q * N;
  c += g * Q * N;
  y += g * Q * hd;

  // 1. cs = cumsum(a): 4 values per lane of warp 0, then a shuffle scan
  if (tid < 32) {
    float v[4], run = 0.f;
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * tid + k;
      run += i < Q ? to_f32(a[i]) : 0.f;
      v[k] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.f;
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * tid + k;
      if (i < Q) cs[i] = excl + v[k];
    }
  }

  // 2. scores on the lower-triangle tiles, N streamed in chunks
  const int nt = Q / 8;
  const int ti = tid / nt, tj = tid % nt;
  const bool active = tid < nt * nt && tj <= ti;
  float acc[8][8];
  for (int r = 0; r < 8; ++r)
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kNChunk) {
    const int nc = N - n0 < kNChunk ? N - n0 : kNChunk;
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < Q * kNChunk; e += kThreads) {
      const int i = e / kNChunk, n = e % kNChunk;
      const bool in = n < nc;
      const int64_t off = (int64_t)i * N + n0 + n;
      ct[n * ld + i] = in ? to_f32(c[off]) : 0.f;
      bt[n * ld + i] = in ? to_f32(b[off]) : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int n = 0; n < nc; ++n) {
        float cv[8], bv[8];
        load8(ct + n * ld + 8 * ti, cv);
        load8(bt + n * ld + 8 * tj, bv);
        for (int r = 0; r < 8; ++r)
          for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
      }
    }
  }
  if (active) {
    for (int s = 0; s < 8; ++s) {
      const int j = 8 * tj + s;
      const float csj = cs[j];
      float m[8];
      for (int r = 0; r < 8; ++r) {
        const int i = 8 * ti + r;
        m[r] = j <= i ? expf(cs[i] - csj) * acc[r][s] : 0.f;
      }
      float* row = mt + j * ld + 8 * ti;
      *reinterpret_cast<float4*>(row) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(m[4], m[5], m[6], m[7]);
    }
  }
  __syncthreads();  // mt complete; the chunks' space is free

  // 3. y = M @ x over the lower triangle
  for (int e = tid; e < Q * hd; e += kThreads) {
    const int j = e / hd, d = e % hd;
    xs[j * ldx + d] = to_f32(x[e]);
  }
  __syncthreads();
  const int ntd = hd / 4;
  for (int tile = tid; tile < nt * ntd; tile += kThreads) {
    const int oi = tile / ntd, od = tile % ntd;
    float o[8][4];
    for (int r = 0; r < 8; ++r)
      for (int k = 0; k < 4; ++k) o[r][k] = 0.f;
    const int j_end = 8 * oi + 8;
    for (int j = 0; j < j_end; ++j) {
      float mv[8];
      load8(mt + j * ld + 8 * oi, mv);
      const float4 xv = *reinterpret_cast<const float4*>(xs + j * ldx + 4 * od);
      for (int r = 0; r < 8; ++r) {
        o[r][0] = fmaf(mv[r], xv.x, o[r][0]);
        o[r][1] = fmaf(mv[r], xv.y, o[r][1]);
        o[r][2] = fmaf(mv[r], xv.z, o[r][2]);
        o[r][3] = fmaf(mv[r], xv.w, o[r][3]);
      }
    }
    for (int r = 0; r < 8; ++r)
      *reinterpret_cast<float4*>(y + (int64_t)(8 * oi + r) * hd + 4 * od) =
          make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
  }
}

template <typename T, typename TA>
int launch(float* y, const void* x, const void* a, const void* b, const void* c, int64_t G, int Q,
           int hd, int N, cudaStream_t stream) {
  const int bytes = smem_bytes(Q, hd);
  static bool opted_in = false;  // one attribute call per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(kMaxQ, kMaxHd));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  ssd_chunk_kernel<T, TA><<<(unsigned)G, kThreads, bytes, stream>>>(
      y, (const T*)x, (const TA*)a, (const T*)b, (const T*)c, Q, hd, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y: (G, Q, hd) float32; x: (G, Q, hd), b and c: (G, Q, N), all of dtype
// 0 (float32) or 1 (bfloat16); a: (G, Q) of a_dtype (same codes). All
// contiguous. Q a multiple of 8 up to 128, hd a multiple of 4 up to 128,
// N >= 1. y must not alias an input.
int repro_ssd_chunk(void* y, const void* x, const void* a, const void* b, const void* c, int64_t G,
                    int Q, int hd, int N, int dtype, int a_dtype, void* stream) {
  if (G <= 0 || G > 0x7fffffff || Q < 8 || Q > kMaxQ || Q % 8 || hd < 4 || hd > kMaxHd || hd % 4 ||
      N < 1 || dtype < 0 || dtype > 1 || a_dtype < 0 || a_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* yo = (float*)y;
  if (dtype == 0 && a_dtype == 0) return launch<float, float>(yo, x, a, b, c, G, Q, hd, N, s);
  if (dtype == 0) return launch<float, __nv_bfloat16>(yo, x, a, b, c, G, Q, hd, N, s);
  if (a_dtype == 0) return launch<__nv_bfloat16, float>(yo, x, a, b, c, G, Q, hd, N, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(yo, x, a, b, c, G, Q, hd, N, s);
}

}  // extern "C"
