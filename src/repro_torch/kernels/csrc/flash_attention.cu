// Causal / sliding-window flash attention (forward), written for Hopper
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
// per byte at D 64, far above the card's byte rate. This kernel runs on the
// CUDA cores in f32, so it cannot beat the f32 line (67 TFLOP/s); the bf16
// tensor-core line (989 TFLOP/s) is the bound of the work itself.
//
// Design: one block of 128 threads per (query tile of 64 rows, head,
// batch), the heaviest causal tiles first. The query tile is staged once
// in shared memory, transposed; each KV tile in its range is staged in
// turn (k transposed, v as it is), converted to f32. The range comes from
// the masks: [max(0, q0 - window + 1), min(S, q0 + 64)) under both, so KV
// tiles masked for the whole query tile are never visited (half of them
// at S 16384, window 8192). A thread owns 8 query rows x 4 keys of a score
// tile (keys strided by 16, so that 16 lanes read 16 neighbouring words)
// and 8 rows x D/16 columns of the accumulator; the 16 lanes that share
// rows reduce the row max and sum with shuffles. p goes through shared
// memory (transposed) to the p.v product, in f32, as the TPU kernel keeps
// it. A row whose first visited tile is wholly masked for it holds
// m = -1e30 and junk in l and acc until its first real score: then
// alpha = exp(-1e30 - m) = 0 erases the junk, as on the TPU. Keys past S
// (a ragged last tile) are read as zeros and masked; rows past S are not
// written. Multiply-adds are explicit fmaf (the build turns off
// contraction, which only the bit-exact kernels need).
//
// Shared memory: 66 KB at D 64, 116 KB at D 128 (dynamic, opted in).
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.

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

}  // namespace

extern "C" {

// out, q: (B, S, H, D); k, v: (B, S, KVH, D); contiguous, all of dtype 0
// (float32) or 1 (bfloat16). D 64 or 128; H a multiple of KVH; window 0
// for none, else >= 1. scale is 1/sqrt(D) in float32. out must not alias
// an input.
int repro_flash_attention(void* out, const void* q, const void* k, const void* v, int B, int S,
                          int H, int KVH, int D, int causal, int window, int dtype, float scale,
                          void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535 || KVH < 1 || H % KVH || window < 0 ||
      dtype < 0 || dtype > 1 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (D == 64) return launch<float, 64>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
    return launch<float, 128>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  }
  if (D == 64) return launch<__nv_bfloat16, 64>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
  return launch<__nv_bfloat16, 128>(out, q, k, v, B, S, H, KVH, causal, window, scale, s);
}

}  // extern "C"
