// Fused fake-quantize / top-k round trip of FibecFed's compressed upload
// channel, with error feedback, written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/compress.py::fake_compress_2d (_compress_kernel)
//
// Per value x (the GAL delta plus the carried residual, f32 compute):
//   s    = per-leaf scale (top-k) or absmax(group)·(1/qmax) (int8/int4),
//          where a group is 128 consecutive values of one client's flattened
//          leaf (the wire format's QUANT_GROUP; the last group may be short);
//          1/qmax is rounded to f32 first, as XLA computes the reference's
//          absmax/qmax
//   inv  = s > 0 ? 1/s : 0
//   y    = clip(rint(x·inv), -qmax, qmax)·s      (qmax = 0: y = x)
//   y    = |x| >= thresh ? y : 0                 (top-k only)
//   out  = y in the leaf's dtype,   residual = (x - y) in the leaf's dtype
// rint rounds half to even, as jnp.round does; the residual is taken from
// the f32 y before y is cast. The per-client threshold and top-k scale need
// a sort over the whole leaf, so the wrapper computes them and passes one
// row [thresh, scale] per client, as the TPU kernel's SMEM row.
//
// Bound: memory. Per value the kernel reads x and writes y and the residual
// (12 bytes in f32) for a handful of flops, far below the H100's ~20 f32
// flops per byte of HBM bandwidth, so the least time is bytes / 3.35 TB/s.
// Design: one warp per 128-value group, four values per lane with
// neighbouring lanes on neighbouring addresses; the group's absmax is a
// shuffle reduction in registers, so every value is read once and each
// output written once, with nothing between in device memory. Warps stride
// over the groups of all clients of a stacked leaf in one launch; each
// client's leaf starts its groups afresh.
//
// Build with -fmad=false (kernels/build.py) and without fast math: the
// division and the multiplies then round as the plain PyTorch version's do.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 16;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, bool QUANT, bool PER_LEAF_SCALE, bool USE_THRESH>
__global__ void fake_compress_kernel(T* y_out, T* r_out, const T* x, const float* scal,
                                     int64_t per_client, int64_t groups_per_client,
                                     int64_t total_groups, float qmax, float inv_qmax) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t gid = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       gid < total_groups; gid += n_warps) {
    const int64_t c = gid / groups_per_client;
    const int64_t start = (gid - c * groups_per_client) * kGroup;
    const int64_t rest = per_client - start;
    const int len = rest < kGroup ? (int)rest : kGroup;
    const int64_t base = c * per_client + start;

    float v[kGroup / 32];
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < kGroup / 32; ++j) {
      const int idx = lane + 32 * j;
      v[j] = idx < len ? to_f32(x[base + idx]) : 0.0f;
      amax = fmaxf(amax, fabsf(v[j]));
    }

    float scale = 0.0f, inv = 0.0f;
    if (QUANT) {
      if (PER_LEAF_SCALE) {
        scale = scal[2 * c + 1];
      } else {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        scale = amax * inv_qmax;
      }
      const float safe = scale > 0.0f ? scale : 1.0f;
      inv = scale > 0.0f ? 1.0f / safe : 0.0f;
    }
    const float thresh = USE_THRESH ? scal[2 * c] : 0.0f;

#pragma unroll
    for (int j = 0; j < kGroup / 32; ++j) {
      const int idx = lane + 32 * j;
      if (idx < len) {
        float yv = v[j];
        if (QUANT) {
          const float q = fminf(fmaxf(rintf(v[j] * inv), -qmax), qmax);
          yv = q * scale;
        }
        if (USE_THRESH) yv = fabsf(v[j]) >= thresh ? yv : 0.0f;
        y_out[base + idx] = from_f32<T>(yv);
        r_out[base + idx] = from_f32<T>(v[j] - yv);
      }
    }
  }
}

template <typename T>
int launch(void* y, void* r, const void* x, const float* scal, int64_t clients,
           int64_t per_client, int qmax, bool use_thresh, bool per_leaf_scale,
           cudaStream_t stream) {
  const int64_t gpc = (per_client + kGroup - 1) / kGroup;
  const int64_t total = clients * gpc;
  int64_t b = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = (int)(b < kMaxBlocks ? b : kMaxBlocks);
  const float q = (float)qmax;
  const float inv_q = qmax ? 1.0f / q : 0.0f;
#define REPRO_COMPRESS(QUANT, PLS, THR)                                                    \
  fake_compress_kernel<T, QUANT, PLS, THR><<<blocks, kThreads, 0, stream>>>(               \
      (T*)y, (T*)r, (const T*)x, scal, per_client, gpc, total, q, inv_q)
  if (qmax == 0) {
    if (use_thresh) REPRO_COMPRESS(false, false, true);
    else REPRO_COMPRESS(false, false, false);
  } else if (per_leaf_scale) {
    if (use_thresh) REPRO_COMPRESS(true, true, true);
    else REPRO_COMPRESS(true, true, false);
  } else {
    if (use_thresh) REPRO_COMPRESS(true, false, true);
    else REPRO_COMPRESS(true, false, false);
  }
#undef REPRO_COMPRESS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y, r: clients × per_client contiguous values of one dtype (0 = float32,
// 1 = bfloat16); scal: (clients, 2) float32 rows [thresh, scale]. y and r
// must not alias x.
int repro_fake_compress(void* y, void* r, const void* x, const void* scal, int64_t clients,
                        int64_t per_client, int dtype, int qmax, int use_thresh,
                        int per_leaf_scale, void* stream) {
  if (clients <= 0 || per_client <= 0 || qmax < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scal;
  if (dtype == 0)
    return launch<float>(y, r, x, sc, clients, per_client, qmax, use_thresh != 0,
                         per_leaf_scale != 0, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(y, r, x, sc, clients, per_client, qmax, use_thresh != 0,
                                 per_leaf_scale != 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
