// Masked AdamW and masked SGD(+momentum) updates for FibecFed's sparse local
// step (paper §4.3.2), written for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/masked_update.py::masked_adamw_update_2d (_adamw_kernel)
//   src/repro/kernels/masked_update.py::masked_sgd_update_2d   (_sgd_kernel)
//
// With eff = mask ⊙ active:
//   adamw    m' = eff ? b1·m + (1-b1)·g : m,   v' = eff ? b2·v + (1-b2)·g·g : v
//            p' = eff ? p - (lr·(m'·m̂s) / (√(v'·v̂s) + ε) + (lr·wd)·p) : p
//   sgd      p' = eff ? p - lr·g : p
//   sgd+mom  μ' = eff ? momentum·μ + g : μ,   p' = eff ? p - lr·μ' : p
// Compute is f32; p (and g) are f32 or bf16, moments and mask f32, and each
// output keeps its input's dtype. A frozen entry is written back from the
// raw input value (a select), so it keeps its bits.
//
// Bound: memory. Per element AdamW reads p, g, m, v and the mask and writes
// p, m, v (32 bytes in f32); SGD reads p and g and writes p (12 bytes), plus
// μ read and written with momentum and the mask read with a mask. That is
// about 2 flops per byte, far below the H100's ~20 f32 flops per byte of
// HBM bandwidth, so the least time is bytes / 3.35 TB/s. The design does
// one pass: every input is read once and every output written once, with no
// intermediate in device memory. One grid-stride launch per leaf; a launch
// over all leaves at once is later work.
//
// The traced scalars ride in a 4-float device row [lr, active, m̂s, v̂s], as
// in the TPU kernel's SMEM row, so the host never waits on the step counter.
// A leaf may stack k clients along its leading axis (the vectorized engine's
// stacked client state): the row table is then (k, 4), one row per client,
// and element i reads the row of client i / (n / k). This is what JAX's vmap
// of the TPU kernel gives each client; one launch covers all k clients.
// The arithmetic follows the plain PyTorch version term by term; build with
// -fmad=false so that no multiply-add is contracted and the two agree.
//
// C interface (loaded with ctypes): each function returns cudaGetLastError()
// after its launch. Outputs may alias their inputs: each thread reads an
// element before it writes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks per SM

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

template <typename P, bool HAS_MASK, bool HAS_WD>
__global__ void adamw_kernel(P* p_out, const P* p, const P* g, float* m_out, const float* m,
                             float* v_out, const float* v, const float* mask,
                             const float* scal, int64_t n, int64_t per_client, float b1,
                             float omb1, float b2, float omb2, float eps, float wd) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float* row = scal + 4 * (i / per_client);
    const float lr = row[0];
    const bool active = row[1] != 0.0f;
    const float mhs = row[2];
    const float vhs = row[3];
    const float lr_wd = lr * wd;
    const P p_raw = p[i];
    const float m_raw = m[i];
    const float v_raw = v[i];
    bool eff = active;
    if (HAS_MASK) eff = eff && (mask[i] != 0.0f);
    if (eff) {
      const float pf = to_f32(p_raw);
      const float gf = to_f32(g[i]);
      const float m_new = b1 * m_raw + omb1 * gf;
      const float v_new = b2 * v_raw + omb2 * gf * gf;
      float step = lr * (m_new * mhs) / (sqrtf(v_new * vhs) + eps);
      if (HAS_WD) step = step + lr_wd * pf;
      p_out[i] = from_f32<P>(pf - step);
      m_out[i] = m_new;
      v_out[i] = v_new;
    } else {
      p_out[i] = p_raw;
      m_out[i] = m_raw;
      v_out[i] = v_raw;
    }
  }
}

template <typename P, bool HAS_MASK, bool HAS_MOM>
__global__ void sgd_kernel(P* p_out, const P* p, const P* g, float* mu_out, const float* mu,
                           const float* mask, const float* scal, int64_t n,
                           int64_t per_client, float momentum) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float* row = scal + 4 * (i / per_client);
    const float lr = row[0];
    const bool active = row[1] != 0.0f;
    const P p_raw = p[i];
    bool eff = active;
    if (HAS_MASK) eff = eff && (mask[i] != 0.0f);
    if (HAS_MOM) {
      const float mu_raw = mu[i];
      if (eff) {
        const float mu_new = momentum * mu_raw + to_f32(g[i]);
        p_out[i] = from_f32<P>(to_f32(p_raw) - lr * mu_new);
        mu_out[i] = mu_new;
      } else {
        p_out[i] = p_raw;
        mu_out[i] = mu_raw;
      }
    } else {
      p_out[i] = eff ? from_f32<P>(to_f32(p_raw) - lr * to_f32(g[i])) : p_raw;
    }
  }
}

inline int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename P>
void launch_adamw(void* p_out, const void* p, const void* g, float* m_out, const float* m,
                  float* v_out, const float* v, const float* mask, const float* scal,
                  int64_t n, int64_t per_client, float b1, float omb1, float b2, float omb2,
                  float eps, float wd, cudaStream_t stream) {
  const int blocks = blocks_for(n);
#define REPRO_ADAMW_ARGS                                                                 \
  (P*)p_out, (const P*)p, (const P*)g, m_out, m, v_out, v, mask, scal, n, per_client, b1, \
      omb1, b2, omb2, eps, wd
  if (mask != nullptr) {
    if (wd != 0.0f)
      adamw_kernel<P, true, true><<<blocks, kThreads, 0, stream>>>(REPRO_ADAMW_ARGS);
    else
      adamw_kernel<P, true, false><<<blocks, kThreads, 0, stream>>>(REPRO_ADAMW_ARGS);
  } else {
    if (wd != 0.0f)
      adamw_kernel<P, false, true><<<blocks, kThreads, 0, stream>>>(REPRO_ADAMW_ARGS);
    else
      adamw_kernel<P, false, false><<<blocks, kThreads, 0, stream>>>(REPRO_ADAMW_ARGS);
  }
#undef REPRO_ADAMW_ARGS
}

template <typename P>
void launch_sgd(void* p_out, const void* p, const void* g, float* mu_out, const float* mu,
                const float* mask, const float* scal, int64_t n, int64_t per_client,
                float momentum, cudaStream_t stream) {
  const int blocks = blocks_for(n);
#define REPRO_SGD_ARGS \
  (P*)p_out, (const P*)p, (const P*)g, mu_out, mu, mask, scal, n, per_client, momentum
  const bool has_mom = mu != nullptr;
  if (mask != nullptr) {
    if (has_mom)
      sgd_kernel<P, true, true><<<blocks, kThreads, 0, stream>>>(REPRO_SGD_ARGS);
    else
      sgd_kernel<P, true, false><<<blocks, kThreads, 0, stream>>>(REPRO_SGD_ARGS);
  } else {
    if (has_mom)
      sgd_kernel<P, false, true><<<blocks, kThreads, 0, stream>>>(REPRO_SGD_ARGS);
    else
      sgd_kernel<P, false, false><<<blocks, kThreads, 0, stream>>>(REPRO_SGD_ARGS);
  }
#undef REPRO_SGD_ARGS
}

}  // namespace

extern "C" {

// dtype codes for p (and g): 0 = float32, 1 = bfloat16. m, v and the mask are
// float32; mask may be null (dense update). scal is a (clients, 4) f32 table;
// n must split evenly into clients.
int repro_masked_adamw(void* p_out, const void* p, const void* g, void* m_out,
                       const void* m, void* v_out, const void* v, const void* mask,
                       const void* scal, int64_t n, int64_t clients, int p_dtype, float b1,
                       float omb1, float b2, float omb2, float eps, float wd, void* stream) {
  if (n <= 0 || clients <= 0 || n % clients != 0) return (int)cudaErrorInvalidValue;
  const int64_t pc = n / clients;
  cudaStream_t s = (cudaStream_t)stream;
  float* mo = (float*)m_out;
  float* vo = (float*)v_out;
  const float* mi = (const float*)m;
  const float* vi = (const float*)v;
  const float* mk = (const float*)mask;
  const float* sc = (const float*)scal;
  if (p_dtype == 0)
    launch_adamw<float>(p_out, p, g, mo, mi, vo, vi, mk, sc, n, pc, b1, omb1, b2, omb2, eps, wd, s);
  else if (p_dtype == 1)
    launch_adamw<__nv_bfloat16>(p_out, p, g, mo, mi, vo, vi, mk, sc, n, pc, b1, omb1, b2, omb2, eps, wd, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// mu/mu_out (float32) null: no momentum.
int repro_masked_sgd(void* p_out, const void* p, const void* g, void* mu_out,
                     const void* mu, const void* mask, const void* scal, int64_t n,
                     int64_t clients, int p_dtype, float momentum, void* stream) {
  if (n <= 0 || clients <= 0 || n % clients != 0) return (int)cudaErrorInvalidValue;
  const int64_t pc = n / clients;
  cudaStream_t s = (cudaStream_t)stream;
  float* muo = (float*)mu_out;
  const float* mui = (const float*)mu;
  const float* mk = (const float*)mask;
  const float* sc = (const float*)scal;
  if (p_dtype == 0)
    launch_sgd<float>(p_out, p, g, muo, mui, mk, sc, n, pc, momentum, s);
  else if (p_dtype == 1)
    launch_sgd<__nv_bfloat16>(p_out, p, g, muo, mui, mk, sc, n, pc, momentum, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
