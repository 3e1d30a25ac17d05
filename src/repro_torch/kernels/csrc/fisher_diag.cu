// Momentum diag-FIM update of FibecFed's local parameter selection (paper
// §4.2, §4.3.2), written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/fisher_diag.py::fisher_diag_update_2d (_kernel)
//
// Per element, f32 compute and f32 out:
//   out = γ·fim + ((1-γ)·g)·g
// g is f32 or bf16 and fim f32 or bf16 (the wrapper turns any other float
// into f32 first, as the plain version does). γ and 1-γ are rounded to f32
// on the host, as PyTorch rounds a Python scalar for an f32 tensor. Built
// with -fmad=false (kernels/build.py) so that no multiply-add is contracted:
// the kernel equals the plain PyTorch version bit for bit.
//
// Bound: memory. Per element it reads g and fim and writes out (12 bytes in
// f32) for 4 flops, far below the H100's ~20 f32 flops per byte of HBM
// bandwidth, so the least time is bytes / 3.35 TB/s. Design: one grid-stride
// pass over the flattened leaf, four elements per thread and step with
// 16-byte loads and stores where every pointer is aligned for them (8-byte
// loads of bf16), elementwise otherwise and for the tail. A leaf that stacks
// k clients is just a longer leaf: there are no per-client scalars. One
// launch per leaf; g², the TPU kernel's point, never reaches device memory.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch. out must not alias g or fim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive values as f32, from a 16-byte (f32) or 8-byte (bf16) load
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

__device__ __forceinline__ float update(float f, float g, float mom, float omm) {
  return mom * f + (omm * g) * g;
}

template <typename G, typename F>
__global__ void fisher_diag_kernel(float* __restrict__ out, const G* __restrict__ g,
                                   const F* __restrict__ fim, int64_t n, float mom, float omm,
                                   bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      float gv[4], fv[4];
      load4(g + 4 * i, gv);
      load4(fim + 4 * i, fv);
      float4 o;
      o.x = update(fv[0], gv[0], mom, omm);
      o.y = update(fv[1], gv[1], mom, omm);
      o.z = update(fv[2], gv[2], mom, omm);
      o.w = update(fv[3], gv[3], mom, omm);
      *reinterpret_cast<float4*>(out + 4 * i) = o;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = update(to_f32(fim[i]), to_f32(g[i]), mom, omm);
}

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p % bytes) == 0; }

template <typename G, typename F>
int launch(float* out, const void* g, const void* fim, int64_t n, float mom, float omm,
           cudaStream_t stream) {
  const bool vec = aligned(out, 16) && aligned(g, 4 * sizeof(G)) && aligned(fim, 4 * sizeof(F));
  const int64_t work = vec ? (n + 3) / 4 : n;
  const int64_t b = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(b < kMaxBlocks ? b : kMaxBlocks);
  fisher_diag_kernel<G, F><<<blocks, kThreads, 0, stream>>>(out, (const G*)g, (const F*)fim, n,
                                                           mom, omm, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out: n float32 values; g, fim: n contiguous values of dtype 0 (float32) or
// 1 (bfloat16). mom = γ and omm = 1-γ, each rounded to float32.
int repro_fisher_diag(void* out, const void* g, const void* fim, int64_t n, int g_dtype,
                      int fim_dtype, float mom, float omm, void* stream) {
  if (n <= 0 || g_dtype < 0 || g_dtype > 1 || fim_dtype < 0 || fim_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  if (g_dtype == 0 && fim_dtype == 0) return launch<float, float>(o, g, fim, n, mom, omm, s);
  if (g_dtype == 0) return launch<float, __nv_bfloat16>(o, g, fim, n, mom, omm, s);
  if (fim_dtype == 0) return launch<__nv_bfloat16, float>(o, g, fim, n, mom, omm, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(o, g, fim, n, mom, omm, s);
}

}  // extern "C"
