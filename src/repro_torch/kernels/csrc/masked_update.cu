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
// HBM bandwidth, so the least time is bytes / 3.35 TB/s. Both kernels do
// one pass: every input is read once and every output written once, with no
// intermediate in device memory.
//
// AdamW: one grid-stride launch per leaf. Its traced scalars ride in a
// 4-float device row [lr, active, m̂s, v̂s], as in the TPU kernel's SMEM row,
// so the host never waits on the step counter. A leaf may stack k clients
// along its leading axis (the vectorized engine's stacked client state): the
// row table is then (k, 4), one row per client, and element i reads the row
// of client i / (n / k). This is what JAX's vmap of the TPU kernel gives
// each client; one launch covers all k clients.
//
// SGD: one launch over all the leaves of a tree (a LoRA tree's 8 leaves:
// one launch per optimizer step, where a launch per leaf paid 8 launches of
// host work for 4 µs of device work). The kernel's parameter space holds a
// table of up to kMaxLeaves leaves (pointers p, g, p_out and the optional
// μ, μ_out, mask; element count; elements per client row; dtype) and the
// block -> (leaf, chunk) map as each leaf's first block: block b works on
// chunk b - block0[l] of the last leaf l with block0[l] <= b, kChunk
// elements. Nothing is uploaded per step; the host fills the table and
// makes one launch (a larger tree takes as many launches as the table
// needs). Leaves may mix f32 and bf16, masked and unmasked. Each chunk
// moves 16-byte vectors (4 f32 or 8 bf16 values of p and g, with their f32
// mask and μ) when every pointer of its leaf is 16-byte aligned, all of a
// thread's vectors loaded before any is computed; the tail of a leaf, and
// an unaligned leaf, go element by element. lr and active travel by value
// in the parameters when the caller gives numbers (the loop engine); a
// tensor lr or per-client active (the vectorized engine) sends the (k, 4)
// device row table instead, read per element as in AdamW.
//
// The arithmetic follows the plain PyTorch version term by term; build with
// -fmad=false so that no multiply-add is contracted and the two agree bit
// for bit. A frozen entry is written back from the raw input value.
//
// C interface (loaded with ctypes): each function returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for arguments it does not
// take. AdamW's outputs may alias their inputs (each thread reads an element
// before it writes it); SGD's may not (its loads run ahead of its stores).

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

// ---- SGD over a whole tree: one launch, a table of leaves in the parameters

constexpr int64_t kChunk = 4096;  // elements per block: 4 f32 or 2 bf16 vectors per thread
constexpr int kMaxLeaves = 32;   // leaves per launch: 2.3 KB of the 4 KB parameter space
constexpr int kLeafWords = 10;   // int64 words per leaf in the host table

struct SgdLeaf {
  const void* p;
  const void* g;
  void* p_out;
  const float* mu;  // null without momentum
  float* mu_out;
  const float* mask;  // null: dense update
  int64_t n;           // elements
  int64_t per_client;  // elements per row of the scalar table (n: one row)
  int block0;          // the leaf's first block
  int dtype;           // p and g: 0 float32, 1 bfloat16
};

struct SgdArgs {
  SgdLeaf leaf[kMaxLeaves];
  const float* scal;  // (k, 4) rows [lr, active, -, -], or null: lr, active below
  float lr, active, momentum;
  int n_leaves;
};

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ void row_scalars(const SgdArgs& a, const SgdLeaf& leaf, int64_t i, float& lr,
                                            bool& active) {
  if (a.scal == nullptr) {
    lr = a.lr;
    active = a.active != 0.0f;
  } else {
    const float* row = a.scal + 4 * (i / leaf.per_client);
    lr = __ldg(row);
    active = __ldg(row + 1) != 0.0f;
  }
}

// one element: the plain version's operations in its order
template <typename P>
__device__ __forceinline__ void sgd_elem(P p_raw, float g, float mk, float mu_raw, bool has_mask,
                                         bool has_mom, float lr, bool active, float momentum, P& p_new,
                                         float& mu_new) {
  const bool eff = active && (!has_mask || mk != 0.0f);
  if (has_mom) {
    if (eff) {
      mu_new = momentum * mu_raw + g;
      p_new = from_f32<P>(to_f32(p_raw) - lr * mu_new);
    } else {
      mu_new = mu_raw;
      p_new = p_raw;
    }
  } else {
    mu_new = mu_raw;
    p_new = eff ? from_f32<P>(to_f32(p_raw) - lr * g) : p_raw;
  }
}

template <typename P>
__device__ __forceinline__ void sgd_scalar(const SgdArgs& a, const SgdLeaf& leaf, int64_t i) {
  float lr;
  bool active;
  row_scalars(a, leaf, i, lr, active);
  const bool has_mask = leaf.mask != nullptr, has_mom = leaf.mu != nullptr;
  P p_new;
  float mu_new;
  sgd_elem<P>(static_cast<const P*>(leaf.p)[i], to_f32(static_cast<const P*>(leaf.g)[i]),
              has_mask ? leaf.mask[i] : 0.0f, has_mom ? leaf.mu[i] : 0.0f, has_mask, has_mom, lr, active,
              a.momentum, p_new, mu_new);
  static_cast<P*>(leaf.p_out)[i] = p_new;
  if (has_mom) leaf.mu_out[i] = mu_new;
}

template <typename P>
__device__ __forceinline__ void sgd_chunk(const SgdArgs& a, const SgdLeaf& leaf, int64_t start, int64_t end) {
  constexpr int V = 16 / sizeof(P);           // values per 16-byte vector of p
  constexpr int U = kChunk / (kThreads * V);  // vectors per thread
  const bool has_mask = leaf.mask != nullptr, has_mom = leaf.mu != nullptr;
  const bool vec = aligned16(leaf.p) && aligned16(leaf.g) && aligned16(leaf.p_out) &&
                   (!has_mask || aligned16(leaf.mask)) && (!has_mom || (aligned16(leaf.mu) && aligned16(leaf.mu_out)));
  int64_t tail = start;
  if (vec) {
    const int64_t vend = start + (end - start) / V * V;
    uint4 pr[U], gr[U];
    float mk[U][V], mu[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = start + (int64_t)(u * kThreads + threadIdx.x) * V;
      if (i < vend) {
        pr[u] = __ldg(reinterpret_cast<const uint4*>(static_cast<const P*>(leaf.p) + i));
        gr[u] = __ldg(reinterpret_cast<const uint4*>(static_cast<const P*>(leaf.g) + i));
#pragma unroll
        for (int h = 0; h < V; h += 4) {
          const float4 m4 = has_mask ? __ldg(reinterpret_cast<const float4*>(leaf.mask + i + h))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 u4 = has_mom ? __ldg(reinterpret_cast<const float4*>(leaf.mu + i + h))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
          mk[u][h] = m4.x; mk[u][h + 1] = m4.y; mk[u][h + 2] = m4.z; mk[u][h + 3] = m4.w;
          mu[u][h] = u4.x; mu[u][h + 1] = u4.y; mu[u][h + 2] = u4.z; mu[u][h + 3] = u4.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = start + (int64_t)(u * kThreads + threadIdx.x) * V;
      if (i >= vend) continue;
      float lr;
      bool active;
      row_scalars(a, leaf, i, lr, active);
      // a vector that crosses into the next client's row (rows shorter than
      // or not a multiple of V) reads each value's own row
      const bool one_row = a.scal == nullptr || (i + V - 1) / leaf.per_client == i / leaf.per_client;
      const P* pv = reinterpret_cast<const P*>(&pr[u]);
      const P* gv = reinterpret_cast<const P*>(&gr[u]);
      uint4 po;
      P* pn = reinterpret_cast<P*>(&po);
      float mn[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (!one_row) row_scalars(a, leaf, i + j, lr, active);
        sgd_elem<P>(pv[j], to_f32(gv[j]), mk[u][j], mu[u][j], has_mask, has_mom, lr, active, a.momentum,
                    pn[j], mn[j]);
      }
      *reinterpret_cast<uint4*>(static_cast<P*>(leaf.p_out) + i) = po;
      if (has_mom) {
#pragma unroll
        for (int h = 0; h < V; h += 4)
          *reinterpret_cast<float4*>(leaf.mu_out + i + h) = make_float4(mn[h], mn[h + 1], mn[h + 2], mn[h + 3]);
      }
    }
    tail = vend;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) sgd_scalar<P>(a, leaf, i);
}

__global__ void __launch_bounds__(kThreads) sgd_tree_kernel(const __grid_constant__ SgdArgs a) {
  int l = 0;
  while (l + 1 < a.n_leaves && a.leaf[l + 1].block0 <= (int)blockIdx.x) ++l;
  const SgdLeaf& leaf = a.leaf[l];
  const int64_t start = (int64_t)((int)blockIdx.x - leaf.block0) * kChunk;
  const int64_t end = start + kChunk < leaf.n ? start + kChunk : leaf.n;
  if (leaf.dtype == 0)
    sgd_chunk<float>(a, leaf, start, end);
  else
    sgd_chunk<__nv_bfloat16>(a, leaf, start, end);
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


// SGD(+momentum) over n_leaves leaves (1 to kMaxLeaves) in one launch.
// leaves: n_leaves rows of kLeafWords int64 words in host memory,
//   [p, g, p_out, mu, mu_out, mask, n, per_client, block0, dtype],
// pointers as integers (mu, mu_out and mask 0 for none; mu given for every
// leaf or for none), n > 0 elements, per_client dividing n, block0 the
// running sum of the leaves' ceil(n / chunk) blocks and grid their total.
// chunk must equal the kernel's kChunk. scal null: lr and active by value;
// else a (k, 4) float32 device table and each leaf's per_client = n / k.
int repro_masked_sgd_tree(const int64_t* leaves, int n_leaves, int64_t grid, int64_t chunk,
                          const void* scal, float lr, float active, float momentum, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || chunk != kChunk || grid < 1 || grid > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  SgdArgs a;
  a.n_leaves = n_leaves;
  a.scal = (const float*)scal;
  a.lr = lr;
  a.active = active;
  a.momentum = momentum;
  int64_t blocks = 0;
  const bool has_mom = leaves[3] != 0;
  for (int l = 0; l < n_leaves; ++l) {
    const int64_t* w = leaves + (int64_t)l * kLeafWords;
    SgdLeaf& leaf = a.leaf[l];
    leaf.p = (const void*)w[0];
    leaf.g = (const void*)w[1];
    leaf.p_out = (void*)w[2];
    leaf.mu = (const float*)w[3];
    leaf.mu_out = (float*)w[4];
    leaf.mask = (const float*)w[5];
    leaf.n = w[6];
    leaf.per_client = w[7];
    leaf.block0 = (int)w[8];
    leaf.dtype = (int)w[9];
    if (!leaf.p || !leaf.g || !leaf.p_out || (leaf.mu != nullptr) != has_mom ||
        (leaf.mu_out != nullptr) != has_mom || leaf.n <= 0 || leaf.per_client <= 0 ||
        leaf.n % leaf.per_client != 0 || w[8] != blocks || leaf.dtype < 0 || leaf.dtype > 1)
      return (int)cudaErrorInvalidValue;
    blocks += (leaf.n + kChunk - 1) / kChunk;
  }
  if (blocks != grid) return (int)cudaErrorInvalidValue;
  sgd_tree_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
