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
//            m̂s = 1 / (1 - b1^t'), v̂s = 1 / (1 - b2^t'), t' = t + (active != 0)
//   sgd      p' = eff ? p - lr·g : p
//   sgd+mom  μ' = eff ? momentum·μ + g : μ,   p' = eff ? p - lr·μ' : p
// Compute is f32. Each tensor (p, g, m, v, μ) is f32 or bf16 on its own,
// the mask f32, and each output keeps its input's dtype: an updated moment
// is rounded to the moment's dtype, as the TPU kernel's
// .astype(out_ref.dtype) does, while p' uses the f32 moment. A frozen entry
// is written back as it was read (exact for both dtypes), so it keeps its
// bits.
//
// Bound: memory. Per element AdamW reads p, g, m, v and the mask and writes
// p, m, v (32 bytes in f32); SGD reads p and g and writes p (12 bytes), plus
// μ read and written with momentum and the mask read with a mask. That is
// about 2 flops per byte, far below the H100's ~20 f32 flops per byte of
// HBM bandwidth, so the least time is bytes / 3.35 TB/s. Both kernels do
// one pass: every input is read once and every output written once, with no
// intermediate in device memory.
//
// Design: one launch over all the leaves of a tree (a LoRA tree's 8 leaves:
// one launch per optimizer step, where a launch per leaf paid 8 launches of
// host work for a few µs of device work). The kernel's parameter space
// holds a table of up to kMaxLeaves leaves (their pointers, element count,
// elements per client row, first block and dtypes; __grid_constant__, so
// indexing it by leaf reads parameter space and copies nothing) and the
// block -> (leaf, client, chunk) map as each leaf's first block: leaf l owns
// the blocks from block0[l] on, and covers client row after client row in
// chunks of kChunk elements, a row's last chunk short. No chunk straddles
// two clients, so a block reads its client's scalars once. Nothing is
// uploaded per step; the host fills the table and makes one launch (a
// larger tree takes as many launches as the table needs). Leaves may mix
// dtypes and masked and dense leaves. A chunk moves vectors of 4 values
// (16 bytes of f32, 8 of bf16) when every pointer of its leaf is 16-byte
// aligned and the chunk starts on a multiple of 4, all of a thread's vectors
// loaded before any is computed; the tail of a chunk, and an unaligned leaf,
// go element by element.
//
// Scalars. SGD: lr and active by value when the caller gives numbers (the
// loop engine); a tensor lr or per-client active sends a (k, 4) device row
// table [lr, active, -, -] instead. AdamW: lr by value or by pointer (a 0-d
// tensor), active by value or by pointer with a stride (the vectorized
// engine's (k,) column of its step plan, read in place), and Adam's step
// counter t by pointer: each block computes its client's t' and bias
// scales as the plain version does (torch.pow on the card: powf), and
// block 0 writes t'. So a step makes no device op besides the launch.
//
// The arithmetic follows the plain PyTorch version term by term; build with
// -fmad=false so that no multiply-add is contracted and the two agree bit
// for bit.
//
// C interface (loaded with ctypes): each function returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for arguments it does not
// take. Outputs may not alias inputs (inputs go through the read-only cache).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 32;   // leaves per launch: 2.8 KB of the 4 KB parameter space
constexpr int kLeafWords = 12;   // int64 words per leaf in the host table
constexpr int64_t kSgdChunk = 4096;    // 4 vectors of 4 values per thread
constexpr int64_t kAdamwChunk = 2048;  // 2 vectors per thread: AdamW moves 5 tensors in

struct Leaf {
  const void* p;
  const void* g;
  const void* m;  // AdamW m; SGD μ (null without momentum)
  const void* v;  // AdamW v; null for SGD
  const float* mask;  // null: dense update
  void* p_out;
  void* m_out;
  void* v_out;
  int64_t n;           // elements
  int64_t per_client;  // elements per client row
  int block0;          // the leaf's first block
  uint8_t dp, dg, dm, dv;  // dtype codes: 0 float32, 1 bfloat16
};

struct SgdArgs {
  Leaf leaf[kMaxLeaves];
  const float* scal;  // (k, 4) rows [lr, active, -, -], or null: lr, active below
  float lr, active, momentum;
  int n_leaves;
};

struct AdamwArgs {
  Leaf leaf[kMaxLeaves];
  const float* lr_ptr;      // one f32, or null: lr below
  const float* active_ptr;  // client c's at active_ptr[c * active_stride], or null: active below
  const int* t;             // client c's step counter at t[c * t_stride]
  int* t_out;               // one entry per client
  int64_t active_stride, t_stride;
  float lr, active, b1, omb1, b2, omb2, eps, wd;
  int clients, n_leaves;
};

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ float bf16_to_f32(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

__device__ __forceinline__ uint32_t f32_to_bf16(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// 4 values at element i of a tensor of dtype code dt (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const void* base, int dt, int64_t i, float (&x)[4]) {
  if (dt == 0) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(base) + i));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(base) + i));
    x[0] = bf16_to_f32(v.x & 0xffffu); x[1] = bf16_to_f32(v.x >> 16);
    x[2] = bf16_to_f32(v.y & 0xffffu); x[3] = bf16_to_f32(v.y >> 16);
  }
}

__device__ __forceinline__ void store4(void* base, int dt, int64_t i, const float (&x)[4]) {
  if (dt == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    uint2 v;
    v.x = f32_to_bf16(x[0]) | (f32_to_bf16(x[1]) << 16);
    v.y = f32_to_bf16(x[2]) | (f32_to_bf16(x[3]) << 16);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + i) = v;
  }
}

__device__ __forceinline__ float load1(const void* base, int dt, int64_t i) {
  if (dt == 0) return __ldg(static_cast<const float*>(base) + i);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
}

__device__ __forceinline__ void store1(void* base, int dt, int64_t i, float x) {
  if (dt == 0)
    static_cast<float*>(base)[i] = x;
  else
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
}

// The block's chunk: its leaf, client row and [start, end) elements.
struct Chunk {
  int leaf;
  int64_t client, start, end;
};

template <int64_t kChunk>
__device__ __forceinline__ Chunk chunk_of_block(const Leaf* leaves, int n_leaves) {
  const int b = (int)blockIdx.x;
  int l = 0;
  while (l + 1 < n_leaves && leaves[l + 1].block0 <= b) ++l;
  const Leaf& leaf = leaves[l];
  const int64_t per_row = (leaf.per_client + kChunk - 1) / kChunk;
  const int64_t local = b - leaf.block0;
  const int64_t c = local / per_row;
  const int64_t start = c * leaf.per_client + (local - c * per_row) * kChunk;
  const int64_t row_end = (c + 1) * leaf.per_client;
  return {l, c, start, start + kChunk < row_end ? start + kChunk : row_end};
}

// One chunk of a leaf: load p, g, m, v, mask (those the leaf has), apply
// op to each element, store p, m, v. op(p, g, m, v, eff) updates p, m, v
// in place when eff; a frozen element is stored as it was loaded.
template <int64_t kChunk, bool kHasV, class Op>
__device__ __forceinline__ void update_chunk(const Leaf& leaf, int64_t start, int64_t end, bool active,
                                             const Op& op) {
  constexpr int U = (int)(kChunk / (kThreads * 4));  // vectors per thread
  const bool has_mask = leaf.mask != nullptr, has_m = leaf.m != nullptr;
  const bool vec = (start & 3) == 0 && aligned16(leaf.p) && aligned16(leaf.g) && aligned16(leaf.p_out) &&
                   (!has_mask || aligned16(leaf.mask)) &&
                   (!has_m || (aligned16(leaf.m) && aligned16(leaf.m_out))) &&
                   (!kHasV || (aligned16(leaf.v) && aligned16(leaf.v_out)));
  int64_t tail = start;
  if (vec) {
    const int64_t vend = start + (end - start) / 4 * 4;
    float p[U][4], g[U][4], m[U][4], v[U][4], mk[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = start + (int64_t)(u * kThreads + threadIdx.x) * 4;
      if (i < vend) {
        load4(leaf.p, leaf.dp, i, p[u]);
        load4(leaf.g, leaf.dg, i, g[u]);
        if (has_m) load4(leaf.m, leaf.dm, i, m[u]);
        if (kHasV) load4(leaf.v, leaf.dv, i, v[u]);
        if (has_mask) load4(leaf.mask, 0, i, mk[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = start + (int64_t)(u * kThreads + threadIdx.x) * 4;
      if (i >= vend) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool eff = active && (!has_mask || mk[u][j] != 0.0f);
        if (eff) op(p[u][j], g[u][j], m[u][j], v[u][j]);
      }
      store4(leaf.p_out, leaf.dp, i, p[u]);
      if (has_m) store4(leaf.m_out, leaf.dm, i, m[u]);
      if (kHasV) store4(leaf.v_out, leaf.dv, i, v[u]);
    }
    tail = vend;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
    float p = load1(leaf.p, leaf.dp, i), g = load1(leaf.g, leaf.dg, i);
    float m = has_m ? load1(leaf.m, leaf.dm, i) : 0.0f;
    float v = kHasV ? load1(leaf.v, leaf.dv, i) : 0.0f;
    const bool eff = active && (!has_mask || __ldg(leaf.mask + i) != 0.0f);
    if (eff) op(p, g, m, v);
    store1(leaf.p_out, leaf.dp, i, p);
    if (has_m) store1(leaf.m_out, leaf.dm, i, m);
    if (kHasV) store1(leaf.v_out, leaf.dv, i, v);
  }
}

// ---- SGD(+momentum)

struct SgdOp {
  float lr, momentum;
  bool has_mom;
  __device__ __forceinline__ void operator()(float& p, float g, float& mu, float&) const {
    if (has_mom) {
      mu = momentum * mu + g;
      p = p - lr * mu;
    } else {
      p = p - lr * g;
    }
  }
};

__global__ void __launch_bounds__(kThreads) sgd_tree_kernel(const __grid_constant__ SgdArgs a) {
  const Chunk ck = chunk_of_block<kSgdChunk>(a.leaf, a.n_leaves);
  const Leaf& leaf = a.leaf[ck.leaf];
  float lr = a.lr;
  bool active = a.active != 0.0f;
  if (a.scal != nullptr) {
    const float* row = a.scal + 4 * ck.client;
    lr = __ldg(row);
    active = __ldg(row + 1) != 0.0f;
  }
  update_chunk<kSgdChunk, false>(leaf, ck.start, ck.end, active, SgdOp{lr, a.momentum, leaf.m != nullptr});
}

// ---- AdamW

struct AdamwOp {
  float lr, mhs, vhs, b1, omb1, b2, omb2, eps, lr_wd;
  bool has_wd;
  __device__ __forceinline__ void operator()(float& p, float g, float& m, float& v) const {
    m = b1 * m + omb1 * g;
    v = b2 * v + omb2 * g * g;
    float step = lr * (m * mhs) / (sqrtf(v * vhs) + eps);
    if (has_wd) step = step + lr_wd * p;
    p = p - step;
  }
};

// client c's active flag and advanced step counter t' (t + 1 on an active step)
__device__ __forceinline__ bool client_active(const AdamwArgs& a, int64_t c) {
  return (a.active_ptr != nullptr ? __ldg(a.active_ptr + c * a.active_stride) : a.active) != 0.0f;
}

__device__ __forceinline__ int client_step(const AdamwArgs& a, int64_t c, bool active) {
  return __ldg(a.t + c * a.t_stride) + (active ? 1 : 0);
}

__global__ void __launch_bounds__(kThreads) adamw_tree_kernel(const __grid_constant__ AdamwArgs a) {
  if (blockIdx.x == 0) {
    for (int c = threadIdx.x; c < a.clients; c += kThreads) a.t_out[c] = client_step(a, c, client_active(a, c));
  }
  const Chunk ck = chunk_of_block<kAdamwChunk>(a.leaf, a.n_leaves);
  const Leaf& leaf = a.leaf[ck.leaf];
  const float lr = a.lr_ptr != nullptr ? __ldg(a.lr_ptr) : a.lr;
  const bool active = client_active(a, ck.client);
  // the plain version's 1.0 / (1.0 - b ** t'.to(float32)), operation by operation
  const float tf = (float)client_step(a, ck.client, active);
  const float mhs = 1.0f / (1.0f - powf(a.b1, tf));
  const float vhs = 1.0f / (1.0f - powf(a.b2, tf));
  const AdamwOp op{lr, mhs, vhs, a.b1, a.omb1, a.b2, a.omb2, a.eps, lr * a.wd, a.wd != 0.0f};
  update_chunk<kAdamwChunk, true>(leaf, ck.start, ck.end, active, op);
}

// Fill leaves[0, n_leaves) from the host table (see the C interface) and
// check it. Returns the grid, or -1 for a table the kernel does not take.
int64_t read_table(const int64_t* words, int n_leaves, int64_t chunk, bool adamw, Leaf* leaves) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return -1;
  const bool has_m = words[2] != 0;
  int64_t blocks = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const int64_t* w = words + (int64_t)l * kLeafWords;
    Leaf& leaf = leaves[l];
    leaf.p = (const void*)w[0];
    leaf.g = (const void*)w[1];
    leaf.m = (const void*)w[2];
    leaf.v = (const void*)w[3];
    leaf.mask = (const float*)w[4];
    leaf.p_out = (void*)w[5];
    leaf.m_out = (void*)w[6];
    leaf.v_out = (void*)w[7];
    leaf.n = w[8];
    leaf.per_client = w[9];
    leaf.block0 = (int)w[10];
    const int64_t codes = w[11];
    leaf.dp = (uint8_t)(codes & 0xff);
    leaf.dg = (uint8_t)((codes >> 8) & 0xff);
    leaf.dm = (uint8_t)((codes >> 16) & 0xff);
    leaf.dv = (uint8_t)((codes >> 24) & 0xff);
    const bool has_v = leaf.v != nullptr;
    if (!leaf.p || !leaf.g || !leaf.p_out || (leaf.m != nullptr) != has_m || (leaf.m_out != nullptr) != has_m ||
        (leaf.v_out != nullptr) != has_v || (adamw ? !(has_m && has_v) : has_v) || leaf.n <= 0 ||
        leaf.per_client <= 0 || leaf.n % leaf.per_client != 0 || w[10] != blocks || leaf.dp > 1 ||
        leaf.dg > 1 || leaf.dm > 1 || leaf.dv > 1 || (codes >> 32) != 0)
      return -1;
    blocks += leaf.n / leaf.per_client * ((leaf.per_client + chunk - 1) / chunk);
  }
  return blocks;
}

}  // namespace

extern "C" {

// The host table: n_leaves rows of kLeafWords int64 words in host memory,
//   [p, g, m, v, mask, p_out, m_out, v_out, n, per_client, block0, dtypes],
// pointers as integers (0 for none), n > 0 elements in rows of per_client,
// block0 the running sum of the leaves' (n / per_client) · ceil(per_client /
// chunk) blocks and grid their total, dtypes the codes of p, g, m, v in
// bytes 0-3 (0 float32, 1 bfloat16); the mask is float32. chunk must equal
// the kernel's.

// SGD(+momentum): m is μ (given for every leaf or for none), v is 0. scal
// null: lr and active by value; else a (k, 4) float32 device table, each
// leaf's per_client = n / k.
int repro_masked_sgd_tree(const int64_t* leaves, int n_leaves, int64_t grid, int64_t chunk,
                          const void* scal, float lr, float active, float momentum, void* stream) {
  SgdArgs a;
  if (chunk != kSgdChunk || grid < 1 || grid > 0x7fffffff ||
      read_table(leaves, n_leaves, chunk, false, a.leaf) != grid)
    return (int)cudaErrorInvalidValue;
  a.n_leaves = n_leaves;
  a.scal = (const float*)scal;
  a.lr = lr;
  a.active = active;
  a.momentum = momentum;
  sgd_tree_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// AdamW over `clients` stacked clients (every leaf's n = clients ·
// per_client). lr_ptr null: lr by value; active_ptr null: active by value,
// else client c's active at active_ptr[c · active_stride] (float32); t the
// int32 step counters at t[c · t_stride]; t_out receives the `clients`
// advanced counters. The bias-correction scales are computed in the kernel.
int repro_masked_adamw_tree(const int64_t* leaves, int n_leaves, int64_t grid, int64_t chunk,
                            const void* lr_ptr, float lr, const void* active_ptr, int64_t active_stride,
                            float active, const void* t, int64_t t_stride, void* t_out, int clients,
                            float b1, float omb1, float b2, float omb2, float eps, float wd, void* stream) {
  AdamwArgs a;
  if (chunk != kAdamwChunk || grid < 1 || grid > 0x7fffffff || clients < 1 || !t || !t_out ||
      active_stride < 0 || t_stride < 0 || read_table(leaves, n_leaves, chunk, true, a.leaf) != grid)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_leaves; ++l)
    if (a.leaf[l].n != (int64_t)clients * a.leaf[l].per_client) return (int)cudaErrorInvalidValue;
  a.n_leaves = n_leaves;
  a.lr_ptr = (const float*)lr_ptr;
  a.active_ptr = (const float*)active_ptr;
  a.t = (const int*)t;
  a.t_out = (int*)t_out;
  a.active_stride = active_stride;
  a.t_stride = t_stride;
  a.lr = lr;
  a.active = active;
  a.b1 = b1;
  a.omb1 = omb1;
  a.b2 = b2;
  a.omb2 = omb2;
  a.eps = eps;
  a.wd = wd;
  a.clients = clients;
  adamw_tree_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
