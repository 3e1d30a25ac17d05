// Fused fake-quantize / top-k round trip of FibecFed's compressed upload
// channel, with error feedback, written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/compress.py::fake_compress_2d (_compress_kernel)
// and the threshold its wrapper computes with a sort
//   src/repro/kernels/ops.py::fake_compress (jnp.sort, then one order statistic)
//
// Per (leaf, client) row of m values x = d + r (the GAL delta plus the
// carried residual, rounded once to the leaf's dtype, as d + r.to(d.dtype)):
//   s    = per-leaf scale absmax(row)·(1/qmax) (top-k) or absmax(group)·(1/qmax)
//          (int8/int4), where a group is 128 consecutive values of the row
//          (the wire format's QUANT_GROUP; the last group may be short);
//          1/qmax is rounded to f32 first, as XLA computes absmax/qmax
//   inv  = s > 0 ? 1/s : 0
//   y    = clip(rint(x·inv), -qmax, qmax)·s      (qmax = 0: y = x)
//   y    = |x| >= thresh ? y : 0                 (top-k only)
//   out  = y in the leaf's dtype,   residual = (x - y) in the leaf's dtype
// with thresh the value at sorted position clip(m - k, 0, m - 1) of |x|,
// k = max(1, ceil(ratio·active)) in f32, active = (the mask's nonzero
// entries)·(m / mask entries) counted as an integer and converted once (the
// row length without a mask). rint rounds half to even, as jnp.round does;
// the residual is taken from the f32 y before y is cast.
//
// Bound: memory. The upload reads d, r and the mask once and writes y and
// the residual once: 16 bytes per f32 value with a broadcast mask, 20 with
// a per-client mask of the leaf's shape, for a few flops and a handful of
// shared-memory passes per value. The least time is bytes / 3.35 TB/s.
//
// Design: one launch per tree (up to kMaxLeaves leaves), from a table of
// the leaves (d, r, mask, y, residual, row length, mask entries per client,
// first block, dtype) in the kernel's parameters, where the wrapper of the
// TPU kernel ran ~15 device ops and a full sort per leaf.
// - Without top-k nothing crosses a 128-value group: one warp per group,
//   4 values per lane in one 16-byte (f32) or 8-byte (bf16) vector where the
//   leaf is aligned; the group's absmax is a shuffle reduction. A block
//   takes 8 consecutive groups of one client row (the shared planner's
//   chunks of 1024 values, aligned to rows).
// - With top-k each row is one thread-block cluster of kCluster blocks
//   (cooperative_groups::this_cluster). Each block keeps its slice of the
//   row's x in shared memory (in the leaf's dtype; a qwen2-0.5b row of
//   172,032 f32 values is 86 KB a block). The blocks reduce the row's
//   absmax and mask count through distributed shared memory, then find the
//   threshold by an MSB-first radix select over the f32 bit patterns of
//   |x| (non-negative, so the bits order as the values do): each pass builds
//   a histogram of the next kRadixBits-bit digit of the values that match
//   the digits found so far, per block in shared memory; every block sums
//   the cluster's histograms (map_shared_rank) and picks the digit that
//   holds the wanted rank, the same digit in every block, with no second
//   exchange. Three passes for f32, two for bf16 (its low 16 bits are 0);
//   the result is that order statistic exactly, ties included. Then each
//   block writes y and the residual from its slice. A row whose slice does
//   not fit kSliceBytes re-forms x from device memory on each pass.
//
// Build with -fmad=false (kernels/build.py) and without fast math: the
// division and the multiplies then round as the plain PyTorch version's do.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 128;
constexpr int kMaxLeaves = 32;
constexpr int kLeafWords = 11;  // int64 words per leaf in the host table
// without top-k
constexpr int kGroupThreads = 256;
constexpr int64_t kGroupChunk = (kGroupThreads / 32) * kGroup;  // a block's 8 groups
// with top-k
constexpr int kCluster = 8;
constexpr int kTopkThreads = 512;
constexpr int kRadixBits = 11;
constexpr int kBins = 1 << kRadixBits;
constexpr int kBinsPerThread = kBins / kTopkThreads;
constexpr int kSliceBytes = 96 * 1024;  // x in shared memory: 2 blocks of an SM with the histograms

struct Leaf {
  const void* d;
  const void* r;       // null: no residual
  const float* mask;   // null: every value counts (top-k only)
  void* y;
  void* res;
  int64_t n;            // elements
  int64_t per_client;   // m, the row length
  int64_t mask_n;       // mask entries per client row
  int64_t mask_stride;  // 0: one mask shared by the rows; mask_n: one per row
  int block0;           // first block (without top-k) or first row (with)
  int dtype;            // d, r, y, residual: 0 float32, 1 bfloat16
};

struct Args {
  Leaf leaf[kMaxLeaves];
  float qmax, inv_qmax, ratio;
  int n_leaves;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// 4 consecutive values: one 16-byte (f32) or 8-byte (bf16) access
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T>
__device__ __forceinline__ Vec4<T> load4(const T* p) {
  Vec4<T> out;
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(out.v) = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    *reinterpret_cast<uint2*>(out.v) = __ldg(reinterpret_cast<const uint2*>(p));
  }
  return out;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const Vec4<T>& x) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(x.v);
  else
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(x.v);
}

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// x = d + r rounded once to T (d alone without a residual), as f32: one
// value, and 4 values from one vector of d and one of r
template <typename T>
__device__ __forceinline__ float form_x(const T* d, const T* r, int64_t i) {
  return r == nullptr ? to_f32(d[i]) : to_f32(from_f32<T>(to_f32(d[i]) + to_f32(r[i])));
}

template <typename T>
__device__ __forceinline__ void form4(const T* d, const T* r, int64_t i, float (&x)[4]) {
  const Vec4<T> dv = load4(d + i);
  if (r == nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = to_f32(dv.v[j]);
  } else {
    const Vec4<T> rv = load4(r + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = to_f32(from_f32<T>(to_f32(dv.v[j]) + to_f32(rv.v[j])));
  }
}

// y and the residual of one value
template <bool QUANT, bool THRESH>
__device__ __forceinline__ void round_trip(float x, float scale, float inv, float qmax, float thresh, float& y,
                                           float& res) {
  y = x;
  if (QUANT) y = fminf(fmaxf(rintf(x * inv), -qmax), qmax) * scale;
  if (THRESH) y = fabsf(x) >= thresh ? y : 0.0f;
  res = x - y;
}

__device__ __forceinline__ float safe_inv(float scale) {
  const float safe = scale > 0.0f ? scale : 1.0f;
  return scale > 0.0f ? 1.0f / safe : 0.0f;
}

// whether every pointer of the leaf is 16-byte aligned and its rows start on
// multiples of 4 values (so every 4-value vector of a row is aligned)
__device__ __forceinline__ bool vector_leaf(const Leaf& leaf) {
  return (leaf.per_client & 3) == 0 && aligned16(leaf.d) && (leaf.r == nullptr || aligned16(leaf.r)) &&
         aligned16(leaf.y) && aligned16(leaf.res);
}

// ---- without top-k: one warp per 128-value group

template <typename T, bool QUANT>
__device__ __forceinline__ void groups_chunk(const Args& a, const Leaf& leaf, int64_t start, int64_t end) {
  const int lane = threadIdx.x & 31;
  const int64_t g0 = start + (int64_t)(threadIdx.x >> 5) * kGroup;
  if (g0 >= end) return;
  const int len = end - g0 < kGroup ? (int)(end - g0) : kGroup;
  const T* d = static_cast<const T*>(leaf.d) + g0;
  const T* r = leaf.r == nullptr ? nullptr : static_cast<const T*>(leaf.r) + g0;
  T* y_out = static_cast<T*>(leaf.y) + g0;
  T* r_out = static_cast<T*>(leaf.res) + g0;
  const int i0 = lane * 4;
  // len is a multiple of 4 on a vector leaf (rows of a multiple of 4 values)
  const bool vec = vector_leaf(leaf);
  float x[4];
  if (vec && i0 < len) {
    form4(d, r, i0, x);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = i0 + j < len ? form_x(d, r, i0 + j) : 0.0f;
  }
  float scale = 0.0f, inv = 0.0f;
  if (QUANT) {
    float amax = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    scale = amax * a.inv_qmax;
    inv = safe_inv(scale);
  }
  Vec4<T> yv, rv;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float yy, rr;
    round_trip<QUANT, false>(x[j], scale, inv, a.qmax, 0.0f, yy, rr);
    yv.v[j] = from_f32<T>(yy);
    rv.v[j] = from_f32<T>(rr);
  }
  if (vec) {
    if (i0 < len) {
      store4(y_out + i0, yv);
      store4(r_out + i0, rv);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j < len) {
        y_out[i0 + j] = yv.v[j];
        r_out[i0 + j] = rv.v[j];
      }
    }
  }
}

template <bool QUANT>
__global__ void __launch_bounds__(kGroupThreads) groups_tree_kernel(const __grid_constant__ Args a) {
  const int b = (int)blockIdx.x;
  int l = 0;
  while (l + 1 < a.n_leaves && a.leaf[l + 1].block0 <= b) ++l;
  const Leaf& leaf = a.leaf[l];
  // block -> (client row, chunk of 8 groups), chunks aligned to rows
  const int64_t per_row = (leaf.per_client + kGroupChunk - 1) / kGroupChunk;
  const int64_t local = b - leaf.block0;
  const int64_t c = local / per_row;
  const int64_t start = c * leaf.per_client + (local - c * per_row) * kGroupChunk;
  const int64_t row_end = (c + 1) * leaf.per_client;
  const int64_t end = start + kGroupChunk < row_end ? start + kGroupChunk : row_end;
  if (leaf.dtype == 0)
    groups_chunk<float, QUANT>(a, leaf, start, end);
  else
    groups_chunk<__nv_bfloat16, QUANT>(a, leaf, start, end);
}

// ---- with top-k: one cluster per row

// the digits of the radix select over the key bits 30..0 (bit 31, the sign,
// is 0 for |x|); a bf16 value's low 16 bits are 0, so its last digit ends at 16
template <typename T>
struct Digits;
template <>
struct Digits<float> {
  static constexpr int kPasses = 3;
  __device__ static int shift(int p) { return p == 0 ? 20 : (p == 1 ? 9 : 0); }
};
template <>
struct Digits<__nv_bfloat16> {
  static constexpr int kPasses = 2;
  __device__ static int shift(int p) { return p == 0 ? 20 : 16; }
};

__device__ __forceinline__ uint32_t key_of(float x) { return __float_as_uint(fabsf(x)); }

struct alignas(16) TopkShared {
  unsigned int hist[2][kBins];  // this block's histogram, double-buffered across passes
  unsigned int amax_bits;       // this block's absmax of |x| (f32 bits order as values)
  unsigned long long count;     // this block's share of the row's nonzero mask entries
  unsigned int warp_sum[kTopkThreads / 32];
  unsigned int digit, rank;
};

template <typename T, bool QUANT>
__device__ void topk_row(const Args& a, const Leaf& leaf, int64_t row, TopkShared& sh, T* xs) {
  cg::cluster_group cluster = cg::this_cluster();
  const int me = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int64_t m = leaf.per_client;
  const int64_t base = row * m;
  // this block's slice [lo, hi) of the row, on a multiple of 4 values
  const int64_t slice = ((m + kCluster - 1) / kCluster + 3) / 4 * 4;
  const int64_t lo = me * slice < m ? me * slice : m;
  const int64_t hi = lo + slice < m ? lo + slice : m;
  const bool in_smem = slice * (int64_t)sizeof(T) <= kSliceBytes;  // the same in every block of the row
  const bool vec = vector_leaf(leaf);
  const T* d = static_cast<const T*>(leaf.d) + base;
  const T* r = leaf.r == nullptr ? nullptr : static_cast<const T*>(leaf.r) + base;

  for (int i = tid; i < 2 * kBins; i += kTopkThreads) (&sh.hist[0][0])[i] = 0;
  if (tid == 0) {
    sh.amax_bits = 0;
    sh.count = 0;
  }
  __syncthreads();

  // pass 0 rides on the load: form x, keep it, its absmax and top digit;
  // a mask of the row's length (per client, or shared) is counted on the way
  float amax = 0.0f;
  unsigned int count = 0;  // a row has fewer than 2^31 entries
  const int shift0 = Digits<T>::shift(0);
  const float* mk = leaf.mask == nullptr ? nullptr : leaf.mask + row * leaf.mask_stride;
  const bool mask_along = mk != nullptr && leaf.mask_n == m && vec && aligned16(mk);
  auto first = [&](int64_t i, float x) {
    amax = fmaxf(amax, fabsf(x));
    atomicAdd(&sh.hist[0][key_of(x) >> shift0], 1u);
    if (in_smem) xs[i - lo] = from_f32<T>(x);
  };
  auto count4 = [&](float4 v) {
    count += (unsigned)(v.x != 0.0f) + (unsigned)(v.y != 0.0f) + (unsigned)(v.z != 0.0f) + (unsigned)(v.w != 0.0f);
  };
  if (vec) {
    // two vectors a thread per step, all loaded before any is counted
    constexpr int64_t kStep = 4 * kTopkThreads;
    for (int64_t i = lo + 4 * tid; i < hi; i += 2 * kStep) {
      float x[2][4];
      const bool second = i + kStep < hi;
      float4 mv[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
      form4(d, r, i, x[0]);
      if (mask_along) mv[0] = __ldg(reinterpret_cast<const float4*>(mk + i));
      if (second) {
        form4(d, r, i + kStep, x[1]);
        if (mask_along) mv[1] = __ldg(reinterpret_cast<const float4*>(mk + i + kStep));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) first(i + j, x[0][j]);
      count4(mv[0]);
      if (second) {
#pragma unroll
        for (int j = 0; j < 4; ++j) first(i + kStep + j, x[1][j]);
        count4(mv[1]);
      }
    }
  } else {
    for (int64_t i = lo + tid; i < hi; i += kTopkThreads) first(i, form_x(d, r, i));
  }
  if (mk != nullptr && !mask_along) {  // this block's share of the mask's entries
    const int64_t part = (leaf.mask_n + kCluster - 1) / kCluster;
    const int64_t mlo = me * part < leaf.mask_n ? me * part : leaf.mask_n;
    const int64_t mhi = mlo + part < leaf.mask_n ? mlo + part : leaf.mask_n;
    for (int64_t j = mlo + tid; j < mhi; j += kTopkThreads) count += __ldg(mk + j) != 0.0f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  if ((tid & 31) == 0) {
    atomicMax(&sh.amax_bits, __float_as_uint(amax));
    atomicAdd(&sh.count, (unsigned long long)count);
  }

  float row_amax = 0.0f;
  unsigned int target = 0;  // the wanted rank among the values that match the digits so far
  uint32_t prefix = 0;      // the digits found so far
  for (int p = 0; p < Digits<T>::kPasses; ++p) {
    cluster.sync();  // every block's histogram (and, at pass 0, partials) complete
    const int shift = Digits<T>::shift(p);
    // the next pass's histogram buffer: the other blocks last read it before
    // this cluster.sync; the block barriers of the digit search below order
    // these stores before the next pass counts into it
    unsigned int* next = sh.hist[(p + 1) & 1];
    if (p + 1 < Digits<T>::kPasses)
      for (int i = tid; i < kBins; i += kTopkThreads) next[i] = 0;
    if (p == 0) {
      // lane l reads block (l % kCluster)'s partials; 8 lanes reduce them
      unsigned int bits = *cluster.map_shared_rank(&sh.amax_bits, tid % kCluster);
      unsigned long long total = *cluster.map_shared_rank(&sh.count, tid % kCluster);
#pragma unroll
      for (int off = 1; off < kCluster; off <<= 1) {
        bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, off));
        total += __shfl_xor_sync(0xffffffffu, total, off);
      }
      row_amax = __uint_as_float(bits);
      // active as the plain version computes it: an integer count, converted
      // once, times the values each mask entry covers, in f32
      const float active = leaf.mask == nullptr ? (float)m : (float)total * (float)(m / leaf.mask_n);
      const float k = fmaxf(1.0f, ceilf(a.ratio * active));
      const int64_t ki = (int64_t)k;
      const int64_t idx = m - ki;
      target = (unsigned int)(idx < 0 ? 0 : (idx > m - 1 ? m - 1 : idx));
    }
    // the cluster's histogram, 4 bins a thread, summed by every block: one
    // 16-byte load from each block, all in flight at once
    static_assert(kBinsPerThread == 4, "one uint4 of bins a thread");
    uint4 part[kCluster];
#pragma unroll
    for (int b = 0; b < kCluster; ++b)
      part[b] = reinterpret_cast<const uint4*>(cluster.map_shared_rank(&sh.hist[p & 1][0], b))[tid];
    unsigned int tot[kBinsPerThread] = {0, 0, 0, 0};
#pragma unroll
    for (int b = 0; b < kCluster; ++b) {
      tot[0] += part[b].x;
      tot[1] += part[b].y;
      tot[2] += part[b].z;
      tot[3] += part[b].w;
    }
    // the digit that holds the target: a block scan over the bins
    unsigned int mine = 0;
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) mine += tot[j];
    unsigned int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int up = __shfl_up_sync(0xffffffffu, incl, off);
      if ((tid & 31) >= off) incl += up;
    }
    if ((tid & 31) == 31) sh.warp_sum[tid >> 5] = incl;
    __syncthreads();
    unsigned int excl = incl - mine;
    for (int w = 0; w < (tid >> 5); ++w) excl += sh.warp_sum[w];
    if (excl <= target && target < excl + mine) {
      unsigned int run = excl;
      for (int j = 0; j < kBinsPerThread; ++j) {
        if (target < run + tot[j]) {
          sh.digit = (unsigned int)(tid * kBinsPerThread + j);
          sh.rank = target - run;
          break;
        }
        run += tot[j];
      }
    }
    __syncthreads();
    prefix |= sh.digit << shift;
    target = sh.rank;
    if (p + 1 == Digits<T>::kPasses) break;
    // the next digit's histogram over the values that match the prefix
    const int nshift = Digits<T>::shift(p + 1);
    const uint32_t nmask = (1u << (shift - nshift)) - 1u;
    auto count_digit = [&](float x) {
      const uint32_t key = key_of(x);
      if ((key >> shift) == (prefix >> shift)) atomicAdd(&next[(key >> nshift) & nmask], 1u);
    };
    if (in_smem) {
      // 4 values a load (the slice is a multiple of 4 values on a vector leaf)
      const int64_t len = hi - lo, vlen = vec ? len / 4 * 4 : 0;
      for (int64_t i = 4 * tid; i < vlen; i += 4 * kTopkThreads) {
        const Vec4<T> xv = *reinterpret_cast<const Vec4<T>*>(xs + i);
#pragma unroll
        for (int j = 0; j < 4; ++j) count_digit(to_f32(xv.v[j]));
      }
      for (int64_t i = vlen + tid; i < len; i += kTopkThreads) count_digit(to_f32(xs[i]));
    } else {
      for (int64_t i = lo + tid; i < hi; i += kTopkThreads) count_digit(form_x(d, r, i));
    }
  }

  // y and the residual of this block's slice
  const float thresh = __uint_as_float(prefix);
  const float scale = QUANT ? row_amax * a.inv_qmax : 0.0f;
  const float inv = QUANT ? safe_inv(scale) : 0.0f;
  T* y_out = static_cast<T*>(leaf.y) + base;
  T* r_out = static_cast<T*>(leaf.res) + base;
  if (vec) {
    for (int64_t i = lo + 4 * tid; i < hi; i += 4 * kTopkThreads) {
      float x[4];
      if (in_smem) {
        const Vec4<T> xv = *reinterpret_cast<const Vec4<T>*>(xs + (i - lo));
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = to_f32(xv.v[j]);
      } else {
        form4(d, r, i, x);
      }
      Vec4<T> yv, rv;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float yy, rr;
        round_trip<QUANT, true>(x[j], scale, inv, a.qmax, thresh, yy, rr);
        yv.v[j] = from_f32<T>(yy);
        rv.v[j] = from_f32<T>(rr);
      }
      store4(y_out + i, yv);
      store4(r_out + i, rv);
    }
  } else {
    for (int64_t i = lo + tid; i < hi; i += kTopkThreads) {
      const float x = in_smem ? to_f32(xs[i - lo]) : form_x(d, r, i);
      float yy, rr;
      round_trip<QUANT, true>(x, scale, inv, a.qmax, thresh, yy, rr);
      y_out[i] = from_f32<T>(yy);
      r_out[i] = from_f32<T>(rr);
    }
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

template <bool QUANT>
__global__ void __launch_bounds__(kTopkThreads, 2) topk_tree_kernel(const __grid_constant__ Args a) {
  __shared__ TopkShared sh;
  extern __shared__ __align__(16) unsigned char xs[];
  const int row = (int)(blockIdx.x / kCluster);
  int l = 0;
  while (l + 1 < a.n_leaves && a.leaf[l + 1].block0 <= row) ++l;
  const Leaf& leaf = a.leaf[l];
  if (leaf.dtype == 0)
    topk_row<float, QUANT>(a, leaf, row - leaf.block0, sh, reinterpret_cast<float*>(xs));
  else
    topk_row<__nv_bfloat16, QUANT>(a, leaf, row - leaf.block0, sh, reinterpret_cast<__nv_bfloat16*>(xs));
}

template <bool QUANT>
int launch_topk(const Args& a, int64_t rows, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(topk_tree_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSliceBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * kCluster));
  cfg.blockDim = dim3(kTopkThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, topk_tree_kernel<QUANT>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// leaves: n_leaves rows of kLeafWords int64 words in host memory,
//   [d, r, mask, y, res, n, per_client, mask_n, mask_stride, block0, dtype],
// pointers as integers (r and mask 0 for none), n > 0 values in rows of
// per_client, mask_n > 0 float32 mask entries per row at mask_stride (0 or
// mask_n) apart, block0 the running sum of the leaves' blocks (without
// top-k: (n / per_client) · ceil(per_client / chunk), chunk the kernel's
// 1024) or rows (with top-k: n / per_client, chunk 0), grid their total; y
// and res must not alias d or r. qmax 0 (no quantization), 7 or 127;
// inv_qmax its f32 reciprocal; ratio the top-k fraction in f32.
int repro_fake_compress_tree(const int64_t* leaves, int n_leaves, int64_t grid, int64_t chunk, int qmax,
                             int use_thresh, float ratio, float inv_qmax, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || qmax < 0 || grid < 1 ||
      chunk != (use_thresh ? 0 : kGroupChunk) || grid * (use_thresh ? kCluster : 1) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.n_leaves = n_leaves;
  a.qmax = (float)qmax;
  a.inv_qmax = inv_qmax;
  a.ratio = ratio;
  int64_t blocks = 0;
  size_t smem = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const int64_t* w = leaves + (int64_t)l * kLeafWords;
    Leaf& leaf = a.leaf[l];
    leaf.d = (const void*)w[0];
    leaf.r = (const void*)w[1];
    leaf.mask = (const float*)w[2];
    leaf.y = (void*)w[3];
    leaf.res = (void*)w[4];
    leaf.n = w[5];
    leaf.per_client = w[6];
    leaf.mask_n = w[7];
    leaf.mask_stride = w[8];
    leaf.block0 = (int)w[9];
    leaf.dtype = (int)w[10];
    if (!leaf.d || !leaf.y || !leaf.res || leaf.n <= 0 || leaf.per_client <= 0 || leaf.per_client > 0x7fffffff ||
        leaf.n % leaf.per_client != 0 || w[9] != blocks || leaf.dtype < 0 || leaf.dtype > 1 ||
        (leaf.mask && (leaf.mask_n <= 0 || (leaf.mask_stride != 0 && leaf.mask_stride != leaf.mask_n))))
      return (int)cudaErrorInvalidValue;
    const int64_t rows = leaf.n / leaf.per_client;
    blocks += use_thresh ? rows : rows * ((leaf.per_client + kGroupChunk - 1) / kGroupChunk);
    const int64_t slice = ((leaf.per_client + kCluster - 1) / kCluster + 3) / 4 * 4;
    const int64_t bytes = slice * (leaf.dtype == 0 ? 4 : 2);
    if (bytes <= kSliceBytes && (size_t)bytes > smem) smem = (size_t)bytes;
  }
  if (blocks != grid) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_thresh) return qmax ? launch_topk<true>(a, grid, smem, s) : launch_topk<false>(a, grid, smem, s);
  if (qmax)
    groups_tree_kernel<true><<<(unsigned)grid, kGroupThreads, 0, s>>>(a);
  else
    groups_tree_kernel<false><<<(unsigned)grid, kGroupThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
