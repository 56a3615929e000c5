// Brick-row gather / interpolate / scatter kernels of the hash grid, for
// Hopper (sm_90a).
//
// The hash grid stores one brick (the 3x3x3 corner lattice of a 2x2x2-cell
// region, 27 entries padded to 32) as one contiguous row of 32*F floats of a
// brick-major f32 table [n_bricks, 32F] (entry-major, feature-minor). Every
// (sample, level) reads exactly one row. These four kernels replace the four
// TPU kernels of nerf_vo_tpu/ops/gather_pallas.py:
//
//   gather_cols        <- gather_cols (:79, kernel _gather_kernel :63)
//       out[t, :] = bf16(tab[idx[t], :])                    [M, R] bf16
//   gather_interp      <- gather_interp (:133, kernel :110)
//       out[t, f] = sum_{e<32} w[t, e] * bf16(tab[idx[t], e*F + f])   f32
//   gather_interp_bf16 <- the same TPU kernel, on a bf16 table (the dense
//       proposal grids' proposal_table_dtype: bfloat16)
//   gather_interp_mm   <- gather_interp_mm (:219, kernel :171)
//       the same function, for the dense small-table levels (the TPU kernel
//       pinned the whole level in VMEM and contracted with one-hot matmuls)
//   scatter_cols_accum <- scatter_cols_accum (:297, kernel :252)
//       out[b, :] += g[t, :] for every t with idx[t] == b     f32
//
// bf16(.) is round-to-nearest-even, done in registers on the f32 parameter
// table: no bf16 copy of the table is made. gather_interp_bf16 reads a bf16
// table as it is stored: bf16(.) is then exact, and it gives bitwise the
// f32 kernel's result on the same values in f32 (the same live entries,
// the same products summed in the same order). Weights, sums and outputs of the
// interpolation are f32 (the Pallas contract had bf16 w and out). A
// descriptor whose id lies outside [0, n_bricks) reads zeros (gathers) or is
// dropped (scatter).
//
// What bounds them on an H100, at the replica configuration's mapping step
// (field: 4096 rays x 48 samples = 196,608 descriptors per level; F = 8, R =
// 256; proposals F = 1, R = 32): all four move bytes and do next to no
// arithmetic (at most 32F multiply-adds per descriptor), so the bound is
// bytes over 3.35 TB/s. Per descriptor, gather_interp reads its w row
// (128 B) and the 8 live entries of one table row (256 B of 1 KB at F = 8)
// and writes 32 B; gather_cols
// writes a 512 B bf16 row; scatter_cols_accum reads a 1 KB f32 cotangent row
// and adds it into one 1 KB table row. Bounds at those shapes (bytes moved
// once over 3.35 TB/s, as chip_smoke.py phase (a) computes them):
//   gather_cols        M 589,824 x 256: 302 MB out + touched rows  ~0.10 ms
//   gather_interp      M 393,216, F 8 (hashed levels 1-2): ~98 MB  ~0.029 ms
//   gather_interp_mm   M 196,608, F 8 (level 0, 512 bricks): ~33 MB ~0.010 ms
//   scatter_cols_accum M 589,824 x 256 into 49,152 bricks: 657 MB ~0.20 ms
//
// Designs.
//
// gather_cols: one warp per descriptor; each warp reads its row coalesced.
//
// gather_interp: a persistent grid; L lanes serve one descriptor (L = 8,
// 4 descriptors a warp; at F = 1 the L of kGiLanesF1). Lane j loads its
// 32 / L weights with 16-byte streaming loads; the ids and weights of the
// next descriptors are in flight while the current rows are read and
// summed, and the row loads of kGiUnroll descriptors are all issued before
// any sum. A lane reads table entry e only where w[t, e] != 0: a point's
// trilinear weights are non-zero on the 8 corners of its cell, so at F = 8
// a descriptor requests 8 sectors of 32 B (256 B) of its 1 KB row. A
// zero-weight entry adds exactly 0 to the plain version's sum when the
// table is finite, so the result is the same; dense weights read every
// entry. At F = 1 an entry is 4 B and four of them are one 16-byte load,
// read where any of its four weights is non-zero; 2, 4 and 8 lanes a
// descriptor came within 3% of one another on an H100, 4 the fastest at
// both proposal grids' shapes (scripts/exp_torch_gather_lanes.py). The row
// loads are predicated, not branched around: with a branch each load
// waited for the one before it (0.0965 ms against 0.0488 at the field's
// hashed levels). A reduce-scatter over the L
// lanes leaves each lane one output feature (a 32 B store per descriptor
// at F = 8). The table's element type is a template parameter: a bf16
// table is read in loads of half the width (at F = 1, 8 bytes for 4
// entries, read where any of their weights is non-zero, as the f32 kernel
// groups them), so a descriptor moves half the table bytes.
//
// gather_interp_mm: the level is small (512 bricks at F = 8: 221,184 B as
// the 27 real entries in bf16), so the table is not what must move; the
// 128 B weight row of each descriptor is. A persistent grid (one 1024-thread
// block per SM) first stages the table's `hot` leading rows, bf16-rounded,
// in dynamic shared memory, entry e of a brick at slot (e % 4) * 7 + e / 4
// (so that the 7 lanes reading one entry column touch consecutive 16-byte
// chunks). Then 8 lanes serve one descriptor, 4 descriptors per warp: lane
// j loads w[t, 4j..4j+3] as one 16-byte streaming load (the next
// descriptors' loads are issued before the current ones are summed), sums
// its 4 entries x F features in registers, and a 3-step reduce-scatter over
// the 8 lanes leaves each lane one output feature (8 lanes write 32 B).
// There is no one-hot work. An id at or above `hot` (or `hot` = 0: every
// row through L1/L2) reads the f32 row from global memory and rounds in
// registers. Padding entries 27..31 are never staged: they are read from
// global memory where their weight is non-zero (the hash grid's descriptors
// give them weight 0), so any input is computed right.
//
// scatter_cols_accum: R = 32F is a template parameter. A block owns one
// 32-column slab of the table and a strided share of the descriptors: 8
// lanes take one descriptor's 128 B of the slab as one 16-byte load each (4
// loads in flight per lane); the id is loaded once per descriptor batch and
// broadcast by shuffle. Ids below `hot` (level 0's 512 bricks, where ~384
// descriptors hit each brick) accumulate in the block's shared-memory copy
// of those rows' slab (shared f32 atomics; rows rotated by their index to
// spread banks), flushed once at the end with global vector atomics; every
// other id adds straight into the table with sm_90's 16-byte atomicAdd on
// float4 (4x fewer atomic operations than scalar adds).
//
// Plain C interface, bound with ctypes (nerf_vo_tpu_torch/ops/gather_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEntries = 27;  // real entries of a brick
constexpr int kSmemMax = 232448;  // dynamic shared memory of one sm_90 block

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kMaxDevices = 64;

// What a launch site knows of its kernel on one device: whether the dynamic
// shared-memory limit is raised, and its resident blocks per SM at the last
// shared-memory size asked (a call site asks for one size). Each site keeps
// one per device, so every card gets its own grid size and attribute.
struct KernelFacts {
  bool attr_set = false;
  int smem = -1;
  int blocks = 0;
};

int sm_count(int dev) {
  static int counts[kMaxDevices] = {};
  int n = dev < kMaxDevices ? counts[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
    if (dev < kMaxDevices) counts[dev] = n;
  }
  return n;
}

// Blocks of `kernel` at `threads` and `smem` that fit on the current device
// at once (SMs x resident blocks per SM), raising the kernel's dynamic
// shared-memory limit to `max_smem` on the device's first call.
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, KernelFacts* facts, int threads,
                          int max_smem, int smem, long long* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  KernelFacts uncached;
  KernelFacts& f = dev >= 0 && dev < kMaxDevices ? facts[dev] : uncached;
  if (!f.attr_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return err;
    f.attr_set = true;
  }
  if (f.smem != smem) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
    f.smem = smem;
    f.blocks = n > 0 ? n : 1;
  }
  *blocks = static_cast<long long>(sm_count(dev)) * f.blocks;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// gather_cols: one warp per descriptor, 16-byte loads, 8-byte stores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) gather_cols_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    __nv_bfloat16* __restrict__ out, int M, int R, int n_bricks) {
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= M) return;
  const int b = idx[t];
  const bool ok = b >= 0 && b < n_bricks;
  const int nvec = R / 4;
  const float4* src =
      reinterpret_cast<const float4*>(tab + static_cast<long long>(ok ? b : 0) * R);
  uint2* dst = reinterpret_cast<uint2*>(out + t * R);
  for (int v = lane; v < nvec; v += 32) {
    float4 x = ok ? src[v] : make_float4(0.f, 0.f, 0.f, 0.f);
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 pack;
    pack.x = *reinterpret_cast<uint32_t*>(&lo);
    pack.y = *reinterpret_cast<uint32_t*>(&hi);
    dst[v] = pack;
  }
}

// ---------------------------------------------------------------------------
// gather_interp_mm: staged hot rows, 8 lanes per descriptor
// ---------------------------------------------------------------------------

constexpr int kMmThreads = 1024;
constexpr int kMmWarps = kMmThreads / 32;
constexpr int kMmUnroll = 2;  // descriptor sets per lane per loop trip

// F f32 table values at p, rounded to bf16 (read-only path).
template <int F>
__device__ __forceinline__ void load_rounded(const float* p, float* v) {
  if constexpr (F >= 4) {
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i + 0] = bf16_round(x.x);
      v[4 * i + 1] = bf16_round(x.y);
      v[4 * i + 2] = bf16_round(x.z);
      v[4 * i + 3] = bf16_round(x.w);
    }
  } else if constexpr (F == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = bf16_round(x.x);
    v[1] = bf16_round(x.y);
  } else {
    v[0] = bf16_round(__ldg(p));
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// F bf16-exact floats -> F bf16 at dst (2F bytes, aligned to 2F).
template <int F>
__device__ __forceinline__ void store_staged(__nv_bfloat16* dst,
                                             const float* v) {
  if constexpr (F == 8) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else if constexpr (F == 4) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  } else if constexpr (F == 2) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(v[0], v[1]);
  } else {
    *dst = __float2bfloat16_rn(v[0]);
  }
}

template <int F>
__device__ __forceinline__ void load_staged(const __nv_bfloat16* src,
                                            float* v) {
  if constexpr (F == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x);
    v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
    v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z);
    v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
  } else if constexpr (F == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x);
    v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
  } else if constexpr (F == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(src);
    v[0] = bf16_lo(u);
    v[1] = bf16_hi(u);
  } else {
    v[0] = __bfloat162float(*src);
  }
}

// Reduce-scatter of v[N] over the lanes that differ in bits OFF, OFF/2, ...,
// 1 of j: each step keeps half of the values (the upper half where bit OFF
// of j is set) and adds the partner's copy of that half; once one value is
// left, the remaining steps all-reduce it. `feat` collects which of the N
// values the lane holds.
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float* v, int j, int& feat) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (j & OFF) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) feat += H;
      reduce_scatter<H, OFF / 2>(v, j, feat);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<1, OFF / 2>(v, j, feat);
    }
  }
}

// The weight quarter-rows (16-byte streaming loads) and ids of the
// descriptors t0 + u * stride + q, u < kMmUnroll.
__device__ __forceinline__ void mm_fetch(const float4* __restrict__ w4,
                                         const int* __restrict__ idx, int M,
                                         long long t0, long long stride,
                                         int q, int j,
                                         float4 (&wd)[kMmUnroll],
                                         int (&bd)[kMmUnroll]) {
#pragma unroll
  for (int u = 0; u < kMmUnroll; ++u) {
    const long long t = t0 + u * stride + q;
    if (t < M) {
      wd[u] = __ldcs(w4 + t * 8 + j);
      bd[u] = __ldg(idx + t);
    } else {
      wd[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      bd[u] = -1;
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kMmThreads, 1) gather_interp_mm_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ w, float* __restrict__ out, int M,
    int n_bricks, int hot) {
  constexpr int R = 32 * F;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(mm_smem);

  const int lane = threadIdx.x & 31;
  const int q = lane >> 3;  // descriptor of the warp's 4
  const int j = lane & 7;   // entries 4j..4j+3
  const long long first =
      (static_cast<long long>(blockIdx.x) * kMmWarps + (threadIdx.x >> 5)) * 4;
  const long long stride = static_cast<long long>(gridDim.x) * kMmWarps * 4;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  // the first descriptors' loads are in flight while the rows are staged
  float4 wv[kMmUnroll];
  int bv[kMmUnroll];
  mm_fetch(w4, idx, M, first, stride, q, j, wv, bv);

  // stage rows [0, hot): entry e < 27 of brick b at (b * 27 + slot(e)) * F;
  // each block starts at another row, so that the blocks do not all ask
  // the same L2 slices for the same lines at once
  const int n_items = hot * kEntries;
  const int shift = static_cast<int>(
      static_cast<long long>(blockIdx.x) * n_items / gridDim.x);
  for (int i = threadIdx.x; i < n_items; i += kMmThreads) {
    const int ii = i + shift < n_items ? i + shift : i + shift - n_items;
    const int b = ii / kEntries;
    const int e = ii - b * kEntries;
    float v[F];
    load_rounded<F>(tab + static_cast<long long>(b) * R + e * F, v);
    store_staged<F>(rows + (b * kEntries + (e & 3) * 7 + (e >> 2)) * F, v);
  }
  __syncthreads();

  for (long long t0 = first; t0 < M; t0 += stride * kMmUnroll) {
    float4 wn[kMmUnroll];
    int bn[kMmUnroll];
    // the next descriptors' loads are in flight while these are summed
    mm_fetch(w4, idx, M, t0 + stride * kMmUnroll, stride, q, j, wn, bn);
#pragma unroll
    for (int u = 0; u < kMmUnroll; ++u) {
      const int b = bv[u];
      const bool ok = b >= 0 && b < n_bricks;
      const bool staged = ok && b < hot;
      const float we[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
      const float* grow = tab + static_cast<long long>(ok ? b : 0) * R;
      float acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * j + k;
        float v[F];
        if (staged && e < kEntries) {
          load_staged<F>(rows + (b * kEntries + k * 7 + j) * F, v);
        } else if (ok && (e < kEntries || we[k] != 0.f)) {
          load_rounded<F>(grow + e * F, v);
        } else {
#pragma unroll
          for (int f = 0; f < F; ++f) v[f] = 0.f;
        }
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = fmaf(we[k], v[f], acc[f]);
      }
      int feat = 0;
      reduce_scatter<F, 4>(acc, j, feat);
      const long long t = t0 + u * stride + q;
      // for F < 8, the lanes of a group hold 8 / F copies of each feature
      if (t < M && (j & (8 / F - 1)) == 0) out[t * F + feat] = acc[0];
    }
#pragma unroll
    for (int u = 0; u < kMmUnroll; ++u) {
      wv[u] = wn[u];
      bv[u] = bn[u];
    }
  }
}

// rows of F-feature bricks that fit in shared memory as 27 bf16 entries
constexpr int mm_capacity(int F) { return kSmemMax / (kEntries * F * 2); }

template <int F>
int launch_interp_mm(const float* tab, const int* idx, const float* w,
                     float* out, int M, int n_bricks, int hot,
                     cudaStream_t stream) {
  static KernelFacts facts[kMaxDevices];
  hot = hot < 0 ? 0 : hot;
  if (hot > n_bricks) hot = n_bricks;
  if (hot > mm_capacity(F)) hot = mm_capacity(F);
  const int smem = hot * kEntries * F * 2;
  const long long per_block = kMmWarps * 4;
  auto kernel = gather_interp_mm_kernel<F>;
  long long blocks = 0;
  cudaError_t err =
      resident_grid(kernel, facts, kMmThreads, kSmemMax, smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (M + per_block - 1) / per_block;
  if (blocks > need) blocks = need;
  kernel<<<static_cast<unsigned int>(blocks), kMmThreads, smem, stream>>>(
      tab, idx, w, out, M, n_bricks, hot);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// gather_interp: L lanes per descriptor, only the live entries read
// ---------------------------------------------------------------------------

constexpr int kGiThreads = 256;
constexpr int kGiWarps = kGiThreads / 32;
constexpr int kGiUnroll = 2;  // descriptor sets per lane per loop trip
// lanes per descriptor at F = 1, measured (scripts/exp_torch_gather_lanes.py
// builds 2, 4 and 8 with -DGI_LANES_F1)
#ifndef GI_LANES_F1
#define GI_LANES_F1 4
#endif
constexpr int kGiLanesF1 = GI_LANES_F1;

// The weight slices (NV 16-byte streaming loads: entries EP j .. EP j +
// EP - 1) and ids of the descriptors t0 + u * stride + q, u < kGiUnroll.
template <int NV>
__device__ __forceinline__ void gi_fetch(const float4* __restrict__ w4,
                                         const int* __restrict__ idx, int M,
                                         long long t0, long long stride,
                                         int q, int j,
                                         float4 (&wd)[kGiUnroll][NV],
                                         int (&bd)[kGiUnroll]) {
#pragma unroll
  for (int u = 0; u < kGiUnroll; ++u) {
    const long long t = t0 + u * stride + q;
#pragma unroll
    for (int g = 0; g < NV; ++g)
      wd[u][g] = t < M ? __ldcs(w4 + t * 8 + j * NV + g)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    bd[u] = t < M ? __ldg(idx + t) : -1;
  }
}

// 16 / 8 bytes at p where pred holds, else zeros: a predicated load, so
// that no branch separates a descriptor's row loads from one another.
__device__ __forceinline__ float4 ldg_f4_if(const float* p, bool pred) {
  float4 v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %5, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\tmov.f32 %1, 0f00000000;\n\t"
      "mov.f32 %2, 0f00000000;\n\tmov.f32 %3, 0f00000000;\n\t"
      "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

__device__ __forceinline__ float2 ldg_f2_if(const float* p, bool pred) {
  float2 v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %3, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\tmov.f32 %1, 0f00000000;\n\t"
      "@q ld.global.nc.v2.f32 {%0, %1}, [%2];\n\t}"
      : "=f"(v.x), "=f"(v.y)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

// 16 / 8 / 4 raw bytes at p where pred holds, else zeros (bf16 tables).
__device__ __forceinline__ uint4 ldg_u4_if(const void* p, bool pred) {
  uint4 v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %5, 0;\n\t"
      "mov.b32 %0, 0;\n\tmov.b32 %1, 0;\n\tmov.b32 %2, 0;\n\t"
      "mov.b32 %3, 0;\n\t"
      "@q ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

__device__ __forceinline__ uint2 ldg_u2_if(const void* p, bool pred) {
  uint2 v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %3, 0;\n\t"
      "mov.b32 %0, 0;\n\tmov.b32 %1, 0;\n\t"
      "@q ld.global.nc.v2.b32 {%0, %1}, [%2];\n\t}"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

__device__ __forceinline__ uint32_t ldg_u1_if(const void* p, bool pred) {
  uint32_t v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %2, 0;\n\t"
      "mov.b32 %0, 0;\n\t"
      "@q ld.global.nc.b32 %0, [%1];\n\t}"
      : "=r"(v)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

// The F values of entries k .. k + n - 1 of a bf16 row, unpacked from the
// 32-bit words u (2 bf16 a word, the lower first) into v[k + i][f].
template <int F, int EP>
__device__ __forceinline__ void unpack_bf16(const uint32_t* u, int k, int n,
                                            float (&v)[EP][F]) {
#pragma unroll
  for (int i = 0; i < n * F; ++i) {
    const uint32_t word = u[i / 2];
    v[k + i / F][i % F] = (i & 1) ? bf16_hi(word) : bf16_lo(word);
  }
}

// A descriptor's row loads for one lane: entries EP j .. EP j + EP - 1 of
// row b, each read only where its weight is live (at F = 1, groups of 4
// entries read where any weight is live). T = float keeps the raw f32
// values (rounded at the sum); T = __nv_bfloat16 reads the stored bf16.
template <typename T, int F, int EP>
__device__ __forceinline__ void gi_load_row(const T* __restrict__ tab,
                                            int b, bool ok, int j,
                                            const float (&we)[EP],
                                            float (&v)[EP][F]) {
  constexpr int R = 32 * F;
  const T* row = tab + static_cast<long long>(ok ? b : 0) * R + j * EP * F;
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (F == 1) {
#pragma unroll
      for (int g = 0; g < EP / 4; ++g) {
        const bool live = ok && (we[4 * g] != 0.f || we[4 * g + 1] != 0.f ||
                                 we[4 * g + 2] != 0.f || we[4 * g + 3] != 0.f);
        const float4 x = ldg_f4_if(row + 4 * g, live);
        v[4 * g + 0][0] = x.x;
        v[4 * g + 1][0] = x.y;
        v[4 * g + 2][0] = x.z;
        v[4 * g + 3][0] = x.w;
      }
    } else if constexpr (F == 2) {
#pragma unroll
      for (int k = 0; k < EP; ++k) {
        const float2 x = ldg_f2_if(row + k * F, ok && we[k] != 0.f);
        v[k][0] = x.x;
        v[k][1] = x.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < EP; ++k) {
#pragma unroll
        for (int h = 0; h < F / 4; ++h) {
          const float4 x = ldg_f4_if(row + k * F + 4 * h, ok && we[k] != 0.f);
          v[k][4 * h + 0] = x.x;
          v[k][4 * h + 1] = x.y;
          v[k][4 * h + 2] = x.z;
          v[k][4 * h + 3] = x.w;
        }
      }
    }
  } else {
    if constexpr (F == 1) {
#pragma unroll
      for (int g = 0; g < EP / 4; ++g) {
        const bool live = ok && (we[4 * g] != 0.f || we[4 * g + 1] != 0.f ||
                                 we[4 * g + 2] != 0.f || we[4 * g + 3] != 0.f);
        const uint2 x = ldg_u2_if(row + 4 * g, live);
        const uint32_t u[2] = {x.x, x.y};
        unpack_bf16<F, EP>(u, 4 * g, 4, v);
      }
    } else {
#pragma unroll
      for (int k = 0; k < EP; ++k) {
        const bool live = ok && we[k] != 0.f;
        if constexpr (F == 2) {
          const uint32_t u[1] = {ldg_u1_if(row + k * F, live)};
          unpack_bf16<F, EP>(u, k, 1, v);
        } else if constexpr (F == 4) {
          const uint2 x = ldg_u2_if(row + k * F, live);
          const uint32_t u[2] = {x.x, x.y};
          unpack_bf16<F, EP>(u, k, 1, v);
        } else {
          const uint4 x = ldg_u4_if(row + k * F, live);
          const uint32_t u[4] = {x.x, x.y, x.z, x.w};
          unpack_bf16<F, EP>(u, k, 1, v);
        }
      }
    }
  }
}

template <typename T, int F, int L>
__global__ void __launch_bounds__(kGiThreads) gather_interp_kernel(
    const T* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ w, float* __restrict__ out, int M,
    int n_bricks) {
  static_assert(F <= L && 32 % L == 0 && L <= 8, "lanes per descriptor");
  constexpr int EP = 32 / L;  // entries per lane
  constexpr int NV = EP / 4;  // 16-byte weight loads per lane
  constexpr int DPW = 32 / L;  // descriptors per warp
  const int lane = threadIdx.x & 31;
  const int q = lane / L;  // descriptor of the warp's DPW
  const int j = lane % L;  // entries EP j .. EP j + EP - 1
  const long long first =
      (static_cast<long long>(blockIdx.x) * kGiWarps + (threadIdx.x >> 5)) *
      DPW;
  const long long stride = static_cast<long long>(gridDim.x) * kGiWarps * DPW;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4 wv[kGiUnroll][NV];
  int bv[kGiUnroll];
  gi_fetch<NV>(w4, idx, M, first, stride, q, j, wv, bv);

  for (long long t0 = first; t0 < M; t0 += stride * kGiUnroll) {
    float4 wn[kGiUnroll][NV];
    int bn[kGiUnroll];
    // the next descriptors' weights and ids are in flight while these rows
    // are read and summed
    gi_fetch<NV>(w4, idx, M, t0 + stride * kGiUnroll, stride, q, j, wn, bn);
    // every row load of the kGiUnroll descriptors is issued (predicated,
    // no branch) before any sum; an entry is read only where its weight is
    // non-zero
    float we[kGiUnroll][EP];
    float v[kGiUnroll][EP][F];
#pragma unroll
    for (int u = 0; u < kGiUnroll; ++u) {
      const int b = bv[u];
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        we[u][4 * g + 0] = wv[u][g].x;
        we[u][4 * g + 1] = wv[u][g].y;
        we[u][4 * g + 2] = wv[u][g].z;
        we[u][4 * g + 3] = wv[u][g].w;
      }
      gi_load_row<T, F, EP>(tab, b, b >= 0 && b < n_bricks, j, we[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kGiUnroll; ++u) {
      float acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
      for (int k = 0; k < EP; ++k) {
#pragma unroll
        for (int f = 0; f < F; ++f)
          acc[f] = fmaf(we[u][k], bf16_round(v[u][k][f]), acc[f]);
      }
      int feat = 0;
      reduce_scatter<F, L / 2>(acc, j, feat);
      const long long t = t0 + u * stride + q;
      // for F < L, the lanes of a group hold L / F copies of each feature
      if (t < M && (j & (L / F - 1)) == 0) out[t * F + feat] = acc[0];
    }
#pragma unroll
    for (int u = 0; u < kGiUnroll; ++u) {
      bv[u] = bn[u];
#pragma unroll
      for (int g = 0; g < NV; ++g) wv[u][g] = wn[u][g];
    }
  }
}

template <typename T, int F, int L>
int launch_interp(const T* tab, const int* idx, const float* w,
                  float* out, int M, int n_bricks, cudaStream_t stream) {
  static KernelFacts facts[kMaxDevices];
  auto kernel = gather_interp_kernel<T, F, L>;
  long long blocks = 0;
  cudaError_t err = resident_grid(kernel, facts, kGiThreads, 0, 0, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = kGiWarps * (32 / L);
  const long long need = (M + per_block - 1) / per_block;
  if (blocks > need) blocks = need;
  kernel<<<static_cast<unsigned int>(blocks), kGiThreads, 0, stream>>>(
      tab, idx, w, out, M, n_bricks);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// scatter_cols_accum: 32-column slabs, hot rows in shared memory, vector
// atomics
// ---------------------------------------------------------------------------

constexpr int kScThreads = 512;
constexpr int kScWarps = kScThreads / 32;
constexpr int kSlab = 32;         // columns of one block's slab
constexpr int kScHotMax = 768;    // rows accumulated on chip: 96 KB a block

// position of column c of hot row r in the shared slab
__device__ __forceinline__ int slab_pos(int r, int c) {
  return r * kSlab + ((c + r) & (kSlab - 1));
}

template <int F>
__global__ void __launch_bounds__(kScThreads) scatter_cols_accum_kernel(
    const float* __restrict__ g, const int* __restrict__ idx,
    float* __restrict__ out, int M, int n_bricks, int hot) {
  constexpr int R = 32 * F;  // F slabs of 32 columns
  extern __shared__ __align__(16) float sc_smem[];
  const int s = blockIdx.x % F;
  const int chunk = blockIdx.x / F;
  const int n_chunks = gridDim.x / F;
  for (int i = threadIdx.x; i < hot * kSlab; i += kScThreads) sc_smem[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int q = lane >> 3;  // descriptor of the 4 served at once
  const int c4 = lane & 7;  // columns 4*c4..4*c4+3 of the slab
  const float4* g4 = reinterpret_cast<const float4*>(g) + s * 8 + c4;
  float* out_s = out + s * kSlab + 4 * c4;
  const long long batch0 =
      static_cast<long long>(chunk) * kScWarps + (threadIdx.x >> 5);
  const long long bstep = static_cast<long long>(n_chunks) * kScWarps;
  for (long long bt = batch0 * 32; bt < M; bt += bstep * 32) {
    const long long tl = bt + lane;
    const int my_id = tl < M ? __ldg(idx + tl) : -1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v[4];
      int b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = h * 16 + k * 4 + q;
        b[k] = __shfl_sync(0xffffffffu, my_id, d);
        v[k] = (b[k] >= 0 && b[k] < n_bricks)
                   ? __ldcs(g4 + (bt + d) * (R / 4))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int bk = b[k];
        if (bk < 0 || bk >= n_bricks) continue;
        if (bk < hot) {
          atomicAdd(sc_smem + slab_pos(bk, 4 * c4 + 0), v[k].x);
          atomicAdd(sc_smem + slab_pos(bk, 4 * c4 + 1), v[k].y);
          atomicAdd(sc_smem + slab_pos(bk, 4 * c4 + 2), v[k].z);
          atomicAdd(sc_smem + slab_pos(bk, 4 * c4 + 3), v[k].w);
        } else {
          atomicAdd(reinterpret_cast<float4*>(
                        out_s + static_cast<long long>(bk) * R), v[k]);
        }
      }
    }
  }
  __syncthreads();

  // flush the hot rows' slab: one vector atomic per non-zero 16 bytes
  for (int i = threadIdx.x; i < hot * 8; i += kScThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    const float4 v = make_float4(
        sc_smem[slab_pos(r, c + 0)], sc_smem[slab_pos(r, c + 1)],
        sc_smem[slab_pos(r, c + 2)], sc_smem[slab_pos(r, c + 3)]);
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
      atomicAdd(reinterpret_cast<float4*>(
                    out + static_cast<long long>(r) * R + s * kSlab + c), v);
  }
}

template <int F>
int launch_scatter(const float* g, const int* idx, float* out, int M,
                   int n_bricks, int hot, cudaStream_t stream) {
  static KernelFacts facts[kMaxDevices];
  hot = hot < 0 ? 0 : hot;
  if (hot > n_bricks) hot = n_bricks;
  if (hot > kScHotMax) hot = kScHotMax;
  const int smem = hot * kSlab * 4;
  auto kernel = scatter_cols_accum_kernel<F>;
  long long chunks = 0;
  cudaError_t err = resident_grid(kernel, facts, kScThreads,
                                  kScHotMax * kSlab * 4, smem, &chunks);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunks /= F;
  const long long need = (M + kScWarps * 32 - 1) / (kScWarps * 32);
  if (chunks > need) chunks = need;
  if (chunks < 1) chunks = 1;
  kernel<<<static_cast<unsigned int>(chunks * F), kScThreads, smem, stream>>>(
      g, idx, out, M, n_bricks, hot);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_interp(const T* tab, const int* idx, const float* w, float* out,
                    int M, int F, int n_bricks, cudaStream_t s) {
  switch (F) {
    case 1: return launch_interp<T, 1, kGiLanesF1>(tab, idx, w, out, M,
                                                   n_bricks, s);
    case 2: return launch_interp<T, 2, 8>(tab, idx, w, out, M, n_bricks, s);
    case 4: return launch_interp<T, 4, 8>(tab, idx, w, out, M, n_bricks, s);
    case 8: return launch_interp<T, 8, 8>(tab, idx, w, out, M, n_bricks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every entry point launches on `stream` and returns the cudaError_t of the
// launch (0 on success). The caller guarantees contiguous tensors, 16-byte
// aligned table, weight, cotangent and output pointers, and R = 32 * F.

// tab [n_bricks, R] f32, idx [M] int32 -> out [M, R] bf16. R % 4 == 0.
extern "C" int gather_cols(const void* tab, const void* idx, void* out, int M,
                           int R, int n_bricks, void* stream) {
  if (M == 0) return 0;
  const int blocks = (M + kWarps - 1) / kWarps;
  gather_cols_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int*>(idx),
      static_cast<__nv_bfloat16*>(out), M, R, n_bricks);
  return static_cast<int>(cudaGetLastError());
}

// tab [n_bricks, 32F] f32, idx [M] int32, w [M, 32] f32 -> out [M, F] f32.
// F in {1, 2, 4, 8}.
extern "C" int gather_interp(const void* tab, const void* idx, const void* w,
                             void* out, int M, int F, int n_bricks,
                             void* stream) {
  if (M == 0) return 0;
  const float* tb = static_cast<const float*>(tab);
  const int* ix = static_cast<const int*>(idx);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_interp(tb, ix, wt, o, M, F, n_bricks, s);
}

// The same function on a bf16 table [n_bricks, 32F]: bitwise the f32
// entry's result on the table's values in f32.
extern "C" int gather_interp_bf16(const void* tab, const void* idx,
                                  const void* w, void* out, int M, int F,
                                  int n_bricks, void* stream) {
  if (M == 0) return 0;
  return dispatch_interp(static_cast<const __nv_bfloat16*>(tab),
                         static_cast<const int*>(idx),
                         static_cast<const float*>(w),
                         static_cast<float*>(out), M, F, n_bricks,
                         static_cast<cudaStream_t>(stream));
}

// The same function; the table's rows [0, hot) (at most what 227 KB holds
// as 27 bf16 entries: 538 rows at F = 8) are staged in shared memory.
extern "C" int gather_interp_mm(const void* tab, const void* idx,
                                const void* w, void* out, int M, int F,
                                int n_bricks, int hot, void* stream) {
  if (M == 0) return 0;
  const float* tb = static_cast<const float*>(tab);
  const int* ix = static_cast<const int*>(idx);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_interp_mm<1>(tb, ix, wt, o, M, n_bricks, hot, s);
    case 2: return launch_interp_mm<2>(tb, ix, wt, o, M, n_bricks, hot, s);
    case 4: return launch_interp_mm<4>(tb, ix, wt, o, M, n_bricks, hot, s);
    case 8: return launch_interp_mm<8>(tb, ix, wt, o, M, n_bricks, hot, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// g [M, 32F] f32, idx [M] int32; out [n_bricks, 32F] f32, zeroed by the
// caller. Rows [0, hot) (at most 768) accumulate in shared memory.
extern "C" int scatter_cols_accum(const void* g, const void* idx, void* out,
                                  int M, int F, int n_bricks, int hot,
                                  void* stream) {
  if (M == 0) return 0;
  const float* gp = static_cast<const float*>(g);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_scatter<1>(gp, ix, o, M, n_bricks, hot, s);
    case 2: return launch_scatter<2>(gp, ix, o, M, n_bricks, hot, s);
    case 4: return launch_scatter<4>(gp, ix, o, M, n_bricks, hot, s);
    case 8: return launch_scatter<8>(gp, ix, o, M, n_bricks, hot, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
