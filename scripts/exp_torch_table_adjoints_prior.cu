// scatter_cols_outer as nerf_vo_tpu_torch/csrc/gather.cu had it before its
// ids were sorted by the port's own kernel: the ids sorted by the caller
// (torch.sort, stable; int64 positions), the runs kernel walking them in
// sorted order through the positions with the Outer row source and the
// OwnRuns sink, then scatter_combine_kernel, one block an id that spans
// lane groups' ranges, its partials summed in range order; three memsets
// of scratch before the two launches. On no path:
// scripts/exp_torch_table_adjoints.py builds this file on its own and
// times it beside the port's design. Besides the int64 positions it takes
// int32 ones (the port's sort_ids), to time the separate combine on the
// port's sort.
//
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ float4 ldcs_f4_if(const float* p, bool pred) {
  float4 v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %5, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\tmov.f32 %1, 0f00000000;\n\t"
      "mov.f32 %2, 0f00000000;\n\tmov.f32 %3, 0f00000000;\n\t"
      "@q ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

__device__ __forceinline__ float2 ldcs_f2_if(const float* p, bool pred) {
  float2 v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %3, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\tmov.f32 %1, 0f00000000;\n\t"
      "@q ld.global.cs.v2.f32 {%0, %1}, [%2];\n\t}"
      : "=f"(v.x), "=f"(v.y)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

__device__ __forceinline__ float ldcs_f1_if(const float* p, bool pred) {
  float v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %2, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\t"
      "@q ld.global.cs.f32 %0, [%1];\n\t}"
      : "=f"(v)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

template <int K, bool kStream>
__device__ __forceinline__ void ld_floats_if(const float* p, bool pred,
                                             float* v) {
  if constexpr (K >= 4) {
#pragma unroll
    for (int h = 0; h < K / 4; ++h) {
      const float4 x = kStream ? ldcs_f4_if(p + 4 * h, pred)
                               : ldg_f4_if(p + 4 * h, pred);
      v[4 * h + 0] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  } else if constexpr (K == 2) {
    const float2 x = kStream ? ldcs_f2_if(p, pred) : ldg_f2_if(p, pred);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = kStream ? ldcs_f1_if(p, pred)
                   : __uint_as_float(ldg_u1_if(p, pred));
  }
}

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

// row t of the id-sorted order is W[r] (x) cot[r] with r = perm[t]
// (positions of type P: int64 from torch.sort, int32 from sort_ids)
template <int F, typename P>
struct Outer {
  const float* W;
  const float* cot;
  const P* perm;
  template <int R>
  __device__ __forceinline__ void load(long long t, int col, bool ok,
                                       float (&v)[8]) const {
    constexpr int E = F >= 8 ? 1 : 8 / F;  // entries the 8 columns span
    const long long r = ok ? static_cast<long long>(__ldg(perm + t)) : 0;
    float w[E], c[F < 8 ? F : 8];
    ld_floats_if<E, true>(W + r * 32 + col / F, ok, w);
    ld_floats_if<(F < 8 ? F : 8), false>(cot + r * F + col % F, ok, c);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = w[i / F] * c[i % F];
  }
};

constexpr int kRunThreads = 512;
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kRunTile = 8;  // descriptors whose rows load at once

// A run's sum, stored where it is the id's whole sum; else into a partial
// row of the lane group's range (slot 2g for its first run, 2g + 1 for its
// last), code 2 b + 1 for the part that starts id b's sum, 2 b for a later
// one, the first parts' slots listed in `heads`.
struct OwnRuns {
  float* out;
  float* part;   // [2 * groups, R]
  int* part_id;  // [2 * groups]
  int* n_heads;  // [1]
  int* heads;    // [groups]
  struct Range {
    long long g;
    int prev, next;  // the ids just before and just after the range
  };
  __device__ __forceinline__ Range range(long long g, long long lo,
                                         long long hi, const int* idx,
                                         int M) const {
    const Range r{g, lo > 0 && lo <= M ? __ldg(idx + lo - 1) : -1,
                  hi < M ? __ldg(idx + hi) : -1};
    return r;
  }
  template <int R>
  __device__ __forceinline__ void put(const Range& r, int b, int j,
                                      const float (&acc)[8]) const {
    const bool from_prev = b == r.prev;
    float* o;
    if (!from_prev && b != r.next) {
      o = out + static_cast<long long>(b) * R;
    } else {
      const long long slot = 2 * r.g + (from_prev ? 0 : 1);
      o = part + slot * R;
      if (j == 0) {
        part_id[slot] = 2 * b + (from_prev ? 0 : 1);
        if (!from_prev) heads[atomicAdd(n_heads, 1)] = static_cast<int>(slot);
      }
    }
    float4* o4 = reinterpret_cast<float4*>(o + 8 * j);
    o4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
};

template <int F, typename Src, typename Sink>
__global__ void __launch_bounds__(kRunThreads, 1) scatter_runs_kernel(
    Src src, const int* __restrict__ idx, Sink sink, int M, int n_bricks,
    long long span) {
  constexpr int R = 32 * F;
  constexpr int L = R / 8;
  constexpr int G = 32 / L;
  constexpr int IDS = (kRunTile + L - 1) / L;  // ids a lane loads a tile
  const int lane = threadIdx.x & 31;
  const int q = lane / L;
  const int j = lane % L;
  const long long g =
      (static_cast<long long>(blockIdx.x) * kRunWarps + (threadIdx.x >> 5)) *
          G + q;
  const long long lo = g * span;
  const long long hi = lo + span < M ? lo + span : M;
  const typename Sink::Range rg = sink.range(g, lo, hi, idx, M);
  float acc[8] = {};
  int cur = -1;
  for (long long t0 = lo; t0 < lo + span; t0 += kRunTile) {
    int my[IDS];
#pragma unroll
    for (int k = 0; k < IDS; ++k) {
      const long long t = t0 + k * L + j;
      my[k] = k * L + j < kRunTile && t < hi ? __ldcs(idx + t) : -1;
    }
    int b[kRunTile];
    float v[kRunTile][8];
#pragma unroll
    for (int u = 0; u < kRunTile; ++u) {
      b[u] = __shfl_sync(0xffffffffu, my[u / L], q * L + u % L);
      const bool ok = b[u] >= 0 && b[u] < n_bricks;
      if (!ok) b[u] = -1;
      src.template load<R>(t0 + u, 8 * j, ok, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kRunTile; ++u) {
      if (b[u] < 0) continue;
      if (b[u] != cur) {
        if (cur >= 0) sink.template put<R>(rg, cur, j, acc);
        cur = b[u];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = v[u][i];
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += v[u][i];
      }
    }
  }
  if (cur >= 0) sink.template put<R>(rg, cur, j, acc);
}

template <int F, typename Src, typename Sink>
cudaError_t runs_grid(int M, long long* blocks, long long* span) {
  static KernelFacts facts[kMaxDevices];
  constexpr int groups = kRunWarps * (32 / (32 * F / 8));  // a block's
  cudaError_t err = resident_grid(scatter_runs_kernel<F, Src, Sink>, facts,
                                  kRunThreads, 0, 0, blocks);
  if (err != cudaSuccess) return err;
  const long long need = (M + groups * kRunTile - 1) / (groups * kRunTile);
  if (*blocks > need) *blocks = need;
  if (*blocks < 1) *blocks = 1;
  *span = (M + *blocks * groups - 1) / (*blocks * groups);
  return cudaSuccess;
}

template <int F, typename P>
long long own_slots(int M) {
  long long blocks = 0, span = 0;
  if (runs_grid<F, Outer<F, P>, OwnRuns>(M, &blocks, &span) != cudaSuccess)
    return -1;
  return 2 * blocks * kRunWarps * (32 / (32 * F / 8));
}

constexpr int kCombThreads = 512;
constexpr int kCombUnroll = 4;  // slots a thread loads at once

template <int F>
__global__ void __launch_bounds__(kCombThreads) scatter_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ part_id,
    const int* __restrict__ n_heads, const int* __restrict__ heads,
    float* __restrict__ out, int n_slots) {
  constexpr int R = 32 * F;
  constexpr int C = R / 4;             // float4 columns of a row
  constexpr int P = kCombThreads / C;  // slots summed at once
  __shared__ float4 red[kCombThreads];
  __shared__ int end;
  const int c4 = threadIdx.x % C;
  const int r = threadIdx.x / C;
  const int n = *n_heads;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int s = heads[i];
    const int b = part_id[s] >> 1;
    if (threadIdx.x == 0) end = n_slots;
    __syncthreads();
    for (int k0 = s + 1; k0 < n_slots; k0 += kCombThreads) {
      const int k = k0 + threadIdx.x;
      const int c = k < n_slots ? part_id[k] : -1;
      if (c >= 0 && c != 2 * b) atomicMin(&end, k);
      __syncthreads();
      const bool found = end < n_slots;
      __syncthreads();
      if (found) break;
    }
    const float4* col = reinterpret_cast<const float4*>(part) + c4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int k = s + r;
    for (; k + (kCombUnroll - 1) * P < end; k += kCombUnroll * P) {
      float4 v[kCombUnroll];
#pragma unroll
      for (int u = 0; u < kCombUnroll; ++u)
        v[u] = col[static_cast<long long>(k + u * P) * C];
#pragma unroll
      for (int u = 0; u < kCombUnroll; ++u) {
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
    }
    for (; k < end; k += P) {
      const float4 v = col[static_cast<long long>(k) * C];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    red[threadIdx.x] = acc;
    __syncthreads();
#pragma unroll
    for (int h = P / 2; h > 0; h >>= 1) {
      if (r < h) {
        const float4 v = red[threadIdx.x + h * C];
        red[threadIdx.x].x += v.x;
        red[threadIdx.x].y += v.y;
        red[threadIdx.x].z += v.z;
        red[threadIdx.x].w += v.w;
      }
      __syncthreads();
    }
    if (r == 0)
      reinterpret_cast<float4*>(out + static_cast<long long>(b) * R)[c4] =
          red[c4];
    __syncthreads();
  }
}

template <int F, typename P>
int launch_scatter_owned(const float* W, const float* cot, const int* sidx,
                         const P* perm, float* out, float* part, int* meta,
                         int M, int n_bricks, cudaStream_t stream) {
  long long blocks = 0, span = 0;
  cudaError_t err = runs_grid<F, Outer<F, P>, OwnRuns>(M, &blocks, &span);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int G = 32 / (32 * F / 8);
  const int n_slots = static_cast<int>(2 * blocks * kRunWarps * G);
  int* part_id = meta;
  int* n_heads = meta + n_slots;
  err = cudaMemsetAsync(part_id, 0xff, n_slots * sizeof(int), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(n_heads, 0, sizeof(int), stream);
  if (err == cudaSuccess)  // empty slots add zeros in the combine
    err = cudaMemsetAsync(part, 0, n_slots * sizeof(float) * 32 * F, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_runs_kernel<F, Outer<F, P>, OwnRuns>
      <<<static_cast<unsigned int>(blocks), kRunThreads, 0, stream>>>(
          Outer<F, P>{W, cot, perm}, sidx,
          OwnRuns{out, part, part_id, n_heads, n_heads + 1}, M, n_bricks,
          span);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = 4 * sm_count(dev);
  scatter_combine_kernel<F><<<grid, kCombThreads, 0, stream>>>(
      part, part_id, n_heads, n_heads + 1, out, n_slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int dispatch(const void* W, const void* cot, const void* sidx,
             const void* perm, void* out, void* part, void* meta, int M,
             int F, int n_bricks, void* stream) {
  if (M == 0) return 0;
  const float* w = static_cast<const float*>(W);
  const float* c = static_cast<const float*>(cot);
  const int* ix = static_cast<const int*>(sidx);
  const P* pm = static_cast<const P*>(perm);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(part);
  int* pi = static_cast<int*>(meta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_scatter_owned<1>(w, c, ix, pm, o, pt, pi, M,
                                           n_bricks, s);
    case 2: return launch_scatter_owned<2>(w, c, ix, pm, o, pt, pi, M,
                                           n_bricks, s);
    case 4: return launch_scatter_owned<4>(w, c, ix, pm, o, pt, pi, M,
                                           n_bricks, s);
    case 8: return launch_scatter_owned<8>(w, c, ix, pm, o, pt, pi, M,
                                           n_bricks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// W [M, 32] f32, cot [M, F] f32 (aligned to 4F bytes, 16 at F = 8); sidx
// [M] int32 the ids sorted, stably, and perm [M] their positions (int64;
// int32 in the _perm32 entry); out [n_bricks, 32F] f32, zeroed by the
// caller. part [slots, 32F] f32 and meta [2 slots + 1] int32 are scratch,
// slots = scatter_cols_outer_prior_slots(M, F, bytes of a position).
extern "C" int scatter_cols_outer_prior(const void* W, const void* cot,
                                        const void* sidx, const void* perm,
                                        void* out, void* part, void* meta,
                                        int M, int F, int n_bricks,
                                        void* stream) {
  return dispatch<long long>(W, cot, sidx, perm, out, part, meta, M, F,
                             n_bricks, stream);
}

extern "C" int scatter_cols_outer_prior_perm32(const void* W, const void* cot,
                                               const void* sidx,
                                               const void* perm, void* out,
                                               void* part, void* meta, int M,
                                               int F, int n_bricks,
                                               void* stream) {
  return dispatch<int>(W, cot, sidx, perm, out, part, meta, M, F, n_bricks,
                       stream);
}

template <typename P>
long long slots(int M, int F) {
  switch (F) {
    case 1: return own_slots<1, P>(M);
    case 2: return own_slots<2, P>(M);
    case 4: return own_slots<4, P>(M);
    case 8: return own_slots<8, P>(M);
    default: return -1;
  }
}

// the scratch slots of either entry: perm_bytes 8 (int64) or 4 (int32)
extern "C" long long scatter_cols_outer_prior_slots(int M, int F,
                                                    int perm_bytes) {
  return perm_bytes == 4 ? slots<int>(M, F) : slots<long long>(M, F);
}
