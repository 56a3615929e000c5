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
//   gather_interp_mm   <- gather_interp_mm (:219, kernel :171)
//       the same function, contracted as ((w @ E) * g) @ S with the 0/1
//       matrices E[e, r] = [r / F == e] and S[r, f] = [r % F == f] over a
//       tile of descriptors staged in shared memory (the identity at
//       gather_pallas.py:177-181)
//   scatter_cols_accum <- scatter_cols_accum (:297, kernel :252)
//       out[b, :] += g[t, :] for every t with idx[t] == b     f32 atomics
//
// bf16(.) is round-to-nearest-even, done in registers on the f32 parameter
// table: no bf16 copy of the table is made. Weights, sums and outputs of the
// interpolation are f32 (the Pallas contract had bf16 w and out). A
// descriptor whose id lies outside [0, n_bricks) reads zeros (gathers) or is
// dropped (scatter).
//
// What bounds them on an H100, at the replica configuration's mapping step
// (field: 4096 rays x 48 samples = 196,608 descriptors per level; F = 8, R =
// 256; proposals F = 1, R = 32): all four move bytes and do next to no
// arithmetic (at most 32F multiply-adds per descriptor), so the bound is
// bytes over 3.35 TB/s. Per descriptor, gather_interp reads its w row
// (128 B) and one table row (1 KB at F = 8) and writes 32 B; gather_cols
// writes a 512 B bf16 row; scatter_cols_accum reads a 1 KB f32 cotangent row
// and issues 256 atomics into one 1 KB table row. The table rows are random
// (hashed) accesses of whole rows: each warp reads or writes 1 KB contiguous,
// so the accesses stay coalesced. The level-0 scatter concentrates ~384
// descriptors on each of 512 bricks: that atomic contention is timed, not
// designed away here.
//
// Bounds at those shapes (bytes moved once over 3.35 TB/s, as chip_smoke.py
// phase (a) computes them from its inputs):
//   gather_cols        M 589,824 x 256: 302 MB out + touched rows  ~0.10 ms
//   gather_interp      M 393,216, F 8 (hashed levels 1-2): ~98 MB  ~0.029 ms
//   gather_interp_mm   M 196,608, F 8 (level 0, 512 bricks): ~33 MB ~0.010 ms
//   scatter_cols_accum M 589,824 x 256 into 49,152 bricks: 657 MB ~0.20 ms
//
// Design: one warp per descriptor for the row gathers (lane e holds brick
// entry e, a warp-shuffle tree reduces over entries); one thread per
// (descriptor, row) for the scatter. Simple and correct first; faster
// versions (several descriptors per warp at F = 1, vector atomics, sorting
// by brick) are later work.
//
// Plain C interface, bound with ctypes (nerf_vo_tpu_torch/ops/gather_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
// gather_interp: one warp per descriptor, lane e = brick entry e
// ---------------------------------------------------------------------------

template <int F>
__global__ void __launch_bounds__(kThreads) gather_interp_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ w, float* __restrict__ out, int M,
    int n_bricks) {
  constexpr int R = 32 * F;
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= M) return;
  const int b = idx[t];
  const bool ok = b >= 0 && b < n_bricks;
  const float we = w[t * 32 + lane];
  float acc[F];
  const float* row = tab + static_cast<long long>(ok ? b : 0) * R + lane * F;
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int v = 0; v < F / 4; ++v) {
      float4 x = ok ? reinterpret_cast<const float4*>(row)[v]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[4 * v + 0] = we * bf16_round(x.x);
      acc[4 * v + 1] = we * bf16_round(x.y);
      acc[4 * v + 2] = we * bf16_round(x.z);
      acc[4 * v + 3] = we * bf16_round(x.w);
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = ok ? we * bf16_round(row[f]) : 0.f;
  }
  // sum over the 32 entries (lanes)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int f = 0; f < F; ++f)
      acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) out[t * F + f] = acc[f];
  }
}

// ---------------------------------------------------------------------------
// gather_interp_mm: a tile of T descriptors per block; the contraction is
// written as the two 0/1-matrix products of the TPU kernel
// ---------------------------------------------------------------------------

template <int F>
struct MmTile {
  static constexpr int R = 32 * F;
  // g tile [T][R] + w tile [T][32] floats, under the 48 KB static limit
  static constexpr int T = F >= 8 ? 32 : (F >= 2 ? 64 : 128);
};

template <int F>
__global__ void __launch_bounds__(kThreads) gather_interp_mm_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ w, float* __restrict__ out, int M,
    int n_bricks) {
  constexpr int R = MmTile<F>::R;
  constexpr int T = MmTile<F>::T;
  __shared__ __align__(16) float gs[T * R];
  __shared__ float ws[T * 32];
  __shared__ int ids[T];
  const long long t0 = static_cast<long long>(blockIdx.x) * T;
  for (int i = threadIdx.x; i < T; i += kThreads) {
    const long long t = t0 + i;
    ids[i] = t < M ? idx[t] : -1;
  }
  for (int i = threadIdx.x; i < T * 32; i += kThreads) {
    const long long t = t0 + i / 32;
    ws[i] = t < M ? w[t0 * 32 + i] : 0.f;
  }
  __syncthreads();
  // stage the bf16-rounded table rows of the tile, 16 bytes per load
  constexpr int nvec = R / 4;
  for (int i = threadIdx.x; i < T * nvec; i += kThreads) {
    const int tt = i / nvec;
    const int v = i - tt * nvec;
    const int b = ids[tt];
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b >= 0 && b < n_bricks)
      x = reinterpret_cast<const float4*>(tab + static_cast<long long>(b) * R)[v];
    float4 y = make_float4(bf16_round(x.x), bf16_round(x.y), bf16_round(x.z),
                           bf16_round(x.w));
    reinterpret_cast<float4*>(gs)[i] = y;
  }
  __syncthreads();
  // prod[t, r] = (w @ E)[t, r] * g[t, r], E[e, r] = [r / F == e]
  for (int i = threadIdx.x; i < T * R; i += kThreads) {
    const int tt = i / R;
    const int r = i - tt * R;
    float wexp = 0.f;
#pragma unroll 8
    for (int e = 0; e < 32; ++e) {
      const float E = (r / F == e) ? 1.f : 0.f;
      wexp = fmaf(ws[tt * 32 + e], E, wexp);
    }
    gs[i] = wexp * gs[i];
  }
  __syncthreads();
  // out[t, f] = (prod @ S)[t, f], S[r, f] = [r % F == f]
  for (int i = threadIdx.x; i < T * F; i += kThreads) {
    const int tt = i / F;
    const int f = i - tt * F;
    const long long t = t0 + tt;
    float acc = 0.f;
    for (int r = 0; r < R; ++r) {
      const float S = (r % F == f) ? 1.f : 0.f;
      acc = fmaf(gs[tt * R + r], S, acc);
    }
    if (t < M) out[t * F + f] = acc;
  }
}

// ---------------------------------------------------------------------------
// scatter_cols_accum: one thread per (descriptor, row), f32 atomics
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) scatter_cols_accum_kernel(
    const float* __restrict__ g, const int* __restrict__ idx,
    float* __restrict__ out, long long total, int R, int n_bricks) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long t = i / R;
  const int r = static_cast<int>(i - t * R);
  const int b = idx[t];
  if (b < 0 || b >= n_bricks) return;
  atomicAdd(out + static_cast<long long>(b) * R + r, g[i]);
}

template <int F>
int launch_interp(bool mm, const float* tab, const int* idx, const float* w,
                  float* out, int M, int n_bricks, cudaStream_t stream) {
  if (mm) {
    constexpr int T = MmTile<F>::T;
    static_assert(sizeof(float) * (T * MmTile<F>::R + T * 32) + sizeof(int) * T
                      <= 48 * 1024,
                  "gather_interp_mm tile exceeds static shared memory");
    const int blocks = (M + T - 1) / T;
    gather_interp_mm_kernel<F><<<blocks, kThreads, 0, stream>>>(
        tab, idx, w, out, M, n_bricks);
  } else {
    const int blocks = (M + kWarps - 1) / kWarps;
    gather_interp_kernel<F><<<blocks, kThreads, 0, stream>>>(
        tab, idx, w, out, M, n_bricks);
  }
  return static_cast<int>(cudaGetLastError());
}

int interp(bool mm, const void* tab, const void* idx, const void* w, void* out,
           int M, int F, int n_bricks, void* stream) {
  if (M == 0) return 0;
  const float* tb = static_cast<const float*>(tab);
  const int* ix = static_cast<const int*>(idx);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_interp<1>(mm, tb, ix, wt, o, M, n_bricks, s);
    case 2: return launch_interp<2>(mm, tb, ix, wt, o, M, n_bricks, s);
    case 4: return launch_interp<4>(mm, tb, ix, wt, o, M, n_bricks, s);
    case 8: return launch_interp<8>(mm, tb, ix, wt, o, M, n_bricks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every entry point launches on `stream` and returns the cudaError_t of the
// launch (0 on success). The caller guarantees contiguous tensors, 16-byte
// aligned table and output pointers, and R = 32 * F.

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
  return interp(false, tab, idx, w, out, M, F, n_bricks, stream);
}

extern "C" int gather_interp_mm(const void* tab, const void* idx,
                                const void* w, void* out, int M, int F,
                                int n_bricks, void* stream) {
  return interp(true, tab, idx, w, out, M, F, n_bricks, stream);
}

// g [M, R] f32, idx [M] int32; out [n_bricks, R] f32, zeroed by the caller.
extern "C" int scatter_cols_accum(const void* g, const void* idx, void* out,
                                  int M, int R, int n_bricks, void* stream) {
  if (M == 0) return 0;
  const long long total = static_cast<long long>(M) * R;
  const long long blocks = (total + kThreads - 1) / kThreads;
  scatter_cols_accum_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(idx),
      static_cast<float*>(out), total, R, n_bricks);
  return static_cast<int>(cudaGetLastError());
}
