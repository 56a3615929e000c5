// scatter_cols_outer's function by the two designs it does not take, on no
// path: scripts/exp_torch_table_adjoints.py builds this file (the whole of
// nerf_vo_tpu_torch/csrc/gather.cu is included, for its kernels and
// helpers) and times both against the port's design (ids sorted, each
// id's terms summed in order, no atomics):
//
// - scatter_cols_outer_atomic_runs: the runs kernel on the ids in the
//   order given (level-major, ray-major), each run's sum added with float4
//   atomics (AddRuns), as scatter_cols_accum does at F <= 2; any F;
// - scatter_cols_outer_slabs: the slabs of scatter_cols_accum_kernel
//   (32-column slabs, rows [0, hot) accumulated in shared memory, float4
//   atomics, zero 16-byte pieces left out), with each row formed as
//   W (x) cot in registers in place of loaded; F = 8.
//
// Both sum in an order that changes from call to call.

#include "nerf_vo_tpu_torch/csrc/gather.cu"

namespace {

// row t of W (x) cot in the order given: Outer<F> without the permutation
template <int F>
struct OuterInOrder {
  const float* W;
  const float* cot;
  template <int R>
  __device__ __forceinline__ void load(long long t, int col, bool ok,
                                       float (&v)[8]) const {
    constexpr int E = F >= 8 ? 1 : 8 / F;
    float w[E], c[F < 8 ? F : 8];
    ld_floats_if<E, true>(W + t * 32 + col / F, ok, w);
    ld_floats_if<(F < 8 ? F : 8), false>(cot + t * F + col % F, ok, c);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = w[i / F] * c[i % F];
  }
};

// columns col..col+3 (col a multiple of 4) of row t of W (x) cot at F = 8:
// entry col / 8, features col % 8..col % 8 + 3; zeros where !ok
__device__ __forceinline__ float4 outer8(const float* W, const float* cot,
                                         long long t, int col, bool ok) {
  float w[1], c[4];
  ld_floats_if<1, true>(W + t * 32 + col / 8, ok, w);
  ld_floats_if<4, false>(cot + t * 8 + col % 8, ok, c);
  return make_float4(w[0] * c[0], w[0] * c[1], w[0] * c[2], w[0] * c[3]);
}

__global__ void __launch_bounds__(kScThreads) scatter_outer_slabs_kernel(
    const float* __restrict__ W, const float* __restrict__ cot,
    const int* __restrict__ idx, float* __restrict__ out, int M,
    int n_bricks, int hot) {
  constexpr int F = 8;
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
        v[k] = outer8(W, cot, bt + d, s * kSlab + 4 * c4,
                      b[k] >= 0 && b[k] < n_bricks);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int bk = b[k];
        if (bk < 0 || bk >= n_bricks || !nonzero(v[k])) continue;
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

  for (int i = threadIdx.x; i < hot * 8; i += kScThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    const float4 v = make_float4(
        sc_smem[slab_pos(r, c + 0)], sc_smem[slab_pos(r, c + 1)],
        sc_smem[slab_pos(r, c + 2)], sc_smem[slab_pos(r, c + 3)]);
    if (nonzero(v))
      atomicAdd(reinterpret_cast<float4*>(
                    out + static_cast<long long>(r) * R + s * kSlab + c), v);
  }
}

}  // namespace

// W [M, 32] f32, cot [M, 8] f32 (16-byte aligned), idx [M] int32; out
// [n_bricks, 256] f32, zeroed by the caller; rows [0, hot) (at most 768)
// accumulate in shared memory. The function of scatter_cols_outer at F = 8.
extern "C" int scatter_cols_outer_slabs(const void* W, const void* cot,
                                        const void* idx, void* out, int M,
                                        int n_bricks, int hot, void* stream) {
  if (M == 0) return 0;
  constexpr int F = 8;
  static KernelFacts facts[kMaxDevices];
  hot = hot < 0 ? 0 : hot;
  if (hot > n_bricks) hot = n_bricks;
  if (hot > kScHotMax) hot = kScHotMax;
  const int smem = hot * kSlab * 4;
  long long chunks = 0;
  cudaError_t err = resident_grid(scatter_outer_slabs_kernel, facts,
                                  kScThreads, kScHotMax * kSlab * 4, smem,
                                  &chunks);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunks /= F;
  const long long need = (M + kScWarps * 32 - 1) / (kScWarps * 32);
  if (chunks > need) chunks = need;
  if (chunks < 1) chunks = 1;
  scatter_outer_slabs_kernel<<<static_cast<unsigned int>(chunks * F),
                               kScThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(cot),
      static_cast<const int*>(idx), static_cast<float*>(out), M, n_bricks,
      hot);
  return static_cast<int>(cudaGetLastError());
}

// W [M, 32] f32, cot [M, F] f32, idx [M] int32 (any order); out [n_bricks,
// 32F] f32, zeroed by the caller. The function of scatter_cols_outer.
extern "C" int scatter_cols_outer_atomic_runs(const void* W, const void* cot,
                                              const void* idx, void* out,
                                              int M, int F, int n_bricks,
                                              void* stream) {
  if (M == 0) return 0;
  const float* w = static_cast<const float*>(W);
  const float* c = static_cast<const float*>(cot);
  const int* ix = static_cast<const int*>(idx);
  const AddRuns sink{static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_scatter_runs<1>(OuterInOrder<1>{w, c}, sink, ix, M,
                                          n_bricks, s);
    case 2: return launch_scatter_runs<2>(OuterInOrder<2>{w, c}, sink, ix, M,
                                          n_bricks, s);
    case 4: return launch_scatter_runs<4>(OuterInOrder<4>{w, c}, sink, ix, M,
                                          n_bricks, s);
    case 8: return launch_scatter_runs<8>(OuterInOrder<8>{w, c}, sink, ix, M,
                                          n_bricks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
