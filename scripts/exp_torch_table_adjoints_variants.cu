// scatter_cols_outer's function by a design it does not take, on no path:
// scripts/exp_torch_table_adjoints.py builds this file (the whole of
// nerf_vo_tpu_torch/csrc/gather.cu is included, for its kernels and
// helpers) and times it against the port's design (ids sorted by sort_ids,
// each id's terms summed in order, no atomics, one cooperative launch):
//
// - scatter_cols_outer_tri: the port's design with another row source,
//   OuterTri, which forms each weight W[r, e] in registers from the
//   descriptor's offsets frac[r] and base corner local[r] (36 bytes, read
//   by every lane of the descriptor) in place of reading W's 128-byte row:
//   (w0[i] w1[j]) w2[k], the f32 products in hash_grid._trilinear's order,
//   so that its result is bitwise the port's.

#include "nerf_vo_tpu_torch/csrc/gather.cu"

namespace {

// the weight of lattice point i on an axis: (i == lo) (1 - f) + (i == lo +
// 1) f, as hash_grid's axis weights give it bit for bit
__device__ __forceinline__ float axis_weight(int i, int lo, float f) {
  return i == lo ? 1.f - f : (i == lo + 1 ? f : 0.f);
}

// Outer<F> with W formed from (frac, local) of descriptor r = perm[t]
template <int F>
struct OuterTri {
  const float* frac;
  const long long* local;
  const float* cot;
  const int* perm;
  template <int R>
  __device__ __forceinline__ void load(long long t, int col, bool ok,
                                       float (&v)[8]) const {
    constexpr int E = F >= 8 ? 1 : 8 / F;  // entries the 8 columns span
    const long long r = ok ? __ldg(perm + t) : 0;
    float c[F < 8 ? F : 8];
    ld_floats_if<(F < 8 ? F : 8), false>(cot + r * F + col % F, ok, c);
    int lo[3];
    float f[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = ok ? static_cast<int>(__ldg(local + 3 * r + a)) : 0;
      f[a] = ok ? __ldg(frac + 3 * r + a) : 0.f;
    }
    float w[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = col / F + k;
      w[k] = ok && e < kEntries
                 ? (axis_weight(e / 9, lo[0], f[0]) *
                    axis_weight((e / 3) % 3, lo[1], f[1])) *
                       axis_weight(e % 3, lo[2], f[2])
                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = w[i / F] * c[i % F];
  }
};

}  // namespace

// frac [M, 3] f32, local [M, 3] int64, cot [M, F] f32; sidx, perm [M]
// int32 from sort_ids; out [n_bricks, 32F] f32, zeroed by the caller; part
// [slots, 32F] f32 and part_id [slots] int32 scratch, slots =
// scatter_cols_outer_tri_slots(M, F). scatter_cols_outer's function on the
// trilinear weights of (local, frac), bitwise its result.
extern "C" int scatter_cols_outer_tri(const void* frac, const void* local,
                                      const void* cot, const void* sidx,
                                      const void* perm, void* out,
                                      void* part, void* part_id, int M,
                                      int F, int n_bricks, void* stream) {
  if (M == 0) return 0;
  const float* fr = static_cast<const float*>(frac);
  const long long* lc = static_cast<const long long*>(local);
  const float* c = static_cast<const float*>(cot);
  const int* ix = static_cast<const int*>(sidx);
  const int* pm = static_cast<const int*>(perm);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(part);
  int* pi = static_cast<int*>(part_id);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_scatter_owned<1>(OuterTri<1>{fr, lc, c, pm}, ix, o,
                                           pt, pi, M, n_bricks, s);
    case 2: return launch_scatter_owned<2>(OuterTri<2>{fr, lc, c, pm}, ix, o,
                                           pt, pi, M, n_bricks, s);
    case 4: return launch_scatter_owned<4>(OuterTri<4>{fr, lc, c, pm}, ix, o,
                                           pt, pi, M, n_bricks, s);
    case 8: return launch_scatter_owned<8>(OuterTri<8>{fr, lc, c, pm}, ix, o,
                                           pt, pi, M, n_bricks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" long long scatter_cols_outer_tri_slots(int M, int F) {
  switch (F) {
    case 1: return owned_slots<1, OuterTri<1>>(M);
    case 2: return owned_slots<2, OuterTri<2>>(M);
    case 4: return owned_slots<4, OuterTri<4>>(M);
    case 8: return owned_slots<8, OuterTri<8>>(M);
    default: return -1;
  }
}
