// The interlevel (proposal histogram) loss of the mapping model, for Hopper
// (sm_90a): ops/rendering.py's interlevel_loss with its [R, B, K]
// indicator contraction formed in registers.
//
// For each ray r, proposal histogram (pe [B+1] edges, pw [B] weights) and
// final histogram (fe [K+1] edges, fw [K] weights), the plain version
// (rendering._outer_bounds) computes
//
//   hi[k] = sum_b pw[b] [pe[b] < fe[k+1]]
//   lo[k] = sum_b pw[b] [pe[b+1] <= fe[k]]
//   bound[k] = hi[k] - lo[k]
//   loss = mean_{r,k} max(fw[k] - bound[k], 0)^2 / max(fw[k], 1e-7)
//
// as two broadcast compares into [R, B, K] bools, two casts to f32 and two
// batched GEMMs with M = 1, and autograd's backward runs two more GEMMs on
// the f32 indicators it kept: at vo.map's step (R 4096, B 256 and 96, K
// 48) 138 M indicator elements, ~1.9 GB moved and 554 MB held from the
// forward to the backward. These two kernels read only the histograms:
//
//   interlevel_fwd_kernel  part[r] = sum_k max(fw - bound, 0)^2 /
//       max(fw, 1e-7), and clipped[r, k] = max(fw - bound, 0), the
//       backward's only saved state
//   interlevel_bwd_kernel  dpw[r, b] = sum_k g[k] ([pe[b] < fe[k+1]] -
//       [pe[b+1] <= fe[k]]), g[k] = -(gpart[r] / max(fw, 1e-7)) (2
//       clipped[k]), the derivative autograd forms for bound[k] from the
//       per-ray partial's gradient
//
// The edges and fw take no gradient (the loss detaches them). The same two
// prefix sets are summed apart and then subtracted, with the plain
// version's <= and < ties, and nothing assumes monotone edges: jittered
// bins can round to equal or swapped edges, and cummax leaves zero-width
// final bins. An indicator is 0 or 1 in f32, multiplied into the sum as
// the GEMM multiplies it.
//
// Design. One warp a ray, 4 rays a block, no atomics and no shared state
// between warps. The forward stages the ray's pe and pw in shared memory
// (2B + 1 floats a warp), gives each lane the final bins k = lane + 32i
// (kFwdTile of them a pass), and sums over b ascending with every lane
// reading the same pe / pw word (a broadcast); the per-ray partial is the
// lane's terms in k order, then a butterfly over the warp's 32 lanes. The
// backward stages fe and g (2K + 1 floats), gives lanes the proposal bins b
// = lane + 32i (kBwdTile a pass) and sums over k ascending. Every sum is
// in a fixed order, so a call gives the same bits every time.
//
// What bounds them: per ray each kernel makes 2 B K compare-and-adds (one
// a prefix set and (b, k)), on ~8 KB of input. At vo.map's shapes
// the forward reads 10.0 MB of pe, pw, fe, fw for proposal 0 and 4.8 MB for
// proposal 1 (~3.0 and ~1.4 us at 3.35 TB/s) and makes 4 R B K operations
// counting a compare and an add each (0.20 and 0.08 G, ~3.0 and ~1.1 us at
// f32's 67 TFLOP/s): bytes and operations set the pace together.
// chip_smoke.py (a) times both kernels beside the plain chain.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays a block
constexpr int kFwdTile = 2;  // final bins a lane a pass: 64 a warp
constexpr int kBwdTile = 4;  // proposal bins a lane a pass: 128 a warp
constexpr int kMaxBins = 1024;  // B and K (rendering_cuda.MAX_BINS): 4 x
                                // (2 x 1024 + 1) floats a block
constexpr unsigned int kAll = 0xffffffffu;

// max(x, 0) and max(x, 1e-7) as torch.clamp computes them: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__global__ void __launch_bounds__(kWarps * 32) interlevel_fwd_kernel(
    const float* __restrict__ pe, const float* __restrict__ pw,
    const float* __restrict__ fe, const float* __restrict__ fw,
    float* __restrict__ part, float* __restrict__ clipped, int R, int B,
    int K) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= R) return;  // the whole warp
  float* s_pe = smem + warp * (2 * B + 1);
  float* s_pw = s_pe + B + 1;
  const float* pe_r = pe + r * (B + 1);
  const float* pw_r = pw + r * B;
  for (int i = lane; i <= B; i += 32) s_pe[i] = pe_r[i];
  for (int i = lane; i < B; i += 32) s_pw[i] = pw_r[i];
  __syncwarp();

  const float* fe_r = fe + r * (K + 1);
  const float* fw_r = fw + r * K;
  float* c_r = clipped + r * K;
  float total = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32 * kFwdTile) {
    float f_lo[kFwdTile], f_hi[kFwdTile], hi[kFwdTile], lo[kFwdTile];
#pragma unroll
    for (int i = 0; i < kFwdTile; ++i) {
      const int k = k0 + lane + 32 * i;
      f_lo[i] = k < K ? fe_r[k] : 0.f;
      f_hi[i] = k < K ? fe_r[k + 1] : 0.f;
      hi[i] = 0.f;
      lo[i] = 0.f;
    }
    for (int b = 0; b < B; ++b) {
      const float p0 = s_pe[b];
      const float p1 = s_pe[b + 1];
      const float w = s_pw[b];
#pragma unroll
      for (int i = 0; i < kFwdTile; ++i) {
        hi[i] = fmaf(w, p0 < f_hi[i] ? 1.f : 0.f, hi[i]);
        lo[i] = fmaf(w, p1 <= f_lo[i] ? 1.f : 0.f, lo[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kFwdTile; ++i) {
      const int k = k0 + lane + 32 * i;
      if (k < K) {
        const float f = fw_r[k];
        const float c = clamp_min(f - (hi[i] - lo[i]), 0.f);
        c_r[k] = c;
        total += (c * c) / clamp_min(f, 1e-7f);
      }
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) total += __shfl_xor_sync(kAll, total, s);
  if (lane == 0) part[r] = total;
}

__global__ void __launch_bounds__(kWarps * 32) interlevel_bwd_kernel(
    const float* __restrict__ pe, const float* __restrict__ fe,
    const float* __restrict__ fw, const float* __restrict__ clipped,
    const float* __restrict__ gpart, float* __restrict__ dpw, int R, int B,
    int K) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= R) return;  // the whole warp
  float* s_fe = smem + warp * (2 * K + 1);
  float* s_g = s_fe + K + 1;
  const float* fe_r = fe + r * (K + 1);
  const float* fw_r = fw + r * K;
  const float* c_r = clipped + r * K;
  const float go = gpart[r];
  for (int i = lane; i <= K; i += 32) s_fe[i] = fe_r[i];
  for (int k = lane; k < K; k += 32)
    s_g[k] = -((go / clamp_min(fw_r[k], 1e-7f)) * (2.f * c_r[k]));
  __syncwarp();

  const float* pe_r = pe + r * (B + 1);
  float* d_r = dpw + r * B;
  for (int b0 = 0; b0 < B; b0 += 32 * kBwdTile) {
    float p0[kBwdTile], p1[kBwdTile], acc[kBwdTile];
#pragma unroll
    for (int i = 0; i < kBwdTile; ++i) {
      const int b = b0 + lane + 32 * i;
      p0[i] = b < B ? pe_r[b] : 0.f;
      p1[i] = b < B ? pe_r[b + 1] : 0.f;
      acc[i] = 0.f;
    }
    for (int k = 0; k < K; ++k) {
      const float f_lo = s_fe[k];
      const float f_hi = s_fe[k + 1];
      const float g = s_g[k];
#pragma unroll
      for (int i = 0; i < kBwdTile; ++i) {
        const float ind = (p0[i] < f_hi ? 1.f : 0.f) -
                          (p1[i] <= f_lo ? 1.f : 0.f);
        acc[i] = fmaf(g, ind, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBwdTile; ++i) {
      const int b = b0 + lane + 32 * i;
      if (b < B) d_r[b] = acc[i];
    }
  }
}

unsigned int blocks(int R) {
  return static_cast<unsigned int>((static_cast<long long>(R) + kWarps - 1) /
                                   kWarps);
}

}  // namespace

// pe [R, B+1], pw [R, B], fe [R, K+1], fw [R, K] f32 -> part [R],
// clipped [R, K] f32. B and K in [0, kMaxBins].
extern "C" int interlevel_fwd(const void* pe, const void* pw, const void* fe,
                              const void* fw, void* part, void* clipped,
                              int R, int B, int K, void* stream) {
  if (R == 0) return 0;
  if (R < 0 || B < 0 || K < 0 || B > kMaxBins || K > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kWarps * (2 * B + 1);
  interlevel_fwd_kernel<<<blocks(R), kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pe), static_cast<const float*>(pw),
      static_cast<const float*>(fe), static_cast<const float*>(fw),
      static_cast<float*>(part), static_cast<float*>(clipped), R, B, K);
  return static_cast<int>(cudaGetLastError());
}

// pe [R, B+1], fe [R, K+1], fw [R, K], clipped [R, K] (the forward's),
// gpart [R] f32 (the partial's gradient) -> dpw [R, B] f32.
extern "C" int interlevel_bwd(const void* pe, const void* fe, const void* fw,
                              const void* clipped, const void* gpart,
                              void* dpw, int R, int B, int K, void* stream) {
  if (R == 0 || B == 0) return 0;
  if (R < 0 || B < 0 || K < 0 || B > kMaxBins || K > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kWarps * (2 * K + 1);
  interlevel_bwd_kernel<<<blocks(R), kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pe), static_cast<const float*>(fe),
      static_cast<const float*>(fw), static_cast<const float*>(clipped),
      static_cast<const float*>(gpart), static_cast<float*>(dpw), R, B, K);
  return static_cast<int>(cudaGetLastError());
}
