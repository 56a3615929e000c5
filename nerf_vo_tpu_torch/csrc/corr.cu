// Patch-correlation window lookup, both pyramid levels in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel nerf_vo_tpu/ops/correlation_pallas.py
// (corr_window_dot / _corr_kernel, wrapped by _level_pallas and
// patch_correlation_pallas) and computes the whole of that wrapper's work:
//
//   for every edge e and level l (l = 0, 1; level 1 at half resolution):
//     1. the (2r+4)^2 window of fmap_l[ring[e]] whose top-left corner is
//        floor(c) - (r+1), c = center[e] * 2^-l; pixels outside the frame
//        read as 0 (no padded copy of the feature ring is made);
//     2. if c lies outside [0, W_l-1] x [0, H_l-1] (or the slot is out of
//        range), zeros (the Pallas route's rule: the whole window is
//        dropped);
//     3. the 9 patch pixels dotted with every window pixel: bf16 x bf16
//        products, f32 sums;
//     4. the bilinear blend of those scalars with c's fractional offset;
//     5. [9, 2r+1, 2r+1] f32 in (p, dy, dx) order at
//        out + e * out_stride + l * 9 (2r+1)^2.
//
// What bounds it on an H100. At the replica configuration (30,240 edges,
// ~26.3k usable a level, C = 128, r = 3) the dots are 12.1 GFLOP per update
// and the bytes that must move are the patch features (70 MB), the output
// (107 MB) and the feature pixels some window covers: ~0.1 ms at 3.35 TB/s,
// 12 us at the bf16 tensor-core rate. But every edge reads its own 25.6 KB
// window per level, ~1.35 GB per update from L2: on an H100 (700 W) that
// traffic alone, with the dots and the blend taken out, takes ~0.19 ms in
// target-slot order, where one frame's windows stay in L2, and ~0.31 ms in
// an arbitrary order, where the 118 MB level-0 ring does not fit the 50 MB
// L2. The dots and the blend (four warps a SM, one per scheduler) overlap
// it to ~0.28 ms (scripts/exp_torch_corr_phases.py). What is left between
// that and the bound is the re-read windows: edges into one frame region
// sharing a staged tile is the next step.
//
// Design.
// - One launch per update: a warp takes one edge at a time and does both
//   levels; the patch features are read from memory once per edge, straight
//   into the registers of the A operand of both levels.
// - The dots run on the tensor cores: mma.sync m16n8k16 bf16 -> f32. A is
//   the 9 patch pixels (rows 9..15 zero) x C, B is the window pixels x C
//   (NHWC keeps a pixel's channels contiguous: the "col" operand), fed by
//   ldmatrix. r = 3: 13 n-tiles of 8 pixels x C/16 k-steps, 104 mma per
//   edge and level. C is zero-padded to 16 KS (KS = 1, 2, 4, 8): any
//   C % 8 == 0 up to 128.
// - Windows are staged by the Tensor Memory Accelerator: one 4-d tensor
//   copy (channels, x, y, slot) per 64 channels, issued by one lane. The
//   hardware zero-fills what lies outside the frame (and channels past C),
//   so the border costs no branch, and writes the 128-byte (64-, 32-byte
//   for C <= 32) swizzle, so that ldmatrix's 8 rows hit 8 different bank
//   groups. Each warp owns two window buffers with an mbarrier each: one
//   level's window is in flight while the other level's dots run. (Staging
//   with per-lane 16-byte cp.async instead kept each warp busy issuing
//   copies: 0.85 ms per update on an H100.)
// - Persistent grid, one block of up to 4 warps per SM (r = 3, C = 128:
//   57 KB of shared memory a warp); warps stride over the edges. On the
//   tracker's path the launch first sorts the edges by target slot itself
//   (a counting sort with two grid-wide barriers, the launch cooperative:
//   ~12 us, where torch.argsort in the wrapper cost ~56 us) so that the
//   warps walk one frame at a time; the one-level entry walks the edges in
//   the caller's order. Each edge writes its own output row whatever the
//   order.
//
// Plain C interface, bound with ctypes (nerf_vo_tpu_torch/ops/correlation_cuda.py).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;      // warps per block
constexpr int kSmemMax = 232448;  // dynamic shared memory of one sm_90 block
constexpr int kPatch = 9;         // patch pixels (3 x 3)
constexpr int kMaxDevices = 64;
constexpr int kMaxBlocks = 1024;  // blocks the slot sort keeps counts for

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The staging geometry for C padded to 16 KS channels: each tensor copy
// (box) brings BI channels of every window pixel as rows of RB bytes, with
// the TMA swizzle of the same width; NB boxes cover the channels.
template <int KS>
struct Stage {
  static constexpr int BI = 16 * KS < 64 ? 16 * KS : 64;
  static constexpr int RB = 2 * BI;
  static constexpr int NB = 16 * KS / BI;
  static constexpr int CPB = RB / 16;  // 16-byte chunks of a row
};

// Byte offset in a window buffer of 16-byte chunk c (of the 2 KS of a
// pixel) of window pixel n. box_bytes is a multiple of 1024, so each box
// starts where the swizzle pattern does.
template <int KS>
__device__ __forceinline__ uint32_t win_off(int n, int c, int box_bytes) {
  using S = Stage<KS>;
  const uint32_t logical = n * S::RB + (c % S::CPB) * 16;
  return (c / S::CPB) * box_bytes +
         (logical ^ (((logical >> 7) & (S::CPB - 1)) << 4));
}

struct Edge {
  int e;         // output row, -1 past the end
  int f;         // ring slot
  float cx, cy;  // level-0 centre
};

__device__ __forceinline__ Edge fetch_edge(long long i, int E,
                                           const int* order,
                                           const int* __restrict__ ring,
                                           const float* __restrict__ center) {
  Edge d{-1, -1, 0.f, 0.f};
  if (i < E) {
    d.e = order ? __ldcg(order + i) : static_cast<int>(i);
    d.f = __ldg(ring + d.e);
    const float2 c = __ldg(reinterpret_cast<const float2*>(center) + d.e);
    d.cx = c.x;
    d.cy = c.y;
  }
  return d;
}

struct LevelGeom {
  bool usable;
  int ix, iy;    // window origin
  float fx, fy;  // fractional offset
};

__device__ __forceinline__ LevelGeom level_geom(const Edge& d, float scale,
                                                int R, int H, int W,
                                                int radius, bool on) {
  LevelGeom g{false, 0, 0, 0.f, 0.f};
  const float cx = d.cx * scale;
  const float cy = d.cy * scale;
  g.usable = on && d.e >= 0 && d.f >= 0 && d.f < R && cx >= 0.f &&
             cx <= static_cast<float>(W - 1) && cy >= 0.f &&
             cy <= static_cast<float>(H - 1);
  if (g.usable) {
    const float x0 = floorf(cx);
    const float y0 = floorf(cy);
    g.fx = cx - x0;
    g.fy = cy - y0;
    g.ix = static_cast<int>(x0) - (radius + 1);
    g.iy = static_cast<int>(y0) - (radius + 1);
  }
  return g;
}

// Lane 0: the window of one level into buf, completion on bar.
template <int KS>
__device__ __forceinline__ void issue_window(uint32_t buf, uint32_t bar,
                                             const CUtensorMap* map,
                                             const Edge& d, const LevelGeom& g,
                                             int box_bytes, int win_bytes) {
  using S = Stage<KS>;
  mbar_expect_tx(bar, win_bytes);
#pragma unroll
  for (int b = 0; b < S::NB; ++b)
    tma_load_4d(buf + b * box_bytes, map, b * S::BI, g.ix, g.iy, d.f, bar);
}

// The A fragments of edge e straight from memory: row g = lane / 4 (and
// row 8 for g = 0), channels 16 ks + 2 (lane % 4) (+1, +8, +9); rows 9..15
// and channels past C are zero.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4],
                                       const __nv_bfloat16* __restrict__ pf,
                                       int e, int C, int lane) {
  const int g = lane >> 2;
  const int k = 2 * (lane & 3);
  const uint32_t* base = reinterpret_cast<const uint32_t*>(
      pf + static_cast<size_t>(e < 0 ? 0 : e) * kPatch * C);
  const uint32_t* r0 = base + (g * C) / 2;
  const uint32_t* r8 = base + (8 * C) / 2;
  const bool ok = e >= 0;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = 16 * ks + k;
    const bool lo = ok && k0 < C;
    const bool hi = ok && k0 + 8 < C;
    a[ks][0] = lo ? __ldg(r0 + k0 / 2) : 0u;
    a[ks][2] = hi ? __ldg(r0 + (k0 + 8) / 2) : 0u;
    a[ks][1] = lo && g == 0 ? __ldg(r8 + k0 / 2) : 0u;
    a[ks][3] = hi && g == 0 ? __ldg(r8 + (k0 + 8) / 2) : 0u;
  }
}

// NG n-tiles of window pixels from tile nt0: dots with the A fragments,
// patch rows 0..8 of the results to cw [9][NW].
template <int KS, int NG>
__device__ __forceinline__ void dot_tiles(uint32_t win,
                                          const uint32_t (&a)[KS][4], int nt0,
                                          float* cw, int NW, int box_bytes,
                                          int lane) {
  float acc[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[g][k] = 0.f;
  }
  if constexpr (KS == 1) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      uint32_t b0, b1;
      ldmatrix_x2(b0, b1,
                  win + win_off<KS>((nt0 + g) * 8 + (lane & 7),
                                    (lane >> 3) & 1, box_bytes));
      mma_bf16(acc[g], a[0], b0, b1);
    }
  } else {
#pragma unroll
    for (int kp = 0; kp < KS / 2; ++kp) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        uint32_t b[4];
        ldmatrix_x4(b, win + win_off<KS>((nt0 + g) * 8 + (lane & 7),
                                         kp * 4 + (lane >> 3), box_bytes));
        mma_bf16(acc[g], a[2 * kp], b[0], b[1]);
        mma_bf16(acc[g], a[2 * kp + 1], b[2], b[3]);
      }
    }
  }
  const int row = lane >> 2;
  const int col0 = 2 * (lane & 3);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int col = (nt0 + g) * 8 + col0;
    if (col < NW) {  // NW is even: a pair is wholly in or out
      *reinterpret_cast<float2*>(cw + row * NW + col) =
          make_float2(acc[g][0], acc[g][1]);
      if (row == 0)
        *reinterpret_cast<float2*>(cw + 8 * NW + col) =
            make_float2(acc[g][2], acc[g][3]);
    }
  }
}

// One level of one edge, by one warp: dots, blend, output.
template <int KS>
__device__ __forceinline__ void level_out(uint32_t win,
                                          const uint32_t (&a)[KS][4],
                                          const LevelGeom& g, float* cw,
                                          const int* blend_off, int NW,
                                          int WIN, int n_out, int box_bytes,
                                          float* __restrict__ o, int lane) {
  if (!g.usable) {
    for (int i = lane; i < n_out; i += 32) __stcs(o + i, 0.f);
    return;
  }
  const int nt = (NW + 7) / 8;
  int t = 0;
  for (; t + 4 <= nt; t += 4)
    dot_tiles<KS, 4>(win, a, t, cw, NW, box_bytes, lane);
  for (; t < nt; ++t) dot_tiles<KS, 1>(win, a, t, cw, NW, box_bytes, lane);
  __syncwarp();
  const float w00 = (1.f - g.fx) * (1.f - g.fy);
  const float w10 = g.fx * (1.f - g.fy);
  const float w01 = (1.f - g.fx) * g.fy;
  const float w11 = g.fx * g.fy;
  for (int i = lane; i < n_out; i += 32) {
    const float* c = cw + blend_off[i];
    __stcs(o + i, w00 * c[0] + w10 * c[1] + w01 * c[WIN] + w11 * c[WIN + 1]);
  }
}

// The edges in target-slot order (slots out of range last), written to
// scratch + kMaxBlocks (R + 1) by the whole grid: each block counts the
// slots of its chunk of edges, then places its edges after those of the
// earlier slots and of the earlier blocks' same slot. A counting sort with
// two grid-wide barriers (the launch is cooperative); within a slot the
// order is arbitrary. hist: 2 (R + 1) ints of shared memory.
__device__ void slot_sort(int* hist, const int* __restrict__ ring,
                          int* scratch, int E, int R) {
  namespace cg = cooperative_groups;
  const int S = R + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthr = blockDim.x;
  const long long chunk = (E + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < E ? lo + chunk : E;
  int* counts = scratch;           // [gridDim.x, S]
  int* order = scratch + kMaxBlocks * S;
  for (int s = tid; s < S; s += nthr) hist[s] = 0;
  __syncthreads();
  for (long long e = lo + tid; e < hi; e += nthr) {
    const int f = __ldg(ring + e);
    atomicAdd(hist + (f >= 0 && f < R ? f : R), 1);
  }
  __syncthreads();
  for (int s = tid; s < S; s += nthr) counts[blockIdx.x * S + s] = hist[s];
  cg::this_grid().sync();
  // per slot: all blocks' count, and the earlier blocks' count
  for (int s = warp; s < S; s += nthr / 32) {
    int total = 0, before = 0;
    for (int b = lane; b < gridDim.x; b += 32) {
      const int c = __ldcg(counts + b * S + s);
      total += c;
      before += b < blockIdx.x ? c : 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, off);
      before += __shfl_xor_sync(0xffffffffu, before, off);
    }
    if (lane == 0) {
      hist[s] = total;
      hist[S + s] = before;
    }
  }
  __syncthreads();
  if (tid == 0) {  // this block's first position in each slot
    int run = 0;
    for (int s = 0; s < S; ++s) {
      const int t = hist[s];
      hist[s] = run + hist[S + s];
      run += t;
    }
  }
  __syncthreads();
  for (long long e = lo + tid; e < hi; e += nthr) {
    const int f = __ldg(ring + e);
    order[atomicAdd(hist + (f >= 0 && f < R ? f : R), 1)] =
        static_cast<int>(e);
  }
  // hist lies in the window buffers that the TMA (the async proxy) writes
  // next: order this thread's generic accesses before those copies, then
  // the barrier orders them across threads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  cg::this_grid().sync();
}

// Shared memory, from a 1024-byte aligned base: per warp two window
// buffers (NB boxes of box_bytes each), then per warp cw [9][NW] f32, the
// blend-offset table, and two mbarriers per warp.
struct Layout {
  int box_bytes;  // one box: n-tile rows x RB, rounded up to 1024
  int win_bytes;  // bytes a window's copies deliver
  int windows;    // bytes of one warp's two window buffers
  int cw;         // bytes of one warp's cw
  int table;      // bytes of the blend-offset table (16-byte rounded)
};

template <int KS>
__host__ __device__ inline Layout layout(int radius) {
  using S = Stage<KS>;
  const int D = 2 * radius + 1;
  const int WIN = 2 * radius + 4;
  const int NW = WIN * WIN;
  Layout l;
  l.box_bytes = ((NW + 7) / 8 * 8 * S::RB + 1023) / 1024 * 1024;
  l.win_bytes = S::NB * NW * S::RB;
  l.windows = 2 * S::NB * l.box_bytes;
  l.cw = kPatch * NW * 4;
  l.table = (kPatch * D * D * 4 + 15) / 16 * 16;
  return l;
}

template <int KS>
inline int smem_bytes(int radius, int wpb) {
  const Layout L = layout<KS>(radius);
  return 1024 + wpb * (L.windows + L.cw) + L.table + wpb * 16;
}

template <int KS>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) corr_kernel(
    const __grid_constant__ CUtensorMap map0,  // fmap level 0 [R, H0, W0, C]
    const __grid_constant__ CUtensorMap map1,  // fmap level 1 (levels == 2)
    const __nv_bfloat16* __restrict__ pf,      // [E, 9, C]
    const int* __restrict__ ring,              // [E]
    const float* __restrict__ center,          // [E, 2] level-0 pixels
    int* scratch,  // sort: [kMaxBlocks, R + 1] counts, then the [E] order
    float* __restrict__ out,                   // [E, out_stride]
    int E, int R, int H0, int W0, int H1, int W1, int C, int radius,
    int levels, int out_stride, int sort) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Layout L = layout<KS>(radius);
  const int D = 2 * radius + 1;
  const int WIN = 2 * radius + 4;
  const int NW = WIN * WIN;
  const int n_out = kPatch * D * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* smem = smem_raw + pad;
  float* cw = reinterpret_cast<float*>(smem + wpb * L.windows) +
              warp * (L.cw / 4);
  int* blend_off =
      reinterpret_cast<int*>(smem + wpb * (L.windows + L.cw));
  const uint32_t bars =
      smem_u32(smem + wpb * (L.windows + L.cw) + L.table) + warp * 16;
  const uint32_t win0 = smem_u32(smem) + warp * L.windows;
  const uint32_t win1 = win0 + L.windows / 2;
  const uint32_t bar0 = bars;
  const uint32_t bar1 = bars + 8;

  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int p = i / (D * D);
    const int rem = i - p * D * D;
    const int dy = rem / D;
    const int dx = rem - dy * D;
    blend_off[i] = p * NW + (p / 3 + dy) * WIN + (p % 3 + dx);
  }
  if (lane == 0) {
    mbar_init(bar0);
    mbar_init(bar1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int* order = nullptr;  // the edge processed i-th: order[i], or i
  if (sort) {
    slot_sort(reinterpret_cast<int*>(smem), ring, scratch, E, R);
    order = scratch + kMaxBlocks * (R + 1);
  }

  const long long G = static_cast<long long>(gridDim.x) * wpb;
  long long i = static_cast<long long>(blockIdx.x) * wpb + warp;
  int ph0 = 0, ph1 = 0;  // the phase each buffer's barrier is in

  // prologue: the first edge's windows in flight, its patch in registers
  Edge cur = fetch_edge(i, E, order, ring, center);
  LevelGeom g0 = level_geom(cur, 1.f, R, H0, W0, radius, true);
  LevelGeom g1 = level_geom(cur, 0.5f, R, H1, W1, radius, levels > 1);
  if (lane == 0) {
    if (g0.usable)
      issue_window<KS>(win0, bar0, &map0, cur, g0, L.box_bytes, L.win_bytes);
    if (g1.usable)
      issue_window<KS>(win1, bar1, &map1, cur, g1, L.box_bytes, L.win_bytes);
  }
  uint32_t a[KS][4];
  load_a<KS>(a, pf, g0.usable || g1.usable ? cur.e : -1, C, lane);

  for (; i < E; i += G) {
    const Edge nxt = fetch_edge(i + G, E, order, ring, center);
    float* o = out + static_cast<size_t>(cur.e) * out_stride;

    if (g0.usable) {
      mbar_wait(bar0, ph0);
      ph0 ^= 1;
    }
    level_out<KS>(win0, a, g0, cw, blend_off, NW, WIN, n_out, L.box_bytes, o,
                  lane);
    __syncwarp();

    // the next edge's level 0 and patch fly while this edge's level 1 runs
    const LevelGeom n0 = level_geom(nxt, 1.f, R, H0, W0, radius, true);
    const LevelGeom n1 = level_geom(nxt, 0.5f, R, H1, W1, radius, levels > 1);
    if (lane == 0 && n0.usable)
      issue_window<KS>(win0, bar0, &map0, nxt, n0, L.box_bytes, L.win_bytes);
    uint32_t an[KS][4];
    load_a<KS>(an, pf, n0.usable || n1.usable ? nxt.e : -1, C, lane);

    if (levels > 1) {
      if (g1.usable) {
        mbar_wait(bar1, ph1);
        ph1 ^= 1;
      }
      level_out<KS>(win1, a, g1, cw, blend_off, NW, WIN, n_out, L.box_bytes,
                    o + n_out, lane);
      __syncwarp();
    }
    if (lane == 0 && n1.usable)
      issue_window<KS>(win1, bar1, &map1, nxt, n1, L.box_bytes, L.win_bytes);

#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int k = 0; k < 4; ++k) a[ks][k] = an[ks][k];
    }
    cur = nxt;
    g0 = n0;
    g1 = n1;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one level [R, H, W, C] bf16: box (BI channels, WIN x
// WIN pixels, one slot), swizzled as ldmatrix reads it.
template <int KS>
cudaError_t make_map(CUtensorMap* map, const void* fmap, int R, int H, int W,
                     int C, int WIN) {
  using S = Stage<KS>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(R)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(S::BI),
                             static_cast<cuuint32_t>(WIN),
                             static_cast<cuuint32_t>(WIN), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUtensorMapSwizzle swizzle =
      S::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : (S::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                  : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(fmap), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct KernelFacts {
  bool attr_set = false;
  int smem = -1;
  int blocks = 0;
};

template <int KS>
int launch(const void* fmap0, const void* fmap1, const void* pf,
           const void* ring, const void* center, void* scratch, void* out,
           int E, int R, int H0, int W0, int H1, int W1, int C, int radius,
           int levels, int out_stride, cudaStream_t stream) {
  static KernelFacts facts[kMaxDevices];
  const int WIN = 2 * radius + 4;
  if (WIN > 256) return static_cast<int>(cudaErrorInvalidValue);
  int wpb = kMaxWarps;
  while (wpb > 0 && smem_bytes<KS>(radius, wpb) > kSmemMax) --wpb;
  if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes<KS>(radius, wpb);
  auto kernel = corr_kernel<KS>;

  CUtensorMap map0, map1;
  cudaError_t err = make_map<KS>(&map0, fmap0, R, H0, W0, C, WIN);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = make_map<KS>(&map1, fmap1, R, H1, W1, C, WIN);
  if (err != cudaSuccess) return static_cast<int>(err);

  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  KernelFacts uncached;
  KernelFacts& f = dev >= 0 && dev < kMaxDevices ? facts[dev] : uncached;
  if (!f.attr_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    f.attr_set = true;
  }
  if (f.smem != smem) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wpb * 32,
                                                  smem);
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    f.smem = smem;
    f.blocks = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  long long blocks = f.blocks;
  const long long need = (E + wpb - 1) / wpb;
  if (blocks > need) blocks = need;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const __nv_bfloat16* pf_ = static_cast<const __nv_bfloat16*>(pf);
  const int* ring_ = static_cast<const int*>(ring);
  const float* center_ = static_cast<const float*>(center);
  int* scratch_ = static_cast<int*>(scratch);
  float* out_ = static_cast<float*>(out);
  int sort = scratch != nullptr;
  if (sort) {
    // the slot histogram lives in the window buffers before any copy
    if (2LL * (R + 1) * 4 > layout<KS>(radius).windows)
      return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&map0, &map1, &pf_, &ring_, &center_, &scratch_,
                    &out_, &E, &R, &H0, &W0, &H1, &W1, &C, &radius,
                    &levels, &out_stride, &sort};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel),
        dim3(static_cast<unsigned int>(blocks)), dim3(wpb * 32), args, smem,
        stream);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  kernel<<<static_cast<unsigned int>(blocks), wpb * 32, smem, stream>>>(
      map0, map1, pf_, ring_, center_, nullptr, out_, E, R, H0, W0, H1, W1,
      C, radius, levels, out_stride, 0);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* fmap0, const void* fmap1, const void* pf,
             const void* ring, const void* center, void* scratch, void* out,
             int E, int R, int H0, int W0, int H1, int W1, int C, int radius,
             int levels, int out_stride, void* stream) {
  if (E == 0) return 0;
  if (C <= 0 || C % 8 || C > 128 || radius < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ks = (C + 15) / 16;
  if (ks <= 1)
    return launch<1>(fmap0, fmap1, pf, ring, center, scratch, out, E,
                     R, H0, W0, H1, W1, C, radius, levels, out_stride, s);
  if (ks <= 2)
    return launch<2>(fmap0, fmap1, pf, ring, center, scratch, out, E,
                     R, H0, W0, H1, W1, C, radius, levels, out_stride, s);
  if (ks <= 4)
    return launch<4>(fmap0, fmap1, pf, ring, center, scratch, out, E,
                     R, H0, W0, H1, W1, C, radius, levels, out_stride, s);
  return launch<8>(fmap0, fmap1, pf, ring, center, scratch, out, E,
                   R, H0, W0, H1, W1, C, radius, levels, out_stride, s);
}

}  // namespace

// Every entry point launches on `stream` and returns the cudaError_t of the
// launch (0 on success). The caller guarantees: C % 8 == 0 and C <= 128,
// every tensor contiguous, fmap 16-byte aligned, pf 4-byte and center
// 8-byte aligned, out rows of at least levels * 9 (2r+1)^2 floats. Each
// edge's output goes to its own row.

// One level: centres in this level's pixels; the edges walked in the
// caller's order.
extern "C" int corr_level(const void* fmap, const void* pf, const void* ring,
                          const void* center, void* out, int E, int R, int H,
                          int W, int C, int radius, int out_stride,
                          void* stream) {
  return dispatch(fmap, fmap, pf, ring, center, nullptr, out, E, R, H, W, H,
                  W, C, radius, 1, out_stride, stream);
}

// Both levels in one launch: centres in level-0 pixels, level 1 = fmap1 at
// half resolution (centre * 0.5); level l's block at column l * 9 (2r+1)^2.
// The launch sorts the edges by target slot into scratch ([1024 (R + 1) +
// E] int32) and walks them in that order.
extern "C" int corr_two_level(const void* fmap0, const void* fmap1,
                              const void* pf, const void* ring,
                              const void* center, void* scratch, void* out,
                              int E, int R, int H0, int W0, int H1, int W1,
                              int C, int radius, int out_stride,
                              void* stream) {
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(fmap0, fmap1, pf, ring, center, scratch, out, E, R, H0, W0,
                  H1, W1, C, radius, 2, out_stride, stream);
}
