// Brick-row gather / interpolate / scatter kernels of the hash grid, for
// Hopper (sm_90a).
//
// The hash grid stores one brick (the 3x3x3 corner lattice of a 2x2x2-cell
// region, 27 entries padded to 32) as one contiguous row of 32*F floats of a
// brick-major f32 table [n_bricks, 32F] (entry-major, feature-minor). Every
// (sample, level) reads exactly one row. These kernels replace the four
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
// and the hash grid's backward runs rows 2 and 5 fused with what consumed
// or fed them, the two adjoints of gather_interp:
//
//   gather_cols_dot    <- gather_cols (:79): gather_cols_kernel with the
//       DotCot sink,  dW[t, e] = sum_f bf16(tab[idx[t], e*F + f]) * cot[t, f]
//       [M, 32] f32 (the position pullback's brick contraction)
//   scatter_cols_outer <- scatter_cols_accum (:297): the runs kernel
//       with the Outer row source and the OwnRuns sink, on the ids sorted,
//       out[b, e*F + f] += W[t, e] * cot[t, f] (the table gradient), each
//       product one f32 multiply in registers, the same bits every call
//
// so no [M, 32F] tensor is written on a path (at the field's shape the
// bf16 rows were 302 MB and the W x cot rows 604 MB a pass).
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
// 256; hash proposals, nerfstudio's mapper: 5 levels x 4096 rays x 96 / 48
// samples, F = 2, R = 64; dense proposals F = 1, R = 32): all four move
// bytes and do next to no arithmetic (at most 32F multiply-adds per
// descriptor), so the bound is bytes over 3.35 TB/s. Per descriptor,
// gather_interp reads its w row (128 B) and the 8 live entries of one
// table row (256 B of 1 KB at F = 8) and writes 32 B; gather_cols writes
// a 2R-byte bf16 row; scatter_cols_accum reads a 4R-byte f32 cotangent row
// and adds it into one table row. Bounds at those shapes (bytes moved once
// over 3.35 TB/s, as chip_smoke.py phases (a) and (h1) compute them):
//   gather_cols        M 589,824 x 256: 302 MB out + touched rows  ~0.10 ms
//                      M 1,966,080 x 64 (proposal 0): 252 MB out   ~0.078 ms
//   gather_interp      M 393,216, F 8 (hashed levels 1-2): ~98 MB  ~0.029 ms
//   gather_interp_mm   M 196,608, F 8 (level 0, 512 bricks): ~33 MB ~0.010 ms
//   scatter_cols_accum M 589,824 x 256 into 49,152 bricks: 657 MB ~0.20 ms
//                      M 1,966,080 x 64 into 20,480 bricks: 516 MB ~0.154 ms
//   gather_cols_dot    M 589,824, F 8: touched rows + 18.9 MB cot + 75.5 MB
//                      dW + ids                                ~0.039 ms
//   scatter_cols_outer M 589,824, F 8: 75.5 MB W + 18.9 MB cot + 50.3 MB
//                      table + ids                             ~0.044 ms
//                      M 1,966,080, F 2: W 252 MB + cot 15.7 + table 5.2
//                      + ids                                   ~0.084 ms
//
// Designs.
//
// gather_cols (every R = 32F; other widths, on no path, one warp a
// descriptor): L = R / 8 lanes serve one descriptor, 8 floats a lane, so a
// warp serves 32 / L descriptors a round (at F = 2 eight lanes and four
// descriptors; at F = 8 the whole warp). Lane j's two 16-byte loads of
// floats 8j..8j+7 become one 16-byte bf16 store, streamed (st.global.cs:
// the caller reads the rows once). A persistent grid; each warp loads the
// ids of 8 rounds (4 at F = 1) at once, one a lane, broadcasts them by
// shuffle, and issues the row loads of all its rounds (predicated, no
// branch) before it converts and stores any. One warp a descriptor leaves
// half of each warp idle at R = 64, with one 16-byte load a lane in flight
// behind a dependent id load: 35.8% of the bound at 2h.
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
// gather_cols_dot: gather_cols' warps, lanes and batches, with a sink
// that contracts each lane's 8 gathered floats (8 / F entries) with the
// descriptor's cotangent in registers and writes 4 * 8 / F bytes a lane
// (128 B a descriptor) in place of 16 bytes of bf16. The batch's cotangent
// rows are contiguous and are loaded once, coalesced, and handed out by
// shuffle (DotCot). It still reads whole brick rows through L2, as row 2
// does, since dW has all 32 entries.
//
// The scatters (scatter_cols_accum, scatter_cols_outer). One runs kernel
// (scatter_runs_kernel) takes the row from a template source (Rows loads
// g[t]; Outer<F> forms W[r] x cot[r] from W's 128 B and cot's 4F bytes,
// at F = 8 160 B a descriptor for the row's 1 KB) and hands each run's sum
// to a template sink (AddRuns adds it with float4 atomics; OwnRuns stores
// it). scatter_cols_accum takes runs with AddRuns at F <= 2 and the slabs
// (scatter_cols_accum_kernel) at F >= 4; both leave out a zero 16-byte
// piece (+0 changes no sum; a point's zero trilinear weights and the
// padding entries 27..31 make 24 of a brick's 32 entries zero), and both
// sum in an order that changes from call to call.
//
// scatter_cols_outer, which the paths run, is deterministic: the wrapper
// sorts the ids (torch.sort, stable) and the runs kernel walks them in
// sorted order through the permutation (Outer reads W[perm[t]],
// cot[perm[t]]), so each id's descriptors are contiguous. A run that
// neither continues from the previous lane group's range nor into the next
// is the id's whole sum and is stored with plain stores; a run that does
// is written to a partial row of its range, and scatter_combine_kernel,
// one block an id that spans ranges, sums its partials in range order (a
// fixed strided split over the block's threads, then a fixed tree). No
// atomics: the same inputs give the same bits on every call. Why: with
// atomics (runs or slabs) the order of a brick's adds changed from call
// to call, and over 8 Adam steps the normal MLP's near-zero gradients
// turned that into differences above 2.5 lr: chip_smoke.py (i2)'s
// descriptor-sharded step failed its check against DP(4) in two runs of
// the script, and in 1 of 6 of scripts/exp_torch_ds_repeats.py --scatter
// atomic, with DP(4) itself never repeating; sorted, 0 of 6, every DP(4)
// run the same bits (NVIDIA H100 80GB HBM3, 700 W). The cost,
// in one call of scripts/exp_torch_table_adjoints.py: at (d)'s field
// scatter (M 589,824, F 8) 0.231-0.233 ms against 0.159-0.161 by atomic
// runs and 0.231-0.234 by slabs; at (h1)'s proposal 0 (M 1,966,080, F 2)
// 0.328 against 0.111. The sort alone takes 0.075 / 0.146 ms of that.
//
// Which atomic design would serve F = 8, from the field scatter of
// chip_smoke.py phase (d)'s last step (replica mapper, M 589,824, 3 levels
// ray-major; NVIDIA H100 80GB HBM3, 700 W): per level id runs 26,332 /
// 163,179 / 196,595 (mean length 7.47 / 1.20 / 1.00), distinct ids 154 /
// 15,262 / 16,384, most descriptors on one id 22,291 / 2,160 / 35. Level
// 0's runs cut its adds 7.5x: on the same ids recorded again, that level
// alone took 0.050 ms by atomic runs against 0.143 by slabs (its 512 rows
// on chip, shared-memory adds as CAS loops). At levels 1-2, where runs
// have length ~1, slabs were 10-20% faster (0.064 / 0.063 against 0.078 /
// 0.069 ms). The whole call: atomic runs 0.162 ms, slabs 0.233; at phase
// (a)'s uniform points (no runs) 0.166 against 0.197
// (scripts/exp_torch_table_adjoints.py, one call, both designs built from
// scripts/exp_torch_table_adjoints_variants.cu). scatter_cols_accum at
// F = 8 keeps slabs: phase (a) holds it on uniform points, and no path
// runs it.
//
// Atomic runs (row 5 at F <= 2: the hash proposals' F = 2 grids, F = 1):
// what held the F = 2 scatter
// back was same-address atomics, which serialize in L2 (~4.8 ns each on an
// H100). The descriptors come level-major, and within a level ray-major
// with a ray's samples adjacent (hash_grid._descriptors over positions
// [rays, samples, 3]), so equal ids come in runs (mean length 17.5 / 10.7
// / 7.8 / 6.6 / 4.9 over proposal 0's levels in chip_smoke.py (h1)), and
// the rays meet in few bricks: one brick took 292,632 of level 1's 393,216
// descriptors, and its slice alone 1.40 of the 2.16 ms that one float4
// atomic per 16 bytes a descriptor cost. So runs are summed in registers
// before any atomic: R / 8 lanes serve a descriptor (two 16-byte streaming
// loads a lane), each lane group owns a contiguous range of descriptors
// (a block's groups consecutive ranges), loads the ids of 8 descriptors at
// once (broadcast by shuffle) and their rows, then walks them in order,
// summing while the id repeats and adding the sum into the table with two
// float4 atomics a lane where it changes. Zero 16-byte pieces are not
// added (+0 changes no sum; a point's zero trilinear weights and the
// padding entries 27..31 give many). On (h1)'s ids the row adds fall from
// 1,966,080 to ~256,000 and the most on one row from ~290,000 to ~5,300
// (scripts/model_scatter_runs.py). A second stage, a per-block table in
// shared memory keyed by brick id, was built and measured slower than runs
// alone at both proposals' shapes (its shared-memory f32 adds are CAS
// loops, and after the runs the global atomics no longer set the pace), so
// there is none; nor are the `hot` rows kept on chip: runs do not read
// `hot`.
//
// Slabs (row 5 at F >= 4): level 0's 512
// bricks take ~384 adds each at phase (a)'s uniform points, which a block
// keeps on chip only as 32-column slabs (768 whole rows of 1 KB do not fit
// in shared memory): a block owns one 32-column slab of the table and a
// strided share of the descriptors: 8 lanes take one descriptor's 128 B of the
// slab as one 16-byte load each (4 loads in flight per lane); the id is
// loaded once per descriptor batch and broadcast by shuffle. Ids
// below `hot` (level 0's 512 bricks, where ~384 descriptors hit each
// brick) accumulate in the block's shared-memory copy of those rows' slab
// (shared f32 atomics; rows rotated by their index to spread banks),
// flushed once at the end with global vector atomics; every other id adds
// straight into the table with sm_90's 16-byte atomicAdd on float4 (4x
// fewer atomic operations than scalar adds).
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

// 16 / 8 / 4 bytes at p where pred holds, else zeros; streaming (read
// once).
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

// K consecutive floats at p into v (K = 1, 2, 4 or 8; p aligned to
// min(4K, 16) bytes), zeros where pred fails: streaming loads (kStream,
// data read once) or the read-only path (data other lanes or blocks read
// again).
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
// gather_cols: R / 8 lanes per descriptor, a batch of ids a warp at once,
// 16-byte streaming stores
// ---------------------------------------------------------------------------

constexpr int kGcUnroll = 8;  // descriptor rounds loaded at once

// any R % 4 == 0 (no path has another width than 32F): one warp per
// descriptor, 16-byte loads, 8-byte stores
__global__ void __launch_bounds__(kThreads) gather_cols_any_kernel(
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
    dst[v] = make_uint2(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w));
  }
}

// What gather_cols_kernel does with lane j's piece of a gathered row,
// floats 8j..8j+7 of tab[idx[t]] in a and b (f32 as stored). A warp serves
// a batch of B descriptors t0..t0+B-1 in rounds u of DPW = 32 / L
// (descriptor t = t0 + u DPW + q); fetch() issues the batch's other loads
// beside its row loads, and every lane of the warp calls put() for every
// round (shuffles need all 32), which writes only where `in` (t < M).
//
// Bf16Rows (gather_cols, row 2): store the piece as one 16-byte streaming
// bf16 store into out[t] [M, R].
struct Bf16Rows {
  __nv_bfloat16* out;
  struct Batch {};
  template <int B>
  __device__ __forceinline__ Batch fetch(long long, int, int) const {
    return {};
  }
  template <int R>
  __device__ __forceinline__ void put(int, int, int j, long long t, bool in,
                                      float4 a, float4 b,
                                      const Batch&) const {
    if (in)
      __stcs(reinterpret_cast<uint4*>(out + t * R) + j,
             make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                        pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w)));
  }
};

// DotCot<F> (gather_cols_dot, the W adjoint of row 3): the piece holds
// entries 8j / F .. 8j / F + 8 / F - 1 of the brick, all F features each;
// contract each entry's bf16-rounded features with cot[t] [M, F] and store
// the 8 / F sums into dW[t] [M, 32] (the lanes of a descriptor write its
// 128 B row together). The batch's cot rows are contiguous (B F <= 64
// floats): the warp loads them with one or two coalesced 4-byte loads a
// lane, and each round takes its descriptor's F values by shuffle (in
// round u, feature f of the warp's descriptor q sits at float 8u + qF + f
// of the block, since DPW F = 8). Prefetching each descriptor's F floats
// a lane instead held 160 registers at F = 8 (one block an SM) and took
// 0.18 ms at the field's shape against row 2's 0.15.
template <int F>
struct DotCot {
  const float* cot;
  float* dW;
  struct Batch {
    float c[2];
  };
  template <int B>
  __device__ __forceinline__ Batch fetch(long long t0, int lane,
                                         int M) const {
    static_assert(B * F <= 64, "a batch's cot block is two words a lane");
    Batch x;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long i = t0 * F + k * 32 + lane;
      const bool live = k * 32 < B * F && i < static_cast<long long>(M) * F;
      x.c[k] = ldcs_f1_if(cot + i, live);
    }
    return x;
  }
  template <int R>
  __device__ __forceinline__ void put(int u, int q, int j, long long t,
                                      bool in, float4 a, float4 b,
                                      const Batch& x) const {
    constexpr int E = 8 / F;  // entries of the lane's 8 floats
    float c[F];
#pragma unroll
    for (int f = 0; f < F; ++f)
      c[f] = __shfl_sync(0xffffffffu, x.c[u / 4], 8 * (u % 4) + q * F + f);
    if (!in) return;
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float d[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      float acc = bf16_round(v[k * F]) * c[0];
#pragma unroll
      for (int f = 1; f < F; ++f)
        acc = fmaf(bf16_round(v[k * F + f]), c[f], acc);
      d[k] = acc;
    }
    float* o = dW + t * 32 + j * E;
    if constexpr (E == 1) {
      *o = d[0];
    } else if constexpr (E == 2) {
      *reinterpret_cast<float2*>(o) = make_float2(d[0], d[1]);
    } else {
#pragma unroll
      for (int h = 0; h < E / 4; ++h)
        reinterpret_cast<float4*>(o)[h] =
            make_float4(d[4 * h], d[4 * h + 1], d[4 * h + 2], d[4 * h + 3]);
    }
  }
};

// R = 8L: lane j of a descriptor's L reads floats 8j..8j+7 of its row (two
// 16-byte loads) and hands them to the sink. A warp serves batches of 32 /
// L x U descriptors (U = kGcUnroll, at most L): it loads their ids at once
// (one a lane) and serves them in U rounds of 32 / L descriptors, the ids
// broadcast by shuffle, with the row loads of all U rounds (and the sink's
// batch loads) issued (predicated) before any is consumed.
template <int L, typename Sink>
__global__ void __launch_bounds__(kThreads) gather_cols_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx, Sink sink,
    int M, int n_bricks) {
  constexpr int R = 8 * L;
  constexpr int DPW = 32 / L;  // descriptors a round
  constexpr int U = L < kGcUnroll ? L : kGcUnroll;
  constexpr int B = DPW * U;  // descriptors a batch
  const int lane = threadIdx.x & 31;
  const int q = lane / L;
  const int j = lane % L;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * B;
  for (long long t0 =
           (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
           B;
       t0 < M; t0 += stride) {
    const int my_id =
        lane < B && t0 + lane < M ? __ldcs(idx + t0 + lane) : -1;
    float4 a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int bk = __shfl_sync(0xffffffffu, my_id, u * DPW + q);
      const bool ok = bk >= 0 && bk < n_bricks;
      const float* src = tab + static_cast<long long>(ok ? bk : 0) * R + 8 * j;
      a[u] = ldg_f4_if(src, ok);
      b[u] = ldg_f4_if(src + 4, ok);
    }
    const typename Sink::Batch x = sink.template fetch<B>(t0, lane, M);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = t0 + u * DPW + q;
      sink.template put<R>(u, q, j, t, t < M, a[u], b[u], x);
    }
  }
}

template <int L, typename Sink>
int launch_gather_cols(const float* tab, const int* idx, Sink sink, int M,
                       int n_bricks, cudaStream_t stream) {
  static KernelFacts facts[kMaxDevices];
  auto kernel = gather_cols_kernel<L, Sink>;
  long long blocks = 0;
  cudaError_t err = resident_grid(kernel, facts, kThreads, 0, 0, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int U = L < kGcUnroll ? L : kGcUnroll;
  const long long per_block = kWarps * (32 / L) * U;
  const long long need = (M + per_block - 1) / per_block;
  if (blocks > need) blocks = need;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      tab, idx, sink, M, n_bricks);
  return static_cast<int>(cudaGetLastError());
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
// the scatters' row sources: a row loaded from memory, or formed in
// registers as W (x) cot
// ---------------------------------------------------------------------------

// Rows (scatter_cols_accum, row 5): row t is g[t] [M, R], loaded with
// streaming loads (each row is read once).
struct Rows {
  const float* g;
  // floats col..col+7 of row t, zeros where !ok
  template <int R>
  __device__ __forceinline__ void load(long long t, int col, bool ok,
                                       float (&v)[8]) const {
    ld_floats_if<8, true>(g + t * R + col, ok, v);
  }
};

// Outer<F> (scatter_cols_outer, the table adjoint of row 3): row t of the
// id-sorted order is W[r] (x) cot[r] with r = perm[t], column e F + f =
// W[r, e] * cot[r, f] (W [M, 32], cot [M, F]): one f32 multiply each, the
// value the materialized row held. The 8 columns from col (col a multiple
// of 8) span one entry's 8 features (F = 8) or 8 / F whole entries (F <
// 8): the lane loads those W values (streaming: each is read by one lane)
// and cot[r]'s features (read-only path: the other lanes of the
// descriptor read them too).
template <int F>
struct Outer {
  const float* W;
  const float* cot;
  const long long* perm;
  template <int R>
  __device__ __forceinline__ void load(long long t, int col, bool ok,
                                       float (&v)[8]) const {
    constexpr int E = F >= 8 ? 1 : 8 / F;  // entries the 8 columns span
    const long long r = ok ? __ldg(perm + t) : 0;
    float w[E], c[F < 8 ? F : 8];
    ld_floats_if<E, true>(W + r * 32 + col / F, ok, w);
    ld_floats_if<(F < 8 ? F : 8), false>(cot + r * F + col % F, ok, c);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = w[i / F] * c[i % F];
  }
};

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}

// ---------------------------------------------------------------------------
// scatter slabs: 32-column slabs, hot rows in shared memory, vector atomics
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
        // +0 changes no sum: a point's zero trilinear weights and the
        // padding entries 27..31 give many zero pieces
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

  // flush the hot rows' slab: one vector atomic per non-zero 16 bytes
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

template <int F>
int launch_scatter_slabs(const float* g, const int* idx, float* out, int M,
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

// ---------------------------------------------------------------------------
// scatter runs: contiguous ranges, runs of equal ids summed in registers
// ---------------------------------------------------------------------------

constexpr int kRunThreads = 512;
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kRunTile = 8;  // descriptors whose rows load at once

// One lane's share of a run's sum, floats 8j..8j+7 of row b: two vector
// atomics, each left out where its 16 bytes are zero (+0 changes no sum).
template <int R>
__device__ __forceinline__ void add_run(float* out, int b, int j,
                                        const float (&acc)[8]) {
  float4* o =
      reinterpret_cast<float4*>(out + static_cast<long long>(b) * R + 8 * j);
  const float4 a = make_float4(acc[0], acc[1], acc[2], acc[3]);
  const float4 c = make_float4(acc[4], acc[5], acc[6], acc[7]);
  if (nonzero(a)) atomicAdd(o, a);
  if (nonzero(c)) atomicAdd(o + 1, c);
}

// Where a run's sum goes: the sink. AddRuns (scatter_cols_accum, row 5)
// adds it into the table (add_run): runs of one id in other ranges add to
// the same row, in an order that changes from run to run. OwnRuns
// (scatter_cols_outer) takes the ids sorted, so that each id's descriptors
// are contiguous: a run that neither continues from the previous range nor
// into the next is the id's whole sum and is stored; a run that does is
// written to a partial row of its range (slot 2g for the range's first
// run, 2g + 1 for its last), which scatter_combine_kernel sums in range
// order. No atomics: the result is the same on every call.
struct AddRuns {
  float* out;
  struct Range {};
  __device__ __forceinline__ Range range(long long, long long, long long,
                                         const int*, int) const {
    return {};
  }
  template <int R>
  __device__ __forceinline__ void put(const Range&, int b, int j,
                                      const float (&acc)[8]) const {
    add_run<R>(out, b, j, acc);
  }
};

// A partial's code: 2 b + 1 for the first part of id b's sum (the run
// that starts it), 2 b for a later part; -1 for an empty slot. The slots
// of first parts are also listed in `heads` (in no fixed order: each is
// combined on its own).
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

// R = 8L: L lanes serve one descriptor (lane j: floats 8j..8j+7 of its
// row from the source), 32 / L lane groups a warp, and each group owns a
// contiguous range of `span` descriptors (a block's groups consecutive
// ranges). A group loads kRunTile ids at once (broadcast by shuffle) and
// their rows, then walks them in order, summing in registers while the id
// repeats and handing the sum to the sink where it changes. An id outside
// [0, n_bricks) is skipped (it neither adds nor ends a run).
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
  // every group of the warp takes the same number of tiles, so that the
  // shuffles see all 32 lanes
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

// The runs kernel's grid for M descriptors: blocks, and descriptors a lane
// group (span).
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

template <int F, typename Src, typename Sink>
int launch_scatter_runs(Src src, Sink sink, const int* idx, int M,
                        int n_bricks, cudaStream_t stream) {
  long long blocks = 0, span = 0;
  cudaError_t err = runs_grid<F, Src, Sink>(M, &blocks, &span);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_runs_kernel<F, Src, Sink>
      <<<static_cast<unsigned int>(blocks), kRunThreads, 0, stream>>>(
          src, idx, sink, M, n_bricks, span);
  return static_cast<int>(cudaGetLastError());
}

// OwnRuns' partial slots for M descriptors: 2 a lane group of the grid.
template <int F>
long long own_slots(int M) {
  long long blocks = 0, span = 0;
  if (runs_grid<F, Outer<F>, OwnRuns>(M, &blocks, &span) != cudaSuccess)
    return -1;
  return 2 * blocks * kRunWarps * (32 / (32 * F / 8));
}

constexpr int kCombThreads = 512;
constexpr int kCombUnroll = 4;  // slots a thread loads at once

// The sums of ids whose descriptors span ranges, one block a listed head
// slot s (code 2 b + 1) at a time: the block finds where b's parts end
// (the first later slot holding another code; the empty slots between
// parts hold zeros), sums slots [s, end) in a fixed order (thread r of P
// takes slots s + r, s + r + P, ..., kCombUnroll loads in flight; then a
// tree over r in shared memory) and stores the total. The result does not
// depend on which block takes which head.
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

// meta: [2 * slots + 1] int32 scratch: the slots' codes, the number of
// heads, the head slots.
template <int F>
int launch_scatter_owned(const float* W, const float* cot, const int* sidx,
                         const long long* perm, float* out, float* part,
                         int* meta, int M, int n_bricks,
                         cudaStream_t stream) {
  long long blocks = 0, span = 0;
  cudaError_t err = runs_grid<F, Outer<F>, OwnRuns>(M, &blocks, &span);
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
  scatter_runs_kernel<F, Outer<F>, OwnRuns>
      <<<static_cast<unsigned int>(blocks), kRunThreads, 0, stream>>>(
          Outer<F>{W, cot, perm}, sidx,
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
  const float* tb = static_cast<const float*>(tab);
  const int* ix = static_cast<const int*>(idx);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bf16Rows sink{o};
  switch (R) {
    case 32: return launch_gather_cols<4>(tb, ix, sink, M, n_bricks, s);
    case 64: return launch_gather_cols<8>(tb, ix, sink, M, n_bricks, s);
    case 128: return launch_gather_cols<16>(tb, ix, sink, M, n_bricks, s);
    case 256: return launch_gather_cols<32>(tb, ix, sink, M, n_bricks, s);
    default: {
      const int blocks = (M + kWarps - 1) / kWarps;
      gather_cols_any_kernel<<<blocks, kThreads, 0, s>>>(tb, ix, o, M, R,
                                                         n_bricks);
      return static_cast<int>(cudaGetLastError());
    }
  }
}

// tab [n_bricks, 32F] f32, idx [M] int32, cot [M, F] f32 -> dW [M, 32]
// f32, dW[t, e] = sum_f bf16(tab[idx[t], e F + f]) cot[t, f]; an id out of
// range gives a row of zeros. F in {1, 2, 4, 8}; cot aligned to 4F bytes
// (16 at F = 8).
extern "C" int gather_cols_dot(const void* tab, const void* idx,
                               const void* cot, void* dW, int M, int F,
                               int n_bricks, void* stream) {
  if (M == 0) return 0;
  const float* tb = static_cast<const float*>(tab);
  const int* ix = static_cast<const int*>(idx);
  const float* c = static_cast<const float*>(cot);
  float* o = static_cast<float*>(dW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_gather_cols<4>(tb, ix, DotCot<1>{c, o}, M,
                                         n_bricks, s);
    case 2: return launch_gather_cols<8>(tb, ix, DotCot<2>{c, o}, M,
                                         n_bricks, s);
    case 4: return launch_gather_cols<16>(tb, ix, DotCot<4>{c, o}, M,
                                          n_bricks, s);
    case 8: return launch_gather_cols<32>(tb, ix, DotCot<8>{c, o}, M,
                                          n_bricks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// caller. At F >= 4 rows [0, hot) (at most 768) accumulate in shared
// memory; F <= 2 sums runs of equal ids in registers and does not read
// `hot`.
extern "C" int scatter_cols_accum(const void* g, const void* idx, void* out,
                                  int M, int F, int n_bricks, int hot,
                                  void* stream) {
  if (M == 0) return 0;
  const float* gp = static_cast<const float*>(g);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_scatter_runs<1>(Rows{gp}, AddRuns{o}, ix, M,
                                          n_bricks, s);
    case 2: return launch_scatter_runs<2>(Rows{gp}, AddRuns{o}, ix, M,
                                          n_bricks, s);
    case 4: return launch_scatter_slabs<4>(gp, ix, o, M, n_bricks, hot, s);
    case 8: return launch_scatter_slabs<8>(gp, ix, o, M, n_bricks, hot, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// W [M, 32] f32, cot [M, F] f32 (aligned to 4F bytes, 16 at F = 8); sidx
// [M] int32 the ids sorted, stably, and perm [M] int64 their positions
// (sidx[t] = idx[perm[t]]); out [n_bricks, 32F] f32, zeroed by the caller:
// out[b, e F + f] = sum of W[t, e] cot[t, f] over idx[t] == b, the product
// formed in registers, each id's terms summed in sorted order, the same on
// every call. part [slots, 32F] f32 and meta [2 slots + 1] int32 are
// scratch, slots = scatter_cols_outer_slots(M, F).
extern "C" int scatter_cols_outer(const void* W, const void* cot,
                                  const void* sidx, const void* perm,
                                  void* out, void* part, void* meta, int M,
                                  int F, int n_bricks, void* stream) {
  if (M == 0) return 0;
  const float* w = static_cast<const float*>(W);
  const float* c = static_cast<const float*>(cot);
  const int* ix = static_cast<const int*>(sidx);
  const long long* pm = static_cast<const long long*>(perm);
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

// scatter_cols_outer's scratch rows for M descriptors on the current
// device, or a negative value if the grid cannot be sized.
extern "C" long long scatter_cols_outer_slots(int M, int F) {
  switch (F) {
    case 1: return own_slots<1>(M);
    case 2: return own_slots<2>(M);
    case 4: return own_slots<4>(M);
    case 8: return own_slots<8>(M);
    default: return -1;
  }
}
