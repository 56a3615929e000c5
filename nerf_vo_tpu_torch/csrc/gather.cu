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
//       out[b, :] += g[t, :] for every t with idx[t] == b     f32: the
//       scatter kernel below with the Rows source, on the ids sorted by
//       sort_ids, the same bits every call
//
// and the hash grid's backward runs rows 2 and 5 fused with what consumed
// or fed them, the two adjoints of gather_interp:
//
//   gather_cols_dfrac  <- gather_cols (:79): the position pullback,
//       res[level] d<gather_interp(tab, idx, W, F)[t], cot[t]> / dfrac[t]
//       [M, 3] f32, W the trilinear weights of (local[t], frac[t]): the 8
//       corners of each cell read and contracted in registers
//   scatter_cols_outer <- scatter_cols_accum (:297): row 5's kernel with
//       the Outer row source, out[b, e*F + f] += W[t, e] * cot[t, f] (the
//       table gradient), each product one f32 multiply in registers
//   sort_ids           the ids sorted stably (int32 keys and positions),
//       both scatters' first launch
//
// so no [M, 32F] tensor is written on a path (at the field's shape the
// bf16 rows were 302 MB and the W x cot rows 604 MB a pass), nor dW.
//
// Every encode's inputs to those kernels come from one more:
//
//   hash_descriptors   the descriptors of points x [N, 3] on every level,
//       level-major: brick ids, base corners (int64), offsets, the
//       trilinear weights [M, 32] and the [N, 3] mask of x in [0, 1],
//       bitwise hash_grid's plain chain (about 20 launches a level before)
//
// bf16(.) is round-to-nearest-even, done in registers on the f32 parameter
// table: no bf16 copy of the table is made. gather_interp_bf16 reads a bf16
// table as it is stored: bf16(.) is then exact, and it gives bitwise the
// f32 kernel's result on the same values in f32 (the same live entries,
// the same products summed in the same order). Weights, sums and outputs of the
// interpolation are f32 (the Pallas contract had bf16 w and out). A
// descriptor whose id lies outside [0, n_bricks) reads zeros (gathers) or is
// dropped (scatters).
//
// What bounds them on an H100, at the replica configuration's mapping step
// (field: 4096 rays x 48 samples = 196,608 descriptors per level; F = 8, R =
// 256; hash proposals, nerfstudio's mapper: 5 levels x 4096 rays x 96 / 48
// samples, F = 2, R = 64; dense proposals F = 1, R = 32): all of them move
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
//   gather_cols_dfrac  M 589,824, F 8: the corners' sectors of the
//                      touched rows + ids 2.4 MB + cot 18.9 + local 14.2
//                      + frac 7.1 + out 7.1                    ~0.022 ms
//                      M 1,966,080, F 2 (proposal 0)           ~0.036 ms
//   sort_ids           M 589,824: ids in, keys and positions out
//                      (7.1 MB)                                ~0.002 ms
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
// gather_cols_dfrac (the paths' position pullback; it replaced a kernel
// that wrote dW [M, 32], gather_cols' lanes contracting each row with the
// cotangent, and the ~10 elementwise launches of hash_grid's dfrac
// contraction that consumed dW): only the 8 corners of a point's cell have
// a non-zero trilinear weight or weight derivative, so one thread serves a
// descriptor and reads those 8 entries (F floats each, a 32-byte sector at
// F = 8, with the descriptor's id, cotangent, base corner and offsets all
// in flight), rounds them to bf16, contracts each with the cotangent
// (D[abc]) and then with the separable weights (1 - f, f) and derivatives
// (-1, +1) in registers, and writes dfrac * res: 12 bytes a descriptor,
// no dW. The level's resolution comes from the id (Levels: each level's
// first id), so one launch serves every level and every id space the
// hash grid hands it (global rows, a shard's local rows, the one-hot
// slab). A thread's sums run in a fixed order whatever the descriptor's
// place in the launch, so the descriptor-sharded route (a descriptor at
// its owner, local ids) gets the one-rank route's bits. In one call of
// scripts/exp_torch_table_adjoints.py (NVIDIA H100 80GB HBM3, 700 W): at
// (d)'s field call (M 589,824, F 8) 0.0479 ms queued, 44% of its ~0.022
// ms bound, against 0.859 for the dW kernel then dfrac; at (h1)'s
// proposal 0 (M 1,966,080, F 2) 0.0384, 93% of its bound, against 2.32.
//
// sort_ids (the scatters' sort; it replaced torch.sort, which sorted all
// 32 bits of the ids and gave int64 positions): an LSD radix sort with
// 8-bit digits, as many passes as n_bricks has bits (two below 65,536
// rows, three at the dense proposal grids), in one cooperative launch of
// one 1024-thread block an SM; each block owns a contiguous chunk of the
// keys. A pass: every warp counts its keys' digits (__match_any_sync
// groups a round's equal digits), the block writes its counts; grid
// barrier; four threads a digit read the earlier blocks' counts, so each
// block knows where its keys of each digit start; then sub-tiles of 8192
// keys are ranked in their warps, staged in shared memory in digit order
// and written out in that order, so that a digit's keys of a sub-tile go
// out as one contiguous run; grid barrier. Stable, integer, the same
// order on every call. Written out key by key, the first build took
// 0.060 ms at (a) (uniform ids: every store its own transaction); staged,
// 0.047 against torch.sort's 0.075; 0.070 against 0.145 at (h1)'s
// proposal 0, 0.029 against 0.057 at an (i2)-shaped M 48,206 (queued, one
// call of the script above).
//
// The scatters (scatter_cols_accum, scatter_cols_outer) are one kernel,
// scatter_owned_kernel, after sort_ids. It walks the ids in sorted order
// and takes row t of that order from a template source, through the
// positions r = perm[t]: Rows loads g[r]; Outer<F> forms W[r] x cot[r]
// from W's 128 B and cot's 4F bytes (at F = 8 160 B a descriptor for the
// row's 1 KB). Sorted, each id's descriptors are contiguous. R / 8 lanes
// serve a descriptor, 8 floats a lane; each lane group owns a contiguous
// range of the sorted order (a block's groups consecutive ranges), loads
// the ids of 8 descriptors at once (broadcast by shuffle) and their rows,
// then walks them, summing in registers while the id repeats. A run that
// neither continues from the previous lane group's range nor into the
// next is the id's whole sum and is stored with plain stores; a run that
// does is written to a partial row of its range. In the same cooperative
// launch, after a grid barrier, each id that spans ranges gets its
// partials summed in range order: by one warp where they end within 32
// slots of its first (lane l adds columns l, l + 32, ... slot by slot),
// else by the block (a fixed strided split over its threads, then a fixed
// tree). No atomics: the same inputs give the same bits on every call.
// Why: with atomics the order of a brick's adds changed from call to call,
// and over 8 Adam steps the normal MLP's near-zero gradients turned that
// into differences above 2.5 lr: chip_smoke.py (i2)'s descriptor-sharded
// step failed its check against DP(4) in two runs of the script, and in 1
// of 6 runs of scripts/exp_torch_ds_repeats.py with the table gradient
// added by atomic runs, with DP(4) itself never repeating; sorted, 0 of 6,
// every DP(4) run the same bits (NVIDIA H100 80GB HBM3, 700 W).
//
// What the sorted design costs against the atomic ones. scatter_cols_outer,
// queued, one call of scripts/exp_torch_table_adjoints.py: at (d)'s field
// scatter (M 589,824, F 8) 0.203 ms against the earlier design's 0.232
// (torch.sort, the runs kernel, a separate combine launch after three
// memsets of scratch; scripts/exp_torch_table_adjoints_prior.cu) and
// atomic runs' 0.167; at (h1)'s proposal 0 (M 1,966,080, F 2) 0.240
// against 0.328 and 0.111. The same kernels as the earlier design on
// sort_ids' order (the combine a launch of its own) took 0.198 at (d),
// 0.240 at (h1)'s proposal 0 and 0.067 against 0.059 at the (i2)-shaped
// call: folding the combine in saves four launches a call and wins where
// a call is small. Forming each W[r, e] from the descriptor's offsets and
// base corner (36 bytes, read by every lane of the descriptor) in place of
// reading W's row was slower at every shape (0.3075 against 0.2028 ms at
// (d)): built in scripts/exp_torch_table_adjoints_variants.cu, on no path.
// scatter_cols_accum had atomic designs of its own: float4 atomics of runs
// summed in registers at F <= 2, and at F >= 4 32-column slabs of the
// table with level 0's 512 rows accumulated in shared memory. On W x cot
// rows of (d)'s field scatter they took 0.162 (runs) and 0.233 ms (slabs),
// at phase (a)'s uniform points 0.166 and 0.197 (one call each); row 5 at
// (h1)'s proposal 0, by runs, 0.1846 ms, and at phase (a) (M 589,824 rows
// of 256) by slabs 0.2623 queued. Sorted, row 5 takes 0.3152 ms queued at
// phase (a), 62% of its ~0.196 ms bound, the sort 0.047 of it (NVIDIA
// H100 80GB HBM3, 700 W): slower, on no path, and the same bits every
// call.
//
// hash_descriptors writes 168 bytes a descriptor (id 4, base corner 24,
// offsets 12, weights 128) from 12 bytes a point, so it is bound by its
// writes: at vo.map's three encodes (M ~10.35 M a step) ~1.74 GB, ~0.52
// ms. One thread computes one (level, point); a block's 256 points share a
// level (blockIdx.y), so the level's constants are uniform. Each store
// instruction of a warp covers whole 32-byte sectors: the weight rows go
// out two lanes a sector, 16 rows a store, each lane's 4 weights formed
// from the row's 9 axis weights, taken by shuffle from the lane that
// computed them; base corners and offsets go out as the warp's 96
// consecutive elements. Every store streams (st.global.cs): the weights
// of one encode exceed L2. Bitwise the plain chain: x res, floor and the
// offset are each rounded alone (__fmul_rn, __fsub_rn: no FMA), the cell
// is clamped after the int64 cast, the hash is Instant-NGP's in uint32
// (the plain chain masks int64 products to 32 bits), each axis weight is
// (i == lo) (1 - f) + (i == lo + 1) f and each weight (w0 w1) w2, every
// operation rounded as the plain chain's elementwise kernels round it.
// Queued behind a device sleep (NVIDIA H100 80GB HBM3, 700 W, 4096 rays):
// vo.map's field (M 3,145,728) 0.164 ms, 96.6% of its 0.159 ms bound,
// against 3.10 ms for the chain; its proposals 0 / 1 (M 5,242,880 /
// 1,966,080) 0.313 / 0.104 ms, 85.6% / 96.7%; slam.map's field (M
// 4,194,304) 0.219 ms, 96.8%.
//
// Plain C interface, bound with ctypes (nerf_vo_tpu_torch/ops/gather_cuda.py).

#include <cooperative_groups.h>
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

// R = 8L: lane j of a descriptor's L reads floats 8j..8j+7 of its row (two
// 16-byte loads) and stores them as one 16-byte streaming bf16 store into
// out[t] [M, R]. A warp serves batches of 32 / L x U descriptors (U =
// kGcUnroll, at most L): it loads their ids at once (one a lane) and serves
// them in U rounds of 32 / L descriptors, the ids broadcast by shuffle,
// with the row loads of all U rounds issued (predicated) before any is
// stored.
template <int L>
__global__ void __launch_bounds__(kThreads) gather_cols_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    __nv_bfloat16* __restrict__ out, int M, int n_bricks) {
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
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = t0 + u * DPW + q;
      if (t < M)
        __stcs(reinterpret_cast<uint4*>(out + t * R) + j,
               make_uint4(pack_bf16x2(a[u].x, a[u].y),
                          pack_bf16x2(a[u].z, a[u].w),
                          pack_bf16x2(b[u].x, b[u].y),
                          pack_bf16x2(b[u].z, b[u].w)));
    }
  }
}

template <int L>
int launch_gather_cols(const float* tab, const int* idx, __nv_bfloat16* out,
                       int M, int n_bricks, cudaStream_t stream) {
  static KernelFacts facts[kMaxDevices];
  auto kernel = gather_cols_kernel<L>;
  long long blocks = 0;
  cudaError_t err = resident_grid(kernel, facts, kThreads, 0, 0, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int U = L < kGcUnroll ? L : kGcUnroll;
  const long long per_block = kWarps * (32 / L) * U;
  const long long need = (M + per_block - 1) / per_block;
  if (blocks > need) blocks = need;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      tab, idx, out, M, n_bricks);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// gather_cols_dfrac: the position pullback, one thread a descriptor, only
// the 8 corners of its cell read
// ---------------------------------------------------------------------------

constexpr int kDfThreads = 256;
constexpr int kMaxLevels = 32;

// The levels of the ids a launch is given: level l's first id (ascending)
// and resolution; an id's level is the last whose first id is at most it.
struct Levels {
  int n;
  int first[kMaxLevels];
  float res[kMaxLevels];
};

// Descriptor t (brick idx[t], base corner local[t] in {0, 1}^3 of its
// 3x3x3 lattice, offsets frac[t] in its cell): the entries of the cell's 8
// corners, e = ((lo0 + a) 3 + lo1 + b) 3 + lo2 + c, are the only ones with
// a non-zero weight or weight derivative. Each corner's F features are
// read (one 32-byte sector at F = 8), rounded to bf16 and contracted with
// cot[t] into D[a][b][c]; the separable weights (1 - f, f) and their
// derivatives (-1, +1) reduce D, in registers, to the three position
// derivatives of <features, cot>, times the level's resolution. A thread
// sums in a fixed order whatever t is, so a descriptor gets the same bits
// wherever it lies in the launch.
template <int F>
__global__ void __launch_bounds__(kDfThreads) gather_cols_dfrac_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ cot, const long long* __restrict__ local,
    const float* __restrict__ frac, float* __restrict__ out, int M,
    int n_bricks, Levels lv) {
  constexpr int R = 32 * F;
  const long long stride = static_cast<long long>(gridDim.x) * kDfThreads;
  for (long long t =
           static_cast<long long>(blockIdx.x) * kDfThreads + threadIdx.x;
       t < M; t += stride) {
    const int b = __ldcs(idx + t);
    const bool ok = b >= 0 && b < n_bricks;
    int lo[3];
    float f[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = static_cast<int>(__ldcs(local + 3 * t + a)) & 1;
      f[a] = __ldcs(frac + 3 * t + a);
    }
    float c[F];
    ld_floats_if<F, true>(cot + t * F, true, c);
    const float* row = tab + static_cast<long long>(ok ? b : 0) * R;
    float v[8][F];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = ((lo[0] + (k >> 2)) * 3 + lo[1] + ((k >> 1) & 1)) * 3 +
                    lo[2] + (k & 1);
      ld_floats_if<F, false>(row + e * F, ok, v[k]);
    }
    float D[8];  // D[a b c] at k = 4a + 2b + c
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float acc = bf16_round(v[k][0]) * c[0];
#pragma unroll
      for (int i = 1; i < F; ++i) acc = fmaf(bf16_round(v[k][i]), c[i], acc);
      D[k] = acc;
    }
    const float w0[2] = {1.f - f[0], f[0]};
    const float w1[2] = {1.f - f[1], f[1]};
    const float w2[2] = {1.f - f[2], f[2]};
    float ij[2][2];  // sum_c D[a b c] w2[c]
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb)
        ij[a][bb] = D[4 * a + 2 * bb] * w2[0] + D[4 * a + 2 * bb + 1] * w2[1];
    const float g0 = (ij[1][0] * w1[0] + ij[1][1] * w1[1]) -
                     (ij[0][0] * w1[0] + ij[0][1] * w1[1]);
    const float g1 = (ij[0][1] * w0[0] + ij[1][1] * w0[1]) -
                     (ij[0][0] * w0[0] + ij[1][0] * w0[1]);
    float kk[2];  // sum_ab D[a b c] w0[a] w1[b]
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
      kk[cc] = ((D[cc] * (w0[0] * w1[0]) + D[2 + cc] * (w0[0] * w1[1])) +
                D[4 + cc] * (w0[1] * w1[0])) +
               D[6 + cc] * (w0[1] * w1[1]);
    const float g2 = kk[1] - kk[0];
    int l = 0;
    for (int k = 1; k < lv.n; ++k) l += b >= lv.first[k];
    const float s = lv.res[l];
    __stcs(out + 3 * t + 0, g0 * s);
    __stcs(out + 3 * t + 1, g1 * s);
    __stcs(out + 3 * t + 2, g2 * s);
  }
}

template <int F>
int launch_dfrac(const float* tab, const int* idx, const float* cot,
                 const long long* local, const float* frac, float* out,
                 int M, int n_bricks, const Levels& lv, cudaStream_t stream) {
  static KernelFacts facts[kMaxDevices];
  auto kernel = gather_cols_dfrac_kernel<F>;
  long long blocks = 0;
  cudaError_t err = resident_grid(kernel, facts, kDfThreads, 0, 0, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (M + kDfThreads - 1) / kDfThreads;
  if (blocks > need) blocks = need;
  kernel<<<static_cast<unsigned int>(blocks), kDfThreads, 0, stream>>>(
      tab, idx, cot, local, frac, out, M, n_bricks, lv);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// hash_descriptors: an encode's descriptors, one thread a (level, point),
// every store a whole sector
// ---------------------------------------------------------------------------

constexpr int kHdThreads = 256;
constexpr unsigned int kHashPrime1 = 2654435761u;  // Instant-NGP's primes
constexpr unsigned int kHashPrime2 = 805459861u;   // (the first is 1)

// The grid's levels: level l's resolution, its bricks per axis and whether
// its whole brick lattice fits its n_bricks rows (dense) or is hashed;
// level l's rows start at l * n_bricks.
struct GridLevels {
  int n_bricks;
  int res[kMaxLevels];
  int bpa[kMaxLevels];
  int dense[kMaxLevels];
};

// (i == lo) (1 - f) + (i == lo + 1) f, with each product and the sum
// rounded on its own, as the plain chain forms it (omf = 1 - f): 1 - f, f
// or +0 for a finite f in [0, 1].
__device__ __forceinline__ float axis_weight(int i, int lo, float f,
                                             float omf) {
  return __fadd_rn(__fmul_rn(i == lo ? 1.f : 0.f, omf),
                   __fmul_rn(i == lo + 1 ? 1.f : 0.f, f));
}

// Entry c of a brick's weight row from the 3 x 3 axis weights ws (w0 at
// 0..2, w1 at 3..5, w2 at 6..8): (w0[i] w1[j]) w2[k] at c = (3i + j) 3 + k,
// 0 on the padding entries 27..31.
__device__ __forceinline__ float brick_weight(const float* ws, int c) {
  if (c >= kEntries) return 0.f;
  return __fmul_rn(__fmul_rn(ws[c / 9], ws[3 + (c / 3) % 3]), ws[6 + c % 3]);
}

// Block (x, l) serves level l of points [256 x, 256 x + 256): thread p
// computes descriptor l N + p, and each warp writes its 32 consecutive
// descriptors' rows with stores that cover whole 32-byte sectors: the ids
// one 128-byte store; the base corners (int64) and offsets as the warp's
// 96 consecutive elements, lane j elements j, j + 32, j + 64 (taken from
// their descriptor's lane by shuffle); a weight row as 4 sectors, two
// lanes a sector and 16 rows a store (the axis weights of the row's
// descriptor taken by shuffle). The blocks of level 0 also write `inside`.
__global__ void __launch_bounds__(kHdThreads) hash_descriptors_kernel(
    const float* __restrict__ x, int* __restrict__ idx,
    long long* __restrict__ local, float* __restrict__ frac,
    float* __restrict__ W, unsigned char* __restrict__ inside, int N,
    const __grid_constant__ GridLevels lv) {
  constexpr unsigned int kAll = 0xffffffffu;
  const int l = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long p0 = static_cast<long long>(blockIdx.x) * kHdThreads +
                       (threadIdx.x & ~31);
  if (p0 >= N) return;  // the whole warp
  const int nv = N - p0 < 32 ? static_cast<int>(N - p0) : 32;
  const bool ok = lane < nv;
  const long long p = p0 + lane;
  float xv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) xv[a] = ok ? __ldg(x + 3 * p + a) : 0.f;

  if (l == 0) {  // inside: x in [0, 1], per coordinate
    int in = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) in |= (xv[a] >= 0.f && xv[a] <= 1.f) << a;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int e = lane + 32 * k;
      const int d = e / 3;
      const int v = __shfl_sync(kAll, in, d);
      if (d < nv) inside[3 * p0 + e] = (v >> (e - 3 * d)) & 1;
    }
  }

  // scale, floor, subtract, each rounded on its own (no FMA); the cell
  // clamped to [0, res - 1] after the cast, so x = 1 takes cell res - 1
  // with offset 0
  const int res = lv.res[l];
  const float rf = static_cast<float>(res);
  float f[3], omf[3];
  int cb[3];
  int lo = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float v = xv[a];
    const float xt = isnan(v) ? v : fminf(fmaxf(v, 0.f), 1.f);
    const float xs = __fmul_rn(xt, rf);
    const float fl = floorf(xs);
    f[a] = __fsub_rn(xs, fl);
    omf[a] = __fsub_rn(1.f, f[a]);
    long long c = static_cast<long long>(fl);
    c = c < 0 ? 0 : (c > res - 1 ? res - 1 : c);
    cb[a] = static_cast<int>(c) >> 1;
    lo |= (static_cast<int>(c) & 1) << a;
  }
  unsigned int bid;
  if (lv.dense[l]) {
    const int bpa = lv.bpa[l];
    bid = static_cast<unsigned int>((cb[0] * bpa + cb[1]) * bpa + cb[2]);
  } else {  // 32-bit products, wrapping
    const unsigned int h = static_cast<unsigned int>(cb[0]) ^
                           static_cast<unsigned int>(cb[1]) * kHashPrime1 ^
                           static_cast<unsigned int>(cb[2]) * kHashPrime2;
    bid = h % static_cast<unsigned int>(lv.n_bricks);
  }
  const long long t0 = static_cast<long long>(l) * N + p0;
  if (ok) __stcs(idx + t0 + lane, static_cast<int>(bid) + l * lv.n_bricks);

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int e = lane + 32 * k;
    const int d = e / 3;
    const int a = e - 3 * d;
    const int bits = __shfl_sync(kAll, lo, d);
    const float f0 = __shfl_sync(kAll, f[0], d);
    const float f1 = __shfl_sync(kAll, f[1], d);
    const float f2 = __shfl_sync(kAll, f[2], d);
    if (d < nv) {
      __stcs(local + 3 * t0 + e, static_cast<long long>((bits >> a) & 1));
      __stcs(frac + 3 * t0 + e, a == 0 ? f0 : (a == 1 ? f1 : f2));
    }
  }

  float w[9];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      w[3 * a + i] = axis_weight(i, (lo >> a) & 1, f[a], omf[a]);
  const int half = lane & 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int src = (lane >> 1) + 16 * h;
    float ws[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) ws[q] = __shfl_sync(kAll, w[q], src);
    if (src < nv) {
      float* row = W + (t0 + src) * 32 + 4 * half;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = half ? brick_weight(ws, 8 * s + 4 + e)
                      : brick_weight(ws, 8 * s + e);
        __stcs(reinterpret_cast<float4*>(row + 8 * s),
               make_float4(v[0], v[1], v[2], v[3]));
      }
    }
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
// the scatters: ids sorted, runs of equal ids summed in registers, each
// id's sum stored once, in one cooperative launch
// ---------------------------------------------------------------------------

// The row sources: row t of the id-sorted order is descriptor r = perm[t]'s
// row; load() gives its floats col..col+7 (col a multiple of 8), zeros
// where !ok.
//
// Rows (scatter_cols_accum, row 5): g[r] [M, R], loaded with streaming
// loads (each row is read once).
struct Rows {
  const float* g;
  const int* perm;
  template <int R>
  __device__ __forceinline__ void load(long long t, int col, bool ok,
                                       float (&v)[8]) const {
    const long long r = ok ? __ldg(perm + t) : 0;
    ld_floats_if<8, true>(g + r * R + col, ok, v);
  }
};

// Outer<F> (scatter_cols_outer, the table adjoint of row 3): W[r] (x)
// cot[r], column e F + f = W[r, e] * cot[r, f] (W [M, 32], cot [M, F]):
// one f32 multiply each, the value the materialized row held. The 8
// columns from col span one entry's 8 features (F = 8) or 8 / F whole
// entries (F < 8): the lane loads those W values (streaming: each is read
// by one lane) and cot[r]'s features (read-only path: the other lanes of
// the descriptor read them too).
template <int F>
struct Outer {
  const float* W;
  const float* cot;
  const int* perm;
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

constexpr int kRunThreads = 512;
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kRunTile = 8;  // descriptors whose rows load at once

// Where a run's sum goes. The ids are sorted, so each id's descriptors are
// contiguous: a run that neither continues from the previous range nor
// into the next is the id's whole sum and is stored; a run that does is
// written to a partial row of its range (slot 2g for the range's first
// run, 2g + 1 for its last), which the kernel's second phase sums in range
// order. A partial's code: 2 b + 1 for the first part of id b's sum (the
// run that starts it), 2 b for a later part; -1 for an empty slot, whose
// row holds zeros. A lane group clears its two slots before its first run.
struct OwnRuns {
  float* out;
  float* part;   // [2 * groups, R]
  int* part_id;  // [2 * groups]
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
  // lane j's 8 floats of both slots zeroed, their codes -1 (lane 0)
  template <int R>
  __device__ __forceinline__ void clear(const Range& r, int j) const {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float4* o = reinterpret_cast<float4*>(part + (2 * r.g + s) * R + 8 * j);
      o[0] = z;
      o[1] = z;
    }
    if (j == 0) {
      part_id[2 * r.g] = -1;
      part_id[2 * r.g + 1] = -1;
    }
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
      if (j == 0) part_id[slot] = 2 * b + (from_prev ? 0 : 1);
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
template <int F, typename Src>
__device__ __forceinline__ void scatter_runs(Src src,
                                             const int* __restrict__ idx,
                                             OwnRuns sink, int M,
                                             int n_bricks, long long span) {
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
  const OwnRuns::Range rg = sink.range(g, lo, hi, idx, M);
  sink.clear<R>(rg, j);
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
        if (cur >= 0) sink.put<R>(rg, cur, j, acc);
        cur = b[u];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = v[u][i];
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += v[u][i];
      }
    }
  }
  if (cur >= 0) sink.put<R>(rg, cur, j, acc);
}

constexpr int kCombUnroll = 4;  // slots a thread loads at once

// The sum of id b's parts, slots [s, end) from head slot s (code 2 b + 1)
// to the first later slot holding another id's code (empty slots between
// parts hold zeros), by the whole block: thread r of P takes slots s + r,
// s + r + P, ..., kCombUnroll loads in flight, then a fixed tree over r in
// shared memory; the total is stored in b's row. The order is fixed, so
// the result does not depend on which block takes which head. part and
// part_id were written by this launch: read through L2 (__ldcg).
template <int F>
__device__ void combine_head(const float* part, const int* part_id,
                             float* out, int s, int n_slots, float4* red,
                             int* end) {
  constexpr int R = 32 * F;
  constexpr int C = R / 4;            // float4 columns of a row
  constexpr int P = kRunThreads / C;  // slots summed at once
  const int c4 = threadIdx.x % C;
  const int r = threadIdx.x / C;
  const int b = __ldcg(part_id + s) >> 1;
  if (threadIdx.x == 0) *end = n_slots;
  __syncthreads();
  for (int k0 = s + 1; k0 < n_slots; k0 += kRunThreads) {
    const int k = k0 + threadIdx.x;
    const int c = k < n_slots ? __ldcg(part_id + k) : -1;
    if (c >= 0 && c != 2 * b) atomicMin(end, k);
    __syncthreads();
    const bool found = *end < n_slots;
    __syncthreads();
    if (found) break;
  }
  const int stop = *end;
  const float4* col = reinterpret_cast<const float4*>(part) + c4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int k = s + r;
  for (; k + (kCombUnroll - 1) * P < stop; k += kCombUnroll * P) {
    float4 v[kCombUnroll];
#pragma unroll
    for (int u = 0; u < kCombUnroll; ++u)
      v[u] = __ldcg(col + static_cast<long long>(k + u * P) * C);
#pragma unroll
    for (int u = 0; u < kCombUnroll; ++u) {
      acc.x += v[u].x;
      acc.y += v[u].y;
      acc.z += v[u].z;
      acc.w += v[u].w;
    }
  }
  for (; k < stop; k += P) {
    const float4 v = __ldcg(col + static_cast<long long>(k) * C);
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

// combine_head's sum by one warp, for a head whose parts end within the 32
// slots after it (the usual case: an id split by one range boundary):
// lane l holds float4 columns l, l + 32, ... and adds the slots in order.
// Returns false, and does nothing, for a head whose parts go on further.
template <int F>
__device__ __forceinline__ bool combine_head_warp(const float* part,
                                                  const int* part_id,
                                                  float* out, int s,
                                                  int n_slots) {
  constexpr int C = 32 * F / 4;  // float4 columns of a row
  const int lane = threadIdx.x & 31;
  const int b = __ldcg(part_id + s) >> 1;
  const int k = s + 1 + lane;
  const int c = k < n_slots ? __ldcg(part_id + k) : -1;
  const unsigned other =
      __ballot_sync(0xffffffffu, k >= n_slots || (c >= 0 && c != 2 * b));
  if (other == 0) return false;
  const int stop = s + __ffs(other);  // the first slot of another id
  const float4* col = reinterpret_cast<const float4*>(part);
  for (int c4 = lane; c4 < C; c4 += 32) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = s; j < stop; ++j) {
      const float4 v = __ldcg(col + static_cast<long long>(j) * C + c4);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    reinterpret_cast<float4*>(out + static_cast<long long>(b) * 32 * F)[c4] =
        acc;
  }
  return true;
}

// A scatter in one cooperative launch: the runs on the sorted ids with the
// OwnRuns sink, a grid-wide barrier, then the ids that span
// ranges: each block reads the codes of its share of the slots at once;
// its warps combine the heads among them whose parts end within 32 slots
// (combine_head_warp), one warp a head, and the block combines the rest
// (combine_head), one after another. Which of the two sums a head depends
// only on where its parts end, so the result is the same on every call.
template <int F, typename Src>
__global__ void __launch_bounds__(kRunThreads, 1) scatter_owned_kernel(
    Src src, const int* __restrict__ sidx, OwnRuns sink, int M, int n_bricks,
    long long span) {
  namespace cg = cooperative_groups;
  constexpr int G = 32 / (32 * F / 8);
  __shared__ float4 red[kRunThreads];
  __shared__ int heads[kRunThreads];
  __shared__ int big[kRunThreads];
  __shared__ int n_heads, n_big, end;
  scatter_runs<F>(src, sidx, sink, M, n_bricks, span);
  cg::this_grid().sync();
  const int warp = threadIdx.x >> 5;
  const int n_slots = 2 * gridDim.x * kRunWarps * G;
  const int chunk = (n_slots + gridDim.x - 1) / gridDim.x;
  const int s_lo = blockIdx.x * chunk;
  const int s_hi = s_lo + chunk < n_slots ? s_lo + chunk : n_slots;
  for (int s0 = s_lo; s0 < s_hi; s0 += kRunThreads) {
    if (threadIdx.x == 0) n_heads = n_big = 0;
    __syncthreads();
    const int s = s0 + threadIdx.x;
    if (s < s_hi) {
      const int code = __ldcg(sink.part_id + s);
      if (code >= 0 && (code & 1)) heads[atomicAdd(&n_heads, 1)] = s;
    }
    __syncthreads();
    const int nh = n_heads;
    for (int h = warp; h < nh; h += kRunWarps)
      if (!combine_head_warp<F>(sink.part, sink.part_id, sink.out, heads[h],
                                n_slots) &&
          (threadIdx.x & 31) == 0)
        big[atomicAdd(&n_big, 1)] = heads[h];
    __syncthreads();
    const int nb = n_big;
    for (int h = 0; h < nb; ++h)
      combine_head<F>(sink.part, sink.part_id, sink.out, big[h], n_slots,
                      red, &end);
    __syncthreads();
  }
}

// scatter_owned_kernel's grid for M descriptors: blocks (at most those
// resident at once, which depends on the row source's registers) and
// descriptors a lane group (span); its scratch slots (two a lane group)
// and its launch.
template <int F, typename Src>
cudaError_t owned_grid(int M, long long* blocks, long long* span) {
  static KernelFacts facts[kMaxDevices];
  constexpr int groups = kRunWarps * (32 / (32 * F / 8));  // a block's
  cudaError_t err = resident_grid(scatter_owned_kernel<F, Src>, facts,
                                  kRunThreads, 0, 0, blocks);
  if (err != cudaSuccess) return err;
  const long long need = (M + groups * kRunTile - 1) / (groups * kRunTile);
  if (*blocks > need) *blocks = need;
  if (*blocks < 1) *blocks = 1;
  *span = (M + *blocks * groups - 1) / (*blocks * groups);
  return cudaSuccess;
}

template <int F, typename Src>
long long owned_slots(int M) {
  long long blocks = 0, span = 0;
  if (owned_grid<F, Src>(M, &blocks, &span) != cudaSuccess) return -1;
  return 2 * blocks * kRunWarps * (32 / (32 * F / 8));
}

// part [owned_slots(M), 32F] f32, part_id [owned_slots(M)] int32: scratch
template <int F, typename Src>
int launch_scatter_owned(Src src, const int* sidx, float* out, float* part,
                         int* part_id, int M, int n_bricks,
                         cudaStream_t stream) {
  long long blocks = 0, span = 0;
  cudaError_t err = owned_grid<F, Src>(M, &blocks, &span);
  if (err != cudaSuccess) return static_cast<int>(err);
  OwnRuns sink{out, part, part_id};
  auto kernel = scatter_owned_kernel<F, Src>;
  void* args[] = {&src, &sidx, &sink, &M, &n_bricks, &span};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel),
      dim3(static_cast<unsigned int>(blocks)), dim3(kRunThreads), args, 0,
      stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// ---------------------------------------------------------------------------
// sort_ids: a stable LSD radix sort of brick ids, 8 bits a pass, in one
// cooperative launch of one block an SM
// ---------------------------------------------------------------------------

constexpr int kSortThreads = 1024;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kSortParts = kSortThreads / kDigits;  // threads a digit
constexpr int kSortRounds = 8;  // 32-key rounds of a warp in a sub-tile
constexpr int kSortTile = kSortWarps * kSortRounds * 32;  // 8192 keys
constexpr int kSortStage = 2 * kSortTile * 4;  // staged keys and positions

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive sum over the block of one int a thread; `total` gets the
// block's sum. red: kSortWarps ints of shared memory. Every thread calls.
__device__ __forceinline__ int block_exclusive_sum(int v, int* red,
                                                   int* total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < kSortWarps ? red[lane] : 0;
#pragma unroll
    for (int o = 1; o < kSortWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kSortWarps) red[lane] = s;
  }
  __syncthreads();
  *total = red[kSortWarps - 1];
  const int before = w > 0 ? red[w - 1] : 0;
  __syncthreads();
  return before + x - v;
}

// One sub-tile of a block's keys: kSortTile consecutive positions from t0
// (none at or past hi), warp w taking rounds w kSortRounds .. (w + 1)
// kSortRounds - 1 of 32 (lane l of round r: t0 + 32 r + l). The first pass
// reads the ids (key: the id in [0, n_bricks), else n_bricks) and numbers
// them; later passes read what the pass before wrote in this launch
// (through L2). Each key's digit (-1 past hi) and its rank among the
// warp's earlier keys of that digit, counts[w][d] counting the warp's keys
// of digit d on from its value on entry. Stable: positions ascend with the
// warp, then the round, then the lane.
struct SortTile {
  int key[kSortRounds];
  int val[kSortRounds];
  int digit[kSortRounds];
  int rank[kSortRounds];
};

__device__ __forceinline__ void rank_sort_tile(
    const int* src_k, const int* src_v, long long t0, long long hi,
    int n_bricks, int shift, int (*counts)[kDigits], SortTile& st) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long base = t0 + static_cast<long long>(w) * kSortRounds * 32;
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    const long long pos = base + 32 * r + lane;
    int key = 0, val = 0;
    if (pos < hi) {
      key = __ldcg(src_k + pos);
      if (src_v == nullptr) {
        key = key >= 0 && key < n_bricks ? key : n_bricks;
        val = static_cast<int>(pos);
      } else {
        val = __ldcg(src_v + pos);
      }
    }
    st.key[r] = key;
    st.val[r] = val;
    st.digit[r] = pos < hi ? (key >> shift) & (kDigits - 1) : -1;
  }
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    const int d = st.digit[r];
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    int before = 0;
    if (d >= 0) {
      before = counts[w][d];
      st.rank[r] = before + __popc(peers & lanemask_lt());
    }
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers) - 1)
      counts[w][d] = before + __popc(peers);
    __syncwarp();
  }
}

// Each pass moves every key by one digit. Block b owns the consecutive
// keys [b chunk, (b + 1) chunk). (1) It counts their digits (sub-tile by
// sub-tile, warps in shared memory) and writes its counts to
// bc[b][digit]; barrier. (2) Per digit, four threads read bc's column:
// the keys of smaller digits and those of the digit in earlier blocks give
// where the block's keys of the digit start (run[d]). Then sub-tile by
// sub-tile: the keys are ranked in their warps, staged in shared memory in
// digit order (a digit's keys in position order), and written out by the
// whole block in staged order, so that each digit's keys of a sub-tile
// are stored as one contiguous run (a key stored alone costs a transaction
// of its own); barrier. The passes alternate between (keys, perm) and
// (tmp_k, tmp_v) so that the last writes (keys, perm). Stable: within a
// digit, keys keep the order of their positions. Dynamic shared memory:
// kSortStage bytes (the staged keys and positions).
__global__ void __launch_bounds__(kSortThreads, 1) sort_ids_kernel(
    const int* __restrict__ idx, int* keys, int* perm, int* tmp_k,
    int* tmp_v, int* bc, int M, int n_bricks, int passes) {
  namespace cg = cooperative_groups;
  __shared__ int counts[kSortWarps][kDigits];
  __shared__ int part[2][kSortParts][kDigits];
  __shared__ int run[kDigits], start[kDigits], total[kDigits];
  __shared__ int red[kSortWarps];
  extern __shared__ int sort_stage[];
  int* sk = sort_stage;
  int* sv = sort_stage + kSortTile;
  const int w = threadIdx.x >> 5;
  const int d = threadIdx.x % kDigits;  // this thread's digit
  const int q = threadIdx.x / kDigits;  // and its share of bc's column
  const long long chunk = (M + gridDim.x - 1) / gridDim.x;
  const long long lo0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long lo = lo0 < M ? lo0 : M;
  const long long hi = lo0 + chunk < M ? lo0 + chunk : M;
  for (int i = threadIdx.x; i < kSortWarps * kDigits; i += kSortThreads)
    (&counts[0][0])[i] = 0;
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const int shift = kDigitBits * p;
    const bool to_out = ((passes - 1 - p) & 1) == 0;
    int* dst_k = to_out ? keys : tmp_k;
    int* dst_v = to_out ? perm : tmp_v;
    const int* src_k = p == 0 ? idx : (to_out ? tmp_k : keys);
    const int* src_v = p == 0 ? nullptr : (to_out ? tmp_v : perm);
    // (1)
    for (long long t0 = lo; t0 < hi; t0 += kSortTile) {
      SortTile st;
      rank_sort_tile(src_k, src_v, t0, hi, n_bricks, shift, counts, st);
    }
    __syncthreads();
    if (threadIdx.x < kDigits) {
      int c = 0;
      for (int i = 0; i < kSortWarps; ++i) {
        c += counts[i][d];
        counts[i][d] = 0;
      }
      bc[static_cast<long long>(blockIdx.x) * kDigits + d] = c;
    }
    cg::this_grid().sync();
    // (2)
    int all = 0, before = 0;
    for (int b0 = q; b0 < static_cast<int>(gridDim.x);
         b0 += kSortParts * 16) {
      int v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int b = b0 + u * kSortParts;
        v[u] = b < static_cast<int>(gridDim.x)
                   ? __ldcg(bc + static_cast<long long>(b) * kDigits + d)
                   : 0;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        all += v[u];
        before += b0 + u * kSortParts < static_cast<int>(blockIdx.x) ? v[u]
                                                                     : 0;
      }
    }
    part[0][q][d] = all;
    part[1][q][d] = before;
    __syncthreads();
    all = before = 0;
    if (threadIdx.x < kDigits) {
      for (int i = 0; i < kSortParts; ++i) {
        all += part[0][i][d];
        before += part[1][i][d];
      }
    }
    int n_keys = 0;
    const int smaller = block_exclusive_sum(all, red, &n_keys);
    if (threadIdx.x < kDigits) run[d] = smaller + before;
    for (long long t0 = lo; t0 < hi; t0 += kSortTile) {
      SortTile st;
      rank_sort_tile(src_k, src_v, t0, hi, n_bricks, shift, counts, st);
      __syncthreads();
      int c = 0;
      if (threadIdx.x < kDigits) {
        for (int i = 0; i < kSortWarps; ++i) {
          const int ci = counts[i][d];
          counts[i][d] = c;
          c += ci;
        }
      }
      int staged = 0;
      const int at = block_exclusive_sum(c, red, &staged);
      if (threadIdx.x < kDigits) {
        start[d] = at;
        total[d] = c;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kSortRounds; ++r) {
        const int dg = st.digit[r];
        if (dg < 0) continue;
        const int i = start[dg] + counts[w][dg] + st.rank[r];
        sk[i] = st.key[r];
        sv[i] = st.val[r];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < staged; i += kSortThreads) {
        const int key = sk[i];
        const int dg = (key >> shift) & (kDigits - 1);
        const int pos = run[dg] + i - start[dg];
        dst_k[pos] = key;
        dst_v[pos] = sv[i];
      }
      __syncthreads();
      if (threadIdx.x < kDigits) {
        run[d] += total[d];
        for (int i = 0; i < kSortWarps; ++i) counts[i][d] = 0;
      }
      __syncthreads();
    }
    if (p + 1 < passes) cg::this_grid().sync();
  }
}

// 8-bit passes for keys up to n_bricks (the key of an id out of range)
int sort_passes(int n_bricks) {
  int bits = 1;
  while (bits < 31 && (1LL << bits) <= n_bricks) ++bits;
  return (bits + kDigitBits - 1) / kDigitBits;
}

// sort_ids_kernel's grid for M ids: its resident blocks, at most one a
// 1024 ids
cudaError_t sort_grid(int M, long long* blocks) {
  static KernelFacts facts[kMaxDevices];
  cudaError_t err = resident_grid(sort_ids_kernel, facts, kSortThreads,
                                  kSortStage, kSortStage, blocks);
  if (err != cudaSuccess) return err;
  const long long need = (M + kSortThreads - 1) / kSortThreads;
  if (*blocks > need) *blocks = need;
  if (*blocks < 1) *blocks = 1;
  return cudaSuccess;
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
  switch (R) {
    case 32: return launch_gather_cols<4>(tb, ix, o, M, n_bricks, s);
    case 64: return launch_gather_cols<8>(tb, ix, o, M, n_bricks, s);
    case 128: return launch_gather_cols<16>(tb, ix, o, M, n_bricks, s);
    case 256: return launch_gather_cols<32>(tb, ix, o, M, n_bricks, s);
    default: {
      const int blocks = (M + kWarps - 1) / kWarps;
      gather_cols_any_kernel<<<blocks, kThreads, 0, s>>>(tb, ix, o, M, R,
                                                         n_bricks);
      return static_cast<int>(cudaGetLastError());
    }
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

// g [M, 32F] f32; sidx [M] int32 the keys of sort_ids (the ids sorted,
// stably; n_bricks for an id out of range) and perm [M] int32 their
// positions; out [n_bricks, 32F] f32, zeroed by the caller: out[b] = sum of
// g[t] over idx[t] == b, each id's rows summed in sorted order, the same on
// every call. part [slots, 32F] f32 and part_id [slots] int32 are scratch,
// slots = scatter_slots(M, F, 0). One cooperative launch.
extern "C" int scatter_cols_accum(const void* g, const void* sidx,
                                  const void* perm, void* out, void* part,
                                  void* part_id, int M, int F, int n_bricks,
                                  void* stream) {
  if (M == 0) return 0;
  const Rows src{static_cast<const float*>(g), static_cast<const int*>(perm)};
  const int* ix = static_cast<const int*>(sidx);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(part);
  int* pi = static_cast<int*>(part_id);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_scatter_owned<1>(src, ix, o, pt, pi, M, n_bricks, s);
    case 2: return launch_scatter_owned<2>(src, ix, o, pt, pi, M, n_bricks, s);
    case 4: return launch_scatter_owned<4>(src, ix, o, pt, pi, M, n_bricks, s);
    case 8: return launch_scatter_owned<8>(src, ix, o, pt, pi, M, n_bricks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// W [M, 32] f32, cot [M, F] f32 (aligned to 4F bytes, 16 at F = 8); sidx
// [M] int32 the keys of sort_ids (the ids sorted, stably; n_bricks for an
// id out of range) and perm [M] int32 their positions; out [n_bricks, 32F]
// f32, zeroed by the caller: out[b, e F + f] = sum of W[t, e] cot[t, f]
// over idx[t] == b, the product formed in registers, each id's terms
// summed in sorted order, the same on every call. part [slots, 32F] f32
// and part_id [slots] int32 are scratch, slots = scatter_slots(M, F, 1).
// One cooperative launch.
extern "C" int scatter_cols_outer(const void* W, const void* cot,
                                  const void* sidx, const void* perm,
                                  void* out, void* part, void* part_id,
                                  int M, int F, int n_bricks, void* stream) {
  if (M == 0) return 0;
  const float* w = static_cast<const float*>(W);
  const float* c = static_cast<const float*>(cot);
  const int* ix = static_cast<const int*>(sidx);
  const int* pm = static_cast<const int*>(perm);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(part);
  int* pi = static_cast<int*>(part_id);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_scatter_owned<1>(Outer<1>{w, c, pm}, ix, o, pt, pi,
                                           M, n_bricks, s);
    case 2: return launch_scatter_owned<2>(Outer<2>{w, c, pm}, ix, o, pt, pi,
                                           M, n_bricks, s);
    case 4: return launch_scatter_owned<4>(Outer<4>{w, c, pm}, ix, o, pt, pi,
                                           M, n_bricks, s);
    case 8: return launch_scatter_owned<8>(Outer<8>{w, c, pm}, ix, o, pt, pi,
                                           M, n_bricks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The scratch slots of a scatter of M descriptors on the current device,
// scatter_cols_outer's where `outer`, else scatter_cols_accum's (the grid
// follows the kernel's resources, which differ by row source), or a
// negative value if the grid cannot be sized.
extern "C" long long scatter_slots(int M, int F, int outer) {
  switch (F) {
    case 1: return outer ? owned_slots<1, Outer<1>>(M)
                         : owned_slots<1, Rows>(M);
    case 2: return outer ? owned_slots<2, Outer<2>>(M)
                         : owned_slots<2, Rows>(M);
    case 4: return outer ? owned_slots<4, Outer<4>>(M)
                         : owned_slots<4, Rows>(M);
    case 8: return outer ? owned_slots<8, Outer<8>>(M)
                         : owned_slots<8, Rows>(M);
    default: return -1;
  }
}

// tab [n_bricks, 32F] f32, idx [M] int32, cot [M, F] f32 (aligned to 4F
// bytes, 16 at F = 8), local [M, 3] int64 (each 0 or 1), frac [M, 3] f32
// -> out [M, 3] f32: res[l] d<gather_interp(tab, idx, W, F)[t], cot[t]> /
// dfrac[t], W the trilinear weights of (local[t], frac[t]) and l the level
// of idx[t] among the n_levels levels whose first ids are first[]
// (ascending) and resolutions res[] (host arrays, n_levels <= 32). An id out
// of range gives zeros. F in {1, 2, 4, 8}.
extern "C" int gather_cols_dfrac(const void* tab, const void* idx,
                                 const void* cot, const void* local,
                                 const void* frac, void* out, int M, int F,
                                 int n_bricks, int n_levels,
                                 const int* first, const float* res,
                                 void* stream) {
  if (M == 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.first[l] = first[l];
    lv.res[l] = res[l];
  }
  const float* tb = static_cast<const float*>(tab);
  const int* ix = static_cast<const int*>(idx);
  const float* c = static_cast<const float*>(cot);
  const long long* lc = static_cast<const long long*>(local);
  const float* fr = static_cast<const float*>(frac);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_dfrac<1>(tb, ix, c, lc, fr, o, M, n_bricks, lv, s);
    case 2: return launch_dfrac<2>(tb, ix, c, lc, fr, o, M, n_bricks, lv, s);
    case 4: return launch_dfrac<4>(tb, ix, c, lc, fr, o, M, n_bricks, lv, s);
    case 8: return launch_dfrac<8>(tb, ix, c, lc, fr, o, M, n_bricks, lv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [N, 3] f32 -> the n_levels-level grid's descriptors, level-major (M =
// n_levels N): idx [M] int32 (global rows, level l's from l n_bricks),
// local [M, 3] int64, frac [M, 3] f32, W [M, 32] f32 and inside [N, 3]
// bool, bitwise hash_grid's plain chain. res[], bpa[] and dense[] are each
// level's resolution, bricks per axis and whether it is dense (host
// arrays, n_levels <= 32); n_levels n_bricks < 2^31.
extern "C" int hash_descriptors(const void* x, void* idx, void* local,
                                void* frac, void* W, void* inside, int N,
                                int n_levels, const int* res, const int* bpa,
                                const int* dense, int n_bricks,
                                void* stream) {
  if (N == 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || n_bricks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GridLevels lv{};
  lv.n_bricks = n_bricks;
  for (int l = 0; l < n_levels; ++l) {
    lv.res[l] = res[l];
    lv.bpa[l] = bpa[l];
    lv.dense[l] = dense[l];
  }
  const dim3 grid(
      static_cast<unsigned int>((static_cast<long long>(N) + kHdThreads - 1) /
                                kHdThreads),
      static_cast<unsigned int>(n_levels));
  hash_descriptors_kernel<<<grid, kHdThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int*>(idx),
      static_cast<long long*>(local), static_cast<float*>(frac),
      static_cast<float*>(W), static_cast<unsigned char*>(inside), N, lv);
  return static_cast<int>(cudaGetLastError());
}

// idx [M] int32 -> keys [M] int32, perm [M] int32: the keys (an id in [0,
// n_bricks), else n_bricks) in ascending order, equal keys in the order of
// their positions, and perm[i] the position of keys[i]. scratch: int32
// [sort_ids_scratch(M)]. One cooperative launch, ceil(bits / 8) passes for
// the bits of n_bricks.
extern "C" int sort_ids(const void* idx, void* keys, void* perm,
                        void* scratch, int M, int n_bricks, void* stream) {
  if (M == 0) return 0;
  long long blocks = 0;
  cudaError_t err = sort_grid(M, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = sort_ids_kernel;
  const int* ix = static_cast<const int*>(idx);
  int* k = static_cast<int*>(keys);
  int* p = static_cast<int*>(perm);
  int* tmp_k = static_cast<int*>(scratch);
  int* tmp_v = tmp_k + M;
  int* bc = tmp_v + M;
  int passes = sort_passes(n_bricks);
  void* args[] = {&ix, &k, &p, &tmp_k, &tmp_v, &bc, &M, &n_bricks,
                  &passes};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel),
      dim3(static_cast<unsigned int>(blocks)), dim3(kSortThreads), args,
      kSortStage, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// sort_ids' scratch ints for M ids on the current device, or a negative
// value if the grid cannot be sized.
extern "C" long long sort_ids_scratch(int M) {
  long long blocks = 0;
  if (sort_grid(M, &blocks) != cudaSuccess) return -1;
  return 2LL * M + kDigits * blocks;
}
