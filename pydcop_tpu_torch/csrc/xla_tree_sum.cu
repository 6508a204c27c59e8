// Float32 sums in XLA-CPU's tree order, one launch a sum site, for NVIDIA
// Hopper (sm_90a).
//
// Not a port of a TPU kernel: the port's own kernel for the float sums
// whose order decides a result (pydcop_tpu_torch/compile/kernels.py): the
// anytime-best total of `evaluate`, MaxSum's ELL fan-in and its sum over
// the domain.  The JAX package sums them with `jnp.sum` under `jit`, and
// XLA's CPU compiler (its TreeReductionRewriter) rewrites every float sum
// over more than 32 elements into a reduce-window of size 32 and stride
// 32, repeated until at most 32 partial sums are left, then a plain
// sequential reduce.  Each window pads its input with +0.0 symmetrically
// (lo = pad / 2 in front, the rest behind) and is summed sequentially from
// an initial +0.0; a one-element sum is the element itself (XLA folds the
// reduce away, so -0.0 stays -0.0).  The totals are sums of costs of up
// to 1e9 (forbidden tuples), where float32 rounding depends on the order,
// and the solvers keep the cycle whose total is strictly lowest, so only
// this exact order gives the JAX package's assignments.  The plain
// PyTorch versions (compile/hopper_kernels.py: xla_tree_sum_plain and the
// compositions built on it) are the definition of that order.
//
// Three sites, each one launch for a whole sum site, and each for a batch
// of instances of one shape too (the serving layer's K tenants: the
// *_batched_launch entries, one launch for the whole batch, every
// instance's sums in the same order as alone):
//   - xla_tree_sum_rows_launch: the sum over the last axis of a strided
//     stack of rows (xla_sum; domain_sum reads its [D, n] plane in place
//     through the element stride; a batch's K x n rows are one stack, the
//     instance axis the outer stride);
//   - xla_tree_sum_evaluate_launch: evaluate's total, the unary entry and
//     each bucket's table entry gathered by level 1 from the assignment,
//     then `unary + (0 + b0 + b1 + ...) + constant` as the JAX package
//     combines them;
//   - xla_tree_sum_ell_fan_in_launch: every degree class of MaxSum's ELL
//     fan-in, `tot = sum(seg) + u` into the [D, V] plane and
//     `v2f_raw = tot - seg` into the [D, n_pad] plane.
//
// How one launch keeps the order.  A row of n values is split by its
// size.  n <= 32: one window (or the value itself), summed by one thread;
// a block takes 256 such rows, so classes of different widths share the
// launch (the fan-in's and the domain sum's short rows have designs of
// their own, below).  32 < n <= 1024: one warp sums the row's level-1
// windows and then, in order, their sums (the final reduce).  n > 1024:
// level L's window w covers level L-1's windows w*32 - lo_L .. +31, which
// cover one contiguous range of inputs, so one block owns one window of
// level 2 (1,024 inputs with the levels' offsets) and writes one partial
// with no grid-wide sync.  Its warps load the range coalesced, four
// level-1 windows a warp, into a padded shared tile (a thread's loads are
// in flight together: they go to registers first); lane jj of warp 0 then
// sums window jj across the tile in index order, and the lanes' sums are
// added in order.  The block that writes a row's last partial finishes
// the row: each block fences its partial (__threadfence) before it takes
// a ticket from the row's counter (atomicAdd); the one that draws the
// last ticket sums the remaining levels from the partials and resets the
// counter to 0, so the next launch, or the next replay of a captured CUDA
// graph, finds it at zero.  The counters are a pool the wrapper zeroes
// once.  Every add is a float32 __fadd_rn (no multiply in a sum, no FMA
// contraction, no fast-math, no flush to zero), so the result is the
// plain version's bit for bit.  Padding adds of +0.0 change nothing (a
// sum from +0.0 never is -0.0), and windows wholly in the padding are
// skipped.  A block finds its segment by a binary search of the
// segments' first blocks, and reserves only the shared memory its site's
// segments use (dynamic, sized on the host: none for a site of short
// rows).
//
// The ELL fan-in's short classes (1 <= db <= 32 slots: 89.6% of config
// 4's 500,598 slots) are warp tiles.  A warp task is 32 * g consecutive
// rows (d, j0 ..) of one class, g groups of 32 so that a lane moves at
// least 16 values (g = 16 for db = 0 or 1, ceil(16 / db) up to 16 slots,
// 1 above).  Config 4's launch is then 521 blocks (315 of short classes),
// against 760 at 8 values a lane; at the float32 kernel's 80 registers
// an SM holds 3 blocks of 256 threads, 396 on an H100, so both take a
// second, partial wave, and 16 values a lane ran 8% faster in turns.  Its
// (class, d, j0) come from the segment table built on the host, one
// 32-bit divide a warp, and the rows' db * 32g values are one contiguous
// range of the plane.  The lanes load the range coalesced (lane l values
// l, l + 32, ...; a bf16 plane widened), all of a lane's loads and its
// rows' unary entries in flight together, and store them into the warp's
// tile, row r at r * pitch with an odd pitch (db | 1) so that the lanes'
// row reads are free of bank conflicts.  Lane l then sums row l (and l +
// 32, ...) from the tile in index order from +0.0, rounds it as the
// plane's type does, adds u, stores tot (coalesced across the lanes), and
// writes t - x back over its row; after a __syncwarp the warp stores the
// range of v2f_raw coalesced.  The plane is read once.  A 1-slot row is
// its value (no tile), a 0-slot row copies u.  The tail task of a class
// is masked.  Classes over 32 slots keep the warp-a-row and
// block-a-level-2-window paths above and come first in the launch,
// longest first, so the rows with tickets start with it.  The class sizes
// 2, 4, 8, 16 and 32 (ELL's power-of-two classes) are compiled unrolled;
// any other size takes a runtime body.
//
// The domain sum's rows (n <= 32 values s_elem apart, the rows
// themselves contiguous: MaxSum's [D, n_pad] plane summed over D in
// place, a serving batch's [K, D, n_pad]) take a kernel of their own,
// with no shared memory: a thread sums 4 consecutive rows, loading each
// of the n plane rows once at the widest width its alignment allows (16,
// 8 or 4 bytes: config 4's n_pad of 500,598 leaves every other plane row
// 8- but not 16-byte aligned; a scalar tail where the row count is not a
// multiple of 4), in XLA's order ((0 + x0) + x1) + ..., a single value
// being itself; n = 1..16 compiled unrolled, 17..32 at run time; a
// grid-stride loop over a grid sized to the card, the instance on the
// grid's y axis (no divide).
//
// What bounds each site on the card.  The fan-in and the domain sum
// stream their planes (config 4: 14.4 MB and 8.0 MB, 4.30 and 2.39 us
// at the H100's 3.35 TB/s): bytes, and the launch.  The fan-in's classes
// over 32 slots end on a dependent chain (a window's 32 adds, a ticket,
// the tail), which starting them first hides behind the short classes'
// streams.  `evaluate` and one-row sums gather or move a few MB at most,
// near the cost of one launch; their design's target is one launch a
// site, no slower than torch.sum.
//
// Plain C interface (loaded with ctypes): each launch function returns
// the first CUDA error of the launch (cudaGetLastError() after it), 0 on
// success, or -1 when a buffer the caller sized is too small or a table
// too long.  The caller owns every buffer and the stream; the scratch is
// the wrapper's torch.empty, the tickets a zeroed int32 pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 32;  // XLA-CPU's window
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPitch = kW + 1;  // a tile row, padded: no bank conflicts
constexpr int kTile = kW * kPitch;  // floats of one warp's window tile
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 8;  // loads a thread keeps in flight at once
constexpr int kMaxBuckets = 16;
constexpr int kMaxClasses = 40;
constexpr int kBlocksPerSm = 8;  // the short-row kernel's grid
constexpr int kTileValues = 16;  // the least values a lane of a tile task

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Rows of n values of one size class share a segment.  block_begin is
// its first block task; scratch and ticket its first float of scratch and
// its first counter (rows over 1,024 values only).  A site whose short
// rows are warp tiles (the fan-in) counts warp tasks in `rows` of a
// segment of n <= 32.
struct Seg {
  int64_t n, rows, block_begin, scratch, ticket;
};

// Block tasks, scratch floats and tickets of `rows` rows of n values: a
// block per 256 rows of up to 32 values (per 8 warp tasks where `tiled`),
// per 8 rows up to 1,024, per level-2 window above, each of those rows
// with its k2 level-2 partials and room for its next level.
inline int64_t seg_blocks(int64_t n, int64_t rows, bool tiled) {
  if (n <= kW) return cdiv(rows, tiled ? kWarps : kThreads);
  if (n <= kW * kW) return cdiv(rows, kWarps);
  return rows * cdiv(cdiv(n, kW), kW);
}
__host__ __device__ inline int64_t row_scratch(int64_t n) {
  if (n <= kW * kW) return 0;
  const int64_t k2 = cdiv(cdiv(n, kW), kW);
  return k2 + cdiv(k2, kW);
}
// Shared floats a block of a segment uses: a window tile a warp up to
// 1,024 values, one tile for a level-2 window, none for short rows (a
// warp tile's are the site's own).
inline int64_t seg_smem(int64_t n) {
  if (n <= kW) return 0;
  return n <= kW * kW ? kWarps * kTile : kTile;
}

// Lays out segs[0..count) (n and rows set) one after another; returns the
// block tasks, adds the scratch floats and tickets to *scratch and
// *tickets, and raises *smem to the shared floats a block needs.
int64_t layout(Seg* segs, int count, bool tiled, int64_t* scratch,
               int64_t* tickets, int64_t* smem) {
  int64_t blocks = 0;
  for (int s = 0; s < count; ++s) {
    segs[s].block_begin = blocks;
    segs[s].scratch = *scratch;
    segs[s].ticket = *tickets;
    blocks += seg_blocks(segs[s].n, segs[s].rows, tiled);
    *scratch += segs[s].rows * row_scratch(segs[s].n);
    if (segs[s].n > kW * kW) *tickets += segs[s].rows;
    if (segs[s].rows > 0 && seg_smem(segs[s].n) > *smem) {
      *smem = seg_smem(segs[s].n);
    }
  }
  return blocks;
}

__device__ __forceinline__ float widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// A total as the plane's type rounds it: float32 as it is, bf16 rounded
// once to nearest even (XLA sums a bf16 array in float32 and rounds the
// result).
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A row of up to 32 values: one window from +0.0, or the value itself.
// The loads are issued kBatch at a time, then added in order.
template <class Row>
__device__ float sum_small(const Row& row, int64_t n) {
  if (n == 1) return row.load(0);
  float acc = 0.0f;
  for (int64_t k0 = 0; k0 < n; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      v[q] = k0 + q < n ? row.load(k0 + q) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (k0 + q < n) acc = __fadd_rn(acc, v[q]);
    }
  }
  return acc;
}

// Stages level-1 windows jj0 .. jj0 + kCount - 1 of the level-2 window
// whose first level-1 window is j0 into rows of `tile`: level-1 window
// j = j0 + jj holds inputs j*32 - lo1 .. +31, lane l loading input l of
// each, +0.0 outside [0, n) (a window wholly outside is padding of level
// 2).  The loads go to registers first, so they are in flight together,
// then to the tile.
template <int kCount, class Row>
__device__ void stage(const Row& row, int64_t n, int64_t lo1, int64_t j0,
                      int jj0, float* tile, int lane) {
  float v[kCount];
#pragma unroll
  for (int q = 0; q < kCount; ++q) {
    const int64_t c = (j0 + jj0 + q) * kW - lo1 + lane;
    v[q] = c >= 0 && c < n ? row.load(c) : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < kCount; ++q) tile[(jj0 + q) * kPitch + lane] = v[q];
}

// The sum of the staged level-1 windows jlo .. jhi - 1, in every lane of
// the warp: lane jj sums window jj across its tile row in index order,
// then the lanes' sums are added in order.
__device__ float reduce_tile(const float* tile, int jlo, int jhi, int lane) {
  float acc = 0.0f;
  if (lane >= jlo && lane < jhi) {
#pragma unroll
    for (int i = 0; i < kW; ++i) acc = __fadd_rn(acc, tile[lane * kPitch + i]);
  }
  float total = 0.0f;
  for (int jj = jlo; jj < jhi; ++jj) {
    total = __fadd_rn(total, __shfl_sync(kFull, acc, jj));
  }
  return total;
}

// The levels left of a row, from its m level-2 partials at part[0..m)
// (part[m..) is room for the next level), in every lane: while more than
// 32 are left a level of windows of 32 (the lanes take the windows), then
// the final reduce.  Levels alternate between the two regions; each is
// fenced before the next reads it, and read from L2 (other blocks wrote
// the first).
__device__ float tail(float* part, int64_t m, int lane) {
  float* src = part;
  float* dst = part + m;
  while (m > kW) {
    const int64_t k = cdiv(m, kW);
    const int64_t lo = (k * kW - m) / 2;
    for (int64_t w = lane; w < k; w += kW) {
      float acc = 0.0f;
      for (int i0 = 0; i0 < kW; i0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int64_t c = w * kW - lo + i0 + q;
          v[q] = c >= 0 && c < m ? __ldcg(src + c) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) acc = __fadd_rn(acc, v[q]);
      }
      dst[w] = acc;
    }
    __threadfence();
    __syncwarp();
    float* t = src;
    src = dst;
    dst = t;
    m = k;
  }
  float v = lane < m ? __ldcg(src + lane) : 0.0f;
  float total = 0.0f;
  for (int i = 0; i < m; ++i) {
    total = __fadd_rn(total, __shfl_sync(kFull, v, i));
  }
  return total;
}

// One block task of segment s of a site: 256 rows of up to 32 values (a
// thread each; a site with kTiled runs 8 warp tasks instead, run_tile), 8
// rows of up to 1,024 (a warp each), or one level-2 window of a longer
// row (the block stages its 32 level-1 windows, 4 a warp, and warp 0 sums
// them; the warp that draws the row's last ticket then sums the rest of
// the row).  site.visit(s, r, f) calls f with row r's loader;
// site.finish(s, r, row, total, lane) consumes its total, called by one
// thread (lane 0) for a short row and by a whole warp (the total in every
// lane) otherwise.
template <class Site>
__device__ void run_task(const Site& site, int s, int64_t t, float* smem,
                         int warp, int lane) {
  const Seg& g = site.segs[s];
  const int64_t n = g.n;
  if (n <= kW) {
    if constexpr (Site::kTiled) {
      site.run_tile(s, t * kWarps + warp, smem + warp * site.warp_floats,
                    lane);
    } else {
      const int64_t r = t * kThreads + warp * kW + lane;
      if (r >= g.rows) return;
      site.visit(s, r, [&](const auto& row) {
        site.finish(s, r, row, sum_small(row, n), 0);
      });
    }
    return;
  }
  const int64_t k1 = cdiv(n, kW);
  const int64_t lo1 = (k1 * kW - n) / 2;
  if (n <= kW * kW) {
    const int64_t r = t * kWarps + warp;
    if (r >= g.rows) return;
    float* tile = smem + warp * kTile;
    site.visit(s, r, [&](const auto& row) {
      for (int jj0 = 0; jj0 < k1; jj0 += kBatch) {
        stage<kBatch>(row, n, lo1, 0, jj0, tile, lane);
      }
      __syncwarp();
      const float total = reduce_tile(tile, 0, static_cast<int>(k1), lane);
      site.finish(s, r, row, total, lane);
    });
    return;
  }
  const int64_t k2 = cdiv(k1, kW);
  const int64_t lo2 = (k2 * kW - k1) / 2;
  const int64_t r = t / k2;
  const int64_t w2 = t - r * k2;
  const int64_t j0 = w2 * kW - lo2;
  site.visit(s, r, [&](const auto& row) {
    stage<kW / kWarps>(row, n, lo1, j0, warp * (kW / kWarps), smem, lane);
    __syncthreads();
    if (warp != 0) return;
    const int jlo = j0 < 0 ? static_cast<int>(-j0) : 0;
    const int jhi = k1 - j0 < kW ? static_cast<int>(k1 - j0) : kW;
    const float p = reduce_tile(smem, jlo, jhi, lane);
    float* part = site.scratch + g.scratch + r * row_scratch(n);
    unsigned* ticket = site.tickets + g.ticket + r;
    int last = 0;
    if (lane == 0) {
      part[w2] = p;
      __threadfence();
      last = atomicAdd(ticket, 1u) == static_cast<unsigned>(k2 - 1);
    }
    if (!__shfl_sync(kFull, last, 0)) return;
    __threadfence();
    const float total = tail(part, k2, lane);
    if (lane == 0) *ticket = 0u;  // every block of the row has drawn
    site.finish(s, r, row, total, lane);
  });
}

template <class Site>
__global__ void __launch_bounds__(kThreads)
    tree_sum_kernel(const __grid_constant__ Site site) {
  extern __shared__ float smem[];
  // the segment of this block: the last whose first block is not after it
  const int64_t b = blockIdx.x;
  int lo = 0, hi = site.n_segs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (site.segs[mid].block_begin <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  run_task(site, lo, b - site.segs[lo].block_begin, smem, threadIdx.x >> 5,
           threadIdx.x & 31);
}

template <class Site>
int launch(const Site& site, void* stream) {
  if (site.blocks == 0) return 0;
  if (site.blocks > 0x7fffffff) return -1;
  tree_sum_kernel<Site>
      <<<static_cast<unsigned int>(site.blocks), kThreads,
         static_cast<size_t>(site.smem) * sizeof(float),
         static_cast<cudaStream_t>(stream)>>>(site);
  return static_cast<int>(cudaGetLastError());
}

// --- rows: a strided stack of rows ---------------------------------------

struct StridedRow {
  const float* p;
  int64_t stride;
  __device__ float load(int64_t i) const { return widen(p + i * stride); }
};

struct RowsSite {
  static constexpr bool kTiled = false;
  int n_segs;
  int64_t blocks, smem;
  Seg segs[1];
  float* scratch;
  unsigned* tickets;
  const float* x;
  int64_t inner, s_outer, s_inner, s_elem;
  float* out;
  template <class F>
  __device__ void visit(int, int64_t r, F&& f) const {
    const int64_t o = r / inner;
    f(StridedRow{x + o * s_outer + (r - o * inner) * s_inner, s_elem});
  }
  __device__ void finish(int, int64_t r, const StridedRow&, float total,
                         int lane) const {
    if (lane == 0) out[r] = total;
  }
};

// --- evaluate: the unary total and each bucket's, gathered, combined -----
//
// A batch of n_inst assignments of one shape (the serving layer's K
// tenants) is one launch: each segment has a row an instance, every
// operand a leading instance axis, and each instance's totals combine on
// their own, by the thread that finishes the instance's last segment.

struct EvalSite;

// The unary entry of variable i of instance `inst`.
struct UnaryRow {
  const EvalSite* site;
  int64_t inst;
  __device__ float load(int64_t i) const;
};

// Constraint i's table entry under instance `inst`'s assignment: its
// slots' values as a flat C-order index; arity kA, or any (kA = 0: the
// bucket's own).
template <int kA>
struct BucketRow {
  const EvalSite* site;
  int b;
  int64_t inst;
  __device__ float load(int64_t i) const;
};

struct EvalSite {
  static constexpr bool kTiled = false;
  int n_segs;  // 1 + buckets
  int64_t blocks, smem;
  Seg segs[kMaxBuckets + 1];
  float* scratch;  // the instances' totals, then the large rows' partials
  unsigned* tickets;  // the large rows', then one an instance
  const void* values;  // [n_inst, n_vars]
  int values_i64;
  int64_t n_vars;
  int d;
  const float* unary;
  int64_t unary_stride;  // between two variables' rows
  int64_t unary_inst;  // between two instances
  const float* tables[kMaxBuckets];  // [n_inst, n_c, D**a]
  const long long* var_slots[kMaxBuckets];  // [n_inst, n_c, a]
  int64_t table_len[kMaxBuckets];
  int64_t n_c[kMaxBuckets];
  int arity[kMaxBuckets];
  const float* constant;  // [n_inst]
  float* out;  // [n_inst]
  float* totals;  // [n_inst, n_segs]
  unsigned* site_tickets;  // [n_inst]

  __device__ int64_t value(int64_t inst, int64_t v) const {
    const int64_t k = inst * n_vars + v;
    return values_i64 ? __ldg(static_cast<const long long*>(values) + k)
                      : __ldg(static_cast<const int*>(values) + k);
  }
  // binary buckets (the common case) get a loader with its slot loop
  // unrolled, so a thread's gathers are in flight together
  template <class F>
  __device__ void visit(int s, int64_t r, F&& f) const {
    if (s == 0) {
      f(UnaryRow{this, r});
    } else if (arity[s - 1] == 2) {
      f(BucketRow<2>{this, s - 1, r});
    } else {
      f(BucketRow<0>{this, s - 1, r});
    }
  }
  // the segment's total; the thread that finishes an instance's last one
  // combines them as the JAX package does,
  // `unary + (0 + b0 + b1 + ...) + constant`
  template <class Row>
  __device__ void finish(int s, int64_t r, const Row&, float total,
                         int lane) const {
    if (lane != 0) return;
    float* mine = totals + r * n_segs;
    mine[s] = total;
    __threadfence();
    if (atomicAdd(site_tickets + r, 1u) !=
        static_cast<unsigned>(n_segs - 1)) {
      return;
    }
    __threadfence();
    float cons = 0.0f;
    for (int b = 1; b < n_segs; ++b) cons = __fadd_rn(cons, __ldcg(mine + b));
    out[r] = __fadd_rn(__fadd_rn(__ldcg(mine), cons), __ldg(constant + r));
    site_tickets[r] = 0u;
  }
};

__device__ float UnaryRow::load(int64_t i) const {
  return __ldg(site->unary + inst * site->unary_inst + i * site->unary_stride +
               site->value(inst, i));
}

template <int kA>
__device__ float BucketRow<kA>::load(int64_t i) const {
  const int a = kA ? kA : site->arity[b];
  const int64_t row = inst * site->n_c[b] + i;
  const long long* vs = site->var_slots[b] + row * a;
  int64_t flat = 0;
#pragma unroll
  for (int t = 0; t < (kA ? kA : a); ++t) {
    flat = flat * site->d + site->value(inst, __ldg(vs + t));
  }
  return __ldg(site->tables[b] + row * site->table_len[b] + flat);
}

// --- the ELL fan-in: every degree class -----------------------------------

template <typename T>
struct PlaneRow {
  const T* p;
  __device__ float load(int64_t i) const { return widen(p + i); }
};

// Groups of 32 rows a warp task of a class of db <= 32 slots takes, so
// that each lane moves at least kTileValues values: 16 for 0 or 1 slot,
// ceil(16 / db) up to 16 slots, 1 above.
__host__ __device__ constexpr int tile_groups(int db) {
  return db <= 1 ? kTileValues
                 : (db >= kTileValues ? 1 : (kTileValues + db - 1) / db);
}
// The most groups a class outside the unrolled sizes (db = 3..31) takes.
constexpr int kRuntimeGroups = tile_groups(3);

// One warp task of a short class: `rows` consecutive rows (at most 32 *
// groups) of a plane row, their values from src (the range of the plane),
// the unary entries from u; tot and v2f_raw to tot and dst.
template <typename T>
struct TileTask {
  const T* src;
  float* dst;
  const float* u;
  float* tot;
  int rows;
  int lane;

  // a 0-slot class: tot is u (sign and all)
  __device__ void copy_u() const {
    float uv[kTileValues];
#pragma unroll
    for (int q = 0; q < kTileValues; ++q) {
      const int r = lane + q * kW;
      uv[q] = r < rows ? __ldg(u + r) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kTileValues; ++q) {
      const int r = lane + q * kW;
      if (r < rows) tot[r] = uv[q];
    }
  }

  // a 1-slot class: a row's sum is its value (a bf16 value rounds to
  // itself), so no tile: lane l takes rows l, l + 32, ...
  __device__ void single() const {
    float x[kTileValues], uv[kTileValues];
#pragma unroll
    for (int q = 0; q < kTileValues; ++q) {
      const int r = lane + q * kW;
      x[q] = r < rows ? widen(src + r) : 0.0f;
      uv[q] = r < rows ? __ldg(u + r) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kTileValues; ++q) {
      const int r = lane + q * kW;
      if (r < rows) {
        const float t = __fadd_rn(x[q], uv[q]);
        tot[r] = t;
        dst[r] = __fsub_rn(t, x[q]);
      }
    }
  }

  // rows of kDb slots (kDb = 0: db_rt, 3..31, at run time) through the
  // warp's tile: value e = lane + 32 k of the range is slot e % db of row
  // e / db, at row * pitch + slot
  template <int kDb>
  __device__ void staged(int db_rt, float* tile) const {
    constexpr int kG = kDb ? tile_groups(kDb) : kRuntimeGroups;
    const int db = kDb ? kDb : db_rt;
    const int groups = kDb ? kG : tile_groups(db);
    const int count = groups * db;  // values a lane
    const int n = rows * db;
    const int pitch = db | 1;
    const int dr = kW / db, di = kW - dr * db;
    float uv[kG];
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      const int r = lane + q * kW;
      uv[q] = q < groups && r < rows ? __ldg(u + r) : 0.0f;
    }
    int r = lane / db, i = lane - r * db;
#pragma unroll
    for (int k0 = 0; k0 < (kDb ? kG * kDb : count); k0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = lane + (k0 + q) * kW;
        v[q] = k0 + q < count && e < n ? widen(src + e) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (k0 + q < count) {
          tile[r * pitch + i] = v[q];
          r += dr;
          i += di;
          if (i >= db) {
            i -= db;
            ++r;
          }
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      const int row = lane + q * kW;
      if (q < groups && row < rows) {
        float* x = tile + row * pitch;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < (kDb ? kDb : db); ++k) acc = __fadd_rn(acc, x[k]);
        const float t = __fadd_rn(round_as(acc, src), uv[q]);
        tot[row] = t;
#pragma unroll
        for (int k = 0; k < (kDb ? kDb : db); ++k) x[k] = __fsub_rn(t, x[k]);
      }
    }
    __syncwarp();
    r = lane / db;
    i = lane - r * db;
#pragma unroll
    for (int k = 0; k < (kDb ? kG * kDb : count); ++k) {
      const int e = lane + k * kW;
      if (e < n) dst[e] = tile[r * pitch + i];
      r += dr;
      i += di;
      if (i >= db) {
        i -= db;
        ++r;
      }
    }
  }
};

// A degree class in its segment: nb rows of db slots from plane offset
// off_e and variable off_v; a short class (db <= 32) runs as warp tasks of
// `group` rows, per_d of them a plane row.
struct FanSeg {
  int64_t nb, off_e, off_v, per_d;
  int db, group;
};

template <typename T>
struct FanSite {
  static constexpr bool kTiled = true;
  int n_segs;  // classes; rows of class c: D * nb, row (d, j)
  int64_t blocks, smem;
  int64_t warp_floats;  // a short class's warp tile
  Seg segs[kMaxClasses];
  FanSeg cls[kMaxClasses];
  float* scratch;
  unsigned* tickets;
  const T* plane;  // [D, n_pad]
  int64_t n_pad;
  const float* u;  // [D, n_vars] in ell order
  int64_t n_vars;
  float* tot;  // [D, n_vars]
  float* v2f;  // [D, n_pad]

  // warp task `task` of short class s: rows (d, j0 ..) of the task table
  __device__ void run_tile(int s, int64_t task, float* tile, int lane) const {
    if (task >= segs[s].rows) return;
    const FanSeg& c = cls[s];
    // the host keeps a segment's tasks under 2^31: one 32-bit divide
    const unsigned per_d = static_cast<unsigned>(c.per_d);
    const unsigned d = static_cast<unsigned>(task) / per_d;
    const int64_t j0 =
        static_cast<int64_t>(static_cast<unsigned>(task) - d * per_d) *
        c.group;
    const int64_t left = c.nb - j0;
    const int64_t e0 = d * n_pad + c.off_e + j0 * c.db;
    const int64_t v0 = d * n_vars + c.off_v + j0;
    const TileTask<T> w{plane + e0, v2f + e0, u + v0, tot + v0,
                        static_cast<int>(left < c.group ? left : c.group),
                        lane};
    switch (c.db) {
      case 0: w.copy_u(); break;
      case 1: w.single(); break;
      case 2: w.template staged<2>(2, tile); break;
      case 4: w.template staged<4>(4, tile); break;
      case 8: w.template staged<8>(8, tile); break;
      case 16: w.template staged<16>(16, tile); break;
      case 32: w.template staged<32>(32, tile); break;
      default: w.template staged<0>(c.db, tile); break;
    }
  }

  // a row of a class over 32 slots, a warp (or a level-2 window's block)
  template <class F>
  __device__ void visit(int s, int64_t r, F&& f) const {
    const int64_t d = r / cls[s].nb;
    f(PlaneRow<T>{plane + d * n_pad + cls[s].off_e +
                  (r - d * cls[s].nb) * cls[s].db});
  }
  // tot = sum + u; v2f_raw = tot - seg, the whole warp
  __device__ void finish(int s, int64_t r, const PlaneRow<T>& row,
                         float total, int lane) const {
    const FanSeg& c = cls[s];
    const int64_t d = r / c.nb;
    const int64_t j = r - d * c.nb;
    const int64_t v = d * n_vars + c.off_v + j;
    const float t = __fadd_rn(round_as(total, plane), __ldg(u + v));
    if (lane == 0) tot[v] = t;
    // kBatch loads in flight a lane, then their stores
    float* o = v2f + d * n_pad + c.off_e + j * c.db;
    for (int64_t i0 = lane; i0 < c.db; i0 += kBatch * kW) {
      float x[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int64_t i = i0 + q * kW;
        x[q] = i < c.db ? row.load(i) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int64_t i = i0 + q * kW;
        if (i < c.db) o[i] = __fsub_rn(t, x[q]);
      }
    }
  }
};

template <typename T>
int fan_in(const void* plane, int d, long long n_pad, const void* u,
           long long n_vars, int n_classes, const long long* spans,
           void* tot, void* v2f, void* scratch, long long scratch_cap,
           void* tickets, long long ticket_cap, void* stream) {
  if (n_classes < 1 || n_classes > kMaxClasses) return -1;
  FanSite<T> site{};
  site.n_segs = n_classes;
  // classes over 32 slots first, longest first (their rows end on a
  // dependent chain), then the short classes in plane order
  int order[kMaxClasses];
  int placed = 0;
  for (int c = 0; c < n_classes; ++c) {
    if (spans[2 * c + 1] <= kW) continue;
    int at = placed++;
    while (at > 0 && spans[2 * order[at - 1] + 1] < spans[2 * c + 1]) {
      order[at] = order[at - 1];
      --at;
    }
    order[at] = c;
  }
  for (int c = 0; c < n_classes; ++c) {
    if (spans[2 * c + 1] <= kW) order[placed++] = c;
  }
  int64_t off_e[kMaxClasses], off_v[kMaxClasses];
  int64_t e = 0, v = 0;
  for (int c = 0; c < n_classes; ++c) {
    off_e[c] = e;
    off_v[c] = v;
    e += spans[2 * c] * spans[2 * c + 1];
    v += spans[2 * c];
  }
  if (e != n_pad || v != n_vars) return -1;
  int64_t tile_floats = 0;
  for (int s = 0; s < n_classes; ++s) {
    const int c = order[s];
    const int64_t nb = spans[2 * c], db = spans[2 * c + 1];
    if (nb < 0 || db < 0 || db > 0x7fffffff) return -1;
    FanSeg& k = site.cls[s];
    k.nb = nb;
    k.db = static_cast<int>(db);
    k.off_e = off_e[c];
    k.off_v = off_v[c];
    site.segs[s].n = db;
    if (db > kW) {
      site.segs[s].rows = d * nb;
      continue;
    }
    k.group = kW * tile_groups(k.db);
    k.per_d = cdiv(nb, k.group);
    site.segs[s].rows = d * k.per_d;  // warp tasks
    if (site.segs[s].rows > 0x7fffffff) return -1;
    if (db > 1 && k.group * (db | 1) > tile_floats) {
      tile_floats = k.group * (db | 1);
    }
  }
  int64_t need = 0, n_tickets = 0, smem = 0;
  site.blocks = layout(site.segs, n_classes, true, &need, &n_tickets, &smem);
  if (need > scratch_cap || n_tickets > ticket_cap) return -1;
  site.warp_floats = tile_floats;
  site.smem = smem > kWarps * tile_floats ? smem : kWarps * tile_floats;
  site.scratch = static_cast<float*>(scratch);
  site.tickets = static_cast<unsigned*>(tickets);
  site.plane = static_cast<const T*>(plane);
  site.n_pad = n_pad;
  site.u = static_cast<const float*>(u);
  site.n_vars = n_vars;
  site.tot = static_cast<float*>(tot);
  site.v2f = static_cast<float*>(v2f);
  return launch(site, stream);
}

// --- the domain sum: short rows, the rows contiguous ----------------------

constexpr int kQuad = 4;  // consecutive rows a thread sums

// 4 consecutive floats at p, at the widest width p's alignment allows
__device__ __forceinline__ float4 load4(const float* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) return __ldg(reinterpret_cast<const float4*>(p));
  if ((a & 7) == 0) {
    const float2 lo = __ldg(reinterpret_cast<const float2*>(p));
    const float2 hi = __ldg(reinterpret_cast<const float2*>(p + 2));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) {
    *reinterpret_cast<float4*>(p) = v;
  } else if ((a & 7) == 0) {
    reinterpret_cast<float2*>(p)[0] = make_float2(v.x, v.y);
    reinterpret_cast<float2*>(p)[1] = make_float2(v.z, v.w);
  } else {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// The sums of Vec-wide columns (a float4 of 4 rows, or one float) of n
// values s_elem apart from p, in XLA's order: ((0 + x0) + x1) + ..., a
// single value itself.  kN = n compiled unrolled, all n loads in flight;
// kN = 0: n at run time, kBatch loads at once.
template <int kN, class Vec, class Load, class Add>
__device__ __forceinline__ Vec sum_column(const float* p, int64_t s_elem,
                                          int n_rt, Vec zero, Load load,
                                          Add add) {
  const int n = kN ? kN : n_rt;
  if (n == 1) return load(p);
  Vec acc = zero;
  if constexpr (kN > 0) {
    Vec v[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = load(p + k * s_elem);
#pragma unroll
    for (int k = 0; k < kN; ++k) acc = add(acc, v[k]);
  } else {
    for (int k0 = 0; k0 < n; k0 += kBatch) {
      Vec v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        v[q] = k0 + q < n ? load(p + (k0 + q) * s_elem) : zero;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (k0 + q < n) acc = add(acc, v[q]);
      }
    }
  }
  return acc;
}

// out[o * inner + i] = the sum over k < n of x[o * s_outer + k * s_elem +
// i]: a thread 4 consecutive i of one o (the grid's y), a scalar tail.
template <int kN>
__global__ void __launch_bounds__(kThreads)
    short_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int n_rt, int64_t inner, int64_t outer,
                      int64_t s_outer, int64_t s_elem) {
  const int64_t quads = cdiv(inner, kQuad);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const auto load1 = [](const float* p) { return __ldg(p); };
  const auto add1 = [](float a, float b) { return __fadd_rn(a, b); };
  const auto load = [](const float* p) { return load4(p); };
  const auto add = [](float4 a, float4 b) { return add4(a, b); };
  for (int64_t o = blockIdx.y; o < outer; o += gridDim.y) {
    const float* xo = x + o * s_outer;
    float* oo = out + o * inner;
    for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
         q < quads; q += stride) {
      const int64_t i0 = q * kQuad;
      if (i0 + kQuad <= inner) {
        store4(oo + i0, sum_column<kN>(xo + i0, s_elem, n_rt,
                                       make_float4(0.f, 0.f, 0.f, 0.f),
                                       load, add));
      } else {
        for (int64_t i = i0; i < inner; ++i) {
          oo[i] = sum_column<kN>(xo + i, s_elem, n_rt, 0.0f, load1, add1);
        }
      }
    }
  }
}

template <int kN>
void launch_short(dim3 grid, cudaStream_t st, const float* x, float* out,
                  int n, int64_t inner, int64_t outer, int64_t s_outer,
                  int64_t s_elem) {
  short_rows_kernel<kN>
      <<<grid, kThreads, 0, st>>>(x, out, n, inner, outer, s_outer, s_elem);
}

// n = 1..16 unrolled, 17..32 at run time
template <int kN = 16>
void launch_short_n(dim3 grid, cudaStream_t st, const float* x, float* out,
                    int n, int64_t inner, int64_t outer, int64_t s_outer,
                    int64_t s_elem) {
  if constexpr (kN == 0) {
    launch_short<0>(grid, st, x, out, n, inner, outer, s_outer, s_elem);
  } else if (n == kN) {
    launch_short<kN>(grid, st, x, out, n, inner, outer, s_outer, s_elem);
  } else {
    launch_short_n<kN - 1>(grid, st, x, out, n, inner, outer, s_outer,
                           s_elem);
  }
}

int short_rows(const float* x, float* out, int n, int64_t inner,
               int64_t outer, int64_t s_outer, int64_t s_elem,
               void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ys = outer < 65535 ? outer : 65535;
  const int64_t full = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int64_t per_o = full / ys > 1 ? full / ys : 1;
  const int64_t need = cdiv(cdiv(inner, kQuad), kThreads);
  const dim3 grid(static_cast<unsigned>(need < per_o ? need : per_o),
                  static_cast<unsigned>(ys));
  launch_short_n(grid, static_cast<cudaStream_t>(stream), x, out, n, inner,
                 outer, s_outer, s_elem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[r] = the sum of row r: rows r = (o, i), o < rows / inner, at x +
// o * s_outer + i * s_inner, each of n values s_elem apart.  Scratch:
// rows * row_scratch(n) floats; tickets: rows (n > 1,024 only).  Rows of
// 1..32 values whose starts are contiguous (s_inner = 1: a [D, n] plane
// summed over D in place) take the short-row kernel.
extern "C" int xla_tree_sum_rows_launch(
    const void* x, void* out, long long n, long long rows, long long inner,
    long long s_outer, long long s_inner, long long s_elem, void* scratch,
    long long scratch_cap, void* tickets, long long ticket_cap,
    void* stream) {
  if (inner < 1) return -1;
  if (n >= 1 && n <= kW && s_inner == 1 && rows % inner == 0) {
    if (rows == 0) return 0;
    return short_rows(static_cast<const float*>(x), static_cast<float*>(out),
                      static_cast<int>(n), inner, rows / inner, s_outer,
                      s_elem, stream);
  }
  RowsSite site{};
  site.n_segs = 1;
  site.segs[0].n = n;
  site.segs[0].rows = rows;
  int64_t need = 0, n_tickets = 0, smem = 0;
  site.blocks = layout(site.segs, 1, false, &need, &n_tickets, &smem);
  if (need > scratch_cap || n_tickets > ticket_cap) return -1;
  site.smem = smem;
  site.scratch = static_cast<float*>(scratch);
  site.tickets = static_cast<unsigned*>(tickets);
  site.x = static_cast<const float*>(x);
  site.inner = inner;
  site.s_outer = s_outer;
  site.s_inner = s_inner;
  site.s_elem = s_elem;
  site.out = static_cast<float*>(out);
  return launch(site, stream);
}

namespace {

int evaluate(const void* values, int values_i64, int d, const void* unary,
             long long unary_stride, long long unary_inst, long long n_vars,
             long long n_inst, int n_buckets, const long long* buckets,
             const void* constant, void* out, void* scratch,
             long long scratch_cap, void* tickets, long long ticket_cap,
             void* stream) {
  if (n_buckets < 0 || n_buckets > kMaxBuckets || n_inst < 1) return -1;
  EvalSite site{};
  site.n_segs = 1 + n_buckets;
  site.segs[0].n = n_vars;
  site.segs[0].rows = n_inst;
  for (int b = 0; b < n_buckets; ++b) {
    site.tables[b] = reinterpret_cast<const float*>(buckets[4 * b]);
    site.var_slots[b] =
        reinterpret_cast<const long long*>(buckets[4 * b + 1]);
    site.n_c[b] = buckets[4 * b + 2];
    site.segs[b + 1].n = buckets[4 * b + 2];
    site.segs[b + 1].rows = n_inst;
    site.arity[b] = static_cast<int>(buckets[4 * b + 3]);
    int64_t len = 1;
    for (int t = 0; t < site.arity[b]; ++t) len *= d;
    site.table_len[b] = len;
  }
  int64_t need = n_inst * site.n_segs, n_tickets = 0, smem = 0;
  site.blocks =
      layout(site.segs, site.n_segs, false, &need, &n_tickets, &smem);
  if (need > scratch_cap || n_tickets + n_inst > ticket_cap) return -1;
  site.smem = smem;
  site.scratch = static_cast<float*>(scratch);
  site.totals = site.scratch;
  site.tickets = static_cast<unsigned*>(tickets);
  site.site_tickets = site.tickets + n_tickets;
  site.values = values;
  site.values_i64 = values_i64;
  site.n_vars = n_vars;
  site.d = d;
  site.unary = static_cast<const float*>(unary);
  site.unary_stride = unary_stride;
  site.unary_inst = unary_inst;
  site.constant = static_cast<const float*>(constant);
  site.out = static_cast<float*>(out);
  return launch(site, stream);
}

}  // namespace

// *out = evaluate's total: the unary entries unary[v, values[v]] (rows
// unary_stride apart), and per bucket b (buckets[4b .. 4b+3]: its [n_c,
// D**a] tables, its [n_c, a] int64 var_slots, n_c, a) the entries
// tables[c, flat(values[var_slots[c]])].  values: int32, or int64 when
// values_i64.  Scratch: 1 + n_buckets totals, then the large rows';
// tickets: the large rows', then one.
extern "C" int xla_tree_sum_evaluate_launch(
    const void* values, int values_i64, int d, const void* unary,
    long long unary_stride, long long n_vars, int n_buckets,
    const long long* buckets, const void* constant, void* out,
    void* scratch, long long scratch_cap, void* tickets,
    long long ticket_cap, void* stream) {
  return evaluate(values, values_i64, d, unary, unary_stride, 0, n_vars, 1,
                  n_buckets, buckets, constant, out, scratch, scratch_cap,
                  tickets, ticket_cap, stream);
}

// evaluate's totals of n_inst instances of one shape, one launch: values
// [n_inst, n_vars]; unary rows unary_stride apart, instances unary_inst
// apart; each bucket's tables [n_inst, n_c, D**a] and var_slots [n_inst,
// n_c, a] (instance-local variable ids); constant and out [n_inst].
// Scratch: n_inst * (1 + n_buckets) totals, then the large rows'; tickets:
// the large rows', then n_inst.
extern "C" int xla_tree_sum_evaluate_batched_launch(
    const void* values, int values_i64, int d, const void* unary,
    long long unary_stride, long long unary_inst, long long n_vars,
    long long n_inst, int n_buckets, const long long* buckets,
    const void* constant, void* out, void* scratch, long long scratch_cap,
    void* tickets, long long ticket_cap, void* stream) {
  return evaluate(values, values_i64, d, unary, unary_stride, unary_inst,
                  n_vars, n_inst, n_buckets, buckets, constant, out, scratch,
                  scratch_cap, tickets, ticket_cap, stream);
}

// MaxSum's ELL fan-in over every degree class (spans[2c], spans[2c+1] =
// nb, db of class c, in plane order): tot[d, v] = sum(seg) + u[d, v] (a
// bf16 plane's sum rounded to bf16 first; a class of degree 0 copies u)
// and v2f[d, e] = tot - plane[d, e], both float32.  Scratch and tickets:
// those of the classes' rows over 1,024 values.
extern "C" int xla_tree_sum_ell_fan_in_launch(
    const void* plane, int d, long long n_pad, const void* u,
    long long n_vars, int n_classes, const long long* spans, void* tot,
    void* v2f, void* scratch, long long scratch_cap, void* tickets,
    long long ticket_cap, void* stream) {
  return fan_in<float>(plane, d, n_pad, u, n_vars, n_classes, spans, tot,
                       v2f, scratch, scratch_cap, tickets, ticket_cap, stream);
}

// n_inst instances of one span table, one launch: plane [n_inst, D,
// n_pad], u and tot [n_inst, D, n_vars], v2f [n_inst, D, n_pad].  A row
// of class c is (instance, d, j) at plane row instance * D + d, so the
// instances fold into the D axis: the site of D' = n_inst * D rows.
extern "C" int xla_tree_sum_ell_fan_in_batched_launch(
    const void* plane, int d, long long n_pad, const void* u,
    long long n_vars, long long n_inst, int n_classes,
    const long long* spans, void* tot, void* v2f, void* scratch,
    long long scratch_cap, void* tickets, long long ticket_cap,
    void* stream) {
  if (n_inst < 1 || n_inst * d > 0x7fffffff) return -1;
  return fan_in<float>(plane, static_cast<int>(n_inst * d), n_pad, u, n_vars,
                       n_classes, spans, tot, v2f, scratch, scratch_cap,
                       tickets, ticket_cap, stream);
}

extern "C" int xla_tree_sum_ell_fan_in_bf16_batched_launch(
    const void* plane, int d, long long n_pad, const void* u,
    long long n_vars, long long n_inst, int n_classes,
    const long long* spans, void* tot, void* v2f, void* scratch,
    long long scratch_cap, void* tickets, long long ticket_cap,
    void* stream) {
  if (n_inst < 1 || n_inst * d > 0x7fffffff) return -1;
  return fan_in<__nv_bfloat16>(plane, static_cast<int>(n_inst * d), n_pad, u,
                               n_vars, n_classes, spans, tot, v2f, scratch,
                               scratch_cap, tickets, ticket_cap, stream);
}

extern "C" int xla_tree_sum_ell_fan_in_bf16_launch(
    const void* plane, int d, long long n_pad, const void* u,
    long long n_vars, int n_classes, const long long* spans, void* tot,
    void* v2f, void* scratch, long long scratch_cap, void* tickets,
    long long ticket_cap, void* stream) {
  return fan_in<__nv_bfloat16>(plane, d, n_pad, u, n_vars, n_classes, spans,
                               tot, v2f, scratch, scratch_cap, tickets,
                               ticket_cap, stream);
}
