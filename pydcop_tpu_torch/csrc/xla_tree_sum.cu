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
//     combines them (a kernel of its own, below: one handoff an
//     instance);
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
// streams.  One-row sums move a few MB at most, near the cost of one
// launch; their design's target is one launch a site, no slower than
// torch.sum.  `evaluate` is bound by its dependent gathers and the
// sectors they move (its section below).
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

// --- evaluate: a kernel of its own ---------------------------------------
//
// evaluate's total of each of n_inst instances (one, or the serving
// layer's K tenants of one shape): the unary entry of every variable under
// the assignment and each bucket's table entry of every constraint, each
// segment of values summed in XLA's order, then `unary + (0 + b0 + b1 +
// ...) + constant`.  What bounds it: a bucket's value takes three
// dependent loads (its slots, the assignment's values, the table entry),
// and the card moves whole 32-byte sectors, so a gathered entry of a
// table of 36-byte rows (D = 3, binary) reads every sector of the table:
// config 4 moves ~12 MB (3.6 us at 3.35 TB/s) where the entries alone
// are 4.8 MB (1.43 us).  Its design:
//   - The grid is (blocks of an instance, instances).  A block is one
//     window of level 2 of one segment (32 level-1 windows, 1,024 inputs
//     with the levels' offsets), or a whole segment of up to 1,024 values
//     (its sum is then the segment's total).  The block finds its segment
//     by counting the segments' first blocks at or before it: 16 compares
//     of 32-bit kernel parameters, no search and no divide.
//   - Gathers issued together: a thread gathers 4 values (input l of each
//     of its warp's 4 level-1 windows, so a warp's loads are coalesced),
//     each step's 4 loads in flight at once: the slots (arity 2: one
//     16-byte load, arity 4: two), then the assignment's values (400 KB
//     at config 4: they stay in L2), then the table entries.  The value
//     type (int32 or int64) is a template parameter, the arity 1..4
//     compiled unrolled (another arity a runtime loop).  Issuing the
//     table's sectors ahead of the values (an L2 prefetch, or the rows
//     copied into shared memory by cp.async) made the launch slower on
//     the card: it moves the same sectors with more instructions.
//   - Every warp reduces: a warp stores its 4 windows into rows of the
//     block's shared tile, and lane q of the warp sums its window q across
//     the row in index order (32 loads, then 32 adds, unrolled); thread 0
//     then adds the 32 window sums in order (unrolled).
//   - One handoff an instance: each block writes its partial and takes
//     one ticket of its instance (no ticket a row) with one atomic that
//     releases the partial and acquires the others' (take_ticket).  The block
//     that draws the instance's last ticket finishes every segment, a
//     warp a segment in parallel: at most 1,024 partials (config 4: 98 and
//     196) take one level of windows, lane w loading window w's 32 values
//     unrolled, all in flight together, then the final reduce of the
//     lanes' sums in order (32 shuffles and adds, unrolled); more than
//     1,024 partials (config 6's 1,954) take levels of windows in a loop
//     first, through the segment's room in the scratch.  One thread then
//     combines the segments' totals as the JAX package does (the constant
//     loaded before its ticket) and resets the ticket to 0 for the next
//     launch or graph replay.
//   - 32-bit arithmetic for every index inside an instance; the table and
//     slot rows' offsets widen once.

constexpr int kEvalSegs = kMaxBuckets + 1;
constexpr int kPerLane = kW / kWarps;  // level-1 windows a warp stages
constexpr int kUnrolledTail = kW * kW;  // partials the tail's one level takes

// A segment of values: the unary entries (arity 0) or a bucket's.
struct EvalSeg {
  int n;  // values
  int lo1;  // level 1's front padding (0 up to 32 values: one window)
  int k2;  // blocks: level-2 windows, 1 up to 1,024 values
  int lo2;  // level 2's front padding (0 up to 1,024 values)
  int block_begin;  // its first block in an instance's row of blocks
  int part;  // its first partial in an instance's scratch
  int room;  // its next level's room (over 1,024 partials only)
  int arity;  // 0: the unary entries
  int row;  // floats between two rows: D**arity (unary: its row stride)
  int vec;  // arity 2 or 4 with 16-byte aligned slot rows
  const float* table;  // instance 0's [n, row] table (or unary)
  const long long* slots;  // instance 0's [n, arity] var_slots
  long long table_inst, slots_inst;  // elements between two instances
};

struct EvalArgs {
  int n_segs;  // 1 + buckets
  int d;
  int row_blocks;  // blocks of an instance
  int part_stride;  // scratch floats of an instance
  long long n_vars;  // the assignment's values between two instances
  const void* values;  // [n_inst, n_vars] int32 or int64
  const float* constant;  // [n_inst]
  float* out;  // [n_inst]
  float* scratch;  // [n_inst, part_stride]
  unsigned* tickets;  // [n_inst]
  EvalSeg segs[kEvalSegs];
};

// The unary entries of variables c[q] (0.0 outside [0, n)).
template <typename V>
__device__ __forceinline__ void gather_unary(const EvalSeg& g,
                                             const V* values,
                                             const float* unary,
                                             const int (&c)[kPerLane],
                                             float (&x)[kPerLane]) {
  bool live[kPerLane];
  V v[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    live[q] = c[q] >= 0 && c[q] < g.n;
    v[q] = live[q] ? __ldg(values + c[q]) : V(0);
  }
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    x[q] = live[q] ? __ldg(unary + static_cast<long long>(c[q]) * g.row +
                           static_cast<int>(v[q]))
                   : 0.0f;
  }
}

// The table entries of constraints c[q] (0.0 outside [0, n)): arity kA,
// or any (kA = 0) in a runtime loop.
template <int kA, typename V>
__device__ __forceinline__ void gather_bucket(const EvalSeg& g, int d,
                                              const V* values,
                                              const float* table,
                                              const long long* slots,
                                              const int (&c)[kPerLane],
                                              float (&x)[kPerLane]) {
  bool live[kPerLane];
  const float* rows[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    live[q] = c[q] >= 0 && c[q] < g.n;
    rows[q] = table + static_cast<long long>(live[q] ? c[q] : 0) * g.row;
  }
  if constexpr (kA == 0) {
    const int a = g.arity;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      x[q] = 0.0f;
      if (!live[q]) continue;
      const long long* vs = slots + static_cast<long long>(c[q]) * a;
      int flat = 0;
      for (int t = 0; t < a; ++t) {
        flat = flat * d + static_cast<int>(__ldg(values + __ldg(vs + t)));
      }
      x[q] = __ldg(rows[q] + flat);
    }
  } else {
    long long s[kPerLane][kA];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const long long* vs =
          slots + static_cast<long long>(live[q] ? c[q] : 0) * kA;
      if constexpr (kA % 2 == 0) {
        if (g.vec) {
#pragma unroll
          for (int t = 0; t < kA; t += 2) {
            const longlong2 p =
                live[q] ? __ldg(reinterpret_cast<const longlong2*>(vs + t))
                        : make_longlong2(0, 0);
            s[q][t] = p.x;
            s[q][t + 1] = p.y;
          }
          continue;
        }
      }
#pragma unroll
      for (int t = 0; t < kA; ++t) s[q][t] = live[q] ? __ldg(vs + t) : 0;
    }
    int v[kPerLane][kA];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
#pragma unroll
      for (int t = 0; t < kA; ++t) {
        v[q][t] = live[q] ? static_cast<int>(__ldg(values + s[q][t])) : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      int flat = v[q][0];
#pragma unroll
      for (int t = 1; t < kA; ++t) flat = flat * d + v[q][t];
      x[q] = live[q] ? __ldg(rows[q] + flat) : 0.0f;
    }
  }
}

// The sum of window values c0 .. c0 + 31 of src (0.0 outside [0, m)) in
// index order from +0.0, its 32 loads in flight together.
__device__ __forceinline__ float window_sum(const float* src, int m, int c0) {
  float v[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const int c = c0 + i;
    v[i] = c >= 0 && c < m ? __ldcg(src + c) : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kW; ++i) acc = __fadd_rn(acc, v[i]);
  return acc;
}

// The final reduce: the 32 lanes' values in lane order from +0.0, in every
// lane (a lane past the values holds +0.0, which adds nothing to a sum
// from +0.0).
__device__ __forceinline__ float lanes_in_order(float v) {
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    total = __fadd_rn(total, __shfl_sync(kFull, v, i));
  }
  return total;
}

// A segment's total from its m level-2 partials at part (m = 1: the
// partial is the total), in every lane of the warp.
__device__ float upper_levels(float* part, int m, float* room, int lane) {
  if (m == 1) return __ldcg(part);
  float* src = part;
  float* dst = room;
  while (m > kUnrolledTail) {  // levels of windows, lane w takes w, w + 32..
    const int k = static_cast<int>(cdiv(m, kW));
    const int lo = (k * kW - m) / 2;
    for (int w = lane; w < k; w += kW) dst[w] = window_sum(src, m, w * kW - lo);
    __threadfence();
    __syncwarp();
    float* t = src;
    src = dst;
    dst = t;
    m = k;
  }
  float v;
  if (m > kW) {  // one level, lane w window w, then the final reduce
    const int k = static_cast<int>(cdiv(m, kW));
    v = lane < k ? window_sum(src, m, lane * kW - (k * kW - m) / 2) : 0.0f;
  } else {
    v = lane < m ? __ldcg(src + lane) : 0.0f;
  }
  return lanes_in_order(v);
}

// A ticket of an instance: one atomic add, acquire and release at the
// card's scope.  It releases this block's partial, written before it,
// and each earlier block's add heads a release sequence that the later
// adds on the counter continue, so the block that draws the last ticket
// acquires every partial; its threads read them after a __syncthreads.
// (On an H100, a __threadfence before the add and another after it took
// 0.4 us more a launch at config 4.)
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned drawn;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(drawn)
               : "l"(ticket)
               : "memory");
  return drawn;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    evaluate_kernel(const __grid_constant__ EvalArgs a) {
  __shared__ float tile[kW * kPitch];  // level-1 window jj in row jj
  __shared__ float sums[kW];  // their sums
  __shared__ float totals[kEvalSegs];
  __shared__ int last;
  const int x = blockIdx.x;
  const int inst = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int s = 0;
#pragma unroll
  for (int t = 1; t < kEvalSegs; ++t) {
    s += t < a.n_segs && a.segs[t].block_begin <= x;
  }
  const EvalSeg& g = a.segs[s];
  const int w2 = x - g.block_begin;
  // this warp's level-1 windows jj = 4 * warp + q: lane l takes input l
  const int jj0 = warp * kPerLane;
  int c[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    c[q] = (w2 * kW - g.lo2 + jj0 + q) * kW - g.lo1 + lane;
  }
  const V* values = static_cast<const V*>(a.values) + inst * a.n_vars;
  const float* table = g.table + inst * g.table_inst;
  const long long* slots = g.slots + inst * g.slots_inst;
  float v[kPerLane];
  switch (g.arity) {
    case 0: gather_unary<V>(g, values, table, c, v); break;
    case 1: gather_bucket<1, V>(g, a.d, values, table, slots, c, v); break;
    case 2: gather_bucket<2, V>(g, a.d, values, table, slots, c, v); break;
    case 3: gather_bucket<3, V>(g, a.d, values, table, slots, c, v); break;
    case 4: gather_bucket<4, V>(g, a.d, values, table, slots, c, v); break;
    default: gather_bucket<0, V>(g, a.d, values, table, slots, c, v); break;
  }
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) tile[(jj0 + q) * kPitch + lane] = v[q];
  __syncwarp();
  if (lane < kPerLane) {  // lane q: window jj0 + q in index order
    const float* row = tile + (jj0 + lane) * kPitch;
    float r[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) r[i] = row[i];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kW; ++i) acc = __fadd_rn(acc, r[i]);
    sums[jj0 + lane] = acc;
  }
  __syncthreads();
  float* part = a.scratch + static_cast<long long>(inst) * a.part_stride;
  float constant = 0.0f;
  if (threadIdx.x == 0) {
    constant = __ldg(a.constant + inst);  // in flight through the handoff
    float r[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) r[i] = sums[i];
    float p = 0.0f;
#pragma unroll
    for (int i = 0; i < kW; ++i) p = __fadd_rn(p, r[i]);
    // a one-value segment's total is the value itself (input 0 is lane 0
    // of window 0: -0.0 stays -0.0)
    if (g.n == 1) p = tile[0];
    part[g.part + w2] = p;
    last = take_ticket(a.tickets + inst) ==
           static_cast<unsigned>(a.row_blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  for (int t = warp; t < a.n_segs; t += kWarps) {
    const EvalSeg& h = a.segs[t];
    const float total = upper_levels(part + h.part, h.k2, part + h.room, lane);
    if (lane == 0) totals[t] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float cons = 0.0f;
    for (int b = 1; b < a.n_segs; ++b) cons = __fadd_rn(cons, totals[b]);
    a.out[inst] = __fadd_rn(__fadd_rn(totals[0], cons), constant);
    a.tickets[inst] = 0u;  // every block of the instance has drawn
  }
}

// Lays out segment g of n values from block *blocks and partial *parts
// on; false if n is too large for 32-bit indices.
bool eval_segment(EvalSeg& g, long long n, int* blocks, long long* parts) {
  if (n < 0 || n > 0x7fffffffLL - 2 * kW * kW) return false;
  const long long k1 = cdiv(n, kW);
  const long long k2 = cdiv(k1, kW);
  g.n = static_cast<int>(n);
  g.lo1 = n <= kW ? 0 : static_cast<int>((k1 * kW - n) / 2);
  g.lo2 = k1 <= kW ? 0 : static_cast<int>((k2 * kW - k1) / 2);
  g.k2 = k2 > 1 ? static_cast<int>(k2) : 1;  // n = 0: one block, +0.0
  g.block_begin = *blocks;
  g.part = static_cast<int>(*parts);
  *parts += g.k2;
  g.room = static_cast<int>(*parts);
  if (g.k2 > kUnrolledTail) *parts += cdiv(g.k2, kW);
  *blocks += g.k2;
  return *blocks > 0 && *parts < 0x7fffffffLL;
}

int evaluate(const void* values, int values_i64, int d, const void* unary,
             long long unary_stride, long long unary_inst, long long n_vars,
             long long n_inst, int n_buckets, const long long* buckets,
             const void* constant, void* out, void* scratch,
             long long scratch_cap, void* tickets, long long ticket_cap,
             void* stream) {
  if (n_buckets < 0 || n_buckets > kMaxBuckets || n_inst < 1 ||
      n_inst > 65535 || d < 1 || unary_stride < d ||
      unary_stride > 0x7fffffff) {
    return -1;
  }
  EvalArgs a{};
  a.n_segs = 1 + n_buckets;
  a.d = d;
  a.n_vars = n_vars;
  a.values = values;
  a.constant = static_cast<const float*>(constant);
  a.out = static_cast<float*>(out);
  a.scratch = static_cast<float*>(scratch);
  a.tickets = static_cast<unsigned*>(tickets);
  int blocks = 0;
  long long parts = 0;
  EvalSeg& u = a.segs[0];
  if (!eval_segment(u, n_vars, &blocks, &parts)) return -1;
  u.row = static_cast<int>(unary_stride);
  u.table = static_cast<const float*>(unary);
  u.table_inst = unary_inst;
  for (int b = 0; b < n_buckets; ++b) {
    EvalSeg& g = a.segs[b + 1];
    const long long n_c = buckets[4 * b + 2];
    const long long arity = buckets[4 * b + 3];
    long long len = 1;
    for (long long t = 0; t < arity && len <= 0x7fffffff; ++t) len *= d;
    if (arity < 1 || len > 0x7fffffff ||
        !eval_segment(g, n_c, &blocks, &parts)) {
      return -1;
    }
    g.arity = static_cast<int>(arity);
    g.row = static_cast<int>(len);
    g.table = reinterpret_cast<const float*>(buckets[4 * b]);
    g.slots = reinterpret_cast<const long long*>(buckets[4 * b + 1]);
    g.table_inst = n_c * len;
    g.slots_inst = n_c * arity;
    g.vec = arity % 2 == 0 && arity <= 4 &&
            reinterpret_cast<uintptr_t>(g.slots) % 16 == 0;
  }
  a.row_blocks = blocks;
  a.part_stride = static_cast<int>(parts);
  if (parts * n_inst > scratch_cap || n_inst > ticket_cap) return -1;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(n_inst));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (values_i64) {
    evaluate_kernel<long long><<<grid, kThreads, 0, st>>>(a);
  } else {
    evaluate_kernel<int><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
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

// *out = evaluate's total: the unary entries unary[v, values[v]] (rows
// unary_stride apart), and per bucket b (buckets[4b .. 4b+3]: its [n_c,
// D**a] tables, its [n_c, a] int64 var_slots, n_c, a) the entries
// tables[c, flat(values[var_slots[c]])].  values: int32, or int64 when
// values_i64.  Scratch: a partial a block (a segment's level-2 windows,
// at least one) and, for a segment of over 1,024 level-2 windows, room
// for its next level; tickets: one.
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
// Scratch: n_inst times a solo launch's; tickets: n_inst.
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
