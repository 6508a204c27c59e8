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
// launch.  32 < n <= 1024: one warp sums the row's level-1 windows and
// then, in order, their sums (the final reduce).  n > 1024: level L's
// window w covers level L-1's windows w*32 - lo_L .. +31, which cover one
// contiguous range of inputs, so one block owns one window of level 2
// (1,024 inputs with the levels' offsets) and writes one partial with no
// grid-wide sync.  Its warps load the range coalesced, four level-1
// windows a warp, into a padded shared tile (a thread's loads are in
// flight together: they go to registers first); lane jj of warp 0 then
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
// skipped.
//
// What bounds it on the card: the launch.  At config 4's sizes a site
// moves a few MB at most (evaluate's 300,000 gathered costs, 0.24 us of
// HBM time for the 199,996-value bucket alone), under the cost of one
// launch, so half the byte bound is out of reach by construction; the
// design's target is one launch a site, no slower than torch.sum.
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
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 8;  // loads a thread keeps in flight at once
constexpr int kMaxBuckets = 16;
constexpr int kMaxClasses = 40;

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Rows of n values of one size class share a segment.  block_begin is
// its first block task; scratch and ticket its first float of scratch and
// its first counter (rows over 1,024 values only).
struct Seg {
  int64_t n, rows, block_begin, scratch, ticket;
};

// Block tasks, scratch floats and tickets of `rows` rows of n values: a
// block per 256 rows of up to 32 values, per 8 rows up to 1,024, per
// level-2 window above, each of those rows with its k2 level-2 partials
// and room for its next level.
inline int64_t seg_blocks(int64_t n, int64_t rows) {
  if (n <= kW) return cdiv(rows, kThreads);
  if (n <= kW * kW) return cdiv(rows, kWarps);
  return rows * cdiv(cdiv(n, kW), kW);
}
__host__ __device__ inline int64_t row_scratch(int64_t n) {
  if (n <= kW * kW) return 0;
  const int64_t k2 = cdiv(cdiv(n, kW), kW);
  return k2 + cdiv(k2, kW);
}

// Lays out segs[0..count) (n and rows set) one after another; returns the
// block tasks, and adds the scratch floats and tickets to *scratch and
// *tickets.
int64_t layout(Seg* segs, int count, int64_t* scratch, int64_t* tickets) {
  int64_t blocks = 0;
  for (int s = 0; s < count; ++s) {
    segs[s].block_begin = blocks;
    segs[s].scratch = *scratch;
    segs[s].ticket = *tickets;
    blocks += seg_blocks(segs[s].n, segs[s].rows);
    *scratch += segs[s].rows * row_scratch(segs[s].n);
    if (segs[s].n > kW * kW) *tickets += segs[s].rows;
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
// thread each), 8 rows of up to 1,024 (a warp each), or one level-2
// window of a longer row (the block stages its 32 level-1 windows, 4 a
// warp, and warp 0 sums them; the warp that draws the row's last ticket
// then sums the rest of the row).  site.visit(s, r, f) calls f with row
// r's loader; site.finish(s, r, row, total, lane, lanes) consumes its
// total, called by one thread (lane 0 of 1) for a small row and by a whole
// warp (the total in every lane) otherwise.
template <class Site>
__device__ void run_task(const Site& site, int s, int64_t t,
                         float (*tiles)[kW * kPitch], int warp, int lane) {
  const Seg& g = site.segs[s];
  const int64_t n = g.n;
  if (n <= kW) {
    const int64_t r = t * kThreads + warp * kW + lane;
    if (r >= g.rows) return;
    site.visit(s, r, [&](const auto& row) {
      site.finish(s, r, row, sum_small(row, n), 0, 1);
    });
    return;
  }
  const int64_t k1 = cdiv(n, kW);
  const int64_t lo1 = (k1 * kW - n) / 2;
  if (n <= kW * kW) {
    const int64_t r = t * kWarps + warp;
    if (r >= g.rows) return;
    site.visit(s, r, [&](const auto& row) {
      for (int jj0 = 0; jj0 < k1; jj0 += kBatch) {
        stage<kBatch>(row, n, lo1, 0, jj0, tiles[warp], lane);
      }
      __syncwarp();
      const float total = reduce_tile(tiles[warp], 0, static_cast<int>(k1),
                                      lane);
      site.finish(s, r, row, total, lane, kW);
    });
    return;
  }
  const int64_t k2 = cdiv(k1, kW);
  const int64_t lo2 = (k2 * kW - k1) / 2;
  const int64_t r = t / k2;
  const int64_t w2 = t - r * k2;
  const int64_t j0 = w2 * kW - lo2;
  site.visit(s, r, [&](const auto& row) {
    stage<kW / kWarps>(row, n, lo1, j0, warp * (kW / kWarps), tiles[0],
                       lane);
    __syncthreads();
    if (warp != 0) return;
    const int jlo = j0 < 0 ? static_cast<int>(-j0) : 0;
    const int jhi = k1 - j0 < kW ? static_cast<int>(k1 - j0) : kW;
    const float p = reduce_tile(tiles[0], jlo, jhi, lane);
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
    site.finish(s, r, row, total, lane, kW);
  });
}

template <class Site>
__global__ void __launch_bounds__(kThreads)
    tree_sum_kernel(const __grid_constant__ Site site) {
  __shared__ float tiles[kWarps][kW * kPitch];
  const int64_t b = blockIdx.x;
  int s = 0;
  while (s + 1 < site.n_segs && b >= site.segs[s + 1].block_begin) ++s;
  run_task(site, s, b - site.segs[s].block_begin, tiles, threadIdx.x >> 5,
           threadIdx.x & 31);
}

template <class Site>
int launch(const Site& site, void* stream) {
  if (site.blocks == 0) return 0;
  if (site.blocks > 0x7fffffff) return -1;
  tree_sum_kernel<Site>
      <<<static_cast<unsigned int>(site.blocks), kThreads, 0,
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
  int n_segs;
  int64_t blocks;
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
                         int lane, int) const {
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
  int n_segs;  // 1 + buckets
  int64_t blocks;
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
  __device__ void finish(int s, int64_t r, const Row&, float total, int lane,
                         int) const {
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

template <typename T>
struct FanSite {
  int n_segs;  // classes; rows of class c: D * nb, row (d, j)
  int64_t blocks;
  Seg segs[kMaxClasses];
  float* scratch;
  unsigned* tickets;
  int64_t nb[kMaxClasses], db[kMaxClasses], off_e[kMaxClasses],
      off_v[kMaxClasses];
  const T* plane;  // [D, n_pad]
  int64_t n_pad;
  const float* u;  // [D, n_vars] in ell order
  int64_t n_vars;
  float* tot;  // [D, n_vars]
  float* v2f;  // [D, n_pad]

  template <class F>
  __device__ void visit(int s, int64_t r, F&& f) const {
    const int64_t d = r / nb[s];
    f(PlaneRow<T>{plane + d * n_pad + off_e[s] + (r - d * nb[s]) * db[s]});
  }
  // tot = sum + u (a class of degree 0 copies u); v2f_raw = tot - seg
  __device__ void finish(int s, int64_t r, const PlaneRow<T>& row,
                         float total, int lane, int lanes) const {
    const int64_t d = r / nb[s];
    const int64_t j = r - d * nb[s];
    const int64_t v = d * n_vars + off_v[s] + j;
    const float uv = __ldg(u + v);
    const float t =
        db[s] == 0 ? uv : __fadd_rn(round_as(total, plane), uv);
    if (lane == 0) tot[v] = t;
    // kBatch loads in flight a lane, then their stores
    float* o = v2f + d * n_pad + off_e[s] + j * db[s];
    for (int64_t i0 = lane; i0 < db[s]; i0 += kBatch * lanes) {
      float x[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int64_t i = i0 + q * lanes;
        x[q] = i < db[s] ? row.load(i) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int64_t i = i0 + q * lanes;
        if (i < db[s]) o[i] = __fsub_rn(t, x[q]);
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
  int64_t off_e = 0, off_v = 0;
  for (int c = 0; c < n_classes; ++c) {
    site.nb[c] = spans[2 * c];
    site.db[c] = spans[2 * c + 1];
    site.off_e[c] = off_e;
    site.off_v[c] = off_v;
    site.segs[c].n = site.db[c];
    site.segs[c].rows = d * site.nb[c];
    off_e += site.nb[c] * site.db[c];
    off_v += site.nb[c];
  }
  if (off_e != n_pad || off_v != n_vars) return -1;
  int64_t need = 0, n_tickets = 0;
  site.blocks = layout(site.segs, n_classes, &need, &n_tickets);
  if (need > scratch_cap || n_tickets > ticket_cap) return -1;
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

}  // namespace

// out[r] = the sum of row r: rows r = (o, i), o < rows / inner, at x +
// o * s_outer + i * s_inner, each of n values s_elem apart.  Scratch:
// rows * row_scratch(n) floats; tickets: rows (n > 1,024 only).
extern "C" int xla_tree_sum_rows_launch(
    const void* x, void* out, long long n, long long rows, long long inner,
    long long s_outer, long long s_inner, long long s_elem, void* scratch,
    long long scratch_cap, void* tickets, long long ticket_cap,
    void* stream) {
  RowsSite site{};
  site.n_segs = 1;
  site.segs[0].n = n;
  site.segs[0].rows = rows;
  int64_t need = 0, n_tickets = 0;
  site.blocks = layout(site.segs, 1, &need, &n_tickets);
  if (need > scratch_cap || n_tickets > ticket_cap || inner < 1) return -1;
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
  int64_t need = n_inst * site.n_segs, n_tickets = 0;
  site.blocks = layout(site.segs, site.n_segs, &need, &n_tickets);
  if (need > scratch_cap || n_tickets + n_inst > ticket_cap) return -1;
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
