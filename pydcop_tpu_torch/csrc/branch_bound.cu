// Depth-first branch and bound: the whole search of SyncBB or NCBB as one
// launch, for NVIDIA Hopper (sm_90a).
//
// The port's own kernel; it replaces no TPU kernel: the JAX package runs
// this search as one jitted lax.while_loop that advances 256 masked steps
// an iteration (_bb_loop in pydcop_tpu/algorithms/_branch_bound.py:95).
// Each step is a chain of dependent scalar operations; as PyTorch ops on
// the card every one would be a kernel, and a search takes up to millions
// of steps.  So the loop is the kernel.
//
// Variables are taken in a fixed order (position p = the p-th variable).
// A step at `depth` tries the next value v of that variable:
//
//   exhausted = v >= dsize[depth]                       -> backtrack
//   cost_new  = cost_prefix[depth]
//             + (unary[depth, v] + S_v)                  S_v: see below
//   feasible  = !exhausted && cost_new + lb_suffix[depth + 1] < ub
//
// with S_v the sum over the K attachment slots of the position, in slot
// order, of (att_mask[depth, k] ? att_table[depth, k, assign[att_other
// [depth, k]], v] : 0): the binary constraints oriented towards the later
// variable, read at the earlier variable's current value.  The value
// pointer moves on (or back to 0 when exhausted), a feasible value is
// assigned and its prefix cost kept, a feasible value at the last position
// is a new incumbent (ub, best), and the depth goes down on exhaustion and
// up on a feasible value short of the last position.  The loop ends when
// the depth falls below 0 (the search is complete) or after max_iters
// steps; the step count, the incumbent and the completion flag are JAX's,
// since JAX's masked dead steps count nothing and this loop stops where
// its `cond` does.
//
// The float arithmetic is the JAX package's, bit for bit: S_v is summed in
// the order XLA's CPU compiler gives the jitted loop's reduce over the K
// slots: for K <= 32 in slot order from +0.0 (K = 1: the one term, as XLA
// folds a one-element reduce away), above 32 in windows of 32 with
// symmetric zero padding, each in order from +0.0, then the window sums in
// order from +0.0 (xla_tree_levels in compile/hopper_kernels.py; K is at
// most 1024 here).  Every add is __fadd_rn, so nothing is contracted or
// reassociated; the bound test stays a strict <.
//
// A row a visit.  Attachments point to earlier positions (att_other[p, k]
// < p wherever att_mask[p, k]), and nothing at a position before p changes
// while the search is at depth >= p.  So when the search descends into p
// (and once for p = 0 at the start) the kernel computes p's whole
// candidate row, for every v < dsize[p]:
//
//   cost_new[p, v] = cost_prefix[p] + (unary[p, v] + S_v)
//   test[p, v]     = cost_new[p, v] + lb_suffix[p + 1]
//
// and every step at p, the siblings and the returns from deeper positions
// alike, reads test[p, v] < ub against the live ub (and cost_new on a
// new incumbent).  The row is kept until the next descent into p.  In a
// complete search a visit of p takes dsize[p] + 1 steps for one row.  The
// value pointer of a position needs no array: a descent enters at value
// 0, a return to p resumes at assign[p] + 1.  Operands that break the
// orientation are refused: the output is then the seed (best0, ub0's
// bits) with a step count of -1, and the host caller raises on it.
//
// What bounds it: latency.  Every step depends on the one before: the
// depth and value it leaves select the entry the next step reads.  Any
// design that takes JAX's step sequence pays at least one dependent
// shared-memory load a step (the candidate's entry), ~30 SM cycles on
// Hopper: steps x 30 cycles is the floor chip_smoke.py reports (a child's
// row could be computed ahead, speculatively, so descents add nothing to
// that floor).  The first design (one thread, the candidate's K terms
// summed at every step) paid at least three dependent loads a step
// (attachment -> assignment -> table entry); that figure stays beside the
// new floor in chip_smoke.py.  The design:
//
// - one thread block; every thread stages the read-only operands into
//   shared memory (the unary rows, domain sizes, attachment slots with the
//   mask folded in as -1, tail bounds; the attachment tables too when all
//   of them fit, else they are read from device memory through the
//   read-only cache), then the block's first warp runs the search and the
//   other warps exit;
// - the 32 lanes run the search's scalar control together: every branch
//   is uniform, every lane holds depth, value, ub and the step count in
//   registers and reads the same shared words (a broadcast), so nothing
//   is handed from lane to lane;
// - a step that stays at its position is one dependent shared-memory load
//   (the (test, cost_new) pair of the row, 8 bytes) and a compare; what a
//   return would need (the earlier position's value and domain size) is
//   read beside it, so a step branches only on feasibility;
// - the lanes need not stay in step between two syncs, so a __syncwarp
//   precedes every write of the shared state (assign, a row): by then
//   every lane has done its reads of the old values;
// - on a descent the lanes share the row's K x D terms: lane i resolves
//   slot i's table row (attachment -> assignment: two dependent loads,
//   all slots at once), then lane v walks column v in XLA's order, each
//   slot's row offset fetched by __shfl_sync, so the table loads of every
//   slot are in flight together and only the adds are serial (a tree of
//   shuffles would change the bits);
// - K = 1..8 are compiled with the slot loop unrolled; any other K takes
//   the same body with a runtime trip count;
// - the result is written once, at the end: best (by position), ub's bits,
//   the step count and the completion flag, so the host reads one vector.
//
// Plain C interface (loaded with ctypes): returns the first CUDA error of
// the launch (cudaGetLastError() after it), or -1 for operands it does not
// take, 0 on success.  The caller owns every buffer and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef BB_THREADS
#define BB_THREADS 256
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kWindow = 32;
constexpr int kMaxSlots = kWindow * kWindow;
constexpr unsigned kFull = 0xffffffffu;

struct Operands {
  const float* unary;      // [n, d] by position
  const int32_t* dsize;    // [n]
  const float* att_table;  // [n, k, d, d]: (position, slot, other, own)
  const int32_t* att_other;  // [n, k] position of the earlier variable
  const uint8_t* att_mask;   // [n, k] bool
  const float* lb_suffix;  // [n + 1]
  const float* ub0;        // scalar
  const int32_t* best0;    // [n]
  int32_t* out;            // [n + 3]: best | ub bits | steps | complete
  int n, k, d, max_iters;
};

// What a row's computation reads and writes in shared memory.
struct Shared {
  float2* row;             // [n, d]: (test, cost_new) of each value
  const float* unary;      // [n, d]
  const float* lb_suffix;  // [n + 1]
  const int32_t* other;    // [n, k]: the earlier position, -1 when masked
  const int32_t* assign;   // [n]
};

template <bool kTablesShared>
__device__ __forceinline__ float table_at(const float* tab, int i) {
  return kTablesShared ? tab[i] : __ldg(tab + i);
}

// Slot s's table row at position p: the offset of (s, assign[other]) in
// p's tables, -1 for a masked slot or a window's padding.  Every load is
// in bounds whatever s, so the loads of all slots issue together.
template <int KT>
__device__ __forceinline__ int slot_base(const Shared& sh, int p, int s,
                                         int k_rt, int d) {
  const int k = KT > 0 ? KT : k_rt;
  const bool in = s >= 0 && s < k;
  const int o = sh.other[p * k + (in ? s : 0)];
  const int a = sh.assign[o < 0 ? 0 : o];
  return (in && o >= 0) ? (s * d + a) * d : -1;
}

// Position p's candidate row, every lane of the warp together: the column
// sums S_v in XLA's order, then (test, cost_new) for every v < dsz.
// `prefix` is cost_prefix[p].  Lane s resolves slot s's table row (a
// window's slot above 32 slots), and each column's terms are fetched by
// __shfl_sync, so the slots' table loads issue together.  The caller has
// synchronized the warp since every lane's last read of p's old row.
// Ends with the row visible to every lane.
template <int KT, bool kTablesShared>
__device__ __forceinline__ void compute_row(
    const Shared& sh, const float* __restrict__ tables, int p, float prefix,
    int dsz, int k_rt, int d, int lane) {
  const int k = KT > 0 ? KT : k_rt;
  const int base = k <= kWindow ? slot_base<KT>(sh, p, lane, k, d) : -1;
  const float* tab = tables + static_cast<int64_t>(p) * k * d * d;
  const float lb = sh.lb_suffix[p + 1];
  for (int c0 = 0; c0 < dsz; c0 += kWarp) {  // uniform: columns by 32
    const int v = c0 + lane;
    const bool live = v < dsz;
    const int col = live ? v : 0;
    // a slot's term of this column: its table entry, 0 when off
    auto term = [&](int b) -> float {
      const float t = table_at<kTablesShared>(tab, (b < 0 ? 0 : b) + col);
      return (b >= 0 && live) ? t : 0.0f;
    };
    float sum;
    if (k == 1) {  // slot 0's one term: its row offset is lane 0's
      sum = term(__shfl_sync(kFull, base, 0));
    } else if (k <= kWindow) {
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < (KT > 0 ? KT : kWindow); ++s) {
        if (KT == 0 && s >= k) break;
        acc = __fadd_rn(acc, term(__shfl_sync(kFull, base, s)));
      }
      sum = acc;
    } else {
      const int windows = (k + kWindow - 1) / kWindow;
      const int lo = (windows * kWindow - k) / 2;
      float top = 0.0f;
      for (int w = 0; w < windows; ++w) {
        const int wb = slot_base<KT>(sh, p, w * kWindow + lane - lo, k, d);
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < kWindow; ++i)
          acc = __fadd_rn(acc, term(__shfl_sync(kFull, wb, i)));
        top = __fadd_rn(top, acc);
      }
      sum = top;
    }
    if (live) {
      const float cost_new =
          __fadd_rn(prefix, __fadd_rn(sh.unary[p * d + v], sum));
      sh.row[p * d + v] = make_float2(__fadd_rn(cost_new, lb), cost_new);
    }
  }
  __syncwarp();
}

template <int KT, bool kTablesShared>
__global__ void __launch_bounds__(BB_THREADS) branch_bound_kernel(
    Operands op) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = op.n, k = op.k, d = op.d;
  const int64_t n_tab = static_cast<int64_t>(n) * k * d * d;
  // the 8-byte row first, then 4-byte words
  float2* row = reinterpret_cast<float2*>(smem);
  float* unary = reinterpret_cast<float*>(row + n * d);
  float* lb_suffix = unary + n * d;
  float* tab_shared = lb_suffix + (n + 1);
  int32_t* dsize = reinterpret_cast<int32_t*>(
      tab_shared + (kTablesShared ? n_tab : 0));
  int32_t* other = dsize + n;
  int32_t* assign = other + n * k;
  int32_t* best = assign + n;

  for (int i = threadIdx.x; i < n * d; i += blockDim.x)
    unary[i] = op.unary[i];
  for (int i = threadIdx.x; i <= n; i += blockDim.x)
    lb_suffix[i] = op.lb_suffix[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dsize[i] = op.dsize[i];
    assign[i] = 0;
    best[i] = op.best0[i];
  }
  int misoriented = 0;
  for (int i = threadIdx.x; i < n * k; i += blockDim.x) {
    const int o = op.att_other[i];
    const bool on = op.att_mask[i] != 0;
    other[i] = on ? o : -1;
    misoriented |= on && (o < 0 || o >= i / k);  // not an earlier position
  }
  if (kTablesShared) {
    for (int64_t i = threadIdx.x; i < n_tab; i += blockDim.x)
      tab_shared[i] = op.att_table[i];
  }
  const int refused = __syncthreads_or(misoriented);
  if (threadIdx.x >= kWarp) return;
  const int lane = threadIdx.x;
  if (refused) {  // the seed back, steps = -1: every word defined
    for (int i = lane; i < n; i += kWarp) op.out[i] = best[i];
    if (lane == 0) {
      op.out[n] = __float_as_int(*op.ub0);
      op.out[n + 1] = -1;
      op.out[n + 2] = 0;
    }
    return;
  }

  const Shared sh{row, unary, lb_suffix, other, assign};
  const float* tables = kTablesShared ? tab_shared : op.att_table;
  const int last = n - 1;
  const int max_iters = op.max_iters;
  float ub = *op.ub0;
  int depth = 0;
  int v = 0;
  int dsz = dsize[0];
  const float2* here = row;  // the row of the position at `depth`
  int steps = 0;
  if (max_iters > 0)
    compute_row<KT, kTablesShared>(sh, tables, 0, 0.0f, dsz, k, d, lane);
  while (steps < max_iters) {
    ++steps;
    // What every outcome of the step may need, read together: the value's
    // (test, cost_new), and for a return the earlier position's value and
    // domain size.  Each is an in-bounds entry whatever the outcome, so
    // the loads issue at once and a step that does not move down or return
    // takes no branch but the one on feasibility.
    const bool exhausted = v >= dsz;
    const float2 cand = here[exhausted ? 0 : v];
    const int up = depth > 0 ? depth - 1 : 0;
    const int up_v = assign[up] + 1;
    const int up_dsz = dsize[up];
    if (!exhausted && cand.x < ub) {
      // Lanes run the same steps but need not stay in step between two
      // syncs: every lane's reads of the shared state (assign, the rows)
      // are done before any lane writes it anew.  Every lane then writes
      // the same value, so each reads back the one it wrote.
      __syncwarp();
      assign[depth] = v;
      if (depth == last) {  // a new incumbent
        ub = cand.y;
        ++v;
        for (int i = lane; i < n; i += kWarp) best[i] = assign[i];
      } else {
        ++depth;
        v = 0;
        dsz = dsize[depth];
        here = row + depth * d;
        compute_row<KT, kTablesShared>(sh, tables, depth, cand.y, dsz, k, d,
                                       lane);
      }
      continue;
    }
    if (exhausted) {  // back to the earlier position's next value
      if (--depth < 0) break;
      v = up_v;
      dsz = up_dsz;
      here -= d;
    } else {
      ++v;
    }
  }
  __syncwarp();
  for (int i = lane; i < n; i += kWarp) op.out[i] = best[i];
  if (lane == 0) {
    op.out[n] = __float_as_int(ub);
    op.out[n + 1] = steps;
    op.out[n + 2] = depth < 0 ? 1 : 0;
  }
}

template <int KT, bool kTablesShared>
int launch_one(const Operands& op, int bytes, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      branch_bound_kernel<KT, kTablesShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  branch_bound_kernel<KT, kTablesShared><<<1, BB_THREADS, bytes, st>>>(op);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTablesShared>
int launch_by_slots(const Operands& op, int bytes, cudaStream_t st) {
  switch (op.k) {
    case 1: return launch_one<1, kTablesShared>(op, bytes, st);
    case 2: return launch_one<2, kTablesShared>(op, bytes, st);
    case 3: return launch_one<3, kTablesShared>(op, bytes, st);
    case 4: return launch_one<4, kTablesShared>(op, bytes, st);
    case 5: return launch_one<5, kTablesShared>(op, bytes, st);
    case 6: return launch_one<6, kTablesShared>(op, bytes, st);
    case 7: return launch_one<7, kTablesShared>(op, bytes, st);
    case 8: return launch_one<8, kTablesShared>(op, bytes, st);
    default: return launch_one<0, kTablesShared>(op, bytes, st);
  }
}

}  // namespace

// The shared-memory bytes of a launch: the staged operands, the search
// state and the (test, cost_new) rows, and the attachment tables when
// tables_shared.
extern "C" long long branch_bound_smem_bytes(int n, int k, int d,
                                             int tables_shared) {
  const long long nd = static_cast<long long>(n) * d;
  // row (2 words a value), unary, lb_suffix, dsize, other, assign, best
  long long words = 2 * nd + nd + (n + 1) + 3LL * n +
                    static_cast<long long>(n) * k;
  if (tables_shared) words += nd * k * d;
  return 4 * words;
}

extern "C" int branch_bound_launch(
    const void* unary, const void* dsize, const void* att_table,
    const void* att_other, const void* att_mask, const void* lb_suffix,
    const void* ub0, const void* best0, void* out, int n, int k, int d,
    int max_iters, int tables_shared, void* stream) {
  if (n < 1 || k < 1 || k > kMaxSlots || d < 1 || max_iters < 0) return -1;
  Operands op{};
  op.unary = static_cast<const float*>(unary);
  op.dsize = static_cast<const int32_t*>(dsize);
  op.att_table = static_cast<const float*>(att_table);
  op.att_other = static_cast<const int32_t*>(att_other);
  op.att_mask = static_cast<const uint8_t*>(att_mask);
  op.lb_suffix = static_cast<const float*>(lb_suffix);
  op.ub0 = static_cast<const float*>(ub0);
  op.best0 = static_cast<const int32_t*>(best0);
  op.out = static_cast<int32_t*>(out);
  op.n = n;
  op.k = k;
  op.d = d;
  op.max_iters = max_iters;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes =
      static_cast<int>(branch_bound_smem_bytes(n, k, d, tables_shared));
  return tables_shared ? launch_by_slots<true>(op, bytes, st)
                       : launch_by_slots<false>(op, bytes, st);
}
