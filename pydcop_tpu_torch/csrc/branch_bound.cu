// Depth-first branch and bound: the whole search of SyncBB or NCBB as one
// launch, for NVIDIA Hopper (sm_90a).
//
// The port's own kernel, not a TPU kernel's: the JAX package runs this
// search as one jitted lax.while_loop that advances 256 masked steps an
// iteration (_bb_loop in pydcop_tpu/algorithms/_branch_bound.py).  Each
// step is a chain of about twenty dependent scalar operations; as PyTorch
// ops on the card every one would be a kernel, and a search takes up to
// millions of steps.  So the loop is the kernel.
//
// Variables are taken in a fixed order (position p = the p-th variable).
// A step at `depth` tries the next value v = ptr[depth] of that variable:
//
//   exhausted = v >= dsize[depth]                       -> backtrack
//   cost_new  = cost_prefix[depth]
//             + (unary[depth, v] + S)                    S: see below
//   feasible  = !exhausted && cost_new + lb_suffix[depth + 1] < ub
//
// with S the sum over the K attachment slots of the position, in slot
// order, of (att_mask[depth, k] ? att_table[depth, k, assign[att_other
// [depth, k]], v] : 0): the binary constraints oriented towards the later
// variable, read at the earlier variable's current value.  ptr[depth]
// moves on (or back to 0 when exhausted), a feasible value is assigned and
// its prefix cost stored, a feasible value at the last position is a new
// incumbent (ub, best), and the depth goes down on exhaustion and up on a
// feasible value short of the last position.  The loop ends when the depth
// falls below 0 (the search is complete) or after max_iters steps; the
// step count, the incumbent and the completion flag are JAX's, since
// JAX's masked dead steps count nothing and this loop stops where its
// `cond` does.
//
// The float arithmetic is the JAX package's, bit for bit: S is summed in
// the order XLA's CPU compiler gives the jitted loop's reduce over the K
// slots: for K <= 32 in slot order from +0.0 (K = 1: the one term, as
// XLA folds a one-element reduce away), above 32 in windows of 32 with
// symmetric zero padding, each in order from +0.0, then the window sums in
// order from +0.0 (xla_tree_levels in compile/hopper_kernels.py; K is at
// most 1024 here).  Every add is __fadd_rn, so nothing is contracted or
// reassociated; the bound test stays a strict <.
//
// What bounds it: latency.  A step is a dependent chain: the depth selects
// the position's row, the row's attachment gives the earlier variable, its
// current value the table entry, the entries' sum the feasibility, and the
// feasibility the next depth.  One step has at least three dependent
// shared-memory round trips (attachment -> assignment -> table entry),
// which no width of the card can overlap with the next step's.  The
// design keeps those round trips short:
//
// - one thread block; every thread stages the read-only operands into
//   shared memory (the per-position unary rows, domain sizes, attachment
//   slots, masks and tail bounds; the attachment tables too when all of
//   them fit, else they are read from device memory through the read-only
//   cache), then one thread runs the search, with ptr, assign, cost_prefix
//   and best in shared memory and depth, ub and the step count in
//   registers;
// - a step reads only the chosen value's column of the tables (K entries),
//   never the D-wide delta row that the JAX step computes;
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

constexpr int kWindow = 32;
constexpr int kMaxSlots = kWindow * kWindow;

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

// The attachment sum S of one candidate, in XLA's order (see above).
__device__ __forceinline__ float attached_sum(
    const float* __restrict__ tab, const int32_t* __restrict__ other,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ assign,
    int k, int d, int v) {
  auto term = [&](int s) -> float {
    return mask[s] ? tab[(s * d + assign[other[s]]) * d + v] : 0.0f;
  };
  if (k == 1) return term(0);
  if (k <= kWindow) {
    float acc = 0.0f;
    for (int s = 0; s < k; ++s) acc = __fadd_rn(acc, term(s));
    return acc;
  }
  const int windows = (k + kWindow - 1) / kWindow;
  const int lo = (windows * kWindow - k) / 2;
  float top = 0.0f;
  for (int w = 0; w < windows; ++w) {
    float acc = 0.0f;
    for (int i = 0; i < kWindow; ++i) {
      const int s = w * kWindow + i - lo;
      acc = __fadd_rn(acc, (s >= 0 && s < k) ? term(s) : 0.0f);
    }
    top = __fadd_rn(top, acc);
  }
  return top;
}

template <bool kTablesShared>
__global__ void __launch_bounds__(BB_THREADS) branch_bound_kernel(
    Operands op) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = op.n, k = op.k, d = op.d;
  const int64_t n_tab = static_cast<int64_t>(n) * k * d * d;
  // 4-byte arrays first, the byte masks last
  float* unary = reinterpret_cast<float*>(smem);
  float* lb_suffix = unary + n * d;
  float* cost_prefix = lb_suffix + (n + 1);
  int32_t* dsize = reinterpret_cast<int32_t*>(cost_prefix + (n + 1));
  int32_t* other = dsize + n;
  int32_t* ptr = other + n * k;
  int32_t* assign = ptr + n;
  int32_t* best = assign + n;
  float* tab_shared = reinterpret_cast<float*>(best + n);
  uint8_t* mask = reinterpret_cast<uint8_t*>(
      tab_shared + (kTablesShared ? n_tab : 0));

  for (int i = threadIdx.x; i < n * d; i += blockDim.x)
    unary[i] = op.unary[i];
  for (int i = threadIdx.x; i <= n; i += blockDim.x) {
    lb_suffix[i] = op.lb_suffix[i];
    cost_prefix[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dsize[i] = op.dsize[i];
    ptr[i] = 0;
    assign[i] = 0;
    best[i] = op.best0[i];
  }
  for (int i = threadIdx.x; i < n * k; i += blockDim.x) {
    other[i] = op.att_other[i];
    mask[i] = op.att_mask[i];
  }
  if (kTablesShared) {
    for (int64_t i = threadIdx.x; i < n_tab; i += blockDim.x)
      tab_shared[i] = op.att_table[i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const float* tables = kTablesShared ? tab_shared : op.att_table;
  const int64_t pos_stride = static_cast<int64_t>(k) * d * d;
  int depth = 0;
  int steps = 0;
  float ub = *op.ub0;
  while (depth >= 0 && steps < op.max_iters) {
    const int v = ptr[depth];
    const bool exhausted = v >= dsize[depth];
    bool feasible = false;
    float cost_new = 0.0f;
    if (!exhausted) {
      const float s = attached_sum(
          tables + depth * pos_stride, other + depth * k, mask + depth * k,
          assign, k, d, v);
      cost_new = __fadd_rn(cost_prefix[depth],
                           __fadd_rn(unary[depth * d + v], s));
      feasible = __fadd_rn(cost_new, lb_suffix[depth + 1]) < ub;
    }
    const bool is_last = depth == n - 1;
    ptr[depth] = exhausted ? 0 : v + 1;
    if (feasible) {
      assign[depth] = v;
      cost_prefix[depth + 1] = cost_new;
      if (is_last) {
        ub = cost_new;
        for (int i = 0; i < n; ++i) best[i] = assign[i];
      }
    }
    depth = exhausted ? depth - 1
                      : (feasible && !is_last ? depth + 1 : depth);
    ++steps;
  }
  for (int i = 0; i < n; ++i) op.out[i] = best[i];
  op.out[n] = __float_as_int(ub);
  op.out[n + 1] = steps;
  op.out[n + 2] = depth < 0 ? 1 : 0;
}

}  // namespace

// The shared-memory bytes of a launch: the staged operands and state, and
// the attachment tables when tables_shared.
extern "C" long long branch_bound_smem_bytes(int n, int k, int d,
                                             int tables_shared) {
  // unary, lb_suffix, cost_prefix, dsize, other, ptr, assign, best
  long long words = static_cast<long long>(n) * d + 2LL * (n + 1) +
                    4LL * n + static_cast<long long>(n) * k;
  if (tables_shared) words += static_cast<long long>(n) * k * d * d;
  return 4 * words + static_cast<long long>(n) * k;  // + the byte masks
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
  cudaError_t err;
  if (tables_shared) {
    err = cudaFuncSetAttribute(branch_bound_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    branch_bound_kernel<true><<<1, BB_THREADS, bytes, st>>>(op);
  } else {
    err = cudaFuncSetAttribute(branch_bound_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    branch_bound_kernel<false><<<1, BB_THREADS, bytes, st>>>(op);
  }
  return static_cast<int>(cudaGetLastError());
}
