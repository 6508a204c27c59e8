// One level of XLA-CPU's tree order for a float32 sum, for NVIDIA Hopper
// (sm_90a).
//
// Not a port of a TPU kernel: the port's own kernel for the float sums
// whose order decides a result (pydcop_tpu_torch/compile/kernels.py,
// `xla_sum`): the anytime-best total of `evaluate` and MaxSum's ELL fan-in.
// The JAX package sums them with `jnp.sum` under `jit`, and XLA's
// CPU compiler (its TreeReductionRewriter) rewrites every float sum over
// more than 32 elements into a reduce-window of size 32 and stride 32,
// repeated until at most 32 partial sums are left, then a plain sequential
// reduce.  Each window pads the input with +0.0 symmetrically (lo =
// pad / 2 in front, the rest behind) and is summed sequentially from an
// initial 0.0.  The total is a sum of costs of up to 1e9 (a forbidden
// tuple), where float32 rounding depends on the order; the solvers keep
// the cycle whose total is strictly lowest, so only this exact order gives
// the JAX package's assignment on hard-constraint problems.
//
// The input is a strided stack of rows: row r = (i, b), i < outer,
// b < inner, starts at x + i * s_outer + b * s_inner and holds n
// consecutive floats (a contiguous [rows, n] tensor is outer = 1, inner =
// rows, s_inner = n; one degree class of MaxSum's ELL fan-in, a
// [D, nb, db] view of the [D, n_pad] plane, is outer = D, s_outer = n_pad,
// inner = nb, s_inner = db).  For each row and each window w < k:
//
//     out[r, w] = ((0.0 + x[r, w*width - lo]) + x[r, w*width - lo + 1]) ...
//
// over `width` elements, reading +0.0 outside [0, n); out is a contiguous
// [rows, k].  The wrapper runs one launch per level (width 32) and a last
// launch with k = 1, lo = 0 and width = the <= 32 values left: the final
// reduce (trailing zeros of that window would not change its sum, so none
// are read).

// What bounds it on the card: nothing at the sizes it runs at.  A level
// reads its floats once and writes a 32nd of them; at config 4's
// 200k-element bucket total that is 0.8 MB, about 0.25 us of HBM time, far
// under the few-microsecond cost of a launch.  The design is the simplest
// one that states the order: one thread a window, its adds in a plain
// loop in index order, adds only (no multiply, so no FMA contraction; keep
// fast-math and flush-to-zero out of the flags), so the result is the
// plain version's bit for bit.  A thread reads up to 32 consecutive
// floats: one 128-byte line, from L1 after its first load.
//
// Plain C interface (loaded with ctypes): returns the first CUDA error of
// the launch (cudaGetLastError() after it), 0 on success.  The caller owns
// every buffer and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    xla_tree_sum_level(const float* __restrict__ x, float* __restrict__ out,
                       int64_t outer, int64_t inner, int64_t s_outer,
                       int64_t s_inner, int64_t n, int64_t k, int64_t lo,
                       int width) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= outer * inner * k) return;
  const int64_t r = t / k;
  const int64_t w = t - r * k;
  const int64_t i = r / inner;
  const float* row = x + i * s_outer + (r - i * inner) * s_inner;
  const int64_t start = w * width - lo;
  float acc = 0.0f;
  for (int j = 0; j < width; ++j) {
    const int64_t c = start + j;
    const float v = (c >= 0 && c < n) ? row[c] : 0.0f;
    acc = acc + v;
  }
  out[t] = acc;
}

}  // namespace

extern "C" int xla_tree_sum_launch(const void* x, void* out, long long outer,
                                   long long inner, long long s_outer,
                                   long long s_inner, long long n, long long k,
                                   long long lo, int width, void* stream) {
  const int64_t total = static_cast<int64_t>(outer) * inner * k;
  if (total <= 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  xla_tree_sum_level<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<int64_t>(outer), static_cast<int64_t>(inner),
      static_cast<int64_t>(s_outer), static_cast<int64_t>(s_inner),
      static_cast<int64_t>(n), static_cast<int64_t>(k),
      static_cast<int64_t>(lo), width);
  return static_cast<int>(cudaGetLastError());
}
