// Arity-2 min-plus marginalization: the factor half-cycle of MaxSum for
// every binary constraint on the lanes layout, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `factor_arity2_minplus` (body
// `_minplus_kernel`) in pydcop_tpu/compile/pallas_kernels.py.  For every
// binary constraint c with slot-0 edge e0[c] and slot-1 edge e1[c], and with
// a[i] = v2f_t[i, e0[c]] and b[j] = v2f_t[j, e1[c]],
//
//     out0[i, c] = min_j ( ((T[i*D+j, c] + a[i]) + b[j]) - a[i] )
//     out1[j, c] = min_i ( ((T[i*D+j, c] + a[i]) + b[j]) - b[j] )
//
// What bounds it on the card: bytes.  Per constraint it reads D*D table
// floats, two int32 edge ids and 2*D gathered message floats, and writes
// 2*D floats: 92 B at D=3, against 4*D*D adds and subtracts and 2*D*(D-1)
// mins (48), about 0.5 operations per byte, far under the H100's ratio of
// peak float32 operations to memory bandwidth (~20).
//
// What the design does about it:
// - the two slot gathers `v2f_t[:, edge_ids[:, s]]`, which the TPU path ran
//   as XLA gathers writing two [D, n_c] planes, are folded in: each thread
//   reads its constraint's 2*D messages directly, saving two plane writes
//   and reads per cycle;
// - one thread per constraint with the constraint axis fastest in the table
//   and in both outputs, so the table stream, the edge ids and the stores
//   are coalesced; only the message reads scatter, which is inherent to the
//   gather;
// - the body is adds, one subtract and mins in the association above, with
//   no multiply, so no FMA contraction can change a bit (keep fast-math and
//   flush-to-zero out of the flags): the result equals the plain PyTorch
//   version by value.
//
// D is a runtime loop bound with no upper limit.  The table is read twice,
// once per output plane; the second pass finds it in L1/L2.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launch, 0 on success.  The caller owns every buffer and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void factor_arity2_minplus_kernel(
    const float* __restrict__ v2f_t, const int32_t* __restrict__ e0,
    const int32_t* __restrict__ e1, const float* __restrict__ tables_t,
    float* __restrict__ out0, float* __restrict__ out1, int d,
    int64_t n_edges, int64_t n_c) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= n_c) return;
  const float* a = v2f_t + e0[c];  // a[i] at a[i * n_edges]
  const float* b = v2f_t + e1[c];
  const float* t = tables_t + c;  // T[k, c] at t[k * n_c]
  for (int i = 0; i < d; ++i) {
    const float ai = __ldg(a + i * n_edges);
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float tot =
          (t[static_cast<int64_t>(i * d + j) * n_c] + ai) + __ldg(b + j * n_edges);
      const float m = tot - ai;
      acc = j == 0 ? m : fminf(acc, m);
    }
    out0[i * n_c + c] = acc;
  }
  for (int j = 0; j < d; ++j) {
    const float bj = __ldg(b + j * n_edges);
    float acc = 0.0f;
    for (int i = 0; i < d; ++i) {
      const float tot =
          (t[static_cast<int64_t>(i * d + j) * n_c] + __ldg(a + i * n_edges)) + bj;
      const float m = tot - bj;
      acc = i == 0 ? m : fminf(acc, m);
    }
    out1[j * n_c + c] = acc;
  }
}

}  // namespace

extern "C" int factor_arity2_minplus_launch(
    const void* v2f_t, const void* e0, const void* e1, const void* tables_t,
    void* out0, void* out1, int d, long long n_edges, long long n_c,
    void* stream) {
  if (n_c <= 0 || d <= 0) return 0;
  const long long blocks = (n_c + kThreads - 1) / kThreads;
  factor_arity2_minplus_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v2f_t), static_cast<const int32_t*>(e0),
      static_cast<const int32_t*>(e1), static_cast<const float*>(tables_t),
      static_cast<float*>(out0), static_cast<float*>(out1), d,
      static_cast<int64_t>(n_edges), static_cast<int64_t>(n_c));
  return static_cast<int>(cudaGetLastError());
}
