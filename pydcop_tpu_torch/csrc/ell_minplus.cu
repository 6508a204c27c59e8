// ELL min-plus marginalization: the factor half-cycle of MaxSum on the
// degree-bucketed (ELL) layout, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ell_minplus` (body `_ell_kernel`) in
// pydcop_tpu/compile/pallas_kernels.py.  For every ELL slot e and own value i
//
//     out[i, e] = min_j ( tabs_t[i, j, e] + v2f_t[j, pair_perm[e]] )
//
// and out[:, e] = 0 exactly on padding slots (real_row[e] == 0).
//
// What bounds it on the card: bytes.  Per slot it reads D*D table floats,
// D partner floats, one int32 index and one mask byte, and writes D floats:
// 65 B per slot at D=3, against D*D adds and D*(D-1) mins (15), about 0.2
// operations per byte, far under the H100's ratio of peak float32
// operations to memory bandwidth (~20).
//
// What the design does about it:
// - the pair gather `v2f_t[:, pair_perm]`, which the TPU path ran as a
//   separate XLA gather writing a [D, n_pad] partner plane, is folded in:
//   each thread reads its partner's D values directly, saving one plane
//   write and one plane read per cycle;
// - one thread per slot with the slot axis fastest in every plane, so the
//   table stream, the mask, the index and the output stores are coalesced;
//   only the partner reads scatter, which is inherent to the gather;
// - the body is adds and mins only, so no FMA contraction can change a bit:
//   the result equals the plain PyTorch version by value.
//
// D is a runtime loop bound with no upper limit.  The partner values are
// re-read per own value i; those reads hit L1 after the first pass.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launch, 0 on success.  The caller owns every buffer and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void ell_minplus_kernel(const float* __restrict__ v2f_t,
                                   const int32_t* __restrict__ pair_perm,
                                   const float* __restrict__ tabs_t,
                                   const uint8_t* __restrict__ real_row,
                                   float* __restrict__ out, int d,
                                   int64_t n_pad) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_pad) return;
  if (!real_row[e]) {
    for (int i = 0; i < d; ++i) out[i * n_pad + e] = 0.0f;
    return;
  }
  const int64_t p = pair_perm[e];
  for (int i = 0; i < d; ++i) {
    const float* row = tabs_t + static_cast<int64_t>(i) * d * n_pad + e;
    float acc = row[0] + __ldg(v2f_t + p);
    for (int j = 1; j < d; ++j) {
      acc = fminf(acc, row[j * n_pad] + __ldg(v2f_t + j * n_pad + p));
    }
    out[i * n_pad + e] = acc;
  }
}

}  // namespace

extern "C" int ell_minplus_launch(const void* v2f_t, const void* pair_perm,
                                  const void* tabs_t, const void* real_row,
                                  void* out, int d, long long n_pad,
                                  void* stream) {
  if (n_pad <= 0 || d <= 0) return 0;
  const long long blocks = (n_pad + kThreads - 1) / kThreads;
  ell_minplus_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v2f_t), static_cast<const int32_t*>(pair_perm),
      static_cast<const float*>(tabs_t), static_cast<const uint8_t*>(real_row),
      static_cast<float*>(out), d, static_cast<int64_t>(n_pad));
  return static_cast<int>(cudaGetLastError());
}
