// MaxSum's float32 damping as one fused multiply-add, for NVIDIA Hopper
// (sm_90a).
//
// The port's own kernel, not a TPU kernel's: XLA's CPU compiler contracts
// the JAX package's damping `d * prev + (1 - d) * new` (pydcop_tpu/compile/
// kernels.py, the MaxSum steps of pydcop_tpu/algorithms/maxsum.py and
// amaxsum.py) into
//
//     out[i] = fma(d, prev[i], e * new[i]),   d = f32(damping),
//                                             e = f32(1 - damping)
//
// the product e * new rounded to float32, then ONE rounding of the exact
// d * prev + that product.  Both roundings are written as intrinsics
// (`__fmul_rn`, `__fmaf_rn`), so nvcc's default `-fmad=true` can neither
// add a contraction (folding the multiply into the fma) nor drop one.  The
// plain version, `hopper_kernels.damp_fma_plain`, computes the same single
// rounding in float64 with round-to-odd, and the kernel is held to it with
// `torch.equal`.
//
// What bounds it on the card: bytes.  Per value it reads two floats and
// writes one: 12 B for one multiply and one fma, far under the H100's ratio
// of float32 operations to memory bandwidth.  So it is one grid-stride pass
// with 16-byte loads and stores (four values a thread a step) when the
// three planes are 16-byte aligned, scalar ones for the ragged tail or
// unaligned views; the grid is sized to the card.  A serving batch's K
// planes are one contiguous plane of K times the values: one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float damp1(float d, float e, float p, float n) {
  return __fmaf_rn(d, p, __fmul_rn(e, n));
}

// Values [0, 4 * n4) as float4s when `vec`, then the rest one by one.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    damp_fma_kernel(const float* __restrict__ prev,
                    const float* __restrict__ nw, float* __restrict__ out,
                    float d, float e, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t head = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    const float4* p4 = reinterpret_cast<const float4*>(prev);
    const float4* q4 = reinterpret_cast<const float4*>(nw);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 p = __ldcs(p4 + i);
      const float4 q = __ldcs(q4 + i);
      float4 r;
      r.x = damp1(d, e, p.x, q.x);
      r.y = damp1(d, e, p.y, q.y);
      r.z = damp1(d, e, p.z, q.z);
      r.w = damp1(d, e, p.w, q.w);
      o4[i] = r;
    }
    head = 4 * n4;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    out[i] = damp1(d, e, __ldcs(prev + i), __ldcs(nw + i));
  }
}

}  // namespace

// out[i] = fma(d, prev[i], e * new[i]) for i < n, on `stream`; returns
// cudaGetLastError().
extern "C" int damp_fma_launch(const void* prev, const void* nw, void* out,
                               float d, float e, long long n, void* stream) {
  if (n <= 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const bool vec = ((reinterpret_cast<uintptr_t>(prev) |
                     reinterpret_cast<uintptr_t>(nw) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t items = vec ? (n + 3) / 4 : n;
  const int64_t need = (items + kThreads - 1) / kThreads;
  const int64_t full = static_cast<int64_t>(sms) * kBlocksPerSm;
  const unsigned int blocks =
      static_cast<unsigned int>(need < full ? need : full);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(prev);
  const float* q = static_cast<const float*>(nw);
  float* o = static_cast<float*>(out);
  if (vec) {
    damp_fma_kernel<true><<<blocks, kThreads, 0, s>>>(p, q, o, d, e, n);
  } else {
    damp_fma_kernel<false><<<blocks, kThreads, 0, s>>>(p, q, o, d, e, n);
  }
  return cudaGetLastError();
}
