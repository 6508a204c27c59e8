// What the two min-plus kernels share: the block size, the unrolling
// policy by domain size D, the grid sized to the card for a grid-stride
// loop, and the widening load of a float32 or bfloat16 message plane.  See ell_minplus.cu and factor_arity2_minplus.cu for
// why each kernel is shaped this way.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One value of a message plane, read through the read-only path and
// widened to float32: a float32 plane as it is, a bfloat16 plane (MaxSum's
// precision="bf16") exactly, as the TPU kernels' adds promote it.  All
// arithmetic stays float32.
__device__ __forceinline__ float load_plane(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float load_plane(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

constexpr int kThreads = 256;
// largest D with a compile-time instantiation (the TPU kernels' own
// range, MAX_PALLAS_DOMAIN); larger D runs the runtime-D kernel
constexpr int kMaxFixedD = 16;
// up to this D a thread loads all D*D table values of a slot before any
// arithmetic; above it, one row of D at a time, to stay in registers
constexpr int kWholeTableD = 8;

// Slots (or constraints) one thread takes at once, strided by the grid's
// width: enough independent loads in flight at small D, without spilling
// at large D; at most `kMax`.
template <int D, int kMax>
constexpr int slots_per_pass() {
  const int k = D <= 3 ? 4 : (D <= 5 ? 2 : 1);
  return k < kMax ? k : kMax;
}

// Blocks of `kernel` that one SM holds at once (1 if the query fails).
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads, 0);
  return b > 0 ? b : 1;
}

// Blocks for `n` slots: one slot a thread at least, at most the blocks the
// card holds at once (its SMs times `per_sm`), so a grid-stride loop walks
// the rest with no ragged last wave.
cudaError_t grid_for(int per_sm, int64_t n, unsigned int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t full = static_cast<int64_t>(sms) * per_sm;
  *blocks = static_cast<unsigned int>(need < full ? need : full);
  return cudaSuccess;
}

}  // namespace
