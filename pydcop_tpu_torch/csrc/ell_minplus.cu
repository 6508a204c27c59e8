// ELL min-plus marginalization: the factor half-cycle of MaxSum on the
// degree-bucketed (ELL) layout, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ell_minplus` (body `_ell_kernel`) in
// pydcop_tpu/compile/pallas_kernels.py.  For every ELL slot e and own value i
//
//     out[i, e] = min_j ( tabs_t[i, j, e] + v2f_t[j, pair_perm[e]] )
//
// and out[:, e] = 0 exactly on padding slots (real_row[e] == 0).  v2f_t is
// float32 or, under MaxSum's precision="bf16", bfloat16 (the kernel is a
// template on the plane type; ell_minplus_bf16_launch): a bf16 value is
// widened exactly to float32 as it is loaded, as the TPU kernel's add
// promotes it, and tables, arithmetic and output stay float32.  A bf16
// plane halves the partner bytes: 59 B a slot at D=3 instead of 65.
//
// What bounds it on the card: bytes.  Per slot it reads D*D table floats,
// D partner floats, one int32 index and one mask byte, and writes D floats:
// 65 B per slot at D=3, against D*D adds and D*(D-1) mins (15), about 0.2
// operations per byte, far under the H100's ratio of peak float32
// operations to memory bandwidth (~20).  So the design is about keeping
// enough bytes in flight and moving no byte twice:
//
// - the pair gather `v2f_t[:, pair_perm]`, which the TPU path ran as a
//   separate XLA gather writing a [D, n_pad] partner plane, is folded in:
//   each thread reads its partner's D values directly, saving one plane
//   write and one plane read per cycle;
// - D is a template parameter for D = 1..16 (the TPU kernel's own range,
//   MAX_PALLAS_DOMAIN), so every loop is unrolled and each slot's work is
//   one batch of independent loads: the mask, the index and the table rows
//   first (none depends on another), then the D partner values (which wait
//   for the index only), each read once into registers; then the adds and
//   mins.  Up to D=8 all D*D table values of a slot are loaded before any
//   arithmetic; above that, one row of D at a time, to stay in registers;
// - a thread takes slots_per_pass<D, 2>() slots at once (2 at D <= 5, else
//   1), strided by the grid's width so every stream stays coalesced: the
//   slot axis is fastest in every plane.  Loads are scalar: row starts
//   k*n_pad are not 16-byte aligned for most n_pad;
// - the grid is sized to the card (SMs times resident blocks per SM, or
//   fewer when the slots run out first) and walks the slots with a
//   grid-stride loop, so there is no ragged last wave;
// - the read-once streams (tables, index, mask) are streaming loads
//   (`ld.global.cs`), so they do not evict the v2f plane that the
//   scattered partner reads need from L2; the partner reads take the
//   read-only path (`__ldg`); the output uses plain stores, since the
//   variable step reads it next;
// - padding slots load their tables like real ones (within a warp real and
//   padding slots interleave, so skipping them would save no 32-byte
//   sector), skip their partner gathers, and store exact 0;
// - the body is adds and mins only, in the plain version's order, so no
//   FMA contraction can change a bit (keep fast-math and flush-to-zero out
//   of the flags): the result equals the plain PyTorch version by value.
//
// What is left between it and its bound: each partner value is a 4-byte
// read from its own 32-byte sector (the plane is [D, n_pad], so a slot's D
// values lie n_pad apart), so the gathers move about 8x the bytes they use
// between L2 and the SMs.  The time barely changes when the operands sit
// in L2, so that on-chip traffic, not device memory, sets it; staging the
// tables through shared memory with cp.async, more or fewer slots a
// thread, and an L2 prefetch of the plane were each tried and were no
// faster (PERF.md).
//
// D > 16 runs `ell_minplus_any`, one thread per slot with D a runtime loop
// bound and no upper limit; it re-reads the partner values per own value
// (they hit L1 after the first pass).
//
// A batch (the serving layer's K tenants of one shape bucket) is one launch:
// the grid's y index is the instance, whose operands start that many
// instances into each [n_inst, ...] operand; its x extent shares the
// card's resident blocks among the instances.  A solo call is a batch of
// one, so both give each instance the same bits.
//
// Plain C interface (loaded with ctypes): returns the first CUDA error of
// the launch (cudaGetLastError() after it), 0 on success.  The caller owns
// every buffer and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

// Instance blockIdx.y of a batch of [n_inst, ...] operands (the serving
// layer's batches; pair indices are instance-local): its operands start
// that many instances in.
#define ELL_TO_INSTANCE(d)                          \
  do {                                              \
    const int64_t inst_ = blockIdx.y;               \
    v2f_t += inst_ * (d) * n_pad;                   \
    pair_perm += inst_ * n_pad;                     \
    tabs_t += inst_ * (d) * (d) * n_pad;            \
    real_row += inst_ * n_pad;                      \
    out += inst_ * (d) * n_pad;                     \
  } while (0)

template <typename P, int D, int K>
__global__ void __launch_bounds__(kThreads)
    ell_minplus_fixed(const P* __restrict__ v2f_t,
                      const int32_t* __restrict__ pair_perm,
                      const float* __restrict__ tabs_t,
                      const uint8_t* __restrict__ real_row,
                      float* __restrict__ out, int64_t n_pad) {
  ELL_TO_INSTANCE(D);
  constexpr bool kWhole = D <= kWholeTableD;
  constexpr int kTabRegs = kWhole ? D * D : 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       base < n_pad; base += K * stride) {
    int64_t e[K];
    bool live[K];
    bool real[K];
    int64_t p[K];
    float tab[K][kTabRegs];
    float m[K][D];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      e[k] = base + k * stride;
      live[k] = e[k] < n_pad;
      real[k] = live[k] && __ldcs(real_row + e[k]) != 0;
      p[k] = live[k] ? __ldcs(pair_perm + e[k]) : 0;
    }
    if constexpr (kWhole) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int r = 0; r < kTabRegs; ++r) {
          tab[k][r] = live[k] ? __ldcs(tabs_t + r * n_pad + e[k]) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        m[k][j] = real[k] ? load_plane(v2f_t + j * n_pad + p[k]) : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!live[k]) continue;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float row[D];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          if constexpr (kWhole) {
            row[j] = tab[k][i * D + j];
          } else {
            row[j] = __ldcs(tabs_t + (i * D + j) * n_pad + e[k]);
          }
        }
        float acc = row[0] + m[k][0];
#pragma unroll
        for (int j = 1; j < D; ++j) acc = fminf(acc, row[j] + m[k][j]);
        out[i * n_pad + e[k]] = real[k] ? acc : 0.0f;
      }
    }
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
    ell_minplus_any(const P* __restrict__ v2f_t,
                    const int32_t* __restrict__ pair_perm,
                    const float* __restrict__ tabs_t,
                    const uint8_t* __restrict__ real_row,
                    float* __restrict__ out, int d, int64_t n_pad) {
  ELL_TO_INSTANCE(d);
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_pad) return;
  if (!real_row[e]) {
    for (int i = 0; i < d; ++i) out[i * n_pad + e] = 0.0f;
    return;
  }
  const int64_t p = pair_perm[e];
  for (int i = 0; i < d; ++i) {
    const float* row = tabs_t + static_cast<int64_t>(i) * d * n_pad + e;
    float acc = row[0] + load_plane(v2f_t + p);
    for (int j = 1; j < d; ++j) {
      acc = fminf(acc, row[j * n_pad] + load_plane(v2f_t + j * n_pad + p));
    }
    out[i * n_pad + e] = acc;
  }
}

template <typename P>
struct Args {
  const P* v2f_t;
  const int32_t* pair_perm;
  const float* tabs_t;
  const uint8_t* real_row;
  float* out;
  int d;
  int64_t n_pad;
  int64_t n_inst;
  cudaStream_t stream;
};

// The grid of a batch: its y extent the instances, its x extent an equal
// share of the blocks the card holds at once (at least one, at most what
// one instance's slots need).
cudaError_t batch_grid(int per_sm, int64_t n_pad, int64_t n_inst,
                       dim3* grid) {
  unsigned int blocks = 0;
  const cudaError_t err = grid_for(per_sm, n_pad * n_inst, &blocks);
  if (err != cudaSuccess) return err;
  const int64_t need = (n_pad + kThreads - 1) / kThreads;
  int64_t x = blocks / n_inst;
  if (x < 1) x = 1;
  if (x > need) x = need;
  *grid = dim3(static_cast<unsigned int>(x),
               static_cast<unsigned int>(n_inst));
  return cudaSuccess;
}

template <typename P, int D>
cudaError_t launch_fixed(const Args<P>& x) {
  constexpr int K = slots_per_pass<D, 2>();
  static const int per_sm = resident_blocks(ell_minplus_fixed<P, D, K>);
  dim3 grid;
  const cudaError_t err = batch_grid(per_sm, x.n_pad, x.n_inst, &grid);
  if (err != cudaSuccess) return err;
  ell_minplus_fixed<P, D, K><<<grid, kThreads, 0, x.stream>>>(
      x.v2f_t, x.pair_perm, x.tabs_t, x.real_row, x.out, x.n_pad);
  return cudaGetLastError();
}

template <typename P, int D>
cudaError_t dispatch(const Args<P>& x) {
  if constexpr (D > kMaxFixedD) {
    const int64_t blocks = (x.n_pad + kThreads - 1) / kThreads;
    const dim3 grid(static_cast<unsigned int>(blocks),
                    static_cast<unsigned int>(x.n_inst));
    ell_minplus_any<P><<<grid, kThreads, 0, x.stream>>>(
        x.v2f_t, x.pair_perm, x.tabs_t, x.real_row, x.out, x.d, x.n_pad);
    return cudaGetLastError();
  } else {
    return x.d == D ? launch_fixed<P, D>(x) : dispatch<P, D + 1>(x);
  }
}

template <typename P>
int launch(const void* v2f_t, const void* pair_perm, const void* tabs_t,
           const void* real_row, void* out, int d, long long n_pad,
           long long n_inst, void* stream) {
  if (n_pad <= 0 || d <= 0 || n_inst <= 0) return 0;
  if (n_inst > 65535) return -1;  // the grid's y extent
  const Args<P> x{static_cast<const P*>(v2f_t),
                  static_cast<const int32_t*>(pair_perm),
                  static_cast<const float*>(tabs_t),
                  static_cast<const uint8_t*>(real_row),
                  static_cast<float*>(out),
                  d,
                  static_cast<int64_t>(n_pad),
                  static_cast<int64_t>(n_inst),
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<P, 1>(x));
}

}  // namespace

extern "C" int ell_minplus_launch(const void* v2f_t, const void* pair_perm,
                                  const void* tabs_t, const void* real_row,
                                  void* out, int d, long long n_pad,
                                  void* stream) {
  return launch<float>(v2f_t, pair_perm, tabs_t, real_row, out, d, n_pad, 1,
                       stream);
}

// The same with a bfloat16 v2f_t (MaxSum's precision="bf16"): each partner
// value is widened exactly to float32 as it is loaded; tables, arithmetic
// and the output stay float32.
extern "C" int ell_minplus_bf16_launch(const void* v2f_t,
                                       const void* pair_perm,
                                       const void* tabs_t,
                                       const void* real_row, void* out, int d,
                                       long long n_pad, void* stream) {
  return launch<__nv_bfloat16>(v2f_t, pair_perm, tabs_t, real_row, out, d,
                               n_pad, 1, stream);
}

// A batch of n_inst instances in one launch: every operand gains a leading
// instance axis ([n_inst, D, n_pad] planes, [n_inst, n_pad] pair_perm with
// instance-local slots, [n_inst, D, D, n_pad] tables, [n_inst, 1, n_pad]
// masks); instance i's result is the solo launch's on its operands.
extern "C" int ell_minplus_batched_launch(const void* v2f_t,
                                          const void* pair_perm,
                                          const void* tabs_t,
                                          const void* real_row, void* out,
                                          int d, long long n_pad,
                                          long long n_inst, void* stream) {
  return launch<float>(v2f_t, pair_perm, tabs_t, real_row, out, d, n_pad,
                       n_inst, stream);
}

extern "C" int ell_minplus_bf16_batched_launch(
    const void* v2f_t, const void* pair_perm, const void* tabs_t,
    const void* real_row, void* out, int d, long long n_pad,
    long long n_inst, void* stream) {
  return launch<__nv_bfloat16>(v2f_t, pair_perm, tabs_t, real_row, out, d,
                               n_pad, n_inst, stream);
}
