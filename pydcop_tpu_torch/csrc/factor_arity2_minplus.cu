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
// v2f_t is float32 or, under MaxSum's precision="bf16", bfloat16 (the
// kernel is a template on the plane type;
// factor_arity2_minplus_bf16_launch): a and b are widened exactly to
// float32 as they are loaded, as the TPU kernel's adds promote them, and
// table, arithmetic and outputs stay float32.  A bf16 plane halves the
// gathered message bytes: 80 B a constraint at D=3 instead of 92.
//
// What bounds it on the card: bytes.  Per constraint it reads D*D table
// floats, two int32 edge ids and 2*D gathered message floats, and writes
// 2*D floats: 92 B at D=3, against 4*D*D adds and subtracts and 2*D*(D-1)
// mins (48), about 0.5 operations per byte, far under the H100's ratio of
// peak float32 operations to memory bandwidth (~20).  So the design is
// about keeping enough bytes in flight and moving no byte twice:
//
// - the two slot gathers `v2f_t[:, edge_ids[:, s]]`, which the TPU path ran
//   as XLA gathers writing two [D, n_c] planes, are folded in: each thread
//   reads its constraint's 2*D messages directly, once, into registers;
// - one pass over the table: for each row i the joint totals
//   tot = (T[i*D+j] + a[i]) + b[j] give out0[i] = min_j(tot - a[i]) and
//   fold tot - b[j] into D running minima for out1.  Each value comes from
//   the same tot as in the plain version, so no bit changes, and the table
//   is read once where a two-pass body reads it twice;
// - D is a template parameter for D = 1..16 (the TPU kernel's own range,
//   MAX_PALLAS_DOMAIN), so every loop is unrolled and each constraint's
//   loads are started ahead of the arithmetic: the edge ids and the table
//   (none depends on another), then the 2*D messages (which wait for the
//   ids only).  Up to D=8 all D*D table values are loaded at once; above
//   that, one row of D at a time, to stay in registers;
// - a thread takes slots_per_pass<D, 4>() constraints at once (4 at D <= 3,
//   2 at D <= 5, else 1), strided by the grid's width so every stream stays
//   coalesced: the constraint axis is fastest in the table, the ids and both
//   outputs.  Loads are scalar: row starts k*n_c are not 16-byte aligned
//   for most n_c;
// - the grid is sized to the card (SMs times resident blocks per SM, or
//   fewer when the constraints run out first) and walks them with a
//   grid-stride loop, so there is no ragged last wave;
// - the read-once streams (table, edge ids) are streaming loads
//   (`ld.global.cs`), so they do not evict the v2f plane that the
//   scattered message reads need from L2; those take the read-only path
//   (`__ldg`); the outputs use plain stores, since the next pass reads
//   them;
// - the body is adds, subtracts and mins in the association above, with
//   no multiply, so no FMA contraction can change a bit (keep fast-math and
//   flush-to-zero out of the flags): the result equals the plain PyTorch
//   version by value.
//
// What is left between it and its bound: each message value is a 4-byte
// read from its own 32-byte sector (the plane is [D, n_edges]), so the
// gathers move about 8x the bytes they use between L2 and the SMs.
//
// D > 16 runs `factor_arity2_minplus_any`, one thread per constraint with D
// a runtime loop bound and no upper limit; it reads the table twice, once
// per output plane (the second pass finds it in L1/L2).
//
// Plain C interface (loaded with ctypes): returns the first CUDA error of
// the launch (cudaGetLastError() after it), 0 on success.  The caller owns
// every buffer and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

template <typename P, int D, int K>
__global__ void __launch_bounds__(kThreads) factor_arity2_minplus_fixed(
    const P* __restrict__ v2f_t, const int32_t* __restrict__ e0,
    const int32_t* __restrict__ e1, const float* __restrict__ tables_t,
    float* __restrict__ out0, float* __restrict__ out1, int64_t n_edges,
    int64_t n_c) {
  constexpr bool kWhole = D <= kWholeTableD;
  constexpr int kTabRegs = kWhole ? D * D : 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       base < n_c; base += K * stride) {
    int64_t c[K];
    bool live[K];
    int64_t ia[K];
    int64_t ib[K];
    float tab[K][kTabRegs];
    float a[K][D];
    float b[K][D];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c[k] = base + k * stride;
      live[k] = c[k] < n_c;
      ia[k] = live[k] ? __ldcs(e0 + c[k]) : 0;
      ib[k] = live[k] ? __ldcs(e1 + c[k]) : 0;
    }
    if constexpr (kWhole) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int r = 0; r < kTabRegs; ++r) {
          tab[k][r] = live[k] ? __ldcs(tables_t + r * n_c + c[k]) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        a[k][i] = live[k] ? load_plane(v2f_t + i * n_edges + ia[k]) : 0.0f;
        b[k][i] = live[k] ? load_plane(v2f_t + i * n_edges + ib[k]) : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!live[k]) continue;
      float acc1[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float row[D];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          if constexpr (kWhole) {
            row[j] = tab[k][i * D + j];
          } else {
            row[j] = __ldcs(tables_t + (i * D + j) * n_c + c[k]);
          }
        }
        float acc0 = 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float tot = (row[j] + a[k][i]) + b[k][j];
          const float m0 = tot - a[k][i];
          const float m1 = tot - b[k][j];
          acc0 = j == 0 ? m0 : fminf(acc0, m0);
          acc1[j] = i == 0 ? m1 : fminf(acc1[j], m1);
        }
        out0[i * n_c + c[k]] = acc0;
      }
#pragma unroll
      for (int j = 0; j < D; ++j) out1[j * n_c + c[k]] = acc1[j];
    }
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads) factor_arity2_minplus_any(
    const P* __restrict__ v2f_t, const int32_t* __restrict__ e0,
    const int32_t* __restrict__ e1, const float* __restrict__ tables_t,
    float* __restrict__ out0, float* __restrict__ out1, int d,
    int64_t n_edges, int64_t n_c) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= n_c) return;
  const P* a = v2f_t + e0[c];  // a[i] at a[i * n_edges]
  const P* b = v2f_t + e1[c];
  const float* t = tables_t + c;  // T[k, c] at t[k * n_c]
  for (int i = 0; i < d; ++i) {
    const float ai = load_plane(a + i * n_edges);
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float tot =
          (t[static_cast<int64_t>(i * d + j) * n_c] + ai) +
          load_plane(b + j * n_edges);
      const float m = tot - ai;
      acc = j == 0 ? m : fminf(acc, m);
    }
    out0[i * n_c + c] = acc;
  }
  for (int j = 0; j < d; ++j) {
    const float bj = load_plane(b + j * n_edges);
    float acc = 0.0f;
    for (int i = 0; i < d; ++i) {
      const float tot =
          (t[static_cast<int64_t>(i * d + j) * n_c] +
           load_plane(a + i * n_edges)) +
          bj;
      const float m = tot - bj;
      acc = i == 0 ? m : fminf(acc, m);
    }
    out1[j * n_c + c] = acc;
  }
}

template <typename P>
struct Args {
  const P* v2f_t;
  const int32_t* e0;
  const int32_t* e1;
  const float* tables_t;
  float* out0;
  float* out1;
  int d;
  int64_t n_edges;
  int64_t n_c;
  cudaStream_t stream;
};

template <typename P, int D>
cudaError_t launch_fixed(const Args<P>& x) {
  constexpr int K = slots_per_pass<D, 4>();
  static const int per_sm =
      resident_blocks(factor_arity2_minplus_fixed<P, D, K>);
  unsigned int blocks = 0;
  const cudaError_t err = grid_for(per_sm, x.n_c, &blocks);
  if (err != cudaSuccess) return err;
  factor_arity2_minplus_fixed<P, D, K><<<blocks, kThreads, 0, x.stream>>>(
      x.v2f_t, x.e0, x.e1, x.tables_t, x.out0, x.out1, x.n_edges, x.n_c);
  return cudaGetLastError();
}

template <typename P, int D>
cudaError_t dispatch(const Args<P>& x) {
  if constexpr (D > kMaxFixedD) {
    const int64_t blocks = (x.n_c + kThreads - 1) / kThreads;
    factor_arity2_minplus_any<P><<<static_cast<unsigned int>(blocks),
                                   kThreads, 0, x.stream>>>(
        x.v2f_t, x.e0, x.e1, x.tables_t, x.out0, x.out1, x.d, x.n_edges,
        x.n_c);
    return cudaGetLastError();
  } else {
    return x.d == D ? launch_fixed<P, D>(x) : dispatch<P, D + 1>(x);
  }
}

template <typename P>
int launch(const void* v2f_t, const void* e0, const void* e1,
           const void* tables_t, void* out0, void* out1, int d,
           long long n_edges, long long n_c, void* stream) {
  if (n_c <= 0 || d <= 0) return 0;
  const Args<P> x{static_cast<const P*>(v2f_t),
                  static_cast<const int32_t*>(e0),
                  static_cast<const int32_t*>(e1),
                  static_cast<const float*>(tables_t),
                  static_cast<float*>(out0),
                  static_cast<float*>(out1),
                  d,
                  static_cast<int64_t>(n_edges),
                  static_cast<int64_t>(n_c),
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<P, 1>(x));
}

}  // namespace

extern "C" int factor_arity2_minplus_launch(
    const void* v2f_t, const void* e0, const void* e1, const void* tables_t,
    void* out0, void* out1, int d, long long n_edges, long long n_c,
    void* stream) {
  return launch<float>(v2f_t, e0, e1, tables_t, out0, out1, d, n_edges, n_c,
                       stream);
}

// The same with a bfloat16 v2f_t (MaxSum's precision="bf16"): a[i] and
// b[j] are widened exactly to float32 as they are loaded; table,
// arithmetic and outputs stay float32.
extern "C" int factor_arity2_minplus_bf16_launch(
    const void* v2f_t, const void* e0, const void* e1, const void* tables_t,
    void* out0, void* out1, int d, long long n_edges, long long n_c,
    void* stream) {
  return launch<__nv_bfloat16>(v2f_t, e0, e1, tables_t, out0, out1, d,
                               n_edges, n_c, stream);
}
