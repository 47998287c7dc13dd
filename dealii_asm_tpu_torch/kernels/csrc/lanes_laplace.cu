// Kernel F: the Laplace apply on an unstructured mesh, gather -> per-cell sum
// factorisation -> scatter, on the flat DoF vector.
//
//   per cell c:  g = (grad N) P_c u0,  t = C_c g,  v_c = (grad N)^T t
//   v = sum over cells of P_c^T v_c,   u0 = free ? u : 0
//   out = free ? v : u            (vmult, constrained rows act as identity)
//   out = rhs - (free ? v : u)    (residual epilogue)
//
// P_c gathers cell c's m^3 DoFs (m = p+1) through the orientation-baked
// cell_dofs table (fem/general_dofs.py); C_c holds the 6 symmetric entries of
// w_q |J| J^-1 J^-T per quadrature point (q = m per axis) in reference
// coordinates, so the shape table is N and D unscaled.
//
// Replaces: dealii_asm_tpu/ops/pallas/lanes_vmult.py LanesDDVmultKernel
// (pallas_call at :263, with the gather and scatter in XLA at :275-307): the
// hyperball's outer f64 matvec, double-single on a (z*m+y, cell*m+x) tiling
// with banded roll-FMA tables on the TPU.  Hopper has native float64, so one
// template serves double (the outer operator) and float (the ball's
// multigrid levels, which the JAX package runs in XLA).
//
// Bound on the H100: device-memory traffic.  At 131,072 cells Q4 in float64
// the coefficient stream is 786.4 MB, u and v 67.5 MB each, the int32 gather
// table 65.5 MB: about 0.99 GB or 0.29 ms at 3.35 TB/s; in float32 about
// 0.53 GB or 0.16 ms.  The arithmetic, 16 m^4 + 9 m^3 multiply-adds per cell
// (2.9 GFLOP per apply at that size), is far below the card's float64 rate.
//
// Design: deterministic, two launches, no atomics (float atomics sum in an
// order that changes from run to run; run_config requires a repeated solve to
// take the same iteration count).
// 1. lanes_cells_kernel: a block owns CPB cells.  It gathers their m^3 values
//    through the gather table, whose constrained entries are -1 (read as 0),
//    and runs cell_sumfac (sumfac_cell.cuh, shared with kernel E) into a
//    (C, m^3) scratch.
// 2. lanes_scatter_kernel: one thread per DoF sums its scratch slots in
//    ascending order from a CSR inverse of cell_dofs built once at setup
//    (row_ptr of n+1 entries, then the slot ids) and applies the epilogue.
//    The CSR lists the slots of free DoFs only: an empty row is a
//    constrained DoF.
// The scratch and the CSR add about 0.36 GB of traffic in float64 (the
// scratch written and read, 2 x 131 MB, the slot ids 65.5 MB and row_ptr
// 33.8 MB): the price of a fixed summation order.
#include "sumfac_cell.cuh"

namespace dat {
namespace {

constexpr int kThreads = kCellThreads;

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
lanes_cells_kernel(const T* __restrict__ u, const int* __restrict__ gather,
                   const T* __restrict__ coeff, const T* __restrict__ shape,
                   T* __restrict__ vcell, int C) {
  using L = CellLayout<P>;
  constexpr int M = L::M, M2 = L::M2, M3 = L::M3, CPB = L::CPB;
  __shared__ T sh[4][M][M];        // N, D, D, D as [q][node]
  __shared__ T buf[6][CPB * M3];   // stage buffers, cell k at k * M3

  const int c0 = blockIdx.x * CPB;
  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * M2; i += kThreads) (&sh[0][0][0])[i] = shape[i];
  const size_t first = static_cast<size_t>(c0) * M3;
  const size_t total = static_cast<size_t>(C) * M3;
  for (int i = tid; i < CPB * M3; i += kThreads) {
    T val = T(0);
    if (first + i < total) {
      const int g = gather[first + i];
      if (g >= 0) val = u[g];
    }
    buf[0][i] = val;
  }
  __syncthreads();
  cell_sumfac<T, P>(sh, buf, coeff, vcell, c0, C);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lanes_scatter_kernel(const T* __restrict__ vcell,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ slots, const T* __restrict__ u,
                     const T* __restrict__ rhs, T* __restrict__ out, int n,
                     int mode) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int b = row_ptr[idx], e = row_ptr[idx + 1];
  T av;
  if (b == e) {
    av = u[idx];
  } else {
    T v = T(0);
    for (int k = b; k < e; ++k) v += vcell[slots[k]];
    av = v;
  }
  out[idx] = mode == kResidual ? rhs[idx] - av : av;
}

template <typename T, int P>
void launch_p(const T* u, const T* rhs, T* out, T* scratch, const T* coeff,
              const T* shape, const int* gather, const int* row_ptr,
              const int* slots, int C, int n, int mode, cudaStream_t stream) {
  using L = CellLayout<P>;
  const unsigned cell_blocks = static_cast<unsigned>((C + L::CPB - 1) / L::CPB);
  lanes_cells_kernel<T, P><<<cell_blocks, kThreads, 0, stream>>>(
      u, gather, coeff, shape, scratch, C);
  const unsigned dof_blocks = static_cast<unsigned>((n + kThreads - 1) /
                                                    kThreads);
  lanes_scatter_kernel<T><<<dof_blocks, kThreads, 0, stream>>>(
      scratch, row_ptr, slots, u, rhs, out, n, mode);
}

template <typename T>
int lanes_entry(const T* u, const T* rhs, T* out, T* scratch, const T* coeff,
                const T* shape, const int* gather, const int* row_ptr,
                const int* slots, int C, int n, int p, int mode,
                void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (p) {
    case 1: launch_p<T, 1>(u, rhs, out, scratch, coeff, shape, gather, row_ptr, slots, C, n, mode, s); break;
    case 2: launch_p<T, 2>(u, rhs, out, scratch, coeff, shape, gather, row_ptr, slots, C, n, mode, s); break;
    case 3: launch_p<T, 3>(u, rhs, out, scratch, coeff, shape, gather, row_ptr, slots, C, n, mode, s); break;
    case 4: launch_p<T, 4>(u, rhs, out, scratch, coeff, shape, gather, row_ptr, slots, C, n, mode, s); break;
    case 5: launch_p<T, 5>(u, rhs, out, scratch, coeff, shape, gather, row_ptr, slots, C, n, mode, s); break;
    case 6: launch_p<T, 6>(u, rhs, out, scratch, coeff, shape, gather, row_ptr, slots, C, n, mode, s); break;
    case 7: launch_p<T, 7>(u, rhs, out, scratch, coeff, shape, gather, row_ptr, slots, C, n, mode, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dat

extern "C" int dat_lanes_laplace_f32(const float* u, const float* rhs,
                                     float* out, float* scratch,
                                     const float* coeff, const float* shape,
                                     const int* gather, const int* row_ptr,
                                     const int* slots, int C, int n, int p,
                                     int mode, void* stream) {
  return dat::lanes_entry<float>(u, rhs, out, scratch, coeff, shape, gather,
                                 row_ptr, slots, C, n, p, mode, stream);
}

extern "C" int dat_lanes_laplace_f64(const double* u, const double* rhs,
                                     double* out, double* scratch,
                                     const double* coeff, const double* shape,
                                     const int* gather, const int* row_ptr,
                                     const int* slots, int C, int n, int p,
                                     int mode, void* stream) {
  return dat::lanes_entry<double>(u, rhs, out, scratch, coeff, shape, gather,
                                  row_ptr, slots, C, n, p, mode, stream);
}
