// Kernel E: deformed-geometry (merged) Laplace apply on the node lattice.
//
//   per cell c:  g = (grad N) u0_c,  t = C_c g,  v_c = (grad N)^T t
//   v = sum over cells of v_c on the shared lattice nodes,  u0 = free ? u : 0
//   out = free ? v : u            (vmult, constrained rows act as identity)
//   out = rhs - (free ? v : u)    (residual epilogue)
//
// C_c holds the 6 symmetric entries of w_q |J| J^-1 J^-T per quadrature point
// (q = p+1 per axis), in box coordinates: D (the 1D derivative matrix) is
// pre-scaled by 1/h_d per direction and C by h_a h_b, as in the plain version.
//
// Replaces: dealii_asm_tpu/ops/pallas/merged_vmult.py MergedDDVmultKernel
// (the Kershaw outer f64 matvec, double-single on the TPU).  Hopper has
// native float64, so one template serves double (the outer operator) and
// float (the deformed multigrid levels).
//
// Bound on the H100: device-memory traffic.  The coefficient stream is
// 6 C Q values: at 48^3 cells Q4 in float64 663.6 MB, plus u and v (16 B per
// node, 115 MB), about 779 MB or 0.23 ms at 3.35 TB/s; in float32 about
// 390 MB or 0.12 ms.  The sum-factorised arithmetic is 16 m^4 + 9 m^3
// multiply-adds per cell (about 22 kflop at p = 4, 2.5 GFLOP per apply at
// 48^3), far below the card's FP64 rate.
//
// Design: deterministic, two launches, no atomics (floating-point atomics
// would sum in an order that changes from run to run; run_config requires a
// repeated solve to take the same iteration count).
// 1. merged_cells_kernel: a block owns CPB cells.  It gathers their (p+1)^3
//    node values (free mask applied), runs the three forward contractions in
//    shared memory, applies the cell's coefficients streamed cell-major
//    (C, 6, Q) so that neighbouring threads read neighbouring words, runs the
//    three backward contractions and writes the cell's result to a (C, m^3)
//    scratch array.
// 2. merged_gather_kernel: one thread per node sums the contributions of its
//    up to 8 cells in a fixed order and applies the epilogue.
// The scratch costs 2 C m^3 words of traffic (about 221 MB at 48^3 Q4 f64),
// instead of the 8x coefficient re-reads an owner-computes design (kernel B's)
// would need here.  The per-cell body (cell_sumfac, sumfac_cell.cuh) is shared
// with kernel F, which gathers through an index table instead of the lattice.
#include "sumfac_cell.cuh"

namespace dat {
namespace {

constexpr int kThreads = kCellThreads;

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
merged_cells_kernel(const T* __restrict__ u, const T* __restrict__ coeff,
                    const T* __restrict__ shape, T* __restrict__ vcell,
                    int Cz, int Cy, int Cx) {
  using L = CellLayout<P>;
  constexpr int M = L::M, M2 = L::M2, M3 = L::M3, CPB = L::CPB;
  __shared__ T sh[4][M][M];        // N, Dx/hx, Dy/hy, Dz/hz as [q][node]
  __shared__ T buf[6][CPB * M3];   // stage buffers, cell k at k * M3

  const int C = Cz * Cy * Cx;
  const int Nx = Cx * P + 1, Ny = Cy * P + 1, Nz = Cz * P + 1;
  const int c0 = blockIdx.x * CPB;
  const int tid = threadIdx.x;

  for (int i = tid; i < 4 * M2; i += kThreads) (&sh[0][0][0])[i] = shape[i];
  for (int i = tid; i < CPB * M3; i += kThreads) {
    const int k = i / M3, l = i - k * M3;
    const int c = c0 + k;
    T val = T(0);
    if (c < C) {
      const int cx = c % Cx, cy = (c / Cx) % Cy, cz = c / (Cx * Cy);
      const int x = cx * P + l % M, y = cy * P + (l / M) % M,
                z = cz * P + l / M2;
      if (x > 0 && x < Nx - 1 && y > 0 && y < Ny - 1 && z > 0 && z < Nz - 1)
        val = u[(static_cast<size_t>(z) * Ny + y) * Nx + x];
    }
    buf[0][i] = val;
  }
  __syncthreads();
  cell_sumfac<T, P>(sh, buf, coeff, vcell, c0, C);
}

// The cells (and local positions) that hold lattice coordinate i of an axis
// with C cells: cell i / P at i % P, and the lower cell at P where i % P == 0.
template <int P>
__device__ __forceinline__ int axis_cells(int i, int C, int* cs, int* ls) {
  const int c = i / P, s = i - c * P;
  int n = 0;
  if (c < C) {
    cs[n] = c;
    ls[n] = s;
    ++n;
  }
  if (s == 0 && c > 0) {
    cs[n] = c - 1;
    ls[n] = P;
    ++n;
  }
  return n;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
merged_gather_kernel(const T* __restrict__ vcell, const T* __restrict__ u,
                     const T* __restrict__ rhs, T* __restrict__ out, int Cz,
                     int Cy, int Cx, int mode) {
  using L = CellLayout<P>;
  constexpr int M = L::M, M3 = L::M3;
  const int Nx = Cx * P + 1, Ny = Cy * P + 1, Nz = Cz * P + 1;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(Nz) * Ny * Nx) return;
  const int x = static_cast<int>(idx % Nx);
  const int y = static_cast<int>((idx / Nx) % Ny);
  const int z = static_cast<int>(idx / (static_cast<size_t>(Nx) * Ny));
  const bool free = x > 0 && x < Nx - 1 && y > 0 && y < Ny - 1 && z > 0 &&
                    z < Nz - 1;
  T av;
  if (free) {
    int czs[2], lzs[2], cys[2], lys[2], cxs[2], lxs[2];
    const int nz = axis_cells<P>(z, Cz, czs, lzs);
    const int ny = axis_cells<P>(y, Cy, cys, lys);
    const int nx = axis_cells<P>(x, Cx, cxs, lxs);
    T v = T(0);
    for (int a = 0; a < nz; ++a)
      for (int b = 0; b < ny; ++b)
        for (int e = 0; e < nx; ++e) {
          const size_t cell =
              (static_cast<size_t>(czs[a]) * Cy + cys[b]) * Cx + cxs[e];
          v += vcell[cell * M3 + (lzs[a] * M + lys[b]) * M + lxs[e]];
        }
    av = v;
  } else {
    av = u[idx];
  }
  out[idx] = mode == kResidual ? rhs[idx] - av : av;
}

template <typename T, int P>
void launch_p(const T* u, const T* rhs, T* out, T* scratch, const T* coeff,
              const T* shape, int Cz, int Cy, int Cx, int mode,
              cudaStream_t stream) {
  using L = CellLayout<P>;
  const size_t C = static_cast<size_t>(Cz) * Cy * Cx;
  const size_t n = static_cast<size_t>(Cz * P + 1) * (Cy * P + 1) *
                   (Cx * P + 1);
  const unsigned cell_blocks =
      static_cast<unsigned>((C + L::CPB - 1) / L::CPB);
  merged_cells_kernel<T, P><<<cell_blocks, kThreads, 0, stream>>>(
      u, coeff, shape, scratch, Cz, Cy, Cx);
  const unsigned node_blocks = static_cast<unsigned>((n + kThreads - 1) /
                                                     kThreads);
  merged_gather_kernel<T, P><<<node_blocks, kThreads, 0, stream>>>(
      scratch, u, rhs, out, Cz, Cy, Cx, mode);
}

template <typename T>
int merged_entry(const T* u, const T* rhs, T* out, T* scratch, const T* coeff,
                 const T* shape, int Cz, int Cy, int Cx, int p, int mode,
                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (p) {
    case 1: launch_p<T, 1>(u, rhs, out, scratch, coeff, shape, Cz, Cy, Cx, mode, stream); break;
    case 2: launch_p<T, 2>(u, rhs, out, scratch, coeff, shape, Cz, Cy, Cx, mode, stream); break;
    case 3: launch_p<T, 3>(u, rhs, out, scratch, coeff, shape, Cz, Cy, Cx, mode, stream); break;
    case 4: launch_p<T, 4>(u, rhs, out, scratch, coeff, shape, Cz, Cy, Cx, mode, stream); break;
    case 5: launch_p<T, 5>(u, rhs, out, scratch, coeff, shape, Cz, Cy, Cx, mode, stream); break;
    case 6: launch_p<T, 6>(u, rhs, out, scratch, coeff, shape, Cz, Cy, Cx, mode, stream); break;
    case 7: launch_p<T, 7>(u, rhs, out, scratch, coeff, shape, Cz, Cy, Cx, mode, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dat

extern "C" int dat_merged_laplace_f32(const float* u, const float* rhs,
                                      float* out, float* scratch,
                                      const float* coeff, const float* shape,
                                      int Cz, int Cy, int Cx, int p, int mode,
                                      void* stream) {
  return dat::merged_entry<float>(u, rhs, out, scratch, coeff, shape, Cz, Cy,
                                  Cx, p, mode, stream);
}

extern "C" int dat_merged_laplace_f64(const double* u, const double* rhs,
                                      double* out, double* scratch,
                                      const double* coeff,
                                      const double* shape, int Cz, int Cy,
                                      int Cx, int p, int mode, void* stream) {
  return dat::merged_entry<double>(u, rhs, out, scratch, coeff, shape, Cz, Cy,
                                   Cx, p, mode, stream);
}
