// Shared declarations of the port's hand-written Hopper kernels.
//
// Each kernel lives in exactly one translation unit (banded_laplace.cu,
// fdm_patch.cu, lanes_laplace.cu, merged_laplace.cu; the last two share the
// per-cell body of sumfac_cell.cuh); smoother_step.cu composes the host
// launchers of the first two.  Every
// extern "C" entry returns cudaGetLastError() after its launches, so the
// Python wrapper can raise on a refused launch.
//
// Layout: the lattice kernels' vectors are flat lexicographic grids
// (Nz, Ny, Nx), x fastest; kernel F's are numbered by its DoF table.
#pragma once

#include <cuda_runtime.h>

namespace dat {

// Diagonal tables of the assembled 1D mass/stiffness factors, one per axis:
// D[k * N + i] = D_matrix[i, i + k - p] for k in [0, 2p], zero outside.
template <typename T>
struct BandedTables {
  const T* Mx;
  const T* Kx;
  const T* My;
  const T* Ky;
  const T* Mz;
  const T* Kz;
  int Nz, Ny, Nx;
  int p;
};

// Per-coordinate FDM tables of element-centric overlap-1 patches (m = p+1):
// V[c * m * m + s * m + k] (node s, mode k) and lam[c * m + k] for cell
// coordinate c; fin/fout are the per-axis folds free * w^a_in, free * w^a_out.
template <typename T>
struct FDMTables {
  const T* Vx;
  const T* Vy;
  const T* Vz;
  const T* lx;
  const T* ly;
  const T* lz;
  const T* fin_x;
  const T* fin_y;
  const T* fin_z;
  const T* fout_x;
  const T* fout_y;
  const T* fout_z;
  int Cz, Cy, Cx;
  int p;
};

// Epilogue of the banded Laplace kernel.
enum BandedMode : int {
  kVmult = 0,     // out = free ? A u0 : u
  kResidual = 1,  // out = rhs - (free ? A u0 : u)
};

// Epilogue of the FDM patch kernel.
enum FDMMode : int {
  kScale = 0,   // out = omega * P^-1 src
  kUpdate = 1,  // out = xold + omega * P^-1 src
};

template <typename T>
cudaError_t banded_laplace_launch(const BandedTables<T>& t, const T* u,
                                  const T* rhs, T* out, int mode,
                                  cudaStream_t stream);

template <typename T>
cudaError_t fdm_patch_launch(const FDMTables<T>& t, const T* src,
                             const T* xold, T* out, T omega, int mode,
                             cudaStream_t stream);

}  // namespace dat
