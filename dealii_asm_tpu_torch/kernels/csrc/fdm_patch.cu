// Kernel B: element-centric overlap-1 FDM Schwarz apply.
//
//   out = omega * P^-1 src            (kScale)
//   out = xold + omega * P^-1 src     (kUpdate)
//   p' = f1 p + omega P^-1 src,  out = xold + p'   (kMomentum, one sub-step
//                                                   of kernel D's sweep)
//   P^-1 = sum over cells of  R_c^T Fout (Vz x Vy x Vx) diag(1/(lz+ly+lx))
//                                   (Vz x Vy x Vx)^T Fin R_c
//
// with per-coordinate M-orthonormal eigenvectors V and eigenvalues lam of the
// 1D patch problems, and the multiplicity weights and Dirichlet masks folded
// per axis into Fin / Fout (weighting none/pre/post/symm).
//
// Replaces: dealii_asm_tpu/ops/pallas/fdm_slab.py FDMSlabKernel.
//
// Bound on the H100: the patch transforms cost 6 m^4 multiply-adds per cell
// (3750 at m = 5), i.e. ~30 per node, against one read and one write of
// 4 bytes per node: about 15 flops per byte, under the card's float32 balance,
// so the floor is device-memory traffic.  Overlap is the hard part: windows
// of neighbouring cells share a node plane, and blocks run in no order.
//
// Design: deterministic, one launch, no atomics.  A block owns the nodes of
// one cell at local positions [0, p) per axis (the last cell of an axis also
// owns position p).  An owned node at local position 0 also receives the
// contribution of the lower neighbour cell, so the block solves the patch
// problems of the up to 8 cells c - (dz, dy, dx), d in {0, 1}, each fully in
// shared memory (m^3 threads, one node each), and sums in registers the
// entries that land on its own nodes in a fixed order.  Repeated runs are
// bit-identical.  The price is up to 8x recomputed patch solves; the
// transforms are cheap next to the memory floor, and halving that factor
// (tiles of cells sharing their solves) is a later optimisation.
#include "kernels.h"

namespace dat {
namespace {

// MOM selects the momentum epilogue at compile time, so the kScale/kUpdate
// instantiations are the same code as without it.
template <typename T, int M, bool MOM>
__global__ void __launch_bounds__(M * M * M)
fdm_patch_kernel(FDMTables<T> t, const T* __restrict__ src,
                 const T* __restrict__ xold, T* __restrict__ out, T omega,
                 int mode, Momentum<T> mom) {
  constexpr int P = M - 1;
  constexpr int M2 = M * M;
  constexpr int M3 = M * M * M;
  __shared__ T s0[M3];
  __shared__ T s1[M3];

  const int Nx = t.Cx * P + 1, Ny = t.Cy * P + 1;
  const int tid = threadIdx.x;
  const int iz = tid / M2;
  const int iy = (tid / M) % M;
  const int ix = tid % M;
  const int cx = blockIdx.x, cy = blockIdx.y, cz = blockIdx.z;
  const bool own = (ix < P || cx == t.Cx - 1) && (iy < P || cy == t.Cy - 1) &&
                   (iz < P || cz == t.Cz - 1);

  T acc = T(0);
  for (int d = 0; d < 8; ++d) {
    const int dx = d & 1, dy = (d >> 1) & 1, dz = (d >> 2) & 1;
    const int sx = cx - dx, sy = cy - dy, sz = cz - dz;
    if (sx < 0 || sy < 0 || sz < 0) continue;  // uniform across the block
    const T* Vx = t.Vx + sx * M2;
    const T* Vy = t.Vy + sy * M2;
    const T* Vz = t.Vz + sz * M2;
    const int nx = sx * P + ix, ny = sy * P + iy, nz = sz * P + iz;

    // gather the window with the input folds (s0's last readers passed the
    // barrier after the backward y transform)
    s0[tid] = src[(static_cast<size_t>(nz) * Ny + ny) * Nx + nx] *
              t.fin_z[nz] * t.fin_y[ny] * t.fin_x[nx];
    __syncthreads();
    T a = T(0);  // forward x: V^T along x
#pragma unroll
    for (int j = 0; j < M; ++j) a += Vx[j * M + ix] * s0[iz * M2 + iy * M + j];
    s1[tid] = a;
    __syncthreads();
    a = T(0);  // forward y
#pragma unroll
    for (int j = 0; j < M; ++j) a += Vy[j * M + iy] * s1[iz * M2 + j * M + ix];
    s0[tid] = a;
    __syncthreads();
    a = T(0);  // forward z, then the eigenvalue-sum scale
#pragma unroll
    for (int j = 0; j < M; ++j) a += Vz[j * M + iz] * s0[j * M2 + iy * M + ix];
    s1[tid] = a / (t.lz[sz * M + iz] + t.ly[sy * M + iy] + t.lx[sx * M + ix]);
    __syncthreads();
    a = T(0);  // backward x: V along x
#pragma unroll
    for (int k = 0; k < M; ++k) a += Vx[ix * M + k] * s1[iz * M2 + iy * M + k];
    s0[tid] = a;
    __syncthreads();
    a = T(0);  // backward y
#pragma unroll
    for (int k = 0; k < M; ++k) a += Vy[iy * M + k] * s0[iz * M2 + k * M + ix];
    s1[tid] = a;
    __syncthreads();
    // backward z, only at the entries that land on this block's nodes
    const int qx = ix + P * dx, qy = iy + P * dy, qz = iz + P * dz;
    if (own && qx < M && qy < M && qz < M) {
      a = T(0);
#pragma unroll
      for (int k = 0; k < M; ++k) a += Vz[qz * M + k] * s1[k * M2 + qy * M + qx];
      acc += a;
    }
  }
  if (own) {
    const int nx = cx * P + ix, ny = cy * P + iy, nz = cz * P + iz;
    const size_t idx = (static_cast<size_t>(nz) * Ny + ny) * Nx + nx;
    const T val = omega * (acc * (t.fout_z[nz] * t.fout_y[ny] * t.fout_x[nx]));
    if constexpr (MOM) {
      // p is read and written only here, by the thread that owns idx; it is
      // not read where read_p is 0 (the first sub-step: p may be garbage)
      const T pn = mom.read_p ? mom.f1 * mom.p[idx] + val : val;
      if (mom.write_p) mom.p[idx] = pn;
      out[idx] = xold != nullptr ? xold[idx] + pn : pn;
    } else {
      out[idx] = mode == kUpdate ? xold[idx] + val : val;
    }
  }
}

template <typename T, int M, bool MOM>
void launch_m(const FDMTables<T>& t, const T* src, const T* xold, T* out,
              T omega, int mode, const Momentum<T>& mom,
              cudaStream_t stream) {
  const dim3 grid(t.Cx, t.Cy, t.Cz);
  fdm_patch_kernel<T, M, MOM><<<grid, M * M * M, 0, stream>>>(
      t, src, xold, out, omega, mode, mom);
}

template <typename T, bool MOM>
cudaError_t launch(const FDMTables<T>& t, const T* src, const T* xold, T* out,
                   T omega, int mode, const Momentum<T>& mom,
                   cudaStream_t stream) {
  switch (t.p) {
    case 1:
      launch_m<T, 2, MOM>(t, src, xold, out, omega, mode, mom, stream);
      break;
    case 2:
      launch_m<T, 3, MOM>(t, src, xold, out, omega, mode, mom, stream);
      break;
    case 3:
      launch_m<T, 4, MOM>(t, src, xold, out, omega, mode, mom, stream);
      break;
    case 4:
      launch_m<T, 5, MOM>(t, src, xold, out, omega, mode, mom, stream);
      break;
    case 5:
      launch_m<T, 6, MOM>(t, src, xold, out, omega, mode, mom, stream);
      break;
    case 6:
      launch_m<T, 7, MOM>(t, src, xold, out, omega, mode, mom, stream);
      break;
    case 7:
      launch_m<T, 8, MOM>(t, src, xold, out, omega, mode, mom, stream);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t fdm_patch_launch(const FDMTables<T>& t, const T* src,
                             const T* xold, T* out, T omega, int mode,
                             cudaStream_t stream) {
  if (mode != kScale && mode != kUpdate) return cudaErrorInvalidValue;
  return launch<T, false>(t, src, xold, out, omega, mode,
                          Momentum<T>{nullptr, T(0), 0, 0}, stream);
}

template <typename T>
cudaError_t fdm_patch_momentum_launch(const FDMTables<T>& t, const T* src,
                                      const T* xold, T* out, T f2,
                                      const Momentum<T>& mom,
                                      cudaStream_t stream) {
  return launch<T, true>(t, src, xold, out, f2, kMomentum, mom, stream);
}

template cudaError_t fdm_patch_launch<float>(const FDMTables<float>&,
                                             const float*, const float*,
                                             float*, float, int,
                                             cudaStream_t);
template cudaError_t fdm_patch_launch<double>(const FDMTables<double>&,
                                              const double*, const double*,
                                              double*, double, int,
                                              cudaStream_t);
template cudaError_t fdm_patch_momentum_launch<float>(
    const FDMTables<float>&, const float*, const float*, float*, float,
    const Momentum<float>&, cudaStream_t);
template cudaError_t fdm_patch_momentum_launch<double>(
    const FDMTables<double>&, const double*, const double*, double*, double,
    const Momentum<double>&, cudaStream_t);

}  // namespace dat

namespace {
template <typename T>
int fdm_entry(const T* src, const T* xold, T* out, const T* Vx, const T* Vy,
              const T* Vz, const T* lx, const T* ly, const T* lz,
              const T* fin_x, const T* fin_y, const T* fin_z,
              const T* fout_x, const T* fout_y, const T* fout_z, int Cz,
              int Cy, int Cx, int p, T omega, int mode, void* stream) {
  const dat::FDMTables<T> t{Vx,    Vy,    Vz,     lx,     ly,     lz,
                            fin_x, fin_y, fin_z,  fout_x, fout_y, fout_z,
                            Cz,    Cy,    Cx,     p};
  return static_cast<int>(dat::fdm_patch_launch<T>(
      t, src, xold, out, omega, mode, static_cast<cudaStream_t>(stream)));
}
}  // namespace

extern "C" int dat_fdm_patch_f32(
    const float* src, const float* xold, float* out, const float* Vx,
    const float* Vy, const float* Vz, const float* lx, const float* ly,
    const float* lz, const float* fin_x, const float* fin_y,
    const float* fin_z, const float* fout_x, const float* fout_y,
    const float* fout_z, int Cz, int Cy, int Cx, int p, float omega, int mode,
    void* stream) {
  return fdm_entry<float>(src, xold, out, Vx, Vy, Vz, lx, ly, lz, fin_x,
                          fin_y, fin_z, fout_x, fout_y, fout_z, Cz, Cy, Cx, p,
                          omega, mode, stream);
}

extern "C" int dat_fdm_patch_f64(
    const double* src, const double* xold, double* out, const double* Vx,
    const double* Vy, const double* Vz, const double* lx, const double* ly,
    const double* lz, const double* fin_x, const double* fin_y,
    const double* fin_z, const double* fout_x, const double* fout_y,
    const double* fout_z, int Cz, int Cy, int Cx, int p, double omega,
    int mode, void* stream) {
  return fdm_entry<double>(src, xold, out, Vx, Vy, Vz, lx, ly, lz, fin_x,
                           fin_y, fin_z, fout_x, fout_y, fout_z, Cz, Cy, Cx,
                           p, omega, mode, stream);
}
