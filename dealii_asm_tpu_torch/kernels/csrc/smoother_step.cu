// Kernel C: one smoother step  x' = x + omega * P^-1 (b - A x).
//
// Replaces: dealii_asm_tpu/ops/pallas/smoother_step.py SmootherStepKernel
// (step / step_padded).  The TPU kernel runs its P^-1 transforms in bfloat16;
// here the whole step is float32 (or float64), so it is the same function as
// the composition of kernels A and B.
//
// Bound on the H100: device-memory traffic.  This version makes two launches
// with nothing between them: kernel A's device code with the residual
// epilogue writes r = b - A x (reads x and b, writes r), then kernel B's
// device code with the update epilogue writes x + omega * P^-1 r (reads r and
// x, writes x').  That is five grid-sized streams against the three (x, b in;
// x' out) of a single-pass kernel that keeps r on chip; the one-pass fusion
// is the first planned optimisation.  Constrained nodes keep x: the output
// fold of B is zero there.
#include "kernels.h"

namespace {
template <typename T>
int step_entry(const T* x, const T* b, T* r, T* out, const T* Mx, const T* Kx,
               const T* My, const T* Ky, const T* Mz, const T* Kz,
               const T* Vx, const T* Vy, const T* Vz, const T* lx,
               const T* ly, const T* lz, const T* fin_x, const T* fin_y,
               const T* fin_z, const T* fout_x, const T* fout_y,
               const T* fout_z, int Cz, int Cy, int Cx, int p, T omega,
               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dat::BandedTables<T> a{Mx, Kx, My, Ky, Mz, Kz,
                               Cz * p + 1, Cy * p + 1, Cx * p + 1, p};
  const dat::FDMTables<T> f{Vx,    Vy,    Vz,     lx,     ly,     lz,
                            fin_x, fin_y, fin_z,  fout_x, fout_y, fout_z,
                            Cz,    Cy,    Cx,     p};
  cudaError_t err = dat::banded_laplace_launch<T>(a, x, b, r, dat::kResidual, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      dat::fdm_patch_launch<T>(f, r, x, out, omega, dat::kUpdate, s));
}
}  // namespace

extern "C" int dat_smoother_step_f32(
    const float* x, const float* b, float* r, float* out, const float* Mx,
    const float* Kx, const float* My, const float* Ky, const float* Mz,
    const float* Kz, const float* Vx, const float* Vy, const float* Vz,
    const float* lx, const float* ly, const float* lz, const float* fin_x,
    const float* fin_y, const float* fin_z, const float* fout_x,
    const float* fout_y, const float* fout_z, int Cz, int Cy, int Cx, int p,
    float omega, void* stream) {
  return step_entry<float>(x, b, r, out, Mx, Kx, My, Ky, Mz, Kz, Vx, Vy, Vz,
                           lx, ly, lz, fin_x, fin_y, fin_z, fout_x, fout_y,
                           fout_z, Cz, Cy, Cx, p, omega, stream);
}

extern "C" int dat_smoother_step_f64(
    const double* x, const double* b, double* r, double* out,
    const double* Mx, const double* Kx, const double* My, const double* Ky,
    const double* Mz, const double* Kz, const double* Vx, const double* Vy,
    const double* Vz, const double* lx, const double* ly, const double* lz,
    const double* fin_x, const double* fin_y, const double* fin_z,
    const double* fout_x, const double* fout_y, const double* fout_z, int Cz,
    int Cy, int Cx, int p, double omega, void* stream) {
  return step_entry<double>(x, b, r, out, Mx, Kx, My, Ky, Mz, Kz, Vx, Vy, Vz,
                            lx, ly, lz, fin_x, fin_y, fin_z, fout_x, fout_y,
                            fout_z, Cz, Cy, Cx, p, omega, stream);
}
