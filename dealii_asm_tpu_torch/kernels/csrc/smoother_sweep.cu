// Kernel D: a whole degree-k smoother sweep in one call,
//
//   p_s = f1_s p_{s-1} + f2_s P^-1 (b - A x_{s-1}),   x_s = x_{s-1} + p_s,
//
// for s = 0 .. k-1 from x_{-1} = x, or from x_{-1} = 0 under zero_x, where
// sub-step 0 applies no A (its residual is b) and x is never read.  Rows
// (f1_s, f2_s) from the Chebyshev recurrence (both kinds) give a Chebyshev
// smoother apply; f1 = 0 gives k Richardson steps.  Constrained nodes keep
// x (0 under zero_x): B's output fold is zero there, so p stays 0.
//
// Replaces: dealii_asm_tpu/ops/pallas/smoother_step.py _call_chain (the
// momentum chain behind SmootherStepKernel.sweep_padded, and steps_padded
// with f1 = 0).  The TPU kernel keeps the intermediate iterates on chip and
// runs its FDM stage and residual ring in bfloat16; here every sub-step is
// float32 (or float64), so the sweep is the same function as the
// composition of kernels A and B.
//
// Bound on the H100: a one-pass sweep would move three grid streams (x, b
// in; x' out; two under zero_x) and do k times kernel C's operations, which
// at Q4 puts operations and bytes at about the same time.  This version
// runs each sub-step as two launches with no torch operation between them,
// all on the caller's stream: kernel A's device code with the residual
// epilogue (r = b - A x_{s-1}; skipped at s = 0 under zero_x), then kernel
// B's tiled device code (fdm_patch.cu, fdm_tile.cuh: each patch solved once
// per sub-step) with the kMomentum epilogue, which reads r, x_{s-1} and p
// and writes p and x_s in one pass.  The iterates ping-pong between two
// buffers so that the last sub-step writes the output; p is updated in
// place.  One pass per sub-step (r kept on chip) was timed against this on
// the H100, as kernel C's body with the kMomentum epilogue and as a
// warp-specialised kernel overlapping the residual with the solve: both
// were slower at 64^3 Q4 and Q2 (PERF.md), because they recompute r on the
// tile's whole patch window and A and B are not bound by device memory, so
// the read and write of r that the one pass saves cost less than that.
#include "kernels.h"

namespace {
template <typename T>
int sweep_entry(const T* x, const T* b, T* r, T* p, T* out, T* tmp,
                const T* Mx, const T* Kx, const T* My, const T* Ky,
                const T* Mz, const T* Kz, const T* Vx, const T* Vy,
                const T* Vz, const T* lx, const T* ly, const T* lz,
                const T* fin_x, const T* fin_y, const T* fin_z,
                const T* fout_x, const T* fout_y, const T* fout_z, int Cz,
                int Cy, int Cx, int deg, const T* coefs, int k, int zero_x,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dat::BandedTables<T> a{Mx, Kx, My, Ky, Mz, Kz,
                               Cz * deg + 1, Cy * deg + 1, Cx * deg + 1, deg};
  const dat::FDMTables<T> f{Vx,    Vy,    Vz,     lx,     ly,     lz,
                            fin_x, fin_y, fin_z,  fout_x, fout_y, fout_z,
                            Cz,    Cy,    Cx,     deg};
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* xs = zero_x ? nullptr : x;  // x_{s-1}; nullptr stands for 0
  for (int i = 0; i < k; ++i) {
    // the buffers alternate so that sub-step k-1 writes out
    T* xn = (k - 1 - i) % 2 == 0 ? out : tmp;
    const T* src = b;
    if (xs != nullptr) {
      const cudaError_t err =
          dat::banded_laplace_launch<T>(a, xs, b, r, dat::kResidual, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      src = r;
    }
    const T f1 = coefs[2 * i];
    const dat::Momentum<T> mom{
        p, f1, i > 0 && f1 != T(0),
        i + 1 < k && coefs[2 * (i + 1)] != T(0)};
    const cudaError_t err = dat::fdm_patch_momentum_launch<T>(
        f, src, xs, xn, coefs[2 * i + 1], mom, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    xs = xn;
  }
  return static_cast<int>(cudaSuccess);
}
}  // namespace

// coefs: host array of the k rows (f1_s, f2_s); x may be null under zero_x,
// tmp may be null when k == 1, p may be null when no f1_s (s > 0) is
// non-zero, r may be null when k == 1 under zero_x.
extern "C" int dat_smoother_sweep_f32(
    const float* x, const float* b, float* r, float* p, float* out,
    float* tmp, const float* Mx, const float* Kx, const float* My,
    const float* Ky, const float* Mz, const float* Kz, const float* Vx,
    const float* Vy, const float* Vz, const float* lx, const float* ly,
    const float* lz, const float* fin_x, const float* fin_y,
    const float* fin_z, const float* fout_x, const float* fout_y,
    const float* fout_z, int Cz, int Cy, int Cx, int deg, const float* coefs,
    int k, int zero_x, void* stream) {
  return sweep_entry<float>(x, b, r, p, out, tmp, Mx, Kx, My, Ky, Mz, Kz, Vx,
                            Vy, Vz, lx, ly, lz, fin_x, fin_y, fin_z, fout_x,
                            fout_y, fout_z, Cz, Cy, Cx, deg, coefs, k, zero_x,
                            stream);
}

extern "C" int dat_smoother_sweep_f64(
    const double* x, const double* b, double* r, double* p, double* out,
    double* tmp, const double* Mx, const double* Kx, const double* My,
    const double* Ky, const double* Mz, const double* Kz, const double* Vx,
    const double* Vy, const double* Vz, const double* lx, const double* ly,
    const double* lz, const double* fin_x, const double* fin_y,
    const double* fin_z, const double* fout_x, const double* fout_y,
    const double* fout_z, int Cz, int Cy, int Cx, int deg,
    const double* coefs, int k, int zero_x, void* stream) {
  return sweep_entry<double>(x, b, r, p, out, tmp, Mx, Kx, My, Ky, Mz, Kz,
                             Vx, Vy, Vz, lx, ly, lz, fin_x, fin_y, fin_z,
                             fout_x, fout_y, fout_z, Cz, Cy, Cx, deg, coefs, k,
                             zero_x, stream);
}
