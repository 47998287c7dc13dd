// Kernel A: separable Cartesian Laplace apply with banded 1D factors.
//
//   v = Kz My Mx u + Mz Ky Mx u + Mz My Kx u,   u0 = free ? u : 0,
//   out = free ? v : u            (vmult, constrained rows act as identity)
//   out = rhs - (free ? v : u)    (residual epilogue)
//
// Replaces: dealii_asm_tpu/ops/pallas/dd_vmult.py F32VmultKernel (f32, the MG
// level residual) and DDVmultKernel (double-single, the outer CG matvec).
// Hopper has native float64, so one template serves both: float for the
// levels, double for the outer operator.
//
// Bound on the H100: device-memory traffic.  The banded work is about
// 2 * (2p+1) * 3 multiply-adds per node (54 at p = 4), far below the card's
// flop-per-byte balance in either precision; the floor is one read of u (and
// of rhs for the residual) and one write of the result.
//
// Design: one launch, no intermediate grid in device memory.  A block owns a
// TY x TX column of output nodes and streams a chunk of z-planes through it.
// For every input plane it stages the (TY+2p) x (TX+2p) halo tile in shared
// memory, applies Mx and Kx along x (the TPU chain's x-dual pass), then My,
// Ky along y in registers, and pushes the pair (My Mx u, Ky Mx u + My Kx u)
// into a register ring of 2p+1 planes.  Once the ring holds the z-band of an
// output plane, the z contraction (Kz, Mz) and the epilogue run and the plane
// is written.  Each input plane is read once per z-chunk (plus a 2p-plane
// halo per chunk); the y/x halo re-reads hit L2.
#include "kernels.h"

namespace dat {
namespace {

constexpr int kTY = 8;
constexpr int kTX = 32;
constexpr int kZChunk = 32;

template <typename T, int P>
__global__ void __launch_bounds__(kTY * kTX)
banded_laplace_kernel(BandedTables<T> t, const T* __restrict__ u,
                      const T* __restrict__ rhs, T* __restrict__ out,
                      int mode) {
  constexpr int B = 2 * P + 1;
  constexpr int HY = kTY + 2 * P;
  constexpr int HX = kTX + 2 * P;
  __shared__ T su[HY][HX];
  __shared__ T sa[HY][kTX];  // Mx u
  __shared__ T sk[HY][kTX];  // Kx u

  const int Nz = t.Nz, Ny = t.Ny, Nx = t.Nx;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int gx = x0 + tx, gy = y0 + ty;
  const int zb = blockIdx.z * kZChunk;
  const int ze = min(Nz, zb + kZChunk);
  const bool in_col = gx < Nx && gy < Ny;

  T rb[B], rc[B];  // ring: entry k holds input plane zo - P + k
#pragma unroll
  for (int k = 0; k < B; ++k) {
    rb[k] = T(0);
    rc[k] = T(0);
  }

  for (int zi = zb - P; zi < ze + P; ++zi) {
#pragma unroll
    for (int k = 0; k < B - 1; ++k) {
      rb[k] = rb[k + 1];
      rc[k] = rc[k + 1];
    }
    T nb = T(0), nc = T(0);
    if (zi >= 0 && zi < Nz) {  // uniform across the block
      __syncthreads();         // previous plane's readers are done
      const bool zfree = zi > 0 && zi < Nz - 1;
      for (int i = tid; i < HY * HX; i += kTY * kTX) {
        const int yy = i / HX, xx = i - (i / HX) * HX;
        const int y = y0 - P + yy, x = x0 - P + xx;
        T val = T(0);
        if (zfree && y > 0 && y < Ny - 1 && x > 0 && x < Nx - 1)
          val = u[(static_cast<size_t>(zi) * Ny + y) * Nx + x];
        su[yy][xx] = val;
      }
      __syncthreads();
      for (int i = tid; i < HY * kTX; i += kTY * kTX) {
        const int yy = i / kTX, xx = i - (i / kTX) * kTX;
        const int x = x0 + xx;
        T a = T(0), kk = T(0);
        if (x < Nx) {
#pragma unroll
          for (int k = 0; k < B; ++k) {
            const T s = su[yy][xx + k];
            a += t.Mx[k * Nx + x] * s;
            kk += t.Kx[k * Nx + x] * s;
          }
        }
        sa[yy][xx] = a;
        sk[yy][xx] = kk;
      }
      __syncthreads();
      if (in_col) {
#pragma unroll
        for (int k = 0; k < B; ++k) {
          const T my = t.My[k * Ny + gy];
          const T a = sa[ty + k][tx];
          nb += my * a;
          nc += t.Ky[k * Ny + gy] * a + my * sk[ty + k][tx];
        }
      }
    }
    rb[B - 1] = nb;
    rc[B - 1] = nc;
    const int zo = zi - P;
    if (zo >= zb && zo < ze && in_col) {
      T v = T(0);
#pragma unroll
      for (int k = 0; k < B; ++k)
        v += t.Kz[k * Nz + zo] * rb[k] + t.Mz[k * Nz + zo] * rc[k];
      const size_t idx = (static_cast<size_t>(zo) * Ny + gy) * Nx + gx;
      const bool free = zo > 0 && zo < Nz - 1 && gy > 0 && gy < Ny - 1 &&
                        gx > 0 && gx < Nx - 1;
      const T av = free ? v : u[idx];
      out[idx] = mode == kResidual ? rhs[idx] - av : av;
    }
  }
}

template <typename T, int P>
void launch_p(const BandedTables<T>& t, const T* u, const T* rhs, T* out,
              int mode, cudaStream_t stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((t.Nx + kTX - 1) / kTX, (t.Ny + kTY - 1) / kTY,
                  (t.Nz + kZChunk - 1) / kZChunk);
  banded_laplace_kernel<T, P><<<grid, block, 0, stream>>>(t, u, rhs, out,
                                                          mode);
}

}  // namespace

template <typename T>
cudaError_t banded_laplace_launch(const BandedTables<T>& t, const T* u,
                                  const T* rhs, T* out, int mode,
                                  cudaStream_t stream) {
  switch (t.p) {
    case 1: launch_p<T, 1>(t, u, rhs, out, mode, stream); break;
    case 2: launch_p<T, 2>(t, u, rhs, out, mode, stream); break;
    case 3: launch_p<T, 3>(t, u, rhs, out, mode, stream); break;
    case 4: launch_p<T, 4>(t, u, rhs, out, mode, stream); break;
    case 5: launch_p<T, 5>(t, u, rhs, out, mode, stream); break;
    case 6: launch_p<T, 6>(t, u, rhs, out, mode, stream); break;
    case 7: launch_p<T, 7>(t, u, rhs, out, mode, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template cudaError_t banded_laplace_launch<float>(
    const BandedTables<float>&, const float*, const float*, float*, int,
    cudaStream_t);
template cudaError_t banded_laplace_launch<double>(
    const BandedTables<double>&, const double*, const double*, double*, int,
    cudaStream_t);

}  // namespace dat

namespace {
template <typename T>
int banded_entry(const T* u, const T* rhs, T* out, const T* Mx, const T* Kx,
                 const T* My, const T* Ky, const T* Mz, const T* Kz, int Nz,
                 int Ny, int Nx, int p, int mode, void* stream) {
  const dat::BandedTables<T> t{Mx, Kx, My, Ky, Mz, Kz, Nz, Ny, Nx, p};
  return static_cast<int>(dat::banded_laplace_launch<T>(
      t, u, rhs, out, mode, static_cast<cudaStream_t>(stream)));
}
}  // namespace

extern "C" int dat_banded_laplace_f32(const float* u, const float* rhs,
                                      float* out, const float* Mx,
                                      const float* Kx, const float* My,
                                      const float* Ky, const float* Mz,
                                      const float* Kz, int Nz, int Ny, int Nx,
                                      int p, int mode, void* stream) {
  return banded_entry<float>(u, rhs, out, Mx, Kx, My, Ky, Mz, Kz, Nz, Ny, Nx,
                             p, mode, stream);
}

extern "C" int dat_banded_laplace_f64(const double* u, const double* rhs,
                                      double* out, const double* Mx,
                                      const double* Kx, const double* My,
                                      const double* Ky, const double* Mz,
                                      const double* Kz, int Nz, int Ny, int Nx,
                                      int p, int mode, void* stream) {
  return banded_entry<double>(u, rhs, out, Mx, Kx, My, Ky, Mz, Kz, Nz, Ny,
                              Nx, p, mode, stream);
}
