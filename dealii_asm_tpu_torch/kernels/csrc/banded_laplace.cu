// Kernel A: separable Cartesian Laplace apply with banded 1D factors.
//
//   v = Kz My Mx u0 + Mz Ky Mx u0 + Mz My Kx u0,   u0 = free ? u : 0,
//   out = free ? v : u            (vmult, constrained rows act as identity)
//   out = rhs - (free ? v : u)    (residual epilogue)
//
// Replaces: dealii_asm_tpu/ops/pallas/dd_vmult.py F32VmultKernel (f32, the MG
// level residual) and DDVmultKernel (double-single, the outer CG matvec).
// Hopper has native float64, so one template serves both: float for the
// levels, double for the outer operator.
//
// Bound on the H100: device-memory traffic in float64, about even in
// float32.  The banded work is 7 (2p+1) multiply-adds per node (63 at
// p = 4) against one read of u (and of rhs for the residual) and one write
// of the result.
//
// Design (banded_plane.cuh): a block owns a WX x WY tile of output nodes
// and a chunk of output planes, and streams the chunk's input planes (2p
// more) through a pipeline with one barrier per plane: in the phase that
// y-bands plane z, the block also x-bands plane z + 1 and copies plane
// z + 2 (cp.async, zero where constrained) into the half of the plane
// stage that plane z left.  The x band keeps its column's Mx and Kx in
// registers; a warp is one tile row, so the y band reads each My, Ky entry
// as a broadcast and its pairs without bank conflicts; the z band is the
// scatter form in registers.  The tables of the block's columns, rows and
// planes are staged in shared memory once.  Tiles and chunks cover the
// nodes [0, N - 1) of each axis, so that no block holds a single column
// (257 = 8 x 32 + 1 at 64^3 Q4); the closing node N - 1 of an axis is
// constrained, and the last block of the axis writes it as a copy.  Each
// node is written once by the thread that owns it: no atomics, repeated
// runs bit-identical.
#include "banded_plane.cuh"

namespace dat {
namespace {

template <typename T, int P>
struct BandConfig {
  static constexpr BandShape S = band_shape(P, sizeof(T));
  static constexpr BandLayout L = band_layout(P, S);
  static constexpr int WX = S.wx, WY = S.wy, CZ = S.cz, NT = S.threads;
  static constexpr int MINB = S.minb;
  static constexpr int BYTES = band_elems(P, sizeof(T)) * sizeof(T);
};

template <typename T, int P>
__global__ void __launch_bounds__(BandConfig<T, P>::NT, BandConfig<T, P>::MINB)
banded_laplace_kernel(BandedTables<T> t, const T* __restrict__ u,
                      const T* __restrict__ rhs, T* __restrict__ out,
                      int mode, int chunk) {
  using C = BandConfig<T, P>;
  using T2 = typename Pair2<T>::type;
  constexpr int B = 2 * P + 1, WX = C::WX, WY = C::WY, NT = C::NT;
  constexpr int HY = C::L.HY, HX = C::L.HX, HXS = C::L.HXS;
  constexpr int XSZ = C::L.XSZ, SSZ = C::L.SSZ, ZT = C::L.ZT;
  constexpr int GR = NT / WX;  // thread rows
  constexpr int NR = WY / GR;  // output rows of a thread
  static_assert(WX % 32 == 0 && NT % WX == 0 && WY % GR == 0,
                "a warp must be one tile row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);        // 2 raw planes
  T2* sak = reinterpret_cast<T2*>(xs + 2 * XSZ);  // 2 x-band planes
  T* mx = reinterpret_cast<T*>(sak + 2 * SSZ);    // B x WX
  T* kx = mx + B * WX;
  T* my = kx + B * WX;  // B x WY
  T* ky = my + B * WY;
  T* mz = ky + B * WY;  // B x ZT
  T* kz = mz + B * ZT;

  const int Nz = t.Nz, Ny = t.Ny, Nx = t.Nx;
  const int tid = threadIdx.x, c = tid % WX, r0 = tid / WX;
  const int x0 = blockIdx.x * WX, y0 = blockIdx.y * WY;
  const int zb = blockIdx.z * chunk;
  // the last chunk also owns the closing plane Nz - 1
  const int ze = zb + chunk >= Nz - 1 ? Nz : zb + chunk;
  const int z0 = zb - P, zend = ze + P;  // input planes z0 .. zend - 1

  for (int i = tid; i < B * WX; i += NT) {
    const int k = i / WX, g = x0 + i % WX;
    const bool in = g < Nx;
    mx[i] = in ? t.Mx[k * Nx + g] : T(0);
    kx[i] = in ? t.Kx[k * Nx + g] : T(0);
  }
  for (int i = tid; i < B * WY; i += NT) {
    const int k = i / WY, g = y0 + i % WY;
    const bool in = g < Ny;
    my[i] = in ? t.My[k * Ny + g] : T(0);
    ky[i] = in ? t.Ky[k * Ny + g] : T(0);
  }
  // entry zo - (zb - 2P) of row k: the chunk's own output planes only
  for (int i = tid; i < B * ZT; i += NT) {
    const int k = i / ZT, zo = zb - 2 * P + i % ZT;
    const bool in = zo >= zb && zo < ze;
    mz[i] = in ? t.Mz[k * Nz + zo] : T(0);
    kz[i] = in ? t.Kz[k * Nz + zo] : T(0);
  }

  auto h = [&](int z) { return (z - z0) & 1; };  // half of the stage
  auto live = [&](int z) {  // u0 is zero on constrained planes
    return z > 0 && z < Nz - 1 && z < zend;
  };
  auto fetch = [&](int z) {
    if (!live(z)) return;
    const T* plane = u + static_cast<size_t>(z) * Ny * Nx;
    T* dst = xs + h(z) * XSZ;
    for (int i = tid; i < HY * HX; i += NT) {
      const int r = i / HX, cc = i - r * HX;
      const int gy = y0 - P + r, gx = x0 - P + cc;
      const bool in = gy > 0 && gy < Ny - 1 && gx > 0 && gx < Nx - 1;
      copy_async(dst + r * HXS + cc,
                 in ? plane + static_cast<size_t>(gy) * Nx + gx : plane, in);
    }
  };
  T mr[B], kr[B];  // the x band's column, set after the first barrier
  auto xband = [&](int z) {
    if (!live(z)) return;
    const T* xp = xs + h(z) * XSZ;
    T2* sa = sak + h(z) * SSZ;
    for (int r = r0; r < HY; r += GR) {
      T s = T(0), q = T(0);
#pragma unroll
      for (int k = 0; k < B; ++k) {
        const T v = xp[r * HXS + c + k];
        s += mr[k] * v;
        q += kr[k] * v;
      }
      sa[r * WX + c] = T2{s, q};
    }
  };
  T acc[NR][B];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) acc[i][j] = T(0);
  auto emit = [&](int zo, int wy, T v) {
    const int gy = y0 + wy, gx = x0 + c;
    if (gy >= Ny || gx >= Nx) return;
    const size_t idx = (static_cast<size_t>(zo) * Ny + gy) * Nx + gx;
    const bool free = zo > 0 && zo < Nz - 1 && gy > 0 && gy < Ny - 1 &&
                      gx > 0 && gx < Nx - 1;
    const T av = free ? v : u[idx];
    out[idx] = mode == kResidual ? rhs[idx] - av : av;
  };
  // y band of plane z and its z band; output plane z - P is complete after
  auto ybandz = [&](int z) {
    if (live(z)) {
      const T2* sa = sak + h(z) * SSZ;
      T kzc[B], mzc[B];  // plane z's weight in output plane z - P + j
#pragma unroll
      for (int j = 0; j < B; ++j) {
        kzc[j] = kz[(2 * P - j) * ZT + z - zb + P + j];
        mzc[j] = mz[(2 * P - j) * ZT + z - zb + P + j];
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int wy = r0 + i * GR;
        T nb = T(0), nc = T(0);
#pragma unroll
        for (int k = 0; k < B; ++k) {
          const T2 a = sa[(wy + k) * WX + c];
          const T m = my[k * WY + wy];
          nb += m * a.x;
          nc += ky[k * WY + wy] * a.x + m * a.y;
        }
        zband_push(acc[i], nb, nc, kzc, mzc);
      }
    }
    const int zo = z - P;
    const bool own = zo >= zb && zo < ze;  // uniform
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const T v = zband_pop(acc[i]);
      if (own) emit(zo, r0 + i * GR, v);
    }
  };

  fetch(z0);
  fetch(z0 + 1);
  copy_async_wait();
  __syncthreads();  // plane z0 and the tables
#pragma unroll
  for (int k = 0; k < B; ++k) {
    mr[k] = mx[k * WX + c];
    kr[k] = kx[k * WX + c];
  }
  xband(z0);
  for (int z = z0; z < zend; ++z) {
    copy_async_wait();
    __syncthreads();
    fetch(z + 2);  // into the half plane z left (x-banded before the barrier)
    xband(z + 1);  // its copy was waited for above
    ybandz(z);     // its x band was written before the barrier
  }

  // the closing column and row where they lie just outside the tile: both
  // constrained, so copies
  const bool ex = x0 + WX == Nx - 1, ey = y0 + WY == Ny - 1;
  if (ex || ey) {
    const int ncol = ex ? min(WY, Ny - y0) + (ey ? 1 : 0) : 0;
    const int per = ncol + (ey ? min(WX, Nx - x0) : 0);
    for (int i = tid; i < (ze - zb) * per; i += NT) {
      const int zo = zb + i / per, e = i % per;
      const int gy = e < ncol ? y0 + e : Ny - 1;
      const int gx = e < ncol ? Nx - 1 : x0 + e - ncol;
      const size_t idx = (static_cast<size_t>(zo) * Ny + gy) * Nx + gx;
      out[idx] = mode == kResidual ? rhs[idx] - u[idx] : u[idx];
    }
  }
}

template <typename T, int P>
cudaError_t launch_p(const BandedTables<T>& t, const T* u, const T* rhs,
                     T* out, int mode, cudaStream_t stream) {
  using C = BandConfig<T, P>;
  auto kern = banded_laplace_kernel<T, P>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (attr != cudaSuccess) return attr;
  // tiles of the nodes [0, N - 1) of each axis
  const int bx = (t.Nx - 2) / C::WX + 1, by = (t.Ny - 2) / C::WY + 1;
  const int chunk = chunk_layers(bx * by, t.Nz - 1, C::CZ, C::MINB);
  const dim3 grid(bx, by, (t.Nz - 2) / chunk + 1);
  kern<<<grid, C::NT, C::BYTES, stream>>>(t, u, rhs, out, mode, chunk);
  return cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t banded_laplace_launch(const BandedTables<T>& t, const T* u,
                                  const T* rhs, T* out, int mode,
                                  cudaStream_t stream) {
  if (t.Nx < 2 || t.Ny < 2 || t.Nz < 2) return cudaErrorInvalidValue;
  switch (t.p) {
    case 1: return launch_p<T, 1>(t, u, rhs, out, mode, stream);
    case 2: return launch_p<T, 2>(t, u, rhs, out, mode, stream);
    case 3: return launch_p<T, 3>(t, u, rhs, out, mode, stream);
    case 4: return launch_p<T, 4>(t, u, rhs, out, mode, stream);
    case 5: return launch_p<T, 5>(t, u, rhs, out, mode, stream);
    case 6: return launch_p<T, 6>(t, u, rhs, out, mode, stream);
    case 7: return launch_p<T, 7>(t, u, rhs, out, mode, stream);
    default: return cudaErrorInvalidValue;
  }
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

// Kernel A's launch plan at degree p for elements of itemsize bytes:
// out[0..4] = tile x, tile y, most planes a block, threads, dynamic shared
// bytes.  kernels/banded_laplace.py::launch_plan mirrors it.
extern "C" int dat_band_plan(int p, int itemsize, int* out) {
  if (p < 1 || p > 7 || (itemsize != 4 && itemsize != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const dat::BandShape s = dat::band_shape(p, itemsize);
  out[0] = s.wx;
  out[1] = s.wy;
  out[2] = s.cz;
  out[3] = s.threads;
  out[4] = dat::band_elems(p, itemsize) * itemsize;
  return 0;
}
