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
// Bound on the H100: device-memory traffic.  The patch transforms cost
// 6 m^4 + m^3 multiply-adds per cell (3,875 at m = 5), about 15 flops per
// byte of one read of src and one write of out, under the card's float32
// balance.
//
// Design: the tiled body of fdm_tile.cuh.  A block owns a TX x TY tile of
// cells and marches through a chunk of cell layers along z (at most CZ,
// fewer on grids too small to fill the card); per layer it gathers the
// folded window of src (its cells and the lower halo cells) into shared
// memory, solves every patch of the layer once (the halo patches are the
// only recomputed ones, (TX+1)(TY+1)/(TX TY); the first layer of a chunk
// re-solves the layer below for the carry), and each owned node sums its
// contributions in a fixed order (the carry of the layer below, then the
// layer's patches by (dy, dx)) and is written once.  No atomics: repeated
// runs are bit-identical.  Six barriers per layer; at 64^3 Q4 the plan is
// 8 x 8 cells by 16 layers, 512 threads, two blocks per SM.
#include "fdm_tile.cuh"

namespace dat {
namespace {

template <typename T, int M>
struct PatchConfig {
  static constexpr TileShape S = tile_shape(kTilePatch, M, sizeof(T));
  static constexpr int TX = S.tx, TY = S.ty, CZ = S.cz, NT = S.threads;
  static constexpr int BYTES = tile_elems(kTilePatch, M, sizeof(T)) * sizeof(T);
  static constexpr int MINB = min_blocks(BYTES, NT);
};

// MOM selects the momentum epilogue at compile time, so the kScale/kUpdate
// instantiations carry no trace of it.
template <typename T, int M, bool MOM>
__global__ void __launch_bounds__(PatchConfig<T, M>::NT, PatchConfig<T, M>::MINB)
fdm_patch_kernel(FDMTables<T> t, const T* __restrict__ src,
                 const T* __restrict__ xold, T* __restrict__ out, T omega,
                 int mode, Momentum<T> mom, int chunk) {
  using C = PatchConfig<T, M>;
  using Tile = FDMTile<T, M, C::TX, C::TY, C::NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile tile;
  tile.carve(reinterpret_cast<T*>(smem_raw), Tile::BUF);
  tile.init(t);
  const int cz_begin = blockIdx.z * chunk;
  const int cz_end = t.Cz - cz_begin < chunk ? t.Cz : cz_begin + chunk;
  const int first = cz_begin > 0 ? cz_begin - 1 : 0;  // uniform
  __syncthreads();  // the tile's tables
  auto epi = [&](size_t idx, T v) {
    const T val = omega * v;
    if constexpr (MOM) {
      // p is read and written only here, by the thread that owns idx; it is
      // not read where read_p is 0 (the first sub-step: p may be garbage)
      const T pn = mom.read_p ? mom.f1 * mom.p[idx] + val : val;
      if (mom.write_p) mom.p[idx] = pn;
      out[idx] = xold != nullptr ? xold[idx] + pn : pn;
    } else {
      out[idx] = mode == kUpdate ? xold[idx] + val : val;
    }
  };
  for (int cz = first; cz < cz_end; ++cz) {
    const int par = (cz - first) & 1;
    tile.stage_layer(t, cz, par);
    tile.gather(src, t, cz);
    __syncthreads();
    tile.transforms(tile.b, par);
    tile.sum(cz, par, cz > first, cz >= cz_begin, cz == t.Cz - 1, epi);
  }
}

template <typename T, int M, bool MOM>
cudaError_t launch_m(const FDMTables<T>& t, const T* src, const T* xold,
                     T* out, T omega, int mode, const Momentum<T>& mom,
                     cudaStream_t stream) {
  using C = PatchConfig<T, M>;
  auto kern = fdm_patch_kernel<T, M, MOM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (attr != cudaSuccess) return attr;
  const int tx = (t.Cx + C::TX - 1) / C::TX, ty = (t.Cy + C::TY - 1) / C::TY;
  const int chunk = chunk_layers(tx * ty, t.Cz, C::CZ, C::MINB);
  const dim3 grid(tx, ty, (t.Cz + chunk - 1) / chunk);
  kern<<<grid, C::NT, C::BYTES, stream>>>(t, src, xold, out, omega, mode, mom,
                                          chunk);
  return cudaGetLastError();
}

template <typename T, bool MOM>
cudaError_t launch(const FDMTables<T>& t, const T* src, const T* xold, T* out,
                   T omega, int mode, const Momentum<T>& mom,
                   cudaStream_t stream) {
  switch (t.p) {
    case 1: return launch_m<T, 2, MOM>(t, src, xold, out, omega, mode, mom, stream);
    case 2: return launch_m<T, 3, MOM>(t, src, xold, out, omega, mode, mom, stream);
    case 3: return launch_m<T, 4, MOM>(t, src, xold, out, omega, mode, mom, stream);
    case 4: return launch_m<T, 5, MOM>(t, src, xold, out, omega, mode, mom, stream);
    case 5: return launch_m<T, 6, MOM>(t, src, xold, out, omega, mode, mom, stream);
    case 6: return launch_m<T, 7, MOM>(t, src, xold, out, omega, mode, mom, stream);
    case 7: return launch_m<T, 8, MOM>(t, src, xold, out, omega, mode, mom, stream);
    default: return cudaErrorInvalidValue;
  }
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

// The launch plan of kernel `kernel` (0: B, 1: C) at degree p for elements
// of itemsize bytes: out[0..4] = tile x, tile y, chunk z, threads, dynamic
// shared bytes.  kernels/fdm_patch.py::launch_plan mirrors it.
extern "C" int dat_tile_plan(int kernel, int p, int itemsize, int* out) {
  if (p < 1 || p > 7 || (kernel != dat::kTilePatch && kernel != dat::kTileStep) ||
      (itemsize != 4 && itemsize != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const dat::TileShape s = dat::tile_shape(kernel, p + 1, itemsize);
  out[0] = s.tx;
  out[1] = s.ty;
  out[2] = s.cz;
  out[3] = s.threads;
  out[4] = dat::tile_elems(kernel, p + 1, itemsize) * itemsize;
  return 0;
}
