// Kernel C: one smoother step  x' = x + omega * P^-1 (b - A x)  in one pass.
//
// Replaces: dealii_asm_tpu/ops/pallas/smoother_step.py SmootherStepKernel
// (step / step_padded).  The TPU kernel runs its P^-1 transforms in bfloat16;
// here the whole step is float32 (or float64), the same function as the
// composition of kernels A (residual) and B (update).
//
// Bound on the H100: about equal in operations and bytes at Q4 float32.
// Per node A's 7 (2p+1) multiply-adds and B's 6 m^4 + m^3 per cell, against
// three grid streams (x and b in, x' out): the residual r never reaches
// device memory, where kernel A then kernel B move five.
//
// Design: B's tiled body (fdm_tile.cuh) fed by a residual stage on chip.  A
// block owns a TX x TY tile of cells and a chunk of cell layers, and needs
// r on the window of its cells plus the lower halo cells.  It streams the x
// planes of the chunk (with the z band of 2p planes around it) through
// shared memory: per plane it copies x with a p-node halo in x and y
// (cp.async, zero where constrained: u0), applies Mx and Kx along x, then My
// and Ky along y, and pushes the pair (My Mx u0, Ky Mx u0 + My Kx u0) into a
// ring of 2p+1 planes; once the ring holds the band of an r plane, the z
// contraction gives r = b - A u0 at the free nodes, folded by fin, into a
// window of m planes (constrained nodes: fin is zero there, so they keep
// x).  The stages overlap as a pipeline: the phase that y-bands plane z
// also x-bands plane z + 1 and copies plane z + 2, one barrier per plane.
// When the m planes of a cell layer are complete, the FDM body solves the
// layer's patches and the kUpdate epilogue writes x' = x + omega * P^-1 r
// at the owned nodes; the window's upper plane is the next layer's lower
// one.  A thread keeps the same window nodes for the y band, the ring and
// the z contraction, so those need no barrier.  Rounding: the same float
// products as A then B, summed in another order.
#include "banded_plane.cuh"

namespace dat {
namespace {

template <typename T, int M>
struct StepConfig {
  static constexpr TileShape S = tile_shape(kTileStep, M, sizeof(T));
  static constexpr int TX = S.tx, TY = S.ty, CZ = S.cz, NT = S.threads;
  static constexpr TileLayout L = tile_layout(M, S);
  static constexpr int HY = L.HY, HX = L.HX, HXS = L.HXS;
  static constexpr int BUFB = imax(L.BUF, L.STAGE);
  static constexpr int RWSZ = pad4(M * L.NY * L.NXS);  // the r window
  static constexpr int BYTES = tile_elems(kTileStep, M, sizeof(T)) * sizeof(T);
  static constexpr int MINB = min_blocks(BYTES, NT);
};

template <typename T, int M>
__global__ void __launch_bounds__(StepConfig<T, M>::NT, StepConfig<T, M>::MINB)
smoother_step_kernel(BandedTables<T> at, FDMTables<T> t,
                     const T* __restrict__ x, const T* __restrict__ b,
                     T* __restrict__ out, T omega, int chunk) {
  using C = StepConfig<T, M>;
  using Tile = FDMTile<T, M, C::TX, C::TY, C::NT>;
  constexpr int P = M - 1, B = 2 * P + 1, NT = C::NT;
  constexpr int NX = Tile::NX, NY = Tile::NY, NXS = Tile::NXS;
  constexpr int HY = C::HY, HX = C::HX, HXS = C::HXS;
  constexpr int GX = NT / NX;   // x band: thread groups of NX columns
  constexpr int TPR = NT / NY;  // y band: threads per window row
  static_assert(GX >= 1 && TPR >= 1, "a tile wider than its threads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile tile;
  T* p = tile.carve(reinterpret_cast<T*>(smem_raw), C::BUFB);
  // the plane stage lives in buffer b, free while no layer is solved: two
  // halves, each an x plane with the band halo (HY x HXS) and its x band
  // (Mx u0 and Kx u0, HY x NXS each)
  using T2 = typename Pair2<T>::type;
  constexpr int XSZ = C::L.XSZ, SKO = HY * NXS, RWSZ = C::RWSZ;
  T* xs = tile.b;
  T2* sak = reinterpret_cast<T2*>(xs + 2 * XSZ);  // (Mx u0, Kx u0) pairs
  T* rw = p;                   // r window, M x NY x NXS
  p += RWSZ;
  T2* ring = reinterpret_cast<T2*>(p);  // B planes of NY x NX pairs
  p += 2 * B * NY * NX;
  T* mx = p;                   // banded tables of the window's nodes
  p += B * NX;
  T* kx = p;
  p += B * NX;
  T* my = p;
  p += B * NY;
  T* ky = p;

  const int tid = threadIdx.x;
  tile.init(t);
  const int Nz = t.Cz * P + 1, Ny = tile.Ny, Nx = tile.Nx;
  const int cx0 = tile.cx0, cy0 = tile.cy0;
  const int cz_begin = blockIdx.z * chunk;
  const int cz_end = t.Cz - cz_begin < chunk ? t.Cz : cz_begin + chunk;
  const int first = cz_begin > 0 ? cz_begin - 1 : 0;  // uniform
  const int zlo = first * P;  // the chunk's first r plane
  // (the first pipeline barrier comes before any table below is read)
  for (int i = tid; i < B * NX; i += NT) {
    const int k = i / NX, g = (cx0 - 1) * P + i % NX;
    const bool in = g >= 0 && g < Nx;
    mx[i] = in ? at.Mx[k * Nx + g] : T(0);
    kx[i] = in ? at.Kx[k * Nx + g] : T(0);
  }
  for (int i = tid; i < B * NY; i += NT) {
    const int k = i / NY, g = (cy0 - 1) * P + i % NY;
    const bool in = g >= 0 && g < Ny;
    my[i] = in ? at.My[k * Ny + g] : T(0);
    ky[i] = in ? at.Ky[k * Ny + g] : T(0);
  }

  // The residual streams the x planes through a two-phase pipeline: in the
  // phase that y-bands plane z (the y band, the ring push and the z
  // contraction), the x band of plane z + 1 and the copy of plane z + 2
  // (cp.async) run too, so that one barrier per plane separates them.
  // Plane z takes half h(z) of the stage.
  const int z0 = zlo - P;  // the chunk's first x plane
  auto h = [&](int z) { return (z - z0) & 1; };
  auto live = [&](int z) { return z > 0 && z < Nz - 1; };  // u0 is zero else
  auto fetch = [&](int z) {
    if (!live(z)) return;
    const T* plane = x + static_cast<size_t>(z) * Ny * Nx;
    T* dst = xs + h(z) * XSZ;
    for (int i = tid; i < HY * HX; i += NT) {
      const int r = i / HX, c = i - r * HX;
      const int gy = (cy0 - 2) * P + r, gx = (cx0 - 2) * P + c;
      const bool in = gy > 0 && gy < Ny - 1 && gx > 0 && gx < Nx - 1;
      copy_async(dst + r * HXS + c,
                 in ? plane + static_cast<size_t>(gy) * Nx + gx : plane, in);
    }
  };
  // x band: a thread keeps one column and its band in registers
  auto xband = [&](int z) {
    if (!live(z) || tid >= GX * NX) return;
    const T* xp = xs + h(z) * XSZ;
    T2* sa = sak + h(z) * SKO;
    const int c = tid % NX;
    T mr[B], kr[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      mr[k] = mx[k * NX + c];
      kr[k] = kx[k * NX + c];
    }
    for (int r = tid / NX; r < HY; r += GX) {
      T s = T(0), q = T(0);
#pragma unroll
      for (int k = 0; k < B; ++k) {
        const T u = xp[r * HXS + c + k];
        s += mr[k] * u;
        q += kr[k] * u;
      }
      sa[r * NXS + c] = T2{s, q};
    }
  };
  // y band of plane z into the ring; with j >= 0 also the z contraction of
  // r plane z - P into window plane j (after moving plane P to plane 0 when
  // shift).  A thread keeps one window row (its band in registers) and the
  // same nodes of it every plane, so the ring needs no barrier.
  int slot = 0;  // ring slot of the next plane
  auto yband = [&](int z, int j, bool shift) {
    const int sl = slot;
    slot = slot + 1 == B ? 0 : slot + 1;
    if (tid >= TPR * NY) return;
    const bool zlive = live(z);
    const T2* sa = sak + h(z) * SKO;
    const int wy = tid / TPR;
    const int zo = z - P;
    const int gy = (cy0 - 1) * P + wy;
    const bool yfree = zo > 0 && zo < Nz - 1 && gy > 0 && gy < Ny - 1;
    T kzr[B], mzr[B], fzy = T(0);
    if (j >= 0) {
#pragma unroll
      for (int k = 0; k < B; ++k) {
        kzr[k] = at.Kz[k * Nz + zo];
        mzr[k] = at.Mz[k * Nz + zo];
      }
      fzy = t.fin_z[zo] * tile.finy[wy];
    }
    T myr[B], kyr[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      myr[k] = my[k * NY + wy];
      kyr[k] = ky[k * NY + wy];
    }
    for (int wx = tid % TPR; wx < NX; wx += TPR) {
      const int idx = wy * NX + wx;
      const int gx = (cx0 - 1) * P + wx;
      // r matters at free nodes only: fin is zero at the others
      const bool free = j >= 0 && yfree && gx > 0 && gx < Nx - 1;
      const T bv = free ? b[(static_cast<size_t>(zo) * Ny + gy) * Nx + gx]
                        : T(0);
      T nb = T(0), nc = T(0);
      if (zlive) {
#pragma unroll
        for (int k = 0; k < B; ++k) {
          const T2 a = sa[(wy + k) * NXS + wx];
          nb += myr[k] * a.x;
          nc += kyr[k] * a.x + myr[k] * a.y;
        }
      }
      ring[sl * NY * NX + idx] = T2{nb, nc};
      if (j < 0) continue;
      if (shift) rw[wy * NXS + wx] = rw[(P * NY + wy) * NXS + wx];
      T r = T(0);
      if (free) {
        // planes zo - P .. zo + P sit in slots sl + 1 .. sl + B (mod B)
        T v = T(0);
#pragma unroll
        for (int k = 0; k < B; ++k) {
          int s = sl + 1 + k;
          s = s >= B ? s - B : s;
          const T2 q = ring[s * NY * NX + idx];
          v += kzr[k] * q.x + mzr[k] * q.y;
        }
        r = (bv - v) * fzy * tile.finx[wx];
      }
      rw[(j * NY + wy) * NXS + wx] = r;
    }
  };
  int zy = z0;  // the next plane to y-band; plane zy + 1 is x-banded, or
                // copied when a layer's solve came between
  // One pipeline phase: y band of zy, x band of zy + 1 (xnext), copy of
  // zy + 2 into the half zy leaves (fetchnext).
  auto phase = [&](int j, bool shift, bool xnext, bool fetchnext) {
    copy_async_wait();
    __syncthreads();
    if (fetchnext) fetch(zy + 2);
    if (xnext) xband(zy + 1);
    yband(zy, j, shift);
    ++zy;
  };

  fetch(z0);
  fetch(z0 + 1);
  copy_async_wait();
  __syncthreads();  // plane z0 and the tables
  xband(z0);
  // the ring's first 2P planes: zlo - P .. zlo + P - 1
  for (int k = 0; k < 2 * P; ++k) phase(-1, false, true, true);
  for (int cz = first; cz < cz_end; ++cz) {
    const int par = (cz - first) & 1;
    tile.stage_layer(t, cz, par);
    // r planes cz * P + j; buffer b must hold no plane across the solve
    for (int j = cz == first ? 0 : 1; j <= P; ++j)
      phase(j, j == 1 && cz != first, j < P, j + 1 < P);
    __syncthreads();
    tile.transforms(rw, par);
    const bool more = cz + 1 < cz_end;
    if (more) {  // buffer b is free again: the next layer's first planes
      fetch(zy);
      fetch(zy + 1);
    }
    tile.sum(cz, par, cz > first, cz >= cz_begin, cz == t.Cz - 1,
             [&](size_t idx, T v) { out[idx] = x[idx] + omega * v; });
    if (more) {
      copy_async_wait();
      __syncthreads();
      xband(zy);
    }
  }
}

template <typename T, int M>
cudaError_t launch_m(const BandedTables<T>& a, const FDMTables<T>& t,
                     const T* x, const T* b, T* out, T omega,
                     cudaStream_t stream) {
  using C = StepConfig<T, M>;
  auto kern = smoother_step_kernel<T, M>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (attr != cudaSuccess) return attr;
  const int tx = (t.Cx + C::TX - 1) / C::TX, ty = (t.Cy + C::TY - 1) / C::TY;
  const int chunk = chunk_layers(tx * ty, t.Cz, C::CZ, C::MINB);
  const dim3 grid(tx, ty, (t.Cz + chunk - 1) / chunk);
  kern<<<grid, C::NT, C::BYTES, stream>>>(a, t, x, b, out, omega, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t step_launch(const BandedTables<T>& a, const FDMTables<T>& t,
                        const T* x, const T* b, T* out, T omega,
                        cudaStream_t stream) {
  switch (t.p) {
    case 1: return launch_m<T, 2>(a, t, x, b, out, omega, stream);
    case 2: return launch_m<T, 3>(a, t, x, b, out, omega, stream);
    case 3: return launch_m<T, 4>(a, t, x, b, out, omega, stream);
    case 4: return launch_m<T, 5>(a, t, x, b, out, omega, stream);
    case 5: return launch_m<T, 6>(a, t, x, b, out, omega, stream);
    case 6: return launch_m<T, 7>(a, t, x, b, out, omega, stream);
    case 7: return launch_m<T, 8>(a, t, x, b, out, omega, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int step_entry(const T* x, const T* b, T* out, const T* Mx, const T* Kx,
               const T* My, const T* Ky, const T* Mz, const T* Kz,
               const T* Vx, const T* Vy, const T* Vz, const T* lx,
               const T* ly, const T* lz, const T* fin_x, const T* fin_y,
               const T* fin_z, const T* fout_x, const T* fout_y,
               const T* fout_z, int Cz, int Cy, int Cx, int p, T omega,
               void* stream) {
  const BandedTables<T> a{Mx, Kx, My, Ky, Mz, Kz,
                          Cz * p + 1, Cy * p + 1, Cx * p + 1, p};
  const FDMTables<T> f{Vx,    Vy,    Vz,     lx,     ly,     lz,
                       fin_x, fin_y, fin_z,  fout_x, fout_y, fout_z,
                       Cz,    Cy,    Cx,     p};
  return static_cast<int>(step_launch<T>(a, f, x, b, out, omega,
                                         static_cast<cudaStream_t>(stream)));
}

}  // namespace
}  // namespace dat

extern "C" int dat_smoother_step_f32(
    const float* x, const float* b, float* out, const float* Mx,
    const float* Kx, const float* My, const float* Ky, const float* Mz,
    const float* Kz, const float* Vx, const float* Vy, const float* Vz,
    const float* lx, const float* ly, const float* lz, const float* fin_x,
    const float* fin_y, const float* fin_z, const float* fout_x,
    const float* fout_y, const float* fout_z, int Cz, int Cy, int Cx, int p,
    float omega, void* stream) {
  return dat::step_entry<float>(x, b, out, Mx, Kx, My, Ky, Mz, Kz, Vx, Vy,
                                Vz, lx, ly, lz, fin_x, fin_y, fin_z, fout_x,
                                fout_y, fout_z, Cz, Cy, Cx, p, omega, stream);
}

extern "C" int dat_smoother_step_f64(
    const double* x, const double* b, double* out, const double* Mx,
    const double* Kx, const double* My, const double* Ky, const double* Mz,
    const double* Kz, const double* Vx, const double* Vy, const double* Vz,
    const double* lx, const double* ly, const double* lz, const double* fin_x,
    const double* fin_y, const double* fin_z, const double* fout_x,
    const double* fout_y, const double* fout_z, int Cz, int Cy, int Cx, int p,
    double omega, void* stream) {
  return dat::step_entry<double>(x, b, out, Mx, Kx, My, Ky, Mz, Kz, Vx, Vy,
                                 Vz, lx, ly, lz, fin_x, fin_y, fin_z, fout_x,
                                 fout_y, fout_z, Cz, Cy, Cx, p, omega, stream);
}
