// Kernel G: element-centric overlap-1 FDM Schwarz apply with per-cell
// tables, on a deformed structured mesh,
//
//   out = P^-1 src
//   P^-1 = sum over cells c of  R_c^T Fout (Vz_c x Vy_c x Vx_c)
//              diag(1/(lz_c+ly_c+lx_c)) (Vz_c x Vy_c x Vx_c)^T Fin R_c
//
// with the M-orthonormal eigenvectors V and eigenvalues lam of each cell's
// own 1D patch problems (precond/asm.py::CellASMPreconditioner), and the
// multiplicity weights and Dirichlet masks folded per axis into Fin / Fout
// (weighting none/pre/post/symm).
//
// Replaces no TPU kernel: the JAX package applies these tables with an XLA
// einsum (dealii_asm_tpu/precond/asm.py::_fdm_apply); the port's plain
// version is CellASMPreconditioner's chain of windows, batched per-cell
// products and overlap-add.
//
// Bound on the H100: device-memory traffic.  Per cell one read of src and
// one write of out (p^3 nodes each), the three m x m eigenvector blocks and
// 3m eigenvalues; 6 m^4 + m^3 multiply-adds.
//
// Design: kernel B's tile walk (fdm_tile.cuh) with per-cell tables.  A
// block owns a TX x TY tile of cells and marches through a chunk of cell
// layers along z; per layer it stages the eigenvector blocks and
// eigenvalues of the layer's (TX+1)(TY+1) patches (its cells and the lower
// x/y halo cells, whose patches are the only recomputed ones) and the
// folded window of src in shared memory, solves every patch of the layer
// (each transform stage maps one thread to one line of m values of one
// patch), and sums each owned node's contributions in a fixed order: the
// carry of the layer below, then the layer's patches by (dy, dx), lower
// cell first.  Each owned node is written once; no atomics, so repeated
// runs are bit-identical.  Unlike B, the first transform cannot share a
// window row between the patches of two y cells (their Vx differ), so
// every transform stage works on per-patch lines (rows (cell y, slot)).
// The eigenvalue sums are formed on chip, (lz + ly) + lx in T, as
// precond/asm.py::cell_fdm_tables adds them, then the correctly rounded
// reciprocal, so the (P, m^3) table of reciprocal sums is never read.
#include "fdm_tile.cuh"

namespace dat {

// Per-cell tables (m = p + 1; cells numbered x fastest): V[c * m * m +
// s * m + k] (node s, mode k) per direction; lam[(c * 3 + d) * m + k] for
// direction d (x, y, z); fin/fout the per-axis folds.
template <typename T>
struct CellFDMTables {
  const T* Vx;
  const T* Vy;
  const T* Vz;
  const T* lam;
  const T* fin_x;
  const T* fin_y;
  const T* fin_z;
  const T* fout_x;
  const T* fout_y;
  const T* fout_z;
  int Cz, Cy, Cx;
  int p;
};

// tx x ty cells per block, at most cz cell layers per block, threads, as
// kernels/cell_fdm_patch.py::launch_plan mirrors them; chosen by timing
// variants at 48^3 cells Q4, Q2 and Q1 in float32 on the H100
// (tools/tile_sweep.py g, PERF.md); m = 4 and 6..8 take m = 5's tile
constexpr TileShape cell_tile_shape(int m, int itemsize) {
  switch (m) {
    case 2: return {8, 8, 16, 128};
    case 3: return {8, 8, 16, 256};
    case 8: return itemsize == 4 ? TileShape{4, 4, 16, 256}
                                 : TileShape{4, 2, 16, 256};
    default: return {4, 4, 16, 256};
  }
}

// Shared-memory layout of one tile, in elements.
struct CellLayout {
  int NX, NY, NXS, LX, LXS, LY, OX, OY, NPT;
  int VTAB;    // the three eigenvector blocks of every patch of a layer
  int BUF;     // one transform buffer: M x LY x LXS, padded
  int TABLES;  // carry, eigenvalues, folds
};

constexpr CellLayout cell_layout(int m, TileShape s) {
  const int P = m - 1;
  const int NX = (s.tx + 1) * P + 1, NY = (s.ty + 1) * P + 1;
  const int LX = (s.tx + 1) * m, LY = (s.ty + 1) * m;
  const int OX = s.tx * P + 1, OY = s.ty * P + 1;
  const int NPT = (s.tx + 1) * (s.ty + 1);
  return CellLayout{NX, NY, odd(NX), LX, odd(LX), LY, OX, OY, NPT,
                    3 * NPT * m * vrow(m), pad4(m * LY * odd(LX)),
                    // carry; lam; fin x, y; fout x, y, z
                    pad4(OY * OX + 3 * NPT * m + NX + NY + OX + OY + m)};
}

constexpr int cell_elems(int m, int itemsize) {
  const CellLayout L = cell_layout(m, cell_tile_shape(m, itemsize));
  return L.VTAB + 2 * L.BUF + L.TABLES;
}

// Cell layers a block marches through: of 1 .. cz, the chunk that gives
// the fewest waves of blocks (sms SMs holding blocks_per_sm each) times
// the layers a block solves (its own and the one below), the larger on a
// tie.  B's rule (chunk_layers: the largest chunk that fills 90% of one
// wave) can leave a second wave a tenth full, which on the Kershaw levels
// costs a third of the time (PERF.md).
inline int cell_chunk_layers(int tiles, int Cz, int cz, int blocks_per_sm) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  const long slots = static_cast<long>(sms) * blocks_per_sm;
  int best = 1;
  long best_cost = -1;
  for (int c = 1; c <= cz && c <= Cz; ++c) {
    const long blocks = static_cast<long>(tiles) * ((Cz + c - 1) / c);
    const long cost = (blocks + slots - 1) / slots * (c < Cz ? c + 1 : c);
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = c;
    }
  }
  return best;
}

namespace {

template <typename T, int M>
struct CellConfig {
  static constexpr TileShape S = cell_tile_shape(M, sizeof(T));
  static constexpr int TX = S.tx, TY = S.ty, CZ = S.cz, NT = S.threads;
  static constexpr int BYTES = cell_elems(M, sizeof(T)) * sizeof(T);
  static constexpr int MINB = min_blocks(BYTES, NT);
};

template <typename T, int M, int TX, int TY, int NT>
struct CellTile {
  static constexpr CellLayout L = cell_layout(M, TileShape{TX, TY, 1, NT});
  static constexpr int P = M - 1;
  static constexpr int NX = L.NX, NY = L.NY, NXS = L.NXS;
  static constexpr int LX = L.LX, LXS = L.LXS, LY = L.LY;
  static constexpr int OX = L.OX, OY = L.OY, NPT = L.NPT;
  static constexpr int MP = vrow(M), VM = M * MP;  // V row stride, one V

  T *vx, *vy, *vz;  // per patch (cell y * (TX+1) + cell x), VM each
  T* a;             // transform buffers, M x LY x LXS each
  T* b;
  T* carry;  // upper node plane of the last layer, OY x OX
  T *lam, *finx, *finy, *foutx, *fouty, *foutz;
  int cx0, cy0;  // the tile's first own cell; its halo cell is one lower
  int ox, oy;    // owned node columns (fewer in a ragged tile)
  int Cx, Cy, Nx, Ny;

  static __device__ __forceinline__ T backward(const T* row, const T (&v)[M]) {
    T r[M];
    load_row<T, M>(row, r);
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j) acc += r[j] * v[j];
    return acc;
  }

  static __device__ __forceinline__ void forward(const T* V, const T (&v)[M],
                                                 T (&o)[M]) {
#pragma unroll
    for (int k = 0; k < M; ++k) o[k] = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T row[M];
      load_row<T, M>(V + j * MP, row);
#pragma unroll
      for (int k = 0; k < M; ++k) o[k] += row[k] * v[j];
    }
  }

  __device__ void carve(T* p) {
    vx = p;
    vy = vx + NPT * VM;
    vz = vy + NPT * VM;
    a = p + L.VTAB;
    b = a + L.BUF;
    carry = b + L.BUF;
    lam = carry + OY * OX;
    finx = lam + 3 * NPT * M;
    finy = finx + NX;
    foutx = finy + NY;
    fouty = foutx + OX;
    foutz = fouty + OY;
  }

  // The tile's place and its x/y folds; the caller syncs before use.
  __device__ void init(const CellFDMTables<T>& t) {
    const int tid = threadIdx.x;
    Cx = t.Cx;
    Cy = t.Cy;
    Nx = Cx * P + 1;
    Ny = Cy * P + 1;
    cx0 = blockIdx.x * TX;
    cy0 = blockIdx.y * TY;
    const int ncx = Cx - cx0 < TX ? Cx - cx0 : TX;
    const int ncy = Cy - cy0 < TY ? Cy - cy0 : TY;
    ox = ncx * P + (cx0 + ncx == Cx ? 1 : 0);
    oy = ncy * P + (cy0 + ncy == Cy ? 1 : 0);
    for (int i = tid; i < NX; i += NT) {
      const int g = (cx0 - 1) * P + i;
      finx[i] = g >= 0 && g < Nx ? t.fin_x[g] : T(0);
    }
    for (int i = tid; i < NY; i += NT) {
      const int g = (cy0 - 1) * P + i;
      finy[i] = g >= 0 && g < Ny ? t.fin_y[g] : T(0);
    }
    for (int i = tid; i < OX; i += NT) {
      const int g = cx0 * P + i;
      foutx[i] = g < Nx ? t.fout_x[g] : T(0);
    }
    for (int i = tid; i < OY; i += NT) {
      const int g = cy0 * P + i;
      fouty[i] = g < Ny ? t.fout_y[g] : T(0);
    }
  }

  // Layer cz's tables: the three eigenvector blocks (rows padded to MP)
  // and eigenvalues of each patch, V = 0 and lambda = 1 for a cell outside
  // the mesh (a zero patch); the z output folds.
  __device__ void stage(const CellFDMTables<T>& t, int cz) {
    const int tid = threadIdx.x;
    const size_t layer = static_cast<size_t>(cz) * Cy;
    for (int i = tid; i < NPT * M * M; i += NT) {
      const int pi = i / (M * M), e = i - pi * (M * M);
      const int s = e / M, k = e - s * M;
      const int cy = pi / (TX + 1), cx = pi - cy * (TX + 1);
      const int gy = cy0 - 1 + cy, gx = cx0 - 1 + cx;
      const bool in = gy >= 0 && gy < Cy && gx >= 0 && gx < Cx;
      const size_t g = ((layer + gy) * Cx + gx) * (M * M) + e;
      const int d = pi * VM + s * MP + k;
      vx[d] = in ? t.Vx[g] : T(0);
      vy[d] = in ? t.Vy[g] : T(0);
      vz[d] = in ? t.Vz[g] : T(0);
    }
    for (int i = tid; i < NPT * 3 * M; i += NT) {
      const int pi = i / (3 * M), e = i - pi * (3 * M);
      const int cy = pi / (TX + 1), cx = pi - cy * (TX + 1);
      const int gy = cy0 - 1 + cy, gx = cx0 - 1 + cx;
      const bool in = gy >= 0 && gy < Cy && gx >= 0 && gx < Cx;
      lam[i] = in ? t.lam[((layer + gy) * Cx + gx) * (3 * M) + e] : T(1);
    }
    for (int i = tid; i < M; i += NT) foutz[i] = t.fout_z[cz * P + i];
  }

  // Layer cz's window of src, folded by fin, into b (M x NY x NXS); zero
  // outside the grid.
  __device__ void gather(const T* __restrict__ src, const CellFDMTables<T>& t,
                         int cz) {
    const int tid = threadIdx.x;
    for (int z = 0; z < M; ++z) {
      const int gz = cz * P + z;
      const T fz = t.fin_z[gz];
      const T* plane = src + static_cast<size_t>(gz) * Ny * Nx;
      for (int i = tid; i < NY * NX; i += NT) {
        const int wy = i / NX, wx = i - wy * NX;
        const int gy = (cy0 - 1) * P + wy, gx = (cx0 - 1) * P + wx;
        T v = T(0);
        if (gy >= 0 && gy < Ny && gx >= 0 && gx < Nx)
          v = plane[static_cast<size_t>(gy) * Nx + gx] * fz * finy[wy] *
              finx[wx];
        b[(z * NY + wy) * NXS + wx] = v;
      }
    }
  }

  // The five transform stages of one layer from the folded window in b:
  // forward x, y, z with the eigenvalue scale, backward x, y.  Leaves the
  // patches' backward-y result in a, laid out (kz, cell y * M + sy, cell x
  // * M + sx); ends on a barrier.
  __device__ void transforms() {
    const int tid = threadIdx.x;
    // forward x: b -> a (z, cell y * M + sy, cell x * M + kx); lines
    // (z, cell x, row)
    for (int l = tid; l < M * (TX + 1) * LY; l += NT) {
      const int row = l % LY, q = l / LY, c = q % (TX + 1), z = q / (TX + 1);
      const int cy = row / M, wy = row - cy * M + cy * P;
      const T* in = b + (z * NY + wy) * NXS + c * P;
      T v[M], o[M];
#pragma unroll
      for (int j = 0; j < M; ++j) v[j] = in[j];
      forward(vx + (cy * (TX + 1) + c) * VM, v, o);
      T* out = a + (z * LY + row) * LXS + c * M;
#pragma unroll
      for (int k = 0; k < M; ++k) out[k] = o[k];
    }
    __syncthreads();
    // forward y: a -> b (z, cell y * M + ky, col); lines (z, cell y, col)
    for (int l = tid; l < M * (TY + 1) * LX; l += NT) {
      const int col = l % LX, q = l / LX, c = q % (TY + 1), z = q / (TY + 1);
      const T* in = a + (z * LY + c * M) * LXS + col;
      T v[M], o[M];
#pragma unroll
      for (int j = 0; j < M; ++j) v[j] = in[j * LXS];
      forward(vy + (c * (TX + 1) + col / M) * VM, v, o);
      T* out = b + (z * LY + c * M) * LXS + col;
#pragma unroll
      for (int k = 0; k < M; ++k) out[k * LXS] = o[k];
    }
    __syncthreads();
    // forward z and the scale: b -> a (kz, row, col); lines (row, col)
    for (int l = tid; l < LY * LX; l += NT) {
      const int col = l % LX, row = l / LX;
      const int cx = col / M, cy = row / M;
      const int pi = cy * (TX + 1) + cx;
      T v[M], o[M];
#pragma unroll
      for (int j = 0; j < M; ++j) v[j] = b[(j * LY + row) * LXS + col];
      forward(vz + pi * VM, v, o);
      const T* lp = lam + pi * 3 * M;
      const T lyv = lp[M + row - cy * M], lxv = lp[col - cx * M];
#pragma unroll
      for (int k = 0; k < M; ++k)
        a[(k * LY + row) * LXS + col] = o[k] * recip(lp[2 * M + k] + lyv + lxv);
    }
    __syncthreads();
    // backward x: a -> b; lines (kz, cell x, row)
    for (int l = tid; l < M * (TX + 1) * LY; l += NT) {
      const int row = l % LY, q = l / LY, c = q % (TX + 1), k = q / (TX + 1);
      const T* in = a + (k * LY + row) * LXS + c * M;
      const T* V = vx + ((row / M) * (TX + 1) + c) * VM;
      T v[M];
#pragma unroll
      for (int j = 0; j < M; ++j) v[j] = in[j];
      T* out = b + (k * LY + row) * LXS + c * M;
#pragma unroll
      for (int s = 0; s < M; ++s) out[s] = backward(V + s * MP, v);
    }
    __syncthreads();
    // backward y: b -> a; lines (kz, cell y, col)
    for (int l = tid; l < M * (TY + 1) * LX; l += NT) {
      const int col = l % LX, q = l / LX, c = q % (TY + 1), k = q / (TY + 1);
      const T* in = b + (k * LY + c * M) * LXS + col;
      const T* V = vy + (c * (TX + 1) + col / M) * VM;
      T v[M];
#pragma unroll
      for (int j = 0; j < M; ++j) v[j] = in[j * LXS];
      T* out = a + (k * LY + c * M) * LXS + col;
#pragma unroll
      for (int s = 0; s < M; ++s) out[s * LXS] = backward(V + s * MP, v);
    }
    __syncthreads();
  }

  // Backward z and the sum onto the owned nodes of layer cz (planes
  // cz * P + [0, P), and the closing plane when top), as FDMTile::sum with
  // each patch's own Vz.  carry_in: add the carry (the layer below was
  // solved); write: the layer is the chunk's own (not its halo layer).
  __device__ void sum(T* __restrict__ out, int cz, bool carry_in, bool write,
                      bool top) {
    const int nw = write ? (top ? M : P) : 0;
    for (int col = threadIdx.x; col < oy * ox; col += NT) {
      const int yy = col / ox, xx = col - yy * ox;
      const int wy = yy + P, wx = xx + P;  // window coordinates
      const int hy = wy / P, ry = wy - hy * P;
      const int hx = wx / P, rx = wx - hx * P;
      T acc[M];
      acc[0] = carry_in ? carry[yy * OX + xx] : T(0);
#pragma unroll
      for (int s = 1; s < M; ++s) acc[s] = T(0);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int cy = hy - 1 + dy, sy = dy ? ry : P;
        const int gcy = cy0 - 1 + cy;
        if (!(dy || ry == 0) || cy > TY || gcy < 0 || gcy >= Cy) continue;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int cx = hx - 1 + dx, sx = dx ? rx : P;
          const int gcx = cx0 - 1 + cx;
          if (!(dx || rx == 0) || cx > TX || gcx < 0 || gcx >= Cx) continue;
          const T* in = a + (cy * M + sy) * LXS + cx * M + sx;
          const T* V = vz + (cy * (TX + 1) + cx) * VM;
          T v[M];
#pragma unroll
          for (int k = 0; k < M; ++k) v[k] = in[k * LY * LXS];
#pragma unroll
          for (int s = 0; s < M; ++s) acc[s] += backward(V + s * MP, v);
        }
      }
      carry[yy * OX + xx] = acc[P];
      const T fyx = fouty[yy] * foutx[xx];
      const size_t col0 = static_cast<size_t>(cy0 * P + yy) * Nx + cx0 * P + xx;
#pragma unroll
      for (int s = 0; s < M; ++s) {
        if (s < nw)
          out[static_cast<size_t>(cz * P + s) * Ny * Nx + col0] =
              acc[s] * (foutz[s] * fyx);
      }
    }
  }
};

template <typename T, int M>
__global__ void __launch_bounds__(CellConfig<T, M>::NT, CellConfig<T, M>::MINB)
cell_fdm_patch_kernel(CellFDMTables<T> t, const T* __restrict__ src,
                      T* __restrict__ out, int chunk) {
  using C = CellConfig<T, M>;
  using Tile = CellTile<T, M, C::TX, C::TY, C::NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile tile;
  tile.carve(reinterpret_cast<T*>(smem_raw));
  tile.init(t);
  const int cz_begin = blockIdx.z * chunk;
  const int cz_end = t.Cz - cz_begin < chunk ? t.Cz : cz_begin + chunk;
  const int first = cz_begin > 0 ? cz_begin - 1 : 0;  // uniform
  for (int cz = first; cz < cz_end; ++cz) {
    __syncthreads();  // the last layer's sum has read the tables and a
    tile.stage(t, cz);
    tile.gather(src, t, cz);
    __syncthreads();
    tile.transforms();
    tile.sum(out, cz, cz > first, cz >= cz_begin, cz == t.Cz - 1);
  }
}

template <typename T, int M>
cudaError_t launch_m(const CellFDMTables<T>& t, const T* src, T* out,
                     cudaStream_t stream) {
  using C = CellConfig<T, M>;
  auto kern = cell_fdm_patch_kernel<T, M>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (attr != cudaSuccess) return attr;
  const int tx = (t.Cx + C::TX - 1) / C::TX, ty = (t.Cy + C::TY - 1) / C::TY;
  const int chunk = cell_chunk_layers(tx * ty, t.Cz, C::CZ, C::MINB);
  const dim3 grid(tx, ty, (t.Cz + chunk - 1) / chunk);
  kern<<<grid, C::NT, C::BYTES, stream>>>(t, src, out, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t cell_fdm_patch_launch(const CellFDMTables<T>& t, const T* src,
                                  T* out, cudaStream_t stream) {
  switch (t.p) {
    case 1: return launch_m<T, 2>(t, src, out, stream);
    case 2: return launch_m<T, 3>(t, src, out, stream);
    case 3: return launch_m<T, 4>(t, src, out, stream);
    case 4: return launch_m<T, 5>(t, src, out, stream);
    case 5: return launch_m<T, 6>(t, src, out, stream);
    case 6: return launch_m<T, 7>(t, src, out, stream);
    case 7: return launch_m<T, 8>(t, src, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int cell_entry(const T* src, T* out, const T* Vx, const T* Vy, const T* Vz,
               const T* lam, const T* fin_x, const T* fin_y, const T* fin_z,
               const T* fout_x, const T* fout_y, const T* fout_z, int Cz,
               int Cy, int Cx, int p, void* stream) {
  const CellFDMTables<T> t{Vx,     Vy,     Vz,     lam, fin_x, fin_y, fin_z,
                           fout_x, fout_y, fout_z, Cz,  Cy,    Cx,    p};
  return static_cast<int>(cell_fdm_patch_launch<T>(
      t, src, out, static_cast<cudaStream_t>(stream)));
}

}  // namespace
}  // namespace dat

extern "C" int dat_cell_fdm_patch_f32(
    const float* src, float* out, const float* Vx, const float* Vy,
    const float* Vz, const float* lam, const float* fin_x, const float* fin_y,
    const float* fin_z, const float* fout_x, const float* fout_y,
    const float* fout_z, int Cz, int Cy, int Cx, int p, void* stream) {
  return dat::cell_entry<float>(src, out, Vx, Vy, Vz, lam, fin_x, fin_y,
                                fin_z, fout_x, fout_y, fout_z, Cz, Cy, Cx, p,
                                stream);
}

extern "C" int dat_cell_fdm_patch_f64(
    const double* src, double* out, const double* Vx, const double* Vy,
    const double* Vz, const double* lam, const double* fin_x,
    const double* fin_y, const double* fin_z, const double* fout_x,
    const double* fout_y, const double* fout_z, int Cz, int Cy, int Cx, int p,
    void* stream) {
  return dat::cell_entry<double>(src, out, Vx, Vy, Vz, lam, fin_x, fin_y,
                                 fin_z, fout_x, fout_y, fout_z, Cz, Cy, Cx, p,
                                 stream);
}

// The launch plan of kernel G at degree p for elements of itemsize bytes:
// out[0..4] = tile x, tile y, chunk z, threads, dynamic shared bytes.
// kernels/cell_fdm_patch.py::launch_plan mirrors it.
extern "C" int dat_cell_tile_plan(int p, int itemsize, int* out) {
  if (p < 1 || p > 7 || (itemsize != 4 && itemsize != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const dat::TileShape s = dat::cell_tile_shape(p + 1, itemsize);
  out[0] = s.tx;
  out[1] = s.ty;
  out[2] = s.cz;
  out[3] = s.threads;
  out[4] = dat::cell_elems(p + 1, itemsize) * itemsize;
  return 0;
}
