// The tiled FDM patch body shared by kernel B (fdm_patch.cu) and kernel C
// (smoother_step.cu): element-centric overlap-1 patches, one m x m x m
// eigen-solve per cell and layer,
//
//   P^-1 r = sum over cells of  R_c^T Fout (Vz x Vy x Vx)
//                 diag(1/(lz+ly+lx)) (Vz x Vy x Vx)^T Fin R_c r.
//
// Replaces the patch stage of dealii_asm_tpu/ops/pallas/fdm_slab.py
// FDMSlabKernel and of smoother_step.py SmootherStepKernel.
//
// Bound: 6 m^4 + m^3 multiply-adds per cell against one read and one write
// of each node; at m = 5 in float32 that is about 15 flops per byte, so
// device memory bounds the patch apply, and the transforms must stay on
// chip and be done once per cell.
//
// Tiles, ownership, carry.  A block owns a TX x TY tile of cells in x and y
// and marches through a chunk of cell layers along z (chunk_layers) with a
// loop inside the block (the z-carry of fdm_slab.py's sequential grid).  It owns the
// nodes at local positions [0, P) of its cells per axis; the last tile of an
// axis also owns the closing node plane.  On each layer it solves the
// (TX+1)(TY+1) patches of its cells and of the one-cell halo on the lower x
// and y sides (the halo patches are the only recomputed ones), all patches
// of the layer at once: each transform stage maps one thread to one line of
// m values of one patch, an m x m product with V rows read from shared
// memory 16 bytes at a time.  The
// upper node plane of a layer goes to a carry in shared memory that the next
// layer adds; only the first layer of a chunk re-solves the layer below it
// (none at the bottom of the grid).  Each owned node sums its contributions
// in one fixed order, the carry first, then the layer's patches by (dy, dx),
// lower cell first, and is written once by the thread that owns it: no
// atomics, repeated runs bit-identical.  The per-coordinate V and lambda of
// the tile's x and y cells and of the current z layer, and the folds, are
// staged into shared memory; no transform reads device memory.
//
// The tile shapes per (kernel, m, element size) are tile_shape() below,
// chosen by timing variants at 64^3 Q4 on the H100 (PERF.md);
// kernels/fdm_patch.py::launch_plan mirrors them, the layout sizes and the
// chunk rule.
#pragma once

#include "kernels.h"

namespace dat {

enum TileKernel : int {
  kTilePatch = 0,  // kernel B: the FDM apply
  kTileStep = 1,   // kernel C: the one-pass smoother step
};

// tx x ty cells per block, at most cz cell layers per block along z (see
// chunk_layers), threads per block
struct TileShape {
  int tx, ty, cz, threads;
};

constexpr TileShape tile_shape(int kernel, int m, int itemsize) {
  if (kernel == kTilePatch) {
    switch (m) {
      case 2: return {16, 16, 16, 256};
      case 3: return {16, 8, 16, 256};
      case 4:
      case 5: return {8, 8, 16, 512};
      case 6: return {8, 4, 16, 512};
      default: return {4, 4, 16, 512};
    }
  }
  switch (m) {
    case 2: return {16, 16, 32, 256};
    case 3: return {8, 8, 32, 256};
    case 4:
    case 5: return itemsize == 4 ? TileShape{8, 8, 32, 512}
                                 : TileShape{4, 4, 32, 256};
    case 6: return itemsize == 4 ? TileShape{4, 4, 32, 256}
                                 : TileShape{2, 2, 32, 256};
    case 7: return {2, 2, 32, 256};
    default: return itemsize == 4 ? TileShape{2, 2, 32, 256}
                                  : TileShape{2, 1, 32, 256};
  }
}

constexpr int odd(int n) { return n | 1; }  // row strides free of bank conflicts
constexpr int vrow(int m) { return (m + 3) & ~3; }  // V rows: 16-byte aligned
constexpr int pad4(int n) { return (n + 3) & ~3; }  // regions: 16-byte aligned
constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory layout of one tile, in elements.
struct TileLayout {
  int P, NX, NY, NXS, LX, LXS, LY, OX, OY;
  int BUF;     // one transform buffer: M x LY x LXS, padded
  int TABLES;  // V, lambda and folds
  int HY, HX, HXS, XSZ, STAGE;  // kernel C: two x planes with the band halo
                                // (XSZ each) and their (Mx x, Kx x) pairs
};

constexpr TileLayout tile_layout(int m, TileShape s) {
  const int P = m - 1;
  const int NX = (s.tx + 1) * P + 1;  // window: the tile's cells and the halo cell
  const int NY = (s.ty + 1) * P + 1;
  const int LX = (s.tx + 1) * m;  // per-cell lines: (cell, mode or patch node)
  const int LY = (s.ty + 1) * m;
  const int OX = s.tx * P + 1;  // owned node columns, at most
  const int OY = s.ty * P + 1;
  const int HY = NY + 2 * P, HX = NX + 2 * P;
  return TileLayout{
      P, NX, NY, odd(NX), LX, odd(LX), LY, OX, OY, pad4(m * LY * odd(LX)),
      // Vx, Vy, Vz[2] (rows padded to vrow(m)); lx, ly, lz[2]; fin x, y;
      // fout x, y, z[2]
      (s.tx + s.ty + 4) * m * vrow(m) + (s.tx + s.ty + 4) * m + NX + NY + OX +
          OY + 2 * m,
      HY, HX, odd(HX), pad4(HY * odd(HX)),
      2 * pad4(HY * odd(HX)) + 4 * HY * odd(NX)};
}

// Elements of shared memory a block of `kernel` uses.
constexpr int tile_elems(int kernel, int m, int itemsize) {
  const TileShape s = tile_shape(kernel, m, itemsize);
  const TileLayout L = tile_layout(m, s);
  const int fdm = L.BUF + pad4(L.OY * L.OX + L.TABLES);  // + buffer b
  if (kernel == kTilePatch) return fdm + L.BUF;
  const int B = 2 * m - 1;  // band width 2p + 1
  // buffer b also holds the plane stage; the r window; the ring of
  // (My Mx x, Ky Mx x + My Kx x) pairs; Mx, Kx, My, Ky
  return fdm + imax(L.BUF, L.STAGE) + pad4(m * L.NY * L.NXS) +
         2 * B * L.NY * L.NX + 2 * B * (L.NX + L.NY);
}

// Blocks an SM can hold for the shared memory (228 KB, 1 KB reserved per
// block) and threads (2048), leaving each thread at least 64 registers: the
// kernels' __launch_bounds__ minimum, so that registers do not lower the
// occupancy further and the transforms do not spill.
constexpr int min_blocks(int bytes, int threads) {
  const int by_smem = 233472 / (bytes + 1024);
  const int by_threads = 2048 / threads;
  const int by_regs = 65536 / (64 * threads);
  int n = by_smem < by_threads ? by_smem : by_threads;
  n = n < by_regs ? n : by_regs;
  return n < 1 ? 1 : n;
}

// Cell layers a block marches through: the largest of cz, cz/2, cz/4, ...
// that still gives the card 90% of the blocks it holds at once (sms SMs at
// min_blocks each), so that small grids are not left to a few long blocks.
inline int chunk_layers(int tiles, int Cz, int cz, int blocks_per_sm) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  const long want = (9L * sms * blocks_per_sm + 9) / 10;
  while (cz > 1 && static_cast<long>(tiles) * ((Cz + cz - 1) / cz) < want)
    cz = (cz + 1) / 2;
  return cz;
}

// The correctly rounded reciprocal (one special-function op and a Newton
// step, where a division is a long sequence): times 1/(lz + ly + lx), as
// the plain version's inverse eigenvalue sums.
__device__ __forceinline__ float recip(float v) { return __frcp_rn(v); }
__device__ __forceinline__ double recip(double v) { return __drcp_rn(v); }

// 16-byte loads of V rows from shared memory (M values of a row padded to
// vrow(M)): four floats or two doubles per load.
__device__ __forceinline__ void load16(const float* p, float (&r)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  r[0] = q.x;
  r[1] = q.y;
  r[2] = q.z;
  r[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double (&r)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  r[0] = q.x;
  r[1] = q.y;
}

template <typename T, int M>
__device__ __forceinline__ void load_row(const T* row, T (&r)[M]) {
  constexpr int N = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < (M + N - 1) / N; ++i) {
    T q[N];
    load16(row + i * N, q);
#pragma unroll
    for (int l = 0; l < N; ++l)
      if (i * N + l < M) r[i * N + l] = q[l];
  }
}

// The FDM body of one tile.  NT threads; the caller stages, syncs and runs
// transforms() and sum() once per layer.
template <typename T, int M, int TX, int TY, int NT>
struct FDMTile {
  static constexpr TileLayout L = tile_layout(M, TileShape{TX, TY, 1, NT});
  static constexpr int P = M - 1;
  static constexpr int NX = L.NX, NY = L.NY, NXS = L.NXS;
  static constexpr int LX = L.LX, LXS = L.LXS, LY = L.LY;
  static constexpr int OX = L.OX, OY = L.OY, BUF = L.BUF;
  // the carry and the tables after it (L.TABLES less the V tables, which
  // come first), padded so that what follows stays 16-byte aligned
  static constexpr int CARRY_TABLES =
      pad4(OY * OX + L.TABLES - (TX + TY + 4) * M * vrow(M));
  static constexpr int MP = vrow(M), VM = M * MP;  // V row stride, one V

  T* a;  // transform buffers, M x LY x LXS each
  T* b;
  T* carry;  // upper node plane of the last layer, OY x OX
  T *vx, *vy, *vz, *lx, *ly, *lz, *finx, *finy, *foutx, *fouty, *foutz;
  int cx0, cy0;  // the tile's first own cell; its halo cell is one lower
  int ox, oy;    // owned node columns (fewer in a ragged tile)
  int Cx, Cy, Nx, Ny;

  // sum_j V[s][j] v[j] for the row V[s] at row
  static __device__ __forceinline__ T backward(const T* row, const T (&v)[M]) {
    T r[M];
    load_row<T, M>(row, r);
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j) acc += r[j] * v[j];
    return acc;
  }

  // o = V^T v, each V row loaded once (j ascending)
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

  // Lays the regions out from p (16-byte aligned; buffer b takes b_elems);
  // returns the end, 16-byte aligned.  The V tables come first, so their
  // rows stay aligned.
  __device__ T* carve(T* p, int b_elems) {
    vx = p;
    p += (TX + 1) * VM;
    vy = p;
    p += (TY + 1) * VM;
    vz = p;
    p += 2 * VM;
    a = p;
    p += BUF;
    b = p;
    p += b_elems;
    carry = p;
    p += OY * OX;
    lx = p;
    p += (TX + 1) * M;
    ly = p;
    p += (TY + 1) * M;
    lz = p;
    p += 2 * M;
    finx = p;
    p += NX;
    finy = p;
    p += NY;
    foutx = p;
    p += OX;
    fouty = p;
    p += OY;
    foutz = p;
    return carry + CARRY_TABLES;
  }

  // The tile's place and its x/y tables; the caller syncs before use.
  __device__ void init(const FDMTables<T>& t) {
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
    // cells outside the mesh get V = 0 and lambda = 1: zero patches
    for (int i = tid; i < (TX + 1) * VM; i += NT) {
      const int c = cx0 - 1 + i / VM, s = i % VM / MP, k = i % MP;
      vx[i] = c >= 0 && c < Cx && k < M ? t.Vx[(c * M + s) * M + k] : T(0);
    }
    for (int i = tid; i < (TY + 1) * VM; i += NT) {
      const int c = cy0 - 1 + i / VM, s = i % VM / MP, k = i % MP;
      vy[i] = c >= 0 && c < Cy && k < M ? t.Vy[(c * M + s) * M + k] : T(0);
    }
    for (int i = tid; i < (TX + 1) * M; i += NT) {
      const int c = cx0 - 1 + i / M;
      lx[i] = c >= 0 && c < Cx ? t.lx[c * M + i % M] : T(1);
    }
    for (int i = tid; i < (TY + 1) * M; i += NT) {
      const int c = cy0 - 1 + i / M;
      ly[i] = c >= 0 && c < Cy ? t.ly[c * M + i % M] : T(1);
    }
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

  // Layer cz's z tables into slot par (the other slot may still be read).
  __device__ void stage_layer(const FDMTables<T>& t, int cz, int par) {
    const int tid = threadIdx.x;
    for (int i = tid; i < VM; i += NT) {
      const int s = i / MP, k = i % MP;
      vz[par * VM + i] = k < M ? t.Vz[(cz * M + s) * M + k] : T(0);
    }
    for (int i = tid; i < M; i += NT) {
      lz[par * M + i] = t.lz[cz * M + i];
      foutz[par * M + i] = t.fout_z[cz * P + i];
    }
  }

  // Kernel B's gather: layer cz's window of src, folded by fin, into b
  // (M x NY x NXS); zero outside the grid.
  __device__ void gather(const T* __restrict__ src, const FDMTables<T>& t,
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

  // The five transform stages of one layer from the folded window w
  // (M x NY x NXS; may be b): forward x, y, z with the eigenvalue scale,
  // backward x, y.  Leaves the patches' backward-y result in a, laid out
  // (kz, cell y * M + sy, cell x * M + sx); ends on a barrier.
  __device__ void transforms(const T* w, int par) {
    const int tid = threadIdx.x;
    // forward x: w -> a (z, wy, cell x * M + kx); lines (z, cell x, wy)
    for (int l = tid; l < M * (TX + 1) * NY; l += NT) {
      const int wy = l % NY, q = l / NY, c = q % (TX + 1), z = q / (TX + 1);
      const T* in = w + (z * NY + wy) * NXS + c * P;
      T v[M], o[M];
#pragma unroll
      for (int j = 0; j < M; ++j) v[j] = in[j];
      forward(vx + c * VM, v, o);
      T* out = a + (z * NY + wy) * LXS + c * M;
#pragma unroll
      for (int k = 0; k < M; ++k) out[k] = o[k];
    }
    __syncthreads();
    // forward y: a -> b (z, cell y * M + ky, col); lines (z, cell y, col)
    for (int l = tid; l < M * (TY + 1) * LX; l += NT) {
      const int col = l % LX, q = l / LX, c = q % (TY + 1), z = q / (TY + 1);
      const T* in = a + (z * NY + c * P) * LXS + col;
      T v[M], o[M];
#pragma unroll
      for (int j = 0; j < M; ++j) v[j] = in[j * LXS];
      forward(vy + c * VM, v, o);
      T* out = b + (z * LY + c * M) * LXS + col;
#pragma unroll
      for (int k = 0; k < M; ++k) out[k * LXS] = o[k];
    }
    __syncthreads();
    // forward z and the scale: b -> a (kz, row, col); lines (row, col)
    {
      const T* lzp = lz + par * M;
      for (int l = tid; l < LY * LX; l += NT) {
        const int col = l % LX, row = l / LX;
        T v[M], o[M];
#pragma unroll
        for (int j = 0; j < M; ++j) v[j] = b[(j * LY + row) * LXS + col];
        forward(vz + par * VM, v, o);
        const T lyx = ly[row] + lx[col];
#pragma unroll
        for (int k = 0; k < M; ++k)
          a[(k * LY + row) * LXS + col] = o[k] * recip(lzp[k] + lyx);
      }
    }
    __syncthreads();
    // backward x: a -> b; lines (kz, cell x, row)
    for (int l = tid; l < M * (TX + 1) * LY; l += NT) {
      const int row = l % LY, q = l / LY, c = q % (TX + 1), k = q / (TX + 1);
      const T* in = a + (k * LY + row) * LXS + c * M;
      T v[M];
#pragma unroll
      for (int j = 0; j < M; ++j) v[j] = in[j];
      T* out = b + (k * LY + row) * LXS + c * M;
#pragma unroll
      for (int s = 0; s < M; ++s) out[s] = backward(vx + c * VM + s * MP, v);
    }
    __syncthreads();
    // backward y: b -> a; lines (kz, cell y, col)
    for (int l = tid; l < M * (TY + 1) * LX; l += NT) {
      const int col = l % LX, q = l / LX, c = q % (TY + 1), k = q / (TY + 1);
      const T* in = b + (k * LY + c * M) * LXS + col;
      T v[M];
#pragma unroll
      for (int j = 0; j < M; ++j) v[j] = in[j * LXS];
      T* out = a + (k * LY + c * M) * LXS + col;
#pragma unroll
      for (int s = 0; s < M; ++s)
        out[s * LXS] = backward(vy + c * VM + s * MP, v);
    }
    __syncthreads();
  }

  // Backward z and the sum onto the owned nodes of layer cz (planes
  // cz * P + [0, P), and the closing plane when top).  carry_in: add the
  // carry (the layer below was solved).  write: the layer is the chunk's
  // own (not its halo layer).  epi(idx, v) gets each node's sum times its
  // output folds.  Each thread keeps the same columns every layer, so the
  // carry needs no barrier.
  template <class Epi>
  __device__ void sum(int cz, int par, bool carry_in, bool write, bool top,
                      Epi&& epi) {
    const T* V = vz + par * VM;
    const T* fz = foutz + par * M;
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
      // the patches holding this node: along each axis the lower cell (at
      // its local node P) where the node is a cell corner, then the cell
      // with the node at local position ry / rx
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
          T v[M];
#pragma unroll
          for (int k = 0; k < M; ++k) v[k] = in[k * LY * LXS];
#pragma unroll
          for (int s = 0; s < M; ++s) acc[s] += backward(V + s * MP, v);
        }
      }
      carry[yy * OX + xx] = acc[P];
      const T fyx_y = fouty[yy], fyx_x = foutx[xx];
      const size_t col0 = static_cast<size_t>(cy0 * P + yy) * Nx + cx0 * P + xx;
#pragma unroll
      for (int s = 0; s < M; ++s) {
        if (s < nw)
          epi(static_cast<size_t>(cz * P + s) * Ny * Nx + col0,
              acc[s] * (fz[s] * fyx_y * fyx_x));
      }
    }
  }
};

}  // namespace dat
