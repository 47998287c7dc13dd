// Per-cell sum-factorised Laplace integral, shared by kernel E
// (merged_laplace.cu, cells of the node lattice) and kernel F
// (lanes_laplace.cu, cells of an unstructured mesh).
//
//   g = (grad N) u_c,  t = C_c g,  v_c = (grad N)^T t
//
// One thread per 1D line of a cell: a cell of m = p+1 points per axis has
// m^2 lines in each direction, and the thread of line li holds that line's
// m values in registers, so each 1D contraction is m^2 register
// multiply-adds.  The 1D tables N, Dx, Dy, Dz arrive by value as a
// __grid_constant__ kernel parameter (ShapeTables); the stage loops unroll
// over the template degree, so every table entry is a compile-time offset
// into the parameter bank, which ptxas loads (ULDC) into a uniform register
// once a warp and feeds to the FMA from there: no vector load, no shared
// memory (cuobjdump -sass; chip_smoke.py --ptxas counts them).  Between
// directions the values make one round trip through shared memory (store
// the line, barrier, load the line of the next direction), 3 m^3 values a
// cell:
//   in   u_c into b0, coalesced (entry li + j m^2)        | barrier
//   x    x-line li = (z, y):  a = N u, d = Dx u          -> b0, b1 | barrier
//   y    y-line (z, qx):      b = N a, c = Dy a, e = N d -> b0, b2, b1 | barrier
//   z    z-line (qy, qx):     gz = Dz b, gy = N c, gx = N e; t = C g with
//        the point's 6 coefficients [xx, yy, zz, xy, xz, yz] streamed
//        cell-major (C, 6, Q) (neighbouring lines read neighbouring words);
//        w1 = Dz^T tz, w2 = N^T ty, w3 = N^T tx      -> b0, b1, b2 | barrier
//   y^T  y-line:  r12 = N^T w1 + Dy^T w2, r3 = N^T w3   -> b0, b1 | barrier
//   x^T  x-line:  v = N^T r12 + Dx^T r3                 -> b0 | barrier
//   out  b0 to the cell's m^3 results in vcell (C, m^3), coalesced.
// A thread reads and writes only its own line's positions inside a stage,
// so one barrier per change of direction suffices.  Where a block holds
// whole cells a warp (cell_shape's cpw > 0; m^2 <= 32 lines, p <= 4) the
// barrier is __syncwarp; where lines are packed across warps it is
// __syncthreads.
#pragma once

#include "kernels.h"

namespace dat {

// N, Dx, Dy, Dz as [quadrature point][node], passed by value.
template <typename T, int M>
struct ShapeTables {
  T t[4][M][M];
};

// Kernel E's and F's cell launch at degree p for elements of itemsize
// bytes: cpw cells a warp (0: a cell's lines span warps, block barrier),
// `cells` cells and `threads` threads a block.
// kernels/merged_laplace.py::cell_plan mirrors it.
struct CellShape {
  int cpw;
  int cells;
  int threads;
};

// At p = 4 (measured, tools/tile_sweep.py ef): float64 runs one cell a
// warp in 128-thread blocks (88 registers a thread, so 5 blocks an SM);
// float32 packs 5 cells' 125 lines into a block without idle lanes.
constexpr CellShape cell_shape(int p, int itemsize) {
  switch (p) {
    case 1: return {8, 64, 256};  // 4 lines a cell, 32 of 32 lanes busy
    case 2: return {3, 24, 256};  // 9 lines, 27 of 32
    case 3: return {2, 16, 256};  // 16 lines, 32 of 32
    case 4:                       // 25 lines
      return itemsize == 8 ? CellShape{1, 4, 128} : CellShape{0, 5, 125};
    case 5: return {0, 7, 252};   // 36 lines
    case 6: return {0, 5, 245};   // 49 lines
    default: return {0, 4, 256};  // 64 lines
  }
}

template <typename T, int P>
struct CellConfig {
  static constexpr int M = P + 1, M2 = M * M, M3 = M2 * M;
  static constexpr CellShape S = cell_shape(P, sizeof(T));
  static constexpr int CPW = S.cpw, CELLS = S.cells, NT = S.threads;
  static constexpr int SHARED_BYTES = CELLS * 3 * M3 * sizeof(T);
  static_assert(CPW == 0 ? NT == CELLS * M2
                         : (CPW * M2 <= 32 && NT == CELLS / CPW * 32 &&
                            CELLS % CPW == 0),
                "cell_shape: threads do not match the cells' lines");
  static_assert(SHARED_BYTES <= 48 * 1024, "cell_shape: static shared limit");
  static_assert(sizeof(ShapeTables<T, M>) + 64 <= 4096,
                "cell_shape: kernel parameter limit");
};

// This thread's cell k of the block, its line li, and whether it owns one.
template <typename T, int P>
__device__ __forceinline__ void cell_lane(int& k, int& li, bool& active) {
  using C = CellConfig<T, P>;
  if constexpr (C::CPW > 0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    k = warp * C::CPW + lane / C::M2;
    li = lane % C::M2;
    active = lane < C::CPW * C::M2;
  } else {
    k = threadIdx.x / C::M2;
    li = threadIdx.x - k * C::M2;
    active = true;
  }
}

template <int CPW>
__device__ __forceinline__ void cell_sync() {
  if constexpr (CPW > 0)
    __syncwarp();
  else
    __syncthreads();
}

// out[q] = sum_s A[q][s] in[s]
template <typename T, int M>
__device__ __forceinline__ void line_apply(const T (&A)[M][M],
                                           const T (&in)[M], T (&out)[M]) {
#pragma unroll
  for (int q = 0; q < M; ++q) {
    T acc = T(0);
#pragma unroll
    for (int s = 0; s < M; ++s) acc += A[q][s] * in[s];
    out[q] = acc;
  }
}

// out[s] = sum_q A[q][s] in[q] (+ sum_q B[q][s] in2[q] in line_apply_t2)
template <typename T, int M>
__device__ __forceinline__ void line_apply_t(const T (&A)[M][M],
                                             const T (&in)[M], T (&out)[M]) {
#pragma unroll
  for (int s = 0; s < M; ++s) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < M; ++q) acc += A[q][s] * in[q];
    out[s] = acc;
  }
}

template <typename T, int M>
__device__ __forceinline__ void line_apply_t2(const T (&A)[M][M],
                                              const T (&in)[M],
                                              const T (&B)[M][M],
                                              const T (&in2)[M], T (&out)[M]) {
#pragma unroll
  for (int s = 0; s < M; ++s) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < M; ++q) acc += A[q][s] * in[q] + B[q][s] * in2[q];
    out[s] = acc;
  }
}

// The z-line li's 6 coefficients at its m points: coeff (C, 6, m^3) of the
// cell at cc, neighbouring lines on neighbouring words; zero where !live.
template <typename T, int M>
__device__ __forceinline__ void coeff_load(T (&cf)[6][M],
                                           const T* __restrict__ cc, int li,
                                           bool live) {
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int q = 0; q < M; ++q)
      cf[k][q] = live ? cc[(k * M + q) * M * M + li] : T(0);
}

template <typename T, int M>
__device__ __forceinline__ void line_load(const T* p, int stride, T (&v)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) v[j] = p[j * stride];
}

template <typename T, int M>
__device__ __forceinline__ void line_store(T* p, int stride, const T (&v)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) p[j * stride] = v[j];
}

// One cell's integral.  Every thread of the block calls it (the barriers);
// `active` threads own line li of the cell whose 3 m^3 stage buffers start
// at buf; `live` ones also own a real cell, whose values load(l) gives
// (l = (z m + y) m + x; zero where constrained), whose coefficients start
// at cc and whose results go to vc.
template <typename T, int P, typename Load>
__device__ __forceinline__ void cell_sumfac(const ShapeTables<T, P + 1>& tab,
                                            T* __restrict__ buf, int li,
                                            bool active, bool live, Load load,
                                            const T* __restrict__ cc,
                                            T* __restrict__ vc) {
  using C = CellConfig<T, P>;
  constexpr int M = C::M, M2 = C::M2, M3 = C::M3;
  const auto& N = tab.t[0];
  const auto& Dx = tab.t[1];
  const auto& Dy = tab.t[2];
  const auto& Dz = tab.t[3];
  T* b0 = buf;
  T* b1 = buf + M3;
  T* b2 = buf + 2 * M3;
  // line li as an x-line (z, y) and as a y-line (z, qx)
  const int zy = li / M, xy = li - zy * M;
  const int ybase = zy * M2 + xy;
  T cf[6][M];  // loaded in the z stage

  if (active) {
#pragma unroll
    for (int j = 0; j < M; ++j)
      b0[li + j * M2] = live ? load(li + j * M2) : T(0);
  }
  cell_sync<C::CPW>();
  if (active) {  // forward x
    T u[M], a[M], d[M];
    line_load(b0 + li * M, 1, u);
    line_apply(N, u, a);
    line_apply(Dx, u, d);
    line_store(b0 + li * M, 1, a);
    line_store(b1 + li * M, 1, d);
  }
  cell_sync<C::CPW>();
  if (active) {  // forward y
    T a[M], d[M], r[M];
    line_load(b0 + ybase, M, a);
    line_load(b1 + ybase, M, d);
    line_apply(N, a, r);
    line_store(b0 + ybase, M, r);
    line_apply(Dy, a, r);
    line_store(b2 + ybase, M, r);
    line_apply(N, d, r);
    line_store(b1 + ybase, M, r);
  }
  cell_sync<C::CPW>();
  if (active) {  // forward z, coefficients, backward z
    coeff_load(cf, cc, li, live);
    T b[M], c[M], e[M], gz[M], gy[M], gx[M];
    line_load(b0 + li, M2, b);
    line_load(b2 + li, M2, c);
    line_load(b1 + li, M2, e);
    line_apply(Dz, b, gz);
    line_apply(N, c, gy);
    line_apply(N, e, gx);
    T tx[M], ty[M], tz[M];
#pragma unroll
    for (int q = 0; q < M; ++q) {
      tx[q] = cf[0][q] * gx[q] + cf[3][q] * gy[q] + cf[4][q] * gz[q];
      ty[q] = cf[3][q] * gx[q] + cf[1][q] * gy[q] + cf[5][q] * gz[q];
      tz[q] = cf[4][q] * gx[q] + cf[5][q] * gy[q] + cf[2][q] * gz[q];
    }
    line_apply_t(Dz, tz, b);
    line_store(b0 + li, M2, b);
    line_apply_t(N, ty, b);
    line_store(b1 + li, M2, b);
    line_apply_t(N, tx, b);
    line_store(b2 + li, M2, b);
  }
  cell_sync<C::CPW>();
  if (active) {  // backward y
    T w1[M], w2[M], w3[M], r[M];
    line_load(b0 + ybase, M, w1);
    line_load(b1 + ybase, M, w2);
    line_load(b2 + ybase, M, w3);
    line_apply_t2(N, w1, Dy, w2, r);
    line_store(b0 + ybase, M, r);
    line_apply_t(N, w3, r);
    line_store(b1 + ybase, M, r);
  }
  cell_sync<C::CPW>();
  if (active) {  // backward x
    T r12[M], r3[M], v[M];
    line_load(b0 + li * M, 1, r12);
    line_load(b1 + li * M, 1, r3);
    line_apply_t2(N, r12, Dx, r3, v);
    line_store(b0 + li * M, 1, v);
  }
  cell_sync<C::CPW>();
  if (live) {
#pragma unroll
    for (int j = 0; j < M; ++j) vc[li + j * M2] = b0[li + j * M2];
  }
}

}  // namespace dat
