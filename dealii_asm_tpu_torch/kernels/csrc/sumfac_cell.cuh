// Per-cell sum-factorised Laplace integral, shared by kernel E
// (merged_laplace.cu, cells of the node lattice) and kernel F
// (lanes_laplace.cu, cells of an unstructured mesh).
//
//   g = (grad N) u_c,  t = C_c g,  v_c = (grad N)^T t
//
// A block of kThreads threads owns CPB cells.  The caller loads the 1D shape
// tables and the cells' gathered node values (constrained nodes as zero) into
// shared memory and synchronises; cell_sumfac runs the three forward 1D
// contractions, applies the 6 symmetric coefficients of each quadrature
// point, streamed cell-major (C, 6, Q) as [xx, yy, zz, xy, xz, yz] so that
// neighbouring threads read neighbouring words, runs the three backward
// contractions and writes each cell's m^3 results to vcell (C, m^3).
#pragma once

#include "kernels.h"

namespace dat {

constexpr int kCellThreads = 256;

template <int P>
struct CellLayout {
  static constexpr int M = P + 1;
  static constexpr int M2 = M * M;
  static constexpr int M3 = M2 * M;
  static constexpr int CPB = kCellThreads / M3 > 0 ? kCellThreads / M3 : 1;
};

// sh: N, Dx, Dy, Dz as [quadrature point][node]; buf[0] holds the gathered
// values of cells c0 .. c0 + CPB - 1 (cell k at k * M3, x fastest) on entry.
template <typename T, int P>
__device__ __forceinline__ void cell_sumfac(
    T (&sh)[4][P + 1][P + 1],
    T (&buf)[6][CellLayout<P>::CPB * CellLayout<P>::M3],
    const T* __restrict__ coeff, T* __restrict__ vcell, int c0, int C) {
  using L = CellLayout<P>;
  constexpr int M = L::M, M2 = L::M2, M3 = L::M3, CPB = L::CPB;
  const int tid = threadIdx.x;
  T(*N)[M] = sh[0];
  T(*Dx)[M] = sh[1];
  T(*Dy)[M] = sh[2];
  T(*Dz)[M] = sh[3];

  // forward x: a[z][y][qx] = sum_x N[qx][x] u[z][y][x], d1 with Dx
  for (int i = tid; i < CPB * M3; i += kCellThreads) {
    const int q = i % M;
    const T* row = &buf[0][i - q];
    T a = T(0), d = T(0);
#pragma unroll
    for (int s = 0; s < M; ++s) {
      a += N[q][s] * row[s];
      d += Dx[q][s] * row[s];
    }
    buf[1][i] = a;
    buf[2][i] = d;
  }
  __syncthreads();
  // forward y: b = N a, c = Dy a, e = N d1 along y
  for (int i = tid; i < CPB * M3; i += kCellThreads) {
    const int q = (i / M) % M;
    const int base = i - q * M;
    T b = T(0), c = T(0), e = T(0);
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const T a = buf[1][base + s * M];
      b += N[q][s] * a;
      c += Dy[q][s] * a;
      e += N[q][s] * buf[2][base + s * M];
    }
    buf[3][i] = b;
    buf[4][i] = c;
    buf[5][i] = e;
  }
  __syncthreads();
  // forward z: gz = Dz b, gy = N c, gx = N e; then t = C g
  for (int i = tid; i < CPB * M3; i += kCellThreads) {
    const int k = i / M3, l = i - k * M3;
    const int q = l / M2;
    const int base = i - q * M2;
    T gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
    for (int s = 0; s < M; ++s) {
      gz += Dz[q][s] * buf[3][base + s * M2];
      gy += N[q][s] * buf[4][base + s * M2];
      gx += N[q][s] * buf[5][base + s * M2];
    }
    T tx = T(0), ty = T(0), tz = T(0);
    const int c = c0 + k;
    if (c < C) {
      const T* cc = coeff + static_cast<size_t>(c) * 6 * M3 + l;
      const T cxx = cc[0], cyy = cc[M3], czz = cc[2 * M3];
      const T cxy = cc[3 * M3], cxz = cc[4 * M3], cyz = cc[5 * M3];
      tx = cxx * gx + cxy * gy + cxz * gz;
      ty = cxy * gx + cyy * gy + cyz * gz;
      tz = cxz * gx + cyz * gy + czz * gz;
    }
    buf[0][i] = tx;
    buf[1][i] = ty;
    buf[2][i] = tz;
  }
  __syncthreads();
  // backward z: w1 = Dz^T tz, w2 = N^T ty, w3 = N^T tx
  for (int i = tid; i < CPB * M3; i += kCellThreads) {
    const int z = (i % M3) / M2;
    const int base = i - z * M2;
    T w1 = T(0), w2 = T(0), w3 = T(0);
#pragma unroll
    for (int q = 0; q < M; ++q) {
      w1 += Dz[q][z] * buf[2][base + q * M2];
      w2 += N[q][z] * buf[1][base + q * M2];
      w3 += N[q][z] * buf[0][base + q * M2];
    }
    buf[3][i] = w1;
    buf[4][i] = w2;
    buf[5][i] = w3;
  }
  __syncthreads();
  // backward y: r12 = N^T w1 + Dy^T w2, r3 = N^T w3
  for (int i = tid; i < CPB * M3; i += kCellThreads) {
    const int y = (i / M) % M;
    const int base = i - y * M;
    T r12 = T(0), r3 = T(0);
#pragma unroll
    for (int q = 0; q < M; ++q) {
      r12 += N[q][y] * buf[3][base + q * M] + Dy[q][y] * buf[4][base + q * M];
      r3 += N[q][y] * buf[5][base + q * M];
    }
    buf[0][i] = r12;
    buf[1][i] = r3;
  }
  __syncthreads();
  // backward x: v = N^T r12 + Dx^T r3, written per cell
  for (int i = tid; i < CPB * M3; i += kCellThreads) {
    const int k = i / M3, l = i - k * M3;
    const int c = c0 + k;
    if (c >= C) continue;
    const int x = l % M;
    const int base = i - x;
    T v = T(0);
#pragma unroll
    for (int q = 0; q < M; ++q)
      v += N[q][x] * buf[0][base + q] + Dx[q][x] * buf[1][base + q];
    vcell[static_cast<size_t>(c) * M3 + l] = v;
  }
}

}  // namespace dat
