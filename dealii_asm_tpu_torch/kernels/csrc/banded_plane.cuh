// The plane pipeline pieces of the banded Laplace, shared by kernel A
// (banded_laplace.cu) and the residual stages of kernel C
// (smoother_step.cu: the copy):
//
//   v = Kz My Mx u0 + Mz Ky Mx u0 + Mz My Kx u0
//
// streamed plane by plane along z: an x plane (with its band halo) is copied
// into shared memory with cp.async, banded along x (Mx u0, Kx u0), then along
// y, giving the pair (My Mx u0, Ky Mx u0 + My Kx u0) of each node; the z band
// sums 2p+1 such pairs per output plane.
//
// The z band in scatter form (zband_push / zband_pop): a thread keeps, for
// each of its nodes, 2p+1 partial sums acc[j] of the output planes
// zo = z - p + j, where z is the plane just pushed.  Plane z adds
// Kz[2p-j][zo] b + Mz[2p-j][zo] c to acc[j]; acc[0] is then complete and
// popped, and the others shift down.  The indices are fixed after
// unrolling, so the sums stay in registers (a ring indexed by a running
// slot would go to local memory), and each output sums its 2p+1 terms in
// the order of the gather form (input planes ascending).
#pragma once

#include "fdm_tile.cuh"

namespace dat {

// Pairs of T in one 8- or 16-byte load.
template <typename T>
struct Pair2;
template <>
struct Pair2<float> {
  using type = float2;
};
template <>
struct Pair2<double> {
  using type = double2;
};

// Asynchronous copy of one element from device to shared memory, zero
// where pred is false (cp.async; the caller waits with copy_async_wait and
// a barrier).  A host compilation pass sees a plain copy.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool pred) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)), "r"(pred ? int(sizeof(T)) : 0));
#else
  *dst = pred ? *src : T(0);
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// acc[j] += kz[j] b + mz[j] c for the 2p+1 output planes plane z feeds.
template <typename T, int B>
__device__ __forceinline__ void zband_push(T (&acc)[B], T b, T c,
                                           const T (&kz)[B],
                                           const T (&mz)[B]) {
#pragma unroll
  for (int j = 0; j < B; ++j) acc[j] += kz[j] * b + mz[j] * c;
}

// The completed output plane's sum; the others move down one slot.
template <typename T, int B>
__device__ __forceinline__ T zband_pop(T (&acc)[B]) {
  const T v = acc[0];
#pragma unroll
  for (int j = 0; j < B - 1; ++j) acc[j] = acc[j + 1];
  acc[B - 1] = T(0);
  return v;
}

// Kernel A's block: a WX x WY tile of output nodes (WX a multiple of 32,
// so that a warp is one row of the tile) streaming at most CZ output planes,
// `threads` threads; minb is its __launch_bounds__ minimum of blocks per SM.
// Chosen by timing variants at 64^3 Q4 on the H100 (tools/tile_sweep.py,
// PERF.md); kernels/banded_laplace.py::launch_plan mirrors it.
struct BandShape {
  int wx, wy, cz, threads, minb;
};

constexpr BandShape band_shape(int p, int itemsize) {
  if (itemsize == 4 && p == 4) return BandShape{64, 16, 64, 256, 2};
  return itemsize == 8 && p >= 5 ? BandShape{32, 8, 64, 256, 2}
                                 : BandShape{32, 16, 64, 256, 2};
}

// Shared-memory layout of kernel A's block, in elements: two raw planes
// with the band halo (HY x HXS each), two x-band planes of pairs (HY x WX
// pairs each), the x, y and z tables (the z tables of the ZT output planes
// the chunk's input planes feed: CZ + 1 own planes, 2p on each side).
struct BandLayout {
  int B, HY, HX, HXS, XSZ, SSZ, ZT;
};

constexpr BandLayout band_layout(int p, BandShape s) {
  return BandLayout{2 * p + 1,         s.wy + 2 * p,
                    s.wx + 2 * p,      odd(s.wx + 2 * p),
                    pad4((s.wy + 2 * p) * odd(s.wx + 2 * p)),
                    (s.wy + 2 * p) * s.wx, s.cz + 1 + 4 * p};
}

constexpr int band_elems(int p, int itemsize) {
  const BandShape s = band_shape(p, itemsize);
  const BandLayout L = band_layout(p, s);
  return 2 * L.XSZ + 4 * L.SSZ + 2 * L.B * (s.wx + s.wy + L.ZT);
}

}  // namespace dat
