// Window sampling of a query-major correlation pyramid, shared by the
// pyramid lookup (pyramid_lookup.cu) and the fused lookup + convc1 kernel
// (lookup_encode.cu).
//
// Level l is (B, N, Hl, Wl): query n's correlation row over the level's
// pixels, stored fp32, bf16, int8 or fp8 (e4m3 / e5m2).  For query n with
// level-0 center c and level center c / 2^l (no half-pixel offset), tap
// (i, j) is the bilinear (align-corners, zeros padding) sample at
// (c.x + i - r, c.y + j - r) of the row, tap index i*k + j (x-major,
// k = 2r+1).  Stored values convert to fp32 exactly; all arithmetic is
// fp32.
//
// Non-finite centers: a NaN in either coordinate gives k*k NaN taps on
// every non-empty level (its bilinear weights are NaN, as in the plain
// versions and the TPU kernels); an infinite or far-off center gives
// zeros; an empty level (Hl or Wl = 0) gives zeros whatever the center.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#define MAX_LEVELS 8

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f(__nv_fp8_e5m2 v) {
  return static_cast<float>(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

template <typename T>
struct Levels {
  T* p[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

template <typename T>
static Levels<T> make_levels(const long long* ptrs, const int* hs,
                             const int* ws, int L) {
  Levels<T> lv;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.p[l] = l < L ? reinterpret_cast<T*>(ptrs[l]) : nullptr;
    lv.h[l] = l < L ? hs[l] : 0;
    lv.w[l] = l < L ? ws[l] : 0;
  }
  return lv;
}

// Window of one query at one level: its integer origin (x0, y0), the
// fractional offsets, whether it overlaps the level at all, and whether
// its center is NaN on a non-empty level (then `any` is false and every
// tap, and every value of the query's gradient row, is NaN).  Written in
// float so far-out or non-finite centers never reach an int cast.
struct Window {
  int x0, y0;
  float fx, fy;
  bool any, nan;
};

__device__ __forceinline__ Window window_of(float cx0, float cy0, int l,
                                            int hl, int wl, int radius) {
  const int kp = 2 * radius + 2;
  const float s = 1.0f / (float)(1 << l);  // exact power of two
  const float cx = cx0 * s, cy = cy0 * s;
  const float fx0 = floorf(cx), fy0 = floorf(cy);
  Window w;
  w.any = hl > 0 && wl > 0 && fx0 > -(float)(2 * kp) &&
          fx0 < (float)(wl + 2 * kp) && fy0 > -(float)(2 * kp) &&
          fy0 < (float)(hl + 2 * kp);
  w.x0 = w.any ? (int)fx0 - radius : 0;
  w.y0 = w.any ? (int)fy0 - radius : 0;
  w.nan = hl > 0 && wl > 0 && (cx0 != cx0 || cy0 != cy0);
  w.fx = cx - fx0;
  w.fy = cy - fy0;
  return w;
}
