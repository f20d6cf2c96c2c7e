// Materialized-pyramid window lookup, forward and backward, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernels `_pyr_multi_fwd_kernel` (+ `_pyr_fwd_level_body`)
// and `_pyr_multi_bwd_kernel` (+ `_pyr_bwd_level_body`) in
// raft_tpu/ops/pallas_corr.py, reached through `pallas_pyramid_lookup`
// (its custom_vjp `_pyr_fwd` / `_pyr_bwd`), and the same forward body on a
// quantized pyramid, `pallas_pyramid_lookup_quantized` (primal only).
//
// Function.  Level l of the pyramid is (B, N, Hl, Wl): query n's
// correlation row over the level's pixels, stored fp32 or bf16, or as
// int8 / fp8 (e4m3, e5m2) codes with one fp32 scale per (batch, level),
// whose taps are the codes' samples times the scale.  For
// query n with level-0 center c = coords[b, n] and level center c / 2^l
// (no half-pixel offset), tap (i, j) is the bilinear (align-corners,
// zeros padding) sample at (c.x + i - r, c.y + j - r) of the row; the
// output channel is l*k*k + i*k + j (x-major, k = 2r+1).  An empty level
// (Hl or Wl = 0) gives zeros.  The backward is the exact transpose: a
// dense dcorr row per query and level, zero outside the window, in the
// level's dtype.  All arithmetic is fp32.
//
// What bounds it on an H100.  Forward: per query and level the window
// touches (k+1)^2 = 100 stored values, so at the chairs training shape
// (B = 8, N = 2852, four levels) a lookup needs about 9 M values (36 MB
// fp32, 9 MB as one-byte codes) plus the taps (30 MB fp32): ~20 us at
// 3.35 TB/s (~12 us from codes), and only ~0.1 GFLOP.  Backward: the
// dense dcorr write, 345 MB fp32 (173 MB bf16) per lookup, ~103 us
// (52 us) at 3.35 TB/s; that write is the bound and the window
// arithmetic is noise beside it.
//
// Design.  The TPU kernel scans every row of a level for every query
// block on the VPU, because the TPU has no cheap gather; here each query
// reads only its window:
//   - one warp per query, QPB = 8 queries (warps) per block, grid
//     (N / QPB, B);
//   - forward: per level the warp loads the (k+1)^2 window positions of
//     its query's row (ten short runs of ten values), zeros outside the
//     level, into shared memory, forms the k*k taps with the JAX
//     operation order (y interpolation first, then x), and stages them in
//     a tile that is written with the caller's strides (query-major
//     (B, N, P) or channel-major (B, P, N), both coalesced);
//   - backward: the block stages its queries' tap gradients in shared
//     memory (read coalesced in either layout); per level each warp forms
//     its query's (k+1)^2 window gradient there (a gather over the <= 4
//     taps touching each position: race-free, no atomics), then the
//     block writes its QPB
//     contiguous dcorr rows, warps over rows and lanes over columns, zero
//     outside the windows;
//   - far-off and non-finite centers are tested in float before any int
//     cast and give zero taps (forward) and zero rows (backward).

#include "pyramid_window.cuh"

#define QPB 8  // queries (warps) per block

template <typename T, typename To>
__global__ void __launch_bounds__(32 * QPB)
pyr_fwd_kernel(Levels<T> lv, const float* __restrict__ coords,
               const float* __restrict__ scale, int L, int N, int radius,
               To* __restrict__ out, long long out_sb, long long out_sq,
               long long out_sp) {
  const int k = 2 * radius + 1;
  const int npos = (k + 1) * (k + 1);
  const int kk = k * k;
  const int P = L * kk;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* tile = smem;                              // (QPB, P)
  float* vals = smem + QPB * P + warp * npos;      // (k+1)^2 per warp
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QPB;
  const int q = q0 + warp;

  if (q < N) {
    const long long qi = (long long)b * N + q;
    const float cx0 = coords[qi * 2 + 0];
    const float cy0 = coords[qi * 2 + 1];
    for (int l = 0; l < L; ++l) {
      // a quantized level's taps are its codes' samples times the
      // (batch, level) scale
      const float s = scale ? scale[b * L + l] : 1.0f;
      warp_window_taps(lv.p[l], qi, lv.h[l], lv.w[l], l, cx0, cy0, radius,
                       s, vals, tile + warp * P + l * kk, 1, lane);
    }
  }
  __syncthreads();

  const int nq = min(QPB, N - q0);
  To* ob = out + (long long)b * out_sb;
  if (out_sp == 1) {
    // query-major rows: each query's P taps are contiguous
    for (int e = threadIdx.x; e < nq * P; e += blockDim.x) {
      const int qq = e / P, p = e % P;
      ob[(long long)(q0 + qq) * out_sq + p] = from_f<To>(tile[qq * P + p]);
    }
  } else {
    // channel-major planes: QPB consecutive queries per channel
    for (int e = threadIdx.x; e < QPB * P; e += blockDim.x) {
      const int p = e / QPB, qq = e % QPB;
      if (qq < nq)
        ob[(long long)p * out_sp + (long long)(q0 + qq) * out_sq] =
            from_f<To>(tile[qq * P + p]);
    }
  }
}

template <typename T, typename Tg>
__global__ void __launch_bounds__(32 * QPB)
pyr_bwd_kernel(Levels<T> lv, const float* __restrict__ coords,
               const Tg* __restrict__ g, long long g_sb, long long g_sq,
               long long g_sp, int L, int N, int radius) {
  const int k = 2 * radius + 1;
  const int kp = k + 1;
  const int npos = kp * kp;
  const int kk = k * k;
  const int P = L * kk;
  extern __shared__ float smem[];
  float* gtile = smem;                                   // (QPB, P)
  float* gw = smem + QPB * P;                            // (QPB, L, npos)
  int* meta = reinterpret_cast<int*>(gw + QPB * L * npos);  // (QPB, L, 3)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QPB;
  const int q = q0 + warp;
  const int nq = min(QPB, N - q0);

  // Stage the block's tap gradients (fp32 or bf16, the taps' dtype) as
  // fp32, read coalesced in either layout.
  const Tg* gb = g + (long long)b * g_sb;
  if (g_sp == 1) {
    for (int e = threadIdx.x; e < nq * P; e += blockDim.x) {
      const int qq = e / P, p = e % P;
      gtile[qq * P + p] = to_f(gb[(long long)(q0 + qq) * g_sq + p]);
    }
  } else {
    for (int e = threadIdx.x; e < QPB * P; e += blockDim.x) {
      const int p = e / QPB, qq = e % QPB;
      if (qq < nq)
        gtile[qq * P + p] =
            to_f(gb[(long long)p * g_sp + (long long)(q0 + qq) * g_sq]);
    }
  }
  __syncthreads();

  if (q < N) {
    const long long qi = (long long)b * N + q;
    const float cx0 = coords[qi * 2 + 0];
    const float cy0 = coords[qi * 2 + 1];
    const float* gq = gtile + warp * P;
    for (int l = 0; l < L; ++l) {
      const Window wd = window_of(cx0, cy0, l, lv.h[l], lv.w[l], radius);
      int* m = meta + (warp * L + l) * 3;
      if (lane == 0) {
        m[0] = wd.any;
        m[1] = wd.x0;
        m[2] = wd.y0;
      }
      if (!wd.any) continue;
      const float fx = wd.fx, fy = wd.fy;
      float* gwl = gw + (warp * L + l) * npos;
      for (int p = lane; p < npos; p += 32) {
        const int a = p / kp, c = p % kp;  // a walks y, c walks x
        float val = 0.0f;
        // dcorr(y, x) = sum_j wy_j(y) sum_i wx_i(x) g(i, j): tap j = a-1
        // reaches row a with weight fy, tap j = a with 1 - fy (and i
        // likewise along x)
        for (int j = a - 1; j <= a; ++j) {
          if (j < 0 || j >= k) continue;
          float bj = 0.0f;
          for (int i = c - 1; i <= c; ++i) {
            if (i < 0 || i >= k) continue;
            const float wx = (i == c) ? 1.0f - fx : fx;
            bj += wx * gq[l * kk + i * k + j];
          }
          const float wy = (j == a) ? 1.0f - fy : fy;
          val += wy * bj;
        }
        gwl[p] = val;
      }
    }
  }
  __syncthreads();

  // Dense write: the block's nq rows of each level are contiguous.
  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const long long hw = (long long)hl * wl;
    T* dst = lv.p[l] + ((long long)b * N + q0) * hw;
    for (int qq = 0; qq < nq; ++qq) {
      const int* m = meta + (qq * L + l) * 3;
      const bool any = m[0];
      const int x0 = m[1], y0 = m[2];
      const float* gwl = gw + (qq * L + l) * npos;
      T* row = dst + qq * hw;
      for (int y = warp; y < hl; y += QPB) {
        const unsigned dy = (unsigned)(y - y0);
        for (int x = lane; x < wl; x += 32) {
          const unsigned dx = (unsigned)(x - x0);
          const float v = (any && dy < (unsigned)kp && dx < (unsigned)kp)
                              ? gwl[dy * kp + dx]
                              : 0.0f;
          row[(long long)y * wl + x] = from_f<T>(v);
        }
      }
    }
  }
}

template <typename T, typename To>
static void launch_fwd(const long long* ptrs, const int* hs, const int* ws,
                       int L, int B, int N, int radius, const float* coords,
                       const float* scale, void* out, long long sb,
                       long long sq, long long sp, cudaStream_t st) {
  const int k = 2 * radius + 1;
  const size_t smem =
      (size_t)QPB * (L * k * k + (k + 1) * (k + 1)) * sizeof(float);
  const dim3 grid((N + QPB - 1) / QPB, B);
  pyr_fwd_kernel<T, To><<<grid, 32 * QPB, smem, st>>>(
      make_levels<T>(ptrs, hs, ws, L), coords, scale, L, N, radius,
      reinterpret_cast<To*>(out), sb, sq, sp);
}

template <typename T, typename Tg>
static void launch_bwd(const long long* ptrs, const int* hs, const int* ws,
                       int L, int B, int N, int radius, const float* coords,
                       const void* g, long long sb, long long sq,
                       long long sp, cudaStream_t st) {
  const int k = 2 * radius + 1;
  const size_t smem =
      (size_t)QPB * (L * k * k + L * ((k + 1) * (k + 1) + 3)) * 4;
  const dim3 grid((N + QPB - 1) / QPB, B);
  pyr_bwd_kernel<T, Tg><<<grid, 32 * QPB, smem, st>>>(
      make_levels<T>(ptrs, hs, ws, L), coords,
      reinterpret_cast<const Tg*>(g), sb, sq, sp, L, N, radius);
}

template <typename T>
static void launch_fwd_to(int out_dtype, const long long* ptrs, const int* hs,
                          const int* ws, int L, int B, int N, int radius,
                          const float* coords, const float* scale, void* out,
                          long long sb, long long sq, long long sp,
                          cudaStream_t st) {
  if (out_dtype == 0)
    launch_fwd<T, float>(ptrs, hs, ws, L, B, N, radius, coords, scale, out,
                         sb, sq, sp, st);
  else
    launch_fwd<T, __nv_bfloat16>(ptrs, hs, ws, L, B, N, radius, coords,
                                 scale, out, sb, sq, sp, st);
}

// Level dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = fp8 e4m3,
// 4 = fp8 e5m2; tap and gradient dtype codes: 0 = float32, 1 = bfloat16.
// `scale` is null for plain levels and a (B, L) fp32 array for quantized
// ones.  Returns a cudaError_t (0 = success).  Level arrays are host arrays
// of L entries; strides are in elements.
extern "C" int pyramid_lookup_fwd(int device, int level_dtype, int out_dtype,
                                  const long long* level_ptrs, const int* hs,
                                  const int* ws, int L, int B, int N,
                                  int radius, const void* coords,
                                  const void* scale, void* out,
                                  long long out_sb, long long out_sq,
                                  long long out_sp, void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 1 || N < 1 || radius < 0 ||
      level_dtype < 0 || level_dtype > 4 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* c = reinterpret_cast<const float*>(coords);
  const float* sc = reinterpret_cast<const float*>(scale);
#define FWD(T)                                                             \
  launch_fwd_to<T>(out_dtype, level_ptrs, hs, ws, L, B, N, radius, c, sc, \
                   out, out_sb, out_sq, out_sp, st)
  switch (level_dtype) {
    case 0: FWD(float); break;
    case 1: FWD(__nv_bfloat16); break;
    case 2: FWD(int8_t); break;
    case 3: FWD(__nv_fp8_e4m3); break;
    default: FWD(__nv_fp8_e5m2); break;
  }
#undef FWD
  return (int)cudaGetLastError();
}

extern "C" int pyramid_lookup_bwd(int device, int level_dtype, int g_dtype,
                                  const long long* dlevel_ptrs, const int* hs,
                                  const int* ws, int L, int B, int N,
                                  int radius, const void* coords,
                                  const void* g, long long g_sb,
                                  long long g_sq, long long g_sp,
                                  void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 1 || N < 1 || radius < 0 ||
      level_dtype < 0 || level_dtype > 1 || g_dtype < 0 || g_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* c = reinterpret_cast<const float*>(coords);
  if (level_dtype == 0 && g_dtype == 0)
    launch_bwd<float, float>(dlevel_ptrs, hs, ws, L, B, N, radius, c, g,
                             g_sb, g_sq, g_sp, st);
  else if (level_dtype == 0)
    launch_bwd<float, __nv_bfloat16>(dlevel_ptrs, hs, ws, L, B, N, radius, c,
                                     g, g_sb, g_sq, g_sp, st);
  else if (g_dtype == 0)
    launch_bwd<__nv_bfloat16, float>(dlevel_ptrs, hs, ws, L, B, N, radius, c,
                                     g, g_sb, g_sq, g_sp, st);
  else
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(dlevel_ptrs, hs, ws, L, B, N,
                                             radius, c, g, g_sb, g_sq, g_sp,
                                             st);
  return (int)cudaGetLastError();
}
