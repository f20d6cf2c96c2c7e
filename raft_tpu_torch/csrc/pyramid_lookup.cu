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
// level's dtype.  All arithmetic is fp32.  Non-finite centers as in
// pyramid_window.cuh: a NaN center gives NaN taps and a dcorr row that is
// NaN everywhere on each non-empty level (its weights are NaN at every
// position, as in the TPU kernel); an infinite or far-off one gives zero
// taps and a zero row.
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
// reads only its window.
//   - Forward: one warp per query, QPB = 8 queries (warps) per block, grid
//     (N / QPB, B).  Per level the warp loads the (k+1)^2 window positions
//     of its query's row (ten short runs of ten values), zeros outside the
//     level, into shared memory, forms the k*k taps with the JAX
//     operation order (y interpolation first, then x), and stages them in
//     a tile that is written with the caller's strides (query-major
//     (B, N, P) or channel-major (B, P, N), both coalesced).
//   - Backward: one block of BNT = 256 threads per (level, batch element,
//     BQ = 32 consecutive queries), level 0 (the largest) first, so the
//     blocks are many and alike.  The block stages the level's tap
//     gradients of its queries (read coalesced in either layout), forms
//     each query's (k+1)^2 window gradient (a gather over the <= 4 taps
//     touching each position: race-free, no atomics), then writes its
//     dense rows, which are one contiguous span, flat in 16-byte
//     evict-first stores (4 fp32 or 8 bf16 values; a scalar head to the
//     first 16-byte boundary and a scalar tail).  A vector that misses the
//     flat bounds of its query's window rows, as most do, is a bare zero
//     store (NaN for a NaN center's row).  No integer division by a
//     runtime size runs per value (a float estimate and one correction,
//     or a table built once per block), and the level tables are
//     __grid_constant__ (indexed by a runtime level, a copy of them in
//     local memory otherwise).  The first design wrote the rows with
//     lanes over x (a warp pass 22-97% full at the chairs widths 62, 31,
//     15, 7), one scalar 2- or 4-byte store per value, 8 queries per
//     block: 0.249 ms fp32 and 0.226 bf16 at chairs (PERF.md), 45% and 25%
//     of the write bound.  The values are unchanged: the same window
//     arithmetic, one rounding to the level's dtype.
//   - Far-off and non-finite centers are tested in float before any int
//     cast.

#include "pyramid_window.cuh"

#include <algorithm>

#define QPB 8        // queries (warps) per block of the forward
#define BQ 32        // queries per block of the backward
#define BNT 256      // threads per block of the backward

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

// 16 bytes of T: V values per vector store, evict-first (`__stcs`: the
// dense rows are written once and not read back by this kernel).
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(u[0], u[1], u[2], u[3]));
  }
};

// Per query and level of the backward: window origin, the flat bounds
// [lo, hi] of the window's rows within the query's dense row, the mode
// (0: no window, 1: window, 2: NaN center) and the fractional offsets.
enum { M_X0, M_Y0, M_LO, M_HI, M_MODE, M_FX, M_FY, M_INTS = 8 };

// x / d for 0 <= x < 2^24 from a float estimate (exact float product, off
// by at most one) and one correction: a few instructions where an integer
// division by a runtime value takes tens.
__device__ __forceinline__ int div_near(int x, int d, float inv_d) {
  int q = (int)((float)x * inv_d);
  q -= q * d > x;
  q += (q + 1) * d <= x;
  return q;
}

// dcorr at position `pos` of the query row with meta `m` and window
// gradients `gwq`.
__device__ __forceinline__ float dcorr_at(const int* m, const float* gwq,
                                          int pos, int wl, int kp) {
  if (m[M_MODE] == 2) return CUDART_NAN_F;
  if (m[M_MODE] == 0 || pos < m[M_LO] || pos > m[M_HI]) return 0.0f;
  const int y = pos / wl;
  const unsigned dy = (unsigned)(y - m[M_Y0]);
  const unsigned dx = (unsigned)(pos - y * wl - m[M_X0]);
  return (dy < (unsigned)kp && dx < (unsigned)kp) ? gwq[dy * kp + dx] : 0.0f;
}

// The backward's blocks: level by level (level 0, the largest, first),
// then batch element, then BQ consecutive queries; level l holds blocks
// [first[l], first[l + 1]).
struct BwdPlan {
  int first[MAX_LEVELS + 1];
};

template <typename T, typename Tg>
__global__ void __launch_bounds__(BNT)
pyr_bwd_kernel(const __grid_constant__ Levels<T> lv,
               const __grid_constant__ BwdPlan plan,
               const float* __restrict__ coords,
               const Tg* __restrict__ g, long long g_sb, long long g_sq,
               long long g_sp, int L, int N, int radius) {
  constexpr int V = Vec16<T>::V;
  const int k = 2 * radius + 1;
  const int kp = k + 1;
  const int npos = kp * kp;
  const int kk = k * k;
  extern __shared__ __align__(16) float smem[];
  float* gt = smem;                                    // (BQ, kk)
  float* gw = gt + BQ * kk;                            // (BQ, npos)
  int* meta = reinterpret_cast<int*>(gw + BQ * npos);  // (BQ, M_INTS)
  int* ptab = meta + BQ * M_INTS;  // window position -> (y << 16) | x
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int l = 0;
  while (l + 1 < L && (int)blockIdx.x >= plan.first[l + 1]) ++l;
  const int chunks = (N + BQ - 1) / BQ;
  const int rel = blockIdx.x - plan.first[l];
  const int b = rel / chunks;
  const int q0 = (rel - b * chunks) * BQ;
  const int nq = min(BQ, N - q0);
  const int hl = lv.h[l], wl = lv.w[l];
  const int hw = hl * wl;  // > 0: an empty level has no blocks
  const float inv_hw = 1.0f / (float)hw, inv_wl = 1.0f / (float)wl;

  if (tid < nq) {
    const long long qi = (long long)b * N + q0 + tid;
    const Window wd =
        window_of(coords[qi * 2 + 0], coords[qi * 2 + 1], l, hl, wl, radius);
    const int x0c = max(wd.x0, 0), x1c = min(wd.x0 + kp - 1, wl - 1);
    const int y0c = max(wd.y0, 0), y1c = min(wd.y0 + kp - 1, hl - 1);
    int* m = meta + tid * M_INTS;
    m[M_X0] = wd.x0;
    m[M_Y0] = wd.y0;
    m[M_LO] = wd.nan ? 0 : y0c * wl + x0c;
    m[M_HI] = wd.nan ? hw - 1 : y1c * wl + x1c;
    m[M_MODE] = wd.nan ? 2 : (wd.any && x0c <= x1c && y0c <= y1c);
    m[M_FX] = __float_as_int(wd.fx);
    m[M_FY] = __float_as_int(wd.fy);
  }
  for (int p = tid; p < npos; p += BNT) ptab[p] = ((p / kp) << 16) | (p % kp);
  // the tap gradients of the block's queries at level l as fp32, read
  // coalesced in either layout
  const Tg* gb = g + (long long)b * g_sb;
  if (g_sp == 1) {
    for (int qq = warp; qq < nq; qq += BNT / 32)
      for (int t = lane; t < kk; t += 32)
        gt[qq * kk + t] = to_f(gb[(long long)(q0 + qq) * g_sq + l * kk + t]);
  } else {
    for (int t = warp; t < kk; t += BNT / 32)
      for (int qq = lane; qq < nq; qq += 32)
        gt[qq * kk + t] = to_f(gb[(long long)(l * kk + t) * g_sp +
                                  (long long)(q0 + qq) * g_sq]);
  }
  __syncthreads();  // gt, meta and ptab
  // window gradients: each position sums the <= 4 taps that read it (a
  // gather: race-free, no atomics), a warp per query, lanes over positions
  for (int qq = warp; qq < nq; qq += BNT / 32) {
    const int* m = meta + qq * M_INTS;
    if (m[M_MODE] != 1) continue;  // warp-uniform
    const float fx = __int_as_float(m[M_FX]), fy = __int_as_float(m[M_FY]);
    const float* gq = gt + qq * kk;
    for (int p = lane; p < npos; p += 32) {
      const int a = ptab[p] >> 16, c = ptab[p] & 0xffff;  // y, x
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
          bj += wx * gq[i * k + j];
        }
        const float wy = (j == a) ? 1.0f - fy : fy;
        val += wy * bj;
      }
      gw[qq * npos + p] = val;
    }
  }
  __syncthreads();

  // Dense write: the block's nq rows are one contiguous span, written
  // flat: a scalar head up to the first 16-byte boundary, 16-byte
  // vectors, a scalar tail.  A vector in one query row that meets no
  // window column of a window row (most) is a bare zero store, or NaN for
  // a NaN center's row; one in one window row reads that row's window
  // gradients; one that runs past a row end takes the values one by one.
  T* span = lv.p[l] + ((long long)b * N + q0) * hw;
  const int total = nq * hw;
  const int mis = (int)(((long long)b * N + q0) * hw % V);
  const int head = min(total, (V - mis) % V);
  const int nvec = (total - head) / V;
  for (int e = tid; e < head; e += BNT) {
    const int qq = e / hw;
    span[e] = from_f<T>(dcorr_at(meta + qq * M_INTS, gw + qq * npos,
                                 e - qq * hw, wl, kp));
  }
#pragma unroll 2
  for (int iv = tid; iv < nvec; iv += BNT) {
    const int e0 = head + iv * V;
    const int qq = div_near(e0, hw, inv_hw);
    const int pos = e0 - qq * hw;
    const int* m = meta + qq * M_INTS;
    const int mode = m[M_MODE];
    float v[V];
    if (pos + V > hw) {  // runs into the next rows (hw may be < V)
      int qe = qq, pe = pos;
#pragma unroll
      for (int i = 0; i < V; ++i, ++pe) {
        if (pe == hw) {
          pe = 0;
          ++qe;
        }
        v[i] = dcorr_at(meta + qe * M_INTS, gw + qe * npos, pe, wl, kp);
      }
    } else if (mode == 0 ||
               (mode == 1 && (pos + V - 1 < m[M_LO] || pos > m[M_HI]))) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.0f;
    } else if (mode == 2) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = CUDART_NAN_F;
    } else {
      const float* gwq = gw + qq * npos;
      int y = div_near(pos, wl, inv_wl);
      int x = pos - y * wl;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const unsigned dy = (unsigned)(y - m[M_Y0]);
        const unsigned dx = (unsigned)(x - m[M_X0]);
        v[i] = (dy < (unsigned)kp && dx < (unsigned)kp) ? gwq[dy * kp + dx]
                                                        : 0.0f;
        if (++x == wl) {
          x = 0;
          ++y;
        }
      }
    }
    Vec16<T>::store(span + e0, v);
  }
  for (int e = head + nvec * V + tid; e < total; e += BNT) {
    const int qq = e / hw;
    span[e] = from_f<T>(dcorr_at(meta + qq * M_INTS, gw + qq * npos,
                                 e - qq * hw, wl, kp));
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

// Dynamic shared memory of one backward block (bytes).
static size_t bwd_smem_bytes(int radius) {
  const int k = 2 * radius + 1;
  return ((size_t)BQ * (k * k + (k + 1) * (k + 1) + M_INTS) +
          (k + 1) * (k + 1)) * 4;
}

// The first block of each level (empty levels get none).
static BwdPlan bwd_plan(const int* hs, const int* ws, int L, int B, int N) {
  BwdPlan p;
  int nb = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    p.first[l] = nb;
    if (l < L && hs[l] * ws[l]) nb += B * ((N + BQ - 1) / BQ);
  }
  p.first[MAX_LEVELS] = nb;
  return p;
}

template <typename T, typename Tg>
static void launch_bwd(const long long* ptrs, const int* hs, const int* ws,
                       int L, int B, int N, int radius, const float* coords,
                       const void* g, long long sb, long long sq,
                       long long sp, cudaStream_t st) {
  const BwdPlan plan = bwd_plan(hs, ws, L, B, N);
  if (plan.first[MAX_LEVELS] == 0) return;  // every level is empty
  pyr_bwd_kernel<T, Tg>
      <<<plan.first[MAX_LEVELS], BNT, bwd_smem_bytes(radius), st>>>(
          make_levels<T>(ptrs, hs, ws, L), plan, coords,
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
  for (int l = 0; l < L; ++l) {
    if (dlevel_ptrs[l] % 16)  // the vector stores need 16-byte bases
      return (int)cudaErrorMisalignedAddress;
    if ((long long)hs[l] * ws[l] * BQ >= (1 << 24))  // div_near's range
      return (int)cudaErrorInvalidValue;
  }
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
