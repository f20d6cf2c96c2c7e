// On-demand correlation window lookup, forward and backward, CUDA C++ for
// sm_90a.
//
// The forward replaces the TPU kernel `_odm_fwd_kernel` (+
// `_odm_fwd_level_body`) in raft_tpu/ops/pallas_corr.py, reached through
// `pallas_corr_lookup`; the backward (corr_ondemand_bwd, below the
// forward) replaces `_odm_bwd_kernel` and the blocked pair
// `_odm_bwd_df1_blocked_kernel` / `_odm_bwd_df2_blocked_kernel` of the
// same file, which compute one function.
//
// Function.  For query q = (b, n) with level-0 center c = coords[b, n]
// and level l with center c / 2^l, tap (i, j) samples the bilinear
// (align-corners, zeros padding) value at (c.x + i - r, c.y + j - r) of
// the correlation row <f1[b, n], f2_l[b, y, x]> / sqrt(C).  The output
// channel is l*k*k + i*k + j (x-major, k = 2r+1).  An empty level
// (Hl or Wl = 0) gives zeros.
//
// What bounds it on an H100.  Per query and level the bilinear window
// touches (k+1)^2 = 100 integer positions, each a C = 256 dot product:
// 100 * 256 * 2 * 4 levels ~ 205 kFLOP per query, 1.44 GFLOP at the
// Sintel shape (N = 7040), about 21 us at the 67 TFLOP/s fp32 CUDA-core
// peak; the unique bytes (f1 + f2 pyramid + taps, ~26 MB) take ~8 us
// at 3.35 TB/s.  So the floor is fp32 arithmetic.  In practice each
// query re-reads 100 rows of f2 (400 KB per query over four levels),
// served by L1/L2, so this simple design is bound by cache bandwidth
// well above that floor.
//
// Design.  The TPU kernel computed each query block's WHOLE correlation
// row with one matmul to feed the MXU (~33 GFLOP per lookup at Sintel
// shape); here only the window is computed, as in alt_cuda_corr:
//   - one warp per query, QPB = 8 queries (warps) per block;
//   - the warp keeps f1[q] in registers: lane (grp, sub) = (lane/8,
//     lane%8) holds the float4s sub, sub+8, ... of the channel vector,
//     the same slice for all four groups;
//   - per level, the four 8-lane groups each take one of the (k+1)^2
//     integer positions at a time: 128 contiguous bytes per group per
//     load (coalesced), fp32 FMAs, a 3-step xor-shuffle reduction;
//     positions outside the level contribute 0;
//   - the 100 dot products sit in shared memory, the 81 taps are formed
//     from them with the fractional weights (floorf handles negative
//     centers) and staged in a shared-memory tile of the block's queries;
//   - the tile is written with the caller's strides, so the same kernel
//     emits query-major (B, N, P) or channel-major (B, P, N) taps, both
//     coalesced.
// All arithmetic is fp32; inputs and output are fp32.
//
// Backward.  From the tap cotangent g (B, N, P) or (B, P, N), for query q
// and level l: dwin[p] = the transpose of the forward's tap formation
// (each tap hands its four bilinear weights to the four integer
// positions it read), over the window's (k+1)^2 positions, times
// 1/sqrt(C); then for every in-level position p
//   df1[q]   += dwin[p] * f2_l[p]
//   df2_l[p] += dwin[p] * f1[q]
// Far and non-finite centers contribute nothing, as in the forward; an
// empty level gets a zero df2_l; coords get no gradient.  The TPU moves a
// level onto the blocked pair only when the fused kernel's residency
// would overflow VMEM (>= 1088x1920 inputs); here f2 windows are read
// from device memory and L2 with no such limit, so one kernel serves
// every shape.
//
// What bounds the backward on an H100.  Twice the forward's window
// products: at the chairs training shape (batch 8, 46x62 grid, levels
// down to 5x7, C = 256) ~9.3 GFLOP a call (~0.14 ms at 67 TFLOP/s fp32)
// against ~140 MB of unique bytes (~0.04 ms).  In practice the df2
// scatter is the cost: every window position of every query adds C
// values into df2_l, ~2.3e9 fp32 atomic adds a call, and at the coarse
// levels nearly every query of a sample adds into the same few rows.
//
// Backward design, mirroring the forward:
//   - the block stages its QPB queries' tap cotangents in shared memory
//     (the transpose of the forward's tile store, coalesced in either
//     layout);
//   - one warp per query keeps f1[q] in registers (the forward's lane
//     mapping) and accumulates df1[q] there across all positions and
//     levels, reduced over the four 8-lane groups and written once;
//   - per level, dwin is gathered (not scattered) into shared memory:
//     each position sums the <= 4 taps that read it;
//   - each 8-lane group takes one position at a time: the f2 row is read
//     once (128 contiguous bytes per load) and serves df1, and df2_l's
//     row gets dwin * f1[q] by 16-byte vector atomicAdd (sm_90) into
//     buffers the caller zeroed.  The order of those adds changes from
//     run to run, so df2 varies in its last bits between runs.
// Measured on the H100 at the chairs shape (ops/corr_bwd_probe.py): with
// near-grid centers most of the time is the df2 adds, and the four
// levels cost about alike, so it is the volume of adds, not contention
// at the coarse levels.  A pre-sum of a 4 x 8 query tile's windows in
// shared memory (one lane per channel, shared atomics) was slower: its
// per-position instructions, not the global adds, became the limit.

#include <cuda_runtime.h>

#define MAX_LEVELS 8
#define QPB 8  // queries (warps) per block

struct Levels {
  const float* f2[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

template <int NV4>  // float4s per lane; C = 32 * NV4
__global__ void __launch_bounds__(32 * QPB)
corr_ondemand_kernel(const float* __restrict__ f1,      // (B, N, C)
                     const float* __restrict__ coords,  // (B, N, 2)
                     Levels lv, int L, int N, int radius, float inv_sqrt_c,
                     float* __restrict__ out, long long out_sb,
                     long long out_sq, long long out_sp) {
  constexpr int C = 32 * NV4;
  const int k = 2 * radius + 1;
  const int kp = k + 1;
  const int npos = kp * kp;
  const int P = L * k * k;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 3;
  const int sub = lane & 7;
  float* tile = smem;                              // (QPB, P)
  float* dots = smem + QPB * P + warp * npos;      // (k+1)^2 per warp
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QPB;
  const int q = q0 + warp;

  if (q < N) {
    const long long qi = (long long)b * N + q;
    const float4* f1q = reinterpret_cast<const float4*>(f1 + qi * C);
    float4 a[NV4];
#pragma unroll
    for (int t = 0; t < NV4; ++t) a[t] = f1q[t * 8 + sub];
    const float cx0 = coords[qi * 2 + 0];
    const float cy0 = coords[qi * 2 + 1];

    for (int l = 0; l < L; ++l) {
      const float s = 1.0f / (float)(1 << l);  // exact power of two
      const float cx = cx0 * s, cy = cy0 * s;
      const int hl = lv.h[l], wl = lv.w[l];
      const float fx0 = floorf(cx), fy0 = floorf(cy);
      // Warp-uniform: does the window overlap the level at all?  Written
      // in float so far-out or non-finite centers never reach an int cast.
      const bool any = hl > 0 && wl > 0 &&
                       fx0 > -(float)(2 * kp) && fx0 < (float)(wl + 2 * kp) &&
                       fy0 > -(float)(2 * kp) && fy0 < (float)(hl + 2 * kp);
      float* trow = tile + warp * P + l * k * k;
      if (!any) {
        for (int t = lane; t < k * k; t += 32) trow[t] = 0.0f;
        continue;
      }
      const int x0 = (int)fx0 - radius;
      const int y0 = (int)fy0 - radius;
      const float* f2l = lv.f2[l] + (long long)b * hl * wl * C;
      for (int p0 = 0; p0 < npos; p0 += 4) {
        const int p = p0 + grp;
        const int X = x0 + p % kp;
        const int Y = y0 + p / kp;
        const bool in = p < npos && X >= 0 && X < wl && Y >= 0 && Y < hl;
        float acc = 0.0f;
        if (in) {
          const float4* row = reinterpret_cast<const float4*>(
              f2l + ((long long)Y * wl + X) * C);
#pragma unroll
          for (int t = 0; t < NV4; ++t) {
            const float4 v = row[t * 8 + sub];
            acc += a[t].x * v.x + a[t].y * v.y + a[t].z * v.z + a[t].w * v.w;
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (sub == 0 && p < npos) dots[p] = acc * inv_sqrt_c;
      }
      __syncwarp();
      const float fx = cx - fx0, fy = cy - fy0;
      for (int t = lane; t < k * k; t += 32) {
        const int i = t / k, j = t % k;  // i walks x, j walks y
        const float* d = dots + j * kp + i;
        trow[t] = (1.0f - fy) * ((1.0f - fx) * d[0] + fx * d[1]) +
                  fy * ((1.0f - fx) * d[kp] + fx * d[kp + 1]);
      }
      __syncwarp();  // dots are rewritten by the next level
    }
  }
  __syncthreads();

  const int nq = min(QPB, N - q0);
  float* ob = out + (long long)b * out_sb;
  if (out_sp == 1) {
    // query-major rows: each query's P taps are contiguous
    for (int e = threadIdx.x; e < nq * P; e += blockDim.x) {
      const int qq = e / P, p = e % P;
      ob[(long long)(q0 + qq) * out_sq + p] = tile[qq * P + p];
    }
  } else {
    // channel-major planes: QPB consecutive queries per channel
    for (int e = threadIdx.x; e < QPB * P; e += blockDim.x) {
      const int p = e / QPB, qq = e % QPB;
      if (qq < nq)
        ob[(long long)p * out_sp + (long long)(q0 + qq) * out_sq] =
            tile[qq * P + p];
    }
  }
}

template <int NV4>
static void launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const float* f1, const float* coords, const Levels& lv,
                   int L, int N, int radius, float inv_sqrt_c, float* out,
                   long long sb, long long sq, long long sp) {
  corr_ondemand_kernel<NV4><<<grid, 32 * QPB, smem, stream>>>(
      f1, coords, lv, L, N, radius, inv_sqrt_c, out, sb, sq, sp);
}

// Returns a cudaError_t (0 = success).  f2_ptrs/hs/ws are host arrays of
// L entries; out strides are in elements.
extern "C" int corr_ondemand_fwd(int device, const void* f1, const void* coords,
                                 const long long* f2_ptrs, const int* hs,
                                 const int* ws, int L, int B, int N, int C,
                                 int radius, float inv_sqrt_c, void* out,
                                 long long out_sb, long long out_sq,
                                 long long out_sp, void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 1 || N < 1 || radius < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.f2[l] = l < L ? reinterpret_cast<const float*>(f2_ptrs[l]) : nullptr;
    lv.h[l] = l < L ? hs[l] : 0;
    lv.w[l] = l < L ? ws[l] : 0;
  }
  const int k = 2 * radius + 1;
  const size_t smem =
      (size_t)QPB * (L * k * k + (k + 1) * (k + 1)) * sizeof(float);
  const dim3 grid((N + QPB - 1) / QPB, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* f1p = reinterpret_cast<const float*>(f1);
  const float* cp = reinterpret_cast<const float*>(coords);
  float* op = reinterpret_cast<float*>(out);
  switch (C) {
    case 32:  launch<1>(grid, smem, st, f1p, cp, lv, L, N, radius, inv_sqrt_c, op, out_sb, out_sq, out_sp); break;
    case 64:  launch<2>(grid, smem, st, f1p, cp, lv, L, N, radius, inv_sqrt_c, op, out_sb, out_sq, out_sp); break;
    case 128: launch<4>(grid, smem, st, f1p, cp, lv, L, N, radius, inv_sqrt_c, op, out_sb, out_sq, out_sp); break;
    case 256: launch<8>(grid, smem, st, f1p, cp, lv, L, N, radius, inv_sqrt_c, op, out_sb, out_sq, out_sp); break;
    case 512: launch<16>(grid, smem, st, f1p, cp, lv, L, N, radius, inv_sqrt_c, op, out_sb, out_sq, out_sp); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

struct DLevels {
  float* df2[MAX_LEVELS];
};

__device__ __forceinline__ void add4(float* p, float4 v) {
#if (__CUDACC_VER_MAJOR__ > 12) || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 5)
  atomicAdd(reinterpret_cast<float4*>(p), v);  // one 16-byte red on sm_90
#else
  atomicAdd(p + 0, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

template <int NV4>  // float4s per lane; C = 32 * NV4
__global__ void __launch_bounds__(32 * QPB)
corr_ondemand_bwd_kernel(const float* __restrict__ f1,      // (B, N, C)
                         const float* __restrict__ coords,  // (B, N, 2)
                         Levels lv, DLevels dl, int L, int N, int radius,
                         float inv_sqrt_c, const float* __restrict__ g,
                         long long g_sb, long long g_sq, long long g_sp,
                         float* __restrict__ df1) {        // (B, N, C)
  constexpr int C = 32 * NV4;
  const int k = 2 * radius + 1;
  const int kp = k + 1;
  const int npos = kp * kp;
  const int P = L * k * k;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 3;
  const int sub = lane & 7;
  float* tile = smem;                              // (QPB, P) cotangents
  float* dwin = smem + QPB * P + warp * npos;      // (k+1)^2 per warp
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QPB;
  const int q = q0 + warp;
  const int nq = min(QPB, N - q0);

  const float* gb = g + (long long)b * g_sb;
  if (g_sp == 1) {
    // query-major rows: each query's P cotangents are contiguous
    for (int e = threadIdx.x; e < nq * P; e += blockDim.x) {
      const int qq = e / P, p = e % P;
      tile[qq * P + p] = gb[(long long)(q0 + qq) * g_sq + p];
    }
  } else {
    // channel-major planes: QPB consecutive queries per channel
    for (int e = threadIdx.x; e < QPB * P; e += blockDim.x) {
      const int p = e / QPB, qq = e % QPB;
      if (qq < nq)
        tile[qq * P + p] =
            gb[(long long)p * g_sp + (long long)(q0 + qq) * g_sq];
    }
  }
  __syncthreads();
  if (q >= N) return;  // warp-uniform; no block barrier follows

  const long long qi = (long long)b * N + q;
  const float4* f1q = reinterpret_cast<const float4*>(f1 + qi * C);
  float4 a[NV4], acc[NV4];
#pragma unroll
  for (int t = 0; t < NV4; ++t) {
    a[t] = f1q[t * 8 + sub];
    acc[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float cx0 = coords[qi * 2 + 0];
  const float cy0 = coords[qi * 2 + 1];

  for (int l = 0; l < L; ++l) {
    const float s = 1.0f / (float)(1 << l);  // exact power of two
    const float cx = cx0 * s, cy = cy0 * s;
    const int hl = lv.h[l], wl = lv.w[l];
    const float fx0 = floorf(cx), fy0 = floorf(cy);
    // the forward's test: no overlap (or a non-finite center) -> no taps
    const bool any = hl > 0 && wl > 0 &&
                     fx0 > -(float)(2 * kp) && fx0 < (float)(wl + 2 * kp) &&
                     fy0 > -(float)(2 * kp) && fy0 < (float)(hl + 2 * kp);
    if (!any) continue;
    const int x0 = (int)fx0 - radius;
    const int y0 = (int)fy0 - radius;
    const float fx = cx - fx0, fy = cy - fy0;
    const float* gq = tile + warp * P + l * k * k;  // tap (i, j) at i*k + j
    for (int p = lane; p < npos; p += 32) {
      const int ii = p % kp, jj = p / kp;  // x and y offsets in the window
      // taps (i, j) with i in {ii-1, ii}, j in {jj-1, jj} read position p
      float d = 0.0f;
      if (jj < k) {
        float r = 0.0f;
        if (ii < k) r += (1.0f - fx) * gq[ii * k + jj];
        if (ii > 0) r += fx * gq[(ii - 1) * k + jj];
        d += (1.0f - fy) * r;
      }
      if (jj > 0) {
        float r = 0.0f;
        if (ii < k) r += (1.0f - fx) * gq[ii * k + jj - 1];
        if (ii > 0) r += fx * gq[(ii - 1) * k + jj - 1];
        d += fy * r;
      }
      dwin[p] = d * inv_sqrt_c;
    }
    __syncwarp();
    const long long lvl_off = (long long)b * hl * wl * C;
    const float* f2l = lv.f2[l] + lvl_off;
    float* df2l = dl.df2[l] + lvl_off;
    for (int p0 = 0; p0 < npos; p0 += 4) {
      const int p = p0 + grp;
      const int X = x0 + p % kp;
      const int Y = y0 + p / kp;
      if (p < npos && X >= 0 && X < wl && Y >= 0 && Y < hl) {
        const float d = dwin[p];
        const long long row = ((long long)Y * wl + X) * C;
        const float4* f2r = reinterpret_cast<const float4*>(f2l + row);
        float* dr = df2l + row;
#pragma unroll
        for (int t = 0; t < NV4; ++t) {
          const float4 v = f2r[t * 8 + sub];
          acc[t].x += d * v.x;
          acc[t].y += d * v.y;
          acc[t].z += d * v.z;
          acc[t].w += d * v.w;
          add4(dr + 4 * (t * 8 + sub),
               make_float4(d * a[t].x, d * a[t].y, d * a[t].z, d * a[t].w));
        }
      }
    }
    __syncwarp();  // dwin is rewritten by the next level
  }

  // the four 8-lane groups hold partial sums of the same channels
#pragma unroll
  for (int t = 0; t < NV4; ++t) {
#pragma unroll
    for (int m = 8; m <= 16; m <<= 1) {
      acc[t].x += __shfl_xor_sync(0xffffffffu, acc[t].x, m);
      acc[t].y += __shfl_xor_sync(0xffffffffu, acc[t].y, m);
      acc[t].z += __shfl_xor_sync(0xffffffffu, acc[t].z, m);
      acc[t].w += __shfl_xor_sync(0xffffffffu, acc[t].w, m);
    }
  }
  if (grp == 0) {
    float4* out = reinterpret_cast<float4*>(df1 + qi * C);
#pragma unroll
    for (int t = 0; t < NV4; ++t) out[t * 8 + sub] = acc[t];
  }
}

template <int NV4>
static void launch_bwd(dim3 grid, size_t smem, cudaStream_t stream,
                       const float* f1, const float* coords,
                       const Levels& lv, const DLevels& dl, int L, int N,
                       int radius, float inv_sqrt_c, const float* g,
                       long long sb, long long sq, long long sp, float* df1) {
  corr_ondemand_bwd_kernel<NV4><<<grid, 32 * QPB, smem, stream>>>(
      f1, coords, lv, dl, L, N, radius, inv_sqrt_c, g, sb, sq, sp, df1);
}

// Returns a cudaError_t (0 = success).  f2_ptrs/df2_ptrs/hs/ws are host
// arrays of L entries; df2 buffers must be zeroed by the caller; g
// strides are in elements.
extern "C" int corr_ondemand_bwd(int device, const void* f1, const void* coords,
                                 const long long* f2_ptrs,
                                 const long long* df2_ptrs, const int* hs,
                                 const int* ws, int L, int B, int N, int C,
                                 int radius, float inv_sqrt_c, const void* g,
                                 long long g_sb, long long g_sq,
                                 long long g_sp, void* df1, void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 1 || N < 1 || radius < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  DLevels dl;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.f2[l] = l < L ? reinterpret_cast<const float*>(f2_ptrs[l]) : nullptr;
    dl.df2[l] = l < L ? reinterpret_cast<float*>(df2_ptrs[l]) : nullptr;
    lv.h[l] = l < L ? hs[l] : 0;
    lv.w[l] = l < L ? ws[l] : 0;
  }
  const int k = 2 * radius + 1;
  const size_t smem =
      (size_t)QPB * (L * k * k + (k + 1) * (k + 1)) * sizeof(float);
  const dim3 grid((N + QPB - 1) / QPB, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* f1p = reinterpret_cast<const float*>(f1);
  const float* cp = reinterpret_cast<const float*>(coords);
  const float* gp = reinterpret_cast<const float*>(g);
  float* dp = reinterpret_cast<float*>(df1);
  switch (C) {
    case 32:  launch_bwd<1>(grid, smem, st, f1p, cp, lv, dl, L, N, radius, inv_sqrt_c, gp, g_sb, g_sq, g_sp, dp); break;
    case 64:  launch_bwd<2>(grid, smem, st, f1p, cp, lv, dl, L, N, radius, inv_sqrt_c, gp, g_sb, g_sq, g_sp, dp); break;
    case 128: launch_bwd<4>(grid, smem, st, f1p, cp, lv, dl, L, N, radius, inv_sqrt_c, gp, g_sb, g_sq, g_sp, dp); break;
    case 256: launch_bwd<8>(grid, smem, st, f1p, cp, lv, dl, L, N, radius, inv_sqrt_c, gp, g_sb, g_sq, g_sp, dp); break;
    case 512: launch_bwd<16>(grid, smem, st, f1p, cp, lv, dl, L, N, radius, inv_sqrt_c, gp, g_sb, g_sq, g_sp, dp); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
