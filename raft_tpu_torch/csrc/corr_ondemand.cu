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
// Function.  For query q = (b, y, x) of the H1 x W1 grid with level-0
// center c = coords[b, y, x] and level l with center c / 2^l, tap (i, j)
// samples the bilinear (align-corners, zeros padding) value at
// (c.x + i - r, c.y + j - r) of the correlation row
// <f1[b, y, x], f2_l[b, Y, X]> / sqrt(C).  The output channel is
// l*k*k + i*k + j (x-major, k = 2r+1).  An empty level (Hl or Wl = 0), a
// far or a non-finite center gives zeros.  The backward maps the tap
// cotangent g to df1 and df2_l (the transpose of the same sums); coords
// get no gradient; df2 buffers are zeroed by the caller.
//
// What bounds both kernels on an H100: fp32 arithmetic.  Per query and
// level the bilinear window touches (k+1)^2 = 100 integer positions, each
// a C = 256 dot product: ~205 kFLOP per query over four levels, 1.44
// GFLOP at the Sintel shape (N = 7040, ~21 us at the 67 TFLOP/s fp32
// peak) against ~26 MB of unique bytes (~8 us at 3.35 TB/s).  The
// backward does twice the products: ~9.3 GFLOP a call at the chairs
// training shape (batch 8, 46x62 grid), ~0.14 ms, against ~140 MB.
//
// What the first design (one warp per query, 8 consecutive queries per
// block) spent its time on.  Each query fetched its own 100 f2 rows per
// level (400 KB per query over four levels) from L1/L2: 19x the forward's
// bound.  Its backward sent each window row's contribution to df2 as its
// own 16-byte atomicAdd, ~2.3e9 fp32 adds a chairs call: 3.72 ms as
// shipped, 1.56 ms with plain stores in place of the atomics, 0.58 ms
// without the df2 writes (its probe, measured on the H100): the volume of
// adds set the time.  A pre-sum over a 4 x 8 tile with one lane per
// channel and shared-memory atomics was slower still.
//
// This design: neighbouring queries read nearly the same f2 rows, so a
// block owns a 2-D tile of TY x TX = 4 x 8 queries and, per level, the
// union box of their windows (clamped to the level; far, non-finite and
// off-level windows left out).  For smooth flow the level-0 box is about
// (4 + 9) x (8 + 9) = 221 positions against 32 x 100 = 3200 window rows,
// and at the coarse levels the windows nearly coincide.
//   - Box path, taken when the box holds at most NB_MAX positions.  The box
//     is cut into slabs of SLAB positions; the slab's f2 rows and the
//     tile's f1 rows are staged in shared memory FCC (forward) or BCC
//     (backward) channels at a time, double-buffered with cp.async, and a
//     slab's compute covers only its used 32-row groups.  The tap
//     cotangents of a level are staged once, coalesced in either layout.
//     The forward forms the dense product
//     S = F1_tile . F2_slab^T with 4 x 4 register micro-tiles (exact fp32
//     FMAs, no TF32) and keeps each query's own window entries.  The
//     backward builds D (box positions x tile queries) from the tap
//     cotangent by the transpose of the bilinear weights (times 1/sqrt(C);
//     a query's column is nonzero only on its window), then per chunk
//       df1_tile += D^T . F2_slab   (4 queries x 4 channels a thread, the
//                                    slab split over 4 lanes, shuffled)
//       dF2_slab  = D . F1_tile     (4 positions x 4 channels a thread)
//     and adds dF2_slab into df2_l with ONE 16-byte atomicAdd per (box
//     row, 4 channels) and tile: about 3200 / 221 ~ 15x fewer adds at
//     level 0 for smooth flow, far fewer at the coarse levels.  Nothing
//     uses shared-memory atomics.  Row strides of 4 floats past a multiple
//     of 32 and the lane maps keep every float4 read of the micro-tiles at
//     one or two shared-memory wavefronts.
//   - Per-query path, taken by a (tile, level) whose box overflows NB_MAX
//     (motion boundaries, centers spread by tens of pixels): the first
//     design's code for that level, one warp per query, its window read
//     from L2 and per-row atomics in the backward.  This is a branch on
//     the data inside the kernel; both paths give the same function.
// df1 is accumulated in shared memory over the levels and written once.
//
// Budget and tile shape.  4 x 8 rather than 8 x 8 queries: the Sintel grid
// (55 x 128, B = 1) gives 224 blocks for the 132 SMs instead of 112.
// NB_MAX = 4 slabs = 512 positions.  A box costs 32 * NB dense dot
// products per tile, the per-query path 32 * 100 read from L2.  On the
// H100 (PERF.md) the chairs backward takes ~0.9-1.0 ms with every tile on
// the box path (level-0 boxes of ~230 positions) where the per-query
// design took 2.8-3.7 ms, so the box path stays ahead up to boxes a few
// times that size.  512 keeps smooth-flow boxes (100-300 positions) on it
// and sends those of centers spread by U(-20, 20) px at level 0
// (~1300-1700) and at half of the level-1 tiles (~450-550) to the
// per-query path.
// Shared memory at C = 256, 4 levels, r = 4: ~101 KB forward, ~111 KB
// backward, two blocks per SM (the backward's df1 tile is TQ x C), both
// above 48 KB and so set with cudaFuncSetAttribute.
// The order of the df2 adds changes from run to run, so df2 varies in its
// last bits between runs.  All arithmetic is fp32; inputs and outputs are
// fp32.  Layouts: f1 (B, H1, W1, C), coords (B, H1, W1, 2), f2_l
// (B, Hl, Wl, C), all contiguous; taps and their cotangent by the caller's
// strides, so one kernel serves (B, N, P) and (B, P, N).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#define MAX_LEVELS 8
#define TY 4          // tile rows of queries
#define TX 8          // tile columns of queries
#define TQ 32         // queries per tile (TY * TX)
#define NT 256        // threads per block
#define FCC 64        // channels per staged chunk, forward (C if less)
#define BCC 32        // channels per staged chunk, backward
#define DRS (TQ + 4)  // row stride (floats) of D
#define SLAB 128      // box positions per slab
#define NB_MAX 512    // box budget (positions) of the box path

struct Levels {
  const float* f2[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

struct DLevels {
  float* df2[MAX_LEVELS];
};

// The tile's windows at one level and their union box.
struct TileLevel {
  int x0[TQ], y0[TQ];   // window origins (level coordinates)
  float fx[TQ], fy[TQ];  // fractional offsets (0 for an inactive query)
  int act[TQ];           // the window overlaps the level
  int bx0, by0, bw, nb;  // box origin, width, positions (0: no window)
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = full ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Local query q of the tile at (ty0, tx0): its flat index n, or -1 off
// the grid (ragged tiles).
__device__ __forceinline__ int query_index(int q, int ty0, int tx0, int H1,
                                           int W1) {
  const int y = ty0 + q / TX, x = tx0 + q % TX;
  return (y < H1 && x < W1) ? y * W1 + x : -1;
}

// One warp: the windows of the tile's queries at level l and their box.
__device__ void tile_level_setup(TileLevel& tl, const float* coords,
                                 long long b, int N, int ty0, int tx0,
                                 int H1, int W1, int l, int hl, int wl,
                                 int radius, int lane) {
  const int k = 2 * radius + 1;
  const int kp = k + 1;
  const int n = query_index(lane, ty0, tx0, H1, W1);
  int x0 = 0, y0 = 0;
  float fx = 0.0f, fy = 0.0f;
  bool act = false;
  if (n >= 0 && hl > 0 && wl > 0) {
    const float s = 1.0f / (float)(1 << l);  // exact power of two
    const long long qi = b * N + n;
    const float cx = coords[qi * 2 + 0] * s, cy = coords[qi * 2 + 1] * s;
    const float fx0 = floorf(cx), fy0 = floorf(cy);
    // in float, so far-out or non-finite centers never reach an int cast
    if (fx0 > -(float)(2 * kp) && fx0 < (float)(wl + 2 * kp) &&
        fy0 > -(float)(2 * kp) && fy0 < (float)(hl + 2 * kp)) {
      x0 = (int)fx0 - radius;
      y0 = (int)fy0 - radius;
      act = x0 + k >= 0 && x0 < wl && y0 + k >= 0 && y0 < hl;
      if (act) {
        fx = cx - fx0;
        fy = cy - fy0;
      }
    }
  }
  tl.x0[lane] = x0;
  tl.y0[lane] = y0;
  tl.fx[lane] = fx;
  tl.fy[lane] = fy;
  tl.act[lane] = act;
  int lx = act ? max(x0, 0) : INT_MAX, hx = act ? min(x0 + k, wl - 1) : -1;
  int ly = act ? max(y0, 0) : INT_MAX, hy = act ? min(y0 + k, hl - 1) : -1;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    lx = min(lx, __shfl_xor_sync(0xffffffffu, lx, m));
    ly = min(ly, __shfl_xor_sync(0xffffffffu, ly, m));
    hx = max(hx, __shfl_xor_sync(0xffffffffu, hx, m));
    hy = max(hy, __shfl_xor_sync(0xffffffffu, hy, m));
  }
  if (lane == 0) {
    const bool any = hx >= 0;
    tl.bx0 = any ? lx : 0;
    tl.by0 = any ? ly : 0;
    tl.bw = any ? hx - lx + 1 : 0;
    tl.nb = any ? (hx - lx + 1) * (hy - ly + 1) : 0;
  }
}

// Stage channel chunk `ch` of the tile's f1 rows (TQ x CCH) and of the
// slab's f2 rows (ns x CCH, rounded up to 32) into f1s / f2s (row stride
// CCH + 4).  Rows off the grid or past the slab are zero-filled.
template <int C, int CCH>
__device__ __forceinline__ void stage_chunk(
    float* f1s, float* f2s, const float* f1, const float* f2l,
    const int* soff, long long b, int N, int ty0, int tx0, int H1, int W1,
    int ns, int ch, int tid) {
  constexpr int RW = CCH + 4, V = CCH / 4;
  const int rows = (ns + 31) & ~31;  // the 32-row groups the slab uses
  for (int e = tid; e < TQ * V; e += NT) {
    const int q = e / V, c4 = e % V;
    const int n = query_index(q, ty0, tx0, H1, W1);
    const float* src =
        f1 + ((b * N + (n < 0 ? 0 : n)) * C + ch * CCH + 4 * c4);
    cp_async16(f1s + q * RW + 4 * c4, src, n >= 0);
  }
  for (int e = tid; e < rows * V; e += NT) {
    const int p = e / V, c4 = e % V;
    const bool in = p < ns;
    const float* src =
        f2l + ((long long)(in ? soff[p] : 0) * C + ch * CCH + 4 * c4);
    cp_async16(f2s + p * RW + 4 * c4, src, in);
  }
}

// Row offsets Y*wl + X of the slab's box positions, and their box
// coordinates (by << 16 | bx).
__device__ __forceinline__ void slab_offsets(int* soff, int* sxy,
                                             const TileLevel& tl, int s0,
                                             int ns, int wl, int tid) {
  for (int p = tid; p < ns; p += NT) {
    const int bp = s0 + p;
    const int by = bp / tl.bw, bx = bp % tl.bw;
    soff[p] = (tl.by0 + by) * wl + tl.bx0 + bx;
    sxy[p] = (by << 16) | bx;
  }
}

// Window position p -> (jj << 16 | ii), its y and x offsets.
__device__ __forceinline__ void window_table(int* pxy, int kp, int tid) {
  for (int p = tid; p < kp * kp; p += NT) pxy[p] = ((p / kp) << 16) | (p % kp);
}

// One staged chunk of S = F1_tile . F2_slab^T: queries qg + 8i (i < 4) x
// positions pg + 32j (j < NJ, the slab's used 32-row groups).
template <int NJ, int CCH>
__device__ __forceinline__ void fwd_chunk(float (&acc)[4][4],
                                          const float* F1, const float* F2,
                                          int qg, int pg) {
  constexpr int RW = CCH + 4;
#pragma unroll
  for (int c4 = 0; c4 < CCH / 4; ++c4) {
    float4 a[4], v[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(F1 + (qg + 8 * i) * RW + 4 * c4);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      v[j] = *reinterpret_cast<const float4*>(F2 + (pg + 32 * j) * RW + 4 * c4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = dot4(a[i], v[j], acc[i][j]);
  }
}

// One staged chunk of dF2_slab = D . F1_tile for positions pg + 32j
// (j < NJ) and channels 4cg..4cg+3 of the chunk, added into df2_l with one
// 16-byte atomicAdd per (row, 4 channels); a box corner no window covers
// adds nothing.
template <int NJ>
__device__ __forceinline__ void bwd_df2_chunk(const float* dts,
                                              const float* F1,
                                              const int* soff, int ns,
                                              int pg, int cg, float* dst,
                                              int C) {
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
#pragma unroll 2
  for (int q4 = 0; q4 < TQ; q4 += 4) {
    float4 d[NJ], a[4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      d[j] = *reinterpret_cast<const float4*>(dts + (pg + 32 * j) * DRS + q4);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      a[u] = *reinterpret_cast<const float4*>(F1 + (q4 + u) * (BCC + 4) +
                                              4 * cg);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float dj[4] = {d[j].x, d[j].y, d[j].z, d[j].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[j][0] = fmaf(dj[u], a[u].x, acc[j][0]);
        acc[j][1] = fmaf(dj[u], a[u].y, acc[j][1]);
        acc[j][2] = fmaf(dj[u], a[u].z, acc[j][2]);
        acc[j][3] = fmaf(dj[u], a[u].w, acc[j][3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int p = pg + 32 * j;
    if (p < ns && (acc[j][0] != 0.0f || acc[j][1] != 0.0f ||
                   acc[j][2] != 0.0f || acc[j][3] != 0.0f))
      add4(dst + (long long)soff[p] * C + 4 * cg,
           make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
  }
}

template <int NV4>  // float4s per lane; C = 32 * NV4
__global__ void __launch_bounds__(NT, 2)
corr_ondemand_kernel(const float* __restrict__ f1,
                     const float* __restrict__ coords, Levels lv, int L,
                     int H1, int W1, int radius, float inv_sqrt_c,
                     float* __restrict__ out, long long out_sb,
                     long long out_sq, long long out_sp, int* path_counts) {
  constexpr int C = 32 * NV4;
  constexpr int CCH = C < FCC ? C : FCC;
  constexpr int RW = CCH + 4;
  constexpr int NCH = C / CCH;
  const int k = 2 * radius + 1;
  const int kp = k + 1;
  const int npos = kp * kp;
  const int kk = k * k;
  extern __shared__ __align__(16) float smem[];
  float* f1s = smem;                   // 2 x TQ x RW
  float* f2s = f1s + 2 * TQ * RW;      // 2 x SLAB x RW
  const int ws = npos + 1;             // odd row stride of the windows
  float* win = f2s + 2 * SLAB * RW;    // TQ x ws window dots
  int* soff = reinterpret_cast<int*>(win + TQ * ws);  // SLAB
  int* sxy = soff + SLAB;                             // SLAB
  int* pxy = sxy + SLAB;                              // npos
  TileLevel* tls = reinterpret_cast<TileLevel*>(pxy + npos);  // L
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_x = (W1 + TX - 1) / TX;
  const int ty0 = (blockIdx.x / tiles_x) * TY;
  const int tx0 = (blockIdx.x % tiles_x) * TX;
  const long long b = blockIdx.y;
  const int N = H1 * W1;
  float* ob = out + b * out_sb;

  // warp l sets up level l (L <= MAX_LEVELS == NT / 32)
  if (warp < L)
    tile_level_setup(tls[warp], coords, b, N, ty0, tx0, H1, W1, warp,
                     lv.h[warp], lv.w[warp], radius, lane);
  window_table(pxy, kp, tid);
  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const TileLevel& tl = tls[l];
    for (int e = tid; e < TQ * ws; e += NT) win[e] = 0.0f;
    __syncthreads();
    const int nb = tl.nb;
    const float* f2l = lv.f2[l] + b * hl * wl * C;
    if (nb > 0 && nb <= NB_MAX) {
      // --- box path: S = F1_tile . F2_slab^T, slab by slab ---
      const int qg = lane & 7;                   // queries qg + 8i
      const int pg = (lane >> 3) + 4 * warp;     // positions pg + 32j
      for (int s0 = 0; s0 < nb; s0 += SLAB) {
        const int ns = min(SLAB, nb - s0);
        const int nj = (ns + 31) / 32;  // 32-row groups the slab uses
        slab_offsets(soff, sxy, tl, s0, ns, wl, tid);
        __syncthreads();
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        stage_chunk<C, CCH>(f1s, f2s, f1, f2l, soff, b, N, ty0, tx0, H1, W1,
                            ns, 0, tid);
        cp_async_commit();
        for (int ch = 0; ch < NCH; ++ch) {
          if (ch + 1 < NCH) {
            const int nx = (ch + 1) & 1;
            stage_chunk<C, CCH>(f1s + nx * TQ * RW, f2s + nx * SLAB * RW, f1,
                                f2l, soff, b, N, ty0, tx0, H1, W1, ns,
                                ch + 1, tid);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const float* F1 = f1s + (ch & 1) * TQ * RW;
          const float* F2 = f2s + (ch & 1) * SLAB * RW;
          switch (nj) {  // block-uniform: the slab's used width
            case 1: fwd_chunk<1, CCH>(acc, F1, F2, qg, pg); break;
            case 2: fwd_chunk<2, CCH>(acc, F1, F2, qg, pg); break;
            case 3: fwd_chunk<3, CCH>(acc, F1, F2, qg, pg); break;
            default: fwd_chunk<4, CCH>(acc, F1, F2, qg, pg);
          }
          __syncthreads();  // this buffer is restaged two chunks on
        }
        // keep each query's own window entries
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = qg + 8 * i;
          if (!tl.act[q]) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = pg + 32 * j;
            if (p >= ns) continue;  // also every j >= nj
            const int wx = tl.bx0 + (sxy[p] & 0xffff) - tl.x0[q];
            const int wy = tl.by0 + (sxy[p] >> 16) - tl.y0[q];
            if (wx >= 0 && wx < kp && wy >= 0 && wy < kp)
              win[q * ws + wy * kp + wx] = acc[i][j] * inv_sqrt_c;
          }
        }
        __syncthreads();  // sxy and soff are rewritten by the next slab
      }
    } else if (nb > 0) {
      // --- per-query path: one warp per query, its window from L2 ---
      const int grp = lane >> 3, sub = lane & 7;
      for (int qq = 0; qq < TQ / 8; ++qq) {
        const int q = warp * (TQ / 8) + qq;
        if (!tl.act[q]) continue;  // warp-uniform
        const int n = query_index(q, ty0, tx0, H1, W1);
        const float4* f1q =
            reinterpret_cast<const float4*>(f1 + (b * N + n) * C);
        float4 a[NV4];
#pragma unroll
        for (int t = 0; t < NV4; ++t) a[t] = f1q[t * 8 + sub];
        const int x0 = tl.x0[q], y0 = tl.y0[q];
        for (int p0 = 0; p0 < npos; p0 += 4) {
          const int p = p0 + grp;
          const int xy = p < npos ? pxy[p] : 0;
          const int X = x0 + (xy & 0xffff);
          const int Y = y0 + (xy >> 16);
          const bool in = p < npos && X >= 0 && X < wl && Y >= 0 && Y < hl;
          float acc = 0.0f;
          if (in) {
            const float4* row = reinterpret_cast<const float4*>(
                f2l + ((long long)Y * wl + X) * C);
#pragma unroll
            for (int t = 0; t < NV4; ++t) acc = dot4(a[t], row[t * 8 + sub], acc);
          }
          acc += __shfl_xor_sync(0xffffffffu, acc, 4);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          if (sub == 0 && in) win[q * ws + p] = acc * inv_sqrt_c;
        }
      }
    }
    if (tid == 0 && path_counts != nullptr && nb > 0)
      atomicAdd(path_counts + (nb <= NB_MAX ? 0 : 1), 1);
    __syncthreads();

    // --- taps of level l from the window dots, in the caller's layout ---
    for (int e = tid; e < TQ * kk; e += NT) {
      const int q = out_sp == 1 ? e / kk : e % TQ;
      const int t = out_sp == 1 ? e % kk : e / TQ;
      const int n = query_index(q, ty0, tx0, H1, W1);
      if (n < 0) continue;
      const int i = t / k, j = t % k;  // i walks x, j walks y
      const float* d = win + q * ws + j * kp + i;
      const float fx = tl.fx[q], fy = tl.fy[q];
      ob[(long long)n * out_sq + (long long)(l * kk + t) * out_sp] =
          (1.0f - fy) * ((1.0f - fx) * d[0] + fx * d[1]) +
          fy * ((1.0f - fx) * d[kp] + fx * d[kp + 1]);
    }
    __syncthreads();  // win is rewritten by the next level
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <int NV4>  // float4s per lane; C = 32 * NV4
__global__ void __launch_bounds__(NT, 2)
corr_ondemand_bwd_kernel(const float* __restrict__ f1,
                         const float* __restrict__ coords, Levels lv,
                         DLevels dl, int L, int H1, int W1, int radius,
                         float inv_sqrt_c, const float* __restrict__ g,
                         long long g_sb, long long g_sq, long long g_sp,
                         float* __restrict__ df1, int* path_counts) {
  constexpr int C = 32 * NV4;
  constexpr int RW = BCC + 4;
  constexpr int NCH = C / BCC;
  const int k = 2 * radius + 1;
  const int kp = k + 1;
  const int npos = kp * kp;
  const int kk = k * k;
  extern __shared__ __align__(16) float smem[];
  float* f1s = smem;                   // 2 x TQ x RW
  float* f2s = f1s + 2 * TQ * RW;      // 2 x SLAB x RW
  float* dts = f2s + 2 * SLAB * RW;    // D (SLAB x DRS), first g's tile
  float* df1s = dts + max(SLAB * DRS, TQ * kk);  // TQ x C
  const int ws = npos + 1;             // odd row stride of the windows
  float* win = df1s + TQ * C;          // TQ x ws window gradients
  int* soff = reinterpret_cast<int*>(win + TQ * ws);  // SLAB
  int* sxy = soff + SLAB;                             // SLAB
  int* pxy = sxy + SLAB;                              // npos
  TileLevel* tls = reinterpret_cast<TileLevel*>(pxy + npos);  // L
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_x = (W1 + TX - 1) / TX;
  const int ty0 = (blockIdx.x / tiles_x) * TY;
  const int tx0 = (blockIdx.x % tiles_x) * TX;
  const long long b = blockIdx.y;
  const int N = H1 * W1;
  const float* gb = g + b * g_sb;

  // warp l sets up level l (L <= MAX_LEVELS == NT / 32)
  if (warp < L)
    tile_level_setup(tls[warp], coords, b, N, ty0, tx0, H1, W1, warp,
                     lv.h[warp], lv.w[warp], radius, lane);
  for (int e = tid; e < TQ * C; e += NT) df1s[e] = 0.0f;
  window_table(pxy, kp, tid);
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const TileLevel& tl = tls[l];
    const int nb = tl.nb;
    if (nb == 0) continue;  // no window of the tile meets the level
    // the level's tap gradients of the tile, (TQ, kk), read coalesced
    float* gs = dts;
    for (int e = tid; e < TQ * kk; e += NT) {
      const int q = g_sp == 1 ? e / kk : e % TQ;
      const int t = g_sp == 1 ? e % kk : e / TQ;
      const int n = query_index(q, ty0, tx0, H1, W1);
      gs[q * kk + t] = (n >= 0 && tl.act[q])
          ? gb[(long long)n * g_sq + (long long)(l * kk + t) * g_sp] : 0.0f;
    }
    __syncthreads();
    // window gradients: each position sums the <= 4 taps that read it
    for (int e = tid; e < TQ * npos; e += NT) {
      const int q = e % TQ, p = e / TQ;
      float d = 0.0f;
      if (tl.act[q]) {
        const float* gq = gs + q * kk;
        const float fx = tl.fx[q], fy = tl.fy[q];
        const int ii = pxy[p] & 0xffff, jj = pxy[p] >> 16;  // x, y offsets
        // taps (i, j) with i in {ii-1, ii}, j in {jj-1, jj} read p
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
      }
      win[q * ws + p] = d * inv_sqrt_c;
    }
    __syncthreads();  // gs (= D) is rewritten below
    const long long lvl_off = b * hl * wl * C;
    const float* f2l = lv.f2[l] + lvl_off;
    float* df2l = dl.df2[l] + lvl_off;
    if (nb <= NB_MAX) {
      // --- box path ---
      // df1 map: queries 4qg..4qg+3, channels 4cg..4cg+3, positions s + 4m
      const int s = lane & 3;
      const int qg = (warp & 3) + 4 * (lane >> 4);
      const int cg = (warp >> 2) + 2 * ((lane >> 2) & 3);
      // df2 map: positions pg + 32j, channels 4cg2..4cg2+3
      const int pg = (lane & 7) + 8 * (warp & 3);
      const int cg2 = (lane >> 3) + 4 * (warp >> 2);
      for (int s0 = 0; s0 < nb; s0 += SLAB) {
        const int ns = min(SLAB, nb - s0);
        const int nj = (ns + 31) / 32;  // 32-row groups the slab uses
        slab_offsets(soff, sxy, tl, s0, ns, wl, tid);
        for (int e = tid; e < nj * 32 * DRS; e += NT) dts[e] = 0.0f;
        __syncthreads();
        // D: each (query, window position) lands on one box row
        for (int e = tid; e < TQ * npos; e += NT) {
          const int q = e % TQ, p = e / TQ;
          if (!tl.act[q]) continue;
          const int X = tl.x0[q] + (pxy[p] & 0xffff);
          const int Y = tl.y0[q] + (pxy[p] >> 16);
          if (X < 0 || X >= wl || Y < 0 || Y >= hl) continue;
          const int bp = (Y - tl.by0) * tl.bw + (X - tl.bx0) - s0;
          if (bp >= 0 && bp < ns) dts[bp * DRS + q] = win[q * ws + p];
        }
        stage_chunk<C, BCC>(f1s, f2s, f1, f2l, soff, b, N, ty0, tx0, H1, W1,
                            ns, 0, tid);
        cp_async_commit();
        for (int ch = 0; ch < NCH; ++ch) {
          if (ch + 1 < NCH) {
            const int nx = (ch + 1) & 1;
            stage_chunk<C, BCC>(f1s + nx * TQ * RW, f2s + nx * SLAB * RW, f1,
                                f2l, soff, b, N, ty0, tx0, H1, W1, ns,
                                ch + 1, tid);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const float* F1 = f1s + (ch & 1) * TQ * RW;
          const float* F2 = f2s + (ch & 1) * SLAB * RW;
          {  // df1_tile += D^T . F2_slab
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
            for (int p = s; p < ns; p += 4) {
              const float4 d =
                  *reinterpret_cast<const float4*>(dts + p * DRS + 4 * qg);
              const float4 v =
                  *reinterpret_cast<const float4*>(F2 + p * RW + 4 * cg);
              const float dq[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[i][0] = fmaf(dq[i], v.x, acc[i][0]);
                acc[i][1] = fmaf(dq[i], v.y, acc[i][1]);
                acc[i][2] = fmaf(dq[i], v.z, acc[i][2]);
                acc[i][3] = fmaf(dq[i], v.w, acc[i][3]);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 1);
                acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 2);
              }
            if (s == 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float4* dst = reinterpret_cast<float4*>(
                    df1s + (4 * qg + i) * C + ch * BCC + 4 * cg);
                float4 o = *dst;
                o.x += acc[i][0];
                o.y += acc[i][1];
                o.z += acc[i][2];
                o.w += acc[i][3];
                *dst = o;
              }
            }
          }
          {  // dF2_slab = D . F1_tile
            float* dst = df2l + ch * BCC;
            switch (nj) {  // block-uniform: the slab's used width
              case 1: bwd_df2_chunk<1>(dts, F1, soff, ns, pg, cg2, dst, C); break;
              case 2: bwd_df2_chunk<2>(dts, F1, soff, ns, pg, cg2, dst, C); break;
              case 3: bwd_df2_chunk<3>(dts, F1, soff, ns, pg, cg2, dst, C); break;
              default: bwd_df2_chunk<4>(dts, F1, soff, ns, pg, cg2, dst, C);
            }
          }
          __syncthreads();  // this buffer is restaged two chunks on
        }
      }
    } else {
      // --- per-query path: one warp per query, per-row atomics ---
      const int grp = lane >> 3, sub = lane & 7;
      for (int qq = 0; qq < TQ / 8; ++qq) {
        const int q = warp * (TQ / 8) + qq;
        if (!tl.act[q]) continue;  // warp-uniform
        const int n = query_index(q, ty0, tx0, H1, W1);
        const float4* f1q =
            reinterpret_cast<const float4*>(f1 + (b * N + n) * C);
        float4 a[NV4], acc[NV4];
#pragma unroll
        for (int t = 0; t < NV4; ++t) {
          a[t] = f1q[t * 8 + sub];
          acc[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        const int x0 = tl.x0[q], y0 = tl.y0[q];
        const float* dw = win + q * ws;
        for (int p0 = 0; p0 < npos; p0 += 4) {
          const int p = p0 + grp;
          const int xy = p < npos ? pxy[p] : 0;
          const int X = x0 + (xy & 0xffff);
          const int Y = y0 + (xy >> 16);
          if (p < npos && X >= 0 && X < wl && Y >= 0 && Y < hl) {
            const float d = dw[p];
            const long long row = ((long long)Y * wl + X) * C;
            const float4* f2r = reinterpret_cast<const float4*>(f2l + row);
            float* dr = df2l + row;
#pragma unroll
            for (int t = 0; t < NV4; ++t) {
              const float4 v = f2r[t * 8 + sub];
              acc[t].x = fmaf(d, v.x, acc[t].x);
              acc[t].y = fmaf(d, v.y, acc[t].y);
              acc[t].z = fmaf(d, v.z, acc[t].z);
              acc[t].w = fmaf(d, v.w, acc[t].w);
              add4(dr + 4 * (t * 8 + sub),
                   make_float4(d * a[t].x, d * a[t].y, d * a[t].z,
                               d * a[t].w));
            }
          }
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
          float4* dst = reinterpret_cast<float4*>(df1s + q * C);
#pragma unroll
          for (int t = 0; t < NV4; ++t) {
            float4 o = dst[t * 8 + sub];
            o.x += acc[t].x;
            o.y += acc[t].y;
            o.z += acc[t].z;
            o.w += acc[t].w;
            dst[t * 8 + sub] = o;
          }
        }
      }
    }
    if (tid == 0 && path_counts != nullptr)
      atomicAdd(path_counts + (nb <= NB_MAX ? 0 : 1), 1);
    __syncthreads();  // win and D are rewritten by the next level
  }

  for (int e = tid; e < TQ * C / 4; e += NT) {
    const int q = e / (C / 4), c4 = e % (C / 4);
    const int n = query_index(q, ty0, tx0, H1, W1);
    if (n >= 0)
      reinterpret_cast<float4*>(df1 + (b * N + n) * C)[c4] =
          reinterpret_cast<const float4*>(df1s + q * C)[c4];
  }
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

static size_t smem_bytes(int bwd, int C, int radius, int L) {
  const size_t kk = (size_t)(2 * radius + 1) * (2 * radius + 1);
  const size_t npos = (size_t)(2 * radius + 2) * (2 * radius + 2);
  const size_t rw = bwd ? BCC + 4 : (C < FCC ? C : FCC) + 4;
  size_t floats = 2 * TQ * rw + 2 * SLAB * rw + TQ * (npos + 1);
  if (bwd) floats += std::max((size_t)SLAB * DRS, TQ * kk) + (size_t)TQ * C;
  return floats * sizeof(float) + (2 * SLAB + npos) * sizeof(int) +
         (size_t)L * sizeof(TileLevel);
}

// Dynamic shared memory a launch needs (bytes), for the wrapper's checks.
extern "C" long long corr_ondemand_smem(int bwd, int C, int radius, int L) {
  return (long long)smem_bytes(bwd, C, radius, L);
}

// The most dynamic shared memory a block may opt in to on `device` (bytes),
// or -1 when the device cannot be queried.
extern "C" long long corr_ondemand_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

static Levels make_levels(const long long* f2_ptrs, const int* hs,
                          const int* ws, int L) {
  Levels lv;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.f2[l] = l < L ? reinterpret_cast<const float*>(f2_ptrs[l]) : nullptr;
    lv.h[l] = l < L ? hs[l] : 0;
    lv.w[l] = l < L ? ws[l] : 0;
  }
  return lv;
}

template <typename Kernel>
static cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NV4>
static cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                          const float* f1, const float* coords,
                          const Levels& lv, int L, int H1, int W1, int radius,
                          float inv_sqrt_c, float* out, long long sb,
                          long long sq, long long sp, int* counts) {
  cudaError_t err = prepare(corr_ondemand_kernel<NV4>, smem);
  if (err != cudaSuccess) return err;
  corr_ondemand_kernel<NV4><<<grid, NT, smem, stream>>>(
      f1, coords, lv, L, H1, W1, radius, inv_sqrt_c, out, sb, sq, sp,
      counts);
  return cudaGetLastError();
}

// Returns a cudaError_t (0 = success).  f2_ptrs/hs/ws are host arrays of
// L entries; out strides are in elements; path_counts (may be null) is a
// device int[2] that gains the (tile, level) pairs of the box path and of
// the per-query path.
extern "C" int corr_ondemand_fwd(int device, const void* f1, const void* coords,
                                 const long long* f2_ptrs, const int* hs,
                                 const int* ws, int L, int B, int H1, int W1,
                                 int C, int radius, float inv_sqrt_c,
                                 void* out, long long out_sb,
                                 long long out_sq, long long out_sp,
                                 void* path_counts, void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 1 || H1 < 1 || W1 < 1 || radius < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Levels lv = make_levels(f2_ptrs, hs, ws, L);
  const size_t smem = smem_bytes(0, C, radius, L);
  const dim3 grid(((H1 + TY - 1) / TY) * ((W1 + TX - 1) / TX), B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* f1p = reinterpret_cast<const float*>(f1);
  const float* cp = reinterpret_cast<const float*>(coords);
  float* op = reinterpret_cast<float*>(out);
  int* cnt = reinterpret_cast<int*>(path_counts);
  switch (C) {
    case 32:  return (int)launch<1>(grid, smem, st, f1p, cp, lv, L, H1, W1, radius, inv_sqrt_c, op, out_sb, out_sq, out_sp, cnt);
    case 64:  return (int)launch<2>(grid, smem, st, f1p, cp, lv, L, H1, W1, radius, inv_sqrt_c, op, out_sb, out_sq, out_sp, cnt);
    case 128: return (int)launch<4>(grid, smem, st, f1p, cp, lv, L, H1, W1, radius, inv_sqrt_c, op, out_sb, out_sq, out_sp, cnt);
    case 256: return (int)launch<8>(grid, smem, st, f1p, cp, lv, L, H1, W1, radius, inv_sqrt_c, op, out_sb, out_sq, out_sp, cnt);
    case 512: return (int)launch<16>(grid, smem, st, f1p, cp, lv, L, H1, W1, radius, inv_sqrt_c, op, out_sb, out_sq, out_sp, cnt);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int NV4>
static cudaError_t launch_bwd(dim3 grid, size_t smem, cudaStream_t stream,
                              const float* f1, const float* coords,
                              const Levels& lv, const DLevels& dl, int L,
                              int H1, int W1, int radius, float inv_sqrt_c,
                              const float* g, long long sb, long long sq,
                              long long sp, float* df1, int* counts) {
  cudaError_t err = prepare(corr_ondemand_bwd_kernel<NV4>, smem);
  if (err != cudaSuccess) return err;
  corr_ondemand_bwd_kernel<NV4><<<grid, NT, smem, stream>>>(
      f1, coords, lv, dl, L, H1, W1, radius, inv_sqrt_c, g, sb, sq, sp, df1,
      counts);
  return cudaGetLastError();
}

// Returns a cudaError_t (0 = success).  f2_ptrs/df2_ptrs/hs/ws are host
// arrays of L entries; df2 buffers must be zeroed by the caller; g
// strides are in elements; path_counts as for corr_ondemand_fwd.
extern "C" int corr_ondemand_bwd(int device, const void* f1, const void* coords,
                                 const long long* f2_ptrs,
                                 const long long* df2_ptrs, const int* hs,
                                 const int* ws, int L, int B, int H1, int W1,
                                 int C, int radius, float inv_sqrt_c,
                                 const void* g, long long g_sb,
                                 long long g_sq, long long g_sp, void* df1,
                                 void* path_counts, void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 1 || H1 < 1 || W1 < 1 || radius < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Levels lv = make_levels(f2_ptrs, hs, ws, L);
  DLevels dl;
  for (int l = 0; l < MAX_LEVELS; ++l)
    dl.df2[l] = l < L ? reinterpret_cast<float*>(df2_ptrs[l]) : nullptr;
  const size_t smem = smem_bytes(1, C, radius, L);
  const dim3 grid(((H1 + TY - 1) / TY) * ((W1 + TX - 1) / TX), B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* f1p = reinterpret_cast<const float*>(f1);
  const float* cp = reinterpret_cast<const float*>(coords);
  const float* gp = reinterpret_cast<const float*>(g);
  float* dp = reinterpret_cast<float*>(df1);
  int* cnt = reinterpret_cast<int*>(path_counts);
  switch (C) {
    case 32:  return (int)launch_bwd<1>(grid, smem, st, f1p, cp, lv, dl, L, H1, W1, radius, inv_sqrt_c, gp, g_sb, g_sq, g_sp, dp, cnt);
    case 64:  return (int)launch_bwd<2>(grid, smem, st, f1p, cp, lv, dl, L, H1, W1, radius, inv_sqrt_c, gp, g_sb, g_sq, g_sp, dp, cnt);
    case 128: return (int)launch_bwd<4>(grid, smem, st, f1p, cp, lv, dl, L, H1, W1, radius, inv_sqrt_c, gp, g_sb, g_sq, g_sp, dp, cnt);
    case 256: return (int)launch_bwd<8>(grid, smem, st, f1p, cp, lv, dl, L, H1, W1, radius, inv_sqrt_c, gp, g_sb, g_sq, g_sp, dp, cnt);
    case 512: return (int)launch_bwd<16>(grid, smem, st, f1p, cp, lv, dl, L, H1, W1, radius, inv_sqrt_c, gp, g_sb, g_sq, g_sp, dp, cnt);
    default: return (int)cudaErrorInvalidValue;
  }
}
