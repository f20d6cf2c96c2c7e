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
// What bounds it on an H100.  Forward: the taps written plus the window
// values read.  Per query and level the window is (k+1) = 10 runs of ten
// stored values, one run per window row, each starting at any element of
// a row 11 KB (fp32, level 0 at chairs) away from the next query's; so
// the reads are short runs, not a stream: 40 B of fp32 span 2-3 32-byte
// sectors, 20 B of bf16 1-2, 10 B of codes 1-2.  At the chairs training
// shape (B = 8, N = 2852, four levels) a lookup needs ~9 M window values
// (36 MB fp32, 9 MB as one-byte codes) plus the taps (30 MB fp32): ~20 us
// at 3.35 TB/s (~12 us from codes), and only ~0.1 GFLOP; counted in
// sectors the reads are ~1.7x (fp32) to ~4x (codes) the values.
// Backward: the dense dcorr write, 345 MB fp32 (173 MB bf16) per lookup,
// ~103 us (52 us) at 3.35 TB/s; that write is the bound and the window
// arithmetic is noise beside it.
//
// Design.  The TPU kernel scans every row of a level for every query
// block on the VPU, because the TPU has no cheap gather; here each query
// reads only its window.
//   - Forward: a block of FNT = 256 threads owns FQ = 32 consecutive
//     queries of one batch element, grid (N / FQ, B), and works in three
//     steps with a barrier between them:
//     (1) a table of the block's (query, level) windows: origin, the rows
//         and columns inside the level, the fractional offsets, and a mode
//         (no window / window / NaN center), one thread per window;
//     (2) every window of every level is copied into shared memory with
//         cp.async, a warp per window and lanes over its words, all
//         copies issued before one wait, so a single round trip covers
//         the block's 32 x L windows.  A window row is copied as the
//         4-byte-aligned words that hold its run (10 words fp32, 6 bf16, 4
//         for codes: cp.async moves 4, 8 or 16 bytes, never 1 or 2);
//         words with no in-level value are zero-filled (source size 0).
//         The per-query stride in shared memory is odd (L * 10 * words +
//         1), so lanes over queries read distinct banks;
//     (3) taps: lanes over the 32 queries, warps over (level, block of
//         tap rows); each lane keeps two window rows in registers, forms
//         y then x interpolation (the JAX order), and stores each tap
//         straight from registers: in the channel-major layout the model
//         reads, one store of 32 consecutive queries per channel (128 B
//         fp32, 64 B bf16: whole sectors).  The query-major layout (no
//         model path uses it) stages the taps in a (32, P + 1) tile and
//         writes the block's rows, one contiguous span, after a barrier.
//     The radius is a template parameter for 3 and 4 (the small and the
//     full model), so k, k+1, the words per row and every division by
//     them fold; any other radius takes the same kernel with a runtime
//     radius (the tap loop then reads shared memory per value).  The
//     level count stays a runtime value: the level tables are
//     __grid_constant__, so a runtime level index reads the parameter
//     bank and nothing is copied to local memory (no LDL / STL in the
//     SASS; chip_smoke.py checks it).  Per block: 55-56 registers a
//     thread (four blocks per SM; capping them lower for more blocks
//     spills and was slower), shared memory 4 * (32 * (L * 10 * words +
//     1) + 7 * 32 * L) bytes, 55 KB fp32, 34 KB bf16, 24 KB codes at four
//     levels and r = 4 (plus a 41 KB tile of taps for the query-major
//     layout).  At chairs the copies alone take about the DRAM time of
//     their sectors (13 us bf16) and the taps and stores alone about as
//     long again (14 us); the two phases of the resident blocks barely
//     overlap (PERF.md).
//     TMA does not fit: a tensor map needs global strides that are
//     multiples of 16 bytes, and the level rows are 248 / 124 / 62 B wide
//     at chairs level 0 (fp32 / bf16 / codes).
//     The first design (PERF.md) ran one warp per query, 8 queries per
//     per block, its four levels in turn, each level's window loaded and
//     waited for before its taps (at most one level's loads of a query in
//     flight per warp); it indexed a by-value level table by a runtime
//     level (a local-memory copy in every thread), divided by runtime
//     sizes for every value, and staged the taps in a tile behind a block
//     barrier before stores of 8 queries (16 B in bf16: half a sector):
//     0.095 ms fp32 and 0.085 bf16 at chairs.  The values are unchanged.
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

#define FQ 32        // queries per block of the forward (a lane each)
#define FNT 256      // threads per block of the forward (8 warps)
#define BQ 32        // queries per block of the backward
#define BNT 256      // threads per block of the backward

// The forward's window table: one int per (query, level) window and field.
enum { T_SLO, T_SHI, T_X, T_Y, T_FX, T_FY, T_MODE, T_FIELDS };

// 4-byte words that hold a run of kp values of es bytes starting at any
// element (es < 4 runs start at byte 0..4-es of their first word).
__host__ __device__ constexpr int run_words(int kp, int es) {
  return ((es < 4 ? 4 - es : 0) + kp * es + 3) / 4;
}

// Dynamic shared memory of one forward block (bytes), with the tile of
// taps that the query-major layout stages; ops/pyramid_kernels.py checks
// the same formula (staged) against the card's 227 KB.
static size_t fwd_smem_bytes(int L, int radius, int es, bool staged) {
  const int kp = 2 * radius + 2;
  return 4 * ((size_t)FQ * (L * kp * run_words(kp, es) + 1) +
              (size_t)T_FIELDS * FQ * L +
              (staged ? (size_t)FQ * (L * (kp - 1) * (kp - 1) + 1) : 0));
}

// 4 bytes global -> shared, asynchronously; src_bytes = 0 writes a zero
// word without reading (src must still be a valid address).
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <typename T, typename To, int RADIUS>
__global__ void __launch_bounds__(FNT, 4)
pyr_fwd_kernel(const __grid_constant__ Levels<T> lv,
               const float* __restrict__ coords,
               const float* __restrict__ scale, int L, int N, int radius_rt,
               To* __restrict__ out, long long out_sb, long long out_sq,
               long long out_sp) {
  constexpr int ES = (int)sizeof(T);
  // compile-time for RADIUS >= 0: every division by these folds
  const int radius = RADIUS >= 0 ? RADIUS : radius_rt;
  const int k = 2 * radius + 1, kp = k + 1, kk = k * k;
  const int wpr = run_words(kp, ES);  // words per window row
  const int nwd = kp * wpr;           // words per window
  const int qs = L * nwd + 1;         // words per query: odd
  const int nt = FQ * L;              // windows of the block
  const int P = L * kk;               // taps per query
  // query-major rows are staged and written flat; channel-major planes
  // are stored straight from registers
  const bool staged = out_sp == 1;
  extern __shared__ __align__(16) int fsm[];
  int* tab = fsm;                     // (T_FIELDS, nt)
  int* win = fsm + T_FIELDS * nt;     // (FQ, qs): query, level, row, word
  float* stile = reinterpret_cast<float*>(win + FQ * qs);  // (FQ, P + 1)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, q0 = blockIdx.x * FQ;

  // (1) the window table, window t = l * FQ + query
  for (int t = tid; t < nt; t += FNT) {
    const int l = t / FQ, q = q0 + t % FQ;
    int mode = 0, xr = 0, yr = 0;
    long long s00 = 0;  // byte offset of the window's (0, 0) value
    float fx = 0.0f, fy = 0.0f;
    if (q < N) {
      const long long qi = (long long)b * N + q;
      const int hl = lv.h[l], wl = lv.w[l];
      const Window wd = window_of(coords[qi * 2 + 0], coords[qi * 2 + 1], l,
                                  hl, wl, radius);
      // window columns [xa, xb) and rows [ya, yb) inside the level
      const int xa = max(0, -wd.x0), xb = max(xa, min(kp, wl - wd.x0));
      const int ya = max(0, -wd.y0), yb = max(ya, min(kp, hl - wd.y0));
      mode = wd.nan ? 2 : (wd.any && xa < xb && ya < yb);
      xr = xa | (xb << 16);
      yr = ya | (yb << 16);
      s00 = ((qi * hl + wd.y0) * wl + wd.x0) * ES;
      fx = wd.fx;
      fy = wd.fy;
    }
    tab[T_SLO * nt + t] = (int)s00;
    tab[T_SHI * nt + t] = (int)(s00 >> 32);
    tab[T_X * nt + t] = xr;
    tab[T_Y * nt + t] = yr;
    tab[T_FX * nt + t] = __float_as_int(fx);
    tab[T_FY * nt + t] = __float_as_int(fy);
    tab[T_MODE * nt + t] = mode;
  }
  __syncthreads();

  // (2) every window of the block into shared memory: a warp per window,
  // lanes over its words, all copies in flight before one wait
  const unsigned win_s = (unsigned)__cvta_generic_to_shared(win);
  for (int t = warp; t < nt; t += FNT / 32) {
    if (tab[T_MODE * nt + t] != 1) continue;  // warp-uniform
    const int l = t / FQ;
    const long long s00 =
        ((long long)tab[T_SHI * nt + t] << 32) | (unsigned)tab[T_SLO * nt + t];
    const int xr = tab[T_X * nt + t], yr = tab[T_Y * nt + t];
    const int xa = xr & 0xffff, xb = xr >> 16, ya = yr & 0xffff, yb = yr >> 16;
    const char* base = reinterpret_cast<const char*>(lv.p[l]);
    const int rs = lv.w[l] * ES;  // bytes per level row
    const unsigned dst = win_s + 4u * ((t % FQ) * qs + l * nwd);
#pragma unroll
    for (int p = lane; p < nwd; p += 32) {
      const int dy = p / wpr, w = p - dy * wpr;
      const long long s0 = s00 + (long long)dy * rs;  // the run's first value
      bool ok = dy >= ya && dy < yb;
      if constexpr (ES == 4) {
        ok = ok && w >= xa && w < xb;
      } else {  // the word's bytes relative to the run's first value
        const int rel = 4 * w - (int)(s0 & 3);
        ok = ok && rel + 4 > xa * ES && rel < xb * ES;
      }
      cp_async4(dst + 4u * p, base + (ok ? (s0 & ~3LL) + 4 * w : 0),
                ok ? 4 : 0);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // (3) taps: lanes over queries, warps over (level, block of tap rows)
  const int jc = max(1, (FNT / 32) / L);  // blocks of tap rows per level
  const int jr = (k + jc - 1) / jc;       // tap rows per block
  const int q = q0 + lane;
  for (int u = warp; u < L * jc; u += FNT / 32) {
    const int l = u / jc, j0 = (u - l * jc) * jr, j1 = min(k, j0 + jr);
    if (j0 >= j1) continue;
    const int t = l * FQ + lane;
    const int mode = tab[T_MODE * nt + t];
    const float fx = __int_as_float(tab[T_FX * nt + t]);
    const float fy = __int_as_float(tab[T_FY * nt + t]);
    const int xr = tab[T_X * nt + t];
    const int xa = xr & 0xffff, xb = xr >> 16;
    const int s0lo = tab[T_SLO * nt + t];
    const int rs = lv.w[l] * ES;
    // a quantized level's taps are its codes' samples times the
    // (batch, level) scale
    const float s = scale ? scale[b * L + l] : 1.0f;
    const float fill = mode == 2 ? CUDART_NAN_F : 0.0f;
    const unsigned char* slot =
        reinterpret_cast<const unsigned char*>(win + lane * qs + l * nwd);
    To* o = out + (long long)b * out_sb + (long long)min(q, N - 1) * out_sq +
            (long long)l * kk * out_sp;
    // the window value at (row dy, column x): rows and words outside the
    // level are zero; a word shared with a neighbouring value outside the
    // level is masked by column
    auto value = [&](int dy, int x) -> float {
      if constexpr (ES == 4) {
        return reinterpret_cast<const float*>(slot)[dy * wpr + x];
      } else {
        const int sh = (s0lo + dy * rs) & 3;  // the run's first byte
        const float v = to_f(
            *reinterpret_cast<const T*>(slot + dy * wpr * 4 + sh + x * ES));
        return x >= xa && x < xb ? v : 0.0f;
      }
    };
    auto store = [&](int i, int j, float tap) {
      const float v = mode == 1 ? tap : fill;
      if (staged)
        stile[lane * (P + 1) + l * kk + i * k + j] = v;
      else if (q < N)
        o[(long long)(i * k + j) * out_sp] = from_f<To>(v);
    };
    if constexpr (RADIUS >= 0) {
      constexpr int KP = 2 * RADIUS + 2;
      float r0[KP], r1[KP];  // window rows j and j + 1
#pragma unroll
      for (int x = 0; x < KP; ++x) r0[x] = value(j0, x);
      for (int j = j0; j < j1; ++j) {
#pragma unroll
        for (int x = 0; x < KP; ++x) r1[x] = value(j + 1, x);
        // y interpolation first, then x (the JAX order)
        float a0 = (1.0f - fy) * r0[0] + fy * r1[0];
#pragma unroll
        for (int i = 0; i < KP - 1; ++i) {
          const float a1 = (1.0f - fy) * r0[i + 1] + fy * r1[i + 1];
          store(i, j, s * ((1.0f - fx) * a0 + fx * a1));
          a0 = a1;
        }
#pragma unroll
        for (int x = 0; x < KP; ++x) r0[x] = r1[x];
      }
    } else {
      for (int j = j0; j < j1; ++j)
        for (int i = 0; i < k; ++i)
          store(i, j,
                s * ((1.0f - fx) * ((1.0f - fy) * value(j, i) +
                                    fy * value(j + 1, i)) +
                     fx * ((1.0f - fy) * value(j, i + 1) +
                           fy * value(j + 1, i + 1))));
    }
  }
  if (staged) {  // block-uniform: the block's rows are one span
    __syncthreads();
    To* ob = out + (long long)b * out_sb + (long long)q0 * out_sq;
    for (int qq = warp; qq < min(FQ, N - q0); qq += FNT / 32)
      for (int c = lane; c < P; c += 32)
        ob[(long long)qq * out_sq + c] = from_f<To>(stile[qq * (P + 1) + c]);
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

template <typename T, typename To, int RADIUS>
static cudaError_t launch_fwd(const Levels<T>& lv, int L, int B, int N,
                              int radius, const float* coords,
                              const float* scale, void* out, long long sb,
                              long long sq, long long sp, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes(L, radius, (int)sizeof(T), sp == 1);
  cudaError_t err = cudaFuncSetAttribute(
      pyr_fwd_kernel<T, To, RADIUS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + FQ - 1) / FQ, B);
  pyr_fwd_kernel<T, To, RADIUS><<<grid, FNT, smem, st>>>(
      lv, coords, scale, L, N, radius, reinterpret_cast<To*>(out), sb, sq,
      sp);
  return cudaGetLastError();
}

// radius 3 and 4 (the small and the full model) at compile time, any
// other at run time
template <typename T, typename To>
static cudaError_t launch_fwd_r(const Levels<T>& lv, int L, int B, int N,
                                int radius, const float* coords,
                                const float* scale, void* out, long long sb,
                                long long sq, long long sp, cudaStream_t st) {
  if (radius == 4)
    return launch_fwd<T, To, 4>(lv, L, B, N, radius, coords, scale, out, sb,
                                sq, sp, st);
  if (radius == 3)
    return launch_fwd<T, To, 3>(lv, L, B, N, radius, coords, scale, out, sb,
                                sq, sp, st);
  return launch_fwd<T, To, -1>(lv, L, B, N, radius, coords, scale, out, sb,
                               sq, sp, st);
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
  const size_t smem = bwd_smem_bytes(radius);
  // past 48 KB only when allowed; a refusal is left for cudaGetLastError
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(pyr_bwd_kernel<T, Tg>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return;
  pyr_bwd_kernel<T, Tg><<<plan.first[MAX_LEVELS], BNT, smem, st>>>(
      make_levels<T>(ptrs, hs, ws, L), plan, coords,
      reinterpret_cast<const Tg*>(g), sb, sq, sp, L, N, radius);
}

template <typename T>
static cudaError_t launch_fwd_to(int out_dtype, const long long* ptrs,
                                 const int* hs, const int* ws, int L, int B,
                                 int N, int radius, const float* coords,
                                 const float* scale, void* out, long long sb,
                                 long long sq, long long sp,
                                 cudaStream_t st) {
  const Levels<T> lv = make_levels<T>(ptrs, hs, ws, L);
  if (out_dtype == 0)
    return launch_fwd_r<T, float>(lv, L, B, N, radius, coords, scale, out,
                                  sb, sq, sp, st);
  return launch_fwd_r<T, __nv_bfloat16>(lv, L, B, N, radius, coords, scale,
                                        out, sb, sq, sp, st);
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
  for (int l = 0; l < L; ++l)  // the window rows are copied as 4-byte words
    if (level_ptrs[l] % 4) return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* c = reinterpret_cast<const float*>(coords);
  const float* sc = reinterpret_cast<const float*>(scale);
#define FWD(T)                                                              \
  launch_fwd_to<T>(out_dtype, level_ptrs, hs, ws, L, B, N, radius, c, sc,  \
                   out, out_sb, out_sq, out_sp, st)
  switch (level_dtype) {
    case 0: err = FWD(float); break;
    case 1: err = FWD(__nv_bfloat16); break;
    case 2: err = FWD(int8_t); break;
    case 3: err = FWD(__nv_fp8_e4m3); break;
    default: err = FWD(__nv_fp8_e5m2); break;
  }
#undef FWD
  return (int)err;
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
