// Fused pyramid lookup -> the motion encoder's 1x1 convc1 (+ bias + relu),
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `_pyr_encode_kernel` in
// raft_tpu/ops/pallas_corr.py, reached through `_pyr_levels_fwd_encode` /
// `pallas_pyramid_lookup_encode` (its custom_vjp forward `_pyr_enc_fwd`).
//
// Function.  For query n of batch element b:
//   out[b, f, n] = relu(sum_t taps[b, n, t] * W'[b, t, f] + bias[f])
// with taps the raw window samples of the stored levels (fp32, bf16 or
// int8 / fp8 codes; pyramid_window.cuh) and W' convc1's weight as a
// (K_pad, F4) fp32 matrix, K = L*k*k taps padded with zero rows to
// K_pad (a multiple of 8), F padded with zero columns to F4 (a multiple
// of 4).  For a quantized pyramid W' is one matrix per batch element, each
// level's rows times that (b, level)'s scale (the scale folded into the
// weights, as the TPU kernel's caller does); the wrapper builds it
// (ops/lookup_encode.py).  The sum is fp32 and the result is stored once
// in the output dtype (fp32 or bf16), NCHW (B, F, H1, W1): the layout
// convc2 reads.  The relu keeps NaN (as torch.relu and jnp.maximum do): a
// NaN center gives NaN taps and so NaN in all F outputs of its query.
// The (B, N, K) tap tensor never reaches device memory.
//
// What bounds it on an H100.  At the chairs training shape (B = 8,
// N = 2852, four levels, r = 4, F = 256) the contraction is
// 2 * 8 * 2852 * 324 * 256 = 3.79 GFLOP; the bytes are the ~9 M window
// values, the 331 KB weight and the output (23 MB fp32): ~0.02 ms.  On
// fp32 CUDA cores the operations bound it (0.057 ms at 67 TFLOP/s); on
// the tensor cores in 3xTF32 (3 x 3.79 GFLOP) it is 0.023 ms at the
// 495 TFLOP/s dense TF32 peak, and the bytes bound it.
//
// Design.  The first version (one warp per query for the sampling, fp32
// FMAs on CUDA cores with the weights re-staged and re-scaled by every
// block, 32 queries a block) took 0.33-0.42 ms at chairs (PERF.md):
// slower than the lookup kernel + cuDNN's 1x1 conv it fuses.  This one:
//   - a block of 8 warps owns MT = 64 queries of one batch element, grid
//     (N / MT, B), two blocks per SM;
//   - sampling: the block's (query, level) windows are spread over the
//     warps, PP = 2 at a time per warp; a warp loads each (k+1)^2 window
//     value once (lanes over consecutive positions of the window's rows,
//     all loads of its PP windows issued before any is used) into its
//     scratch in shared memory, then forms the k*k taps from there in the
//     lookup's operation order and stores them as the A tile, MT x K_pad
//     fp32 (row stride K_pad + 4: the mma fragment reads are free of bank
//     conflicts).  Window offsets come from tables built once per block
//     (an integer division by a runtime size costs tens of instructions);
//   - contraction on the tensor cores: mma.sync m16n8k8 TF32 in a 3xTF32
//     split, each operand x = hi + lo with hi = tf32(x), lo = tf32(x - hi),
//     and acc += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in fp32, which keeps
//     fp32 accuracy (a single TF32 or bf16 pass would not).  Each warp
//     owns all 64 rows and 32 columns of a 256-feature pass (4 x 4 mma
//     tiles, 64 accumulators a thread) and reads its B fragments straight
//     from W' (331 KB, resident in L2) one k-step ahead, so the k-loop has
//     no barrier; F > 256 takes more passes over the same A tile, and a
//     warp whose columns lie past F skips the pass;
//   - epilogue: bias, the NaN-keeping relu, one store per value straight
//     from the accumulator fragments (8 consecutive queries of a feature
//     row per 32 bytes).
// The level tables are __grid_constant__ (indexed by a runtime level, a
// copy of them in local memory otherwise).  The radius is at most 5.

#include "pyramid_window.cuh"

#define MT 64      // queries per block (rows of the A tile)
#define NTH 256    // threads per block: 8 warps, each 32 features of a pass
#define FT 256     // features per pass (columns of the block's tile)
#define PP 2       // windows a warp samples at once
#define MAX_RADIUS 5
#define WIN_MAX ((2 * MAX_RADIUS + 2) * (2 * MAX_RADIUS + 2))

// Dynamic shared memory of one block, in bytes (ops/lookup_encode.py
// checks the same formula against the card's 227 KB).
static inline size_t encode_smem_bytes(int L, int radius) {
  const int k = 2 * radius + 1;
  const int kpad = (L * k * k + 7) & ~7;
  return sizeof(float) * ((size_t)MT * (kpad + 4) +
                          (size_t)((NTH / 32) * PP + 1) * (k + 1) * (k + 1) +
                          k * k);
}

__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (fp32 bit patterns with the low 13 bits zero)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a . b for one m16n8k8 TF32 tile (fp32 accumulators)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of one k-step for the warp's 4 n-tiles: rows k0 + tg
// and k0 + tg + 4, column c + 8j of W' (zero past f4).
__device__ __forceinline__ void load_b(float (&bv)[4][2], const float* w,
                                       int k0, int c, int f4) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = c + 8 * j < f4;
    bv[j][0] = in ? __ldg(w + (long long)k0 * f4 + c + 8 * j) : 0.0f;
    bv[j][1] = in ? __ldg(w + (long long)(k0 + 4) * f4 + c + 8 * j) : 0.0f;
  }
}

template <typename T, typename To>
__global__ void __launch_bounds__(NTH, 2)
lookup_encode_kernel(const __grid_constant__ Levels<T> lv,
                     const float* __restrict__ coords,
                     const float* __restrict__ w, long long w_sb,
                     const float* __restrict__ bias, int L, int N,
                     int radius, int F, int f4, To* __restrict__ out) {
  const int k = 2 * radius + 1;
  const int kp = k + 1;
  const int npos = kp * kp;
  const int kk = k * k;
  const int K = L * kk;
  const int kpad = (K + 7) & ~7;
  const int ks = kpad + 4;  // == 4 (mod 8): conflict-free A fragments
  extern __shared__ __align__(16) float smem[];
  float* A = smem;  // (MT, ks) taps
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* win = A + MT * ks + warp * PP * npos;  // the warp's windows
  // window position -> (y << 16) | x, and tap -> its scratch offset: no
  // integer division by a runtime size in the loops (each costs tens of
  // instructions)
  int* ptab = reinterpret_cast<int*>(A + MT * ks + (NTH / 32) * PP * npos);
  int* toff = ptab + npos;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * MT;
  const float* wb = w + b * w_sb;

  // --- sampling: the A tile.  A warp loads PP windows at once, each
  // (k+1)^2 window value once (lanes over consecutive positions of its
  // rows), into its scratch, then forms the k*k taps of each from there.
  for (int q = warp; q < MT; q += NTH / 32)
    for (int c = K + lane; c < kpad; c += 32) A[q * ks + c] = 0.0f;
  for (int p = tid; p < npos; p += NTH) ptab[p] = ((p / kp) << 16) | (p % kp);
  for (int t = tid; t < kk; t += NTH) toff[t] = (t % k) * kp + t / k;
  __syncthreads();
  for (int p0 = warp * PP; p0 < MT * L; p0 += (NTH / 32) * PP) {
    float v[PP][(WIN_MAX + 31) / 32];
    Window wd[PP];
#pragma unroll
    for (int u = 0; u < PP; ++u) {
      const int p = p0 + u, l = p / MT, q = q0 + p % MT;
      const int hl = lv.h[l], wl = lv.w[l];
      const long long qi = (long long)b * N + q;
      wd[u] = q < N ? window_of(coords[qi * 2 + 0], coords[qi * 2 + 1], l,
                                hl, wl, radius)
                    : Window{0, 0, 0.0f, 0.0f, false, false};
      const T* row = lv.p[l] + (q < N ? qi * hl * wl : 0);
#pragma unroll
      for (int s = 0; s < (WIN_MAX + 31) / 32; ++s) {
        const int pp = lane + 32 * s;
        const int xy = pp < npos ? ptab[pp] : 0;
        const int Y = wd[u].y0 + (xy >> 16), X = wd[u].x0 + (xy & 0xffff);
        v[u][s] = wd[u].any && pp < npos && X >= 0 && X < wl && Y >= 0 &&
                          Y < hl
                      ? to_f(row[(long long)Y * wl + X])
                      : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < PP; ++u)
#pragma unroll
      for (int s = 0; s < (WIN_MAX + 31) / 32; ++s)
        if (lane + 32 * s < npos) win[u * npos + lane + 32 * s] = v[u][s];
    __syncwarp();
#pragma unroll
    for (int u = 0; u < PP; ++u) {
      const int p = p0 + u, l = p / MT, q = p % MT;
      const float fx = wd[u].fx, fy = wd[u].fy;
      for (int t = lane; t < kk; t += 32) {
        // tap t = i*k + j (i walks x, j walks y) reads from j*kp + i on
        const float* d = win + u * npos + toff[t];
        // the lookup's order: y interpolation first, then x (a center
        // with no window, an infinite one too, has taps 0; a NaN one NaN)
        A[q * ks + l * kk + t] =
            !wd[u].any ? (wd[u].nan ? CUDART_NAN_F : 0.0f)
                       : (1.0f - fx) * ((1.0f - fy) * d[0] + fy * d[kp]) +
                             fx * ((1.0f - fy) * d[1] + fy * d[kp + 1]);
      }
    }
    __syncwarp();  // the scratch is rewritten by the warp's next windows
  }
  __syncthreads();

  // --- contraction: out tile = A . W'[:, f0 : f0 + FT] in 3xTF32.  The
  // warp owns all MT rows and 32 columns (4 x 4 mma tiles); its B
  // fragments come straight from W' in L2, one k-step ahead, so the loop
  // has no barrier.
  const int g = lane >> 2, tg = lane & 3;
  const int nk = kpad / 8;
  for (int f0 = 0; f0 < F; f0 += FT) {
    const int c0 = f0 + warp * 32;  // the warp's first column
    if (c0 >= F) continue;          // warp-uniform
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
    float bn[4][2];
    load_b(bn, wb, tg, c0 + g, f4);
    for (int kc = 0; kc < nk; ++kc) {
      unsigned bhi[4][2], blo[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(bn[j][0], bhi[j][0], blo[j][0]);
        split_tf32(bn[j][1], bhi[j][1], blo[j][1]);
      }
      if (kc + 1 < nk) load_b(bn, wb, (kc + 1) * 8 + tg, c0 + g, f4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* ar = A + (i * 16 + g) * ks + kc * 8 + tg;
        unsigned ahi[4], alo[4];
        split_tf32(ar[0], ahi[0], alo[0]);
        split_tf32(ar[8 * ks], ahi[1], alo[1]);
        split_tf32(ar[4], ahi[2], alo[2]);
        split_tf32(ar[8 * ks + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], alo, bhi[j][0], bhi[j][1]);
          mma_tf32(acc[i][j], ahi, blo[j][0], blo[j][1]);
          mma_tf32(acc[i][j], ahi, bhi[j][0], bhi[j][1]);
        }
      }
    }
    // epilogue: c0, c1 at (row g, cols 2tg, 2tg+1), c2, c3 at row g + 8
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = c0 + j * 8 + 2 * tg + (c & 1);
        if (f >= F) continue;
        const float bf = bias[f];
        To* of = out + ((long long)b * F + f) * N;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + i * 16 + g + 8 * (c >> 1);
          if (q >= N) continue;
          const float v = acc[i][j][c] + bf;
          of[q] = from_f<To>(v < 0.0f ? 0.0f : v);  // keeps NaN
        }
      }
    }
  }
}

template <typename T, typename To>
static int launch(const long long* ptrs, const int* hs, const int* ws, int L,
                  int B, int N, int radius, const float* coords,
                  const float* w, long long w_sb, const float* bias, int F,
                  int f4, void* out, cudaStream_t st) {
  const size_t smem = encode_smem_bytes(L, radius);
  cudaError_t err = cudaFuncSetAttribute(
      lookup_encode_kernel<T, To>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + MT - 1) / MT, B);
  lookup_encode_kernel<T, To><<<grid, NTH, smem, st>>>(
      make_levels<T>(ptrs, hs, ws, L), coords, w, w_sb, bias, L, N, radius,
      F, f4, reinterpret_cast<To*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_to(int out_dtype, const long long* ptrs, const int* hs,
                     const int* ws, int L, int B, int N, int radius,
                     const float* coords, const float* w, long long w_sb,
                     const float* bias, int F, int f4, void* out,
                     cudaStream_t st) {
  if (out_dtype == 0)
    return launch<T, float>(ptrs, hs, ws, L, B, N, radius, coords, w, w_sb,
                            bias, F, f4, out, st);
  return launch<T, __nv_bfloat16>(ptrs, hs, ws, L, B, N, radius, coords, w,
                                  w_sb, bias, F, f4, out, st);
}

// Level dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = fp8 e4m3,
// 4 = fp8 e5m2; output dtype codes: 0 = float32, 1 = bfloat16.  `weight`
// is W', (K_pad, f4) fp32 with K_pad = L*(2r+1)^2 rounded up to 8 and f4
// = F rounded up to 4 (zero padding), one such matrix per batch element
// `weight_sb` floats apart (0: shared); `bias` (F,) fp32, `out` (B, F, N)
// contiguous.  Returns a cudaError_t (0 = success).
extern "C" int lookup_encode_fwd(int device, int level_dtype, int out_dtype,
                                 const long long* level_ptrs, const int* hs,
                                 const int* ws, int L, int B, int N,
                                 int radius, const void* coords,
                                 const void* weight, long long weight_sb,
                                 const void* bias, int F, int f4, void* out,
                                 void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 1 || N < 1 || F < 1 || f4 < F ||
      f4 % 4 || radius < 0 || radius > MAX_RADIUS || level_dtype < 0 ||
      level_dtype > 4 || out_dtype < 0 || out_dtype > 1 ||
      reinterpret_cast<unsigned long long>(weight) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* c = reinterpret_cast<const float*>(coords);
  const float* wt = reinterpret_cast<const float*>(weight);
  const float* bs = reinterpret_cast<const float*>(bias);
#define ENC(T)                                                             \
  launch_to<T>(out_dtype, level_ptrs, hs, ws, L, B, N, radius, c, wt,      \
               weight_sb, bs, F, f4, out, st)
  switch (level_dtype) {
    case 0: return ENC(float);
    case 1: return ENC(__nv_bfloat16);
    case 2: return ENC(int8_t);
    case 3: return ENC(__nv_fp8_e4m3);
    default: return ENC(__nv_fp8_e5m2);
  }
#undef ENC
}
