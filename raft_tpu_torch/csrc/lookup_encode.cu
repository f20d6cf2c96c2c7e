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
// int8 / fp8 codes; pyramid_window.cuh) and W'[b, t, f] = w[f, t] times
// the (b, level(t)) scale for a quantized pyramid (the scale folded into
// the weights, as the TPU kernel's caller does), w itself otherwise.
// w is convc1's weight (F, L*k*k, 1, 1) in fp32 whatever the compute
// dtype; the sum is fp32 and the result is stored once in the output
// dtype (fp32 or bf16), NCHW (B, F, H1, W1): the layout convc2 reads.
// The (B, N, L*k*k) tap tensor never reaches device memory.
//
// What bounds it on an H100.  At the chairs training shape (B = 8,
// N = 2852, four levels, r = 4, F = 256) the contraction is
// 2 * 8 * 2852 * 324 * 256 = 3.79 GFLOP of fp32 FMAs (0.057 ms at
// 67 TFLOP/s on CUDA cores); the bytes are the ~9 M window values, the
// 331 KB weight and the output (23 MB fp32): ~0.02 ms.  So operations
// bound it.
//
// Design (a simple first version; it leaves the tensor cores unused):
//   - one block of 8 warps per tile of QT = 32 queries of one batch
//     element, grid (N / QT, B);
//   - phase 1, taps: each warp samples the windows of 4 queries with the
//     lookup's window code and writes the (L*k*k) x QT tap tile to shared
//     memory (row stride QT + 1: the warp writes a column, conflict-free);
//   - phase 2, contraction on CUDA cores: lane = query, warp = 32
//     consecutive features (acc[32] in registers); W' is staged through
//     shared memory TK = 16 rows at a time (scaled on the way in), read as
//     broadcast float4s; each tap is read once per row, conflict-free;
//   - bias + relu, then each warp stores 32 contiguous queries per
//     feature row (coalesced).

#include "pyramid_window.cuh"

#define QT 32      // queries per block (one per lane in the contraction)
#define NWARPS 8   // warps per block
#define FW 32      // features per warp per pass (accumulators per lane)
#define TK 16      // weight rows staged per step
#define FPAD 4     // padding of a staged weight row, in floats

// Dynamic shared memory of one block, in bytes (ops/lookup_encode.py
// checks the same formula against the card's 227 KB).
static inline size_t encode_smem_bytes(int L, int radius) {
  const int k = 2 * radius + 1;
  const int FP = NWARPS * FW + FPAD;
  return sizeof(float) * ((size_t)TK * FP + (size_t)L * k * k * (QT + 1) +
                          (size_t)NWARPS * (k + 1) * (k + 1));
}

template <typename T, typename To>
__global__ void __launch_bounds__(32 * NWARPS)
lookup_encode_kernel(Levels<T> lv, const float* __restrict__ coords,
                     const float* __restrict__ scale,
                     const float* __restrict__ w,
                     const float* __restrict__ bias, int L, int N,
                     int radius, int F, To* __restrict__ out) {
  const int k = 2 * radius + 1;
  const int kk = k * k;
  const int KK = L * kk;
  const int FP = NWARPS * FW + FPAD;
  extern __shared__ __align__(16) float smem[];
  float* wst = smem;                              // (TK, FP) weight rows
  float* taps = wst + TK * FP;                    // (KK, QT + 1)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* vals = taps + KK * (QT + 1) + warp * (k + 1) * (k + 1);
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QT;

  // phase 1: the tile's raw taps, one warp per query
  for (int qq = warp; qq < QT; qq += NWARPS) {
    const int q = q0 + qq;
    if (q >= N) {
      for (int t = lane; t < KK; t += 32) taps[t * (QT + 1) + qq] = 0.0f;
      continue;
    }
    const long long qi = (long long)b * N + q;
    const float cx0 = coords[qi * 2 + 0];
    const float cy0 = coords[qi * 2 + 1];
    for (int l = 0; l < L; ++l)
      warp_window_taps(lv.p[l], qi, lv.h[l], lv.w[l], l, cx0, cy0, radius,
                       1.0f, vals, taps + (l * kk) * (QT + 1) + qq, QT + 1,
                       lane);
  }

  // phase 2: out[q, f] = relu(taps[q, :] . W'[:, f] + bias[f])
  const int q = q0 + lane;
  for (int f0 = 0; f0 < F; f0 += NWARPS * FW) {
    float acc[FW];
#pragma unroll
    for (int c = 0; c < FW; ++c) acc[c] = 0.0f;
    for (int t0 = 0; t0 < KK; t0 += TK) {
      const int nt = min(TK, KK - t0);
      __syncthreads();  // the taps are complete / the last rows consumed
      // stage W'[t0 : t0 + nt, f0 : f0 + 256]: consecutive threads read
      // consecutive t of one feature (w is (F, KK), t fastest)
      for (int e = threadIdx.x; e < TK * NWARPS * FW; e += blockDim.x) {
        const int t = e % TK, fl = e / TK;
        const int f = f0 + fl;
        float v = 0.0f;
        if (t < nt && f < F) {
          v = w[(long long)f * KK + t0 + t];
          if (scale) v *= scale[b * L + (t0 + t) / kk];
        }
        wst[t * FP + fl] = v;
      }
      __syncthreads();
      for (int t = 0; t < nt; ++t) {
        const float tap = taps[(t0 + t) * (QT + 1) + lane];
        const float4* wr =
            reinterpret_cast<const float4*>(wst + t * FP + warp * FW);
#pragma unroll
        for (int c4 = 0; c4 < FW / 4; ++c4) {
          const float4 wv = wr[c4];
          acc[4 * c4 + 0] = fmaf(tap, wv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(tap, wv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(tap, wv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(tap, wv.w, acc[4 * c4 + 3]);
        }
      }
    }
    if (q < N) {
      To* ob = out + (long long)b * F * N + q;
#pragma unroll
      for (int c = 0; c < FW; ++c) {
        const int f = f0 + warp * FW + c;
        if (f < F) ob[(long long)f * N] = from_f<To>(fmaxf(acc[c] + bias[f],
                                                           0.0f));
      }
    }
  }
}

template <typename T, typename To>
static int launch(const long long* ptrs, const int* hs, const int* ws, int L,
                  int B, int N, int radius, const float* coords,
                  const float* scale, const float* w, const float* bias,
                  int F, void* out, cudaStream_t st) {
  const size_t smem = encode_smem_bytes(L, radius);
  cudaError_t err = cudaFuncSetAttribute(
      lookup_encode_kernel<T, To>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + QT - 1) / QT, B);
  lookup_encode_kernel<T, To><<<grid, 32 * NWARPS, smem, st>>>(
      make_levels<T>(ptrs, hs, ws, L), coords, scale, w, bias, L, N, radius,
      F, reinterpret_cast<To*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_to(int out_dtype, const long long* ptrs, const int* hs,
                     const int* ws, int L, int B, int N, int radius,
                     const float* coords, const float* scale, const float* w,
                     const float* bias, int F, void* out, cudaStream_t st) {
  if (out_dtype == 0)
    return launch<T, float>(ptrs, hs, ws, L, B, N, radius, coords, scale, w,
                            bias, F, out, st);
  return launch<T, __nv_bfloat16>(ptrs, hs, ws, L, B, N, radius, coords,
                                  scale, w, bias, F, out, st);
}

// Level dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = fp8 e4m3,
// 4 = fp8 e5m2; output dtype codes: 0 = float32, 1 = bfloat16.  `scale` is
// null for plain levels and a (B, L) fp32 array for quantized ones;
// `weight` is (F, L*k*k) fp32, `bias` (F,) fp32, `out` (B, F, N)
// contiguous.  Returns a cudaError_t (0 = success).
extern "C" int lookup_encode_fwd(int device, int level_dtype, int out_dtype,
                                 const long long* level_ptrs, const int* hs,
                                 const int* ws, int L, int B, int N,
                                 int radius, const void* coords,
                                 const void* scale, const void* weight,
                                 const void* bias, int F, void* out,
                                 void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 1 || N < 1 || F < 1 || radius < 0 ||
      level_dtype < 0 || level_dtype > 4 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* c = reinterpret_cast<const float*>(coords);
  const float* sc = reinterpret_cast<const float*>(scale);
  const float* wt = reinterpret_cast<const float*>(weight);
  const float* bs = reinterpret_cast<const float*>(bias);
#define ENC(T)                                                              \
  launch_to<T>(out_dtype, level_ptrs, hs, ws, L, B, N, radius, c, sc, wt, \
               bs, F, out, st)
  switch (level_dtype) {
    case 0: return ENC(float);
    case 1: return ENC(__nv_bfloat16);
    case 2: return ENC(int8_t);
    case 3: return ENC(__nv_fp8_e4m3);
    default: return ENC(__nv_fp8_e5m2);
  }
#undef ENC
}
