// Fused ConvGRU gate chains, forward and backward, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of raft_tpu/ops/pallas_gru.py (reached through
// `gru_gate_rh` and `gru_gate_blend`):
//   `_rh_fwd_kernel` (:84)     -> rh_kernel:    out = sigmoid(r) * h
//   `_blend_fwd_kernel` (:99)  -> blend_kernel: out = (1 - sigmoid(z)) * h
//                                                    + sigmoid(z) * tanh(q)
//   `_rh_bwd_kernel` (:90)     -> rh_bwd_kernel: dr = g*h*s*(1-s),
//                                                dh = g*s    (s = sigmoid r)
//   `_blend_bwd_kernel` (:106) -> blend_bwd_kernel:
//        dz = g*(tanh q - h)*s*(1-s), dq = g*s*(1 - tanh^2 q), dh = g*(1-s)
//        (s = sigmoid z)
// The backward recomputes sigmoid and tanh from the saved raw inputs, as
// the JAX custom_vjp does, in the same operation order.  Math is fp32
// whatever the storage type, with expf / tanhf and an IEEE division (no
// fast-math intrinsics, so fp32 results stay within 1e-6 of the plain
// PyTorch version); each result is written in its operand's type (fp32,
// or bf16 rounded to nearest even).
//
// What bounds them on an H100: bytes.  A few flops per value against 3
// (rh) or 4 (blend) values moved forward and 5 (rh) or 7 (blend)
// backward.  At the serving slot shape (8 x 128 x 55 x 128 = 7.2 M
// values) the rh forward moves 43.3 MB in bf16 (12.9 us at 3.35 TB/s)
// and blend 57.7 MB (17.2 us); at the chairs step (8 x 128 x 46 x 62)
// the rh backward moves 29.2 MB in bf16 (8.7 us).  At the Sintel shape
// with B = 1 a forward is a few microseconds, the order of a launch.
// Each input is addressed as (B, inner) with its own batch stride, so
// the z/r halves of the convzr output (a channel split, not contiguous
// across the batch when B > 1) and rh's incoming gradient (a channel
// slice of the gradient of cat([rh, x])) are read in place without a
// copy.  Outputs are contiguous.
//
// The vectorized gates: rh_kernel, blend_kernel and rh_bwd_kernel share
// one body (`gate_walk`).  One value per thread (the first design, which
// blend_bwd_kernel keeps) moved 64 bytes a warp access in bf16, had one
// load of each operand in flight per thread, and turned over up to
// 2048 x B short blocks a launch with 64-bit index arithmetic per value
// (`grid_for`); its rate in values per second barely rose from fp32 to
// bf16, so the cost per value, not bytes, set its pace.  Now:
//   - every access moves 16 bytes (8 bf16 or 4 fp32 values), and each
//     thread loads U vectors of every input (RH_FWD_UNROLL,
//     BLEND_FWD_UNROLL, RH_BWD_UNROLL) before it uses the first;
//   - the grid is one wave of resident blocks (GATE_BLOCKS_PER_SM per SM,
//     the launch bounds' minimum, or fewer when there is less work), and
//     the blocks walk the units (sample, chunk of U x GATE_THREADS
//     vectors) in a stride loop: one integer division per unit, none per
//     value; the batch does not ride on blockIdx.y;
//   - access width, checked per launch by the wrapper (`gate_plan`) and
//     again here: the vector path when every base address (inputs and
//     outputs), every input batch stride and the sample size are
//     multiples of 16 bytes (at the model's shapes they always are: 128
//     or 96 channels a half); otherwise the same kernel with one value
//     per access (an odd channel count times an odd H*W, or a view that
//     starts off 16 bytes).  The last chunk of a sample is masked vector
//     by vector: a sample is a whole number of vectors, so no vector
//     straddles two samples;
//   - the arithmetic and its order are those of the one-value loop
//     (blend's one fused multiply-add written out), so the results are
//     the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

#define GATE_THREADS 256
#define GATE_BLOCKS_PER_SM 4  // resident blocks per SM; the grid is one wave
// vectors of each input in flight per thread (U), chosen on an H100: rh
// reads fastest at 2; blend, whose three inputs put 48 bytes a thread in
// flight at 1, reads 1-12% slower at 2 and spills at 3-4
#define RH_FWD_UNROLL 2
#define BLEND_FWD_UNROLL 1
#define RH_BWD_UNROLL 2

// VE values of T moved as one access, and their conversions to and from
// fp32 (bf16 kept as bf16x2 words, so a 16-byte pack takes 4 registers).
template <typename T, int VE>
struct __align__(sizeof(T) * VE) Pack {
  T x[VE];
};
template <>
struct __align__(16) Pack<__nv_bfloat16, 8> {
  __nv_bfloat162 x[4];
};

template <typename T, int VE>
__device__ __forceinline__ void unpack(const Pack<T, VE>& p, float* f) {
#pragma unroll
  for (int e = 0; e < VE; ++e) f[e] = load(&p.x[e]);
}
__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16, 8>& p,
                                       float* f) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(p.x[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}
template <typename T, int VE>
__device__ __forceinline__ void pack(const float* f, Pack<T, VE>& p) {
#pragma unroll
  for (int e = 0; e < VE; ++e) store(&p.x[e], f[e]);
}
__device__ __forceinline__ void pack(const float* f,
                                     Pack<__nv_bfloat16, 8>& p) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    p.x[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
}

// The gates' arithmetic on one value: NI fp32 inputs -> NO fp32 results
// (T: the storage type).
struct RhFwd {  // (r, h) -> sigmoid(r) * h
  static constexpr int NI = 2, NO = 1;
  template <typename T>
  __device__ __forceinline__ static void apply(const float* x, float* y) {
    y[0] = sigmoid_f32(x[0]) * x[1];
  }
};
struct BlendFwd {  // (z, q, h) -> (1 - sigmoid(z)) * h + sigmoid(z) * tanh(q)
  static constexpr int NI = 3, NO = 1;
  template <typename T>
  __device__ __forceinline__ static void apply(const float* x, float* y) {
    const float s = sigmoid_f32(x[0]);
    const float t = tanhf(x[1]);
    // (1 - s) * h + s * t with one product fused, written out so that the
    // bits do not hang on which product the compiler contracts: these are
    // the bits of this gate's first CUDA design (one value per thread),
    // which nvcc contracted one way in fp32 and the other in bf16
    y[0] = sizeof(T) == 4 ? fmaf(1.0f - s, x[2], s * t)
                          : fmaf(s, t, (1.0f - s) * x[2]);
  }
};
struct RhBwd {  // (r, h, g) -> (g*h*s*(1-s), g*s)
  static constexpr int NI = 3, NO = 2;
  template <typename T>
  __device__ __forceinline__ static void apply(const float* x, float* y) {
    const float s = sigmoid_f32(x[0]);
    y[0] = x[2] * x[1] * s * (1.0f - s);
    y[1] = x[2] * s;
  }
};

// The body of the vectorized gates: input j at in[j] with batch stride
// sin[j], output o at out[o] (contiguous); VE values a vector (16 bytes,
// or 1 value on the unaligned path); a unit (sample b, chunk c) is
// U * GATE_THREADS vectors.
template <class Op, int U, typename T, int VE>
__device__ __forceinline__ void gate_walk(const T* const (&in)[Op::NI],
                                          const long long (&sin)[Op::NI],
                                          T* const (&out)[Op::NO],
                                          long long inner, long long batch) {
  using P = Pack<T, VE>;
  constexpr int NI = Op::NI, NO = Op::NO, CHUNK = U * GATE_THREADS;
  const long long nvec = inner / VE;
  const long long per = (nvec + CHUNK - 1) / CHUNK;  // units per sample
  const long long units = batch * per;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = u / per;
    const long long i0 = (u - b * per) * CHUNK + threadIdx.x;
    P v[U][NI];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long i = i0 + k * GATE_THREADS;
      if (i < nvec) {
#pragma unroll
        for (int j = 0; j < NI; ++j)
          v[k][j] = reinterpret_cast<const P*>(in[j] + b * sin[j])[i];
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long i = i0 + k * GATE_THREADS;
      if (i >= nvec) continue;
      float x[NI][VE], y[NO][VE];
#pragma unroll
      for (int j = 0; j < NI; ++j) unpack(v[k][j], x[j]);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        float xe[NI], ye[NO];
#pragma unroll
        for (int j = 0; j < NI; ++j) xe[j] = x[j][e];
        Op::template apply<T>(xe, ye);
#pragma unroll
        for (int o = 0; o < NO; ++o) y[o][e] = ye[o];
      }
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        P p;
        pack(y[o], p);
        reinterpret_cast<P*>(out[o] + b * inner)[i] = p;
      }
    }
  }
}

template <typename T, int VE>
__global__ void __launch_bounds__(GATE_THREADS, GATE_BLOCKS_PER_SM)
rh_kernel(const T* __restrict__ r, long long sr, const T* __restrict__ h,
          long long sh, T* __restrict__ out, long long inner,
          long long batch) {
  gate_walk<RhFwd, RH_FWD_UNROLL, T, VE>({r, h}, {sr, sh}, {out}, inner,
                                        batch);
}

template <typename T, int VE>
__global__ void __launch_bounds__(GATE_THREADS, GATE_BLOCKS_PER_SM)
blend_kernel(const T* __restrict__ z, long long sz, const T* __restrict__ q,
             long long sq, const T* __restrict__ h, long long sh,
             T* __restrict__ out, long long inner, long long batch) {
  gate_walk<BlendFwd, BLEND_FWD_UNROLL, T, VE>({z, q, h}, {sz, sq, sh},
                                              {out}, inner, batch);
}

template <typename T, int VE>
__global__ void __launch_bounds__(GATE_THREADS, GATE_BLOCKS_PER_SM)
rh_bwd_kernel(const T* __restrict__ r, long long sr, const T* __restrict__ h,
              long long sh, const T* __restrict__ g, long long sg,
              T* __restrict__ dr, T* __restrict__ dh, long long inner,
              long long batch) {
  gate_walk<RhBwd, RH_BWD_UNROLL, T, VE>({r, h, g}, {sr, sh, sg}, {dr, dh},
                                         inner, batch);
}

// blockIdx.y is the sample; x walks the sample's contiguous block.
template <typename T>
__global__ void blend_bwd_kernel(const T* __restrict__ z, long long sz,
                                 const T* __restrict__ q, long long sq,
                                 const T* __restrict__ h, long long sh,
                                 const T* __restrict__ g, long long sg,
                                 T* __restrict__ dz, T* __restrict__ dq,
                                 T* __restrict__ dh, long long inner) {
  const long long b = blockIdx.y;
  z += b * sz;
  q += b * sq;
  h += b * sh;
  g += b * sg;
  dz += b * inner;
  dq += b * inner;
  dh += b * inner;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < inner; i += (long long)gridDim.x * blockDim.x) {
    const float s = sigmoid_f32(load(z + i));
    const float t = tanhf(load(q + i));
    const float gi = load(g + i);
    store(dz + i, gi * (t - load(h + i)) * s * (1.0f - s));
    store(dq + i, gi * s * (1.0f - t * t));
    store(dh + i, gi * (1.0f - s));
  }
}

static dim3 grid_for(long long inner, long long batch) {
  const long long blocks = (inner + 255) / 256;
  return dim3((unsigned)(blocks < 2048 ? blocks : 2048), (unsigned)batch);
}

// Checks a launch of a vectorized gate: sizes, dtype and the plan (vec:
// values per access, 16 / element size on the vector path, where `bits`,
// the OR of every address and of every batch stride in bytes, must be a
// multiple of 16; or 1; grid: blocks, at least 1).  Returns a cudaError_t
// to refuse the launch with, or -1 to go on.
static int refuse(int dtype, long long inner, long long total, int vec,
                  int grid, unsigned long long bits) {
  if (total == 0) return (int)cudaSuccess;
  if (total < 0 || inner <= 0 || total % inner || grid < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && (vec * (dtype == 0 ? 4 : 2) != 16 || bits % 16))
    return (int)cudaErrorInvalidValue;
  return -1;
}

static unsigned long long addr(const void* p) {
  return reinterpret_cast<unsigned long long>(p);
}

// The launch of kernel template K on the plan's path: fp32 or bf16, VE
// values a vector or one.
#define GATE_LAUNCH(K, ...)                                                  \
  do {                                                                       \
    cudaStream_t st_ = reinterpret_cast<cudaStream_t>(stream);               \
    if (dtype == 0) {                                                        \
      using T = float;                                                       \
      if (vec == 1) K<T, 1><<<grid, GATE_THREADS, 0, st_>>>(__VA_ARGS__);    \
      else K<T, 4><<<grid, GATE_THREADS, 0, st_>>>(__VA_ARGS__);             \
    } else {                                                                 \
      using T = __nv_bfloat16;                                               \
      if (vec == 1) K<T, 1><<<grid, GATE_THREADS, 0, st_>>>(__VA_ARGS__);    \
      else K<T, 8><<<grid, GATE_THREADS, 0, st_>>>(__VA_ARGS__);             \
    }                                                                        \
  } while (0)

// device: CUDA ordinal; dtype: 0 = float32, 1 = bfloat16.  Strides and
// sizes are in elements.  vec, grid: the plan the wrapper picked
// (`gate_plan`), checked by `refuse`.  Returns a cudaError_t (0 =
// success).
extern "C" int gru_gate_rh_fwd(int device, int dtype, const void* r,
                               long long sr, const void* h, long long sh,
                               void* out, long long inner, long long total,
                               int vec, int grid, void* stream) {
  const long long es = dtype == 0 ? 4 : 2;
  const int rc = refuse(dtype, inner, total, vec, grid,
                        addr(r) | addr(h) | addr(out) |
                            (unsigned long long)((sr | sh | inner) * es));
  if (rc >= 0) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GATE_LAUNCH(rh_kernel, (const T*)r, sr, (const T*)h, sh, (T*)out, inner,
              total / inner);
  return (int)cudaGetLastError();
}

extern "C" int gru_gate_blend_fwd(int device, int dtype, const void* z,
                                  long long sz, const void* q, long long sq,
                                  const void* h, long long sh, void* out,
                                  long long inner, long long total, int vec,
                                  int grid, void* stream) {
  const long long es = dtype == 0 ? 4 : 2;
  const int rc = refuse(
      dtype, inner, total, vec, grid,
      addr(z) | addr(q) | addr(h) | addr(out) |
          (unsigned long long)((sz | sq | sh | inner) * es));
  if (rc >= 0) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GATE_LAUNCH(blend_kernel, (const T*)z, sz, (const T*)q, sq, (const T*)h,
              sh, (T*)out, inner, total / inner);
  return (int)cudaGetLastError();
}

extern "C" int gru_gate_rh_bwd(int device, int dtype, const void* r,
                               long long sr, const void* h, long long sh,
                               const void* g, long long sg, void* dr,
                               void* dh, long long inner, long long total,
                               int vec, int grid, void* stream) {
  const long long es = dtype == 0 ? 4 : 2;
  const int rc = refuse(
      dtype, inner, total, vec, grid,
      addr(r) | addr(h) | addr(g) | addr(dr) | addr(dh) |
          (unsigned long long)((sr | sh | sg | inner) * es));
  if (rc >= 0) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GATE_LAUNCH(rh_bwd_kernel, (const T*)r, sr, (const T*)h, sh, (const T*)g,
              sg, (T*)dr, (T*)dh, inner, total / inner);
  return (int)cudaGetLastError();
}

extern "C" int gru_gate_blend_bwd(int device, int dtype, const void* z, long long sz,
                                  const void* q, long long sq, const void* h,
                                  long long sh, const void* g, long long sg,
                                  void* dz, void* dq, void* dh,
                                  long long inner, long long total,
                                  void* stream) {
  if (total <= 0 || inner <= 0 || total % inner || total / inner > 65535)
    return total == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(inner, total / inner);
  if (dtype == 0) {
    blend_bwd_kernel<float><<<grid, 256, 0, st>>>(
        (const float*)z, sz, (const float*)q, sq, (const float*)h, sh,
        (const float*)g, sg, (float*)dz, (float*)dq, (float*)dh, inner);
  } else if (dtype == 1) {
    blend_bwd_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        (const __nv_bfloat16*)z, sz, (const __nv_bfloat16*)q, sq,
        (const __nv_bfloat16*)h, sh, (const __nv_bfloat16*)g, sg,
        (__nv_bfloat16*)dz, (__nv_bfloat16*)dq, (__nv_bfloat16*)dh, inner);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
