// Fused ConvGRU gate chains, forward and backward, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of raft_tpu/ops/pallas_gru.py (reached through
// `gru_gate_rh` and `gru_gate_blend`):
//   `_rh_fwd_kernel`     gru_gate_rh:    out = sigmoid(r) * h
//   `_blend_fwd_kernel`  gru_gate_blend: out = (1 - sigmoid(z)) * h
//                                              + sigmoid(z) * tanh(q)
//   `_rh_bwd_kernel`     dr = g*h*s*(1-s), dh = g*s            (s = sigmoid r)
//   `_blend_bwd_kernel`  dz = g*(tanh q - h)*s*(1-s),
//                        dq = g*s*(1 - tanh^2 q), dh = g*(1-s) (s = sigmoid z)
// The backward recomputes sigmoid and tanh from the saved raw inputs, as
// the JAX custom_vjp does, in the same operation order.  Math is fp32
// whatever the storage type; each result is written in its operand's
// type (fp32, or bf16 rounded to nearest even).
//
// What bounds it on an H100.  A few flops per element against 8-12 bytes
// (fp32) or 4-8 bytes (bf16) per element: memory bound.  At the Sintel
// shape (1 x 128 x 55 x 128 = 901,120 elements) rh moves 10.8 MB in fp32
// (3.2 us at 3.35 TB/s) and blend 14.4 MB (4.3 us); at that size the
// launch itself (a few us) is of the same order.  The backward moves 5
// (rh) and 7 (blend) values per element.
//
// Design.  One grid-stride elementwise loop per gate (grid y = sample, so
// no per-element index division), fp32 math with
// expf/tanhf (no fast-math intrinsics, so fp32 results stay within 1e-6
// of the plain PyTorch version).  Each input is addressed as (B, inner)
// with its own batch stride, so the z/r halves of the convzr output (a
// channel split, not contiguous across the batch when B > 1) are read in
// place without a copy; so is the incoming gradient of rh, itself a
// channel slice of the gradient of the concatenation [rh, x].  Outputs
// are contiguous.
//
// The reset-gate backward (`rh_bwd_kernel`, redesigned for Hopper; it
// replaces `_rh_bwd_kernel`, raft_tpu/ops/pallas_gru.py:90, reached
// through `_rh_core_bwd`).  At the
// chairs step (8 x 128 x 46 x 62) it moves 29.2 MB in bf16 (8.7 us at
// 3.35 TB/s) and 58.4 MB in fp32.  The one-value-per-thread loop above
// moved 64 bytes per warp access in bf16, had three loads in flight per
// thread, and turned over 11,408 short blocks a launch (`grid_for`,
// which the other three gates keep).  Now:
//   - every access moves 16 bytes (8 bf16 or 4 fp32 values), and each
//     thread loads RH_UNROLL = 2 vectors of each of r, h and g before it
//     uses the first;
//   - the grid is one wave of resident blocks (RH_BLOCKS_PER_SM per SM,
//     the launch bounds' minimum, or fewer when there is less work),
//     and the blocks walk the units (sample, chunk of 2 x 256 vectors)
//     in a stride loop: one integer division per unit, none per value;
//   - access width, checked per launch by the wrapper and again here: the
//     vector path when every base address (r, h, g, dr, dh), every batch
//     stride and the sample size are multiples of 16 bytes (at the
//     model's shapes they always are: 128 channels a half); otherwise the
//     same kernel with one value per access (an odd channel count times
//     an odd H*W, or a view that starts off 16 bytes).  The last chunk of
//     a sample is masked value by value (a vector never straddles two
//     samples, since a sample is a whole number of vectors);
//   - the arithmetic and its order are those of the loop above; bf16
//     results are rounded to nearest even.

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

// blockIdx.y is the sample; x walks the sample's contiguous block.
template <typename T>
__global__ void rh_kernel(const T* __restrict__ r, long long sr,
                          const T* __restrict__ h, long long sh,
                          T* __restrict__ out, long long inner) {
  const long long b = blockIdx.y;
  r += b * sr;
  h += b * sh;
  out += b * inner;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < inner; i += (long long)gridDim.x * blockDim.x) {
    store(out + i, sigmoid_f32(load(r + i)) * load(h + i));
  }
}

template <typename T>
__global__ void blend_kernel(const T* __restrict__ z, long long sz,
                             const T* __restrict__ q, long long sq,
                             const T* __restrict__ h, long long sh,
                             T* __restrict__ out, long long inner) {
  const long long b = blockIdx.y;
  z += b * sz;
  q += b * sq;
  h += b * sh;
  out += b * inner;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < inner; i += (long long)gridDim.x * blockDim.x) {
    const float s = sigmoid_f32(load(z + i));
    const float t = tanhf(load(q + i));
    store(out + i, (1.0f - s) * load(h + i) + s * t);
  }
}

#define RH_THREADS 256
#define RH_UNROLL 2         // vectors of each operand in flight per thread
#define RH_BLOCKS_PER_SM 4  // resident blocks per SM; the grid is one wave

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

// u: a unit (sample b, chunk c) of RH_UNROLL * RH_THREADS vectors; VE
// values a vector (16 bytes, or 1 value on the unaligned path).
template <typename T, int VE>
__global__ void __launch_bounds__(RH_THREADS, RH_BLOCKS_PER_SM)
rh_bwd_kernel(const T* __restrict__ r, long long sr, const T* __restrict__ h,
              long long sh, const T* __restrict__ g, long long sg,
              T* __restrict__ dr, T* __restrict__ dh, long long inner,
              long long batch) {
  using P = Pack<T, VE>;
  constexpr int CHUNK = RH_UNROLL * RH_THREADS;
  const long long nvec = inner / VE;
  const long long per = (nvec + CHUNK - 1) / CHUNK;  // units per sample
  const long long units = batch * per;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = u / per;
    const long long i0 = (u - b * per) * CHUNK + threadIdx.x;
    const P* rb = reinterpret_cast<const P*>(r + b * sr);
    const P* hb = reinterpret_cast<const P*>(h + b * sh);
    const P* gb = reinterpret_cast<const P*>(g + b * sg);
    P* drb = reinterpret_cast<P*>(dr + b * inner);
    P* dhb = reinterpret_cast<P*>(dh + b * inner);
    P rv[RH_UNROLL], hv[RH_UNROLL], gv[RH_UNROLL];
#pragma unroll
    for (int k = 0; k < RH_UNROLL; ++k) {
      const long long i = i0 + k * RH_THREADS;
      if (i < nvec) {
        rv[k] = rb[i];
        hv[k] = hb[i];
        gv[k] = gb[i];
      }
    }
#pragma unroll
    for (int k = 0; k < RH_UNROLL; ++k) {
      const long long i = i0 + k * RH_THREADS;
      if (i >= nvec) continue;
      float rf[VE], hf[VE], gf[VE], drf[VE], dhf[VE];
      unpack(rv[k], rf);
      unpack(hv[k], hf);
      unpack(gv[k], gf);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float s = sigmoid_f32(rf[e]);
        drf[e] = gf[e] * hf[e] * s * (1.0f - s);
        dhf[e] = gf[e] * s;
      }
      P drv, dhv;
      pack(drf, drv);
      pack(dhf, dhv);
      drb[i] = drv;
      dhb[i] = dhv;
    }
  }
}

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

// device: CUDA ordinal; dtype: 0 = float32, 1 = bfloat16.  Strides and sizes are in elements.
// Returns a cudaError_t (0 = success).
extern "C" int gru_gate_rh_fwd(int device, int dtype, const void* r, long long sr,
                               const void* h, long long sh, void* out,
                               long long inner, long long total,
                               void* stream) {
  if (total <= 0 || inner <= 0 || total % inner || total / inner > 65535)
    return total == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rh_kernel<float><<<grid_for(inner, total / inner), 256, 0, st>>>(
        (const float*)r, sr, (const float*)h, sh, (float*)out, inner);
  } else if (dtype == 1) {
    rh_kernel<__nv_bfloat16><<<grid_for(inner, total / inner), 256, 0, st>>>(
        (const __nv_bfloat16*)r, sr, (const __nv_bfloat16*)h, sh,
        (__nv_bfloat16*)out, inner);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gru_gate_blend_fwd(int device, int dtype, const void* z, long long sz,
                                  const void* q, long long sq, const void* h,
                                  long long sh, void* out, long long inner,
                                  long long total, void* stream) {
  if (total <= 0 || inner <= 0 || total % inner || total / inner > 65535)
    return total == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    blend_kernel<float><<<grid_for(inner, total / inner), 256, 0, st>>>(
        (const float*)z, sz, (const float*)q, sq, (const float*)h, sh,
        (float*)out, inner);
  } else if (dtype == 1) {
    blend_kernel<__nv_bfloat16><<<grid_for(inner, total / inner), 256, 0, st>>>(
        (const __nv_bfloat16*)z, sz, (const __nv_bfloat16*)q, sq,
        (const __nv_bfloat16*)h, sh, (__nv_bfloat16*)out, inner);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// vec: values per access, 16 / element size (the vector path; every
// address, batch stride and `inner` must then be a multiple of 16 bytes)
// or 1; grid: blocks (one wave, or fewer).  The wrapper picks both.
extern "C" int gru_gate_rh_bwd(int device, int dtype, const void* r, long long sr,
                               const void* h, long long sh, const void* g,
                               long long sg, void* dr, void* dh,
                               long long inner, long long total, int vec,
                               int grid, void* stream) {
  if (total <= 0 || inner <= 0 || total % inner || grid < 1)
    return total == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long es = dtype == 0 ? 4 : 2;
  if (vec != 1) {
    const unsigned long long a =
        reinterpret_cast<unsigned long long>(r) |
        reinterpret_cast<unsigned long long>(h) |
        reinterpret_cast<unsigned long long>(g) |
        reinterpret_cast<unsigned long long>(dr) |
        reinterpret_cast<unsigned long long>(dh) |
        (unsigned long long)((sr | sh | sg | inner) * es);
    if (vec * es != 16 || a % 16) return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define RH_BWD(T, VE)                                                      \
  rh_bwd_kernel<T, VE><<<grid, RH_THREADS, 0, st>>>(                       \
      (const T*)r, sr, (const T*)h, sh, (const T*)g, sg, (T*)dr, (T*)dh,   \
      inner, total / inner)
  if (dtype == 0) {
    if (vec == 1) RH_BWD(float, 1);
    else RH_BWD(float, 4);
  } else {
    if (vec == 1) RH_BWD(__nv_bfloat16, 1);
    else RH_BWD(__nv_bfloat16, 8);
  }
#undef RH_BWD
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
