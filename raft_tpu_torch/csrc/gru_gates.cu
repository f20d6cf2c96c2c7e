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

template <typename T>
__global__ void rh_bwd_kernel(const T* __restrict__ r, long long sr,
                              const T* __restrict__ h, long long sh,
                              const T* __restrict__ g, long long sg,
                              T* __restrict__ dr, T* __restrict__ dh,
                              long long inner) {
  const long long b = blockIdx.y;
  r += b * sr;
  h += b * sh;
  g += b * sg;
  dr += b * inner;
  dh += b * inner;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < inner; i += (long long)gridDim.x * blockDim.x) {
    const float s = sigmoid_f32(load(r + i));
    const float gi = load(g + i);
    store(dr + i, gi * load(h + i) * s * (1.0f - s));
    store(dh + i, gi * s);
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

extern "C" int gru_gate_rh_bwd(int device, int dtype, const void* r, long long sr,
                               const void* h, long long sh, const void* g,
                               long long sg, void* dr, void* dh,
                               long long inner, long long total,
                               void* stream) {
  if (total <= 0 || inner <= 0 || total % inner || total / inner > 65535)
    return total == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(inner, total / inner);
  if (dtype == 0) {
    rh_bwd_kernel<float><<<grid, 256, 0, st>>>(
        (const float*)r, sr, (const float*)h, sh, (const float*)g, sg,
        (float*)dr, (float*)dh, inner);
  } else if (dtype == 1) {
    rh_bwd_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        (const __nv_bfloat16*)r, sr, (const __nv_bfloat16*)h, sh,
        (const __nv_bfloat16*)g, sg, (__nv_bfloat16*)dr, (__nv_bfloat16*)dh,
        inner);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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
