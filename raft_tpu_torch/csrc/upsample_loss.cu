// Fused convex 8x upsample + masked sequence-loss sums, forward and
// backward, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels `_upsample_loss_fwd_kernel` and
// `_upsample_loss_bwd_kernel` in raft_tpu/ops/pallas_upsample.py, reached
// through `pallas_upsample_loss_sums` (its custom_vjp `_core_fwd` /
// `_core_bwd`).
//
// Function.  Sample n of gB = g * B (iterations folded batch-major, so its
// ground truth is sample b = n % B) has a 1/8-resolution flow (H, W, 2)
// and mask logits (576, H, W), channel k*64 + p*8 + q for 3x3 tap k
// (unfold order) and subpixel (p, q).  For full-resolution pixel
// (8h+p, 8w+q): a softmax over the nine k (max subtracted per group)
// weighs the nine neighbours of 8 * flow zero-padded by one; against the
// fp32 ground truth (dx, dy) and valid mask v it contributes
// [v(|dx|+|dy|), v*epe, v(epe<1), v(epe<3), v(epe<5)], epe = |(dx, dy)|,
// to sample n's five sums.  The backward takes the cotangent of the l1
// sum only (the other four are metrics), with the |.| subgradient +1 at
// exactly 0 as in the JAX package, and gives dmask (in the mask's dtype)
// and dflow; the ground truth and valid mask are data.  All arithmetic is
// fp32, whatever the mask's dtype.
//
// What bounds it on an H100.  The mask is the one large input: at the
// chairs training shape (12 iterations x B = 8 folded, 46 x 62) it is
// 630 MB fp32 (315 MB bf16) read by the forward, and read plus written
// (as dmask) by the backward; ~0.19 ms and ~0.38 ms at 3.35 TB/s in fp32.
// The arithmetic is about 100 (forward) and 170 (backward) fp32 ops per
// full-resolution pixel, 1.8 and 3.0 GFLOP: 27 and 45 us at 67 TFLOP/s.
// So both are bound by bytes.
//
// Design.  The TPU kernel holds a whole sample in VMEM and broadcasts the
// flow over 64 lanes so that every tap is a static slice; here:
//   - one thread per (sample, low-res pixel), looping over its 64
//     subpixels, so for every (tap, subpixel) channel a warp reads 32
//     consecutive pixels of the NCHW mask (coalesced), the 3x3 flow
//     window lives in registers, and the ground truth is read at full
//     resolution directly (the TPU's space-to-depth layout is not needed);
//   - forward: each thread sums its 64 subpixels, the block reduces with
//     a fixed shuffle tree and then its warps in order, and writes one
//     partial per block; a second kernel adds each sample's partials in
//     block order.  No atomics, so the sums are the same run to run;
//   - backward: the thread recomputes the softmax, writes its 576 dmask
//     values (coalesced) and, per tap, the sum over its subpixels of
//     w_k * (gx, gy) into a small scratch (gB, 9, 2, H, W); a second
//     kernel gathers dflow at each low-res pixel from the nine neighbours
//     whose windows contain it (race-free; the TPU kernel scatters into
//     a VMEM scratch instead).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define THREADS 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// The 3x3 window of 8 * flow around (h, w), zero outside the grid.
__device__ __forceinline__ void flow_window(const float* __restrict__ fl,
                                            int h, int w, int H, int W,
                                            float* fx, float* fy) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int hh = h + k / 3 - 1, ww = w + k % 3 - 1;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
    fx[k] = in ? 8.0f * fl[(hh * W + ww) * 2 + 0] : 0.0f;
    fy[k] = in ? 8.0f * fl[(hh * W + ww) * 2 + 1] : 0.0f;
  }
}

// Softmax weights of one subpixel group: e[k] = exp(m_k - max), and
// 1 / sum(e), with the TPU kernel's operation order.
template <typename T>
__device__ __forceinline__ float softmax9(const T* __restrict__ m,
                                          long long stride, float* e) {
  float v[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = to_f(m[k * 64 * stride]);
  float gmax = v[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) gmax = fmaxf(gmax, v[k]);
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = expf(v[k] - gmax);
  float denom = e[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) denom += e[k];
  return 1.0f / denom;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ul_fwd_kernel(const float* __restrict__ flow, const T* __restrict__ mask,
              const float* __restrict__ gt, const float* __restrict__ vm,
              int B, int H, int W, float* __restrict__ partial) {
  const int n = blockIdx.y;
  const int HW = H * W;
  const int pix = blockIdx.x * THREADS + threadIdx.x;
  float s[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (pix < HW) {
    const int h = pix / W, w = pix % W, b = n % B;
    const int W8 = 8 * W;
    float fx[9], fy[9], e[9];
    flow_window(flow + (long long)n * HW * 2, h, w, H, W, fx, fy);
    const T* m = mask + (long long)n * 576 * HW + pix;
    const float* gtb = gt + (long long)b * 64 * HW * 2;
    const float* vmb = vm + (long long)b * 64 * HW;
    for (int p = 0; p < 8; ++p) {
      for (int q = 0; q < 8; ++q) {
        const int pq = p * 8 + q;
        const float inv = softmax9(m + (long long)pq * HW, HW, e);
        float accx = 0.0f, accy = 0.0f;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          accx += e[k] * fx[k];
          accy += e[k] * fy[k];
        }
        const long long gi = (long long)(8 * h + p) * W8 + 8 * w + q;
        const float dx = accx * inv - gtb[gi * 2 + 0];
        const float dy = accy * inv - gtb[gi * 2 + 1];
        const float v = vmb[gi];
        const float epe = sqrtf(dx * dx + dy * dy);
        s[0] += v * (fabsf(dx) + fabsf(dy));
        s[1] += v * epe;
        s[2] += v * (epe < 1.0f ? 1.0f : 0.0f);
        s[3] += v * (epe < 3.0f ? 1.0f : 0.0f);
        s[4] += v * (epe < 5.0f ? 1.0f : 0.0f);
      }
    }
  }
  // Fixed-order block reduction: a shuffle tree per warp, then the warps
  // in order.
  __shared__ float red[THREADS / 32][5];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    float x = s[c];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][c] = x;
  }
  __syncthreads();
  if (threadIdx.x < 5) {
    float t = 0.0f;
    for (int i = 0; i < THREADS / 32; ++i) t += red[i][threadIdx.x];
    partial[((long long)n * gridDim.x + blockIdx.x) * 5 + threadIdx.x] = t;
  }
}

// sums[n, c] = the block partials of sample n, added in block order.
__global__ void ul_reduce_kernel(const float* __restrict__ partial,
                                 int nblk, int gB, float* __restrict__ sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= gB * 5) return;
  const int n = i / 5, c = i % 5;
  float t = 0.0f;
  for (int j = 0; j < nblk; ++j) t += partial[((long long)n * nblk + j) * 5 + c];
  sums[i] = t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ul_bwd_kernel(const float* __restrict__ flow, const T* __restrict__ mask,
              const float* __restrict__ gt, const float* __restrict__ vm,
              const float* __restrict__ gl1, int B, int H, int W,
              T* __restrict__ dmask, float* __restrict__ scratch) {
  const int n = blockIdx.y;
  const int HW = H * W;
  const int pix = blockIdx.x * THREADS + threadIdx.x;
  if (pix >= HW) return;
  const int h = pix / W, w = pix % W, b = n % B;
  const int W8 = 8 * W;
  const float dl1 = gl1[n];
  float fx[9], fy[9], e[9], sx[9], sy[9];
  flow_window(flow + (long long)n * HW * 2, h, w, H, W, fx, fy);
#pragma unroll
  for (int k = 0; k < 9; ++k) sx[k] = sy[k] = 0.0f;
  const T* m = mask + (long long)n * 576 * HW + pix;
  T* dm = dmask + (long long)n * 576 * HW + pix;
  const float* gtb = gt + (long long)b * 64 * HW * 2;
  const float* vmb = vm + (long long)b * 64 * HW;
  for (int p = 0; p < 8; ++p) {
    for (int q = 0; q < 8; ++q) {
      const int pq = p * 8 + q;
      const float inv = softmax9(m + (long long)pq * HW, HW, e);
      float accx = 0.0f, accy = 0.0f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        accx += e[k] * fx[k];
        accy += e[k] * fy[k];
      }
      const float outx = accx * inv, outy = accy * inv;
      const long long gi = (long long)(8 * h + p) * W8 + 8 * w + q;
      const float v = vmb[gi];
      // d|d|/dd is +1 at exactly 0 (jnp.abs's VJP), not sign(0) = 0
      const float gx = v * (outx >= gtb[gi * 2 + 0] ? 1.0f : -1.0f) * dl1;
      const float gy = v * (outy >= gtb[gi * 2 + 1] ? 1.0f : -1.0f) * dl1;
      const float gout = gx * outx + gy * outy;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float wk = e[k] * inv;
        const float ghat = gx * fx[k] + gy * fy[k];
        dm[(long long)(k * 64 + pq) * HW] = from_f<T>(wk * (ghat - gout));
        sx[k] += wk * gx;
        sy[k] += wk * gy;
      }
    }
  }
  float* sc = scratch + (long long)n * 18 * HW + pix;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    sc[(long long)(2 * k) * HW] = sx[k];
    sc[(long long)(2 * k + 1) * HW] = sy[k];
  }
}

// dflow[n, h', w'] = 8 * sum over the taps k = (di, dj) of the window
// sums at (h' - di + 1, w' - dj + 1): the flow at (h', w') is tap k of
// that pixel's 3x3 window.
__global__ void __launch_bounds__(THREADS)
ul_dflow_kernel(const float* __restrict__ scratch, int H, int W,
                float* __restrict__ dflow) {
  const int n = blockIdx.y;
  const int HW = H * W;
  const int pix = blockIdx.x * THREADS + threadIdx.x;
  if (pix >= HW) return;
  const int h = pix / W, w = pix % W;
  const float* sc = scratch + (long long)n * 18 * HW;
  float ax = 0.0f, ay = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int hh = h - k / 3 + 1, ww = w - k % 3 + 1;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
    ax += sc[(long long)(2 * k) * HW + hh * W + ww];
    ay += sc[(long long)(2 * k + 1) * HW + hh * W + ww];
  }
  dflow[((long long)n * HW + pix) * 2 + 0] = 8.0f * ax;
  dflow[((long long)n * HW + pix) * 2 + 1] = 8.0f * ay;
}

// mask_dtype: 0 = float32, 1 = bfloat16.  `partial` holds
// gB * ceil(H*W / 256) * 5 floats.  Returns a cudaError_t (0 = success).
extern "C" int upsample_loss_fwd(int device, int mask_dtype, const void* flow,
                                 const void* mask, const void* gt,
                                 const void* vm, int gB, int B, int H, int W,
                                 void* partial, void* sums, void* stream) {
  if (gB < 1 || B < 1 || gB % B || H < 1 || W < 1 || mask_dtype < 0 ||
      mask_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nblk = (H * W + THREADS - 1) / THREADS;
  const dim3 grid(nblk, gB);
  const float* f = reinterpret_cast<const float*>(flow);
  const float* g = reinterpret_cast<const float*>(gt);
  const float* v = reinterpret_cast<const float*>(vm);
  float* part = reinterpret_cast<float*>(partial);
  if (mask_dtype == 0)
    ul_fwd_kernel<float><<<grid, THREADS, 0, st>>>(
        f, reinterpret_cast<const float*>(mask), g, v, B, H, W, part);
  else
    ul_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        f, reinterpret_cast<const __nv_bfloat16*>(mask), g, v, B, H, W,
        part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ul_reduce_kernel<<<(gB * 5 + 127) / 128, 128, 0, st>>>(
      part, nblk, gB, reinterpret_cast<float*>(sums));
  return (int)cudaGetLastError();
}

// `scratch` holds gB * 18 * H * W floats; dflow is (gB, H, W, 2) fp32.
extern "C" int upsample_loss_bwd(int device, int mask_dtype, const void* flow,
                                 const void* mask, const void* gt,
                                 const void* vm, const void* gl1, int gB,
                                 int B, int H, int W, void* dmask,
                                 void* scratch, void* dflow, void* stream) {
  if (gB < 1 || B < 1 || gB % B || H < 1 || W < 1 || mask_dtype < 0 ||
      mask_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((H * W + THREADS - 1) / THREADS, gB);
  const float* f = reinterpret_cast<const float*>(flow);
  const float* g = reinterpret_cast<const float*>(gt);
  const float* v = reinterpret_cast<const float*>(vm);
  const float* d = reinterpret_cast<const float*>(gl1);
  float* sc = reinterpret_cast<float*>(scratch);
  if (mask_dtype == 0)
    ul_bwd_kernel<float><<<grid, THREADS, 0, st>>>(
        f, reinterpret_cast<const float*>(mask), g, v, d, B, H, W,
        reinterpret_cast<float*>(dmask), sc);
  else
    ul_bwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        f, reinterpret_cast<const __nv_bfloat16*>(mask), g, v, d, B, H, W,
        reinterpret_cast<__nv_bfloat16*>(dmask), sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ul_dflow_kernel<<<grid, THREADS, 0, st>>>(sc, H, W,
                                            reinterpret_cast<float*>(dflow));
  return (int)cudaGetLastError();
}
