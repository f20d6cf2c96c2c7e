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
// Design of the forward.  The TPU kernel holds a whole sample in VMEM and
// broadcasts the flow over 64 lanes so that every tap is a static slice;
// here one thread per (sample, low-res pixel) loops over its 64
// subpixels, so for every (tap, subpixel) channel a warp reads 32
// consecutive pixels of the NCHW mask (coalesced), the 3x3 flow window
// lives in registers, and the ground truth is read at full resolution
// directly (the TPU's space-to-depth layout is not needed).  Each thread
// sums its 64 subpixels, the block reduces with a fixed shuffle tree and
// then its warps in order, and writes one partial per block; a second
// kernel adds each sample's partials in block order.  No atomics, so the
// sums are the same run to run.
//
// Design of the backward (`ul_bwd_kernel`, redesigned for Hopper).  What
// held the one-thread-per-pixel version at half its bound: for every
// subpixel a warp read the ground truth at 32 addresses 64 bytes apart
// and the valid mask 32 bytes apart, and a bf16 lane moved 2 bytes per
// access.  A redesign also meets stores that begin or end inside a
// 32-byte sector: channel planes lie H*W*es bytes apart (11,408 B at the
// chairs grid in fp32, 5,704 B in bf16, 2 B aligned at an odd H*W in
// bf16), so a block's rows start anywhere in a sector, and sectors that
// two blocks' stores share cost time in fp32 (lookup_ab.py's probe
// `unaligned`, PERF.md).  Now:
//   - a block of BP + 32 threads owns a run of BP = 128 consecutive
//     low-res pixels of one sample (flat indices, so a run may wrap to
//     the next row), one thread per pixel for all 64 subpixels: the 3x3
//     flow window and the 18 window sums stay in its registers, no
//     reduction between threads;
//   - it walks 16 chunks (a subpixel row p, four columns q): a chunk's
//     36 mask rows, and under each pixel the 4 ground-truth pairs and 4
//     valid values of full-resolution row 8h + p (one 32-byte and one
//     16-byte piece a pixel), are copied into shared memory with
//     cp.async, two chunks in flight while one is computed and the one
//     before is stored: every byte of the ground truth is read once a
//     block, in whole sectors;
//   - a staged row is the 16-byte-aligned span around its pixels, so
//     every copy in is 16 bytes whatever the plane's alignment (pixel
//     pix0 sits at its address mod 16 into the row; a span's bytes
//     beyond the tensor lie in the same 16-byte-aligned allocation);
//   - the threads compute the softmax (2^x on the special-function unit,
//     a correctly rounded reciprocal) and dmask in place, and the block
//     stores, in each plane, its pixels from the first 32-byte boundary
//     of the run to that of the next: whole sectors only.  To have them,
//     it also computes a halo of 32 / es pixels past its run (the extra
//     warp), whose values stand in for the next run's first ones; the
//     next run skips them.  dmask is allocated at the mask's address mod
//     16 (the wrapper), so a row's stores read it 16 bytes at a time;
//   - the blocks of one sample's runs are neighbours in launch order, and
//     the G folded iterations that share a ground-truth sample follow
//     each other, so the ground truth is found in L2;
//   - the window sums go to a scratch (gB, 9, 2, H, W); a second kernel
//     (`ul_dflow_kernel`) gathers dflow at each low-res pixel from the
//     nine neighbours whose windows hold it (race-free; the TPU kernel
//     scatters into a VMEM scratch).  No atomics, and every sum has a
//     fixed order: the same results run to run.
// Access width.  Inside a plane every access is 16 bytes.  A plane's
// first and last 32-byte granules are shared with the neighbouring
// planes: the first and last runs store the pieces up to the first and
// from the last 16-byte boundary VB bytes at a time, VB being the widest
// of 16, 8, 4 and 2 that divides the mask's and dmask's addresses and the
// plane stride (the wrapper picks it; a template argument here):
//   VB = 16: fp32, H*W % 4 == 0; bf16, H*W % 8 == 0;
//   VB = 8:  fp32, H*W % 4 == 2; bf16, H*W % 8 == 4 (the chairs grid);
//   VB = 4:  fp32, odd H*W; bf16, H*W % 4 == 2;
//   VB = 2:  bf16, odd H*W;
// and a mask that starts off those boundaries takes the narrower width.

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

// ---- backward ----
#define BP 128             // low-res pixels a block owns (its run)
#define CQ 4               // subpixel columns of a chunk (a multiple of 4)
#define NCH (64 / CQ)      // chunks of a run
#define AHEAD 2            // chunks loading while one is computed
#define NSTAGE (AHEAD + 2)  // + the chunk computed + the chunk stored
#define GRAN 32            // bytes: a block stores whole granules
#define BWD_THREADS (BP + 32)  // a thread per pixel, and a halo warp

// Pixels a block computes: its run and one granule's worth beyond it.
template <typename T>
struct Bpc {
  static constexpr int value = BP + GRAN / (int)sizeof(T);
};

// One chunk (subpixel row p, columns q0 .. q0 + CQ - 1) in shared memory.
// A staged row holds the 16-byte-aligned span around the pixels it
// needs: pixel pix0 sits `skew` (its address mod 16) bytes in.
template <typename T>
struct __align__(16) BwdStage {
  static constexpr int RB = Bpc<T>::value * (int)sizeof(T) + 16;
  unsigned char m[9 * CQ * RB];  // row k * CQ + qq: the mask, then dmask
  float g[Bpc<T>::value * CQ * 2];  // ground truth (x, y), pixel j, column qq
  float v[Bpc<T>::value * CQ];      // valid mask of pixel j, column qq
};

template <int VB> struct Piece;  // an unsigned type of VB bytes
template <> struct Piece<16> { using type = uint4; };
template <> struct Piece<8> { using type = uint2; };
template <> struct Piece<4> { using type = unsigned; };
template <> struct Piece<2> { using type = unsigned short; };

// 16 bytes from global to shared memory with cp.async, past L1, with L2
// fetching whole 128-byte lines (a staged row covers parts of its first
// and last).
__device__ __forceinline__ void copy_in(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

template <int VB>
__device__ __forceinline__ void copy_out(void* dst, const void* src) {
  using P = typename Piece<VB>::type;
  *static_cast<P*>(dst) = *static_cast<const P*>(src);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x on the special-function unit (relative error ~2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Block -> (b, g, run), run fastest; sample n = g * B + b.  VB: bytes
// per store at a plane's first and last granule (the file's note).
template <typename T, int VB>
__global__ void __launch_bounds__(BWD_THREADS)
ul_bwd_kernel(const float* __restrict__ flow, const T* __restrict__ mask,
              const float* __restrict__ gt, const float* __restrict__ vm,
              const float* __restrict__ gl1, int G, int B, int H, int W,
              T* __restrict__ dmask, float* __restrict__ scratch) {
  constexpr int es = (int)sizeof(T);
  constexpr int BPC = Bpc<T>::value;
  constexpr int RB = BwdStage<T>::RB;
  constexpr int NPR = RB / 16;                   // 16-byte copies a row
  constexpr int NP16 = (BP * es + GRAN) / 16;    // 16-byte stores a row
  constexpr int NE = 16 / VB;                    // VB stores an edge
  constexpr int SLOTS = NP16 + 2 * NE;
  extern __shared__ __align__(16) unsigned char smem[];
  BwdStage<T>* stages = reinterpret_cast<BwdStage<T>*>(smem);
  const int HW = H * W, nrun = (HW + BP - 1) / BP;
  const int run = blockIdx.x % nrun, g = (blockIdx.x / nrun) % G;
  const int b = blockIdx.x / (G * nrun);
  const int n = g * B + b, pix0 = run * BP;
  const int lc = min(BPC, HW - pix0);  // pixels computed
  const int j = threadIdx.x;
  const T* mk = mask + (long long)n * 576 * HW + pix0;
  T* dk = dmask + (long long)n * 576 * HW;
  const float* gtb = gt + (long long)b * 64 * HW * 2;
  const float* vmb = vm + (long long)b * 64 * HW;
  const int W8 = 8 * W;
  // ground-truth row 8h of the pixel this thread copies (if j < lc)
  const long long grow = (long long)((pix0 + j) / W) * 8 * W8 +
                         8 * ((pix0 + j) % W);
  // the address of pixel pix0 in plane c, mod 32 (the mask's and dmask's
  // agree mod 16: the wrapper allocates dmask so)
  const unsigned mbase = (unsigned)reinterpret_cast<size_t>(mk);
  const unsigned dbase = (unsigned)reinterpret_cast<size_t>(dk + pix0);
  auto skew = [&](int c) { return (int)((mbase + c * HW * es) & 15u); };
  // a run away from the plane's ends: no cap, no shared edge granules
  const bool inner = run > 0 && pix0 + BPC <= HW;

  auto issue = [&](int ch) {
    BwdStage<T>& st = stages[ch % NSTAGE];
    const int p = ch / (8 / CQ), q0 = ch % (8 / CQ) * CQ;
    for (int i = j; i < 9 * CQ * NPR; i += BWD_THREADS) {
      const int row = i / NPR, t = i % NPR;
      const int c = (row / CQ) * 64 + p * 8 + q0 + row % CQ;
      const char* a = reinterpret_cast<const char*>(mk + (long long)c * HW);
      const char* a16 = a - (reinterpret_cast<size_t>(a) & 15);
      // every 16 bytes holding one of the row's values (they lie inside
      // the allocation, whose ends are 16-byte aligned)
      if (a16 + 16 * t < a + lc * es)
        copy_in(st.m + row * RB + 16 * t, a16 + 16 * t);
    }
    if (j < lc) {  // CQ (x, y) pairs and CQ valid values: 16-byte pieces
      const long long gi = grow + (long long)p * W8 + q0;
#pragma unroll
      for (int u = 0; u < 2 * CQ; u += 4)
        copy_in(st.g + j * CQ * 2 + u, gtb + gi * 2 + u);
#pragma unroll
      for (int u = 0; u < CQ; u += 4)
        copy_in(st.v + j * CQ + u, vmb + gi + u);
    }
    cp_async_commit();
  };
  // A block stores, in each plane, the pixels from its run's first granule
  // boundary to the next run's: whole granules, the halo's values standing
  // in for the next run's first ones.  The plane's first and last granules
  // are shared with the neighbouring planes: their VB-byte pieces up to
  // the first and from the last 16-byte boundary are stored apart.
  auto store = [&](int ch) {
    const BwdStage<T>& st = stages[ch % NSTAGE];
    const int p = ch / (8 / CQ), q0 = ch % (8 / CQ) * CQ;
    if (inner) {  // BP values a row from its first granule boundary on
      constexpr int NPP = BP * es / 16;
      for (int i = j; i < 9 * CQ * NPP; i += BWD_THREADS) {
        const int row = i / NPP, t = i % NPP;
        const int c = (row / CQ) * 64 + p * 8 + q0 + row % CQ;
        const unsigned r = (dbase + c * HW * es) % GRAN;
        const unsigned lead = (0u - r) % GRAN;  // bytes to the boundary
        copy_out<16>(
            dk + (long long)c * HW + pix0 + (lead / es + t * (16 / es)),
            st.m + row * RB + (r & 15u) + lead + 16 * t);
      }
      return;
    }
    for (int i = j; i < 9 * CQ * SLOTS; i += BWD_THREADS) {
      const int row = i / SLOTS, t = i % SLOTS;
      const int c = (row / CQ) * 64 + p * 8 + q0 + row % CQ;
      T* plane = dk + (long long)c * HW;
      const unsigned pa = (unsigned)reinterpret_cast<size_t>(plane);
      const int lead = (int)((0u - pa) % GRAN) / es;
      const int ws = run == 0 ? 0 : pix0 + lead;
      const int we = run == nrun - 1 ? HW : min(HW, pix0 + BP + lead);
      // [a, b): the 16-byte-aligned middle of [ws, we)
      const int a = min(we, ws + (int)((0u - pa - ws * es) % 16u) / es);
      const int bb = max(a, we - (int)((pa + we * es) % 16u) / es);
      const int r0 = row * RB + skew(c) - pix0 * es;  // + x * es: pixel x
      int x, w;
      if (t < NP16) {
        x = a + t * (16 / es);
        w = x < bb ? 16 : 0;
      } else if (t < NP16 + NE) {
        x = ws + (t - NP16) * (VB / es);
        w = x < a ? VB : 0;
      } else {
        x = bb + (t - NP16 - NE) * (VB / es);
        w = x < we ? VB : 0;
      }
      if (w == 16)
        copy_out<16>(plane + x, st.m + r0 + x * es);
      else if (w)
        copy_out<VB>(plane + x, st.m + r0 + x * es);
    }
  };

  const bool act = j < lc;
  float fx[9], fy[9], sx[9], sy[9];
  if (act)
    flow_window(flow + (long long)n * HW * 2, (pix0 + j) / W, (pix0 + j) % W,
                H, W, fx, fy);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (!act) fx[k] = fy[k] = 0.0f;
    sx[k] = sy[k] = 0.0f;
  }
  const float dl1 = gl1[n];
  constexpr float L2E = 1.4426950408889634f;  // log2(e)
#pragma unroll
  for (int ch = 0; ch < AHEAD; ++ch) issue(ch);
  for (int ch = 0; ch < NCH; ++ch) {
    cp_async_wait<AHEAD - 1>();  // chunk ch has landed (this thread's)
    __syncthreads();  // ... everyone's, and chunk ch - 1 is computed
    if (ch > 0) store(ch - 1);  // its stores drain while ch is computed
    if (ch + AHEAD < NCH)
      issue(ch + AHEAD);  // into the stage chunk ch - 2 was stored from
    else
      cp_async_commit();  // an empty group keeps the count of the wait
    BwdStage<T>& st = stages[ch % NSTAGE];
    const int p = ch / (8 / CQ), q0 = ch % (8 / CQ) * CQ;
    if (act) {
      float gq[2 * CQ], vq[CQ];
#pragma unroll
      for (int c = 0; c < 2 * CQ; c += 4)
        *reinterpret_cast<float4*>(gq + c) =
            *reinterpret_cast<const float4*>(st.g + j * CQ * 2 + c);
      if constexpr (CQ % 4 == 0) {
#pragma unroll
        for (int c = 0; c < CQ; c += 4)
          *reinterpret_cast<float4*>(vq + c) =
              *reinterpret_cast<const float4*>(st.v + j * CQ + c);
      } else {
#pragma unroll
        for (int c = 0; c < CQ; ++c) vq[c] = st.v[j * CQ + c];
      }
#pragma unroll
      for (int qq = 0; qq < CQ; ++qq) {
        // tap k of pixel j at m[k * CQ * RB / es] (the skew is the same
        // for the nine taps: their planes lie 64 * H*W values apart)
        T* m = reinterpret_cast<T*>(st.m + qq * RB +
                                    skew(p * 8 + q0 + qq)) + j;
        // softmax over the nine taps, as 2^((m_k - max) log2 e)
        float e[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) e[k] = to_f(m[k * CQ * RB / es]);
        float gmax = e[0];
#pragma unroll
        for (int k = 1; k < 9; ++k) gmax = fmaxf(gmax, e[k]);
        const float ms = gmax * L2E;
#pragma unroll
        for (int k = 0; k < 9; ++k) e[k] = ex2(fmaf(e[k], L2E, -ms));
        float denom = e[0];
#pragma unroll
        for (int k = 1; k < 9; ++k) denom += e[k];
        const float inv = __frcp_rn(denom);
        float accx = 0.0f, accy = 0.0f;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          accx += e[k] * fx[k];
          accy += e[k] * fy[k];
        }
        const float outx = accx * inv, outy = accy * inv;
        // d|d|/dd is +1 at exactly 0 (jnp.abs's VJP), not sign(0) = 0
        const float gx =
            vq[qq] * (outx >= gq[2 * qq] ? 1.0f : -1.0f) * dl1;
        const float gy =
            vq[qq] * (outy >= gq[2 * qq + 1] ? 1.0f : -1.0f) * dl1;
        // dmask_k = w_k (g . f_k - g . out), w_k = e_k * inv
        const float ax = gx * inv, ay = gy * inv;
        const float c0 = (gx * outx + gy * outy) * inv;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          m[k * CQ * RB / es] =
              from_f<T>(e[k] * fmaf(ay, fy[k], fmaf(ax, fx[k], -c0)));
          sx[k] = fmaf(e[k], ax, sx[k]);
          sy[k] = fmaf(e[k], ay, sy[k]);
        }
      }
    }
  }
  __syncthreads();
  store(NCH - 1);
  // the run's window sums, one thread per pixel (the halo's are its
  // neighbour's)
  if (j < BP && pix0 + j < HW) {
    float* sc = scratch + (long long)n * 18 * HW + pix0 + j;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      sc[(long long)(2 * k) * HW] = sx[k];
      sc[(long long)(2 * k + 1) * HW] = sy[k];
    }
  }
}

template <typename T, int VB>
static cudaError_t launch_ul_bwd(unsigned blocks, cudaStream_t st,
                                 const float* f, const void* mask,
                                 const float* g, const float* v,
                                 const float* d, int G, int B, int H, int W,
                                 void* dmask, float* sc) {
  const int smem = NSTAGE * (int)sizeof(BwdStage<T>);
  cudaError_t err = cudaFuncSetAttribute(
      ul_bwd_kernel<T, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ul_bwd_kernel<T, VB><<<blocks, BWD_THREADS, smem, st>>>(
      f, reinterpret_cast<const T*>(mask), g, v, d, G, B, H, W,
      reinterpret_cast<T*>(dmask), sc);
  return cudaGetLastError();
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
// vec_bytes: the access width of the mask copies (the file's note); it
// must divide both mask addresses and H * W * element size.
extern "C" int upsample_loss_bwd(int device, int mask_dtype, int vec_bytes,
                                 const void* flow, const void* mask,
                                 const void* gt, const void* vm,
                                 const void* gl1, int gB, int B, int H, int W,
                                 void* dmask, void* scratch, void* dflow,
                                 void* stream) {
  if (gB < 1 || B < 1 || gB % B || H < 1 || W < 1 || mask_dtype < 0 ||
      mask_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const long long es = mask_dtype == 0 ? 4 : 2;
  const unsigned long long align =
      reinterpret_cast<unsigned long long>(mask) |
      reinterpret_cast<unsigned long long>(dmask) |
      (unsigned long long)((long long)H * W * es);
  if ((vec_bytes != 16 && vec_bytes != 8 && vec_bytes != 4 &&
       vec_bytes != 2) || vec_bytes < es || align % vec_bytes ||
      (reinterpret_cast<unsigned long long>(gt) |
       reinterpret_cast<unsigned long long>(vm)) % 16 ||
      (reinterpret_cast<unsigned long long>(mask) -
       reinterpret_cast<unsigned long long>(dmask)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = gB / B, nrun = (H * W + BP - 1) / BP;
  const long long blocks = (long long)gB * nrun;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* f = reinterpret_cast<const float*>(flow);
  const float* g = reinterpret_cast<const float*>(gt);
  const float* v = reinterpret_cast<const float*>(vm);
  const float* d = reinterpret_cast<const float*>(gl1);
  float* sc = reinterpret_cast<float*>(scratch);
#define UL_BWD(T, VB)                                             \
  err = launch_ul_bwd<T, VB>((unsigned)blocks, st, f, mask, g, v, d, G, B, \
                             H, W, dmask, sc)
  if (mask_dtype == 0) {
    if (vec_bytes == 16) UL_BWD(float, 16);
    else if (vec_bytes == 8) UL_BWD(float, 8);
    else UL_BWD(float, 4);
  } else {
    if (vec_bytes == 16) UL_BWD(__nv_bfloat16, 16);
    else if (vec_bytes == 8) UL_BWD(__nv_bfloat16, 8);
    else if (vec_bytes == 4) UL_BWD(__nv_bfloat16, 4);
    else UL_BWD(__nv_bfloat16, 2);
  }
#undef UL_BWD
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H * W + THREADS - 1) / THREADS, gB);
  ul_dflow_kernel<<<grid, THREADS, 0, st>>>(sc, H, W,
                                            reinterpret_cast<float*>(dflow));
  return (int)cudaGetLastError();
}
