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
// Design of the forward (`ul_fwd_kernel`, redesigned for Hopper).  It
// replaces `_upsample_loss_fwd_kernel` (raft_tpu/ops/pallas_upsample.py,
// through `_core_fwd`).  What held the one-thread-per-pixel version at
// 61% (fp32) and 39% (bf16) of its bound, measured with lookup_ab.py's
// probes on it at the chairs shape (PERF.md): its ground-truth reads,
// 32 addresses 64 bytes apart a warp for every subpixel (without them
// 0.32 -> 0.23 ms fp32, 0.25 -> 0.17 bf16); not its accurate expf (2^x
// in its place: -2% / -3%).  And a probe of this kernel's reads alone
// showed what a redesign meets: a group's nine tap planes lie 64 planes
// apart, so the mask is read in short rows of many planes at once, and
// how fast depends on which rows the warps at work read together.  Now:
//   - a lane owns P consecutive flat pixels of one sample (P = 4, or 8
//     for a bf16 mask whose planes are 16-byte aligned); each of the nine
//     taps of a plane is one 16-byte (or 8-byte) load of its P values,
//     all nine issued before the first is used, past L1, asking L2 for
//     whole 256-byte blocks (`ld_stream`);
//   - a warp owns a tile of 32 groups (32 P pixels) and items of four
//     subpixel planes (a stage: row p, columns q0 .. q0 + 3) of one
//     sample; the warps of a tile split its items (b, stage, g) into
//     equal ranges, g fastest, and neighbouring warps hold neighbouring
//     tiles: the warps at work together read whole rows of the same
//     planes (neighbouring warps on one tile: 4% slower, probe
//     `same_tile`); persistent warps, as many as fit on the card at once
//     (the occupancy API), so no wave is left over;
//   - the ground truth and valid mask of a stage (32 and 16 bytes under
//     each pixel) are copied into the warp's shared memory with 16-byte
//     cp.async, consecutive lanes on neighbouring pixels, the next stage
//     while this one is used; the G folded iterations that share a
//     ground-truth sample are consecutive items, so each stage is read
//     once for all of them (a copy per item: a third slower in bf16,
//     probe `gt_per_item`); the reads from it are swizzled over the
//     banks;
//   - the 3x3 windows of the flow around the lane's P pixels live in
//     registers as three rows of P + 2 values (zero outside the sample);
//     where an image row ends inside the group, a 0/1 factor drops the
//     taps across it; the factor 8 goes into the reciprocal;
//   - the softmax is the backward's (`softmax9_ex2`: 2^x on the
//     special-function unit after a log2(e) scale, a correctly rounded
//     reciprocal), so both compute the same weights; the EPE takes the
//     approximate square root, and the 1/3/5 px tests compare its square
//     (dx^2 + dy^2 < 1, 9, 25), which gives the plain version's counts
//     except within an ulp of a threshold;
//   - each item's lane sums go through a fixed shuffle tree to one
//     partial; `ul_reduce_kernel` adds a sample's partials, a warp a
//     sample, in a fixed order.  No atomics: the same sums run to run (on
//     a given card, whose SM count sets the ranges).
//   Registers are sized for the most blocks an SM without spills: 3
//   (fp32), 4 (bf16, 4 pixels a lane in one or two pieces), 2 (the other
//   bf16 paths); keeping the next plane's loads in flight within a warp
//   was no faster than the other warps'.
// Access width.  A tap of P values is loaded in pieces of VB bytes, the
// widest of 16, 8, 4 and 2 that divides the mask's address and the plane
// stride H*W*es (the wrapper picks it; a template argument here); a
// group starts where its first piece is VB-aligned in every plane, and
// pieces outside the sample are not read:
//   VB = 16: fp32, H*W % 4 == 0 (the chairs, Sintel, things and KITTI
//            grids; P = 4); bf16, H*W % 8 == 0 (Sintel; P = 8);
//   VB = 8:  fp32, H*W % 4 == 2 (two pieces); bf16, H*W % 8 == 4 (the
//            chairs, things and KITTI grids; one piece);
//   VB = 4:  fp32, odd H*W (four pieces); bf16, H*W % 4 == 2 (two);
//   VB = 2:  bf16, odd H*W (four pieces);
// and a mask that starts off those boundaries takes the narrower width.
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

// The same, or 16 zero bytes when `ok` is false (nothing is read).
__device__ __forceinline__ void copy_in_or_zero(void* dst, const void* src,
                                                bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d),
      "l"(src), "r"(ok ? 16 : 0));
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

// Softmax of one subpixel group, in place: the nine logits in, e[k] =
// 2^((m_k - max) log2 e) out; returns 1 / sum(e), correctly rounded.
// The forward and the backward both take their weights from here.
__device__ __forceinline__ float softmax9_ex2(float (&e)[9]) {
  constexpr float L2E = 1.4426950408889634f;  // log2(e)
  float gmax = e[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) gmax = fmaxf(gmax, e[k]);
  const float ms = gmax * L2E;
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = ex2(fmaf(e[k], L2E, -ms));
  float denom = e[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) denom += e[k];
  return __frcp_rn(denom);
}

// ---- forward ----
#define FWD_WARPS 4  // warps a block (each on its own)
#define FWD_THREADS (32 * FWD_WARPS)

// The forward's shapes for a mask of T read VB bytes at a time.
template <typename T, int VB>
struct Fwd {
  static constexpr int es = (int)sizeof(T);
  static constexpr int P = VB == 16 ? 16 / es : 4;  // pixels a lane
  static constexpr int NX = 32 * P;                 // pixels a tile
  static constexpr int NPC = P * es / VB;           // pieces a tap
  static constexpr int NW = P * es / 4;             // 32-bit words a tap
  // a stage: ground truth (x, y) of columns q0, q0 + 1 and q0 + 2, q0 + 3
  // (two 16-byte chunks), and the valid mask of q0 .. q0 + 3 (one), under
  // each of the tile's pixels
  static constexpr int STAGE = 3 * NX * 16;
  // a warp's shared memory: two stages and the ground-truth offsets of
  // the tile's pixels
  static constexpr int SMEM = 2 * STAGE + NX * 4;
  // blocks an SM the registers are sized for: the most without spills
  static constexpr int MIN_BLOCKS = es == 4 ? 3 : P == 4 && NPC <= 2 ? 4 : 2;
};

// 16-byte chunk slot of tile pixel x: spreads the lanes' reads (pixels P
// apart) over the banks.
__device__ __forceinline__ int swz(int x) { return x ^ ((x >> 3) & 7); }

__device__ __forceinline__ void put_words(unsigned* w, uint4 x) {
  w[0] = x.x;
  w[1] = x.y;
  w[2] = x.z;
  w[3] = x.w;
}
__device__ __forceinline__ void put_words(unsigned* w, uint2 x) {
  w[0] = x.x;
  w[1] = x.y;
}
__device__ __forceinline__ void put_words(unsigned* w, unsigned x) {
  w[0] = x;
}

// A load past L1 that asks L2 for the whole 256-byte block around it
// (the lanes of a warp and its neighbours read the rest).
template <typename U> __device__ __forceinline__ U ld_stream(const U* p);
template <> __device__ __forceinline__ uint4 ld_stream<uint4>(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}
template <> __device__ __forceinline__ uint2 ld_stream<uint2>(const uint2* p) {
  uint2 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
      : "=r"(r.x), "=r"(r.y)
      : "l"(p));
  return r;
}
template <>
__device__ __forceinline__ unsigned ld_stream<unsigned>(const unsigned* p) {
  unsigned r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];"
      : "=r"(r)
      : "l"(p));
  return r;
}
template <>
__device__ __forceinline__ unsigned short ld_stream<unsigned short>(
    const unsigned short* p) {
  unsigned short r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.u16 %0, [%1];"
      : "=h"(r)
      : "l"(p));
  return r;
}

// The lane's P values of one tap plane as 32-bit words, VB bytes a load
// (`ld_stream`); a piece outside the sample (bit u of `valid` clear) is
// not read and holds zeros.
template <typename T, int VB>
__device__ __forceinline__ void load_tap(unsigned (&w)[Fwd<T, VB>::NW],
                                         const T* a, unsigned valid) {
  using F = Fwd<T, VB>;
  using U = typename Piece<VB>::type;
  const U* pa = reinterpret_cast<const U*>(a);
#pragma unroll
  for (int u = 0; u < F::NPC; ++u) {
    const U x = (valid >> u & 1u) ? ld_stream<U>(pa + u) : U{};
    if constexpr (VB >= 4) {
      put_words(w + u * (VB / 4), x);
    } else if (u & 1) {  // bf16 values two bytes a load
      w[u >> 1] |= (unsigned)x << 16;
    } else {
      w[u >> 1] = x;
    }
  }
}

// Value i of a lane's words.
template <typename T>
__device__ __forceinline__ float word_val(const unsigned* w, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[i]);
  } else {
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                   : (w[i >> 1] << 16));
  }
}

// sqrt on the special-function unit.
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Warp k of R = NT * RR owns tile kj = k % NT of 32 groups (lane l's
// group starts at pixel kj * NX + l * P - off) and the kr = k / NT-th of
// RR equal ranges of its items it = (b * 16 + s) * G + g: sample
// n = g * B + b, stage s (row p = s / 2, columns q0 = 4 (s % 2) ..
// q0 + 3: the planes 4 s .. 4 s + 3).  So the warps at work together read
// neighbouring tiles of the same planes (the mask in whole rows of its
// planes), and the G items of a stage share its staged ground truth.
// Item (kj, it) writes its 5 sums to partial[((b * G + g) * NT + kj) *
// 16 + s]: a sample's partials lie together.
template <typename T, int VB>
__global__ void __launch_bounds__(FWD_THREADS, Fwd<T, VB>::MIN_BLOCKS)
ul_fwd_kernel(const float* __restrict__ flow, const T* __restrict__ mask,
              const float* __restrict__ gt, const float* __restrict__ vm,
              int G, int B, int H, int W, int off, int NT, int RR,
              float* __restrict__ partial) {
  using F = Fwd<T, VB>;
  constexpr int P = F::P, NX = F::NX, NW = F::NW, NV = 3 * (P + 2);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * FWD_WARPS + (threadIdx.x >> 5);
  if (k >= NT * RR) return;
  unsigned char* stages = smem + (threadIdx.x >> 5) * F::SMEM;
  int* goff = reinterpret_cast<int*>(stages + 2 * F::STAGE);
  const int HW = H * W, W8 = 8 * W, kj = k % NT, kr = k / NT;
  const long long items = (long long)B * 16 * G;  // a tile's
  const long long i0 = kr * items / RR, i1 = (kr + 1) * items / RR;
  if (i0 >= i1) return;
  // the lane's first pixel; which of its pieces lie inside the sample (a
  // piece is wholly in or out: a plane's ends are VB-aligned); keep[i]:
  // pixel i is not the last of its image row (the taps across a row end
  // inside the group drop); which window values exist (inside the
  // sample, and at the group's ends not across the image's left or right
  // edge); the ground-truth offsets (floats, of row 8h and column 8w) of
  // the lane's pixels, -1 outside the sample
  const int x0 = kj * NX + lane * P - off;
  unsigned pvalid = 0;
#pragma unroll
  for (int u = 0; u < F::NPC; ++u) {
    const int x = x0 + u * (VB / F::es);
    pvalid |= (x >= 0 && x < HW) ? 1u << u : 0u;
  }
  float keep[P];
  unsigned vbits = 0;
  {
    int h = x0 >= 0 ? x0 / W : -((W - 1 - x0) / W);  // floor
    int c = x0 - h * W;
    const int c0 = c;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int x = x0 + i;
      goff[lane * P + i] = x >= 0 && x < HW ? (8 * h * W8 + 8 * c) * 2 : -1;
      keep[i] = c == W - 1 ? 0.0f : 1.0f;
      if (++c == W) {
        c = 0;
        ++h;
      }
    }
    const int cl = c == 0 ? W - 1 : c - 1;  // column of the last pixel
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int m = 0; m < P + 2; ++m) {
        const int f = x0 - 1 + m + (r - 1) * W;
        const bool in = f >= 0 && f < HW && !(m == 0 && c0 == 0) &&
                        !(m == P + 1 && cl == W - 1);
        vbits |= in ? 1u << (r * (P + 2) + m) : 0u;
      }
    }
  }
  __syncwarp();  // the table is complete
  // stage s of sample b (row p = s / 2, columns q0 = 4 (s % 2) ..) into
  // buffer sb: the (x, y) of columns q0 .. q0 + 3 (two 16-byte chunks)
  // and their valid mask (one) under each tile pixel, consecutive lanes
  // on neighbouring pixels
  auto issue = [&](int b, int s, int sb) {
    unsigned char* st = stages + sb * F::STAGE;
    const float* gtb = gt + (long long)b * 64 * HW * 2;
    const float* vmb = vm + (long long)b * 64 * HW;
    const long long rg = (long long)(s >> 1) * W8 * 2 + (s & 1) * 8;
    const long long rv = (long long)(s >> 1) * W8 + (s & 1) * 4;
#pragma unroll
    for (int u = 0; u < 2 * P; ++u) {  // (x, y) of 2 columns a chunk
      const int c = lane + 32 * u, x = c >> 1, h = c & 1;
      const int o = goff[x];
      copy_in_or_zero(st + (h * NX + swz(x)) * 16,
                      o >= 0 ? gtb + o + rg + h * 4 : gtb, o >= 0);
    }
#pragma unroll
    for (int u = 0; u < P; ++u) {  // 4 columns a chunk
      const int x = lane + 32 * u;
      const int o = goff[x];
      copy_in_or_zero(st + (2 * NX + swz(x)) * 16,
                      o >= 0 ? vmb + (o >> 1) + rv : vmb, o >= 0);
    }
    cp_async_commit();
  };
  // the nine tap planes c * 64 + pl of the lane's group, at m = the
  // group's first pixel in plane pl
  auto load9 = [&](unsigned (&w)[9][NW], const T* m) {
#pragma unroll
    for (int c = 0; c < 9; ++c)
      load_tap<T, VB>(w[c], m + (long long)c * 64 * HW, pvalid);
  };
  // plane 0 of item i: sample g * B + b, planes from 4 s
  auto plane0 = [&](long long i) {
    const int g = (int)(i % G), s = (int)(i / G % 16), b = (int)(i / G / 16);
    return mask + ((long long)(g * B + b) * 576 + 4 * s) * HW + x0;
  };
  unsigned wa[9][NW];
  load9(wa, plane0(i0));
  int sb = 0;
  issue((int)(i0 / G / 16), (int)(i0 / G % 16), sb);
  for (long long it = i0; it < i1; ++it) {
    const int g = (int)(it % G), s = (int)(it / G % 16);
    const int b = (int)(it / G / 16), n = g * B + b;
    if (it == i0 || g == 0) {
      // a new stage: flip to it (staged ahead) unless it is the first;
      // stage the next one into the other buffer, whose last reader (the
      // stage before) is done; then wait for this one
      if (it != i0) sb ^= 1;
      __syncwarp();
      const long long nx = (it / G + 1) * G;  // the next stage's first item
      if (nx < i1)
        issue((int)(nx / G / 16), (int)(nx / G % 16), sb ^ 1);
      else
        cp_async_commit();  // an empty group keeps the count of the wait
      cp_async_wait<1>();
      __syncwarp();  // every lane's copies of this stage have landed
    }
    const unsigned char* st = stages + sb * F::STAGE;
    // the 3 x 3 windows of the flow (its factor 8 goes into 1 / sum):
    // three rows of P + 2 values
    float vx[NV], vy[NV];
    {
      const float2* fl = reinterpret_cast<const float2*>(flow) +
                         (long long)n * HW + x0 - 1 - W;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int m = 0; m < P + 2; ++m) {
          const int v = r * (P + 2) + m;
          const float2 f2 = (vbits >> v & 1u) ? __ldg(fl + r * W + m)
                                              : make_float2(0.0f, 0.0f);
          vx[v] = f2.x;
          vy[v] = f2.y;
        }
      }
    }
    float s5[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    // plane qi of the stage for the lane's P pixels
    auto plane = [&](const unsigned (&w)[9][NW], int qi) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int x = swz(lane * P + i);
        const float2 gq = *reinterpret_cast<const float2*>(
            st + ((qi >> 1) * NX + x) * 16 + (qi & 1) * 8);
        const float v =
            *reinterpret_cast<const float*>(st + (2 * NX + x) * 16 + qi * 4);
        float e[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) e[c] = word_val<T>(w[c], i);
        const float inv8 = 8.0f * softmax9_ex2(e);
        // the convex combination, by window column (taps k = 3 r + c):
        // the middle one, then the left one, dropped across a row end
        // before the pixel, and the right one, across a row end after it
        float cx[3], cy[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          cx[c] = e[c] * vx[i + c];
          cy[c] = e[c] * vy[i + c];
#pragma unroll
          for (int r = 1; r < 3; ++r) {
            cx[c] = fmaf(e[3 * r + c], vx[r * (P + 2) + i + c], cx[c]);
            cy[c] = fmaf(e[3 * r + c], vy[r * (P + 2) + i + c], cy[c]);
          }
        }
        const float kl = i > 0 ? keep[i > 0 ? i - 1 : 0] : 1.0f;
        const float kr = i < P - 1 ? keep[i] : 1.0f;
        const float ax = fmaf(kr, cx[2], fmaf(kl, cx[0], cx[1]));
        const float ay = fmaf(kr, cy[2], fmaf(kl, cy[0], cy[1]));
        const float dx = fmaf(ax, inv8, -gq.x);
        const float dy = fmaf(ay, inv8, -gq.y);
        const float d2 = fmaf(dx, dx, dy * dy);
        s5[0] = fmaf(v, fabsf(dx) + fabsf(dy), s5[0]);
        s5[1] = fmaf(v, sqrt_approx(d2), s5[1]);
        s5[2] += d2 < 1.0f ? v : 0.0f;
        s5[3] += d2 < 9.0f ? v : 0.0f;
        s5[4] += d2 < 25.0f ? v : 0.0f;
      }
    };
    // the four planes; the last brings in plane 0 of the next item
    const T* mp = plane0(it);
    plane(wa, 0);
#pragma unroll
    for (int qi = 1; qi < 4; ++qi) {
      load9(wa, mp + (long long)qi * HW);
      plane(wa, qi);
    }
    if (it + 1 < i1) load9(wa, plane0(it + 1));
    // the item's sums: a fixed shuffle tree
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float x = s5[c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0)
        partial[((((long long)b * G + g) * NT + kj) * 16 + s) * 5 + c] = x;
    }
  }
}

// sums[n, c] = the partials of sample n's items, added in a fixed order:
// lane l of warp n adds the items l, l + 32, ... of the sample, then a
// shuffle tree adds the lanes.
__global__ void ul_reduce_kernel(const float* __restrict__ partial, int NT,
                                 int G, int B, float* __restrict__ sums) {
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= G * B) return;
  const float* pp =
      partial + ((long long)(n % B) * G + n / B) * NT * 16 * 5;
  float t[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = lane; i < NT * 16; i += 32) {
#pragma unroll
    for (int c = 0; c < 5; ++c) t[c] += pp[i * 5 + c];
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      t[c] += __shfl_xor_sync(0xffffffffu, t[c], o);
    if (lane == 0) sums[n * 5 + c] = t[c];
  }
}

template <typename T, int VB>
static cudaError_t launch_ul_fwd(cudaStream_t st, const float* f,
                                 const void* mask, const float* g,
                                 const float* v, int G, int B, int H, int W,
                                 int off, int NT, float* part) {
  using F = Fwd<T, VB>;
  auto kernel = ul_fwd_kernel<T, VB>;
  const int smem = FWD_WARPS * F::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, FWD_THREADS, smem)) != cudaSuccess)
    return err;
  // persistent warps, as many as fit at once: RR ranges a tile
  const long long fit =
      (long long)(per_sm > 0 ? per_sm : 1) * sms * FWD_WARPS;
  const long long items = (long long)B * 16 * G;
  long long RR = fit / NT;
  RR = RR < 1 ? 1 : (RR > items ? items : RR);
  const long long warps = RR * NT;
  kernel<<<(int)((warps + FWD_WARPS - 1) / FWD_WARPS), FWD_THREADS, smem,
           st>>>(f, reinterpret_cast<const T*>(mask), g, v, G, B, H, W, off,
                 NT, (int)RR, part);
  return cudaGetLastError();
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
        const float inv = softmax9_ex2(e);
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

// mask_dtype: 0 = float32, 1 = bfloat16.  vec_bytes: the access width of
// the mask loads (the file's note); it must divide the mask's address and
// H * W * element size.  `partial` holds `partial_floats` >= gB * NT * 80
// floats, NT the tiles of a sample (the wrapper's `fwd_plan`); `flow` is
// 8-byte and `gt` and `vm` are 16-byte aligned.  Returns a
// cudaError_t (0 = success).
extern "C" int upsample_loss_fwd(int device, int mask_dtype, int vec_bytes,
                                 const void* flow, const void* mask,
                                 const void* gt, const void* vm, int gB,
                                 int B, int H, int W, void* partial,
                                 long long partial_floats, void* sums,
                                 void* stream) {
  if (gB < 1 || B < 1 || gB % B || H < 1 || W < 1 || mask_dtype < 0 ||
      mask_dtype > 1 || (long long)H * W >= (1LL << 24))
    return (int)cudaErrorInvalidValue;
  const int es = mask_dtype == 0 ? 4 : 2, HW = H * W;
  const unsigned long long mp = reinterpret_cast<unsigned long long>(mask);
  if ((vec_bytes != 16 && vec_bytes != 8 && vec_bytes != 4 &&
       vec_bytes != 2) || vec_bytes < es ||
      (mp | (unsigned long long)HW * es) % vec_bytes ||
      (reinterpret_cast<unsigned long long>(gt) |
       reinterpret_cast<unsigned long long>(vm)) % 16)
    return (int)cudaErrorInvalidValue;
  const int P = vec_bytes == 16 ? 16 / es : 4;
  const int off = (int)(mp % (unsigned long long)(P * es)) / es;
  const int NT = ((HW + off + P - 1) / P + 31) / 32;
  if (partial_floats < (long long)gB * NT * 80 ||
      reinterpret_cast<unsigned long long>(flow) % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = gB / B;
  const float* f = reinterpret_cast<const float*>(flow);
  const float* g = reinterpret_cast<const float*>(gt);
  const float* v = reinterpret_cast<const float*>(vm);
  float* part = reinterpret_cast<float*>(partial);
#define UL_FWD(T, VB) \
  err = launch_ul_fwd<T, VB>(st, f, mask, g, v, G, B, H, W, off, NT, part)
  if (mask_dtype == 0) {
    if (vec_bytes == 16) UL_FWD(float, 16);
    else if (vec_bytes == 8) UL_FWD(float, 8);
    else UL_FWD(float, 4);
  } else {
    if (vec_bytes == 16) UL_FWD(__nv_bfloat16, 16);
    else if (vec_bytes == 8) UL_FWD(__nv_bfloat16, 8);
    else if (vec_bytes == 4) UL_FWD(__nv_bfloat16, 4);
    else UL_FWD(__nv_bfloat16, 2);
  }
#undef UL_FWD
  if (err != cudaSuccess) return (int)err;
  ul_reduce_kernel<<<(gB + 3) / 4, 128, 0, st>>>(
      part, NT, G, B, reinterpret_cast<float*>(sums));
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
