/* Native host-side augmentation kernels (the hot loop of
 * raft_tpu/data/augment.py; reference semantics from
 * core/utils/augmentor.py).
 *
 * Why C: the Python/cv2 pipeline costs ~108 ms/sample at FlyingThings
 * shapes (color ~60 ms, spatial ~34 ms) — a single host core feeds ~9
 * samples/s, far short of a multi-chip host's appetite.  These kernels
 * (a) compute the geometric path *only over the output crop* by fusing
 * resize+flip+crop into one inverse-mapped bilinear pass, and (b) run the
 * photometric ops as single passes without float temporaries.  Called via
 * ctypes (GIL released), so the loader's ThreadPoolExecutor scales across
 * cores.
 *
 * Parity contracts (tested against the NumPy/cv2 implementations):
 * - gray uses cv2's fixed-point RGB2GRAY: (R*4899+G*9617+B*1868+8192)>>14.
 * - brightness/contrast/saturation: float32 multiply, clip to [0,255],
 *   truncate to uint8 (NumPy .astype(uint8) semantics).
 * - warp: cv2.resize(INTER_LINEAR) center-aligned inverse mapping
 *   src = (dst + 0.5)/scale - 0.5 with edge clamp (float arithmetic; cv2's
 *   fixed-point path may differ by 1/255 — tolerance-tested).
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

static inline int gray_u8(const uint8_t *p) {
    return (p[0] * 4899 + p[1] * 9617 + p[2] * 1868 + 8192) >> 14;
}

static inline uint8_t clip_u8(float v) {
    if (v < 0.0f) return 0;
    if (v > 255.0f) return 255;
    return (uint8_t)v; /* truncation, matching .astype(uint8) */
}

/* Sum of the cv2-gray image over n_px RGB pixels (caller divides/rounds:
 * PIL contrast uses round(gray.mean())). */
double aug_gray_sum(const uint8_t *img, long n_px) {
    double acc = 0.0;
    for (long i = 0; i < n_px; i++) acc += (double)gray_u8(img + 3 * i);
    return acc;
}

/* The photometric ops are affine in the 8-bit input, so each becomes a
 * 256-entry lookup table (saturation: two tables joined by one add) —
 * byte-at-a-time float math ran at ~0.5 GB/s, LUTs are memory-speed. */

/* In-place brightness: v * f (PIL blend with black). */
void aug_brightness(uint8_t *img, long n, float f) {
    uint8_t lut[256];
    for (int v = 0; v < 256; v++) lut[v] = clip_u8((float)v * f);
    for (long i = 0; i < n; i++) img[i] = lut[img[i]];
}

/* In-place contrast: v * f + mean * (1 - f) (PIL blend with mean gray). */
void aug_contrast(uint8_t *img, long n, float f, float mean) {
    const float add = mean * (1.0f - f);
    uint8_t lut[256];
    for (int v = 0; v < 256; v++) lut[v] = clip_u8((float)v * f + add);
    for (long i = 0; i < n; i++) img[i] = lut[img[i]];
}

/* In-place saturation: v * f + gray * (1 - f) (PIL blend with grayscale).
 * lut_v[v] = v*f and lut_g[g] = g*(1-f) in 8.8 fixed point would drift
 * from the float32 reference; instead keep float tables and clip on the
 * summed value (identical arithmetic to the NumPy path up to fp32
 * association). */
void aug_saturation(uint8_t *img, long n_px, float f) {
    float lut_v[256], lut_g[256];
    for (int v = 0; v < 256; v++) {
        lut_v[v] = (float)v * f;
        lut_g[v] = (float)v * (1.0f - f);
    }
    for (long i = 0; i < n_px; i++) {
        uint8_t *p = img + 3 * i;
        const float g = lut_g[gray_u8(p)];
        p[0] = clip_u8(lut_v[p[0]] + g);
        p[1] = clip_u8(lut_v[p[1]] + g);
        p[2] = clip_u8(lut_v[p[2]] + g);
    }
}

/* Fused resize (cv2 center-aligned bilinear) + flip + crop, computed only
 * over the OH x OW output window.  (RH, RW) are the dims cv2.resize would
 * have produced; (x0, y0) is the crop origin in the (flipped) resized
 * image.  sample_x/y precomputed per output column/row would save a few
 * flops but keeps the code simple enough to skip. */
#define WARP_BODY(T, READ, WRITE, CN)                                          \
    const double inv_sx = 1.0 / sx, inv_sy = 1.0 / sy;                     \
    for (long i = 0; i < oh; i++) {                                        \
        long Y = y0 + i;                                                   \
        if (vflip) Y = rh - 1 - Y;                                         \
        double fy = ((double)Y + 0.5) * inv_sy - 0.5;                      \
        if (fy < 0) fy = 0;                                                \
        if (fy > (double)(h - 1)) fy = (double)(h - 1);                    \
        long y_lo = (long)fy;                                              \
        if (y_lo > h - 2) y_lo = h - 2;                                    \
        if (y_lo < 0) y_lo = 0;                                            \
        float wy = (float)(fy - (double)y_lo);                             \
        if (h == 1) { y_lo = 0; wy = 0.0f; }                               \
        const T *r0 = src + y_lo * w * (CN);                                  \
        const T *r1 = src + (h == 1 ? y_lo : y_lo + 1) * w * (CN);            \
        T *out = dst + i * ow * (CN);                                         \
        for (long j = 0; j < ow; j++) {                                    \
            long X = x0 + j;                                               \
            if (hflip) X = rw - 1 - X;                                     \
            double fx = ((double)X + 0.5) * inv_sx - 0.5;                  \
            if (fx < 0) fx = 0;                                            \
            if (fx > (double)(w - 1)) fx = (double)(w - 1);                \
            long x_lo = (long)fx;                                          \
            if (x_lo > w - 2) x_lo = w - 2;                                \
            if (x_lo < 0) x_lo = 0;                                        \
            float wx = (float)(fx - (double)x_lo);                         \
            if (w == 1) { x_lo = 0; wx = 0.0f; }                           \
            const float w00 = (1.0f - wy) * (1.0f - wx);                   \
            const float w01 = (1.0f - wy) * wx;                            \
            const float w10 = wy * (1.0f - wx);                            \
            const float w11 = wy * wx;                                     \
            const T *p00 = r0 + x_lo * (CN);                                  \
            const T *p01 = p00 + (w == 1 ? 0 : (CN));                         \
            const T *p10 = r1 + x_lo * (CN);                                  \
            const T *p11 = p10 + (w == 1 ? 0 : (CN));                         \
            for (long k = 0; k < (CN); k++) {                                 \
                float v = w00 * READ(p00[k]) + w01 * READ(p01[k]) +        \
                          w10 * READ(p10[k]) + w11 * READ(p11[k]);         \
                WRITE(out + j * (CN) + k, v, k);                           \
            }                                                              \
        }                                                                  \
    }

#define READ_U8(x) ((float)(x))
#define WRITE_U8(dst, v, k) (*(dst) = clip_u8((v) + 0.5f)) /* cv2 rounds */
#define READ_F32(x) (x)
#define WRITE_F32(dst, v, k) (*(dst) = (v) * chan_scale[k])

void aug_warp_u8(const uint8_t *src, long h, long w, long c, uint8_t *dst,
                 long oh, long ow, double sx, double sy, long rh, long rw,
                 int hflip, int vflip, long x0, long y0) {
    if (c == 3) { /* specialized so the inner loop fully unrolls */
        WARP_BODY(uint8_t, READ_U8, WRITE_U8, 3)
    } else {
        WARP_BODY(uint8_t, READ_U8, WRITE_U8, c)
    }
}

/* f32 variant with a per-channel output scale: folds the flow unit
 * rescale (* [sx, sy], augmentor.py:88) and the flip sign fixes
 * (augmentor.py:91-100) into the same pass. */
void aug_warp_f32(const float *src, long h, long w, long c, float *dst,
                  long oh, long ow, double sx, double sy, long rh, long rw,
                  int hflip, int vflip, long x0, long y0,
                  const float *chan_scale) {
    if (c == 2) { /* flow */
        WARP_BODY(float, READ_F32, WRITE_F32, 2)
    } else {
        WARP_BODY(float, READ_F32, WRITE_F32, c)
    }
}

/* --- Hue shift: cv2's uint8 RGB2HSV -> (h + shift) mod 180 -> HSV2RGB,
 * fused into one pass (the HSV image never materializes).  Forward
 * conversion replicates OpenCV's fixed-point path (hsv_shift=12 division
 * tables, nearest-int rounding); the back conversion replicates the u8
 * wrapper over the float sector functor (saturate_cast = rint + clamp).
 * This was the last cv2 call in the photometric path (~5 ms/sample,
 * GIL-held). */

static int sdiv_table[256];
static int hdiv_table[256];

/* Filled once at library load (constructor): the loader's thread pool
 * calls aug_hue_shift concurrently with the GIL released, so lazy init
 * would be a data race. */
__attribute__((constructor))
static void init_hue_tables(void) {
    sdiv_table[0] = hdiv_table[0] = 0;
    for (int i = 1; i < 256; i++) {
        sdiv_table[i] = (int)lrint((255 << 12) / (1.0 * i));
        hdiv_table[i] = (int)lrint((180 << 12) / (6.0 * i));
    }
}


void aug_hue_shift(uint8_t *img, long n_px, int shift) {
    shift %= 180;
    if (shift < 0) shift += 180;
    for (long i = 0; i < n_px; i++) {
        uint8_t *p = img + 3 * i;
        int r = p[0], g = p[1], b = p[2];
        int v = r > g ? r : g; if (b > v) v = b;
        int vmin = r < g ? r : g; if (b < vmin) vmin = b;
        int diff = v - vmin;
        int vr = (v == r) ? -1 : 0;
        int vg = (v == g) ? -1 : 0;
        int s = (diff * sdiv_table[v] + (1 << 11)) >> 12;
        int h = (vr & (g - b)) +
                (~vr & ((vg & (b - r + 2 * diff)) +
                        (~vg & (r - g + 4 * diff))));
        h = (h * hdiv_table[diff] + (1 << 11)) >> 12;
        if (h < 0) h += 180;

        h = (h + shift) % 180;

        /* HSV(u8) -> RGB via the float sector path in cv2's exact
         * operation order: h*6/180, s*(1/255), v*(1/255), sector tabs,
         * then TRUNCATING x*255 back to u8 (cv2 4.x's u8 wrapper
         * truncates; verified 0.005%% max-one-level residual over the
         * full 180*256*256 input domain). */
        if (s == 0) {
            p[0] = p[1] = p[2] = (uint8_t)v;
            continue;
        }
        float hf = (float)h * (6.0f / 180.0f);
        float sf = (float)s * (1.0f / 255.0f);
        float vf = (float)v * (1.0f / 255.0f);
        int sector = (int)floorf(hf);
        float f = hf - (float)sector;
        sector = ((sector % 6) + 6) % 6;
        float pv = vf * (1.0f - sf);
        float qv = vf * (1.0f - sf * f);
        float tv = vf * (1.0f - sf * (1.0f - f));
        float rf, gf, bf;
        switch (sector) {
        case 0: rf = vf; gf = tv; bf = pv; break;
        case 1: rf = qv; gf = vf; bf = pv; break;
        case 2: rf = pv; gf = vf; bf = tv; break;
        case 3: rf = pv; gf = qv; bf = vf; break;
        case 4: rf = tv; gf = pv; bf = vf; break;
        default: rf = vf; gf = pv; bf = qv; break;
        }
        p[0] = clip_u8(rf * 255.0f);
        p[1] = clip_u8(gf * 255.0f);
        p[2] = clip_u8(bf * 255.0f);
    }
}

/* --- Eraser support: channel sums (the occlusion rectangles are filled
 * with the frame-2 mean color, augmentor.py:40-48) + clipped fill. */

void aug_channel_sums(const uint8_t *img, long n_px, double *out3) {
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    for (long i = 0; i < n_px; i++) {
        const uint8_t *p = img + 3 * i;
        s0 += p[0]; s1 += p[1]; s2 += p[2];
    }
    out3[0] = s0; out3[1] = s1; out3[2] = s2;
}

void aug_fill_rect(uint8_t *img, int ht, int wd, int y0, int x0,
                   int dy, int dx, uint8_t r, uint8_t g, uint8_t b) {
    int y1 = y0 + dy, x1 = x0 + dx;
    if (y0 < 0) y0 = 0;
    if (x0 < 0) x0 = 0;
    if (y1 > ht) y1 = ht;
    if (x1 > wd) x1 = wd;
    for (int y = y0; y < y1; y++) {
        uint8_t *row = img + ((long)y * wd + x0) * 3;
        for (int x = x0; x < x1; x++) {
            *row++ = r; *row++ = g; *row++ = b;
        }
    }
}
