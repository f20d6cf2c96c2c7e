/* PNG row unfiltering (RFC 2083 §6) — the sequential hot loop of the
 * pure-NumPy PNG codec in raft_tpu/data/png16.py.
 *
 * The TPU framework's native runtime layer: where the reference uses
 * C++/CUDA for its device kernel (alt_cuda_corr/correlation_kernel.cu), the
 * TPU build uses Pallas for device code and keeps C for genuinely serial
 * host-side work like this (Paeth prediction has a loop-carried dependency
 * on the decoded left pixel, so it cannot be vectorized).
 *
 * Built as a shared library by raft_tpu/native/build.py; loaded via ctypes.
 */

#include <stdint.h>
#include <stdlib.h>

/* scan: height rows of (1 filter byte + stride data bytes), as produced by
 * zlib-inflating the IDAT stream.  out: height*stride decoded bytes.
 * Returns 0 on success, the bad filter type on failure. */
int png_unfilter(const uint8_t *scan, uint8_t *out,
                 long height, long stride, int bpp) {
    const uint8_t *prev = NULL;
    for (long y = 0; y < height; y++) {
        const uint8_t *line = scan + y * (stride + 1);
        uint8_t ft = line[0];
        const uint8_t *in = line + 1;
        uint8_t *cur = out + y * stride;
        switch (ft) {
        case 0:
            for (long x = 0; x < stride; x++) cur[x] = in[x];
            break;
        case 1: /* Sub */
            for (long x = 0; x < stride; x++) {
                uint8_t a = x >= bpp ? cur[x - bpp] : 0;
                cur[x] = (uint8_t)(in[x] + a);
            }
            break;
        case 2: /* Up */
            for (long x = 0; x < stride; x++) {
                uint8_t b = prev ? prev[x] : 0;
                cur[x] = (uint8_t)(in[x] + b);
            }
            break;
        case 3: /* Average */
            for (long x = 0; x < stride; x++) {
                int a = x >= bpp ? cur[x - bpp] : 0;
                int b = prev ? prev[x] : 0;
                cur[x] = (uint8_t)(in[x] + ((a + b) >> 1));
            }
            break;
        case 4: /* Paeth */
            for (long x = 0; x < stride; x++) {
                int a = x >= bpp ? cur[x - bpp] : 0;
                int b = prev ? prev[x] : 0;
                int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                int p = a + b - c;
                int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                cur[x] = (uint8_t)(in[x] + pred);
            }
            break;
        default:
            return ft;
        }
        prev = cur;
    }
    return 0;
}
