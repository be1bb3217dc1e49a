/* PNG row filters undone, host code (plain C, no CUDA), built with the system
 * C compiler and loaded with ctypes (`utils/image_io.py`). The IDAT stream is
 * inflated in Python (zlib); this reverses the five filter types of the PNG
 * specification (section 9: None, Sub, Up, Average, Paeth) row by row. The
 * filters run along each row with a dependency on the previous byte, which
 * Python would take seconds for on a 1024 x 1024 mask.
 *
 *   dsn_png_unfilter(raw, rawlen, out, h, rowbytes, bpp, err, errlen):
 *     raw holds h rows of (1 filter byte + rowbytes); out receives h *
 *     rowbytes bytes. bpp is the bytes per complete pixel (at least 1).
 *     Returns 0, or nonzero with a message in err.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

static int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

int dsn_png_unfilter(const uint8_t *raw, int64_t rawlen, uint8_t *out, int32_t h,
                     int32_t rowbytes, int32_t bpp, char *err, int errlen) {
    if ((int64_t)h * ((int64_t)rowbytes + 1) > rawlen) {
        snprintf(err, (size_t)errlen, "PNG: image data is %lld bytes, %lld expected",
                 (long long)rawlen, (long long)h * ((long long)rowbytes + 1));
        return 2;
    }
    for (int32_t y = 0; y < h; y++) {
        const uint8_t *src = raw + (int64_t)y * (rowbytes + 1);
        int filter = src[0];
        src++;
        uint8_t *cur = out + (int64_t)y * rowbytes;
        const uint8_t *up = y > 0 ? cur - rowbytes : NULL;
        switch (filter) {
            case 0:
                for (int32_t x = 0; x < rowbytes; x++) cur[x] = src[x];
                break;
            case 1:
                for (int32_t x = 0; x < rowbytes; x++)
                    cur[x] = (uint8_t)(src[x] + (x >= bpp ? cur[x - bpp] : 0));
                break;
            case 2:
                for (int32_t x = 0; x < rowbytes; x++) cur[x] = (uint8_t)(src[x] + (up ? up[x] : 0));
                break;
            case 3:
                for (int32_t x = 0; x < rowbytes; x++) {
                    int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
                    cur[x] = (uint8_t)(src[x] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int32_t x = 0; x < rowbytes; x++) {
                    int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
                    int c = (up && x >= bpp) ? up[x - bpp] : 0;
                    cur[x] = (uint8_t)(src[x] + paeth(a, b, c));
                }
                break;
            default:
                snprintf(err, (size_t)errlen, "PNG: unknown row filter type %d in row %d", filter,
                         (int)y);
                return 2;
        }
    }
    return 0;
}
