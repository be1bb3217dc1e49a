/* Bilinear remap with fixed-point maps, host code (plain C, no CUDA), built
 * with the system C compiler and loaded with ctypes (`data/cameras.py`).
 *
 * It computes what `cv2.remap(src, map1, map2, cv2.INTER_LINEAR)` computes
 * for CV_16SC2 maps and the default constant border of 0: map1 holds each
 * destination pixel's integer source (x, y), map2 its fraction index
 * (5 bits of y, then 5 bits of x); `wtab` holds the four weights of each of
 * the 1024 fractions (y0x0, y0x1, y1x0, y1x1), built in Python as cv2
 * builds them. Source pixels outside the image read as 0.
 *
 *   uint8:   (v0 w0 + v1 w1 + v2 w2 + v3 w3 + 2^14) >> 15, saturated, with
 *            15-bit integer weights;
 *   float32: ((v0 w0 + v1 w1) + v2 w2) + v3 w3 in float, float weights (the
 *            build turns contraction into FMA off, so each product rounds).
 *
 *   dsn_remap_linear_u8 / dsn_remap_linear_f32(src, h, w, c, map1, map2,
 *       wtab, dst, oh, ow): dst is oh * ow * c; returns 0.
 */
#include <stdint.h>

#define FRAC_MASK 1023

static inline int inside(int32_t y, int32_t x, int32_t h, int32_t w) {
    return y >= 0 && y < h && x >= 0 && x < w;
}

int dsn_remap_linear_u8(const uint8_t *src, int32_t h, int32_t w, int32_t c,
                        const int16_t *map1, const uint16_t *map2, const int32_t *wtab,
                        uint8_t *dst, int32_t oh, int32_t ow) {
    int64_t n = (int64_t)oh * ow;
    for (int64_t i = 0; i < n; i++) {
        int32_t sx = map1[2 * i], sy = map1[2 * i + 1];
        const int32_t *wt = wtab + 4 * (map2[i] & FRAC_MASK);
        int in00 = inside(sy, sx, h, w), in01 = inside(sy, sx + 1, h, w);
        int in10 = inside(sy + 1, sx, h, w), in11 = inside(sy + 1, sx + 1, h, w);
        int64_t i00 = ((int64_t)sy * w + sx) * c, i10 = i00 + (int64_t)w * c;
        for (int32_t k = 0; k < c; k++) {
            int32_t v0 = in00 ? src[i00 + k] : 0, v1 = in01 ? src[i00 + c + k] : 0;
            int32_t v2 = in10 ? src[i10 + k] : 0, v3 = in11 ? src[i10 + c + k] : 0;
            int32_t acc = v0 * wt[0] + v1 * wt[1] + v2 * wt[2] + v3 * wt[3];
            int32_t v = (acc + (1 << 14)) >> 15;
            dst[i * c + k] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
        }
    }
    return 0;
}

int dsn_remap_linear_f32(const float *src, int32_t h, int32_t w, int32_t c,
                         const int16_t *map1, const uint16_t *map2, const float *wtab,
                         float *dst, int32_t oh, int32_t ow) {
    int64_t n = (int64_t)oh * ow;
    for (int64_t i = 0; i < n; i++) {
        int32_t sx = map1[2 * i], sy = map1[2 * i + 1];
        const float *wt = wtab + 4 * (map2[i] & FRAC_MASK);
        int in00 = inside(sy, sx, h, w), in01 = inside(sy, sx + 1, h, w);
        int in10 = inside(sy + 1, sx, h, w), in11 = inside(sy + 1, sx + 1, h, w);
        int64_t i00 = ((int64_t)sy * w + sx) * c, i10 = i00 + (int64_t)w * c;
        for (int32_t k = 0; k < c; k++) {
            float v0 = in00 ? src[i00 + k] : 0.0f, v1 = in01 ? src[i00 + c + k] : 0.0f;
            float v2 = in10 ? src[i10 + k] : 0.0f, v3 = in11 ? src[i10 + c + k] : 0.0f;
            float acc = v0 * wt[0];
            acc = acc + v1 * wt[1];
            acc = acc + v2 * wt[2];
            acc = acc + v3 * wt[3];
            dst[i * c + k] = acc;
        }
    }
    return 0;
}
