/* Baseline JPEG decoder, host code (plain C, no CUDA), built with the system
 * C compiler and loaded with ctypes (`utils/image_io.py`).
 *
 * It decodes what `cv2.imread(path)` decodes and gives the same pixels:
 * OpenCV reads JPEGs through libjpeg(-turbo) with the library's defaults, and
 * this file follows that default decode path step for step:
 *
 *   - sequential Huffman scans (SOF0, and SOF1 at 8-bit precision), one or
 *     more scans, interleaved or not, with restart markers (DRI / RSTn);
 *   - dequantisation and the accurate integer IDCT, "islow" (jidctint.c),
 *     with its range-limit table (jdmaster.c prepare_range_limit_table);
 *   - "fancy" chroma upsampling (jdsample.c): the triangle filters for h2v1,
 *     h1v2 and h2v2 (edge samples replicated, as the context rows of
 *     jdmainct.c replicate the first and last rows), plain replication for
 *     other integral ratios and for components two samples wide or less;
 *   - the fixed-point YCbCr -> RGB tables (jdcolor.c, 16 fraction bits);
 *   - output as BGR, H x W x 3; a one-component (grey) image is replicated
 *     into the three channels, as OpenCV's colour read does.
 *
 * Progressive (SOF2/SOF6/SOF10/SOF14), lossless (SOF3), hierarchical and
 * arithmetic-coded (SOF9-SOF15, DAC) files, 12-bit samples and four-
 * component (CMYK / YCCK) files are refused with a message naming the marker
 * or the field. Entropy data that ends early decodes as zero bits, as
 * libjpeg does after its "premature end" warning.
 *
 * Entry points (each returns 0, or nonzero with a message in `err`):
 *   dsn_jpeg_header(data, len, dims[3], err, errlen): dims = H, W, components;
 *   dsn_jpeg_decode(data, len, out, err, errlen): out is H*W*3 bytes, BGR.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAX_COMPS 4

typedef struct {
    uint8_t bits[17];     /* bits[k]: number of codes of length k */
    uint8_t vals[256];
    int mincode[17], maxcode[18], valptr[17];
    int present;
} HuffTable;

typedef struct {
    int id, h, v, tq;
    int dw, dh;           /* downsampled width and height (samples) */
    int bw, bh;           /* plane size in blocks, padded to whole MCUs */
    int stride;           /* plane row length in samples (bw * 8) */
    uint8_t *plane;       /* decoded samples, (bh*8) x (bw*8) */
    int dc_pred;
    int td, ta;           /* Huffman table ids of the current scan */
} Component;

typedef struct {
    const uint8_t *data;
    size_t len, pos;
    /* bit reader */
    uint32_t acc;
    int nbits;
    int hit_marker;
    /* frame */
    int width, height, ncomp, hmax, vmax, mcux, mcuy, sof_seen, restart_interval;
    int adobe, adobe_transform, jfif;
    Component comp[MAX_COMPS];
    uint16_t qt[4][64];
    int qt_present[4];
    HuffTable dc[4], ac[4];
    char *err;
    int errlen;
} Decoder;

static const int zigzag[64 + 16] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    /* extra entries for safety in decoder (as jutils.c) */
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

static int fail(Decoder *d, const char *msg, int code) {
    if (d->err && d->errlen > 0) {
        snprintf(d->err, (size_t)d->errlen, "%s", msg);
    }
    return code;
}

static int read_u8(Decoder *d, int *v) {
    if (d->pos >= d->len) return 0;
    *v = d->data[d->pos++];
    return 1;
}

static int read_u16(Decoder *d, int *v) {
    if (d->pos + 2 > d->len) return 0;
    *v = (d->data[d->pos] << 8) | d->data[d->pos + 1];
    d->pos += 2;
    return 1;
}

/* ------------------------------------------------------------------------ */
/* Huffman tables (jdhuff.c jpeg_make_d_derived_tbl, the slow-path form)     */
/* ------------------------------------------------------------------------ */
static int build_huffman(HuffTable *t) {
    int code = 0, p = 0;
    for (int l = 1; l <= 16; l++) {
        t->valptr[l] = p;
        t->mincode[l] = code;
        code += t->bits[l];
        p += t->bits[l];
        t->maxcode[l] = t->bits[l] ? code - 1 : -1;
        if (code > (1 << l)) return 0; /* bad table */
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    t->present = 1;
    return 1;
}

/* ------------------------------------------------------------------------ */
/* Bit reader: byte stuffing, stop at markers (then feed zero bits)         */
/* ------------------------------------------------------------------------ */
static void fill_bits(Decoder *d) {
    while (d->nbits <= 24) {
        int byte = 0;
        if (!d->hit_marker && d->pos < d->len) {
            byte = d->data[d->pos];
            if (byte == 0xFF) {
                int next = d->pos + 1 < d->len ? d->data[d->pos + 1] : -1;
                if (next == 0x00) {
                    d->pos += 2;
                } else {
                    d->hit_marker = 1; /* leave the marker for the parser */
                    byte = 0;
                }
            } else {
                d->pos++;
            }
        }
        d->acc |= (uint32_t)byte << (24 - d->nbits);
        d->nbits += 8;
    }
}

static inline int get_bits(Decoder *d, int n) {
    if (n == 0) return 0;
    if (d->nbits < n) fill_bits(d);
    int v = (int)(d->acc >> (32 - n));
    d->acc <<= n;
    d->nbits -= n;
    return v;
}

static inline int get_bit(Decoder *d) { return get_bits(d, 1); }

static int decode_huff(Decoder *d, const HuffTable *t) {
    int code = get_bit(d);
    int l = 1;
    while (l <= 16 && code > t->maxcode[l]) {
        code = (code << 1) | get_bit(d);
        l++;
    }
    if (l > 16) return 0; /* corrupt data: libjpeg warns and returns 0 */
    return t->vals[(t->valptr[l] + code - t->mincode[l]) & 0xFF];
}

static inline int extend(int r, int s) {
    /* HUFF_EXTEND */
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

static void reset_bits(Decoder *d) {
    d->acc = 0;
    d->nbits = 0;
}

/* ------------------------------------------------------------------------ */
/* IDCT: jidctint.c jpeg_idct_islow                                         */
/* ------------------------------------------------------------------------ */
#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* sample_range_limit of jdmaster.c, indexed from -256; idct_limit is the
 * post-IDCT view (offset by CENTERJSAMPLE), masked with RANGE_MASK 1023. */
static uint8_t range_table[5 * 256 + 128];
static const uint8_t *sample_limit; /* sample_limit[x], x in [-256, 1152) */
static const uint8_t *idct_limit;
static int cr_r_tab[256], cb_b_tab[256];
static int64_t cr_g_tab[256], cb_g_tab[256];

/* Filled once when the library is loaded, before any thread calls in: the
 * loader's threads decode concurrently and only read these tables. */
__attribute__((constructor)) static void prepare_tables(void) {
    uint8_t *table = range_table + 256;
    memset(table - 256, 0, 256);
    for (int i = 0; i <= 255; i++) table[i] = (uint8_t)i;
    uint8_t *post = table + 128;
    for (int i = 128; i < 512; i++) post[i] = 255;
    memset(post + 512, 0, 512 - 128);
    memcpy(post + 1024 - 128, table, 128);
    sample_limit = table;
    idct_limit = post;
    /* jdcolor.c build_ycc_rgb_table */
    const int64_t one_half = (int64_t)1 << 15;
#define FIX16(x) ((int64_t)((x) * 65536.0 + 0.5))
    for (int i = 0, x = -128; i <= 255; i++, x++) {
        cr_r_tab[i] = (int)((FIX16(1.40200) * x + one_half) >> 16);
        cb_b_tab[i] = (int)((FIX16(1.77200) * x + one_half) >> 16);
        cr_g_tab[i] = (-FIX16(0.71414)) * x;
        cb_g_tab[i] = (-FIX16(0.34414)) * x + one_half;
    }
#undef FIX16
}

static void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out, int stride) {
    int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
    int ws[64];
    /* Pass 1: columns from input, into the work array */
    for (int c = 0; c < 8; c++) {
        const int16_t *in = coef + c;
        const uint16_t *qp = q + c;
        int *w = ws + c;
        if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
            in[48] == 0 && in[56] == 0) {
            int dcval = (int)(((int)in[0] * (int)qp[0]) * (1 << PASS1_BITS));
            for (int r = 0; r < 8; r++) w[8 * r] = dcval;
            continue;
        }
        z2 = (int64_t)in[16] * qp[16];
        z3 = (int64_t)in[48] * qp[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)in[0] * qp[0];
        z3 = (int64_t)in[32] * qp[32];
        tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
        tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = (int64_t)in[56] * qp[56];
        tmp1 = (int64_t)in[40] * qp[40];
        tmp2 = (int64_t)in[24] * qp[24];
        tmp3 = (int64_t)in[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        w[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
        w[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
        w[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
        w[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
        w[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
        w[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
        w[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
        w[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    }
    /* Pass 2: rows from the work array, into the output */
    for (int r = 0; r < 8; r++) {
        const int *w = ws + 8 * r;
        uint8_t *o = out + (size_t)r * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
            w[7] == 0) {
            uint8_t dcval = idct_limit[(int)DESCALE((int64_t)w[0], PASS1_BITS + 3) & 1023];
            for (int c = 0; c < 8; c++) o[c] = dcval;
            continue;
        }
        z2 = w[2];
        z3 = w[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        tmp0 = ((int64_t)w[0] + w[4]) * ((int64_t)1 << CONST_BITS);
        tmp1 = ((int64_t)w[0] - w[4]) * ((int64_t)1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS + PASS1_BITS + 3;
        o[0] = idct_limit[(int)DESCALE(tmp10 + tmp3, sh) & 1023];
        o[7] = idct_limit[(int)DESCALE(tmp10 - tmp3, sh) & 1023];
        o[1] = idct_limit[(int)DESCALE(tmp11 + tmp2, sh) & 1023];
        o[6] = idct_limit[(int)DESCALE(tmp11 - tmp2, sh) & 1023];
        o[2] = idct_limit[(int)DESCALE(tmp12 + tmp1, sh) & 1023];
        o[5] = idct_limit[(int)DESCALE(tmp12 - tmp1, sh) & 1023];
        o[3] = idct_limit[(int)DESCALE(tmp13 + tmp0, sh) & 1023];
        o[4] = idct_limit[(int)DESCALE(tmp13 - tmp0, sh) & 1023];
    }
}

/* ------------------------------------------------------------------------ */
/* Markers                                                                  */
/* ------------------------------------------------------------------------ */
static int parse_dqt(Decoder *d, int length) {
    size_t end = d->pos + (size_t)length;
    while (d->pos < end) {
        int pq_tq;
        if (!read_u8(d, &pq_tq)) return fail(d, "DQT: truncated", 2);
        int pq = pq_tq >> 4, tq = pq_tq & 15;
        if (tq > 3) return fail(d, "DQT: table id above 3", 2);
        for (int i = 0; i < 64; i++) {
            int v;
            if (pq ? !read_u16(d, &v) : !read_u8(d, &v)) return fail(d, "DQT: truncated", 2);
            d->qt[tq][zigzag[i]] = (uint16_t)v;
        }
        d->qt_present[tq] = 1;
    }
    return 0;
}

static int parse_dht(Decoder *d, int length) {
    size_t end = d->pos + (size_t)length;
    while (d->pos < end) {
        int tc_th;
        if (!read_u8(d, &tc_th)) return fail(d, "DHT: truncated", 2);
        int tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3) return fail(d, "DHT: bad table class or id", 2);
        HuffTable *t = tc ? &d->ac[th] : &d->dc[th];
        int total = 0;
        t->bits[0] = 0;
        for (int i = 1; i <= 16; i++) {
            int v;
            if (!read_u8(d, &v)) return fail(d, "DHT: truncated", 2);
            t->bits[i] = (uint8_t)v;
            total += v;
        }
        if (total > 256) return fail(d, "DHT: more than 256 codes", 2);
        for (int i = 0; i < total; i++) {
            int v;
            if (!read_u8(d, &v)) return fail(d, "DHT: truncated", 2);
            if (tc == 0 && v > 15) return fail(d, "DHT: DC symbol above 15", 2);
            t->vals[i] = (uint8_t)v;
        }
        if (!build_huffman(t)) return fail(d, "DHT: bad code lengths", 2);
    }
    return 0;
}

static int parse_sof(Decoder *d, int marker) {
    int p, h, w, n;
    if (!read_u8(d, &p) || !read_u16(d, &h) || !read_u16(d, &w) || !read_u8(d, &n))
        return fail(d, "SOF: truncated", 2);
    if (p != 8) {
        char msg[96];
        snprintf(msg, sizeof msg, "SOF%d: %d-bit samples are not supported (8-bit only)",
                 marker - 0xC0, p);
        return fail(d, msg, 3);
    }
    if (h == 0 || w == 0) return fail(d, "SOF: zero height (DNL) or width is not supported", 3);
    if (n != 1 && n != 3) {
        char msg[96];
        snprintf(msg, sizeof msg, "SOF: %d components are not supported (1 or 3 only)", n);
        return fail(d, msg, 3);
    }
    d->width = w;
    d->height = h;
    d->ncomp = n;
    d->hmax = d->vmax = 1;
    for (int i = 0; i < n; i++) {
        int id, hv, tq;
        if (!read_u8(d, &id) || !read_u8(d, &hv) || !read_u8(d, &tq))
            return fail(d, "SOF: truncated", 2);
        Component *c = &d->comp[i];
        c->id = id;
        c->h = hv >> 4;
        c->v = hv & 15;
        c->tq = tq;
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || tq > 3)
            return fail(d, "SOF: bad sampling factor or table id", 2);
        if (c->h > d->hmax) d->hmax = c->h;
        if (c->v > d->vmax) d->vmax = c->v;
    }
    d->mcux = (w + 8 * d->hmax - 1) / (8 * d->hmax);
    d->mcuy = (h + 8 * d->vmax - 1) / (8 * d->vmax);
    for (int i = 0; i < n; i++) {
        Component *c = &d->comp[i];
        c->dw = (int)(((int64_t)w * c->h + d->hmax - 1) / d->hmax);
        c->dh = (int)(((int64_t)h * c->v + d->vmax - 1) / d->vmax);
        c->bw = d->mcux * c->h;
        c->bh = d->mcuy * c->v;
        c->stride = c->bw * 8;
    }
    d->sof_seen = 1;
    return 0;
}

static int decode_block(Decoder *d, Component *c, uint8_t *out) {
    int16_t coef[64];
    memset(coef, 0, sizeof coef);
    const HuffTable *dc = &d->dc[c->td], *ac = &d->ac[c->ta];
    int s = decode_huff(d, dc);
    if (s) s = extend(get_bits(d, s), s);
    s = (int)((unsigned int)s + (unsigned int)c->dc_pred);
    c->dc_pred = s;
    coef[0] = (int16_t)s;
    for (int k = 1; k < 64; k++) {
        int rs = decode_huff(d, ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            int v = extend(get_bits(d, s), s);
            coef[zigzag[k]] = (int16_t)v;
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    idct_islow(coef, d->qt[c->tq], out, c->stride);
    return 0;
}

/* After a restart interval: drop the partial byte, step over RSTn. */
static int process_restart(Decoder *d) {
    reset_bits(d);
    d->hit_marker = 0;
    /* scan forward to the next marker (libjpeg resyncs on garbage too) */
    while (d->pos + 1 < d->len && !(d->data[d->pos] == 0xFF && d->data[d->pos + 1] != 0 &&
                                     d->data[d->pos + 1] != 0xFF)) {
        d->pos++;
    }
    if (d->pos + 1 < d->len && d->data[d->pos + 1] >= 0xD0 && d->data[d->pos + 1] <= 0xD7)
        d->pos += 2;
    for (int i = 0; i < d->ncomp; i++) d->comp[i].dc_pred = 0;
    return 0;
}

static int parse_sos(Decoder *d) {
    int ns;
    if (!d->sof_seen) return fail(d, "SOS before SOF", 2);
    if (!read_u8(d, &ns) || ns < 1 || ns > d->ncomp) return fail(d, "SOS: bad component count", 2);
    Component *sc[MAX_COMPS];
    for (int i = 0; i < ns; i++) {
        int id, t;
        if (!read_u8(d, &id) || !read_u8(d, &t)) return fail(d, "SOS: truncated", 2);
        sc[i] = NULL;
        for (int j = 0; j < d->ncomp; j++)
            if (d->comp[j].id == id) sc[i] = &d->comp[j];
        if (!sc[i]) return fail(d, "SOS: unknown component id", 2);
        sc[i]->td = t >> 4;
        sc[i]->ta = t & 15;
        if (sc[i]->td > 3 || sc[i]->ta > 3 || !d->dc[sc[i]->td].present ||
            !d->ac[sc[i]->ta].present)
            return fail(d, "SOS: Huffman table not defined", 2);
        if (!d->qt_present[sc[i]->tq]) return fail(d, "SOS: quantisation table not defined", 2);
    }
    int ss, se, ahal;
    if (!read_u8(d, &ss) || !read_u8(d, &se) || !read_u8(d, &ahal)) return fail(d, "SOS: truncated", 2);
    if (ss != 0 || se != 63 || ahal != 0)
        return fail(d, "SOS: spectral selection or approximation in a sequential scan", 2);
    for (int i = 0; i < ns; i++) {
        if (!sc[i]->plane) {
            size_t sz = (size_t)sc[i]->stride * (size_t)(sc[i]->bh * 8);
            sc[i]->plane = (uint8_t *)calloc(sz, 1);
            if (!sc[i]->plane) return fail(d, "out of memory", 4);
        }
        sc[i]->dc_pred = 0;
    }
    reset_bits(d);
    d->hit_marker = 0;
    int restarts_left = d->restart_interval;
    if (ns == 1) {
        /* non-interleaved: one block per MCU over the component's own blocks */
        Component *c = sc[0];
        int bw = (c->dw + 7) / 8, bh = (c->dh + 7) / 8;
        for (int by = 0; by < bh; by++) {
            for (int bx = 0; bx < bw; bx++) {
                if (d->restart_interval) {
                    if (restarts_left == 0) {
                        process_restart(d);
                        restarts_left = d->restart_interval;
                    }
                    restarts_left--;
                }
                decode_block(d, c, c->plane + (size_t)by * 8 * c->stride + (size_t)bx * 8);
            }
        }
    } else {
        for (int my = 0; my < d->mcuy; my++) {
            for (int mx = 0; mx < d->mcux; mx++) {
                if (d->restart_interval) {
                    if (restarts_left == 0) {
                        process_restart(d);
                        restarts_left = d->restart_interval;
                    }
                    restarts_left--;
                }
                for (int i = 0; i < ns; i++) {
                    Component *c = sc[i];
                    for (int v = 0; v < c->v; v++) {
                        for (int h = 0; h < c->h; h++) {
                            size_t row = (size_t)(my * c->v + v) * 8;
                            size_t col = (size_t)(mx * c->h + h) * 8;
                            decode_block(d, c, c->plane + row * c->stride + col);
                        }
                    }
                }
            }
        }
    }
    /* step to the marker after the entropy data */
    reset_bits(d);
    while (d->pos + 1 < d->len &&
           !(d->data[d->pos] == 0xFF && d->data[d->pos + 1] != 0 &&
             !(d->data[d->pos + 1] >= 0xD0 && d->data[d->pos + 1] <= 0xD7))) {
        d->pos++;
    }
    return 0;
}

static int parse(Decoder *d, int headers_only) {
    int m0, m1;
    if (!read_u8(d, &m0) || !read_u8(d, &m1) || m0 != 0xFF || m1 != 0xD8)
        return fail(d, "not a JPEG file (no SOI marker)", 1);
    for (;;) {
        int b;
        if (!read_u8(d, &b)) break; /* end of data without EOI: decode what we have */
        if (b != 0xFF) continue;    /* garbage between markers: libjpeg skips it */
        int marker;
        do {
            if (!read_u8(d, &marker)) return d->sof_seen ? 0 : fail(d, "truncated JPEG", 2);
        } while (marker == 0xFF);
        if (marker == 0xD9) break; /* EOI */
        if (marker == 0x00 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
        int length;
        if (!read_u16(d, &length) || length < 2) return fail(d, "truncated marker segment", 2);
        length -= 2;
        if (d->pos + (size_t)length > d->len) return fail(d, "truncated marker segment", 2);
        size_t next = d->pos + (size_t)length;
        int rc = 0;
        switch (marker) {
            case 0xC0:
            case 0xC1:
                if (d->sof_seen) return fail(d, "more than one SOF marker", 2);
                rc = parse_sof(d, marker);
                if (rc == 0 && headers_only) return 0;
                break;
            case 0xC2:
            case 0xC6:
            case 0xCA:
            case 0xCE: {
                char msg[96];
                snprintf(msg, sizeof msg,
                         "progressive JPEG (SOF%d, marker 0xFF%02X) is not supported: baseline only",
                         marker - 0xC0, marker);
                return fail(d, msg, 3);
            }
            case 0xC3:
            case 0xC5:
            case 0xC7:
            case 0xC9:
            case 0xCB:
            case 0xCD:
            case 0xCF: {
                char msg[112];
                const char *kind = marker == 0xC3   ? "lossless"
                                   : marker >= 0xC9 ? "arithmetic-coded"
                                                    : "hierarchical (differential)";
                snprintf(msg, sizeof msg,
                         "%s JPEG (SOF%d, marker 0xFF%02X) is not supported: baseline only", kind,
                         marker - 0xC0, marker);
                return fail(d, msg, 3);
            }
            case 0xCC:
                return fail(d, "arithmetic-coded JPEG (DAC, marker 0xFFCC) is not supported", 3);
            case 0xC4:
                rc = parse_dht(d, length);
                break;
            case 0xDB:
                rc = parse_dqt(d, length);
                break;
            case 0xDD: {
                int ri;
                if (!read_u16(d, &ri)) return fail(d, "DRI: truncated", 2);
                d->restart_interval = ri;
                break;
            }
            case 0xDA:
                if (headers_only) return fail(d, "SOS before SOF", 2);
                rc = parse_sos(d);
                if (rc) return rc;
                continue; /* parse_sos leaves pos at the next marker */
            case 0xE0:
                if (length >= 5 && memcmp(d->data + d->pos, "JFIF\0", 5) == 0) d->jfif = 1;
                break;
            case 0xEE:
                if (length >= 12 && memcmp(d->data + d->pos, "Adobe", 5) == 0) {
                    d->adobe = 1;
                    d->adobe_transform = d->data[d->pos + 11];
                }
                break;
            default:
                break; /* APPn, COM and others: skipped */
        }
        if (rc) return rc;
        d->pos = next;
    }
    if (!d->sof_seen) return fail(d, "no SOF marker", 2);
    return 0;
}

/* ------------------------------------------------------------------------ */
/* Upsampling (jdsample.c, do_fancy_upsampling = TRUE) and colour            */
/* ------------------------------------------------------------------------ */
/* Row r of a component, clamped to its real rows (jdmainct.c context rows). */
static inline const uint8_t *crow(const Component *c, int r) {
    if (r < 0) r = 0;
    if (r > c->dh - 1) r = c->dh - 1;
    return c->plane + (size_t)r * c->stride;
}

/* The component at full size: out has rows of `ow` = 2*dw (or more) samples. */
static int upsample(const Decoder *d, const Component *c, uint8_t *out, int ow, int oh) {
    int hr = d->hmax / c->h, vr = d->vmax / c->v;
    if (d->hmax % c->h || d->vmax % c->v) return 0;
    int dw = c->dw;
    if (hr == 1 && vr == 1) {
        for (int y = 0; y < oh; y++) memcpy(out + (size_t)y * ow, crow(c, y), (size_t)ow);
        return 1;
    }
    if (hr == 2 && vr == 1 && dw > 2) { /* h2v1_fancy_upsample */
        for (int y = 0; y < oh; y++) {
            const uint8_t *in = crow(c, y);
            uint8_t *o = out + (size_t)y * ow;
            int v = in[0];
            o[0] = (uint8_t)v;
            o[1] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
            for (int x = 1; x < dw - 1; x++) {
                v = in[x] * 3;
                o[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
                o[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
            }
            v = in[dw - 1];
            o[2 * dw - 2] = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
            o[2 * dw - 1] = (uint8_t)v;
        }
        return 1;
    }
    if (hr == 1 && vr == 2) { /* h1v2_fancy_upsample */
        for (int y = 0; y < oh; y++) {
            int r = y >> 1;
            const uint8_t *in0 = crow(c, r);
            const uint8_t *in1 = crow(c, (y & 1) ? r + 1 : r - 1);
            int bias = (y & 1) ? 2 : 1;
            uint8_t *o = out + (size_t)y * ow;
            for (int x = 0; x < dw; x++) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
        }
        return 1;
    }
    if (hr == 2 && vr == 2 && dw > 2) { /* h2v2_fancy_upsample */
        for (int y = 0; y < oh; y++) {
            int r = y >> 1;
            const uint8_t *in0 = crow(c, r);
            const uint8_t *in1 = crow(c, (y & 1) ? r + 1 : r - 1);
            uint8_t *o = out + (size_t)y * ow;
            int this_s = in0[0] * 3 + in1[0];
            int next_s = in0[1] * 3 + in1[1];
            o[0] = (uint8_t)((this_s * 4 + 8) >> 4);
            o[1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
            int last_s = this_s;
            this_s = next_s;
            for (int x = 1; x < dw - 1; x++) {
                next_s = in0[x + 1] * 3 + in1[x + 1];
                o[2 * x] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
                o[2 * x + 1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
                last_s = this_s;
                this_s = next_s;
            }
            o[2 * dw - 2] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
            o[2 * dw - 1] = (uint8_t)((this_s * 4 + 7) >> 4);
        }
        return 1;
    }
    /* int_upsample (and h2v1 / h2v2 plain replication for narrow components) */
    for (int y = 0; y < oh; y++) {
        const uint8_t *in = crow(c, y / vr);
        uint8_t *o = out + (size_t)y * ow;
        for (int x = 0; x < ow; x++) {
            int sx = x / hr;
            o[x] = in[sx < c->stride ? sx : c->stride - 1];
        }
    }
    return 1;
}

static void free_planes(Decoder *d) {
    for (int i = 0; i < MAX_COMPS; i++) {
        free(d->comp[i].plane);
        d->comp[i].plane = NULL;
    }
}

int dsn_jpeg_header(const uint8_t *data, int64_t len, int32_t *dims, char *err, int errlen) {
    Decoder d;
    memset(&d, 0, sizeof d);
    d.data = data;
    d.len = (size_t)len;
    d.err = err;
    d.errlen = errlen;
    int rc = parse(&d, 1);
    if (rc) return rc;
    if (!d.sof_seen) return fail(&d, "no SOF marker", 2);
    dims[0] = d.height;
    dims[1] = d.width;
    dims[2] = d.ncomp;
    return 0;
}

int dsn_jpeg_decode(const uint8_t *data, int64_t len, uint8_t *out, char *err, int errlen) {
    Decoder d;
    memset(&d, 0, sizeof d);
    d.data = data;
    d.len = (size_t)len;
    d.err = err;
    d.errlen = errlen;
    int rc = parse(&d, 0);
    if (rc) {
        free_planes(&d);
        return rc;
    }
    for (int i = 0; i < d.ncomp; i++) {
        if (!d.comp[i].plane) {
            free_planes(&d);
            return fail(&d, "a component has no scan", 2);
        }
    }
    int W = d.width, H = d.height;
    /* full-size planes, rows padded to hmax * 8 * mcux samples */
    int ow = d.mcux * d.hmax * 8, oh = H;
    uint8_t *full[MAX_COMPS] = {0};
    for (int i = 0; i < d.ncomp; i++) {
        full[i] = (uint8_t *)malloc((size_t)ow * (size_t)oh);
        if (!full[i] || !upsample(&d, &d.comp[i], full[i], ow, oh)) {
            for (int j = 0; j <= i; j++) free(full[j]);
            free_planes(&d);
            return fail(&d, full[i] ? "non-integral sampling ratio" : "out of memory", 3);
        }
    }
    if (d.ncomp == 1) {
        for (int y = 0; y < H; y++) {
            const uint8_t *g = full[0] + (size_t)y * ow;
            uint8_t *o = out + (size_t)y * W * 3;
            for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
        }
    } else {
        /* jdapimin.c default_decompress_parms: JFIF -> YCbCr; Adobe
         * transform 0 -> RGB; otherwise component ids 'R','G','B' -> RGB */
        int rgb = 0;
        if (!d.jfif) {
            if (d.adobe)
                rgb = d.adobe_transform == 0;
            else
                rgb = d.comp[0].id == 'R' && d.comp[1].id == 'G' && d.comp[2].id == 'B';
        }
        for (int y = 0; y < H; y++) {
            const uint8_t *p0 = full[0] + (size_t)y * ow;
            const uint8_t *p1 = full[1] + (size_t)y * ow;
            const uint8_t *p2 = full[2] + (size_t)y * ow;
            uint8_t *o = out + (size_t)y * W * 3;
            if (rgb) {
                for (int x = 0; x < W; x++) {
                    o[3 * x] = p2[x];
                    o[3 * x + 1] = p1[x];
                    o[3 * x + 2] = p0[x];
                }
                continue;
            }
            for (int x = 0; x < W; x++) {
                int yy = p0[x], cb = p1[x], cr = p2[x];
                o[3 * x + 2] = sample_limit[yy + cr_r_tab[cr]];
                o[3 * x + 1] = sample_limit[yy + (int)((cb_g_tab[cb] + cr_g_tab[cr]) >> 16)];
                o[3 * x] = sample_limit[yy + cb_b_tab[cb]];
            }
        }
    }
    for (int i = 0; i < d.ncomp; i++) free(full[i]);
    free_planes(&d);
    return 0;
}
