/* Baseline JPEG decode and encode on the host, in libjpeg-turbo's arithmetic.
 *
 * The decoder reads sequential Huffman JPEG (SOF0, and SOF1 at 8-bit
 * precision) of one or three components, at any integral sampling factors,
 * with restart intervals and any number of DQT/DHT segments and scans, and
 * writes RGB as libjpeg-turbo's defaults do (JDCT_ISLOW, fancy upsampling,
 * the fixed-point YCbCr tables):
 *   - jidctint.c's integer IDCT with its range-limit table;
 *   - jdsample.c's triangle upsampling for h2v1, h1v2 and h2v2 (h2v1 and h2v2
 *     only on planes wider than two samples), replication otherwise;
 *   - jdcolor.c's YCbCr->RGB tables; gray repeated to three channels.
 * A stream that ends early or holds a bad code is an error (libjpeg pads it
 * with zeros and warns). The encoder writes baseline 4:2:0 JPEG as
 * libjpeg-turbo's jpeg_set_defaults + jpeg_set_quality(q, TRUE) does: the
 * scaled standard tables, jccolor.c's RGB->YCbCr, jcsample.c's h2v2
 * downsampling with its alternating bias, jfdctint.c's integer DCT, the
 * standard Huffman tables and a JFIF header.
 *
 * Plain C with a C interface (ctypes), built with the host compiler by
 * ops/_build.py. Its only global state is two constant tables, filled when
 * the library loads, so threads may call it at once.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define JPEG_OK 0
#define JPEG_UNSUPPORTED 1
#define JPEG_CORRUPT 2

typedef struct {
  int code;
  char msg[200];
} jerr_t;

static int set_err(jerr_t *e, int code, const char *msg, long offset) {
  if (e->code == JPEG_OK) {
    e->code = code;
    if (offset >= 0)
      snprintf(e->msg, sizeof(e->msg), "%s at byte offset %ld", msg, offset);
    else
      snprintf(e->msg, sizeof(e->msg), "%s", msg);
  }
  return code;
}

static const int ZIGZAG[64] = { /* zig-zag index -> natural index */
  0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
  35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
  58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* ------------------------------------------------------------------------ */
/* Huffman tables                                                           */
/* ------------------------------------------------------------------------ */
#define LOOK 9

typedef struct {
  uint8_t bits[17];
  uint8_t vals[256];
  int defined;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << LOOK]; /* (size << 8) | value; size 0: not in LOOK bits */
} dhuff_t;

static int huff_codes(const uint8_t *bits, uint16_t *code, uint8_t *size) {
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) size[p++] = (uint8_t)l;
  size[p] = 0;
  int n = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = (uint16_t)c++;
    if (c >= (1u << si)) return -1;
    c <<= 1;
    si++;
  }
  return n;
}

static int dhuff_derive(dhuff_t *t) {
  uint16_t code[257];
  uint8_t size[257];
  int n = huff_codes(t->bits, code, size);
  if (n < 0) return -1;
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t->bits[l]) {
      t->valoffset[l] = p - code[p];
      p += t->bits[l];
      t->maxcode[l] = code[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0x7FFFFFFF;
  memset(t->look, 0, sizeof(t->look));
  for (int i = 0; i < n; i++) {
    if (size[i] <= LOOK) {
      int shift = LOOK - size[i];
      int base = code[i] << shift;
      for (int j = 0; j < (1 << shift); j++)
        t->look[base + j] = (uint16_t)((size[i] << 8) | t->vals[i]);
    }
  }
  t->defined = 1;
  return 0;
}

/* ------------------------------------------------------------------------ */
/* Bit reader over entropy-coded data                                       */
/* ------------------------------------------------------------------------ */
typedef struct {
  const uint8_t *d;
  size_t n, pos;
  uint64_t buf; /* next bits at the top */
  int bits;     /* bits in buf, the padding included */
  int pad;      /* zero bits past the data (a marker or the end), at the tail */
  int at_marker;
} breader_t;

/* the reader runs out of data at the end of the buffer as at a marker */
static inline void br_refill(breader_t *b) {
  if (b->bits > 56) return;
  while (b->bits <= 56) {
    unsigned c = 0;
    if (!b->at_marker) {
      if (b->pos >= b->n) {
        b->at_marker = 1;
      } else {
        c = b->d[b->pos];
        if (c == 0xFF) {
          if (b->pos + 1 < b->n && b->d[b->pos + 1] == 0x00) {
            b->pos += 2;
          } else {
            b->at_marker = 1;
            c = 0;
          }
        } else {
          b->pos++;
        }
      }
    }
    if (b->at_marker) b->pad += 8;
    b->buf |= (uint64_t)c << (56 - b->bits);
    b->bits += 8;
  }
}

static inline int br_consume(breader_t *b, int n, jerr_t *e) {
  b->buf <<= n;
  b->bits -= n;
  if (b->bits < b->pad)
    return set_err(e, JPEG_CORRUPT, "JPEG stream ends early or is corrupt (entropy data ran out)",
                   (long)b->pos);
  return 0;
}

static inline int br_get(breader_t *b, int n, int *out, jerr_t *e) {
  if (n == 0) {
    *out = 0;
    return 0;
  }
  br_refill(b);
  *out = (int)(b->buf >> (64 - n));
  return br_consume(b, n, e);
}

static inline int br_decode(breader_t *b, const dhuff_t *t, int *sym, jerr_t *e) {
  br_refill(b);
  unsigned look = (unsigned)(b->buf >> (64 - LOOK));
  unsigned ent = t->look[look];
  if (ent >> 8) {
    *sym = ent & 0xFF;
    return br_consume(b, ent >> 8, e);
  }
  uint32_t peek = (uint32_t)(b->buf >> 48);
  for (int l = LOOK + 1; l <= 16; l++) {
    int32_t code = (int32_t)(peek >> (16 - l));
    if (code <= t->maxcode[l]) {
      *sym = t->vals[(code + t->valoffset[l]) & 0xFF];
      return br_consume(b, l, e);
    }
  }
  return set_err(e, JPEG_CORRUPT, "corrupt JPEG data: bad Huffman code", (long)b->pos);
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

/* ------------------------------------------------------------------------ */
/* IDCT: jidctint.c (jpeg_idct_islow)                                       */
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

static uint8_t RANGE_LIMIT[1024]; /* post-IDCT: index (x & 1023), x + 128 clamped */
static uint8_t CLAMP_TAB[256 * 3]; /* CLAMP_TAB[256 + x] = clamp(x, 0, 255) */

/* filled when the library is loaded, before any thread can call it */
__attribute__((constructor)) static void init_tables(void) {
  for (int i = 0; i < 1024; i++) {
    int x = i < 512 ? i : i - 1024;
    int v = x + 128;
    RANGE_LIMIT[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
  }
  for (int i = 0; i < 768; i++) {
    int v = i - 256;
    CLAMP_TAB[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
  }
}

static void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out, int stride) {
  int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *in = coef + c;
    const uint16_t *qp = q + c;
    int *w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = (int)((int32_t)in[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
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
  for (int r = 0; r < 8; r++) {
    const int *w = ws + 8 * r;
    uint8_t *o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t dc = RANGE_LIMIT[(int)DESCALE((int64_t)w[0], PASS1_BITS + 3) & 1023];
      memset(o, dc, 8);
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
#define OUT(x) RANGE_LIMIT[(int)DESCALE(x, CONST_BITS + PASS1_BITS + 3) & 1023]
    o[0] = OUT(tmp10 + tmp3);
    o[7] = OUT(tmp10 - tmp3);
    o[1] = OUT(tmp11 + tmp2);
    o[6] = OUT(tmp11 - tmp2);
    o[2] = OUT(tmp12 + tmp1);
    o[5] = OUT(tmp12 - tmp1);
    o[3] = OUT(tmp13 + tmp0);
    o[4] = OUT(tmp13 - tmp0);
#undef OUT
  }
}

/* ------------------------------------------------------------------------ */
/* Decoder                                                                  */
/* ------------------------------------------------------------------------ */
typedef struct {
  int id, h, v, tq;
  int dw, dh;      /* downsampled size: ceil(W * h / hmax), ceil(H * v / vmax) */
  int pw, ph;      /* plane size, padded to the MCU grid */
  uint8_t *plane;
  uint16_t q[64];  /* natural order, latched at the component's scan */
  int scanned;
  int pred;
} jcomp_t;

typedef struct {
  const uint8_t *d;
  size_t n;
  uint16_t qt[4][64];
  int qt_defined[4];
  dhuff_t dc[4], ac[4];
  int restart;
  int width, height, ncomp, hmax, vmax, mcux, mcuy;
  int sof;
  jcomp_t comp[3];
  int saw_jfif, saw_adobe, adobe_transform;
} jdec_t;

static int seg_len(jdec_t *j, size_t pos, size_t *len, jerr_t *e) {
  if (pos + 4 > j->n) return set_err(e, JPEG_CORRUPT, "JPEG stream ends early", (long)pos);
  size_t l = ((size_t)j->d[pos + 2] << 8) | j->d[pos + 3];
  if (l < 2 || pos + 2 + l > j->n)
    return set_err(e, JPEG_CORRUPT, "JPEG stream ends early (marker segment cut)", (long)pos);
  *len = l;
  return 0;
}

static int parse_dqt(jdec_t *j, size_t p, size_t end, jerr_t *e) {
  while (p < end) {
    int pq = j->d[p] >> 4, tq = j->d[p] & 15;
    p++;
    if (tq > 3) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: DQT table id", (long)p);
    size_t need = pq ? 128 : 64;
    if (p + need > end) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: DQT length", (long)p);
    for (int k = 0; k < 64; k++) {
      unsigned v = pq ? ((unsigned)j->d[p + 2 * k] << 8) | j->d[p + 2 * k + 1] : j->d[p + k];
      j->qt[tq][ZIGZAG[k]] = (uint16_t)v;
    }
    j->qt_defined[tq] = 1;
    p += need;
  }
  return 0;
}

static int parse_dht(jdec_t *j, size_t p, size_t end, jerr_t *e) {
  while (p < end) {
    if (p + 17 > end) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: DHT length", (long)p);
    int tc = j->d[p] >> 4, th = j->d[p] & 15;
    if (tc > 1 || th > 3) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: DHT class or id", (long)p);
    dhuff_t *t = tc ? &j->ac[th] : &j->dc[th];
    int count = 0;
    t->bits[0] = 0;
    for (int l = 1; l <= 16; l++) {
      t->bits[l] = j->d[p + l];
      count += t->bits[l];
    }
    p += 17;
    if (count > 256 || p + (size_t)count > end)
      return set_err(e, JPEG_CORRUPT, "corrupt JPEG: DHT symbol count", (long)p);
    memset(t->vals, 0, sizeof(t->vals));
    memcpy(t->vals, j->d + p, (size_t)count);
    p += (size_t)count;
    if (dhuff_derive(t)) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: bad Huffman table", (long)p);
  }
  return 0;
}

static const char *sof_variant(int m) {
  switch (m) {
    case 0xC2: return "progressive JPEG (SOF2)";
    case 0xC3: return "lossless JPEG (SOF3)";
    case 0xC5: return "hierarchical JPEG (SOF5)";
    case 0xC6: return "hierarchical progressive JPEG (SOF6)";
    case 0xC7: return "hierarchical lossless JPEG (SOF7)";
    case 0xC9: return "arithmetic-coded JPEG (SOF9)";
    case 0xCA: return "arithmetic-coded progressive JPEG (SOF10)";
    case 0xCB: return "arithmetic-coded lossless JPEG (SOF11)";
    case 0xCD: return "arithmetic-coded hierarchical JPEG (SOF13)";
    case 0xCE: return "arithmetic-coded hierarchical progressive JPEG (SOF14)";
    case 0xCF: return "arithmetic-coded hierarchical lossless JPEG (SOF15)";
    default: return NULL;
  }
}

static int parse_sof(jdec_t *j, int m, size_t p, size_t end, jerr_t *e) {
  const char *var = sof_variant(m);
  if (var) return set_err(e, JPEG_UNSUPPORTED, var, -1);
  if (j->sof) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: a second SOF", (long)p);
  if (p + 6 > end) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: SOF length", (long)p);
  int prec = j->d[p];
  j->height = (j->d[p + 1] << 8) | j->d[p + 2];
  j->width = (j->d[p + 3] << 8) | j->d[p + 4];
  j->ncomp = j->d[p + 5];
  if (prec != 8) {
    char msg[64];
    snprintf(msg, sizeof(msg), "%d-bit JPEG (SOF%d)", prec, m - 0xC0);
    return set_err(e, JPEG_UNSUPPORTED, msg, -1);
  }
  if (j->ncomp == 4) return set_err(e, JPEG_UNSUPPORTED, "4-component JPEG (CMYK or YCCK)", -1);
  if (j->ncomp != 1 && j->ncomp != 3) {
    char msg[64];
    snprintf(msg, sizeof(msg), "%d-component JPEG", j->ncomp);
    return set_err(e, JPEG_UNSUPPORTED, msg, -1);
  }
  if (j->height == 0) return set_err(e, JPEG_UNSUPPORTED, "JPEG with its height in a DNL marker", -1);
  if (j->width == 0) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: zero width", (long)p);
  if (p + 6 + 3 * (size_t)j->ncomp > end) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: SOF length", (long)p);
  j->hmax = j->vmax = 1;
  for (int c = 0; c < j->ncomp; c++) {
    jcomp_t *k = &j->comp[c];
    memset(k, 0, sizeof(*k));
    k->id = j->d[p + 6 + 3 * c];
    k->h = j->d[p + 7 + 3 * c] >> 4;
    k->v = j->d[p + 7 + 3 * c] & 15;
    k->tq = j->d[p + 8 + 3 * c];
    if (k->h < 1 || k->h > 4 || k->v < 1 || k->v > 4 || k->tq > 3)
      return set_err(e, JPEG_CORRUPT, "corrupt JPEG: sampling factor or table id", (long)p);
    if (k->h > j->hmax) j->hmax = k->h;
    if (k->v > j->vmax) j->vmax = k->v;
  }
  j->sof = m;
  return 0;
}

static void layout(jdec_t *j) {
  j->mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
  j->mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
  for (int c = 0; c < j->ncomp; c++) {
    jcomp_t *k = &j->comp[c];
    k->dw = (int)(((int64_t)j->width * k->h + j->hmax - 1) / j->hmax);
    k->dh = (int)(((int64_t)j->height * k->v + j->vmax - 1) / j->vmax);
    k->pw = j->mcux * k->h * 8;
    k->ph = j->mcuy * k->v * 8;
  }
}

/* the header up to the first SOS: tables, restart interval, frame, markers */
static int parse_header(jdec_t *j, size_t *pos_out, jerr_t *e) {
  if (j->n < 4 || j->d[0] != 0xFF || j->d[1] != 0xD8)
    return set_err(e, JPEG_CORRUPT, "not a JPEG stream (no SOI)", 0);
  size_t p = 2;
  for (;;) {
    while (p < j->n && j->d[p] != 0xFF) p++; /* libjpeg skips stray bytes too */
    while (p + 1 < j->n && j->d[p + 1] == 0xFF) p++;
    if (p + 1 >= j->n) return set_err(e, JPEG_CORRUPT, "JPEG stream ends early (no SOS)", (long)p);
    int m = j->d[p + 1];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      p += 2;
      continue;
    }
    if (m == 0xD9) return set_err(e, JPEG_CORRUPT, "JPEG stream ends early (EOI before SOS)", (long)p);
    size_t len;
    if (seg_len(j, p, &len, e)) return e->code;
    size_t body = p + 4, end = p + 2 + len;
    if (m == 0xDB) {
      if (parse_dqt(j, body, end, e)) return e->code;
    } else if (m == 0xC4) {
      if (parse_dht(j, body, end, e)) return e->code;
    } else if (m == 0xCC) {
      return set_err(e, JPEG_UNSUPPORTED, "arithmetic-coded JPEG (DAC)", -1);
    } else if (m == 0xDD) {
      if (len != 4) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: DRI length", (long)p);
      j->restart = (j->d[body] << 8) | j->d[body + 1];
    } else if (m >= 0xC0 && m <= 0xCF) {
      if (parse_sof(j, m, body, end, e)) return e->code;
    } else if (m == 0xE0) {
      if (len >= 7 && memcmp(j->d + body, "JFIF\0", 5) == 0) j->saw_jfif = 1;
    } else if (m == 0xEE) {
      if (len >= 14 && memcmp(j->d + body, "Adobe", 5) == 0) {
        j->saw_adobe = 1;
        j->adobe_transform = j->d[body + 11];
      }
    } else if (m == 0xDA) {
      if (!j->sof) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: SOS before SOF", (long)p);
      *pos_out = p;
      return 0;
    } else if (m == 0xDC) {
      return set_err(e, JPEG_UNSUPPORTED, "JPEG with a DNL marker", -1);
    }
    p = end;
  }
}

static int decode_block(breader_t *b, const dhuff_t *dc, const dhuff_t *ac, int *pred,
                        int16_t *coef, jerr_t *e) {
  int s, v;
  memset(coef, 0, 64 * sizeof(int16_t));
  if (br_decode(b, dc, &s, e)) return e->code;
  if (s > 15) return set_err(e, JPEG_CORRUPT, "corrupt JPEG data: DC size", (long)b->pos);
  int diff = 0;
  if (s) {
    if (br_get(b, s, &v, e)) return e->code;
    diff = extend(v, s);
  }
  *pred += diff;
  coef[0] = (int16_t)*pred;
  for (int k = 1; k < 64; k++) {
    int rs;
    if (br_decode(b, ac, &rs, e)) return e->code;
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) return set_err(e, JPEG_CORRUPT, "corrupt JPEG data: AC run past the block", (long)b->pos);
      if (br_get(b, s, &v, e)) return e->code;
      coef[ZIGZAG[k]] = (int16_t)extend(v, s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return 0;
}

/* one scan from the SOS at p; -> the position after its entropy data */
static int decode_scan(jdec_t *j, size_t p, size_t *next, jerr_t *e) {
  size_t len;
  if (seg_len(j, p, &len, e)) return e->code;
  size_t body = p + 4;
  int ns = j->d[body];
  if (ns < 1 || ns > j->ncomp || len != 6 + 2 * (size_t)ns)
    return set_err(e, JPEG_CORRUPT, "corrupt JPEG: SOS component count", (long)p);
  jcomp_t *sc[3];
  int dct[3], act[3];
  for (int i = 0; i < ns; i++) {
    int id = j->d[body + 1 + 2 * i], t = j->d[body + 2 + 2 * i];
    sc[i] = NULL;
    for (int c = 0; c < j->ncomp; c++)
      if (j->comp[c].id == id) sc[i] = &j->comp[c];
    if (!sc[i]) return set_err(e, JPEG_CORRUPT, "corrupt JPEG: SOS names an unknown component", (long)p);
    dct[i] = t >> 4;
    act[i] = t & 15;
    if (dct[i] > 3 || act[i] > 3 || !j->dc[dct[i]].defined || !j->ac[act[i]].defined)
      return set_err(e, JPEG_CORRUPT, "corrupt JPEG: SOS names an undefined Huffman table", (long)p);
    if (!j->qt_defined[sc[i]->tq])
      return set_err(e, JPEG_CORRUPT, "corrupt JPEG: undefined quantization table", (long)p);
    memcpy(sc[i]->q, j->qt[sc[i]->tq], sizeof(sc[i]->q)); /* latched at the scan */
    sc[i]->pred = 0;
    if (!sc[i]->plane) {
      sc[i]->plane = (uint8_t *)calloc((size_t)sc[i]->pw * sc[i]->ph, 1);
      if (!sc[i]->plane) return set_err(e, JPEG_CORRUPT, "out of memory", -1);
    }
  }
  int ss = j->d[body + 1 + 2 * ns], se = j->d[body + 2 + 2 * ns], a = j->d[body + 3 + 2 * ns];
  if (ss != 0 || se != 63 || a != 0)
    return set_err(e, JPEG_CORRUPT, "corrupt JPEG: spectral selection in a sequential scan", (long)p);
  breader_t b;
  memset(&b, 0, sizeof(b));
  b.d = j->d;
  b.n = j->n;
  b.pos = p + 2 + len;
  int16_t coef[64];
  long units_x, units_y;
  if (ns == 1) {
    units_x = (sc[0]->dw + 7) / 8;
    units_y = (sc[0]->dh + 7) / 8;
  } else {
    units_x = j->mcux;
    units_y = j->mcuy;
  }
  long total = units_x * units_y, left = j->restart;
  int rst = 0;
  for (long u = 0; u < total; u++) {
    if (j->restart && left == 0) {
      /* byte-align, then the RSTn marker */
      b.buf = 0;
      b.bits = 0;
      b.pad = 0;
      b.at_marker = 0;
      size_t q = b.pos;
      while (q + 1 < j->n && j->d[q] == 0xFF && j->d[q + 1] == 0xFF) q++;
      if (q + 1 >= j->n || j->d[q] != 0xFF || j->d[q + 1] != 0xD0 + rst)
        return set_err(e, JPEG_CORRUPT, "corrupt JPEG data: expected a restart marker", (long)q);
      b.pos = q + 2;
      rst = (rst + 1) & 7;
      left = j->restart;
      for (int i = 0; i < ns; i++) sc[i]->pred = 0;
    }
    long ux = u % units_x, uy = u / units_x;
    for (int i = 0; i < ns; i++) {
      jcomp_t *k = sc[i];
      int bh = ns == 1 ? 1 : k->h, bv = ns == 1 ? 1 : k->v;
      for (int y = 0; y < bv; y++)
        for (int x = 0; x < bh; x++) {
          if (decode_block(&b, &j->dc[dct[i]], &j->ac[act[i]], &k->pred, coef, e)) return e->code;
          size_t row = (size_t)(uy * bv + y) * 8, col = (size_t)(ux * bh + x) * 8;
          idct_islow(coef, k->q, k->plane + row * k->pw + col, k->pw);
        }
    }
    if (j->restart) left--;
  }
  for (int i = 0; i < ns; i++) sc[i]->scanned = 1;
  /* past the entropy data: to the next marker */
  size_t q = b.pos;
  while (q + 1 < j->n && !(j->d[q] == 0xFF && j->d[q + 1] != 0 && j->d[q + 1] != 0xFF &&
                           !(j->d[q + 1] >= 0xD0 && j->d[q + 1] <= 0xD7)))
    q++;
  *next = q;
  return 0;
}

/* one component's plane upsampled to the image: [H, W] */
static void upsample(const jdec_t *j, const jcomp_t *k, uint8_t *out) {
  int W = j->width, H = j->height, hr = j->hmax / k->h, vr = j->vmax / k->v;
  int dw = k->dw, dh = k->dh, pw = k->pw;
  const uint8_t *pl = k->plane;
  if (hr == 1 && vr == 1) {
    for (int y = 0; y < H; y++) memcpy(out + (size_t)y * W, pl + (size_t)y * pw, (size_t)W);
    return;
  }
  if (hr == 2 && vr == 1 && dw > 2) { /* h2v1_fancy_upsample */
    for (int y = 0; y < H; y++) {
      const uint8_t *in = pl + (size_t)y * pw;
      uint8_t *o = out + (size_t)y * W;
      for (int x = 0; x < dw; x++) {
        int v3 = in[x] * 3;
        int l = in[x > 0 ? x - 1 : 0], r = in[x + 1 < dw ? x + 1 : dw - 1];
        if (2 * x < W) o[2 * x] = (uint8_t)((v3 + l + 1) >> 2);
        if (2 * x + 1 < W) o[2 * x + 1] = (uint8_t)((v3 + r + 2) >> 2);
      }
    }
    return;
  }
  if (hr == 1 && vr == 2) { /* h1v2_fancy_upsample */
    for (int y = 0; y < H; y++) {
      int iy = y >> 1;
      int ny = (y & 1) ? (iy + 1 < dh ? iy + 1 : dh - 1) : (iy > 0 ? iy - 1 : 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t *i0 = pl + (size_t)iy * pw, *i1 = pl + (size_t)ny * pw;
      uint8_t *o = out + (size_t)y * W;
      for (int x = 0; x < W; x++) o[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
    }
    return;
  }
  if (hr == 2 && vr == 2 && dw > 2) { /* h2v2_fancy_upsample */
    int *cs = (int *)malloc(sizeof(int) * (size_t)dw);
    for (int y = 0; y < H; y++) {
      int iy = y >> 1;
      int ny = (y & 1) ? (iy + 1 < dh ? iy + 1 : dh - 1) : (iy > 0 ? iy - 1 : 0);
      const uint8_t *i0 = pl + (size_t)iy * pw, *i1 = pl + (size_t)ny * pw;
      uint8_t *o = out + (size_t)y * W;
      for (int x = 0; x < dw; x++) cs[x] = i0[x] * 3 + i1[x];
      for (int x = 0; x < dw; x++) {
        int t = cs[x] * 3, l = cs[x > 0 ? x - 1 : 0], r = cs[x + 1 < dw ? x + 1 : dw - 1];
        if (2 * x < W) o[2 * x] = (uint8_t)((t + l + 8) >> 4);
        if (2 * x + 1 < W) o[2 * x + 1] = (uint8_t)((t + r + 7) >> 4);
      }
    }
    free(cs);
    return;
  }
  /* replication: h2v1_upsample, h2v2_upsample and int_upsample */
  for (int y = 0; y < H; y++) {
    const uint8_t *in = pl + (size_t)(y / vr) * pw;
    uint8_t *o = out + (size_t)y * W;
    for (int x = 0; x < W; x++) o[x] = in[x / hr];
  }
}

/* jdcolor.c's tables */
#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static void ycc_rgb(const uint8_t *y, const uint8_t *cb, const uint8_t *cr, uint8_t *rgb, size_t n) {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0, x = -128; i < 256; i++, x++) {
    cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = (-FIX(0.71414)) * x;
    cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
  }
  const uint8_t *cl = CLAMP_TAB + 256;
  for (size_t i = 0; i < n; i++) {
    int Y = y[i], Cb = cb[i], Cr = cr[i];
    rgb[3 * i] = cl[Y + cr_r[Cr]];
    rgb[3 * i + 1] = cl[Y + (int)((cb_g[Cb] + cr_g[Cr]) >> SCALEBITS)];
    rgb[3 * i + 2] = cl[Y + cb_b[Cb]];
  }
}

static void dec_free(jdec_t *j) {
  for (int c = 0; c < 3; c++) {
    free(j->comp[c].plane);
    j->comp[c].plane = NULL;
  }
}

/* -> 0 and the image's size; else an error code and message */
int jpeg_header(const uint8_t *data, size_t n, int *height, int *width, char *msg, int msglen) {
  jerr_t e = {0, {0}};
  jdec_t *j = (jdec_t *)calloc(1, sizeof(jdec_t));
  size_t sos;
  j->d = data;
  j->n = n;
  if (parse_header(j, &sos, &e) == 0) {
    *height = j->height;
    *width = j->width;
  }
  free(j);
  snprintf(msg, (size_t)msglen, "%s", e.msg);
  return e.code;
}

/* decode into rgb [height, width, 3] (the size jpeg_header gave) */
int jpeg_decode(const uint8_t *data, size_t n, uint8_t *rgb, char *msg, int msglen) {
  jerr_t e = {0, {0}};
  jdec_t *j = (jdec_t *)calloc(1, sizeof(jdec_t));
  uint8_t *full = NULL;
  size_t p;
  j->d = data;
  j->n = n;
  if (parse_header(j, &p, &e)) goto done;
  for (int c = 0; c < j->ncomp; c++)
    if (j->hmax % j->comp[c].h || j->vmax % j->comp[c].v) {
      set_err(&e, JPEG_UNSUPPORTED, "JPEG with fractional sampling factors", -1);
      goto done;
    }
  layout(j);
  for (;;) {
    size_t next = 0;
    if (decode_scan(j, p, &next, &e)) goto done;
    /* further scans (non-interleaved components) and tables before them */
    p = next;
    int more = 0;
    while (p + 1 < j->n) {
      int m = j->d[p + 1];
      if (m == 0xD9) break;
      size_t len;
      if (m >= 0xD0 && m <= 0xD7) {
        p += 2;
        continue;
      }
      if (seg_len(j, p, &len, &e)) goto done;
      size_t body = p + 4, end = p + 2 + len;
      if (m == 0xDA) {
        more = 1;
        break;
      } else if (m == 0xDB) {
        if (parse_dqt(j, body, end, &e)) goto done;
      } else if (m == 0xC4) {
        if (parse_dht(j, body, end, &e)) goto done;
      } else if (m == 0xDD) {
        j->restart = (j->d[body] << 8) | j->d[body + 1];
      } else if (m == 0xDC) {
        set_err(&e, JPEG_UNSUPPORTED, "JPEG with a DNL marker", -1);
        goto done;
      }
      p = end;
      while (p < j->n && j->d[p] != 0xFF) p++;
      while (p + 1 < j->n && j->d[p + 1] == 0xFF) p++;
    }
    if (!more) break;
  }
  for (int c = 0; c < j->ncomp; c++)
    if (!j->comp[c].scanned) {
      set_err(&e, JPEG_CORRUPT, "JPEG stream ends early (a component has no scan)", (long)p);
      goto done;
    }
  {
    size_t px = (size_t)j->width * j->height;
    full = (uint8_t *)malloc(px * (size_t)j->ncomp);
    for (int c = 0; c < j->ncomp; c++) upsample(j, &j->comp[c], full + px * c);
    int rgb_space = 0;
    if (j->ncomp == 3) {
      if (j->saw_jfif) rgb_space = 0;
      else if (j->saw_adobe) rgb_space = j->adobe_transform == 0;
      else rgb_space = j->comp[0].id == 82 && j->comp[1].id == 71 && j->comp[2].id == 66;
    }
    if (j->ncomp == 1) {
      for (size_t i = 0; i < px; i++) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = full[i];
    } else if (rgb_space) {
      for (size_t i = 0; i < px; i++) {
        rgb[3 * i] = full[i];
        rgb[3 * i + 1] = full[px + i];
        rgb[3 * i + 2] = full[2 * px + i];
      }
    } else {
      ycc_rgb(full, full + px, full + 2 * px, rgb, px);
    }
  }
done:
  free(full);
  dec_free(j);
  free(j);
  snprintf(msg, (size_t)msglen, "%s", e.msg);
  return e.code;
}

/* ------------------------------------------------------------------------ */
/* Encoder                                                                  */
/* ------------------------------------------------------------------------ */
static const unsigned STD_LUMA_Q[64] = {
  16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
  14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
  18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
  49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const unsigned STD_CHROMA_Q[64] = {
  17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
  24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
  99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
  99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

static const uint8_t DC_LUMA_BITS[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t DC_CHROMA_BITS[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t AC_LUMA_BITS[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t AC_LUMA_VALS[162] = {
  0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
  0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
  0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
  0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
  0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
  0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
  0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
  0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
  0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
  0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
  0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t AC_CHROMA_BITS[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t AC_CHROMA_VALS[162] = {
  0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
  0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
  0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
  0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
  0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
  0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
  0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
  0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
  0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
  0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
  0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
  uint16_t code[256];
  uint8_t size[256];
} ehuff_t;

static void ehuff_derive(const uint8_t *bits17, const uint8_t *vals, ehuff_t *t) {
  uint8_t bits[17];
  memcpy(bits, bits17, 17);
  uint16_t code[257];
  uint8_t size[257];
  int n = huff_codes(bits, code, size);
  memset(t, 0, sizeof(*t));
  for (int i = 0; i < n; i++) {
    t->code[vals[i]] = code[i];
    t->size[vals[i]] = size[i];
  }
}

typedef struct {
  uint8_t *d;
  size_t n, cap;
  uint64_t acc;
  int nbits;
  int oom;
} bwriter_t;

static void put_byte(bwriter_t *w, uint8_t c) {
  if (w->n == w->cap) {
    size_t cap = w->cap ? 2 * w->cap : 65536;
    uint8_t *d = (uint8_t *)realloc(w->d, cap);
    if (!d) {
      w->oom = 1;
      return;
    }
    w->d = d;
    w->cap = cap;
  }
  w->d[w->n++] = c;
}

static void put_bytes(bwriter_t *w, const uint8_t *p, size_t n) {
  for (size_t i = 0; i < n; i++) put_byte(w, p[i]);
}

static void put_bits(bwriter_t *w, uint32_t v, int n) {
  if (n == 0) return;
  w->acc = (w->acc << n) | (v & ((1u << n) - 1));
  w->nbits += n;
  while (w->nbits >= 8) {
    uint8_t c = (uint8_t)(w->acc >> (w->nbits - 8));
    put_byte(w, c);
    if (c == 0xFF) put_byte(w, 0);
    w->nbits -= 8;
  }
}

static void put_marker(bwriter_t *w, int m, const uint8_t *body, size_t len) {
  uint8_t h[4] = {0xFF, (uint8_t)m, (uint8_t)((len + 2) >> 8), (uint8_t)((len + 2) & 0xFF)};
  put_bytes(w, h, 4);
  put_bytes(w, body, len);
}

static int quality_scaling(int quality) { /* jpeg_quality_scaling */
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  return quality < 50 ? 5000 / quality : 200 - quality * 2;
}

/* the quantization tables of jpeg_set_quality(quality, TRUE), natural order */
static void jpeg_quant_tables(int quality, uint16_t *luma, uint16_t *chroma) {
  int scale = quality_scaling(quality);
  for (int i = 0; i < 64; i++) {
    long l = ((long)STD_LUMA_Q[i] * scale + 50L) / 100L;
    long c = ((long)STD_CHROMA_Q[i] * scale + 50L) / 100L;
    l = l <= 0 ? 1 : l > 255 ? 255 : l;
    c = c <= 0 ? 1 : c > 255 ? 255 : c;
    luma[i] = (uint16_t)l;
    chroma[i] = (uint16_t)c;
  }
}

/* jfdctint.c (jpeg_fdct_islow) on level-shifted samples, in place */
static void fdct_islow(int32_t *data) {
  int64_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7, tmp10, tmp11, tmp12, tmp13;
  int64_t z1, z2, z3, z4, z5;
  for (int pass = 0; pass < 2; pass++) {
    for (int i = 0; i < 8; i++) {
      int32_t *d = pass == 0 ? data + 8 * i : data + i;
      int st = pass == 0 ? 1 : 8;
      tmp0 = d[0] + d[7 * st];
      tmp7 = d[0] - d[7 * st];
      tmp1 = d[st] + d[6 * st];
      tmp6 = d[st] - d[6 * st];
      tmp2 = d[2 * st] + d[5 * st];
      tmp5 = d[2 * st] - d[5 * st];
      tmp3 = d[3 * st] + d[4 * st];
      tmp4 = d[3 * st] - d[4 * st];
      tmp10 = tmp0 + tmp3;
      tmp13 = tmp0 - tmp3;
      tmp11 = tmp1 + tmp2;
      tmp12 = tmp1 - tmp2;
      int sh = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
      if (pass == 0) {
        d[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
        d[4 * st] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
      } else {
        d[0] = (int32_t)DESCALE(tmp10 + tmp11, PASS1_BITS);
        d[4 * st] = (int32_t)DESCALE(tmp10 - tmp11, PASS1_BITS);
      }
      z1 = (tmp12 + tmp13) * FIX_0_541196100;
      d[2 * st] = (int32_t)DESCALE(z1 + tmp13 * FIX_0_765366865, sh);
      d[6 * st] = (int32_t)DESCALE(z1 + tmp12 * (-FIX_1_847759065), sh);
      z1 = tmp4 + tmp7;
      z2 = tmp5 + tmp6;
      z3 = tmp4 + tmp6;
      z4 = tmp5 + tmp7;
      z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 = tmp4 * FIX_0_298631336;
      tmp5 = tmp5 * FIX_2_053119869;
      tmp6 = tmp6 * FIX_3_072711026;
      tmp7 = tmp7 * FIX_1_501321110;
      z1 = z1 * (-FIX_0_899976223);
      z2 = z2 * (-FIX_2_562915447);
      z3 = z3 * (-FIX_1_961570560);
      z4 = z4 * (-FIX_0_390180644);
      z3 += z5;
      z4 += z5;
      d[7 * st] = (int32_t)DESCALE(tmp4 + z1 + z3, sh);
      d[5 * st] = (int32_t)DESCALE(tmp5 + z2 + z4, sh);
      d[3 * st] = (int32_t)DESCALE(tmp6 + z2 + z3, sh);
      d[st] = (int32_t)DESCALE(tmp7 + z1 + z4, sh);
    }
  }
}

/* one block of a plane -> quantized coefficients (natural order) */
static void forward_block(const uint8_t *pl, size_t stride, const uint16_t *q, int16_t *coef) {
  int32_t ws[64];
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) ws[8 * r + c] = (int32_t)pl[r * stride + c] - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int32_t div = (int32_t)q[i] << 3, t = ws[i];
    if (t < 0) {
      t = -t + (div >> 1);
      t = t >= div ? t / div : 0;
      t = -t;
    } else {
      t += div >> 1;
      t = t >= div ? t / div : 0;
    }
    coef[i] = (int16_t)t;
  }
}

static int nbits_of(int v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

static void encode_block(bwriter_t *w, const int16_t *coef, int *last_dc, const ehuff_t *dc,
                         const ehuff_t *ac) {
  int diff = coef[0] - *last_dc, t = diff, t2 = diff;
  *last_dc = coef[0];
  if (t < 0) {
    t = -t;
    t2--;
  }
  int nb = nbits_of(t);
  put_bits(w, dc->code[nb], dc->size[nb]);
  put_bits(w, (uint32_t)t2, nb);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    int v = coef[ZIGZAG[k]];
    if (v == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      put_bits(w, ac->code[0xF0], ac->size[0xF0]);
      r -= 16;
    }
    t = t2 = v;
    if (t < 0) {
      t = -t;
      t2--;
    }
    nb = nbits_of(t);
    int sym = (r << 4) + nb;
    put_bits(w, ac->code[sym], ac->size[sym]);
    put_bits(w, (uint32_t)t2, nb);
    r = 0;
  }
  if (r > 0) put_bits(w, ac->code[0], ac->size[0]);
}

static void put_dht(bwriter_t *w, int tc_th, const uint8_t *bits17, const uint8_t *vals, int n) {
  uint8_t body[1 + 16 + 256];
  body[0] = (uint8_t)tc_th;
  memcpy(body + 1, bits17 + 1, 16);
  memcpy(body + 17, vals, (size_t)n);
  put_marker(w, 0xC4, body, 17 + (size_t)n);
}

/* rgb [h, w, 3] -> baseline 4:2:0 JPEG in *out (free it with jpeg_free); 0 on success */
int jpeg_encode(const uint8_t *rgb, int h, int w, int quality, uint8_t **out, size_t *out_n) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535) return 1;
  int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  int ybw = (w + 7) / 8, ybh = (h + 7) / 8; /* luma width/height in blocks */
  size_t lw = (size_t)mcux * 16, lh = (size_t)mcuy * 16, cw = (size_t)mcux * 8, ch = (size_t)mcuy * 8;
  uint8_t *Y = (uint8_t *)malloc(lw * lh), *CB = (uint8_t *)malloc(lw * (size_t)(h + 1)),
          *CR = (uint8_t *)malloc(lw * (size_t)(h + 1));
  uint8_t *dcb = (uint8_t *)malloc(cw * ch), *dcr = (uint8_t *)malloc(cw * ch);
  if (!Y || !CB || !CR || !dcb || !dcr) {
    free(Y); free(CB); free(CR); free(dcb); free(dcr);
    return 2;
  }
  /* jccolor.c rgb_ycc_convert */
  int64_t tab[8 * 256];
  for (int i = 0; i < 256; i++) {
    tab[i] = FIX(0.29900) * i;
    tab[i + 256] = FIX(0.58700) * i;
    tab[i + 512] = FIX(0.11400) * i + ONE_HALF;
    tab[i + 768] = (-FIX(0.16874)) * i;
    tab[i + 1024] = (-FIX(0.33126)) * i;
    tab[i + 1280] = FIX(0.50000) * i + ((int64_t)128 << SCALEBITS) + ONE_HALF - 1;
    tab[i + 1536] = (-FIX(0.41869)) * i;
    tab[i + 1792] = (-FIX(0.08131)) * i;
  }
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      const uint8_t *p = rgb + ((size_t)y * w + x) * 3;
      int r = p[0], g = p[1], b = p[2];
      Y[(size_t)y * lw + x] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512]) >> SCALEBITS);
      CB[(size_t)y * lw + x] = (uint8_t)((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> SCALEBITS);
      CR[(size_t)y * lw + x] = (uint8_t)((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> SCALEBITS);
    }
  /* edges: rows replicated right (the luma to its blocks, the chroma to the
     downsampler's 2 * cw columns), the full-size chroma to an even row count */
  for (int y = 0; y < h; y++) {
    memset(Y + (size_t)y * lw + w, Y[(size_t)y * lw + w - 1], (size_t)ybw * 8 - w);
    memset(CB + (size_t)y * lw + w, CB[(size_t)y * lw + w - 1], 2 * cw - w);
    memset(CR + (size_t)y * lw + w, CR[(size_t)y * lw + w - 1], 2 * cw - w);
  }
  for (size_t y = (size_t)h; y < lh; y++) memcpy(Y + y * lw, Y + (size_t)(h - 1) * lw, (size_t)ybw * 8);
  if (h & 1) {
    memcpy(CB + (size_t)h * lw, CB + (size_t)(h - 1) * lw, 2 * cw);
    memcpy(CR + (size_t)h * lw, CR + (size_t)(h - 1) * lw, 2 * cw);
  }
  /* jcsample.c h2v2_downsample: bias 1, 2, 1, 2, ... along each row */
  size_t crows = (size_t)(h + 1) / 2;
  for (size_t y = 0; y < crows; y++)
    for (size_t x = 0; x < cw; x++) {
      int bias = (x & 1) ? 2 : 1;
      const uint8_t *a = CB + 2 * y * lw + 2 * x, *c = CR + 2 * y * lw + 2 * x;
      dcb[y * cw + x] = (uint8_t)((a[0] + a[1] + a[lw] + a[lw + 1] + bias) >> 2);
      dcr[y * cw + x] = (uint8_t)((c[0] + c[1] + c[lw] + c[lw + 1] + bias) >> 2);
    }
  for (size_t y = crows; y < ch; y++) {
    memcpy(dcb + y * cw, dcb + (crows - 1) * cw, cw);
    memcpy(dcr + y * cw, dcr + (crows - 1) * cw, cw);
  }
  uint16_t ql[64], qc[64];
  jpeg_quant_tables(quality, ql, qc);
  ehuff_t dcl, acl, dcc, acc;
  ehuff_derive(DC_LUMA_BITS, DC_VALS, &dcl);
  ehuff_derive(AC_LUMA_BITS, AC_LUMA_VALS, &acl);
  ehuff_derive(DC_CHROMA_BITS, DC_VALS, &dcc);
  ehuff_derive(AC_CHROMA_BITS, AC_CHROMA_VALS, &acc);

  bwriter_t wr;
  memset(&wr, 0, sizeof(wr));
  const uint8_t soi[2] = {0xFF, 0xD8};
  put_bytes(&wr, soi, 2);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  put_marker(&wr, 0xE0, jfif, 14);
  for (int t = 0; t < 2; t++) {
    uint8_t body[65];
    body[0] = (uint8_t)t;
    for (int k = 0; k < 64; k++) body[1 + k] = (uint8_t)(t ? qc : ql)[ZIGZAG[k]];
    put_marker(&wr, 0xDB, body, 65);
  }
  const uint8_t sof[15] = {8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8), (uint8_t)w, 3,
                           1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  put_marker(&wr, 0xC0, sof, 15);
  put_dht(&wr, 0x00, DC_LUMA_BITS, DC_VALS, 12);
  put_dht(&wr, 0x10, AC_LUMA_BITS, AC_LUMA_VALS, 162);
  put_dht(&wr, 0x01, DC_CHROMA_BITS, DC_VALS, 12);
  put_dht(&wr, 0x11, AC_CHROMA_BITS, AC_CHROMA_VALS, 162);
  const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  put_marker(&wr, 0xDA, sos, 10);

  int ldc[3] = {0, 0, 0};
  int16_t blk[4][64], cblk[64];
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++) {
      /* luma: 2 x 2 blocks; those past the image's blocks are jccoefct.c's
         dummies (zero AC, the DC of the block before) */
      for (int by = 0; by < 2; by++)
        for (int bx = 0; bx < 2; bx++) {
          int n = 2 * by + bx, gy = 2 * my + by, gx = 2 * mx + bx;
          if (gy < ybh && gx < ybw) {
            forward_block(Y + (size_t)gy * 8 * lw + (size_t)gx * 8, lw, ql, blk[n]);
          } else {
            memset(blk[n], 0, sizeof(blk[n]));
            blk[n][0] = gy < ybh ? blk[n - 1][0] : blk[2 * by - 1][0];
          }
        }
      for (int n = 0; n < 4; n++) encode_block(&wr, blk[n], &ldc[0], &dcl, &acl);
      forward_block(dcb + (size_t)my * 8 * cw + (size_t)mx * 8, cw, qc, cblk);
      encode_block(&wr, cblk, &ldc[1], &dcc, &acc);
      forward_block(dcr + (size_t)my * 8 * cw + (size_t)mx * 8, cw, qc, cblk);
      encode_block(&wr, cblk, &ldc[2], &dcc, &acc);
    }
  put_bits(&wr, 0x7F, 7); /* fill the last byte with ones */
  wr.nbits = 0;
  const uint8_t eoi[2] = {0xFF, 0xD9};
  put_bytes(&wr, eoi, 2);
  free(Y); free(CB); free(CR); free(dcb); free(dcr);
  if (wr.oom) {
    free(wr.d);
    return 2;
  }
  *out = wr.d;
  *out_n = wr.n;
  return 0;
}

void jpeg_free(void *p) { free(p); }
