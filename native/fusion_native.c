/* fusion_native.c — native host pipeline for the Fusion JAX framework.
 *
 * The reference implementation's host costs (SHAKE/SHA3 hashing, repr-string
 * serialization, XOF byte decoding, seeded sampling — see SURVEY.md §3 hot
 * paths) dominate end-to-end verify throughput once the lattice math runs on
 * the accelerator.  This module implements that entire host pipeline in C with pthread
 * fan-out, exposed via ctypes (no Python C-API dependency):
 *
 *   - Keccak-f[1600] sponge: SHA3-256 and SHAKE256 (FIPS 202);
 *   - byte -> bounded-coefficient decoder (exact semantics of reference
 *     fusion/fusion.py:422-481 including the partial Fisher–Yates quirk);
 *   - polynomial repr serializer (byte-identical to the reference str()
 *     formats, algebra/polynomials.py:92-93,:257-258 — the wire format);
 *   - CPython-compatible MT19937 (random.seed(int)/getrandbits/randrange
 *     semantics) for bit-exact batched key sampling;
 *   - fused challenge derivation: per (vk_repr, message) item, SHA3 pre-hash,
 *     decimal rendering, SHAKE256 XOF and coefficient decode, parallelized
 *     across a thread pool.
 *
 * Build: gcc -O3 -shared -fPIC -pthread -o libfusion_native.so fusion_native.c
 */
#define _GNU_SOURCE  /* qsort_r */
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Keccak-f[1600] and the FIPS-202 sponge                              */
/* ------------------------------------------------------------------ */

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

#define ROTL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

/* rho+pi as a single 24-step cycle walk (no 25-word temp copy). */
static const int KECCAK_PILN[24] = {10, 7,  11, 17, 18, 3,  5,  16, 8,  21, 24, 4,
                                    15, 23, 19, 13, 12, 2,  20, 14, 22, 9,  6,  1};
static const int KECCAK_ROTC[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                                    27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};

static void keccakf(uint64_t st[25]) {
    int round, i, j;
    uint64_t t, bc[5];
    for (round = 0; round < 24; round++) {
        /* theta */
        for (i = 0; i < 5; i++)
            bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
        for (i = 0; i < 5; i++) {
            t = bc[(i + 4) % 5] ^ ROTL64(bc[(i + 1) % 5], 1);
            for (j = 0; j < 25; j += 5) st[j + i] ^= t;
        }
        /* rho + pi */
        t = st[1];
        for (i = 0; i < 24; i++) {
            j = KECCAK_PILN[i];
            bc[0] = st[j];
            st[j] = ROTL64(t, KECCAK_ROTC[i]);
            t = bc[0];
        }
        /* chi */
        for (j = 0; j < 25; j += 5) {
            for (i = 0; i < 5; i++) bc[i] = st[j + i];
            for (i = 0; i < 5; i++)
                st[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
        }
        /* iota */
        st[0] ^= KECCAK_RC[round];
    }
}

typedef struct {
    uint64_t st[25];
    unsigned rate;    /* in bytes */
    unsigned absorbed;
} keccak_ctx;

static void keccak_init(keccak_ctx *c, unsigned rate) {
    memset(c, 0, sizeof(*c));
    c->rate = rate;
}

static void keccak_absorb(keccak_ctx *c, const uint8_t *in, size_t len) {
    uint8_t *state8 = (uint8_t *)c->st;  /* little-endian host assumed (x86/ARM) */
    while (len > 0) {
        size_t take = c->rate - c->absorbed;
        if (take > len) take = len;
        for (size_t k = 0; k < take; k++) state8[c->absorbed + k] ^= in[k];
        c->absorbed += (unsigned)take;
        in += take;
        len -= take;
        if (c->absorbed == c->rate) {
            keccakf(c->st);
            c->absorbed = 0;
        }
    }
}

static void keccak_finish(keccak_ctx *c, uint8_t domain) {
    uint8_t *state8 = (uint8_t *)c->st;
    state8[c->absorbed] ^= domain;
    state8[c->rate - 1] ^= 0x80;
    keccakf(c->st);
    c->absorbed = 0;
}

static void keccak_squeeze(keccak_ctx *c, uint8_t *out, size_t outlen) {
    uint8_t *state8 = (uint8_t *)c->st;
    size_t off = 0;
    while (off < outlen) {
        size_t take = c->rate - c->absorbed;
        if (take > outlen - off) take = outlen - off;
        memcpy(out + off, state8 + c->absorbed, take);
        c->absorbed += (unsigned)take;
        off += take;
        if (c->absorbed == c->rate) {
            keccakf(c->st);
            c->absorbed = 0;
        }
    }
}

void fn_sha3_256(const uint8_t *in, size_t inlen, uint8_t out[32]) {
    keccak_ctx c;
    keccak_init(&c, 136);
    keccak_absorb(&c, in, inlen);
    keccak_finish(&c, 0x06);
    keccak_squeeze(&c, out, 32);
}

void fn_shake256(const uint8_t *in, size_t inlen, uint8_t *out, size_t outlen) {
    keccak_ctx c;
    keccak_init(&c, 136);
    keccak_absorb(&c, in, inlen);
    keccak_finish(&c, 0x1f);
    keccak_squeeze(&c, out, outlen);
}

/* ------------------------------------------------------------------ */
/* XOF byte -> bounded coefficient decoder                             */
/* (exact behavior of reference fusion/fusion.py:422-481)              */
/* ------------------------------------------------------------------ */

/* Reads a big-endian chunk mod `mod` without bignums (mod < 2^31). */
static uint32_t be_mod(const uint8_t *p, int len, uint32_t mod) {
    uint64_t acc = 0;
    for (int i = 0; i < len; i++) acc = ((acc << 8) | p[i]) % mod;
    return (uint32_t)acc;
}

/* Decode one polynomial.  Returns 0 on success, -1 if too few bytes. */
int fn_decode_coeffs(const uint8_t *b, size_t blen, int32_t degree,
                     int32_t weight_bound, int32_t bound,
                     int32_t bytes_per_coefficient, int32_t bytes_per_index,
                     int32_t *out /* [degree] */) {
    if (weight_bound > degree) return -2;  /* out[] is int32[degree] */
    int bytes_for_signums = (weight_bound + 7) / 8;
    size_t total = (size_t)bytes_for_signums +
                   (size_t)(bytes_per_coefficient + bytes_per_index) * weight_bound;
    if (blen < total) return -1;
    int num_coefs = weight_bound < degree ? weight_bound : degree;
    if (num_coefs < 1) num_coefs = 1;

    /* signums: big-endian integer over the signum bytes, bit i (LSB-first) */
    const uint8_t *sb = b;
    for (int i = 0; i < degree; i++) out[i] = 0;
    size_t off = (size_t)bytes_for_signums;
    for (int i = 0; i < weight_bound; i++) {
        /* bit i of the big-endian integer = byte (from end) i/8, bit i%8 */
        int byte_from_end = i / 8;
        int bit = i % 8;
        int v = (sb[bytes_for_signums - 1 - byte_from_end] >> bit) & 1;
        int sign = 2 * v - 1;
        /* (block % bound) + 1; for bound == 1 the magnitude is always 1 but the
         * bytes are still consumed (keeps the index-stream offsets aligned) */
        uint32_t mag =
            bound == 1 ? 1u : be_mod(b + off, bytes_per_coefficient, (uint32_t)bound) + 1u;
        out[i] = sign * (int32_t)mag;
        off += (size_t)bytes_per_coefficient;
    }

    /* partial Fisher–Yates: i from degree-1 down to weight_bound+1 (exclusive
     * lower bound quirk, fusion.py:473).  Quirk parity: if the byte stream runs
     * dry the reference's slicing silently truncates and int.from_bytes(b"")
     * is 0, so trailing swaps use j = 0 — reproduce by clamping the read
     * length to the remaining buffer (this path is live for the secpar=256
     * aggregation blocks, whose n is smaller than the full index stream). */
    if (num_coefs < degree) {
        for (int i = degree - 1; i > weight_bound; i--) {
            size_t avail = blen > off ? blen - off : 0;
            int len = (size_t)bytes_per_index < avail ? bytes_per_index : (int)avail;
            uint32_t j = len > 0 ? be_mod(b + off, len, (uint32_t)(i + 1)) : 0;
            off += (size_t)bytes_per_index;
            int32_t t = out[i];
            out[i] = out[j];
            out[j] = t;
        }
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Integer / repr formatting                                           */
/* ------------------------------------------------------------------ */

static int i32toa(int32_t v, char *dst) {
    char buf[12];
    int n = 0, neg = v < 0;
    uint32_t u = neg ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
    do {
        buf[n++] = (char)('0' + u % 10);
        u /= 10;
    } while (u);
    int m = 0;
    if (neg) dst[m++] = '-';
    while (n) dst[m++] = buf[--n];
    return m;
}

/* "PolynomialNTTRepresentation(<meta>values=[v0, v1, ...])"
 * meta is the pre-rendered "modulus=..., degree=..., root=..., inv_root=...,
 * root_order=..., " prefix.  Returns number of bytes written. */
size_t fn_format_poly(const char *class_name, const char *meta, size_t meta_len,
                      const char *field_name, const int32_t *values, int32_t degree,
                      char *dst) {
    char *p = dst;
    size_t cl = strlen(class_name);
    memcpy(p, class_name, cl); p += cl;
    *p++ = '(';
    memcpy(p, meta, meta_len); p += meta_len;
    size_t fl = strlen(field_name);
    memcpy(p, field_name, fl); p += fl;
    *p++ = '='; *p++ = '[';
    for (int i = 0; i < degree; i++) {
        if (i) { *p++ = ','; *p++ = ' '; }
        p += i32toa(values[i], p);
    }
    *p++ = ']'; *p++ = ')';
    return (size_t)(p - dst);
}

/* 256-bit little-endian bytes -> decimal string.  Returns length. */
size_t fn_u256_to_dec(const uint8_t le_bytes[32], char *dst) {
    /* 8 x 32-bit limbs, little-endian */
    uint32_t limbs[8];
    for (int i = 0; i < 8; i++)
        limbs[i] = (uint32_t)le_bytes[4 * i] | ((uint32_t)le_bytes[4 * i + 1] << 8) |
                   ((uint32_t)le_bytes[4 * i + 2] << 16) |
                   ((uint32_t)le_bytes[4 * i + 3] << 24);
    char tmp[80];
    int n = 0;
    int nonzero = 1;
    while (nonzero) {
        /* divide limbs (big number, little-endian limb order) by 10 */
        uint64_t rem = 0;
        nonzero = 0;
        for (int i = 7; i >= 0; i--) {
            uint64_t cur = (rem << 32) | limbs[i];
            limbs[i] = (uint32_t)(cur / 10);
            rem = cur % 10;
            if (limbs[i]) nonzero = 1;
        }
        tmp[n++] = (char)('0' + rem);
    }
    for (int i = 0; i < n; i++) dst[i] = tmp[n - 1 - i];
    return (size_t)n;
}

/* ------------------------------------------------------------------ */
/* 8-way vectorized Keccak (AVX-512): batch independent SHAKE256 XOFs  */
/* ------------------------------------------------------------------ */

#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>

/* Compiled with a per-function target so the rest of the library stays free of
 * AVX-512 instructions (a whole-file -mavx512f lets gcc auto-vectorize scalar
 * paths and SIGILL on non-AVX-512 hosts); have_avx512() gates at runtime. */
__attribute__((target("avx512f")))
static void keccakf_x8(__m512i st[25]) {
    __m512i bc[5], t;
    for (int round = 0; round < 24; round++) {
        for (int i = 0; i < 5; i++)
            bc[i] = _mm512_xor_si512(
                _mm512_xor_si512(_mm512_xor_si512(st[i], st[i + 5]), _mm512_xor_si512(st[i + 10], st[i + 15])),
                st[i + 20]);
        for (int i = 0; i < 5; i++) {
            t = _mm512_xor_si512(bc[(i + 4) % 5],
                                 _mm512_rolv_epi64(bc[(i + 1) % 5], _mm512_set1_epi64(1)));
            for (int j = 0; j < 25; j += 5) st[j + i] = _mm512_xor_si512(st[j + i], t);
        }
        {
            __m512i cur = st[1];
            for (int i = 0; i < 24; i++) {
                int j = KECCAK_PILN[i];
                __m512i nxt = st[j];
                st[j] = _mm512_rolv_epi64(cur, _mm512_set1_epi64(KECCAK_ROTC[i]));
                cur = nxt;
            }
        }
        for (int j = 0; j < 25; j += 5) {
            for (int i = 0; i < 5; i++) bc[i] = st[j + i];
            for (int i = 0; i < 5; i++)
                st[j + i] = _mm512_xor_si512(
                    bc[i], _mm512_andnot_si512(bc[(i + 1) % 5], bc[(i + 2) % 5]));
        }
        st[0] = _mm512_xor_si512(st[0], _mm512_set1_epi64((long long)KECCAK_RC[round]));
    }
}

static int have_avx512(void) { return __builtin_cpu_supports("avx512f"); }

/* 8 SHAKE256 XOFs with EQUAL absorb block counts, vectorized.
 * payloads: lens[i] bytes at ptrs[i]; each must produce exactly `nblocks`
 * rate-136 blocks after pad10*1.  out: 8 contiguous outputs of outlen bytes. */
__attribute__((target("avx512f")))
static void shake256_x8(const uint8_t *ptrs[8], const size_t lens[8], int nblocks,
                        uint8_t *out, size_t outlen) {
    __m512i st[25];
    for (int i = 0; i < 25; i++) st[i] = _mm512_setzero_si512();
    uint64_t blk[8][17] __attribute__((aligned(64)));
    uint64_t tbuf[17 * 8] __attribute__((aligned(64)));
    for (int b = 0; b < nblocks; b++) {
        for (int lane = 0; lane < 8; lane++) {
            uint8_t *dst = (uint8_t *)blk[lane];
            size_t start = (size_t)b * 136;
            size_t len = lens[lane];
            size_t n = len > start ? (len - start < 136 ? len - start : 136) : 0;
            memcpy(dst, ptrs[lane] + start, n);
            memset(dst + n, 0, 136 - n);
            if (n < 136) dst[n] ^= 0x1f; /* pad start (only in the final block) */
            if (b == nblocks - 1) dst[135] ^= 0x80;
        }
        /* scalar transpose -> aligned vector loads */
        for (int lane = 0; lane < 8; lane++)
            for (int w = 0; w < 17; w++) tbuf[w * 8 + lane] = blk[lane][w];
        for (int w = 0; w < 17; w++)
            st[w] = _mm512_xor_si512(st[w], _mm512_load_si512((const __m512i *)&tbuf[w * 8]));
        keccakf_x8(st);
    }
    /* squeeze: extract one full 136-byte rate block per lane at a time */
    size_t produced = 0;
    uint64_t wordbuf[17 * 8] __attribute__((aligned(64)));
    while (produced < outlen) {
        for (int w = 0; w < 17; w++)
            _mm512_store_si512((__m512i *)&wordbuf[w * 8], st[w]);
        size_t take = outlen - produced < 136 ? outlen - produced : 136;
        for (int lane = 0; lane < 8; lane++) {
            uint64_t tmp[17];
            for (int w = 0; w < 17; w++) tmp[w] = wordbuf[w * 8 + lane];
            memcpy(out + (size_t)lane * outlen + produced, tmp, take);
        }
        produced += take;
        if (produced < outlen) keccakf_x8(st);
    }
}
#else
static int have_avx512(void) { return 0; }
static void shake256_x8(const uint8_t *ptrs[8], const size_t lens[8], int nblocks,
                        uint8_t *out, size_t outlen) {
    (void)ptrs; (void)lens; (void)nblocks; (void)out; (void)outlen;
}
#endif

int fn_have_avx512(void) { return have_avx512(); }

/* Exported: batch of n equal-block-count SHAKE256 XOFs (n <= 8 real lanes;
 * unused lanes duplicate lane 0).  For testing and reuse. */
void fn_shake256_x8(const uint8_t *blob, const uint64_t *off /* n+1 */, int n,
                    int nblocks, uint8_t *out, size_t outlen) {
    if (n > 8) n = 8;  /* 8 lanes max; wrapper validates */
    const uint8_t *ptrs[8];
    size_t lens[8];
    for (int i = 0; i < 8; i++) {
        int src = i < n ? i : 0;
        ptrs[i] = blob + off[src];
        lens[i] = (size_t)(off[src + 1] - off[src]);
    }
    if (have_avx512()) {
        uint8_t *tmp = (uint8_t *)malloc(8 * outlen);
        shake256_x8(ptrs, lens, nblocks, tmp, outlen);
        for (int i = 0; i < n; i++)
            memcpy(out + (size_t)i * outlen, tmp + (size_t)i * outlen, outlen);
        free(tmp);
    } else {
        for (int i = 0; i < n; i++)
            fn_shake256(ptrs[i], lens[i], out + (size_t)i * outlen, outlen);
    }
}

/* ------------------------------------------------------------------ */
/* Fused challenge derivation with a thread pool                       */
/* ------------------------------------------------------------------ */

typedef struct {
    /* shared inputs */
    const uint8_t *pre_dst;  size_t pre_dst_len;   /* sign_pre_hash_dst */
    const uint8_t *hash_dst; size_t hash_dst_len;  /* sign_hash_dst */
    const uint8_t *vk_blob;  const uint64_t *vk_off;   /* n+1 offsets */
    const uint8_t *msg_blob; const uint64_t *msg_off;  /* n+1 offsets */
    int32_t n_items;
    int32_t degree, weight_bound, bound, bpc, bpi;
    size_t xof_len;
    int32_t *out_coeffs;     /* [n_items * degree] */
    uint8_t *out_prehash;    /* [n_items * 32] little-endian digests */
    /* phase-2 scratch */
    uint8_t **payloads;
    size_t *payload_lens;
    int32_t *order;          /* item indices sorted by absorb block count */
    /* work counter */
    int32_t next;
    pthread_mutex_t lock;
    int32_t rc;
} chall_job;

static void chall_build_payload(chall_job *J, int32_t i) {
    /* 1. pre-hash: sha3_256(pre_dst + "," + msg) -> little-endian int */
    uint8_t head[4096];
    size_t mlen = (size_t)(J->msg_off[i + 1] - J->msg_off[i]);
    size_t plen = J->pre_dst_len + 1 + mlen;
    uint8_t *pre = plen <= sizeof head ? head : (uint8_t *)malloc(plen);
    memcpy(pre, J->pre_dst, J->pre_dst_len);
    pre[J->pre_dst_len] = ',';
    memcpy(pre + J->pre_dst_len + 1, J->msg_blob + J->msg_off[i], mlen);
    uint8_t digest[32];
    fn_sha3_256(pre, plen, digest);
    if (pre != head) free(pre);
    memcpy(J->out_prehash + 32 * i, digest, 32);

    /* 2. decimal string of the little-endian integer */
    char dec[80];
    size_t dec_len = fn_u256_to_dec(digest, dec);

    /* 3. payload = hash_dst + "," + vk_repr + "," + dec */
    size_t vlen = (size_t)(J->vk_off[i + 1] - J->vk_off[i]);
    size_t plen2 = J->hash_dst_len + 1 + vlen + 1 + dec_len;
    uint8_t *p = (uint8_t *)malloc(plen2);
    J->payloads[i] = p;
    J->payload_lens[i] = plen2;
    memcpy(p, J->hash_dst, J->hash_dst_len); p += J->hash_dst_len;
    *p++ = ',';
    memcpy(p, J->vk_blob + J->vk_off[i], vlen); p += vlen;
    *p++ = ',';
    memcpy(p, dec, dec_len);
}

static void chall_finish_item(chall_job *J, int32_t i, const uint8_t *xof) {
    if (fn_decode_coeffs(xof, J->xof_len, J->degree, J->weight_bound, J->bound,
                         J->bpc, J->bpi, J->out_coeffs + (size_t)i * J->degree) != 0) {
        pthread_mutex_lock(&J->lock);
        J->rc = -1;
        pthread_mutex_unlock(&J->lock);
    }
}

static inline int absorb_blocks(size_t len) { return (int)(len / 136) + 1; }

static void *chall_worker_phase1(void *arg) {
    chall_job *J = (chall_job *)arg;
    for (;;) {
        pthread_mutex_lock(&J->lock);
        int32_t i = J->next++;
        pthread_mutex_unlock(&J->lock);
        if (i >= J->n_items) break;
        chall_build_payload(J, i);
    }
    return NULL;
}

static void *chall_worker_phase2(void *arg) {
    /* consume chunks of 16 consecutive (block-count-sorted) items:
     * 16-wide (two interleaved 8-lane states) when homogeneous, then 8-wide,
     * then scalar stragglers */
    chall_job *J = (chall_job *)arg;
    uint8_t *xof = (uint8_t *)malloc(16 * J->xof_len);
    int simd = have_avx512();
    for (;;) {
        pthread_mutex_lock(&J->lock);
        int32_t c = J->next;
        J->next += 16;
        pthread_mutex_unlock(&J->lock);
        if (c >= J->n_items) break;
        int32_t n = J->n_items - c < 16 ? J->n_items - c : 16;
        const int32_t *idx = J->order + c;
        int32_t k = 0;
        while (k < n) {
            int32_t left = n - k;
            int width = 1;
            if (simd && left >= 8) {
                int nb0 = absorb_blocks(J->payload_lens[idx[k]]);
                int homog = 1;
                for (int m = 1; m < 8; m++) {
                    if (absorb_blocks(J->payload_lens[idx[k + m]]) != nb0) break;
                    homog = m + 1;
                }
                if (homog >= 8) width = 8;
            }
            if (width == 8) {
                const uint8_t *ptrs[8];
                size_t lens[8];
                for (int m = 0; m < width; m++) {
                    ptrs[m] = J->payloads[idx[k + m]];
                    lens[m] = J->payload_lens[idx[k + m]];
                }
                int nb0 = absorb_blocks(lens[0]);
                shake256_x8(ptrs, lens, nb0, xof, J->xof_len);
                for (int m = 0; m < width; m++)
                    chall_finish_item(J, idx[k + m], xof + (size_t)m * J->xof_len);
            } else {
                fn_shake256(J->payloads[idx[k]], J->payload_lens[idx[k]], xof, J->xof_len);
                chall_finish_item(J, idx[k], xof);
            }
            k += width;
        }
    }
    free(xof);
    return NULL;
}

static int cmp_blocks_r(const void *a, const void *b, void *arg) {
    const chall_job *J = (const chall_job *)arg;
    int32_t ia = *(const int32_t *)a, ib = *(const int32_t *)b;
    int na = absorb_blocks(J->payload_lens[ia]);
    int nb = absorb_blocks(J->payload_lens[ib]);
    if (na != nb) return na - nb;
    return ia - ib;
}

int fn_derive_challenges(const uint8_t *pre_dst, size_t pre_dst_len,
                         const uint8_t *hash_dst, size_t hash_dst_len,
                         const uint8_t *vk_blob, const uint64_t *vk_off,
                         const uint8_t *msg_blob, const uint64_t *msg_off,
                         int32_t n_items, int32_t degree, int32_t weight_bound,
                         int32_t bound, int32_t bpc, int32_t bpi, size_t xof_len,
                         int32_t n_threads, int32_t *out_coeffs,
                         uint8_t *out_prehash) {
    chall_job J;
    memset(&J, 0, sizeof(J));
    J.pre_dst = pre_dst; J.pre_dst_len = pre_dst_len;
    J.hash_dst = hash_dst; J.hash_dst_len = hash_dst_len;
    J.vk_blob = vk_blob; J.vk_off = vk_off;
    J.msg_blob = msg_blob; J.msg_off = msg_off;
    J.n_items = n_items; J.degree = degree; J.weight_bound = weight_bound;
    J.bound = bound; J.bpc = bpc; J.bpi = bpi; J.xof_len = xof_len;
    J.out_coeffs = out_coeffs; J.out_prehash = out_prehash;
    J.payloads = (uint8_t **)calloc(n_items, sizeof(uint8_t *));
    J.payload_lens = (size_t *)calloc(n_items, sizeof(size_t));
    J.order = (int32_t *)malloc(n_items * sizeof(int32_t));
    pthread_mutex_init(&J.lock, NULL);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    pthread_t th[16];

    /* Phase 1: build payloads + prehashes */
    J.next = 0;
    for (int t = 0; t < n_threads; t++) pthread_create(&th[t], NULL, chall_worker_phase1, &J);
    for (int t = 0; t < n_threads; t++) pthread_join(th[t], NULL);

    /* Sort by absorb block count so x8 chunks are homogeneous */
    for (int32_t i = 0; i < n_items; i++) J.order[i] = i;
    qsort_r(J.order, n_items, sizeof(int32_t), cmp_blocks_r, &J);

    /* Phase 2: XOF (8-way where possible) + decode */
    J.next = 0;
    for (int t = 0; t < n_threads; t++) pthread_create(&th[t], NULL, chall_worker_phase2, &J);
    for (int t = 0; t < n_threads; t++) pthread_join(th[t], NULL);

    for (int32_t i = 0; i < n_items; i++) free(J.payloads[i]);
    free(J.payloads);
    free(J.payload_lens);
    free(J.order);
    pthread_mutex_destroy(&J.lock);
    return J.rc;
}

/* ------------------------------------------------------------------ */
/* Batched aggregation XOF: per group, SHAKE256(payload) ->            */
/* sigs_per_group blocks -> decode each (8-way keccak across groups)   */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *blob;
    const uint64_t *off;     /* n_groups + 1 */
    int32_t n_groups, sigs_per_group;
    size_t block_len;
    int32_t degree, weight_bound, bound, bpc, bpi;
    int32_t *out;            /* [n_groups * sigs_per_group * degree] */
    int32_t *order;
    int32_t next;
    pthread_mutex_t lock;
    int32_t rc;
} agg_job;

static int agg_cmp_blocks_r(const void *a, const void *b, void *arg) {
    const agg_job *J = (const agg_job *)arg;
    int32_t ia = *(const int32_t *)a, ib = *(const int32_t *)b;
    size_t la = (size_t)(J->off[ia + 1] - J->off[ia]);
    size_t lb = (size_t)(J->off[ib + 1] - J->off[ib]);
    int na = absorb_blocks(la), nb = absorb_blocks(lb);
    if (na != nb) return na - nb;
    return ia - ib;
}

static void agg_decode_group(agg_job *J, int32_t g, const uint8_t *xof) {
    size_t outlen_each = J->block_len;
    for (int32_t s = 0; s < J->sigs_per_group; s++) {
        if (fn_decode_coeffs(xof + (size_t)s * outlen_each, outlen_each, J->degree,
                             J->weight_bound, J->bound, J->bpc, J->bpi,
                             J->out + ((size_t)g * J->sigs_per_group + s) * J->degree) != 0) {
            pthread_mutex_lock(&J->lock);
            J->rc = -1;
            pthread_mutex_unlock(&J->lock);
        }
    }
}

static void *agg_worker(void *arg) {
    agg_job *J = (agg_job *)arg;
    size_t outlen = (size_t)J->sigs_per_group * J->block_len;
    uint8_t *xof = (uint8_t *)malloc(16 * outlen);
    int simd = have_avx512();
    for (;;) {
        pthread_mutex_lock(&J->lock);
        int32_t c = J->next;
        J->next += 16;
        pthread_mutex_unlock(&J->lock);
        if (c >= J->n_groups) break;
        int32_t n = J->n_groups - c < 16 ? J->n_groups - c : 16;
        const int32_t *idx = J->order + c;
        int32_t k = 0;
        while (k < n) {
            int32_t left = n - k;
            int width = 1;
            if (simd && left >= 8) {
                size_t l0 = (size_t)(J->off[idx[k] + 1] - J->off[idx[k]]);
                int nb0 = absorb_blocks(l0);
                int homog = 1;
                for (int m = 1; m < 8; m++) {
                    size_t lm = (size_t)(J->off[idx[k + m] + 1] - J->off[idx[k + m]]);
                    if (absorb_blocks(lm) != nb0) break;
                    homog = m + 1;
                }
                if (homog >= 8) width = 8;
            }
            if (width == 8) {
                const uint8_t *ptrs[8];
                size_t lens[8];
                for (int m = 0; m < width; m++) {
                    ptrs[m] = J->blob + J->off[idx[k + m]];
                    lens[m] = (size_t)(J->off[idx[k + m] + 1] - J->off[idx[k + m]]);
                }
                int nb0 = absorb_blocks(lens[0]);
                shake256_x8(ptrs, lens, nb0, xof, outlen);
                for (int m = 0; m < width; m++)
                    agg_decode_group(J, idx[k + m], xof + (size_t)m * outlen);
            } else {
                size_t l = (size_t)(J->off[idx[k] + 1] - J->off[idx[k]]);
                fn_shake256(J->blob + J->off[idx[k]], l, xof, outlen);
                agg_decode_group(J, idx[k], xof);
            }
            k += width;
        }
    }
    free(xof);
    return NULL;
}

/* Build the per-group aggregation XOF payloads natively:
 *   payload_g = agg_dst + "," + "[" + join(", ", "(<vk>, <dec(prehash)>, "
 *               "SignatureChallenge(c_hat=PolynomialNTTRepresentation(<meta>"
 *               "values=[...]))" ")") + "]"
 * (wire format of fusion.py:586-589 with the reference's repr grammar).
 *
 * vk blob/offsets are the sorted per-signer vk reprs; prehash digests are the
 * 32-byte little-endian SHA3 digests; c_hat the NTT-domain challenge values.
 * out_blob must have capacity >= fn_agg_payload_bound(...); offsets out_off
 * get n_groups+1 entries.  Returns total bytes written. */
size_t fn_build_agg_payloads(
    const uint8_t *agg_dst, size_t agg_dst_len,
    const uint8_t *vk_blob, const uint64_t *vk_off,
    const uint8_t *prehash /* [n_items*32] */,
    const char *meta, size_t meta_len,
    const int32_t *c_hat /* [n_items*degree] */, int32_t degree,
    int32_t n_groups, int32_t sigs_per_group,
    uint8_t *out_blob, uint64_t *out_off) {
    uint8_t *p = out_blob;
    out_off[0] = 0;
    for (int32_t g = 0; g < n_groups; g++) {
        memcpy(p, agg_dst, agg_dst_len); p += agg_dst_len;
        *p++ = ',';
        *p++ = '[';
        for (int32_t s = 0; s < sigs_per_group; s++) {
            int32_t i = g * sigs_per_group + s;
            if (s) { *p++ = ','; *p++ = ' '; }
            *p++ = '(';
            size_t vlen = (size_t)(vk_off[i + 1] - vk_off[i]);
            memcpy(p, vk_blob + vk_off[i], vlen); p += vlen;
            *p++ = ','; *p++ = ' ';
            p += fn_u256_to_dec(prehash + (size_t)i * 32, (char *)p);
            *p++ = ','; *p++ = ' ';
            const char *pre = "SignatureChallenge(c_hat=";
            size_t plen = strlen(pre);
            memcpy(p, pre, plen); p += plen;
            p += fn_format_poly("PolynomialNTTRepresentation", meta, meta_len,
                                "values", c_hat + (size_t)i * degree, degree, (char *)p);
            *p++ = ')';
            *p++ = ')';
        }
        *p++ = ']';
        out_off[g + 1] = (uint64_t)(p - out_blob);
    }
    return (size_t)(p - out_blob);
}

int fn_agg_alpha_batch(const uint8_t *blob, const uint64_t *off, int32_t n_groups,
                       int32_t sigs_per_group, size_t block_len, int32_t degree,
                       int32_t weight_bound, int32_t bound, int32_t bpc,
                       int32_t bpi, int32_t n_threads, int32_t *out) {
    agg_job J;
    memset(&J, 0, sizeof(J));
    J.blob = blob; J.off = off; J.n_groups = n_groups;
    J.sigs_per_group = sigs_per_group; J.block_len = block_len;
    J.degree = degree; J.weight_bound = weight_bound; J.bound = bound;
    J.bpc = bpc; J.bpi = bpi; J.out = out;
    J.order = (int32_t *)malloc(n_groups * sizeof(int32_t));
    for (int32_t i = 0; i < n_groups; i++) J.order[i] = i;
    qsort_r(J.order, n_groups, sizeof(int32_t), agg_cmp_blocks_r, &J);
    pthread_mutex_init(&J.lock, NULL);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    pthread_t th[16];
    for (int t = 0; t < n_threads; t++) pthread_create(&th[t], NULL, agg_worker, &J);
    for (int t = 0; t < n_threads; t++) pthread_join(th[t], NULL);
    pthread_mutex_destroy(&J.lock);
    free(J.order);
    return J.rc;
}

/* Decode a contiguous run of equal-size alpha blocks (aggregation coefs). */
int fn_decode_blocks(const uint8_t *b, size_t block_len, int32_t n_blocks,
                     int32_t degree, int32_t weight_bound, int32_t bound,
                     int32_t bpc, int32_t bpi, int32_t *out /* [n*degree] */) {
    for (int32_t i = 0; i < n_blocks; i++) {
        if (fn_decode_coeffs(b + (size_t)i * block_len, block_len, degree,
                             weight_bound, bound, bpc, bpi,
                             out + (size_t)i * degree) != 0)
            return -1;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Host-side batched forward NTT (for the hash pipeline's challenge    */
/* reprs — keeps serialization fully on-host; same table layout and    */
/* bit-identical results as ops/ntt.py)                                */
/* ------------------------------------------------------------------ */

typedef struct {
    int32_t *x;              /* [n, d] centered in/out */
    const uint32_t *brp;     /* [d] bit-reversed twiddles */
    int32_t n, d;
    int64_t q;
    int32_t next;
    pthread_mutex_t lock;
} ntt_job;

static void ntt_fwd_row(int32_t *row, const uint32_t *brp, int32_t d, int64_t q) {
    /* Cooley–Tukey DIT, standard order in -> bit-reversed out
     * (algebra/ntt.py:276-290 loop structure). */
    uint64_t tmp[1024];
    int64_t half = q / 2;
    for (int32_t i = 0; i < d; i++) {
        int64_t v = row[i];
        tmp[i] = (uint64_t)(v < 0 ? v + q : v);
    }
    int32_t t = d, m = 1;
    while (m < d) {
        t >>= 1;
        for (int32_t i = 0; i < m; i++) {
            int32_t j1 = 2 * i * t;
            uint64_t s = brp[m + i];
            for (int32_t j = j1; j < j1 + t; j++) {
                uint64_t u = tmp[j];
                uint64_t v = tmp[j + t] * s % (uint64_t)q;
                uint64_t a = u + v;
                if (a >= (uint64_t)q) a -= (uint64_t)q;
                uint64_t b = u >= v ? u - v : u + (uint64_t)q - v;
                tmp[j] = a;
                tmp[j + t] = b;
            }
        }
        m <<= 1;
    }
    for (int32_t i = 0; i < d; i++) {
        int64_t v = (int64_t)tmp[i];
        row[i] = (int32_t)(v > half ? v - q : v);
    }
}

static void *ntt_worker(void *arg) {
    ntt_job *J = (ntt_job *)arg;
    for (;;) {
        pthread_mutex_lock(&J->lock);
        int32_t i = J->next;
        J->next += 64;
        pthread_mutex_unlock(&J->lock);
        if (i >= J->n) break;
        int32_t end = i + 64 < J->n ? i + 64 : J->n;
        for (; i < end; i++) ntt_fwd_row(J->x + (size_t)i * J->d, J->brp, J->d, J->q);
    }
    return NULL;
}

int fn_ntt_fwd_batch(int32_t *x, const uint32_t *brp, int32_t n, int32_t d,
                     int64_t q, int32_t n_threads) {
    if (d > 1024) return -1;
    ntt_job J = {x, brp, n, d, q, 0, PTHREAD_MUTEX_INITIALIZER};
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    pthread_t th[16];
    for (int t = 0; t < n_threads; t++) pthread_create(&th[t], NULL, ntt_worker, &J);
    for (int t = 0; t < n_threads; t++) pthread_join(th[t], NULL);
    return 0;
}

/* ------------------------------------------------------------------ */
/* CPython-compatible MT19937 + the reference samplers                 */
/* ------------------------------------------------------------------ */

typedef struct {
    uint32_t mt[624];
    int mti;
} mt_state;

static void mt_init_genrand(mt_state *s, uint32_t seed) {
    s->mt[0] = seed;
    for (int i = 1; i < 624; i++)
        s->mt[i] = 1812433253u * (s->mt[i - 1] ^ (s->mt[i - 1] >> 30)) + (uint32_t)i;
    s->mti = 624;
}

static void mt_init_by_array(mt_state *s, const uint32_t *key, int key_len) {
    mt_init_genrand(s, 19650218u);
    int i = 1, j = 0;
    int k = 624 > key_len ? 624 : key_len;
    for (; k; k--) {
        s->mt[i] = (s->mt[i] ^ ((s->mt[i - 1] ^ (s->mt[i - 1] >> 30)) * 1664525u)) +
                   key[j] + (uint32_t)j;
        i++; j++;
        if (i >= 624) { s->mt[0] = s->mt[623]; i = 1; }
        if (j >= key_len) j = 0;
    }
    for (k = 623; k; k--) {
        s->mt[i] = (s->mt[i] ^ ((s->mt[i - 1] ^ (s->mt[i - 1] >> 30)) * 1566083941u)) -
                   (uint32_t)i;
        i++;
        if (i >= 624) { s->mt[0] = s->mt[623]; i = 1; }
    }
    s->mt[0] = 0x80000000u;
}

static uint32_t mt_genrand(mt_state *s) {
    uint32_t y;
    if (s->mti >= 624) {
        static const uint32_t mag01[2] = {0u, 0x9908b0dfu};
        int kk;
        for (kk = 0; kk < 624 - 397; kk++) {
            y = (s->mt[kk] & 0x80000000u) | (s->mt[kk + 1] & 0x7fffffffu);
            s->mt[kk] = s->mt[kk + 397] ^ (y >> 1) ^ mag01[y & 1];
        }
        for (; kk < 623; kk++) {
            y = (s->mt[kk] & 0x80000000u) | (s->mt[kk + 1] & 0x7fffffffu);
            s->mt[kk] = s->mt[kk + (397 - 624)] ^ (y >> 1) ^ mag01[y & 1];
        }
        y = (s->mt[623] & 0x80000000u) | (s->mt[0] & 0x7fffffffu);
        s->mt[623] = s->mt[396] ^ (y >> 1) ^ mag01[y & 1];
        s->mti = 0;
    }
    y = s->mt[s->mti++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
}

/* CPython random.seed(a) for non-negative a: key = 32-bit digits of a,
 * little-endian (at least one digit). */
static void mt_seed_cpython(mt_state *s, uint64_t a) {
    uint32_t key[2];
    int len = 0;
    if (a == 0) { key[0] = 0; len = 1; }
    else {
        while (a) { key[len++] = (uint32_t)(a & 0xffffffffu); a >>= 32; }
    }
    mt_init_by_array(s, key, len);
}

/* getrandbits(k) for 1 <= k <= 64, CPython semantics (32-bit words LE). */
static uint64_t mt_getrandbits(mt_state *s, int k) {
    if (k <= 32) return (uint64_t)(mt_genrand(s) >> (32 - k));
    uint64_t lo = mt_genrand(s);
    uint64_t hi = mt_genrand(s) >> (64 - k);
    return lo | (hi << 32);
}

/* randrange(n) == _randbelow_with_getrandbits */
static uint64_t mt_randbelow(mt_state *s, uint64_t n) {
    int k = 0;
    uint64_t tmp = n;
    while (tmp) { k++; tmp >>= 1; }
    uint64_t r = mt_getrandbits(s, k);
    while (r >= n) r = mt_getrandbits(s, k);
    return r;
}

/* Batched short-poly sampler: for each seed, reproduce
 * sample_polynomial_coefficient_representation (polynomials.py:436-467). */
void fn_sample_short_batch(const uint64_t *seeds, int32_t n_seeds, int32_t degree,
                           int32_t norm_bound, int32_t weight_bound,
                           int64_t modulus, int32_t *out /* [n*degree] */) {
    int32_t num = weight_bound < degree ? weight_bound : degree;
    if (num < 0) num = 0;
    int64_t half = modulus / 2;
    int64_t bound = norm_bound < half ? norm_bound : half;
    if (bound < 0) bound = 0;
    for (int32_t s_i = 0; s_i < n_seeds; s_i++) {
        mt_state st;
        mt_seed_cpython(&st, seeds[s_i]);
        int32_t *o = out + (size_t)s_i * degree;
        for (int32_t i = 0; i < num; i++) {
            int32_t mag = 1 + (int32_t)mt_randbelow(&st, (uint64_t)bound);
            int32_t sgn = 1 - 2 * (int32_t)mt_randbelow(&st, 2);
            o[i] = mag * sgn;
        }
        for (int32_t i = num; i < degree; i++) o[i] = 0;
        if (num < degree) {
            for (int32_t i = degree - 1; i > 0; i--) {
                uint32_t j = (uint32_t)mt_randbelow(&st, (uint64_t)i + 1);
                int32_t t = o[i]; o[i] = o[j]; o[j] = t;
            }
        }
    }
}

/* Batched uniform NTT sampler (polynomials.py:470-488). */
void fn_sample_uniform_batch(const uint64_t *seeds, int32_t n_seeds, int32_t degree,
                             int64_t modulus, int32_t *out /* [n*degree] */) {
    int64_t half = modulus / 2;
    for (int32_t s_i = 0; s_i < n_seeds; s_i++) {
        mt_state st;
        mt_seed_cpython(&st, seeds[s_i]);
        int32_t *o = out + (size_t)s_i * degree;
        for (int32_t i = 0; i < degree; i++)
            o[i] = (int32_t)((int64_t)mt_randbelow(&st, (uint64_t)modulus) - half);
    }
}

/* ------------------------------------------------------------------ */
/* Batched message prehash: sha3_256(dst + "," + msg) -> decimal digits */
/* (the host half of the device verify pipeline; everything else runs   */
/* on the device)                                                       */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *pre_dst; size_t pre_dst_len;
    const uint8_t *msg_blob; const uint64_t *msg_off;
    int32_t n;
    uint8_t *out_digits;  /* [n * 78], zero-padded */
    int32_t *out_lens;
    int32_t next;
    pthread_mutex_t lock;
} prehash_job;

static void *prehash_worker(void *arg) {
    prehash_job *J = (prehash_job *)arg;
    for (;;) {
        pthread_mutex_lock(&J->lock);
        int32_t i = J->next;
        J->next += 256;
        pthread_mutex_unlock(&J->lock);
        if (i >= J->n) break;
        int32_t end = i + 256 < J->n ? i + 256 : J->n;
        for (; i < end; i++) {
            uint8_t head[4096];
            size_t mlen = (size_t)(J->msg_off[i + 1] - J->msg_off[i]);
            size_t plen = J->pre_dst_len + 1 + mlen;
            uint8_t *pre = plen <= sizeof head ? head : (uint8_t *)malloc(plen);
            if (!pre) { /* allocation failure: flag the entry, don't crash */
                memset(J->out_digits + (size_t)i * 78, 0, 78);
                J->out_lens[i] = -1;
                continue;
            }
            memcpy(pre, J->pre_dst, J->pre_dst_len);
            pre[J->pre_dst_len] = ',';
            memcpy(pre + J->pre_dst_len + 1, J->msg_blob + J->msg_off[i], mlen);
            uint8_t digest[32];
            fn_sha3_256(pre, plen, digest);
            if (pre != head) free(pre);
            char dec[80];
            size_t dl = fn_u256_to_dec(digest, dec);
            memset(J->out_digits + (size_t)i * 78, 0, 78);
            memcpy(J->out_digits + (size_t)i * 78, dec, dl);
            J->out_lens[i] = (int32_t)dl;
        }
    }
    return NULL;
}

int fn_prehash_digits(const uint8_t *pre_dst, size_t pre_dst_len,
                      const uint8_t *msg_blob, const uint64_t *msg_off,
                      int32_t n, uint8_t *out_digits, int32_t *out_lens,
                      int32_t n_threads) {
    prehash_job J = {pre_dst, pre_dst_len, msg_blob, msg_off, n,
                     out_digits, out_lens, 0, PTHREAD_MUTEX_INITIALIZER};
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    pthread_t th[16];
    for (int t = 0; t < n_threads; t++) pthread_create(&th[t], NULL, prehash_worker, &J);
    for (int t = 0; t < n_threads; t++) pthread_join(th[t], NULL);
    return 0;
}
