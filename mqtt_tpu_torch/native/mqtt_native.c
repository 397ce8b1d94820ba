/* Native host data-plane core: the port's copy of the JAX package's
 * native/mqtt_native.c; its code is unchanged.
 *
 * The reference broker (xyzj/mqtt-server) is pure Go; its host data plane
 * gets goroutine-cheap concurrency for free. Python asyncio does not, so
 * the byte-level hot paths live here:
 *
 *   - blake2b-64 (RFC 7693) token hashing — bit-identical to Python's
 *     hashlib.blake2b(digest_size=8, salt=...) used by ops/hashing.py, so
 *     host-built flat indexes and native-tokenized topics always agree.
 *   - batch topic tokenization (split on '/', two u32 hashes per level)
 *     feeding the device matcher's input arrays.
 *   - MQTT frame scanning: split a raw read buffer into complete packets
 *     (fixed-header flag validation + variable-byte-integer decode).
 *   - UTF-8 validation with the MQTT NUL rejection rule [MQTT-1.5.4-2].
 *
 * Exposed as a flat C ABI consumed via ctypes
 * (mqtt_tpu_torch/native/__init__.py). The port binds mqtt_hash_token and
 * mqtt_tokenize_topics; the frame functions wait for the packet codec.
 * ops/hashing.py keeps the plain Python versions the tests hold these
 * against.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#if defined(__unix__) || defined(__APPLE__)
#include <errno.h>
#include <sys/socket.h>
#include <sys/uio.h>
#define MQTT_HAVE_SOCKETS 1
#endif

/* ------------------------------------------------------------------ */
/* blake2b (RFC 7693), fixed-output 8 bytes, 16-byte salt, no key     */
/* ------------------------------------------------------------------ */

static const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

static inline uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

static inline uint64_t load64(const uint8_t *p) {
    uint64_t v;
    memcpy(&v, p, 8); /* little-endian hosts only (x86-64 / aarch64) */
    return v;
}

#define G(a, b, c, d, x, y)                                                  \
    do {                                                                     \
        v[a] = v[a] + v[b] + (x);                                            \
        v[d] = rotr64(v[d] ^ v[a], 32);                                      \
        v[c] = v[c] + v[d];                                                  \
        v[b] = rotr64(v[b] ^ v[c], 24);                                      \
        v[a] = v[a] + v[b] + (y);                                            \
        v[d] = rotr64(v[d] ^ v[a], 16);                                      \
        v[c] = v[c] + v[d];                                                  \
        v[b] = rotr64(v[b] ^ v[c], 63);                                      \
    } while (0)

static void b2b_compress(uint64_t h[8], const uint8_t block[128],
                         uint64_t t, int last) {
    uint64_t v[16], m[16];
    int i;
    for (i = 0; i < 16; i++) m[i] = load64(block + i * 8);
    for (i = 0; i < 8; i++) v[i] = h[i];
    for (i = 0; i < 8; i++) v[i + 8] = B2B_IV[i];
    v[12] ^= t; /* low counter word; inputs here are < 2^64 bytes */
    if (last) v[14] = ~v[14];
    for (i = 0; i < 12; i++) {
        const uint8_t *s = B2B_SIGMA[i];
        G(0, 4, 8, 12, m[s[0]], m[s[1]]);
        G(1, 5, 9, 13, m[s[2]], m[s[3]]);
        G(2, 6, 10, 14, m[s[4]], m[s[5]]);
        G(3, 7, 11, 15, m[s[6]], m[s[7]]);
        G(0, 5, 10, 15, m[s[8]], m[s[9]]);
        G(1, 6, 11, 12, m[s[10]], m[s[11]]);
        G(2, 7, 8, 13, m[s[12]], m[s[13]]);
        G(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

/* 8-byte blake2b of `len` bytes with an 8-byte little-endian salt value
 * (zero-padded to the 16-byte salt field, matching hashlib's padding). */
static uint64_t b2b_hash64(const uint8_t *data, size_t len, uint64_t salt) {
    uint64_t h[8];
    uint8_t block[128];
    size_t off = 0;
    int i;
    /* parameter block: digest_length=8, fanout=1, depth=1, salt at 32..47 */
    uint64_t p0 = 8ULL | (1ULL << 16) | (1ULL << 24);
    for (i = 0; i < 8; i++) h[i] = B2B_IV[i];
    h[0] ^= p0;
    h[4] ^= salt;      /* param words 4..5 = salt[0..15]; high half zero */
    while (len - off > 128) {
        b2b_compress(h, data + off, (uint64_t)(off + 128), 0);
        off += 128;
    }
    memset(block, 0, 128);
    memcpy(block, data + off, len - off);
    b2b_compress(h, block, (uint64_t)len, 1);
    return h[0];
}

uint64_t mqtt_hash_token(const uint8_t *data, size_t len, uint64_t salt) {
    return b2b_hash64(data, len, salt);
}

/* ------------------------------------------------------------------ */
/* batch topic tokenization for the device matcher                     */
/* ------------------------------------------------------------------ */

/* Tokenize n topics (UTF-8, concatenated in `buf`, topic i spanning
 * [offsets[i], offsets[i+1])) into per-level hash arrays of shape
 * [n, max_levels]. Mirrors ops/hashing.tokenize_topics exactly:
 * split on '/', hash1 = low 4 bytes, hash2 = high 4 bytes of the 8-byte
 * blake2b digest; lengths clamped at max_levels with overflow flagged;
 * is_dollar set when the first byte is '$'. */
void mqtt_tokenize_topics(const uint8_t *buf, const int64_t *offsets,
                          int64_t n, int64_t max_levels, uint64_t salt,
                          uint32_t *tok1, uint32_t *tok2, int32_t *lengths,
                          uint8_t *is_dollar, uint8_t *overflow) {
    int64_t i;
    for (i = 0; i < n; i++) {
        const uint8_t *s = buf + offsets[i];
        int64_t len = offsets[i + 1] - offsets[i];
        int64_t start = 0, level = 0, pos = 0;
        is_dollar[i] = (len > 0 && s[0] == '$');
        overflow[i] = 0;
        for (pos = 0; pos <= len; pos++) {
            if (pos == len || s[pos] == '/') {
                if (level >= max_levels) {
                    overflow[i] = 1;
                    break;
                }
                uint64_t d = b2b_hash64(s + start, (size_t)(pos - start), salt);
                tok1[i * max_levels + level] = (uint32_t)(d & 0xffffffffULL);
                tok2[i * max_levels + level] = (uint32_t)(d >> 32);
                level++;
                start = pos + 1;
            }
        }
        lengths[i] = (int32_t)level;
    }
}

/* ------------------------------------------------------------------ */
/* MQTT variable byte integer + fixed header + frame scanning          */
/* ------------------------------------------------------------------ */

#define MQTT_MAX_VARINT 268435455

/* Decode a variable byte integer at buf[0..len). Returns the number of
 * bytes consumed (1-4), 0 if more bytes are needed, or -1 on overflow. */
int mqtt_varint_decode(const uint8_t *buf, size_t len, uint32_t *value) {
    uint32_t v = 0;
    int shift = 0, i;
    for (i = 0; i < 4; i++) {
        if ((size_t)i >= len) return 0;
        v |= (uint32_t)(buf[i] & 0x7f) << shift;
        if (v > MQTT_MAX_VARINT) return -1;
        if ((buf[i] & 0x80) == 0) {
            *value = v;
            return i + 1;
        }
        shift += 7;
    }
    return -1; /* 4 continuation bytes */
}

/* Encode value as a variable byte integer into out (>= 4 bytes).
 * Returns bytes written, or -1 if value exceeds the MQTT maximum. */
int mqtt_varint_encode(uint32_t value, uint8_t *out) {
    int n = 0;
    if (value > MQTT_MAX_VARINT) return -1;
    do {
        uint8_t b = value % 128;
        value /= 128;
        if (value > 0) b |= 0x80;
        out[n++] = b;
    } while (value > 0);
    return n;
}

/* Fixed-header first-byte validation, mirroring packets/fixedheader.py
 * (reference packets/fixedheader.go:27-62): per-type flag rules.
 * Returns 0 ok, -1 malformed. */
int mqtt_fh_validate(uint8_t b) {
    uint8_t type = b >> 4;
    uint8_t flags = b & 0x0f;
    switch (type) {
    case 3: { /* PUBLISH: qos<3, dup only with qos>0 */
        uint8_t qos = (flags >> 1) & 0x03;
        uint8_t dup = (flags >> 3) & 0x01;
        if (qos >= 3) return -1;
        if (dup && qos == 0) return -1;
        return 0;
    }
    case 6:  /* PUBREL */
    case 8:  /* SUBSCRIBE */
    case 10: /* UNSUBSCRIBE */
        return flags == 0x02 ? 0 : -1;
    default:
        /* type 0 (reserved) with zero flags passes header validation —
         * the decoder dispatch rejects it with NoValidPacketAvailable,
         * matching packets/fixedheader.py decode + clients.read_packet */
        return flags == 0x00 ? 0 : -1;
    }
}

/* Scan a read buffer for complete MQTT packets. For each complete packet
 * writes (start-of-body offset, first byte, remaining length). Returns the
 * count of complete packets found BEFORE any error, so the caller can
 * still process them. `*consumed` ends at the last complete packet — or at
 * the offending packet's first byte when `*err` is set: -1 malformed fixed
 * header/varint, -2 packet too large ([MQTT-3.2.2-15] on remaining+1,
 * `max_packet_size`>0), 0 ok. */
int64_t mqtt_frame_scan(const uint8_t *buf, int64_t len,
                        int64_t max_frames, uint32_t max_packet_size,
                        int64_t *body_offsets, uint8_t *first_bytes,
                        uint32_t *remainings, int64_t *consumed,
                        int32_t *err) {
    int64_t pos = 0, n = 0;
    *err = 0;
    while (n < max_frames && pos < len) {
        uint32_t remaining;
        int vb;
        if (mqtt_fh_validate(buf[pos]) != 0) {
            *err = -1;
            break;
        }
        if (pos + 1 >= len) break;
        vb = mqtt_varint_decode(buf + pos + 1, (size_t)(len - pos - 1),
                                &remaining);
        if (vb < 0) {
            *err = -1;
            break;
        }
        if (vb == 0) break; /* varint incomplete */
        if (max_packet_size > 0 &&
            (uint64_t)remaining + 1 > (uint64_t)max_packet_size) {
            *err = -2; /* packet too large */
            break;
        }
        if (pos + 1 + vb + (int64_t)remaining > len) break; /* body incomplete */
        first_bytes[n] = buf[pos];
        body_offsets[n] = pos + 1 + vb;
        remainings[n] = remaining;
        n++;
        pos += 1 + vb + (int64_t)remaining;
    }
    *consumed = pos;
    return n;
}

/* ------------------------------------------------------------------ */
/* Batched fan-out flush                                               */
/* ------------------------------------------------------------------ */

/* Write ONE encoded PUBLISH variant frame to many sockets in a single
 * call. The caller (server._fan_out batched path, via ctypes — which
 * releases the GIL for the duration) passes the sockets' fds, the
 * shared frame bytes, and, for QoS>0 variants, the per-target packet
 * ids plus the fixed offset of the 2-byte packet-id field: each target
 * is then written as THREE iovecs (head | its own big-endian id | tail)
 * — encode-once, zero per-target copies. ``id_offset < 0`` means the
 * frame is fully shared (QoS0) and goes out with one send().
 *
 * Sockets are the caller's non-blocking asyncio fds whose transports
 * were verified idle (empty write buffer, empty outbound queue), so a
 * full write is the common case. Per-target results land in ``sent``:
 * bytes written (possibly short on EAGAIN mid-frame), or -errno on
 * error (including EAGAIN-before-anything as -EAGAIN); the caller
 * finishes short/failed targets through the normal transport path,
 * preserving ordering and backpressure accounting. Returns the number
 * of COMPLETE writes. */
int64_t mqtt_fan_flush(const int32_t *fds, int64_t n, const uint8_t *frame,
                       int64_t frame_len, int64_t id_offset,
                       const uint16_t *ids, int64_t *sent) {
#ifdef MQTT_HAVE_SOCKETS
    int64_t complete = 0, i;
    for (i = 0; i < n; i++) {
        int64_t wrote;
        if (id_offset >= 0 && id_offset + 2 <= frame_len) {
            uint8_t idb[2];
            struct iovec iov[3];
            int iovcnt = 0;
            idb[0] = (uint8_t)(ids[i] >> 8);
            idb[1] = (uint8_t)(ids[i] & 0xff);
            if (id_offset > 0) {
                iov[iovcnt].iov_base = (void *)frame;
                iov[iovcnt].iov_len = (size_t)id_offset;
                iovcnt++;
            }
            iov[iovcnt].iov_base = idb;
            iov[iovcnt].iov_len = 2;
            iovcnt++;
            if (id_offset + 2 < frame_len) {
                iov[iovcnt].iov_base = (void *)(frame + id_offset + 2);
                iov[iovcnt].iov_len = (size_t)(frame_len - id_offset - 2);
                iovcnt++;
            }
            wrote = (int64_t)writev(fds[i], iov, iovcnt);
        } else {
#ifdef MSG_NOSIGNAL
            wrote = (int64_t)send(fds[i], frame, (size_t)frame_len,
                                  MSG_NOSIGNAL);
#else
            wrote = (int64_t)send(fds[i], frame, (size_t)frame_len, 0);
#endif
        }
        if (wrote < 0) {
            sent[i] = -(int64_t)errno;
        } else {
            sent[i] = wrote;
            if (wrote == frame_len)
                complete++;
        }
    }
    return complete;
#else
    (void)fds; (void)n; (void)frame; (void)frame_len; (void)id_offset;
    (void)ids; (void)sent;
    return -1; /* platform without writev: caller keeps the Python path */
#endif
}

/* ------------------------------------------------------------------ */
/* Batched read-side frame scanning                                    */
/* ------------------------------------------------------------------ */

/* Scan K read buffers for complete MQTT packets in ONE call — the
 * read-side twin of mqtt_fan_flush: read loops that woke in the same
 * event-loop tick coalesce their buffers so the whole tick pays one
 * GIL-released native call instead of K. Output arrays are strided
 * ``max_frames`` per buffer; per-buffer packet counts land in
 * ``counts``, consumed/err exactly as mqtt_frame_scan. */
void mqtt_frame_scan_multi(int64_t k, const uint8_t *const *bufs,
                           const int64_t *lens, int64_t max_frames,
                           uint32_t max_packet_size, int64_t *body_offsets,
                           uint8_t *first_bytes, uint32_t *remainings,
                           int64_t *counts, int64_t *consumed,
                           int32_t *errs) {
    int64_t i;
    for (i = 0; i < k; i++) {
        counts[i] = mqtt_frame_scan(
            bufs[i], lens[i], max_frames, max_packet_size,
            body_offsets + i * max_frames, first_bytes + i * max_frames,
            remainings + i * max_frames, consumed + i, errs + i);
    }
}

/* ------------------------------------------------------------------ */
/* Re-encrypt fan-out frame assembly                                   */
/* ------------------------------------------------------------------ */

/* Assemble N per-subscriber encrypted PUBLISH frames from one shared
 * encoded head and the batched keystream: frame_i = head || nonce_i ||
 * (plaintext XOR keystream_i). One GIL-released pass replaces N
 * per-subscriber Packet copies + encodes — the encode-once path for
 * encrypted namespaces, whose payload bytes necessarily differ per
 * subscriber but whose frame head does not. ``ks_stride`` is the byte
 * stride between keystream rows (>= pt_len); ``out`` is [n,
 * head_len + nonce_len + pt_len] row-major. */
void mqtt_assemble_frames(const uint8_t *head, int64_t head_len,
                          const uint8_t *nonces, int64_t nonce_len,
                          const uint8_t *keystreams, int64_t ks_stride,
                          const uint8_t *plaintext, int64_t pt_len,
                          int64_t n, uint8_t *out) {
    int64_t frame_len = head_len + nonce_len + pt_len;
    int64_t i, j;
    for (i = 0; i < n; i++) {
        uint8_t *row = out + i * frame_len;
        const uint8_t *ks = keystreams + i * ks_stride;
        memcpy(row, head, (size_t)head_len);
        memcpy(row + head_len, nonces + i * nonce_len, (size_t)nonce_len);
        for (j = 0; j < pt_len; j++)
            row[head_len + nonce_len + j] = plaintext[j] ^ ks[j];
    }
}

/* ------------------------------------------------------------------ */
/* UTF-8 validation with MQTT rules                                    */
/* ------------------------------------------------------------------ */

/* Strict UTF-8 validation rejecting NUL [MQTT-1.5.4-2], overlong forms,
 * surrogates, and values above U+10FFFF. Returns 1 valid, 0 invalid. */
int mqtt_utf8_valid(const uint8_t *s, size_t len) {
    size_t i = 0;
    while (i < len) {
        uint8_t c = s[i];
        if (c == 0x00) return 0;
        if (c < 0x80) {
            i += 1;
        } else if ((c & 0xe0) == 0xc0) {
            if (i + 1 >= len || (s[i + 1] & 0xc0) != 0x80) return 0;
            if (c < 0xc2) return 0; /* overlong */
            i += 2;
        } else if ((c & 0xf0) == 0xe0) {
            if (i + 2 >= len || (s[i + 1] & 0xc0) != 0x80 ||
                (s[i + 2] & 0xc0) != 0x80)
                return 0;
            if (c == 0xe0 && s[i + 1] < 0xa0) return 0; /* overlong */
            if (c == 0xed && s[i + 1] >= 0xa0) return 0; /* surrogate */
            i += 3;
        } else if ((c & 0xf8) == 0xf0) {
            if (i + 3 >= len || (s[i + 1] & 0xc0) != 0x80 ||
                (s[i + 2] & 0xc0) != 0x80 || (s[i + 3] & 0xc0) != 0x80)
                return 0;
            if (c == 0xf0 && s[i + 1] < 0x90) return 0; /* overlong */
            if (c == 0xf4 && s[i + 1] >= 0x90) return 0; /* > U+10FFFF */
            if (c > 0xf4) return 0;
            i += 4;
        } else {
            return 0;
        }
    }
    return 1;
}
