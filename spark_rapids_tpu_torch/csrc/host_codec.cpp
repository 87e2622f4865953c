// Host codecs of the port's frame format: LZ4 blocks and, where the system
// has libzstd, zstd at level 1.
//
// A copy of the codec half of the JAX package's native/src/rtpu_native.cpp,
// so frames either package writes decode on the other. Plain C interface,
// loaded through ctypes by shuffle/serializer.py; built with the host
// compiler (kernels/build.py), no CUDA.

#include <cstdint>
#include <cstring>
#ifdef RTPU_WITH_ZSTD
#include <zstd.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// LZ4 block format
// ---------------------------------------------------------------------------

// Compress src[0..n) into dst (capacity dst_cap). Returns compressed size,
// or -1 if dst_cap is too small. Standard LZ4 block format: token byte
// (literal len high nibble, match len low nibble), literals, 2-byte LE
// offset, extension bytes for lengths >= 15.
static inline uint32_t lz4_hash(uint32_t v) {
    return (v * 2654435761u) >> 20;   // 12-bit table
}

int64_t rtpu_lz4_compress(const uint8_t* src, int64_t n,
                          uint8_t* dst, int64_t dst_cap) {
    const int64_t MINMATCH = 4;
    const int64_t MFLIMIT = 12;       // last 12 bytes are always literals
    int32_t table[1 << 12];
    for (auto& t : table) t = -1;

    int64_t ip = 0, op = 0, anchor = 0;
    if (n >= MFLIMIT) {
        const int64_t mflimit = n - MFLIMIT;
        while (ip <= mflimit) {
            uint32_t seq;
            std::memcpy(&seq, src + ip, 4);
            uint32_t h = lz4_hash(seq);
            int64_t ref = table[h];
            table[h] = (int32_t)ip;
            uint32_t refseq;
            bool match = false;
            if (ref >= 0 && ip - ref <= 65535) {
                std::memcpy(&refseq, src + ref, 4);
                match = (refseq == seq);
            }
            if (!match) { ip++; continue; }

            // extend match forward
            int64_t mlen = MINMATCH;
            const int64_t limit = n - 5;   // keep 5 trailing literal bytes
            while (ip + mlen < limit && src[ref + mlen] == src[ip + mlen])
                mlen++;

            int64_t lit = ip - anchor;
            // token + literal extension + literals + offset + match ext
            int64_t need = 1 + lit / 255 + 1 + lit + 2 + (mlen - MINMATCH) / 255 + 1;
            if (op + need > dst_cap) return -1;

            uint8_t* token = dst + op++;
            if (lit >= 15) {
                *token = 15 << 4;
                int64_t rest = lit - 15;
                while (rest >= 255) { dst[op++] = 255; rest -= 255; }
                dst[op++] = (uint8_t)rest;
            } else {
                *token = (uint8_t)(lit << 4);
            }
            std::memcpy(dst + op, src + anchor, lit);
            op += lit;

            uint16_t off = (uint16_t)(ip - ref);
            dst[op++] = off & 0xFF;
            dst[op++] = off >> 8;

            int64_t mrem = mlen - MINMATCH;
            if (mrem >= 15) {
                *token |= 15;
                mrem -= 15;
                while (mrem >= 255) { dst[op++] = 255; mrem -= 255; }
                dst[op++] = (uint8_t)mrem;
            } else {
                *token |= (uint8_t)mrem;
            }
            ip += mlen;
            anchor = ip;
        }
    }
    // trailing literals
    int64_t lit = n - anchor;
    int64_t need = 1 + lit / 255 + 1 + lit;
    if (op + need > dst_cap) return -1;
    uint8_t* token = dst + op++;
    if (lit >= 15) {
        *token = 15 << 4;
        int64_t rest = lit - 15;
        while (rest >= 255) { dst[op++] = 255; rest -= 255; }
        dst[op++] = (uint8_t)rest;
    } else {
        *token = (uint8_t)(lit << 4);
    }
    std::memcpy(dst + op, src + anchor, lit);
    op += lit;
    return op;
}

// Decompress exactly out_n bytes. Returns out_n, or -1 on malformed input.
int64_t rtpu_lz4_decompress(const uint8_t* src, int64_t n,
                            uint8_t* dst, int64_t out_n) {
    int64_t ip = 0, op = 0;
    while (ip < n) {
        uint8_t token = src[ip++];
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > n || op + lit > out_n) return -1;
        std::memcpy(dst + op, src + ip, lit);
        ip += lit; op += lit;
        if (ip >= n) break;   // last sequence has no match part
        if (ip + 2 > n) return -1;
        uint16_t off = src[ip] | (src[ip + 1] << 8);
        ip += 2;
        if (off == 0 || off > op) return -1;
        int64_t mlen = (token & 15);
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if (op + mlen > out_n) return -1;
        // overlapping copy byte-by-byte (offset can be < mlen)
        for (int64_t i = 0; i < mlen; i++) {
            dst[op + i] = dst[op - off + i];
        }
        op += mlen;
    }
    return op == out_n ? op : -1;
}

// ---------------------------------------------------------------------------
// ZSTD (system libzstd; level 1). Without it both return -2.
// ---------------------------------------------------------------------------

#ifdef RTPU_WITH_ZSTD
int64_t rtpu_zstd_compress(const uint8_t* src, int64_t n,
                           uint8_t* dst, int64_t dst_cap) {
    size_t r = ZSTD_compress(dst, (size_t)dst_cap, src, (size_t)n, 1);
    if (ZSTD_isError(r)) return -1;
    return (int64_t)r;
}

int64_t rtpu_zstd_decompress(const uint8_t* src, int64_t n,
                             uint8_t* dst, int64_t dst_cap) {
    size_t r = ZSTD_decompress(dst, (size_t)dst_cap, src, (size_t)n);
    if (ZSTD_isError(r)) return -1;
    return (int64_t)r;
}
#else
int64_t rtpu_zstd_compress(const uint8_t*, int64_t, uint8_t*, int64_t) {
    return -2;
}

int64_t rtpu_zstd_decompress(const uint8_t*, int64_t, uint8_t*, int64_t) {
    return -2;
}
#endif

int32_t rtpu_has_zstd() {
#ifdef RTPU_WITH_ZSTD
    return 1;
#else
    return 0;
#endif
}

}  // extern "C"
