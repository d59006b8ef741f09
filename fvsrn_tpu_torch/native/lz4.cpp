// LZ4 block codec for .cvol volume IO (the port's own copy of the JAX
// package's codec, kept byte for byte in its output).
//
// The reference compresses .cvol payloads with LZ4 through a vendored
// wrapper (reference: renderer/volume.cpp:10 `#include <lz4cpp.hpp>`,
// chunked compress/decompress at volume.cpp:335-380). This is an
// independent implementation of the LZ4 *block* format
// (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md):
//  - literals/match tokens, 4-byte minimum match, 16-bit little-endian
//    offsets, last 5 bytes always literals, matches end >= 12 bytes before
//    the block end.
// Compression hashes 4-byte sequences into a 64K-entry table (greedy
// match, LZ4-fast style). Output interoperates with any standard LZ4
// block decoder.
//
// Built with g++ into build/fvsrn_tpu_torch/ and exposed as a C ABI for
// ctypes (fvsrn_tpu_torch/volume/lz4io.py).

#include <cstdint>
#include <cstring>

namespace {

constexpr int MINMATCH = 4;
constexpr int MFLIMIT = 12;       // matches must end 12B before block end
constexpr int LASTLITERALS = 5;   // last 5 bytes are always literals
constexpr int HASH_LOG = 16;

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_LOG);
}

inline uint8_t* write_length(uint8_t* op, int len) {
    while (len >= 255) {
        *op++ = 255;
        len -= 255;
    }
    *op++ = static_cast<uint8_t>(len);
    return op;
}

}  // namespace

extern "C" {

// Worst-case compressed size for srcLen input (standard LZ4 bound).
int fv_lz4_compress_bound(int srcLen) {
    if (srcLen < 0) return 0;
    return srcLen + srcLen / 255 + 16;
}

// Compress src[0..srcLen) into dst (capacity dstCap).
// Returns compressed size, or 0 on error/overflow.
int fv_lz4_compress(const uint8_t* src, int srcLen, uint8_t* dst,
                    int dstCap) {
    if (srcLen < 0 || dstCap < fv_lz4_compress_bound(srcLen)) return 0;
    const uint8_t* ip = src;
    const uint8_t* const iend = src + srcLen;
    const uint8_t* const mflimit = iend - MFLIMIT;
    const uint8_t* anchor = src;
    uint8_t* op = dst;

    if (srcLen >= MFLIMIT) {
        uint32_t table[1 << HASH_LOG];
        std::memset(table, 0, sizeof(table));
        ip++;  // first byte can't match (offset 0 invalid)
        while (ip <= mflimit) {
            // find a 4-byte match via the hash table
            uint32_t seq = read32(ip);
            uint32_t h = hash4(seq);
            const uint8_t* match = src + table[h];
            table[h] = static_cast<uint32_t>(ip - src);
            if (match >= ip || ip - match > 65535 || read32(match) != seq) {
                ip++;
                continue;
            }
            // extend match backward over pending literals
            while (ip > anchor && match > src && ip[-1] == match[-1]) {
                ip--;
                match--;
            }
            // emit token + literals
            int litLen = static_cast<int>(ip - anchor);
            uint8_t* token = op++;
            if (litLen >= 15) {
                *token = 15 << 4;
                op = write_length(op, litLen - 15);
            } else {
                *token = static_cast<uint8_t>(litLen << 4);
            }
            std::memcpy(op, anchor, litLen);
            op += litLen;
            // offset
            uint16_t offset = static_cast<uint16_t>(ip - match);
            *op++ = static_cast<uint8_t>(offset);
            *op++ = static_cast<uint8_t>(offset >> 8);
            // extend match forward (must stop LASTLITERALS before end)
            const uint8_t* matchEnd = ip + MINMATCH;
            const uint8_t* refEnd = match + MINMATCH;
            const uint8_t* const matchLimit = iend - LASTLITERALS;
            while (matchEnd < matchLimit && *matchEnd == *refEnd) {
                matchEnd++;
                refEnd++;
            }
            int matchLen = static_cast<int>(matchEnd - ip) - MINMATCH;
            if (matchLen >= 15) {
                *token |= 15;
                op = write_length(op, matchLen - 15);
            } else {
                *token |= static_cast<uint8_t>(matchLen);
            }
            ip = matchEnd;
            anchor = ip;
            if (ip <= mflimit) {
                // index the position two back to improve future matches
                table[hash4(read32(ip - 2))] =
                    static_cast<uint32_t>(ip - 2 - src);
            }
        }
    }
    // trailing literals
    int litLen = static_cast<int>(iend - anchor);
    uint8_t* token = op++;
    if (litLen >= 15) {
        *token = 15 << 4;
        op = write_length(op, litLen - 15);
    } else {
        *token = static_cast<uint8_t>(litLen << 4);
    }
    std::memcpy(op, anchor, litLen);
    op += litLen;
    return static_cast<int>(op - dst);
}

// Decompress an LZ4 block src[0..srcLen) into dst (exactly dstLen bytes
// expected). Returns dstLen on success, negative on corrupt input.
int fv_lz4_decompress(const uint8_t* src, int srcLen, uint8_t* dst,
                      int dstLen) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + srcLen;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dstLen;

    while (ip < iend) {
        uint8_t token = *ip++;
        // literals
        int litLen = token >> 4;
        if (litLen == 15) {
            uint8_t s;
            do {
                if (ip >= iend) return -1;
                s = *ip++;
                litLen += s;
            } while (s == 255);
        }
        if (ip + litLen > iend || op + litLen > oend) return -2;
        std::memcpy(op, ip, litLen);
        ip += litLen;
        op += litLen;
        if (ip >= iend) break;  // end of block after literals
        // match
        if (ip + 2 > iend) return -3;
        int offset = ip[0] | (ip[1] << 8);
        ip += 2;
        if (offset == 0 || op - dst < offset) return -4;
        int matchLen = token & 15;
        if (matchLen == 15) {
            uint8_t s;
            do {
                if (ip >= iend) return -5;
                s = *ip++;
                matchLen += s;
            } while (s == 255);
        }
        matchLen += MINMATCH;
        if (op + matchLen > oend) return -6;
        const uint8_t* match = op - offset;
        // byte-wise copy: overlapping matches are the point of LZ4
        for (int i = 0; i < matchLen; ++i) op[i] = match[i];
        op += matchLen;
    }
    return static_cast<int>(op - dst);
}

// Decompress an LZ4 block with a dictionary prefix: dst points at the
// write position inside a larger contiguous buffer whose preceding
// prefixLen bytes hold already-decoded output that matches may reference.
// This is the streaming-decode case (LZ4_decompress_safe_continue with
// contiguous destination) used by the reference's vendored lz4cpp when
// chunking one .cvol payload: chunk N may back-reference chunk N-1.
// The produced size is implicit in the block; returns bytes written
// (<= dstCap), negative on corrupt input.
int fv_lz4_decompress_prefix(const uint8_t* src, int srcLen, uint8_t* dst,
                             int dstCap, int prefixLen) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + srcLen;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dstCap;

    while (ip < iend) {
        uint8_t token = *ip++;
        int litLen = token >> 4;
        if (litLen == 15) {
            uint8_t s;
            do {
                if (ip >= iend) return -1;
                s = *ip++;
                litLen += s;
            } while (s == 255);
        }
        if (ip + litLen > iend || op + litLen > oend) return -2;
        std::memcpy(op, ip, litLen);
        ip += litLen;
        op += litLen;
        if (ip >= iend) break;
        if (ip + 2 > iend) return -3;
        int offset = ip[0] | (ip[1] << 8);
        ip += 2;
        // matches may reach back into the prefix window
        if (offset == 0 || (op - dst) + prefixLen < offset) return -4;
        int matchLen = token & 15;
        if (matchLen == 15) {
            uint8_t s;
            do {
                if (ip >= iend) return -5;
                s = *ip++;
                matchLen += s;
            } while (s == 255);
        }
        matchLen += MINMATCH;
        if (op + matchLen > oend) return -6;
        const uint8_t* match = op - offset;
        for (int i = 0; i < matchLen; ++i) op[i] = match[i];
        op += matchLen;
    }
    return static_cast<int>(op - dst);
}

}  // extern "C"
