// Host helpers of sketchtpu_torch: CRC32C, the Snappy raw block codec and
// the framed stream's decoder (.skm and .ski files are snappy-framed,
// sketchlib.rust src/sketch/multisketch.rs:80-103), the FASTQ k-mer count
// filter, whose result depends on read order (src/sketch/mod.rs:198-208
// with src/hashing/bloom_filter.rs), the bin minimum of the host sketch
// oracle, f32 text formatting with the reference's digits, the DNA and AA
// fastx parsers, the .ski index codec (one bin's msgpack map of roaring
// bitmaps written; every bin read into the sign matrix, and the name
// lists), and the .skm metadata decoder (its CBOR into columns).
//
// Formats are implemented from their public specifications
// (https://github.com/google/snappy/blob/main/format_description.txt).
//
// sketchtpu_torch/_native.py builds it with
//   g++ -O3 -std=c++17 -shared -fPIC -o <lib>.so native.cpp

#include <algorithm>
#include <cstdint>
#include <charconv>
#include <cmath>
#include <cstring>
#include <cstddef>
#include <memory>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli): the SSE4.2 crc32 instruction where the CPU has it
// (checked at run time; the function alone is built for SSE4.2), else a
// slice-by-8 table.
// ---------------------------------------------------------------------------

static uint32_t crc32c_table[8][256];

static bool crc32c_init() {
    const uint32_t poly = 0x82F63B78u;  // reflected CRC32C polynomial
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t crc = i;
        for (int j = 0; j < 8; j++)
            crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
        crc32c_table[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t crc = crc32c_table[0][i];
        for (int s = 1; s < 8; s++) {
            crc = crc32c_table[0][crc & 0xFF] ^ (crc >> 8);
            crc32c_table[s][i] = crc;
        }
    }
    return true;
}

// the register form (no pre- or post-inversion) of either implementation
static uint32_t crc32c_sw(const uint8_t* data, size_t len, uint32_t crc) {
    static const bool ready = crc32c_init();  // once, thread-safe
    (void)ready;
    size_t i = 0;
    while (len - i >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, data + i, 4);
        memcpy(&hi, data + i + 4, 4);
        lo ^= crc;
        crc = crc32c_table[7][lo & 0xFF] ^ crc32c_table[6][(lo >> 8) & 0xFF] ^
              crc32c_table[5][(lo >> 16) & 0xFF] ^ crc32c_table[4][lo >> 24] ^
              crc32c_table[3][hi & 0xFF] ^ crc32c_table[2][(hi >> 8) & 0xFF] ^
              crc32c_table[1][(hi >> 16) & 0xFF] ^ crc32c_table[0][hi >> 24];
        i += 8;
    }
    for (; i < len; i++)
        crc = crc32c_table[0][(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(const uint8_t* data, size_t len, uint32_t crc) {
    uint64_t c = crc;
    size_t i = 0;
    for (; len - i >= 8; i += 8) {
        uint64_t v;
        memcpy(&v, data + i, 8);
        c = __builtin_ia32_crc32di(c, v);
    }
    uint32_t c32 = (uint32_t)c;
    for (; i < len; i++) c32 = __builtin_ia32_crc32qi(c32, data[i]);
    return c32;
}

static bool crc32c_have_hw() {
    __builtin_cpu_init();
    return __builtin_cpu_supports("sse4.2");
}
#endif

static uint32_t crc32c(const uint8_t* data, size_t len, uint32_t seed) {
#if defined(__x86_64__)
    static const bool hw = crc32c_have_hw();
    if (hw) return ~crc32c_hw(data, len, ~seed);
#endif
    return ~crc32c_sw(data, len, ~seed);
}

uint32_t stpu_crc32c(const uint8_t* data, size_t len, uint32_t seed) {
    return crc32c(data, len, seed);
}

// Software only: the tests hold the instruction against it.
uint32_t stpu_crc32c_table(const uint8_t* data, size_t len, uint32_t seed) {
    return ~crc32c_sw(data, len, ~seed);
}

// ---------------------------------------------------------------------------
// Snappy raw block format.
// ---------------------------------------------------------------------------

static size_t write_varint(uint8_t* out, uint64_t v) {
    size_t n = 0;
    while (v >= 0x80) {
        out[n++] = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    out[n++] = (uint8_t)v;
    return n;
}

// Maximum compressed size for `n` input bytes (worst case all literals).
size_t stpu_snappy_max_compressed(size_t n) { return 32 + n + n / 6; }

// LZ77 compressor emitting the snappy raw element stream. This is a
// faithful re-implementation of the classic snappy block algorithm
// (64 KiB blocks, 2^8..2^14-entry hash table sized to the block,
// multiplicative hash 0x1e35a7bd, the skip/32 miss accelerator, and the
// 68/64-split copy emission) so that the emitted bytes are identical to
// what the reference's `snap` crate writes — .skm/.ski containers built
// here byte-match reference-written fixtures, not just decode-compat.
// Returns compressed size, or 0 on error (out buffer too small).

static inline uint32_t snappy_load32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;  // little-endian hosts only (x86-64/aarch64)
}

static inline uint32_t snappy_hash(uint32_t bytes, int shift) {
    return (bytes * 0x1E35A7BDu) >> shift;
}

// Emit a literal run [start, start+len) into out. len <= 2^32.
static bool snappy_emit_literal(const uint8_t* in, size_t start, size_t len,
                                uint8_t* out, size_t out_cap, size_t& op) {
    if (len == 0) return true;
    size_t l = len - 1;
    if (l < 60) {
        if (op + 1 + len > out_cap) return false;
        out[op++] = (uint8_t)(l << 2);
    } else if (l < (1u << 8)) {
        if (op + 2 + len > out_cap) return false;
        out[op++] = (uint8_t)(60 << 2);
        out[op++] = (uint8_t)l;
    } else if (l < (1u << 16)) {
        if (op + 3 + len > out_cap) return false;
        out[op++] = (uint8_t)(61 << 2);
        out[op++] = (uint8_t)l;
        out[op++] = (uint8_t)(l >> 8);
    } else if (l < (1ull << 24)) {
        if (op + 4 + len > out_cap) return false;
        out[op++] = (uint8_t)(62 << 2);
        out[op++] = (uint8_t)l;
        out[op++] = (uint8_t)(l >> 8);
        out[op++] = (uint8_t)(l >> 16);
    } else {
        if (op + 5 + len > out_cap) return false;
        out[op++] = (uint8_t)(63 << 2);
        out[op++] = (uint8_t)l;
        out[op++] = (uint8_t)(l >> 8);
        out[op++] = (uint8_t)(l >> 16);
        out[op++] = (uint8_t)(l >> 24);
    }
    memcpy(out + op, in + start, len);
    op += len;
    return true;
}

// One copy element of length 4..64 (type-1 two-byte form when it fits).
static bool snappy_emit_copy_upto64(size_t offset, size_t len, uint8_t* out,
                                    size_t out_cap, size_t& op) {
    if (len < 12 && offset < 2048) {
        if (op + 2 > out_cap) return false;
        out[op++] =
            (uint8_t)(1 | (((len - 4) & 7) << 2) | ((offset >> 8) << 5));
        out[op++] = (uint8_t)(offset & 0xFF);
    } else {
        if (op + 3 > out_cap) return false;
        out[op++] = (uint8_t)(2 | ((len - 1) << 2));
        out[op++] = (uint8_t)(offset & 0xFF);
        out[op++] = (uint8_t)(offset >> 8);
    }
    return true;
}

// Copy emission with the reference algorithm's exact chunking: 64s while
// len >= 68, then a 60 if len > 64, then the remainder.
static bool snappy_emit_copy(size_t offset, size_t len, uint8_t* out,
                             size_t out_cap, size_t& op) {
    while (len >= 68) {
        if (!snappy_emit_copy_upto64(offset, 64, out, out_cap, op))
            return false;
        len -= 64;
    }
    if (len > 64) {
        if (!snappy_emit_copy_upto64(offset, 60, out, out_cap, op))
            return false;
        len -= 60;
    }
    return snappy_emit_copy_upto64(offset, len, out, out_cap, op);
}

// Compress one block (<= 64 KiB) appending elements to out at op.
static bool snappy_compress_block(const uint8_t* in, size_t n, uint8_t* out,
                                  size_t out_cap, size_t& op,
                                  uint16_t* table) {
    size_t table_size = 256;
    const size_t kMaxTableSize = 1u << 14;
    while (table_size < kMaxTableSize && table_size < n) table_size <<= 1;
    memset(table, 0, table_size * sizeof(uint16_t));
    const int shift = 32 - __builtin_ctzll(table_size);

    const size_t kInputMarginBytes = 15;
    size_t next_emit = 0;
    size_t ip = 0;
    if (n >= kInputMarginBytes) {
        const size_t ip_limit = n - kInputMarginBytes;
        ip = 1;
        uint32_t next_hash = snappy_hash(snappy_load32(in + ip), shift);
        for (;;) {
            uint32_t skip = 32;
            size_t next_ip = ip;
            size_t candidate;
            do {
                ip = next_ip;
                uint32_t hash = next_hash;
                uint32_t bytes_between = skip++ >> 5;
                next_ip = ip + bytes_between;
                if (next_ip > ip_limit) goto emit_remainder;
                next_hash = snappy_hash(snappy_load32(in + next_ip), shift);
                candidate = table[hash];
                table[hash] = (uint16_t)ip;
            } while (snappy_load32(in + ip) != snappy_load32(in + candidate));

            if (!snappy_emit_literal(in, next_emit, ip - next_emit, out,
                                     out_cap, op))
                return false;

            uint64_t input_bytes = 0;
            for (;;) {
                size_t base = ip;
                size_t matched = 4;
                while (ip + matched < n &&
                       in[candidate + matched] == in[ip + matched])
                    matched++;
                ip += matched;
                if (!snappy_emit_copy(base - candidate, matched, out,
                                      out_cap, op))
                    return false;
                next_emit = ip;
                if (ip >= ip_limit) goto emit_remainder;
                memcpy(&input_bytes, in + ip - 1, 8);
                uint32_t prev_hash =
                    snappy_hash((uint32_t)input_bytes, shift);
                table[prev_hash] = (uint16_t)(ip - 1);
                uint32_t cur_hash =
                    snappy_hash((uint32_t)(input_bytes >> 8), shift);
                candidate = table[cur_hash];
                table[cur_hash] = (uint16_t)ip;
                if ((uint32_t)(input_bytes >> 8) !=
                    snappy_load32(in + candidate))
                    break;
            }
            ip++;
            next_hash = snappy_hash(snappy_load32(in + ip), shift);
        }
    }
emit_remainder:
    return snappy_emit_literal(in, next_emit, n - next_emit, out, out_cap,
                               op);
}

size_t stpu_snappy_compress(const uint8_t* in, size_t n, uint8_t* out,
                            size_t out_cap) {
    if (out_cap < 16) return 0;
    size_t op = write_varint(out, n);
    if (n == 0) return op;
    const size_t kBlockSize = 1u << 16;
    std::vector<uint16_t> table(1u << 14);
    for (size_t pos = 0; pos < n; pos += kBlockSize) {
        size_t blk = n - pos < kBlockSize ? n - pos : kBlockSize;
        if (!snappy_compress_block(in + pos, blk, out, out_cap, op,
                                   table.data()))
            return 0;
    }
    return op;
}

// Decompresses a snappy raw block. Returns the uncompressed size, or
// (size_t)-1 on malformed input / output overflow.
size_t stpu_snappy_decompress(const uint8_t* in, size_t n, uint8_t* out,
                              size_t out_cap) {
    size_t ip = 0;
    // read uncompressed-length varint
    uint64_t ulen = 0;
    int shift = 0;
    while (true) {
        if (ip >= n || shift > 63) return (size_t)-1;
        uint8_t b = in[ip++];
        ulen |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if (ulen > out_cap) return (size_t)-1;
    // Writes stay below ulen: a frame's chunks share one buffer. Away
    // from either end, a short literal moves 16 bytes and a copy whole
    // 8-byte words (the bytes past its length are written over next)
    size_t op = 0;
    while (ip < n) {
        uint8_t tag = in[ip++];
        uint32_t kind = tag & 3;
        if (kind == 0) {  // literal
            size_t len = (tag >> 2) + 1;
            if (len <= 16 && n - ip >= 16 && ulen - op >= 16) {
                memcpy(out + op, in + ip, 16);
                ip += len;
                op += len;
                continue;
            }
            if (len > 60) {
                size_t extra = len - 60;
                if (ip + extra > n) return (size_t)-1;
                len = 0;
                for (size_t i = 0; i < extra; i++) len |= (size_t)in[ip + i] << (8 * i);
                len += 1;
                ip += extra;
            }
            if (ip + len > n || op + len > ulen) return (size_t)-1;
            memcpy(out + op, in + ip, len);
            ip += len;
            op += len;
        } else {
            size_t len, offset;
            if (kind == 1) {
                len = ((tag >> 2) & 7) + 4;
                if (ip >= n) return (size_t)-1;
                offset = ((size_t)(tag >> 5) << 8) | in[ip++];
            } else if (kind == 2) {
                len = (tag >> 2) + 1;
                if (ip + 2 > n) return (size_t)-1;
                offset = (size_t)in[ip] | ((size_t)in[ip + 1] << 8);
                ip += 2;
            } else {
                len = (tag >> 2) + 1;
                if (ip + 4 > n) return (size_t)-1;
                offset = (size_t)in[ip] | ((size_t)in[ip + 1] << 8) |
                         ((size_t)in[ip + 2] << 16) | ((size_t)in[ip + 3] << 24);
                ip += 4;
            }
            if (offset == 0 || offset > op || op + len > ulen) return (size_t)-1;
            uint8_t* d = out + op;
            const uint8_t* src = d - offset;
            op += len;
            // with offset >= 8 a word never reads bytes this copy writes;
            // an overlapping (RLE) copy goes byte by byte
            if (offset >= 8 && ulen - op >= 8) {
                for (size_t i = 0; i < len; i += 8) memcpy(d + i, src + i, 8);
                continue;
            }
            size_t i = 0;
            if (offset >= 8)
                for (; i + 8 <= len; i += 8) memcpy(d + i, src + i, 8);
            for (; i < len; i++) d[i] = src[i];
        }
    }
    return op == ulen ? op : (size_t)-1;
}

// ---------------------------------------------------------------------------
// Snappy framing format (framing_format.txt), the whole stream at once:
// stpu_snappy_frame_scan walks the chunk headers and gives each data
// chunk's place in the input and in one output buffer, and
// stpu_snappy_frame_chunks decodes a range of them into it (ranges on
// threads of their own). Chunk types as formats/snappy.py takes them:
// compressed and uncompressed data, padding and the skippable 0x80-0xFD,
// a repeated stream identifier; anything else, a chunk past the end, a
// malformed block or a checksum mismatch is left to the Python path,
// which raises its own error.
// ---------------------------------------------------------------------------

static const uint8_t kStreamIdentifier[10] = {0xff, 0x06, 0x00, 0x00, 's',
                                              'N',  'a',  'P',  'p',  'Y'};

// With info NULL, count the data chunks and their uncompressed bytes
// (*total); with info, also write each one's (body offset, body length,
// output offset, uncompressed length). Returns the data chunks, or -1.
int64_t stpu_snappy_frame_scan(const uint8_t* in, int64_t n, int64_t* info,
                               int64_t* total) {
    if (n < 10 || memcmp(in, kStreamIdentifier, 10) != 0) return -1;
    int64_t pos = 10, chunks = 0, out = 0;
    while (pos < n) {
        if (n - pos < 4) return -1;
        uint8_t type = in[pos];
        int64_t len = in[pos + 1] | (in[pos + 2] << 8) | (in[pos + 3] << 16);
        int64_t body = pos + 4;
        if (len > n - body) return -1;
        pos = body + len;
        if (type == 0xFF || type >= 0x80) continue;  // skippable
        if (type > 0x01 || len < 4) return -1;
        int64_t ulen = len - 4;
        if (type == 0x00) {
            // the block's uncompressed length; a block expands 64 / 3
            // times at most (a 3-byte copy element of 64 bytes)
            uint64_t v = 0;
            int64_t p = body + 4;
            for (int shift = 0;; shift += 7) {
                if (p >= pos || shift > 63) return -1;
                uint8_t b = in[p++];
                v |= (uint64_t)(b & 0x7F) << shift;
                if (!(b & 0x80)) break;
            }
            if (v > 22 * (uint64_t)len) return -1;
            ulen = (int64_t)v;
        }
        if (info) {
            int64_t* e = info + 4 * chunks;
            e[0] = body;
            e[1] = len;
            e[2] = out;
            e[3] = ulen;
        }
        chunks++;
        out += ulen;
    }
    *total = out;
    return chunks;
}

// Decode data chunks [lo, hi) of a scanned stream into out, checking each
// chunk's masked CRC-32C when verify. Returns 0, or -1.
int64_t stpu_snappy_frame_chunks(const uint8_t* in, const int64_t* info,
                                 int64_t lo, int64_t hi, uint8_t* out,
                                 int verify) {
    for (int64_t c = lo; c < hi; c++) {
        const int64_t* e = info + 4 * c;
        const uint8_t* body = in + e[0];
        uint8_t* dst = out + e[2];
        size_t got = (size_t)e[3];
        if (body[-4] == 0x00)  // compressed: exactly the length scanned
            got = stpu_snappy_decompress(body + 4, (size_t)(e[1] - 4), dst,
                                         got);
        else
            memcpy(dst, body + 4, got);
        if (got == (size_t)-1) return -1;
        if (verify) {
            uint32_t crc = body[0] | (body[1] << 8) | (body[2] << 16) |
                           ((uint32_t)body[3] << 24);
            uint32_t c32 = crc32c(dst, got, 0);
            if ((((c32 >> 15) | (c32 << 17)) + 0xA282EAD8u) != crc) return -1;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// FASTQ min-count filter + bin minimum (order-dependent sequential loop).
//
// Mirrors Sketch::bin_sign with a KmerFilter
// (sketchlib.rust src/sketch/mod.rs:198-208,
//  src/hashing/bloom_filter.rs:43-152): a sign only updates
// its bin minimum if it is strictly smaller than the current minimum AND the
// count filter (blocked bloom filter + exact counts for >=3) has seen the
// k-mer min_count times. The bloom filter is only consulted for signs that
// would improve their bin, so the result depends on stream order.
// ---------------------------------------------------------------------------

struct CountFilter {
    static const size_t BLOOM_WIDTH = 1ull << 27;
    static const size_t BITS_PER_ENTRY = 12;
    std::vector<uint64_t> buffer;
    std::unordered_map<uint64_t, uint16_t> counts;
    uint16_t min_count;

    explicit CountFilter(uint16_t mc) : min_count(mc) {
        double sz = (double)BLOOM_WIDTH * ((double)BITS_PER_ENTRY / 8.0) / 64.0;
        size_t buf_size = (size_t)(sz + 0.5);
        if (mc >= 2) buffer.assign(buf_size, 0);
    }

    static uint64_t cheap_mix(uint64_t key) {
        return (key ^ (key >> 31)) * 0x85D059AA333121CFull;
    }
    static uint64_t reduce(uint64_t key, uint64_t range) {
        return (uint64_t)(((unsigned __int128)key * range) >> 64);
    }
    static uint64_t fingerprint(uint64_t key) {
        return (1ull << (key & 63)) | (1ull << ((key >> 6) & 63)) |
               (1ull << ((key >> 12) & 63)) | (1ull << ((key >> 18) & 63)) |
               (1ull << ((key >> 24) & 63));
    }
    bool bloom_add_and_check(uint64_t key) {
        uint64_t f = fingerprint(key);
        uint64_t& v = buffer[reduce(cheap_mix(key), buffer.size())];
        if ((v & f) == f) return true;
        v |= f;
        return false;
    }
    // returns 0 if passed (Ordering::Equal), nonzero otherwise
    int filter(uint64_t hash) {
        if (min_count <= 1) return 0;
        if (min_count == 2) return bloom_add_and_check(hash) ? 0 : -1;
        if (!bloom_add_and_check(hash)) return -1;
        uint16_t count;
        auto it = counts.find(hash);
        if (it == counts.end()) {
            counts.emplace(hash, 2);
            count = 2;
        } else {
            if (it->second < 0xFFFF) it->second++;
            count = it->second;
        }
        return min_count == count ? 0 : (min_count < count ? -1 : 1);
    }
};

// signs: stream of sign values (already reduced mod 2^61-1), in sequence
// order. bins (len nbins) must be pre-filled with UINT64_MAX.
void stpu_filter_bin_signs(const uint64_t* signs, size_t n, uint16_t min_count,
                           uint64_t binsize, uint64_t* bins, size_t nbins) {
    CountFilter filter(min_count);
    for (size_t i = 0; i < n; i++) {
        uint64_t sign = signs[i];
        size_t bin = (size_t)(sign / binsize);
        if (bin >= nbins) continue;
        if (sign < bins[bin] && filter.filter(sign) == 0) bins[bin] = sign;
    }
}

// Unfiltered variant (FASTA path) for fast host-side oracle use.
void stpu_bin_signs(const uint64_t* signs, size_t n, uint64_t binsize,
                    uint64_t* bins, size_t nbins) {
    for (size_t i = 0; i < n; i++) {
        uint64_t sign = signs[i];
        size_t bin = (size_t)(sign / binsize);
        if (bin < nbins && sign < bins[bin]) bins[bin] = sign;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// f32 text formatting (Rust `Display` semantics: shortest round-trip digits,
// positional notation, no trailing ".0") and bulk distance-line assembly.
// std::to_chars produces the shortest round-trip form but may pick scientific
// notation; the exponent is expanded to positional here so output matches the
// reference byte-for-byte (distance_matrix.rs:175-209).
// ---------------------------------------------------------------------------

static int fmt_f32_positional(float v, char* out) {
    if (std::isnan(v)) { std::memcpy(out, "NaN", 3); return 3; }
    if (std::isinf(v)) {
        if (v < 0) { std::memcpy(out, "-inf", 4); return 4; }
        std::memcpy(out, "inf", 3); return 3;
    }
    char tmp[48];
    auto res = std::to_chars(tmp, tmp + sizeof(tmp), v);
    int n = (int)(res.ptr - tmp);
    int epos = -1;
    for (int i = 0; i < n; i++) {
        if (tmp[i] == 'e') { epos = i; break; }
    }
    if (epos < 0) { std::memcpy(out, tmp, n); return n; }

    // scientific: [-]D[.DDDD]e[-+]XX -> positional
    int p = 0, o = 0;
    if (tmp[0] == '-') { out[o++] = '-'; p = 1; }
    char digits[40];
    int nd = 0;
    for (int i = p; i < epos; i++)
        if (tmp[i] != '.') digits[nd++] = tmp[i];
    int exp = 0, esign = 1, i = epos + 1;
    if (tmp[i] == '-') { esign = -1; i++; } else if (tmp[i] == '+') { i++; }
    for (; i < n; i++) exp = exp * 10 + (tmp[i] - '0');
    exp *= esign;
    // value = digits[0].digits[1:] * 10^exp
    if (exp >= nd - 1) {
        for (int d = 0; d < nd; d++) out[o++] = digits[d];
        for (int z = 0; z < exp - (nd - 1); z++) out[o++] = '0';
    } else if (exp >= 0) {
        for (int d = 0; d <= exp; d++) out[o++] = digits[d];
        out[o++] = '.';
        for (int d = exp + 1; d < nd; d++) out[o++] = digits[d];
    } else {
        out[o++] = '0'; out[o++] = '.';
        for (int z = 0; z < -exp - 1; z++) out[o++] = '0';
        for (int d = 0; d < nd; d++) out[o++] = digits[d];
    }
    return o;
}

extern "C" {

// Bulk "row\tcol\tv1[\tv2]\n" line assembly.
// names_r/off_r: row-name table (name i = bytes [off[i], off[i+1]));
// names_c/off_c: column-name table; rows/cols: per-line indices;
// v2 == nullptr -> single-value lines. Returns bytes written, or -1 if the
// output capacity would be exceeded.
int64_t stpu_format_dist_lines(
    const char* names_r, const int64_t* off_r,
    const char* names_c, const int64_t* off_c,
    const int32_t* rows, const int32_t* cols,
    const float* v1, const float* v2,
    int64_t n, char* out, int64_t cap) {
    int64_t o = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t r0 = off_r[rows[i]], r1 = off_r[rows[i] + 1];
        int64_t c0 = off_c[cols[i]], c1 = off_c[cols[i] + 1];
        int64_t need = (r1 - r0) + (c1 - c0) + 2 * 64 + 4;
        if (o + need > cap) return -1;
        std::memcpy(out + o, names_r + r0, r1 - r0); o += r1 - r0;
        out[o++] = '\t';
        std::memcpy(out + o, names_c + c0, c1 - c0); o += c1 - c0;
        out[o++] = '\t';
        o += fmt_f32_positional(v1[i], out + o);
        if (v2 != nullptr) {
            out[o++] = '\t';
            o += fmt_f32_positional(v2[i], out + o);
        }
        out[o++] = '\n';
    }
    return o;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// DNA fastx parsing: the per-line Python loop is the sketch pipeline's
// host bottleneck on large inputs. Operates on the fully decompressed byte
// buffer; semantics replicate ingest/fastx.read_dna_sample exactly
// (line strip(), blank-line tolerance, per-record break, quality-byte
// filter against raw PHRED+33, break = #valid bases before each invalid).
// Returns 0 on success, negative on malformed input (caller falls back to
// the Python parser for its error messages).
// ---------------------------------------------------------------------------

namespace {

struct DnaParseOut {
    uint8_t* codes;       // caller-allocated, capacity n
    int64_t* breaks;      // caller-allocated, capacity n + 1 (worst case)
    int64_t n_codes = 0;
    int64_t n_breaks = 0;
    int64_t acgt[4] = {0, 0, 0, 0};
    int64_t non_acgt = 0;
};

inline bool is_space(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
           c == '\f';
}

// [s, e) with ascii whitespace stripped from both ends
inline void strip_span(const uint8_t* b, int64_t& s, int64_t& e) {
    while (s < e && is_space(b[s])) s++;
    while (e > s && is_space(b[e - 1])) e--;
}

inline void emit_seq(const uint8_t* seq, const uint8_t* qual, int64_t len,
                     const uint8_t* enc, int min_qual, DnaParseOut& o) {
    // one record's sequence (qual may be null): append codes + breaks
    int64_t rec_valid = 0;
    for (int64_t i = 0; i < len; i++) {
        uint8_t code = enc[seq[i]];
        bool ok = code < 4;
        if (qual != nullptr && min_qual > 0 && qual[i] < (uint8_t)min_qual)
            ok = false;
        if (ok) {
            o.codes[o.n_codes++] = code;
            o.acgt[code]++;
            rec_valid++;
        } else {
            o.non_acgt++;
            o.breaks[o.n_breaks++] = o.n_codes;  // #valid before this base
        }
    }
    (void)rec_valid;
    o.breaks[o.n_breaks++] = o.n_codes;  // end-of-record break
}

}  // namespace

extern "C" {

// buf: whole decompressed file; fmt: 0 = fasta, 1 = fastq.
// codes cap >= n; breaks cap >= n + #records + 1 (n + n/2 is safe: every
// break consumes an input byte or terminates a record of >= 2 lines).
int stpu_parse_dna(const uint8_t* buf, int64_t n, int fmt,
                   const uint8_t* enc, int min_qual, uint8_t* codes,
                   int64_t* breaks, int64_t* n_codes, int64_t* n_breaks,
                   int64_t* acgt, int64_t* non_acgt) {
    DnaParseOut o;
    o.codes = codes;
    o.breaks = breaks;
    int64_t pos = 0;
    if (fmt == 0) {
        // FASTA: accumulate body lines per record; process base-by-base,
        // breaks only depend on running valid count so no buffering needed
        bool started = false;
        bool pending_record = false;  // emitted bases since last header?
        while (pos < n) {
            int64_t e = pos;
            while (e < n && buf[e] != '\n') e++;
            int64_t s = pos;
            int64_t se = e;
            strip_span(buf, s, se);
            pos = e + 1;
            if (s == se) continue;  // blank line
            if (buf[s] == '>') {
                if (started && pending_record) {
                    o.breaks[o.n_breaks++] = o.n_codes;  // end previous record
                }
                started = true;
                pending_record = true;
                continue;
            }
            if (!started) return -1;
            // body line: no end-of-record break yet
            for (int64_t i = s; i < se; i++) {
                uint8_t code = enc[buf[i]];
                if (code < 4) {
                    o.codes[o.n_codes++] = code;
                    o.acgt[code]++;
                } else {
                    o.non_acgt++;
                    o.breaks[o.n_breaks++] = o.n_codes;
                }
            }
        }
        if (started && pending_record)
            o.breaks[o.n_breaks++] = o.n_codes;
    } else {
        // FASTQ: 4-line records, blank lines tolerated between records
        while (pos < n) {
            int64_t e = pos;
            while (e < n && buf[e] != '\n') e++;
            int64_t hs = pos, he = e;
            strip_span(buf, hs, he);
            pos = e + 1;
            if (hs == he) continue;
            if (buf[hs] != '@') return -2;
            // seq line
            if (pos >= n) return -3;
            e = pos;
            while (e < n && buf[e] != '\n') e++;
            int64_t ss = pos, se = e;
            strip_span(buf, ss, se);
            pos = e + 1;
            // plus line (must start with '+', unstripped leading check on
            // the raw line like Python's startswith on the readline)
            if (pos >= n) return -4;
            e = pos;
            while (e < n && buf[e] != '\n') e++;
            if (buf[pos] != '+') return -5;
            pos = e + 1;
            // qual line
            if (pos > n) return -6;
            e = pos;
            while (e < n && buf[e] != '\n') e++;
            int64_t qs = pos, qe = e;
            strip_span(buf, qs, qe);
            pos = e + 1;
            if (qe - qs != se - ss) return -7;
            emit_seq(buf + ss, buf + qs, se - ss, enc, min_qual, o);
        }
    }
    *n_codes = o.n_codes;
    *n_breaks = o.n_breaks;
    for (int i = 0; i < 4; i++) acgt[i] = o.acgt[i];
    *non_acgt = o.non_acgt;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// AA fasta parsing: like stpu_parse_dna but emits the record bytes with
// invalid residues replaced by a separator byte (aahash_iterator.rs:100-107
// keeps invalid residues in-stream as SEQSEP), plus per-record end offsets
// so the caller can split records (--concat-fasta) or join them with SEQSEP.
// Returns 0 on success, -1 on malformed input (caller falls back to Python).
// ---------------------------------------------------------------------------

extern "C" {

int stpu_parse_aa(const uint8_t* buf, int64_t n, const uint8_t* valid_tab,
                  uint8_t sep, uint8_t* seq, int64_t* rec_off,
                  int64_t* n_seq, int64_t* n_rec, int64_t* invalid) {
    int64_t pos = 0, o = 0, recs = 0, bad = 0;
    bool started = false;
    while (pos < n) {
        int64_t e = pos;
        while (e < n && buf[e] != '\n') e++;
        int64_t s = pos, se = e;
        strip_span(buf, s, se);
        pos = e + 1;
        if (s == se) continue;
        if (buf[s] == '>') {
            if (started) rec_off[recs++] = o;
            started = true;
            continue;
        }
        if (!started) return -1;
        for (int64_t i = s; i < se; i++) {
            if (valid_tab[buf[i]]) {
                seq[o++] = buf[i];
            } else {
                seq[o++] = sep;
                bad++;
            }
        }
    }
    if (started) rec_off[recs++] = o;
    *n_seq = o;
    *n_rec = recs;
    *invalid = bad;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// .ski index-body serialization: the per-bin {u16 sign -> roaring bitmap}
// msgpack maps, the same bytes as formats/msgpack.py and formats/roaring.py
// in one pass (the Python codec costs ~20us per entry, and an index of
// 100k+ samples has millions of entries).
// Formats: MessagePack (uint keys minimal-width, bin8/16/32 values) and the
// RoaringFormatSpec no-run-container layout (cookie 12346), matching
// formats/msgpack.py and formats/roaring.py byte-for-byte.
// ---------------------------------------------------------------------------

namespace {

inline void put_u16le(uint8_t* p, uint16_t v) { p[0] = v & 0xFF; p[1] = v >> 8; }
inline void put_u32le(uint8_t* p, uint32_t v) {
    p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF; p[2] = (v >> 16) & 0xFF; p[3] = v >> 24;
}

// roaring blob for sorted u32 members; returns bytes written or -1 on cap
int64_t roaring_emit(const uint32_t* vals, int64_t n, uint8_t* out, int64_t cap) {
    // count containers (distinct high-16 keys) and the exact data size
    int64_t nc = 0, data_size = 0;
    for (int64_t i = 0; i < n;) {
        uint16_t key = vals[i] >> 16;
        int64_t j = i;
        while (j < n && (vals[j] >> 16) == key) j++;
        data_size += (j - i) <= 4096 ? (j - i) * 2 : 8192;
        i = j;
        nc++;
    }
    int64_t header = 8 + 4 * nc;
    int64_t pos = header + 4 * nc;  // offsets section then container data
    if (pos + data_size > cap) return -1;
    put_u32le(out, 12346u);
    put_u32le(out + 4, (uint32_t)nc);
    uint8_t* desc = out + 8;
    uint8_t* offs = out + header;
    int64_t i = 0;
    for (int64_t c = 0; c < nc; c++) {
        uint16_t key = vals[i] >> 16;
        int64_t j = i;
        while (j < n && (vals[j] >> 16) == key) j++;
        int64_t card = j - i;
        put_u16le(desc, key); desc += 2;
        put_u16le(desc, (uint16_t)(card - 1)); desc += 2;
        put_u32le(offs, (uint32_t)pos); offs += 4;
        if (card <= 4096) {
            for (int64_t t = i; t < j; t++) {
                put_u16le(out + pos, (uint16_t)(vals[t] & 0xFFFF));
                pos += 2;
            }
        } else {
            uint8_t* bits = out + pos;
            std::memset(bits, 0, 8192);
            for (int64_t t = i; t < j; t++) {
                uint16_t lo = vals[t] & 0xFFFF;
                bits[lo >> 3] |= (uint8_t)(1u << (lo & 7));
            }
            pos += 8192;
        }
        i = j;
    }
    return pos;
}

}  // namespace

extern "C" {

// One bin's msgpack map {sign: roaring bin}: signs ascending (n_entries
// distinct u16), members flat sorted-ascending u32 with entry offsets.
// Returns bytes written, or -1 if cap insufficient.
int64_t stpu_ski_bin_msgpack(const uint16_t* signs, const int64_t* ent_off,
                             const uint32_t* members, int64_t n_entries,
                             uint8_t* out, int64_t cap) {
    int64_t o = 0;
    if (n_entries < 16) {
        if (o + 1 > cap) return -1;
        out[o++] = 0x80 | (uint8_t)n_entries;
    } else if (n_entries < (1 << 16)) {
        if (o + 3 > cap) return -1;
        out[o++] = 0xDE;
        out[o++] = (n_entries >> 8) & 0xFF;
        out[o++] = n_entries & 0xFF;
    } else {
        if (o + 5 > cap) return -1;
        out[o++] = 0xDF;
        out[o++] = (n_entries >> 24) & 0xFF;
        out[o++] = (n_entries >> 16) & 0xFF;
        out[o++] = (n_entries >> 8) & 0xFF;
        out[o++] = n_entries & 0xFF;
    }
    for (int64_t e = 0; e < n_entries; e++) {
        uint16_t sign = signs[e];
        if (o + 3 > cap) return -1;
        if (sign < 0x80) {
            out[o++] = (uint8_t)sign;
        } else if (sign < 0x100) {
            out[o++] = 0xCC;
            out[o++] = (uint8_t)sign;
        } else {
            out[o++] = 0xCD;
            out[o++] = sign >> 8;
            out[o++] = sign & 0xFF;
        }
        // roaring blob into scratch position after a reserved bin header;
        // bin header size depends on blob length, so emit blob at o+5 max
        // then move if needed
        uint8_t tmp_hdr[5];
        int64_t blob_at = o + 5;
        int64_t blen = roaring_emit(members + ent_off[e], ent_off[e + 1] - ent_off[e],
                                    out + blob_at, cap - blob_at);
        if (blen < 0) return -1;
        int hdr;
        if (blen < (1 << 8)) {
            tmp_hdr[0] = 0xC4; tmp_hdr[1] = (uint8_t)blen; hdr = 2;
        } else if (blen < (1 << 16)) {
            tmp_hdr[0] = 0xC5; tmp_hdr[1] = blen >> 8; tmp_hdr[2] = blen & 0xFF; hdr = 3;
        } else {
            tmp_hdr[0] = 0xC6;
            tmp_hdr[1] = (blen >> 24) & 0xFF; tmp_hdr[2] = (blen >> 16) & 0xFF;
            tmp_hdr[3] = (blen >> 8) & 0xFF; tmp_hdr[4] = blen & 0xFF; hdr = 5;
        }
        std::memcpy(out + o, tmp_hdr, hdr);
        if (hdr != 5) std::memmove(out + o + hdr, out + blob_at, blen);
        o += hdr + blen;
    }
    return o;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// .ski index reading: the decompressed payload's per-bin maps straight into
// the (n_samples, S) u16 sign matrix. stpu_ski_bins_scan finds where each
// bin's map starts; stpu_ski_bins_fill writes bins [lo, hi) as rows of a
// bin-major (S, n) matrix (ranges on threads of their own); and
// stpu_transpose_u16 gives rows [lo, hi) of the row-major one. The
// subset: a top-level array of 9, an array of bin maps, uint keys up to
// 0xFFFF, bin8/16/32 values holding no-run roaring bitmaps (cookie 12346)
// of members below n. Anything else (a run container, a larger key, a
// member past n, a truncated payload) returns -1, and the caller decodes
// the whole payload in Python.
// ---------------------------------------------------------------------------

namespace {

inline int64_t be_uint(const uint8_t* p, int w) {
    int64_t v = 0;
    for (int i = 0; i < w; i++) v = (v << 8) | p[i];
    return v;
}

// a msgpack array or map header at buf[pos] (map: 0x80), its length into
// *n; false for another type or past len
bool mp_header(const uint8_t* buf, int64_t len, int64_t& pos, uint8_t fix,
               int64_t* n) {
    if (pos >= len) return false;
    uint8_t b = buf[pos++];
    int w;
    if ((b & 0xF0) == fix) { *n = b & 0x0F; return true; }
    if (b == (fix == 0x90 ? 0xDC : 0xDE)) w = 2;
    else if (b == (fix == 0x90 ? 0xDD : 0xDF)) w = 4;
    else return false;
    if (len - pos < w) return false;
    *n = be_uint(buf + pos, w);
    pos += w;
    return true;
}

// one bin map entry at buf[pos]: its u16 sign and its bin's span
bool ski_entry(const uint8_t* buf, int64_t end, int64_t& pos, uint16_t* sign,
               int64_t* blob, int64_t* blen) {
    if (pos >= end) return false;
    uint8_t kb = buf[pos++];
    int64_t key;
    if (kb < 0x80) key = kb;
    else if (kb >= 0xCC && kb <= 0xCE) {
        int w = 1 << (kb - 0xCC);
        if (end - pos < w) return false;
        key = be_uint(buf + pos, w);
        pos += w;
    } else return false;
    if (key > 0xFFFF || pos >= end) return false;
    uint8_t vb = buf[pos++];
    if (vb < 0xC4 || vb > 0xC6) return false;
    int w = 1 << (vb - 0xC4);
    if (end - pos < w) return false;
    int64_t n = be_uint(buf + pos, w);
    pos += w;
    if (n > end - pos) return false;
    *sign = (uint16_t)key;
    *blob = pos;
    *blen = n;
    pos += n;
    return true;
}

inline uint32_t le_u32(const uint8_t* p) {
    return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

// a roaring bitmap's members (below n) set to sign in row
bool roaring_fill(const uint8_t* blob, int64_t blen, uint16_t sign, int64_t n,
                  uint16_t* row) {
    if (blen < 8 || le_u32(blob) != 12346u) return false;
    int64_t nc = le_u32(blob + 4);
    if (nc > (blen - 8) / 8) return false;
    const uint8_t* desc = blob + 8;
    int64_t dpos = 8 + 8 * nc;  // past descriptors and offsets
    for (int64_t c = 0; c < nc; c++, desc += 4) {
        int64_t base = (int64_t)(desc[0] | (desc[1] << 8)) << 16;
        int64_t card = (int64_t)(desc[2] | (desc[3] << 8)) + 1;
        if (card <= 4096) {
            if (card * 2 > blen - dpos) return false;
            const uint8_t* a = blob + dpos;
            if (base + 0xFFFF < n) {  // every low half is in range
                for (int64_t t = 0; t < card; t++)
                    row[base + (a[2 * t] | (a[2 * t + 1] << 8))] = sign;
            } else {
                for (int64_t t = 0; t < card; t++) {
                    int64_t m = base + (a[2 * t] | (a[2 * t + 1] << 8));
                    if (m >= n) return false;
                    row[m] = sign;
                }
            }
            dpos += card * 2;
        } else {
            if (8192 > blen - dpos) return false;
            for (int64_t w = 0; w < 1024; w++) {
                uint64_t word;
                memcpy(&word, blob + dpos + 8 * w, 8);
                while (word) {
                    int64_t m = base + w * 64 + __builtin_ctzll(word);
                    word &= word - 1;
                    if (m >= n) return false;
                    row[m] = sign;
                }
            }
            dpos += 8192;
        }
    }
    return true;
}

}  // namespace

extern "C" {

// The payload's bin count. starts (cap entries): with cap > bins, each
// bin map's offset and, last, the offset past the index list, where the
// sample count begins. Returns -1 outside the subset.
int64_t stpu_ski_bins_scan(const uint8_t* buf, int64_t len, int64_t* starts,
                           int64_t cap) {
    int64_t pos = 0, top, s;
    if (!mp_header(buf, len, pos, 0x90, &top) || top != 9 ||
        !mp_header(buf, len, pos, 0x90, &s) || s > len - pos)
        return -1;
    if (cap <= s) return s;
    for (int64_t b = 0; b < s; b++) {
        starts[b] = pos;
        int64_t entries;
        if (!mp_header(buf, len, pos, 0x80, &entries)) return -1;
        for (int64_t e = 0; e < entries; e++) {
            uint16_t sign;
            int64_t blob, blen;
            if (!ski_entry(buf, len, pos, &sign, &blob, &blen)) return -1;
        }
    }
    starts[s] = pos;
    return s;
}

// Bins [lo, hi) of the scanned payload as rows of the (S, n) bin-major
// matrix out: 0xFFFF, then each entry's sign at its members, in the
// map's order. Returns 0, or -1 outside the subset.
int64_t stpu_ski_bins_fill(const uint8_t* buf, const int64_t* starts,
                           int64_t lo, int64_t hi, int64_t n, uint16_t* out) {
    for (int64_t b = lo; b < hi; b++) {
        uint16_t* row = out + b * n;
        std::fill(row, row + n, (uint16_t)0xFFFF);
        int64_t pos = starts[b], end = starts[b + 1], entries;
        if (!mp_header(buf, end, pos, 0x80, &entries)) return -1;
        for (int64_t e = 0; e < entries; e++) {
            uint16_t sign;
            int64_t blob, blen;
            if (!ski_entry(buf, end, pos, &sign, &blob, &blen) ||
                !roaring_fill(buf + blob, blen, sign, n, row))
                return -1;
        }
    }
    return 0;
}

// Rows [lo, hi) of dst (n, s) = src (s, n) transposed, in 64 x 64 tiles.
void stpu_transpose_u16(const uint16_t* src, int64_t s, int64_t n,
                        uint16_t* dst, int64_t lo, int64_t hi) {
    const int64_t T = 64;
    for (int64_t i0 = lo; i0 < hi; i0 += T) {
        int64_t i1 = std::min(i0 + T, hi);
        for (int64_t b0 = 0; b0 < s; b0 += T) {
            int64_t b1 = std::min(b0 + T, s);
            for (int64_t i = i0; i < i1; i++)
                for (int64_t b = b0; b < b1; b++)
                    dst[i * s + b] = src[b * n + i];
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// .skm metadata: the decompressed payload, CBOR (RFC 8949) of a serde
// struct map (sketchlib.rust src/sketch/multisketch.rs), with its two
// per-sample values decoded straight into columns: sketch_metadata (one
// map a sample, src/sketch/mod.rs's Sketch fields) and name_map. Every
// other top-level value is left as a byte span for formats/cbor.py.
// Only the subset ciborium writes for this schema is decoded here: an
// indefinite length, a tag, another type in a field, an unknown record
// key, a missing name, invalid UTF-8 or a truncated payload makes
// stpu_skm_decode return NULL, and the caller decodes the whole payload in
// Python (which then raises whatever error it raises).
// ---------------------------------------------------------------------------

namespace {

// a record's fields in serde order; bit i of its mask: field i present
// (index: present and not null, as from_serde's .get("index") reads it)
enum SkmField {
    F_NAME, F_INDEX, F_RC, F_READS, F_SEQ_LENGTH, F_DENSIFIED, F_ACGT,
    F_NON_ACGT, F_COUNT
};
const std::string_view kSkmFields[F_COUNT] = {
    "name", "index", "rc", "reads", "seq_length", "densified", "acgt",
    "non_acgt"};

struct CborIn {
    const uint8_t* p;
    int64_t len;
    int64_t pos;

    // the head of the next item; false past the end, for an indefinite
    // length or for reserved additional information
    bool head(int& major, int& info, uint64_t& arg) {
        if (pos >= len) return false;
        uint8_t b = p[pos++];
        major = b >> 5;
        info = b & 31;
        if (info < 24) { arg = info; return true; }
        if (info > 27) return false;
        int64_t w = int64_t(1) << (info - 24);
        if (w > len - pos) return false;
        arg = 0;
        for (int64_t i = 0; i < w; i++) arg = (arg << 8) | p[pos++];
        return true;
    }

    bool text(std::string_view& s) {
        int major, info;
        uint64_t n;
        if (!head(major, info, n) || major != 3 || n > uint64_t(len - pos))
            return false;
        s = std::string_view(reinterpret_cast<const char*>(p + pos), n);
        pos += int64_t(n);
        return true;
    }

    bool uint(uint64_t& v) {
        int major, info;
        return head(major, info, v) && major == 0;
    }

    bool boolean(uint8_t& v) {
        int major, info;
        uint64_t arg;
        if (!head(major, info, arg) || major != 7 || (info != 20 && info != 21))
            return false;
        v = info == 21;
        return true;
    }

    // one whole item, of the items formats/cbor.py decodes without tags
    // or indefinite lengths
    bool skip() {
        uint64_t todo = 1;
        while (todo) {
            todo--;
            int major, info;
            uint64_t arg;
            if (!head(major, info, arg)) return false;
            switch (major) {
            case 0: case 1: break;
            case 2: case 3:
                if (arg > uint64_t(len - pos)) return false;
                pos += int64_t(arg);
                break;
            case 4: case 5:
                // each item takes a byte at least
                if (arg > uint64_t(len - pos)) return false;
                todo += major == 4 ? arg : 2 * arg;
                break;
            case 7:
                if (info == 24) return false;  // cbor.py rejects it
                break;
            default: return false;  // a tag
            }
        }
        return true;
    }
};

// strict UTF-8, as Python's bytes.decode("utf-8") takes it
bool utf8_valid(std::string_view s) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(s.data());
    size_t n = s.size(), i = 0;
    while (i < n) {
        uint8_t c = p[i];
        if (c < 0x80) { i++; continue; }
        size_t k;
        uint8_t lo = 0x80, hi = 0xBF;
        if (c >= 0xC2 && c <= 0xDF) k = 1;
        else if (c == 0xE0) { k = 2; lo = 0xA0; }
        else if (c >= 0xE1 && c <= 0xEF) { k = 2; if (c == 0xED) hi = 0x9F; }
        else if (c == 0xF0) { k = 3; lo = 0x90; }
        else if (c >= 0xF1 && c <= 0xF3) k = 3;
        else if (c == 0xF4) { k = 3; hi = 0x8F; }
        else return false;
        if (k > n - i - 1 || p[i + 1] < lo || p[i + 1] > hi) return false;
        for (size_t j = 2; j <= k; j++)
            if ((p[i + j] & 0xC0) != 0x80) return false;
        i += k + 1;
    }
    return true;
}

struct SkmColumns {
    std::vector<std::string_view> names, keys;  // into the payload
    std::vector<uint64_t> nums;  // a record: index, seq_length, non_acgt, acgt[4]
    std::vector<uint8_t> flags;  // a record: rc, reads, densified, mask
    std::vector<uint64_t> values;  // name_map's, in its order
    std::vector<int64_t> other;  // an entry: key offset, key length, value offset
};

bool skm_records(CborIn& in, SkmColumns& c) {
    int major, info;
    uint64_t n;
    if (!in.head(major, info, n) || major != 4 || n > uint64_t(in.len - in.pos))
        return false;
    c.names.reserve(n);
    c.nums.reserve(7 * n);
    c.flags.reserve(4 * n);
    for (uint64_t r = 0; r < n; r++) {
        uint64_t nf;
        if (!in.head(major, info, nf) || major != 5) return false;
        std::string_view name;
        uint64_t num[7] = {0, 0, 0, 0, 0, 0, 0};
        uint8_t fl[4] = {0, 0, 0, 0};
        for (uint64_t f = 0; f < nf; f++) {
            std::string_view key;
            if (!in.text(key)) return false;
            int field = 0;
            while (field < F_COUNT && kSkmFields[field] != key) field++;
            bool ok = true, present = true;
            uint64_t arg;
            switch (field) {
            case F_NAME: ok = in.text(name) && utf8_valid(name); break;
            case F_INDEX:
                ok = in.head(major, info, arg);
                if (ok && major == 7 && (info == 22 || info == 23))
                    present = false;  // null or undefined: None
                else if (ok && major == 0) num[0] = arg;
                else ok = false;
                break;
            case F_RC: ok = in.boolean(fl[0]); break;
            case F_READS: ok = in.boolean(fl[1]); break;
            case F_DENSIFIED: ok = in.boolean(fl[2]); break;
            case F_SEQ_LENGTH: ok = in.uint(num[1]); break;
            case F_NON_ACGT: ok = in.uint(num[2]); break;
            case F_ACGT:
                ok = in.head(major, info, arg) && major == 4 && arg == 4;
                for (int b = 0; ok && b < 4; b++) ok = in.uint(num[3 + b]);
                break;
            default: ok = false;  // a key from_serde does not read
            }
            if (!ok) return false;
            if (present) fl[3] |= uint8_t(1u << field);
            else fl[3] &= uint8_t(~(1u << field));
        }
        if (!(fl[3] & (1u << F_NAME))) return false;
        c.names.push_back(name);
        c.nums.insert(c.nums.end(), num, num + 7);
        c.flags.insert(c.flags.end(), fl, fl + 4);
    }
    return true;
}

bool skm_name_map(CborIn& in, SkmColumns& c) {
    int major, info;
    uint64_t n;
    if (!in.head(major, info, n) || major != 5 || n > uint64_t(in.len - in.pos))
        return false;
    c.keys.reserve(n);
    c.values.reserve(n);
    for (uint64_t e = 0; e < n; e++) {
        std::string_view key;
        uint64_t v;
        if (!in.text(key) || !utf8_valid(key) || !in.uint(v)) return false;
        c.keys.push_back(key);
        c.values.push_back(v);
    }
    return true;
}

// the strings, each followed by a 0 byte, and their offsets (n + 1);
// whether none holds a 0 byte itself
bool pack_strings(const std::vector<std::string_view>& s, uint8_t* blob,
                  int64_t* off) {
    bool plain = true;
    int64_t o = 0;
    for (size_t i = 0; i < s.size(); i++) {
        off[i] = o;
        std::memcpy(blob + o, s[i].data(), s[i].size());
        plain = plain && std::memchr(s[i].data(), 0, s[i].size()) == nullptr;
        o += int64_t(s[i].size());
        blob[o++] = 0;
    }
    off[s.size()] = o;
    return plain;
}

// set(keys) == set(names): every key is a name, and every distinct name
// is a key (an open-addressing table of the names, FNV-1a)
bool same_set(const std::vector<std::string_view>& names,
              const std::vector<std::string_view>& keys) {
    size_t cap = 16;
    while (cap < 2 * names.size()) cap *= 2;
    std::vector<int64_t> slot(cap, -1);  // a name's index
    std::vector<uint8_t> seen(cap, 0);   // 1 a name, 2 a name that is a key
    auto find = [&](std::string_view s) {
        uint64_t h = 14695981039346656037ull;
        for (unsigned char ch : s) h = (h ^ ch) * 1099511628211ull;
        size_t i = h & (cap - 1);
        while (slot[i] >= 0 && names[slot[i]] != s) i = (i + 1) & (cap - 1);
        return i;
    };
    size_t distinct = 0, matched = 0;
    for (size_t j = 0; j < names.size(); j++) {
        size_t i = find(names[j]);
        if (slot[i] < 0) { slot[i] = int64_t(j); seen[i] = 1; distinct++; }
    }
    for (auto k : keys) {
        size_t i = find(k);
        if (slot[i] < 0) return false;
        if (seen[i] == 1) { seen[i] = 2; matched++; }
    }
    return matched == distinct;
}

int64_t packed_size(const std::vector<std::string_view>& s) {
    int64_t n = 0;
    for (auto v : s) n += int64_t(v.size()) + 1;
    return n;
}

}  // namespace

extern "C" {

// Decode a .skm payload (its top-level map) into columns. Returns a
// handle for stpu_skm_columns and stpu_skm_free, or NULL when the payload
// is not of the subset above. sizes (5): records, their names' packed
// bytes, name_map entries, its keys' packed bytes, other top-level entries.
void* stpu_skm_decode(const uint8_t* buf, int64_t len, int64_t* sizes) {
    auto c = std::make_unique<SkmColumns>();
    CborIn in{buf, len, 0};
    int major, info;
    uint64_t n;
    if (!in.head(major, info, n) || major != 5 || n > uint64_t(len)) return nullptr;
    bool meta = false, map = false;
    for (uint64_t e = 0; e < n; e++) {
        std::string_view key;
        if (!in.text(key)) return nullptr;
        if (key == "sketch_metadata") {
            if (meta || !skm_records(in, *c)) return nullptr;
            meta = true;
        } else if (key == "name_map") {
            if (map || !skm_name_map(in, *c)) return nullptr;
            map = true;
        } else {
            int64_t at = in.pos;
            if (!in.skip()) return nullptr;
            c->other.insert(c->other.end(),
                            {int64_t(reinterpret_cast<const uint8_t*>(key.data()) - buf),
                             int64_t(key.size()), at});
        }
    }
    if (!meta || !map) return nullptr;
    sizes[0] = int64_t(c->names.size());
    sizes[1] = packed_size(c->names);
    sizes[2] = int64_t(c->keys.size());
    sizes[3] = packed_size(c->keys);
    sizes[4] = int64_t(c->other.size() / 3);
    return c.release();
}

// Copy a decoded payload's columns out (the sizes stpu_skm_decode gave):
// names packed with offsets; nums (n, 7) index, seq_length, non_acgt,
// acgt; flags (n, 4) rc, reads, densified, the field mask; name_map's keys
// packed with offsets and its values; other (m, 3) key offset, key
// length, value offset in the payload. bits: 1 no name, 2 no key holds a
// 0 byte; 4 the set of keys equals the set of names. The handle reads the
// payload it decoded, which must outlive it.
void stpu_skm_columns(void* handle, uint8_t* names, int64_t* name_off,
                      uint64_t* nums, uint8_t* flags, uint8_t* keys,
                      int64_t* key_off, uint64_t* values, int64_t* other,
                      int64_t* bits) {
    const SkmColumns& c = *static_cast<const SkmColumns*>(handle);
    int64_t b = pack_strings(c.names, names, name_off) ? 1 : 0;
    b |= pack_strings(c.keys, keys, key_off) ? 2 : 0;
    std::memcpy(nums, c.nums.data(), c.nums.size() * sizeof(uint64_t));
    std::memcpy(flags, c.flags.data(), c.flags.size());
    std::memcpy(values, c.values.data(), c.values.size() * sizeof(uint64_t));
    std::memcpy(other, c.other.data(), c.other.size() * sizeof(int64_t));
    if (same_set(c.names, c.keys)) b |= 4;
    *bits = b;
}

void stpu_skm_free(void* handle) { delete static_cast<SkmColumns*>(handle); }

// A msgpack array of str at buf[pos] (a .ski's sample names, metadata or
// labels): with blob NULL, info = (count, packed bytes, offset past the
// array); with blob, the strings packed as pack_strings packs them into
// blob and off (count + 1). Returns 1 if no string holds a 0 byte, else
// 0; -1 for another type, invalid UTF-8 or a truncated payload.
int64_t stpu_msgpack_strs(const uint8_t* buf, int64_t len, int64_t pos,
                          uint8_t* blob, int64_t* off, int64_t* info) {
    int64_t n;
    if (!mp_header(buf, len, pos, 0x90, &n) || n > len - pos) return -1;
    std::vector<std::string_view> strs;
    strs.reserve(n);
    for (int64_t i = 0; i < n; i++) {
        if (pos >= len) return -1;
        uint8_t b = buf[pos++];
        int64_t sn;
        if ((b & 0xE0) == 0xA0) sn = b & 0x1F;
        else if (b >= 0xD9 && b <= 0xDB) {
            int w = 1 << (b - 0xD9);
            if (len - pos < w) return -1;
            sn = be_uint(buf + pos, w);
            pos += w;
        } else return -1;
        if (sn > len - pos) return -1;
        std::string_view str(reinterpret_cast<const char*>(buf + pos), sn);
        if (!utf8_valid(str)) return -1;
        strs.push_back(str);
        pos += sn;
    }
    if (blob) return pack_strings(strs, blob, off) ? 1 : 0;
    info[0] = n;
    info[1] = packed_size(strs);
    info[2] = pos;
    for (auto v : strs)
        if (std::memchr(v.data(), 0, v.size())) return 0;
    return 1;
}

}  // extern "C"
