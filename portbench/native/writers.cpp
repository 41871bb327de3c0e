// Writers of the benchmark's frozen input files: CRC-32C, the Snappy raw
// block compressor and its framing (.skm and .ski are snappy-framed), and
// one bin of the .ski index body (a MessagePack map of u16 signs to
// roaring bitmaps of sample ids).
//
// A frozen copy of the port's host helper (sketchtpu_torch/csrc/host/
// native.cpp), so that the benchmark's inputs stay the same bytes whatever
// a later change does to the port's writers. Formats follow their public
// specifications (google/snappy format_description.txt and
// framing_format.txt, RoaringFormatSpec, MessagePack).
//
// portbench/databases/native.py builds it with
//   g++ -O3 -std=c++17 -shared -fPIC -o <lib>.so writers.cpp

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), slice-by-8 software implementation.
// ---------------------------------------------------------------------------

static uint32_t crc32c_table[8][256];
static bool crc32c_init_done = false;

static void crc32c_init() {
    if (crc32c_init_done) return;
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
    crc32c_init_done = true;
}

uint32_t pb_crc32c(const uint8_t* data, size_t len, uint32_t seed) {
    crc32c_init();
    uint32_t crc = ~seed;
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
    return ~crc;
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
size_t pb_snappy_max_compressed(size_t n) { return 32 + n + n / 6; }

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

size_t pb_snappy_compress(const uint8_t* in, size_t n, uint8_t* out,
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

// A snappy framed stream of in[0, n): the stream identifier, then one chunk
// of each 64 KiB, compressed where that is shorter (as snap::FrameEncoder
// writes), each with the masked CRC-32C of its uncompressed bytes. Returns
// the bytes written, or 0 if cap is too small.
size_t pb_snappy_frame(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
    static const uint8_t ident[10] = {0xff, 0x06, 0x00, 0x00, 's', 'N',
                                      'a', 'P', 'p', 'Y'};
    if (cap < 10) return 0;
    std::memcpy(out, ident, 10);
    size_t op = 10;
    const size_t kChunk = 1u << 16;
    std::vector<uint8_t> tmp(pb_snappy_max_compressed(kChunk));
    size_t pos = 0;
    do {
        size_t len = n - pos < kChunk ? n - pos : kChunk;
        uint32_t crc = pb_crc32c(in + pos, len, 0);
        uint32_t masked = ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
        size_t clen = pb_snappy_compress(in + pos, len, tmp.data(), tmp.size());
        bool comp = clen != 0 && clen < len;
        const uint8_t* src = comp ? tmp.data() : in + pos;
        size_t blen = comp ? clen : len;
        if (op + 8 + blen > cap) return 0;
        out[op] = comp ? 0x00 : 0x01;
        uint32_t body = (uint32_t)(blen + 4);
        out[op + 1] = body & 0xFF;
        out[op + 2] = (body >> 8) & 0xFF;
        out[op + 3] = (body >> 16) & 0xFF;
        std::memcpy(out + op + 4, &masked, 4);  // little-endian hosts
        std::memcpy(out + op + 8, src, blen);
        op += 8 + blen;
        pos += len;
    } while (pos < n);
    return op;
}
}  // extern "C"

// ---------------------------------------------------------------------------
// .ski index-body serialization: the per-bin {u16 sign -> roaring bitmap}
// msgpack maps, the same bytes as the port's codec
// in one pass (the Python codec costs ~20us per entry, and an index of
// 100k+ samples has millions of entries).
// Formats: MessagePack (uint keys minimal-width, bin8/16/32 values) and the
// RoaringFormatSpec no-run-container layout (cookie 12346), matching
// the port's writer byte for byte.
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
int64_t pb_ski_bin_msgpack(const uint16_t* signs, const int64_t* ent_off,
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
