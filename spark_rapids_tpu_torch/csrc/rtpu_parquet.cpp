// Native Parquet column-chunk decoder of spark_rapids_tpu_torch.
//
// A copy of the JAX package's native/src/rtpu_parquet.cpp, so both packages
// decode a file alike. The reference decodes Parquet through native code:
// footer parse and row-group filter in JNI (GpuParquetScan.scala:539-597,
// ParquetFooter.readAndFilter) and page decode in libcudf
// (Table.readParquet). This is the host half of that: a thrift-compact
// footer/stats parser and a PLAIN/RLE_DICTIONARY page decoder producing
// flat column buffers, exposed as a plain C interface loaded through ctypes
// by io/parquet_native.py and built with the host compiler by
// kernels/build.py. Anything outside the supported subset (nested schemas,
// INT96, FLBA, other codecs and encodings) returns an error code, and the
// caller reads that row group with pyarrow.
//
// Supported subset (covers pyarrow/Spark defaults for flat tables):
//   physical types  BOOLEAN, INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY
//   codecs          UNCOMPRESSED, SNAPPY (own decoder), ZSTD (libzstd,
//                   where the build defines RTPU_WITH_ZSTD; without it a
//                   ZSTD chunk is outside the subset)
//   encodings       PLAIN, PLAIN_DICTIONARY / RLE_DICTIONARY,
//                   RLE (def levels + booleans)
//   pages           DATA_PAGE (v1), DATA_PAGE_V2, DICTIONARY_PAGE
//
// All parsing is bounds-checked; malformed input returns an error instead
// of reading out of bounds.

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>
#ifdef RTPU_WITH_ZSTD
#include <zstd.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// error codes (negative returns through the C ABI)
// ---------------------------------------------------------------------------
enum {
    ERR_MALFORMED = -1,       // thrift/page structure out of bounds
    ERR_UNSUPPORTED = -2,     // valid parquet outside the native subset
    ERR_HANDLE = -3,          // bad footer handle
    ERR_SPACE = -4,           // output buffer too small (binary decode)
};

// ---------------------------------------------------------------------------
// thrift compact protocol reader
// ---------------------------------------------------------------------------

struct TReader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    TReader(const uint8_t* buf, int64_t len) : p(buf), end(buf + len) {}

    uint8_t byte() {
        if (p >= end) { ok = false; return 0; }
        return *p++;
    }

    uint64_t uvarint() {
        uint64_t v = 0;
        int shift = 0;
        while (ok) {
            uint8_t b = byte();
            v |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
            if (shift > 63) { ok = false; break; }
        }
        return v;
    }

    int64_t zigzag() {
        uint64_t u = uvarint();
        return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
    }

    void skip_bytes(int64_t n) {
        if (n < 0 || end - p < n) { ok = false; return; }
        p += n;
    }

    // returns (field_id, type); type 0 == STOP
    std::pair<int16_t, uint8_t> field_header(int16_t last_id) {
        uint8_t b = byte();
        if (!ok || b == 0) return {0, 0};
        uint8_t type = b & 0x0F;
        int16_t delta = (b >> 4) & 0x0F;
        int16_t id = delta ? (int16_t)(last_id + delta)
                           : (int16_t)zigzag();
        return {id, type};
    }

    std::pair<uint64_t, uint8_t> list_header() {
        uint8_t b = byte();
        uint8_t et = b & 0x0F;
        uint64_t n = (b >> 4) & 0x0F;
        if (n == 15) n = uvarint();
        return {n, et};
    }

    std::string binary() {
        uint64_t n = uvarint();
        if (!ok || (uint64_t)(end - p) < n) { ok = false; return {}; }
        std::string s((const char*)p, n);
        p += n;
        return s;
    }

    // skip a value of the given compact type (recursive for containers)
    void skip_value(uint8_t type) {
        switch (type) {
            case 1: case 2: return;                 // bool true/false
            case 3: byte(); return;                 // i8
            case 4: case 5: case 6: zigzag(); return;
            case 7: skip_bytes(8); return;          // double
            case 8: { uint64_t n = uvarint(); skip_bytes((int64_t)n); return; }
            case 9: case 10: {                      // list / set
                auto [n, et] = list_header();
                for (uint64_t i = 0; i < n && ok; i++) skip_value(et);
                return;
            }
            case 11: {                              // map
                uint64_t n = uvarint();
                if (n == 0) return;
                uint8_t kv = byte();
                uint8_t kt = kv >> 4, vt = kv & 0x0F;
                for (uint64_t i = 0; i < n && ok; i++) {
                    skip_value(kt);
                    skip_value(vt);
                }
                return;
            }
            case 12: {                              // struct
                int16_t last = 0;
                while (ok) {
                    auto [id, t] = field_header(last);
                    if (t == 0) break;
                    last = id;
                    skip_value(t);
                }
                return;
            }
            default: ok = false;
        }
    }
};

// ---------------------------------------------------------------------------
// footer model
// ---------------------------------------------------------------------------

struct Stats {
    std::string min_value, max_value;   // raw plain-encoded bytes
    int64_t null_count = -1;
    bool has_min = false, has_max = false;
};

struct ChunkMeta {
    int32_t type = -1;
    int32_t codec = -1;
    int64_t num_values = 0;
    int64_t data_page_offset = -1;
    int64_t dict_page_offset = -1;
    int64_t total_compressed = 0;
    int64_t total_uncompressed = 0;
    Stats stats;
};

struct LeafCol {
    std::string name;        // dotted path
    int32_t type = -1;
    int32_t max_def = 0;     // 0 required, 1 optional (flat only)
    bool flat = true;
    bool is_decimal = false; // DECIMAL logical/converted type (stats are
                             // unscaled ints; callers must not compare
                             // them with logical Decimal literals)
};

struct Footer {
    int64_t num_rows = 0;
    std::vector<LeafCol> cols;
    std::vector<int64_t> rg_rows;
    std::vector<std::vector<ChunkMeta>> rgs;   // [rg][col]
    std::vector<std::pair<std::string, std::string>> kv;
};

static Stats parse_stats(TReader& r) {
    Stats s;
    std::string dep_min, dep_max;
    int16_t last = 0;
    while (r.ok) {
        auto [id, t] = r.field_header(last);
        if (t == 0) break;
        last = id;
        switch (id) {
            case 1: dep_max = r.binary(); break;
            case 2: dep_min = r.binary(); break;
            case 3: s.null_count = r.zigzag(); break;
            case 5: s.max_value = r.binary(); s.has_max = true; break;
            case 6: s.min_value = r.binary(); s.has_min = true; break;
            default: r.skip_value(t);
        }
    }
    // the deprecated min/max fields only carry signed-comparable types
    // correctly; use them when min_value/max_value are absent (old files)
    if (!s.has_min && !dep_min.empty()) { s.min_value = dep_min; s.has_min = true; }
    if (!s.has_max && !dep_max.empty()) { s.max_value = dep_max; s.has_max = true; }
    return s;
}

static ChunkMeta parse_column_meta(TReader& r) {
    ChunkMeta c;
    int16_t last = 0;
    while (r.ok) {
        auto [id, t] = r.field_header(last);
        if (t == 0) break;
        last = id;
        switch (id) {
            case 1: c.type = (int32_t)r.zigzag(); break;
            case 4: c.codec = (int32_t)r.zigzag(); break;
            case 5: c.num_values = r.zigzag(); break;
            case 6: c.total_uncompressed = r.zigzag(); break;
            case 7: c.total_compressed = r.zigzag(); break;
            case 9: c.data_page_offset = r.zigzag(); break;
            case 11: c.dict_page_offset = r.zigzag(); break;
            case 12: c.stats = parse_stats(r); break;
            default: r.skip_value(t);
        }
    }
    return c;
}

struct SchemaElem {
    int32_t type = -1;
    int32_t repetition = 0;
    int32_t num_children = 0;
    int32_t converted_type = -1;
    int32_t logical_kind = -1;     // LogicalType union field id (5=DECIMAL)
    std::string name;
};

static SchemaElem parse_schema_elem(TReader& r) {
    SchemaElem e;
    int16_t last = 0;
    while (r.ok) {
        auto [id, t] = r.field_header(last);
        if (t == 0) break;
        last = id;
        switch (id) {
            case 1: e.type = (int32_t)r.zigzag(); break;
            case 3: e.repetition = (int32_t)r.zigzag(); break;
            case 4: e.name = r.binary(); break;
            case 5: e.num_children = (int32_t)r.zigzag(); break;
            case 6: e.converted_type = (int32_t)r.zigzag(); break;
            case 10: {     // LogicalType union: record which member is set
                int16_t l2 = 0;
                while (r.ok) {
                    auto [i2, t2] = r.field_header(l2);
                    if (t2 == 0) break;
                    l2 = i2;
                    e.logical_kind = i2;
                    r.skip_value(t2);
                }
                break;
            }
            default: r.skip_value(t);
        }
    }
    return e;
}

static Footer* parse_footer(const uint8_t* buf, int64_t len) {
    TReader r(buf, len);
    auto f = new Footer();
    std::vector<SchemaElem> schema;
    int16_t last = 0;
    while (r.ok) {
        auto [id, t] = r.field_header(last);
        if (t == 0) break;
        last = id;
        if (id == 2 && t == 9) {             // schema
            auto [n, et] = r.list_header();
            for (uint64_t i = 0; i < n && r.ok; i++)
                schema.push_back(parse_schema_elem(r));
            (void)et;
        } else if (id == 3) {
            f->num_rows = r.zigzag();
        } else if (id == 5 && t == 9) {      // key_value_metadata
            auto [n, et] = r.list_header();
            (void)et;
            for (uint64_t i = 0; i < n && r.ok; i++) {
                std::string k, v;
                int16_t l2 = 0;
                while (r.ok) {
                    auto [i2, t2] = r.field_header(l2);
                    if (t2 == 0) break;
                    l2 = i2;
                    if (i2 == 1) k = r.binary();
                    else if (i2 == 2) v = r.binary();
                    else r.skip_value(t2);
                }
                f->kv.emplace_back(std::move(k), std::move(v));
            }
        } else if (id == 4 && t == 9) {      // row groups
            auto [nrg, et] = r.list_header();
            (void)et;
            for (uint64_t g = 0; g < nrg && r.ok; g++) {
                std::vector<ChunkMeta> cols;
                int64_t rows = 0;
                int16_t last2 = 0;
                while (r.ok) {
                    auto [id2, t2] = r.field_header(last2);
                    if (t2 == 0) break;
                    last2 = id2;
                    if (id2 == 1 && t2 == 9) {         // columns
                        auto [nc, et2] = r.list_header();
                        (void)et2;
                        for (uint64_t c = 0; c < nc && r.ok; c++) {
                            ChunkMeta cm;
                            int16_t last3 = 0;
                            while (r.ok) {            // ColumnChunk struct
                                auto [id3, t3] = r.field_header(last3);
                                if (t3 == 0) break;
                                last3 = id3;
                                if (id3 == 3 && t3 == 12)
                                    cm = parse_column_meta(r);
                                else
                                    r.skip_value(t3);
                            }
                            cols.push_back(cm);
                        }
                    } else if (id2 == 3) {
                        rows = r.zigzag();
                    } else {
                        r.skip_value(t2);
                    }
                }
                f->rg_rows.push_back(rows);
                f->rgs.push_back(std::move(cols));
            }
        } else {
            r.skip_value(t);
        }
    }
    if (!r.ok || schema.empty()) { delete f; return nullptr; }
    // walk the schema tree: leaves in depth-first order = column order.
    // ``flat`` leaves are depth-1 non-repeated children of the root.
    size_t idx = 1;     // schema[0] is the root
    struct Frame { int remaining; int depth; int def; bool nested; };
    std::vector<Frame> stack{{schema[0].num_children, 0, 0, false}};
    while (idx < schema.size() && !stack.empty()) {
        auto& e = schema[idx++];
        auto& top = stack.back();
        int def = top.def + (e.repetition != 0 ? 1 : 0);
        bool nested = top.nested || e.repetition == 2;
        if (e.num_children > 0) {
            stack.push_back({e.num_children, top.depth + 1, def, true});
        } else {
            LeafCol lc;
            lc.name = e.name;
            lc.type = e.type;
            lc.max_def = def;
            lc.is_decimal = e.converted_type == 5 || e.logical_kind == 5;
            lc.flat = !nested && top.depth == 0 && def <= 1;
            f->cols.push_back(lc);
        }
        while (!stack.empty() && --stack.back().remaining < 0) {
            // decremented past this level's children: pop. (The root frame
            // counts down as its direct children complete.)
            stack.pop_back();
        }
    }
    return f;
}

// ---------------------------------------------------------------------------
// snappy raw-format decompressor (self-contained; the image ships only the
// versioned runtime .so without headers)
// ---------------------------------------------------------------------------

static int64_t snappy_uncompress(const uint8_t* src, int64_t n,
                                 uint8_t* dst, int64_t dst_cap) {
    TReader r(src, n);
    uint64_t out_len = r.uvarint();
    if (!r.ok || (int64_t)out_len > dst_cap) return ERR_MALFORMED;
    int64_t op = 0;
    const uint8_t* p = r.p;
    const uint8_t* end = src + n;
    while (p < end && op < (int64_t)out_len) {
        uint8_t tag = *p++;
        uint32_t kind = tag & 3;
        if (kind == 0) {                       // literal
            int64_t len = (tag >> 2) + 1;
            if (len > 60) {
                int nb = (int)len - 60;
                if (end - p < nb) return ERR_MALFORMED;
                len = 0;
                for (int i = 0; i < nb; i++) len |= (int64_t)p[i] << (8 * i);
                len += 1;
                p += nb;
            }
            if (end - p < len || op + len > (int64_t)out_len)
                return ERR_MALFORMED;
            std::memcpy(dst + op, p, len);
            p += len;
            op += len;
        } else {
            int64_t len, offset;
            if (kind == 1) {                   // copy, 1-byte offset
                len = ((tag >> 2) & 7) + 4;
                if (p >= end) return ERR_MALFORMED;
                offset = ((int64_t)(tag >> 5) << 8) | *p++;
            } else if (kind == 2) {            // copy, 2-byte offset
                len = (tag >> 2) + 1;
                if (end - p < 2) return ERR_MALFORMED;
                offset = p[0] | ((int64_t)p[1] << 8);
                p += 2;
            } else {                           // copy, 4-byte offset
                len = (tag >> 2) + 1;
                if (end - p < 4) return ERR_MALFORMED;
                offset = p[0] | ((int64_t)p[1] << 8)
                       | ((int64_t)p[2] << 16) | ((int64_t)p[3] << 24);
                p += 4;
            }
            if (offset <= 0 || offset > op ||
                op + len > (int64_t)out_len) return ERR_MALFORMED;
            // overlapping copies are the point (run-length); byte-by-byte
            for (int64_t i = 0; i < len; i++, op++)
                dst[op] = dst[op - offset];
        }
    }
    return op == (int64_t)out_len ? (int64_t)out_len : ERR_MALFORMED;
}

// codec ids (parquet.thrift CompressionCodec)
enum { CODEC_UNCOMPRESSED = 0, CODEC_SNAPPY = 1, CODEC_ZSTD = 6 };

static int64_t decompress(int32_t codec, const uint8_t* src, int64_t n,
                          uint8_t* dst, int64_t dst_cap) {
    switch (codec) {
        case CODEC_UNCOMPRESSED:
            if (n > dst_cap) return ERR_MALFORMED;
            std::memcpy(dst, src, n);
            return n;
        case CODEC_SNAPPY:
            return snappy_uncompress(src, n, dst, dst_cap);
#ifdef RTPU_WITH_ZSTD
        case CODEC_ZSTD: {
            size_t r = ZSTD_decompress(dst, dst_cap, src, n);
            if (ZSTD_isError(r)) return ERR_MALFORMED;
            return (int64_t)r;
        }
#endif
        default:
            return ERR_UNSUPPORTED;
    }
}

// ---------------------------------------------------------------------------
// RLE / bit-packed hybrid reader (levels + dictionary indices)
// ---------------------------------------------------------------------------

struct RleReader {
    const uint8_t* p;
    const uint8_t* end;
    int bit_width;
    // current run
    int64_t run_left = 0;
    uint32_t run_value = 0;
    bool packed = false;
    uint64_t bit_buf = 0;
    int bits_in_buf = 0;
    int64_t packed_left = 0;
    bool ok = true;

    RleReader(const uint8_t* buf, int64_t len, int w)
        : p(buf), end(buf + len), bit_width(w) {}

    void next_run() {
        if (p >= end) { ok = false; return; }
        uint64_t header = 0;
        int shift = 0;
        while (p < end) {
            uint8_t b = *p++;
            header |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        if (header & 1) {                       // bit-packed groups
            packed = true;
            packed_left = (int64_t)(header >> 1) * 8;
            bit_buf = 0;
            bits_in_buf = 0;
        } else {                                // RLE run
            packed = false;
            run_left = (int64_t)(header >> 1);
            int nbytes = (bit_width + 7) / 8;
            if (end - p < nbytes) { ok = false; return; }
            run_value = 0;
            for (int i = 0; i < nbytes; i++)
                run_value |= (uint32_t)p[i] << (8 * i);
            p += nbytes;
        }
    }

    uint32_t next() {
        while (ok) {
            if (!packed && run_left > 0) { run_left--; return run_value; }
            if (packed && packed_left > 0) {
                while (bits_in_buf < bit_width) {
                    if (p >= end) {
                        // trailing group may be truncated at buffer end;
                        // pad with zero bits (values past num_values are
                        // never consumed by a well-formed page)
                        bit_buf |= 0;
                        bits_in_buf += 8;
                        continue;
                    }
                    bit_buf |= (uint64_t)(*p++) << bits_in_buf;
                    bits_in_buf += 8;
                }
                uint32_t v = (uint32_t)(bit_buf & ((1u << bit_width) - 1));
                bit_buf >>= bit_width;
                bits_in_buf -= bit_width;
                packed_left--;
                return v;
            }
            next_run();
        }
        return 0;
    }
};

// ---------------------------------------------------------------------------
// page-level decode
// ---------------------------------------------------------------------------

struct PageHeader {
    int32_t type = -1;
    int32_t uncompressed_size = 0;
    int32_t compressed_size = 0;
    // v1 data page
    int32_t num_values = 0;
    int32_t encoding = -1;
    int32_t def_encoding = -1;
    // v2 additions
    int32_t num_nulls = 0;
    int32_t num_rows = 0;
    int32_t def_len = 0;
    int32_t rep_len = 0;
    bool v2_compressed = true;
};

static bool parse_page_header(TReader& r, PageHeader& h) {
    int16_t last = 0;
    while (r.ok) {
        auto [id, t] = r.field_header(last);
        if (t == 0) break;
        last = id;
        switch (id) {
            case 1: h.type = (int32_t)r.zigzag(); break;
            case 2: h.uncompressed_size = (int32_t)r.zigzag(); break;
            case 3: h.compressed_size = (int32_t)r.zigzag(); break;
            case 5: case 7: {       // data_page_header / dictionary header
                int16_t l2 = 0;
                while (r.ok) {
                    auto [i2, t2] = r.field_header(l2);
                    if (t2 == 0) break;
                    l2 = i2;
                    if (i2 == 1) h.num_values = (int32_t)r.zigzag();
                    else if (i2 == 2) h.encoding = (int32_t)r.zigzag();
                    else if (i2 == 3 && id == 5)
                        h.def_encoding = (int32_t)r.zigzag();
                    else r.skip_value(t2);
                }
                break;
            }
            case 8: {               // data_page_header_v2
                int16_t l2 = 0;
                while (r.ok) {
                    auto [i2, t2] = r.field_header(l2);
                    if (t2 == 0) break;
                    l2 = i2;
                    switch (i2) {
                        case 1: h.num_values = (int32_t)r.zigzag(); break;
                        case 2: h.num_nulls = (int32_t)r.zigzag(); break;
                        case 3: h.num_rows = (int32_t)r.zigzag(); break;
                        case 4: h.encoding = (int32_t)r.zigzag(); break;
                        case 5: h.def_len = (int32_t)r.zigzag(); break;
                        case 6: h.rep_len = (int32_t)r.zigzag(); break;
                        case 7: h.v2_compressed = (t2 == 1); break;
                        default: r.skip_value(t2);
                    }
                }
                break;
            }
            default: r.skip_value(t);
        }
    }
    return r.ok;
}

enum { PT_BOOLEAN = 0, PT_INT32 = 1, PT_INT64 = 2, PT_INT96 = 3,
       PT_FLOAT = 4, PT_DOUBLE = 5, PT_BYTE_ARRAY = 6, PT_FLBA = 7 };
enum { ENC_PLAIN = 0, ENC_PLAIN_DICT = 2, ENC_RLE = 3, ENC_RLE_DICT = 8 };
enum { PAGE_DATA = 0, PAGE_DICT = 2, PAGE_DATA_V2 = 3 };

static int elem_size(int32_t ptype) {
    switch (ptype) {
        case PT_BOOLEAN: return 1;            // decoded to one byte
        case PT_INT32: case PT_FLOAT: return 4;
        case PT_INT64: case PT_DOUBLE: return 8;
        default: return -1;
    }
}

// shared chunk walker: fixed-width and byte-array variants share the page
// loop and differ only in value materialization.
struct BinaryOut {
    int32_t* offsets;       // [expected_rows + 1]
    uint8_t* bytes;
    int64_t bytes_cap;
    int64_t bytes_used = 0;
    int64_t bytes_needed = 0;   // tracked even past cap (for retry sizing)
};

struct DecodeCtx {
    int32_t ptype;
    int32_t codec;
    int32_t max_def;
    int64_t expected_rows;
    uint8_t* out_values;        // fixed-width path
    uint8_t* out_validity;      // 1 byte per row
    BinaryOut* bin;             // byte-array path (null for fixed)
    // dictionary (decoded PLAIN values)
    std::vector<uint8_t> dict_fixed;
    std::vector<std::string> dict_bin;
    int64_t dict_count = 0;
};

// Materialize definition levels (bit width 1, flat schemas) into one byte
// per level using run-block fills — the hot shape is a single RLE run of
// 1s (no nulls in the page), which becomes one memset.
static bool decode_levels1(const uint8_t* buf, int64_t len, int64_t n,
                           uint8_t* out) {
    RleReader r(buf, len, 1);
    int64_t i = 0;
    while (i < n) {
        if (!r.packed && r.run_left > 0) {
            int64_t k = std::min(r.run_left, n - i);
            std::memset(out + i, (uint8_t)(r.run_value & 1), k);
            r.run_left -= k;
            i += k;
        } else if (r.packed && r.packed_left > 0) {
            int64_t k = std::min(r.packed_left, n - i);
            for (int64_t j = 0; j < k; j++) out[i + j] = (uint8_t)r.next();
            i += k;
        } else {
            if (!r.ok) return false;
            r.next_run();
        }
    }
    return true;
}

// Expand an RLE/bit-packed hybrid stream into n uint32 values, run-blocked.
static bool decode_indices(RleReader& r, int64_t n, uint32_t* out) {
    int64_t i = 0;
    while (i < n) {
        if (!r.packed && r.run_left > 0) {
            int64_t k = std::min(r.run_left, n - i);
            std::fill(out + i, out + i + k, r.run_value);
            r.run_left -= k;
            i += k;
        } else if (r.packed && r.packed_left > 0) {
            int64_t k = std::min(r.packed_left, n - i);
            // tight unpack: hoist the reader state into locals and bound
            // the byte reads once (the one-value-at-a-time state machine
            // was the decode hot spot for dict-encoded columns)
            int w = r.bit_width;
            uint64_t buf = r.bit_buf;
            int bits = r.bits_in_buf;
            const uint8_t* p = r.p;
            const uint32_t mask = w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1);
            int64_t avail = w == 0 ? k
                : ((int64_t)(r.end - p) * 8 + bits) / w;
            int64_t fast = std::min(k, avail);
            int64_t j = 0;
            if (w > 0 && w <= 14) {
                // 4 values per 64-bit refill (4w <= 56 bits guaranteed
                // after topping the buffer past 56)
                while (j + 4 <= fast && r.end - p >= 8) {
                    while (bits <= 56) {
                        buf |= (uint64_t)(*p++) << bits;
                        bits += 8;
                    }
                    out[i + j] = (uint32_t)(buf & mask); buf >>= w;
                    out[i + j + 1] = (uint32_t)(buf & mask); buf >>= w;
                    out[i + j + 2] = (uint32_t)(buf & mask); buf >>= w;
                    out[i + j + 3] = (uint32_t)(buf & mask); buf >>= w;
                    bits -= 4 * w;
                    j += 4;
                }
            }
            for (; j < fast; j++) {
                while (bits < w) {
                    buf |= (uint64_t)(*p++) << bits;
                    bits += 8;
                }
                out[i + j] = (uint32_t)(buf & mask);
                buf >>= w;
                bits -= w;
            }
            // exhausted stream inside a group: zero-pad (matches next())
            for (int64_t j2 = fast; j2 < k; j2++) out[i + j2] = 0;
            if (r.packed_left == k && bits >= 8) {
                // run complete: packed runs end byte-aligned, so whole
                // bytes still in the bit buffer were over-read from the
                // NEXT run's header by the eager refill — push them back
                p -= bits / 8;
                bits &= 7;
                buf = 0;
            }
            r.bit_buf = buf;
            r.bits_in_buf = bits;
            r.p = p;
            r.packed_left -= k;
            i += k;
        } else {
            if (!r.ok) return false;
            r.next_run();
        }
    }
    return true;
}

// fill c.out_validity[row0..row0+n) and return non-null count, or -1
static int64_t materialize_defs(DecodeCtx& c, const uint8_t* defs,
                                int64_t defs_len, int64_t n_levels,
                                int64_t row0) {
    uint8_t* v = c.out_validity + row0;
    if (c.max_def == 0) {
        std::memset(v, 1, n_levels);
        return n_levels;
    }
    if (!decode_levels1(defs, defs_len, n_levels, v)) return -1;
    int64_t nnz = 0;
    for (int64_t i = 0; i < n_levels; i++) nnz += v[i];
    return nnz;
}

template <typename T>
static void scatter_vals(T* out, const T* in, const uint8_t* valid,
                         int64_t n) {
    int64_t vpos = 0;
    for (int64_t i = 0; i < n; i++)
        out[i] = valid[i] ? in[vpos++] : T(0);
}

template <typename T>
static void gather_dict(T* out, const T* dict, const uint32_t* idx,
                        const uint8_t* valid, int64_t n, bool dense) {
    if (dense) {
        for (int64_t i = 0; i < n; i++) out[i] = dict[idx[i]];
        return;
    }
    int64_t vpos = 0;
    for (int64_t i = 0; i < n; i++)
        out[i] = valid[i] ? dict[idx[vpos++]] : T(0);
}

static int64_t emit_fixed_plain(DecodeCtx& c, const uint8_t* vals,
                                int64_t vals_len, const uint8_t* defs,
                                int64_t defs_len, int64_t n_levels,
                                int64_t row0, int32_t def_encoding) {
    (void)def_encoding;
    if (row0 + n_levels > c.expected_rows) return ERR_MALFORMED;
    int64_t nnz = materialize_defs(c, defs, defs_len, n_levels, row0);
    if (nnz < 0) return ERR_MALFORMED;
    const uint8_t* valid = c.out_validity + row0;
    if (c.ptype == PT_BOOLEAN) {
        // PLAIN booleans: bit-packed LSB-first over non-null slots
        if ((nnz + 7) / 8 > vals_len) return ERR_MALFORMED;
        int64_t bit = 0;
        for (int64_t i = 0; i < n_levels; i++) {
            if (valid[i]) {
                c.out_values[row0 + i] = (vals[bit >> 3] >> (bit & 7)) & 1;
                bit++;
            } else {
                c.out_values[row0 + i] = 0;
            }
        }
        return n_levels;
    }
    int es = elem_size(c.ptype);
    if (nnz * es > vals_len) return ERR_MALFORMED;
    uint8_t* out = c.out_values + row0 * es;
    if (nnz == n_levels) {                       // no nulls: one block copy
        std::memcpy(out, vals, n_levels * es);
        return n_levels;
    }
    if (es == 4)
        scatter_vals((uint32_t*)out, (const uint32_t*)vals, valid, n_levels);
    else
        scatter_vals((uint64_t*)out, (const uint64_t*)vals, valid, n_levels);
    return n_levels;
}

static int64_t emit_fixed_dict(DecodeCtx& c, const uint8_t* vals,
                               int64_t vals_len, const uint8_t* defs,
                               int64_t defs_len, int64_t n_levels,
                               int64_t row0) {
    if (vals_len < 1) return ERR_MALFORMED;
    if (row0 + n_levels > c.expected_rows) return ERR_MALFORMED;
    int bw = vals[0];
    if (bw > 32) return ERR_MALFORMED;
    int64_t nnz = materialize_defs(c, defs, defs_len, n_levels, row0);
    if (nnz < 0) return ERR_MALFORMED;
    const uint8_t* valid = c.out_validity + row0;
    std::vector<uint32_t> idx(nnz);
    if (bw == 0) {
        std::fill(idx.begin(), idx.end(), 0u);
    } else {
        RleReader idxr(vals + 1, vals_len - 1, bw);
        if (!decode_indices(idxr, nnz, idx.data())) return ERR_MALFORMED;
    }
    for (int64_t i = 0; i < nnz; i++)
        if ((int64_t)idx[i] >= c.dict_count) return ERR_MALFORMED;
    int es = elem_size(c.ptype);
    uint8_t* out = c.out_values + row0 * es;
    bool dense = nnz == n_levels;
    if (c.ptype == PT_BOOLEAN)
        gather_dict(out, c.dict_fixed.data(), idx.data(), valid,
                    n_levels, dense);
    else if (es == 4)
        gather_dict((uint32_t*)out, (const uint32_t*)c.dict_fixed.data(),
                    idx.data(), valid, n_levels, dense);
    else
        gather_dict((uint64_t*)out, (const uint64_t*)c.dict_fixed.data(),
                    idx.data(), valid, n_levels, dense);
    return n_levels;
}

static void bin_append(DecodeCtx& c, int64_t row, const uint8_t* data,
                       int64_t len) {
    c.bin->bytes_needed += len;
    if (c.bin->bytes_used + len <= c.bin->bytes_cap) {
        std::memcpy(c.bin->bytes + c.bin->bytes_used, data, len);
        c.bin->bytes_used += len;
    }
    c.bin->offsets[row + 1] = (int32_t)c.bin->bytes_needed;
}

static int64_t emit_binary(DecodeCtx& c, const uint8_t* vals,
                           int64_t vals_len, const uint8_t* defs,
                           int64_t defs_len, int64_t n_levels,
                           int64_t row0, bool dict) {
    if (row0 + n_levels > c.expected_rows) return ERR_MALFORMED;
    int64_t nnz = materialize_defs(c, defs, defs_len, n_levels, row0);
    if (nnz < 0) return ERR_MALFORMED;
    const uint8_t* valid = c.out_validity + row0;
    int64_t vpos = 0;
    if (dict) {
        if (vals_len < 1) return ERR_MALFORMED;
        int bw = vals[0];
        if (bw > 32) return ERR_MALFORMED;
        std::vector<uint32_t> idx(nnz);
        if (bw == 0) {
            std::fill(idx.begin(), idx.end(), 0u);
        } else {
            RleReader idxr(vals + 1, vals_len - 1, bw);
            if (!decode_indices(idxr, nnz, idx.data()))
                return ERR_MALFORMED;
        }
        int64_t ipos = 0;
        for (int64_t i = 0; i < n_levels; i++) {
            int64_t row = row0 + i;
            if (!valid[i]) {
                c.bin->offsets[row + 1] = (int32_t)c.bin->bytes_needed;
                continue;
            }
            uint32_t ix = idx[ipos++];
            if ((int64_t)ix >= c.dict_count) return ERR_MALFORMED;
            const std::string& s = c.dict_bin[ix];
            bin_append(c, row, (const uint8_t*)s.data(), (int64_t)s.size());
        }
        return n_levels;
    }
    for (int64_t i = 0; i < n_levels; i++) {
        int64_t row = row0 + i;
        if (!valid[i]) {
            c.bin->offsets[row + 1] = (int32_t)c.bin->bytes_needed;
            continue;
        }
        if (vpos + 4 > vals_len) return ERR_MALFORMED;
        uint32_t len;
        std::memcpy(&len, vals + vpos, 4);
        vpos += 4;
        if (vpos + len > (uint64_t)vals_len) return ERR_MALFORMED;
        bin_append(c, row, vals + vpos, len);
        vpos += len;
    }
    return n_levels;
}

static int64_t load_dict(DecodeCtx& c, const uint8_t* vals,
                         int64_t vals_len, int64_t n) {
    c.dict_count = n;
    if (c.ptype == PT_BYTE_ARRAY) {
        c.dict_bin.clear();
        int64_t pos = 0;
        for (int64_t i = 0; i < n; i++) {
            if (pos + 4 > vals_len) return ERR_MALFORMED;
            uint32_t len;
            std::memcpy(&len, vals + pos, 4);
            pos += 4;
            if (pos + len > (uint64_t)vals_len) return ERR_MALFORMED;
            c.dict_bin.emplace_back((const char*)(vals + pos), len);
            pos += len;
        }
        return n;
    }
    int es = elem_size(c.ptype);
    if (es < 0 || n * es > vals_len) return ERR_MALFORMED;
    c.dict_fixed.assign(vals, vals + n * es);
    return n;
}

// value-section dispatch shared by v1 and v2 data pages
static int64_t emit_values(DecodeCtx& c, int32_t encoding,
                           const uint8_t* vals, int64_t vals_len,
                           const uint8_t* defs, int64_t defs_len,
                           int64_t n_levels, int64_t row0) {
    bool dict = encoding == ENC_PLAIN_DICT || encoding == ENC_RLE_DICT;
    if (c.bin) {
        if (!dict && encoding != ENC_PLAIN) return ERR_UNSUPPORTED;
        return emit_binary(c, vals, vals_len, defs, defs_len, n_levels,
                           row0, dict);
    }
    if (dict)
        return emit_fixed_dict(c, vals, vals_len, defs, defs_len,
                               n_levels, row0);
    if (encoding == ENC_PLAIN)
        return emit_fixed_plain(c, vals, vals_len, defs, defs_len,
                                n_levels, row0, ENC_RLE);
    if (encoding == ENC_RLE && c.ptype == PT_BOOLEAN) {
        // RLE-encoded booleans: u32 LE length prefix + hybrid runs
        if (vals_len < 4) return ERR_MALFORMED;
        if (row0 + n_levels > c.expected_rows) return ERR_MALFORMED;
        int64_t nnz = materialize_defs(c, defs, defs_len, n_levels, row0);
        if (nnz < 0) return ERR_MALFORMED;
        const uint8_t* valid = c.out_validity + row0;
        std::vector<uint32_t> bits(nnz);
        RleReader br(vals + 4, vals_len - 4, 1);
        if (!decode_indices(br, nnz, bits.data())) return ERR_MALFORMED;
        int64_t vpos = 0;
        for (int64_t i = 0; i < n_levels; i++)
            c.out_values[row0 + i] =
                valid[i] ? (uint8_t)bits[vpos++] : 0;
        return n_levels;
    }
    return ERR_UNSUPPORTED;
}

static int64_t decode_chunk(DecodeCtx& c, const uint8_t* chunk,
                            int64_t chunk_len) {
    if (c.ptype != PT_BYTE_ARRAY && elem_size(c.ptype) < 0)
        return ERR_UNSUPPORTED;
    const uint8_t* p = chunk;
    const uint8_t* end = chunk + chunk_len;
    int64_t rows = 0;
    std::vector<uint8_t> scratch;
    if (c.bin) c.bin->offsets[0] = 0;
    while (p < end && rows < c.expected_rows) {
        TReader r(p, end - p);
        PageHeader h;
        if (!parse_page_header(r, h)) return ERR_MALFORMED;
        p = r.p;
        if (end - p < h.compressed_size) return ERR_MALFORMED;
        if (h.type == PAGE_DICT) {
            scratch.resize(h.uncompressed_size);
            int64_t un = decompress(c.codec, p, h.compressed_size,
                                    scratch.data(), scratch.size());
            if (un < 0) return un;
            int64_t res = load_dict(c, scratch.data(), un, h.num_values);
            if (res < 0) return res;
        } else if (h.type == PAGE_DATA) {
            if (c.max_def > 0 && h.def_encoding != ENC_RLE)
                return ERR_UNSUPPORTED;
            scratch.resize(h.uncompressed_size);
            int64_t un = decompress(c.codec, p, h.compressed_size,
                                    scratch.data(), scratch.size());
            if (un < 0) return un;
            const uint8_t* defs = nullptr;
            int64_t defs_len = 0;
            const uint8_t* vals = scratch.data();
            int64_t vals_len = un;
            if (c.max_def > 0) {
                // v1 RLE levels: u32 LE length prefix
                if (un < 4) return ERR_MALFORMED;
                uint32_t dl;
                std::memcpy(&dl, scratch.data(), 4);
                if (4 + (int64_t)dl > un) return ERR_MALFORMED;
                defs = scratch.data() + 4;
                defs_len = dl;
                vals = scratch.data() + 4 + dl;
                vals_len = un - 4 - dl;
            }
            int64_t res = emit_values(c, h.encoding, vals, vals_len,
                                      defs, defs_len, h.num_values, rows);
            if (res < 0) return res;
            rows += res;
        } else if (h.type == PAGE_DATA_V2) {
            // v2: rep + def level bytes sit UNCOMPRESSED before the value
            // section; levels have no u32 length prefix
            if (h.rep_len != 0) return ERR_UNSUPPORTED;   // flat only
            int64_t lvl = h.def_len;
            if (lvl > h.compressed_size) return ERR_MALFORMED;
            const uint8_t* defs = p;
            int64_t defs_len = lvl;
            const uint8_t* comp_vals = p + lvl;
            int64_t comp_len = h.compressed_size - lvl;
            int64_t vals_cap = h.uncompressed_size - lvl;
            scratch.resize(vals_cap > 0 ? vals_cap : 0);
            int64_t un;
            if (h.v2_compressed) {
                un = decompress(c.codec, comp_vals, comp_len,
                                scratch.data(), scratch.size());
                if (un < 0) return un;
            } else {
                un = comp_len;
                scratch.assign(comp_vals, comp_vals + comp_len);
            }
            int64_t res = emit_values(c, h.encoding, scratch.data(), un,
                                      defs, defs_len, h.num_values, rows);
            if (res < 0) return res;
            rows += res;
        } else {
            // index pages etc.: skip
        }
        p += h.compressed_size;
    }
    if (rows != c.expected_rows) return ERR_MALFORMED;
    if (c.bin && c.bin->bytes_needed > c.bin->bytes_cap)
        return ERR_SPACE;
    return rows;
}

// ---------------------------------------------------------------------------
// handle registry
// ---------------------------------------------------------------------------

// ctypes releases the GIL around native calls and the reader pool opens
// footers concurrently — the registry needs its own lock
std::mutex g_footers_mutex;
std::map<int64_t, Footer*> g_footers;
int64_t g_next_handle = 1;

}  // namespace

extern "C" {

// 1 where this build decodes ZSTD chunks, else 0
int32_t rtpu_pq_has_zstd() {
#ifdef RTPU_WITH_ZSTD
    return 1;
#else
    return 0;
#endif
}

int64_t rtpu_pq_footer_open(const uint8_t* buf, int64_t len) {
    Footer* f = parse_footer(buf, len);
    if (!f) return ERR_MALFORMED;
    // column count consistency
    for (auto& rg : f->rgs)
        if (rg.size() != f->cols.size()) { delete f; return ERR_MALFORMED; }
    std::lock_guard<std::mutex> g(g_footers_mutex);
    int64_t h = g_next_handle++;
    g_footers[h] = f;
    return h;
}

void rtpu_pq_footer_free(int64_t h) {
    Footer* doomed = nullptr;
    {
        std::lock_guard<std::mutex> g(g_footers_mutex);
        auto it = g_footers.find(h);
        if (it != g_footers.end()) {
            doomed = it->second;
            g_footers.erase(it);
        }
    }
    delete doomed;
}

static Footer* get(int64_t h) {
    std::lock_guard<std::mutex> g(g_footers_mutex);
    auto it = g_footers.find(h);
    return it == g_footers.end() ? nullptr : it->second;
}

int64_t rtpu_pq_num_rows(int64_t h) {
    Footer* f = get(h);
    return f ? f->num_rows : ERR_HANDLE;
}

int32_t rtpu_pq_num_columns(int64_t h) {
    Footer* f = get(h);
    return f ? (int32_t)f->cols.size() : ERR_HANDLE;
}

int32_t rtpu_pq_num_row_groups(int64_t h) {
    Footer* f = get(h);
    return f ? (int32_t)f->rgs.size() : ERR_HANDLE;
}

int64_t rtpu_pq_rg_rows(int64_t h, int32_t rg) {
    Footer* f = get(h);
    if (!f || rg < 0 || rg >= (int32_t)f->rg_rows.size()) return ERR_HANDLE;
    return f->rg_rows[rg];
}

int32_t rtpu_pq_col_name(int64_t h, int32_t c, char* out, int32_t cap) {
    Footer* f = get(h);
    if (!f || c < 0 || c >= (int32_t)f->cols.size()) return ERR_HANDLE;
    const std::string& s = f->cols[c].name;
    if ((int32_t)s.size() + 1 > cap) return ERR_SPACE;
    std::memcpy(out, s.data(), s.size());
    out[s.size()] = 0;
    return (int32_t)s.size();
}

// out[0]=physical type, out[1]=max_def, out[2]=flat(0/1), out[3]=is_decimal
int32_t rtpu_pq_col_info(int64_t h, int32_t c, int64_t* out) {
    Footer* f = get(h);
    if (!f || c < 0 || c >= (int32_t)f->cols.size()) return ERR_HANDLE;
    out[0] = f->cols[c].type;
    out[1] = f->cols[c].max_def;
    out[2] = f->cols[c].flat ? 1 : 0;
    out[3] = f->cols[c].is_decimal ? 1 : 0;
    return 0;
}

// out[0]=codec, out[1]=chunk start offset, out[2]=total_compressed_size,
// out[3]=num_values, out[4]=total_uncompressed_size
int32_t rtpu_pq_chunk_info(int64_t h, int32_t rg, int32_t c, int64_t* out) {
    Footer* f = get(h);
    if (!f || rg < 0 || rg >= (int32_t)f->rgs.size()
        || c < 0 || c >= (int32_t)f->rgs[rg].size()) return ERR_HANDLE;
    const ChunkMeta& m = f->rgs[rg][c];
    int64_t start = m.data_page_offset;
    if (m.dict_page_offset >= 0 && m.dict_page_offset < start)
        start = m.dict_page_offset;
    out[0] = m.codec;
    out[1] = start;
    out[2] = m.total_compressed;
    out[3] = m.num_values;
    out[4] = m.total_uncompressed;
    return 0;
}

// copies raw PLAIN-encoded stat bytes; returns a presence bitmask
// (1 = min, 2 = max, 4 = null_count). min/max buffers must hold >= 16 bytes;
// lengths land in len_out[0], len_out[1]; null count in len_out[2].
int32_t rtpu_pq_chunk_stats(int64_t h, int32_t rg, int32_t c,
                            uint8_t* min_out, uint8_t* max_out,
                            int64_t* len_out) {
    Footer* f = get(h);
    if (!f || rg < 0 || rg >= (int32_t)f->rgs.size()
        || c < 0 || c >= (int32_t)f->rgs[rg].size()) return ERR_HANDLE;
    const Stats& s = f->rgs[rg][c].stats;
    int32_t mask = 0;
    if (s.has_min && s.min_value.size() <= 16) {
        std::memcpy(min_out, s.min_value.data(), s.min_value.size());
        len_out[0] = (int64_t)s.min_value.size();
        mask |= 1;
    }
    if (s.has_max && s.max_value.size() <= 16) {
        std::memcpy(max_out, s.max_value.data(), s.max_value.size());
        len_out[1] = (int64_t)s.max_value.size();
        mask |= 2;
    }
    if (s.null_count >= 0) {
        len_out[2] = s.null_count;
        mask |= 4;
    }
    return mask;
}

int32_t rtpu_pq_has_kv_key(int64_t h, const char* key) {
    Footer* f = get(h);
    if (!f) return ERR_HANDLE;
    for (auto& kv : f->kv)
        if (kv.first == key) return 1;
    return 0;
}

// Decode one fixed-width column chunk into out_values (expected_rows *
// elem size; booleans one byte per row) + out_validity (one byte per row).
// Returns rows decoded or a negative error.
int64_t rtpu_pq_decode_fixed(const uint8_t* chunk, int64_t chunk_len,
                             int32_t ptype, int32_t codec, int32_t max_def,
                             int64_t expected_rows, uint8_t* out_values,
                             uint8_t* out_validity) {
    DecodeCtx c;
    c.ptype = ptype;
    c.codec = codec;
    c.max_def = max_def;
    c.expected_rows = expected_rows;
    c.out_values = out_values;
    c.out_validity = out_validity;
    c.bin = nullptr;
    return decode_chunk(c, chunk, chunk_len);
}

// Decode one BYTE_ARRAY chunk into arrow-style offsets[rows+1] + bytes.
// On ERR_SPACE, offsets[expected_rows] still holds the NEEDED byte count —
// the caller reallocates and retries.
int64_t rtpu_pq_decode_binary(const uint8_t* chunk, int64_t chunk_len,
                              int32_t codec, int32_t max_def,
                              int64_t expected_rows, int32_t* out_offsets,
                              uint8_t* out_bytes, int64_t bytes_cap,
                              uint8_t* out_validity) {
    DecodeCtx c;
    c.ptype = PT_BYTE_ARRAY;
    c.codec = codec;
    c.max_def = max_def;
    c.expected_rows = expected_rows;
    c.out_values = nullptr;
    c.out_validity = out_validity;
    BinaryOut b{out_offsets, out_bytes, bytes_cap};
    c.bin = &b;
    return decode_chunk(c, chunk, chunk_len);
}

// Decode one BYTE_ARRAY chunk KEEPING its RLE_DICTIONARY codes (the
// compressed-execution scan hand-off: per-row bytes are never
// materialized; the engine gets codes + the dictionary page's values).
// Outputs: out_codes[expected_rows] (0 on null rows), out_validity
// (one byte per row), dictionary as arrow-style
// dict_offsets[dict_count+1] + dict_bytes. info[0] returns the dictionary
// entry count and info[1] its byte size; if the provided caps are too
// small the call returns ERR_SPACE with the needed sizes still in info,
// and the caller reallocates and retries. A chunk containing any
// non-dictionary data page (writer dictionary-overflow fallback) returns
// ERR_UNSUPPORTED — the caller takes the materializing decode instead.
int64_t rtpu_pq_decode_binary_codes(
        const uint8_t* chunk, int64_t chunk_len, int32_t codec,
        int32_t max_def, int64_t expected_rows,
        int32_t* out_codes, uint8_t* out_validity,
        int32_t* dict_offsets, int64_t dict_entries_cap,
        uint8_t* dict_bytes, int64_t dict_bytes_cap,
        int64_t* info) {
    DecodeCtx c;
    c.ptype = PT_BYTE_ARRAY;
    c.codec = codec;
    c.max_def = max_def;
    c.expected_rows = expected_rows;
    c.out_values = nullptr;
    c.out_validity = out_validity;
    c.bin = nullptr;
    info[0] = 0;
    info[1] = 0;
    const uint8_t* p = chunk;
    const uint8_t* end = chunk + chunk_len;
    int64_t rows = 0;
    std::vector<uint8_t> scratch;
    auto emit_codes = [&](const uint8_t* vals, int64_t vals_len,
                          const uint8_t* defs, int64_t defs_len,
                          int64_t n_levels, int64_t row0) -> int64_t {
        if (row0 + n_levels > c.expected_rows) return ERR_MALFORMED;
        if (vals_len < 1) return ERR_MALFORMED;
        int bw = vals[0];
        if (bw > 32) return ERR_MALFORMED;
        int64_t nnz = materialize_defs(c, defs, defs_len, n_levels, row0);
        if (nnz < 0) return ERR_MALFORMED;
        const uint8_t* valid = c.out_validity + row0;
        std::vector<uint32_t> idx(nnz);
        if (bw == 0) {
            std::fill(idx.begin(), idx.end(), 0u);
        } else {
            RleReader idxr(vals + 1, vals_len - 1, bw);
            if (!decode_indices(idxr, nnz, idx.data()))
                return ERR_MALFORMED;
        }
        int64_t ipos = 0;
        for (int64_t i = 0; i < n_levels; i++) {
            if (valid[i]) {
                uint32_t ix = idx[ipos++];
                if ((int64_t)ix >= c.dict_count) return ERR_MALFORMED;
                out_codes[row0 + i] = (int32_t)ix;
            } else {
                out_codes[row0 + i] = 0;
            }
        }
        return n_levels;
    };
    while (p < end && rows < c.expected_rows) {
        TReader r(p, end - p);
        PageHeader h;
        if (!parse_page_header(r, h)) return ERR_MALFORMED;
        p = r.p;
        if (end - p < h.compressed_size) return ERR_MALFORMED;
        if (h.type == PAGE_DICT) {
            scratch.resize(h.uncompressed_size);
            int64_t un = decompress(c.codec, p, h.compressed_size,
                                    scratch.data(), scratch.size());
            if (un < 0) return un;
            int64_t res = load_dict(c, scratch.data(), un, h.num_values);
            if (res < 0) return res;
        } else if (h.type == PAGE_DATA) {
            if (h.encoding != ENC_PLAIN_DICT && h.encoding != ENC_RLE_DICT)
                return ERR_UNSUPPORTED;
            if (c.max_def > 0 && h.def_encoding != ENC_RLE)
                return ERR_UNSUPPORTED;
            scratch.resize(h.uncompressed_size);
            int64_t un = decompress(c.codec, p, h.compressed_size,
                                    scratch.data(), scratch.size());
            if (un < 0) return un;
            const uint8_t* defs = nullptr;
            int64_t defs_len = 0;
            const uint8_t* vals = scratch.data();
            int64_t vals_len = un;
            if (c.max_def > 0) {
                if (un < 4) return ERR_MALFORMED;
                uint32_t dl;
                std::memcpy(&dl, scratch.data(), 4);
                if (4 + (int64_t)dl > un) return ERR_MALFORMED;
                defs = scratch.data() + 4;
                defs_len = dl;
                vals = scratch.data() + 4 + dl;
                vals_len = un - 4 - dl;
            }
            int64_t res = emit_codes(vals, vals_len, defs, defs_len,
                                     h.num_values, rows);
            if (res < 0) return res;
            rows += res;
        } else if (h.type == PAGE_DATA_V2) {
            if (h.encoding != ENC_PLAIN_DICT && h.encoding != ENC_RLE_DICT)
                return ERR_UNSUPPORTED;
            if (h.rep_len != 0) return ERR_UNSUPPORTED;   // flat only
            int64_t lvl = h.def_len;
            if (lvl > h.compressed_size) return ERR_MALFORMED;
            const uint8_t* defs = p;
            int64_t defs_len = lvl;
            const uint8_t* comp_vals = p + lvl;
            int64_t comp_len = h.compressed_size - lvl;
            int64_t vals_cap = h.uncompressed_size - lvl;
            scratch.resize(vals_cap > 0 ? vals_cap : 0);
            int64_t un;
            if (h.v2_compressed) {
                un = decompress(c.codec, comp_vals, comp_len,
                                scratch.data(), scratch.size());
                if (un < 0) return un;
            } else {
                un = comp_len;
                scratch.assign(comp_vals, comp_vals + comp_len);
            }
            int64_t res = emit_codes(scratch.data(), un, defs, defs_len,
                                     h.num_values, rows);
            if (res < 0) return res;
            rows += res;
        } else {
            // index pages etc.: skip
        }
        p += h.compressed_size;
    }
    if (rows != c.expected_rows) return ERR_MALFORMED;
    int64_t total = 0;
    for (const std::string& s : c.dict_bin) total += (int64_t)s.size();
    info[0] = c.dict_count;
    info[1] = total;
    if (c.dict_count > dict_entries_cap || total > dict_bytes_cap)
        return ERR_SPACE;
    int64_t off = 0;
    dict_offsets[0] = 0;
    for (int64_t i = 0; i < c.dict_count; i++) {
        const std::string& s = c.dict_bin[i];
        std::memcpy(dict_bytes + off, s.data(), s.size());
        off += (int64_t)s.size();
        dict_offsets[i + 1] = (int32_t)off;
    }
    return rows;
}

}  // extern "C"
