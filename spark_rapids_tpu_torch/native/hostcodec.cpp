// Host codec of the Parquet decoder (io/fastpar.py) and the wire
// encoder (columnar/transfer.py).
//
// The byte-crunching steps of decoding a column chunk on the host:
// snappy (the public block format), the Parquet RLE/bit-packed hybrid
// that carries dictionary codes and definition levels, and the walk
// over a chunk's page headers (the thrift compact protocol); and the
// wire encoder's passes: the fixed-width chars matrix, the min/max
// scan and bias packs of integers, and the int32-cents check.  Plain C
// ABI, loaded with ctypes (native/__init__.py); a ctypes call releases
// the GIL, so the scan's decode pool runs these in parallel.  Each
// function is single-threaded: parallelism comes from files.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Raw snappy block decompress (format: github.com/google/snappy
// format_description.txt).  `in` points AFTER the uncompressed-length
// preamble; out_len must equal the decoded size from the preamble.
// Returns 0 on success, -1 on malformed/overflow input.
int snappy_raw_decompress(const uint8_t* in, int64_t in_len,
                          uint8_t* out, int64_t out_len) {
    int64_t ip = 0, op = 0;
    while (ip < in_len) {
        uint8_t tag = in[ip++];
        uint32_t kind = tag & 3u;
        if (kind == 0) {  // literal
            int64_t len = (tag >> 2) + 1;
            if (len > 60) {
                int n_extra = static_cast<int>(len - 60);
                if (ip + n_extra > in_len) return -1;
                uint32_t l = 0;
                for (int i = 0; i < n_extra; ++i)
                    l |= static_cast<uint32_t>(in[ip + i]) << (8 * i);
                ip += n_extra;
                len = static_cast<int64_t>(l) + 1;
            }
            if (ip + len > in_len || op + len > out_len) return -1;
            std::memcpy(out + op, in + ip, static_cast<size_t>(len));
            ip += len;
            op += len;
            continue;
        }
        int64_t len, offset;
        if (kind == 1) {  // copy, 1-byte offset
            len = ((tag >> 2) & 7u) + 4;
            if (ip >= in_len) return -1;
            offset = (static_cast<int64_t>(tag >> 5) << 8) | in[ip++];
        } else if (kind == 2) {  // copy, 2-byte offset
            len = (tag >> 2) + 1;
            if (ip + 2 > in_len) return -1;
            offset = in[ip] | (static_cast<int64_t>(in[ip + 1]) << 8);
            ip += 2;
        } else {  // copy, 4-byte offset
            len = (tag >> 2) + 1;
            if (ip + 4 > in_len) return -1;
            offset = static_cast<int64_t>(in[ip])
                   | (static_cast<int64_t>(in[ip + 1]) << 8)
                   | (static_cast<int64_t>(in[ip + 2]) << 16)
                   | (static_cast<int64_t>(in[ip + 3]) << 24);
            ip += 4;
        }
        if (offset <= 0 || offset > op || op + len > out_len) return -1;
        const uint8_t* src = out + op - offset;
        if (offset >= len) {
            std::memcpy(out + op, src, static_cast<size_t>(len));
        } else if (offset >= 8) {
            // overlapping, but each 8-byte word is read before it is
            // written: word copies keep the replication semantics
            int64_t i = 0;
            for (; i + 8 <= len; i += 8) {
                uint64_t w;
                std::memcpy(&w, src + i, 8);
                std::memcpy(out + op + i, &w, 8);
            }
            for (; i < len; ++i) out[op + i] = src[i];
        } else {
            // a short period: the bytes repeat every `offset`, so also
            // every p >= 8 (a multiple of it); after the first 8 bytes
            // each word copies from p back, never from bytes it writes
            uint8_t* dst = out + op;
            int64_t i = 0;
            for (; i < len && i < 8; ++i) dst[i] = src[i];
            int64_t p = offset;
            while (p < 8) p += offset;
            for (; i + 8 <= len; i += 8) {
                uint64_t w;
                std::memcpy(&w, dst + i - p, 8);
                std::memcpy(dst + i, &w, 8);
            }
            for (; i < len; ++i) dst[i] = dst[i - p];
        }
        op += len;
    }
    return op == out_len ? 0 : -1;
}

// Parquet RLE/bit-packed hybrid decode into uint32 values
// (format-specs/Encodings.md).  `in` points at the first run header
// (caller strips the 1-byte bit width of dictionary index streams and
// the 4-byte length prefix of v1 definition levels).  Decodes exactly
// n values; returns 0 on success, -1 on malformed input.
int rle_unpack_u32(const uint8_t* in, int64_t in_len, int bit_width,
                   uint32_t* out, int64_t n) {
    if (bit_width < 0 || bit_width > 32) return -1;
    int64_t ip = 0, op = 0;
    if (bit_width == 0) {
        for (int64_t i = 0; i < n; ++i) out[i] = 0;
        return 0;
    }
    const int byte_w = (bit_width + 7) / 8;
    while (op < n) {
        // varint run header
        uint64_t h = 0;
        int shift = 0;
        while (true) {
            if (ip >= in_len || shift > 63) return -1;
            uint8_t b = in[ip++];
            h |= static_cast<uint64_t>(b & 0x7f) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        // a malformed header with h >> 1 beyond any real run would
        // overflow the count/nbytes arithmetic below — reject it
        if ((h >> 1) > (1ull << 40)) return -1;
        if (h & 1) {  // bit-packed groups of 8
            int64_t count = static_cast<int64_t>(h >> 1) * 8;
            int64_t nbytes = count * bit_width / 8;
            if (ip + nbytes > in_len) return -1;
            int64_t take = count < n - op ? count : n - op;
            const uint8_t* p = in + ip;
            const uint32_t mask =
                bit_width == 32 ? 0xffffffffu : ((1u << bit_width) - 1);
            // values whose 8-byte window lies inside the stream take one
            // unaligned little-endian load each (a value spans at most 5
            // bytes); the last few are assembled byte by byte
            const int64_t in_rest = in_len - ip;
            int64_t fast = take;
            while (fast > 0 && ((fast - 1) * bit_width >> 3) + 8 > in_rest)
                --fast;
            for (int64_t i = 0; i < fast; ++i) {
                int64_t bit = i * bit_width;
                uint64_t w;
                std::memcpy(&w, p + (bit >> 3), 8);
                out[op + i] = static_cast<uint32_t>(w >> (bit & 7)) & mask;
            }
            for (int64_t i = fast; i < take; ++i) {
                int64_t bit = i * bit_width;
                int64_t byte = bit >> 3;
                int rem = static_cast<int>(bit & 7);
                uint64_t w = 0;
                int64_t avail = nbytes - byte;
                int need = (rem + bit_width + 7) / 8;
                for (int j = 0; j < need && j < avail; ++j)
                    w |= static_cast<uint64_t>(p[byte + j]) << (8 * j);
                out[op + i] = static_cast<uint32_t>(w >> rem) & mask;
            }
            ip += nbytes;
            op += take;
        } else {  // repeated run
            int64_t count = static_cast<int64_t>(h >> 1);
            if (count < 0 || ip + byte_w > in_len) return -1;
            uint32_t v = 0;
            for (int j = 0; j < byte_w; ++j)
                v |= static_cast<uint32_t>(in[ip + j]) << (8 * j);
            ip += byte_w;
            int64_t take = count < n - op ? count : n - op;
            for (int64_t i = 0; i < take; ++i) out[op + i] = v;
            op += take;
        }
    }
    return 0;
}

// ---------------------------------------------------------------- //
// Parquet page headers (parquet.thrift PageHeader, thrift compact
// protocol).  io/fastpar.py's _parse_page_header is the plain version.
// ---------------------------------------------------------------- //

namespace {

struct Reader {
    const uint8_t* buf;
    int64_t len;
    int64_t pos;
    bool bad;

    int byte() {
        if (pos >= len) { bad = true; return 0; }
        return buf[pos++];
    }
    uint64_t varint() {
        uint64_t out = 0;
        for (int shift = 0; shift < 64; shift += 7) {
            int b = byte();
            if (bad) return 0;
            out |= static_cast<uint64_t>(b & 0x7f) << shift;
            if (!(b & 0x80)) return out;
        }
        bad = true;
        return 0;
    }
    int64_t zigzag() {
        uint64_t v = varint();
        return static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
    }
    void skip(int ftype, int depth);
    // Walks one struct; records its integer and bool fields 1-15 into
    // vals[fid] (set[fid] = 1) and, one level down, the fields of its
    // struct fields into sub[fid * 16 + subfid] when sub is given.
    void fields(int64_t* vals, uint8_t* set, int64_t* sub, uint8_t* subset,
                int depth) {
        if (depth > 32) { bad = true; return; }
        int fid = 0;
        while (!bad) {
            int head = byte();
            if (bad || head == 0) return;
            int delta = head >> 4, ftype = head & 0x0f;
            fid = delta ? fid + delta : static_cast<int>(zigzag());
            bool keep = vals != nullptr && fid >= 1 && fid <= 15;
            if (keep && (ftype == 4 || ftype == 5 || ftype == 6)) {
                vals[fid] = zigzag();
                set[fid] = 1;
            } else if (keep && (ftype == 1 || ftype == 2)) {
                vals[fid] = ftype == 1;
                set[fid] = 1;
            } else if (keep && ftype == 12 && sub != nullptr) {
                fields(sub + fid * 16, subset + fid * 16, nullptr, nullptr,
                       depth + 1);
                set[fid] = 1;
            } else {
                skip(ftype, depth + 1);
            }
        }
    }
};

void Reader::skip(int ftype, int depth) {
    if (depth > 32) { bad = true; return; }
    switch (ftype) {
        case 1: case 2: return;
        case 3: pos += 1; return;
        case 4: case 5: case 6: varint(); return;
        case 7: pos += 8; return;
        case 8: { int64_t n = static_cast<int64_t>(varint());
                  if (n < 0 || n > len) { bad = true; return; }
                  pos += n; return; }
        case 9: case 10: {
            int head = byte();
            int64_t size = head >> 4;
            if (size == 15) size = static_cast<int64_t>(varint());
            // every element takes at least a byte: a longer list is bad
            if (size < 0 || size > len - pos) { bad = true; return; }
            int et = head & 0x0f;
            if (et == 1 || et == 2) {  // list bools are a byte each
                pos += size;
                return;
            }
            for (int64_t i = 0; i < size && !bad; ++i) skip(et, depth + 1);
            return;
        }
        case 12: fields(nullptr, nullptr, nullptr, nullptr, depth + 1);
                 return;
        default: bad = true;
    }
}

}  // namespace

// The page headers of one column chunk's bytes, from offset 0: for each
// page, PAGE_FIELDS int64s (fields absent from the header are -1):
//   0 page type, 1 offset of the payload, 2 compressed size,
//   3 uncompressed size,
//   4-7 data page v1: num_values, encoding, definition level encoding,
//       repetition level encoding,
//   8-9 dictionary page: num_values, encoding,
//   10-16 data page v2: num_values, num_nulls, num_rows, encoding,
//       definition levels byte length, repetition levels byte length,
//       is_compressed.
// Walks from offset `start` until the bytes end, max_pages pages are
// read or, once stop_values values of data pages are seen, stops.
// Returns the pages read, or -1 on a malformed header or a payload
// past the end.
int64_t parquet_page_headers(const uint8_t* seg, int64_t len, int64_t start,
                             int64_t stop_values, int64_t* out,
                             int64_t max_pages) {
    const int F = 17;
    int64_t pos = start, n = 0, seen = 0;
    while (pos < len && n < max_pages && seen < stop_values) {
        int64_t vals[16], sub[256];
        uint8_t set[16] = {0}, subset[256] = {0};
        Reader r{seg, len, pos, false};
        r.fields(vals, set, sub, subset, 0);
        if (r.bad) return -1;
        auto top = [&](int f) { return set[f] ? vals[f] : -1; };
        auto in = [&](int s, int f) {
            return set[s] && subset[s * 16 + f] ? sub[s * 16 + f] : -1;
        };
        int64_t* rec = out + n * F;
        rec[0] = top(1);
        rec[1] = r.pos;
        rec[2] = top(3);
        rec[3] = top(2);
        for (int f = 1; f <= 4; ++f) rec[3 + f] = in(5, f);
        rec[8] = in(7, 1);
        rec[9] = in(7, 2);
        for (int f = 1; f <= 7; ++f) rec[9 + f] = in(8, f);
        if (rec[2] < 0 || r.pos + rec[2] > len) return -1;
        pos = r.pos + rec[2];
        if (rec[0] == 0 && rec[4] > 0) seen += rec[4];
        if (rec[0] == 3 && rec[10] > 0) seen += rec[10];
        ++n;
    }
    return n;
}

namespace {

// Whether an RLE/bit-packed level stream starts with one repeated run
// of at least n values equal to max_def: every row of the page valid.
bool levels_all_valid(const uint8_t* dl, int64_t len, int bit_width,
                      int64_t n, int64_t max_def) {
    if (n == 0) return true;
    uint64_t h = 0;
    int64_t pos = 0;
    for (int shift = 0;; shift += 7) {
        if (pos >= len || shift > 63) return false;
        uint8_t b = dl[pos++];
        h |= static_cast<uint64_t>(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
    }
    if ((h & 1) || static_cast<int64_t>(h >> 1) < n) return false;
    const int byte_w = (bit_width + 7) / 8;
    if (pos + byte_w > len) return false;
    int64_t v = 0;
    for (int j = 0; j < byte_w; ++j)
        v |= static_cast<int64_t>(dl[pos + j]) << (8 * j);
    return v == max_def;
}

// The payload of a page: the bytes themselves (codec 0) or its snappy
// block decoded into scratch (codec 1); nullptr when it does not decode.
const uint8_t* page_bytes(const uint8_t* in, int64_t in_len,
                          int64_t out_len, int codec, uint8_t* scratch) {
    if (codec == 0) return in_len >= out_len ? in : nullptr;
    int64_t pos = 0;
    uint64_t dec = 0;
    for (int shift = 0;; shift += 7) {
        if (pos >= in_len || shift > 63) return nullptr;
        uint8_t b = in[pos++];
        dec |= static_cast<uint64_t>(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
    }
    if (static_cast<int64_t>(dec) != out_len) return nullptr;
    if (snappy_raw_decompress(in + pos, in_len - pos, scratch, out_len) != 0)
        return nullptr;
    return scratch;
}

}  // namespace

// The data pages of a column chunk in one call, for a codec of 0 (none)
// or 1 (snappy): a dictionary-encoded page decodes its codes into
// codes[first value of the page ...], a PLAIN page of a fixed-width
// type (value_size > 0) copies its values into values[...]; a page with
// NULL rows decodes its definition levels (RLE) into valid[...] and
// scatters its present entries, leaving zeros in the NULL slots.
// `pages` holds n_pages records of parquet_page_headers; `scratch` at
// least the largest page's uncompressed size.  status[i] becomes 1 for
// a dictionary page decoded here, 2 for a PLAIN one, 0 for one left to
// the caller (the dictionary page, another encoding or level encoding,
// levels that do not decode) and -1 for a malformed one, where the walk
// stops.  Returns the values the data pages hold, or -1.
int64_t decode_pages(const uint8_t* seg, const int64_t* pages,
                     int64_t n_pages, int codec, int64_t max_def,
                     int64_t value_size, uint32_t* codes, uint8_t* values,
                     uint8_t* valid, int64_t n_total, uint8_t* scratch,
                     int8_t* status) {
    const int F = 17;
    const int def_bw = max_def > 0 ? 64 - __builtin_clzll(max_def) : 0;
    std::vector<uint32_t> levels, present;
    int64_t seen = 0;
    for (int64_t i = 0; i < n_pages; ++i) {
        const int64_t* r = pages + i * F;
        status[i] = 0;
        int64_t type = r[0], body = r[1], comp = r[2], uncomp = r[3];
        int64_t n_vals, enc;
        if (type == 0) {
            n_vals = r[4];
            enc = r[5] < 0 ? 0 : r[5];
        } else if (type == 3) {
            n_vals = r[10];
            enc = r[13] < 0 ? 0 : r[13];
        } else {
            continue;  // the dictionary page (or an index page)
        }
        if (n_vals < 0 || seen + n_vals > n_total) {
            status[i] = -1;
            return -1;
        }
        const int64_t lo = seen;
        seen += n_vals;
        const bool dict = enc == 2 || enc == 8;
        if (dict ? codes == nullptr
                 : !(enc == 0 && value_size > 0 && values != nullptr))
            continue;
        // the definition levels (nullptr: none) and the value stream
        const uint8_t* dl = nullptr;
        int64_t dl_len = 0;
        const uint8_t* vals;
        int64_t vals_len;
        if (type == 0) {
            if (max_def > 0 && r[6] >= 0 && r[6] != 3) continue;
            const uint8_t* buf = page_bytes(seg + body, comp, uncomp, codec,
                                            scratch);
            if (buf == nullptr) continue;
            int64_t off = 0;
            if (max_def > 0) {
                if (uncomp < 4) continue;
                int32_t len4;
                std::memcpy(&len4, buf, 4);
                if (len4 < 0 || 4 + static_cast<int64_t>(len4) > uncomp)
                    continue;
                dl = buf + 4;
                dl_len = len4;
                off = 4 + len4;
            }
            vals = buf + off;
            vals_len = uncomp - off;
        } else {
            int64_t n_nulls = r[11] < 0 ? 0 : r[11];
            int64_t lv_len = r[14] < 0 ? 0 : r[14];
            int64_t rl_len = r[15] < 0 ? 0 : r[15];
            if (rl_len || lv_len > comp) continue;
            if (max_def > 0 && lv_len) {
                dl = seg + body;
                dl_len = lv_len;
            } else if (n_nulls) {
                continue;  // NULLs without levels: the caller refuses it
            }
            bool compressed = r[16] != 0 && codec != 0;
            const uint8_t* buf = page_bytes(seg + body + lv_len,
                                            comp - lv_len, uncomp - lv_len,
                                            compressed ? codec : 0, scratch);
            if (buf == nullptr) continue;
            vals = buf;
            vals_len = uncomp - lv_len;
        }
        // validity: one run of max_def covers the page, or decode levels
        int64_t n_present = n_vals;
        bool nulls = false;
        if (dl != nullptr && !levels_all_valid(dl, dl_len, def_bw, n_vals,
                                               max_def)) {
            levels.resize(static_cast<size_t>(n_vals));
            if (rle_unpack_u32(dl, dl_len, def_bw, levels.data(), n_vals) != 0)
                continue;
            n_present = 0;
            for (int64_t j = 0; j < n_vals; ++j)
                n_present += levels[j] == static_cast<uint32_t>(max_def);
            nulls = n_present != n_vals;
        }
        if (dict) {
            if (vals_len < 1) continue;
            uint32_t* dst = codes + lo;
            if (!nulls) {
                if (rle_unpack_u32(vals + 1, vals_len - 1, vals[0], dst,
                                   n_vals) != 0)
                    continue;
            } else {
                present.resize(static_cast<size_t>(n_present));
                if (rle_unpack_u32(vals + 1, vals_len - 1, vals[0],
                                   present.data(), n_present) != 0)
                    continue;
                for (int64_t j = 0, k = 0; j < n_vals; ++j)
                    dst[j] = levels[j] == static_cast<uint32_t>(max_def)
                        ? present[k++] : 0;
            }
            status[i] = 1;
        } else {
            if (vals_len < n_present * value_size) continue;
            uint8_t* dst = values + lo * value_size;
            if (!nulls) {
                std::memcpy(dst, vals, static_cast<size_t>(n_vals * value_size));
            } else {
                for (int64_t j = 0, k = 0; j < n_vals; ++j, dst += value_size) {
                    if (levels[j] == static_cast<uint32_t>(max_def)) {
                        std::memcpy(dst, vals + k * value_size,
                                    static_cast<size_t>(value_size));
                        ++k;
                    } else {
                        std::memset(dst, 0, static_cast<size_t>(value_size));
                    }
                }
            }
            status[i] = 2;
        }
        if (nulls) {
            for (int64_t j = 0; j < n_vals; ++j)
                valid[lo + j] = levels[j] == static_cast<uint32_t>(max_def);
        } else {
            std::memset(valid + lo, 1, static_cast<size_t>(n_vals));
        }
    }
    return seen;
}

// A PLAIN BYTE_ARRAY stream (n values, each a 4-byte little-endian
// length and its bytes): offsets[0..n] (int32) and the values' bytes
// back to back in data (which holds at least len bytes).  Returns the
// bytes written, or -1 when the stream is short, a length negative or
// the total past 2^31 - 1.
int64_t byte_array_plain(const uint8_t* in, int64_t len, int64_t n,
                         int32_t* offsets, uint8_t* data) {
    int64_t pos = 0, total = 0;
    offsets[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (pos + 4 > len) return -1;
        int32_t ln;
        std::memcpy(&ln, in + pos, 4);
        pos += 4;
        if (ln < 0 || pos + ln > len || total + ln > 2147483647LL)
            return -1;
        std::memcpy(data + total, in + pos, static_cast<size_t>(ln));
        pos += ln;
        total += ln;
        offsets[i + 1] = static_cast<int32_t>(total);
    }
    return total;
}

// out[i] = dict[codes[i]] for n codes into a dictionary of n_dict
// values of `width` bytes (1, 2, 4 or 8), a code outside [0, n_dict)
// clipped into it (a NULL row's slot, zeroed by the caller).  The
// upload's gather of a dictionary-encoded fixed-width column
// (columnar/arrow.py).  Returns 0, or -1 for another width or an empty
// dictionary.
int gather_codes(const uint8_t* dict, int64_t n_dict, int64_t width,
                 const int32_t* codes, int64_t n, uint8_t* out) {
    if (n_dict <= 0) return -1;
    const int64_t hi = n_dict - 1;
    auto at = [&](int64_t i) {
        int64_t c = codes[i];
        return c < 0 ? 0 : (c > hi ? hi : c);
    };
    switch (width) {
        case 1: for (int64_t i = 0; i < n; ++i) out[i] = dict[at(i)];
                return 0;
        case 2: { auto* o = reinterpret_cast<uint16_t*>(out);
                  auto* d = reinterpret_cast<const uint16_t*>(dict);
                  for (int64_t i = 0; i < n; ++i) o[i] = d[at(i)];
                  return 0; }
        case 4: { auto* o = reinterpret_cast<uint32_t*>(out);
                  auto* d = reinterpret_cast<const uint32_t*>(dict);
                  for (int64_t i = 0; i < n; ++i) o[i] = d[at(i)];
                  return 0; }
        case 8: { auto* o = reinterpret_cast<uint64_t*>(out);
                  auto* d = reinterpret_cast<const uint64_t*>(dict);
                  for (int64_t i = 0; i < n; ++i) o[i] = d[at(i)];
                  return 0; }
        default: return -1;
    }
}

// ---------------------------------------------------------------- //
// The wire encoder's host passes (columnar/transfer.py), copies of
// the JAX package's native/hostcodec.cpp: each one pass, no numpy
// temporaries.  The numpy forms stay beside them in transfer.py.
// ---------------------------------------------------------------- //

// ragged bytes -> zero-padded fixed-width matrix.  offsets has n+1
// entries into raw; lens[i] <= w must hold (the caller clamps); out is
// n*w bytes, zeroed by the caller.
void chars_fill(const uint8_t* raw, const int64_t* offsets,
                const int32_t* lens, int64_t n, int64_t w,
                uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t len = lens[i];
        if (len > 0) {
            std::memcpy(out + i * w, raw + offsets[i],
                        static_cast<size_t>(len));
        }
    }
}

void minmax_i64(const int64_t* v, int64_t n, int64_t* out_min,
                int64_t* out_max) {
    int64_t mn = v[0], mx = v[0];
    for (int64_t i = 1; i < n; ++i) {
        int64_t x = v[i];
        if (x < mn) mn = x;
        if (x > mx) mx = x;
    }
    *out_min = mn;
    *out_max = mx;
}

void minmax_i32(const int32_t* v, int64_t n, int64_t* out_min,
                int64_t* out_max) {
    int32_t mn = v[0], mx = v[0];
    for (int64_t i = 1; i < n; ++i) {
        int32_t x = v[i];
        if (x < mn) mn = x;
        if (x > mx) mx = x;
    }
    *out_min = mn;
    *out_max = mx;
}

void bias_encode8_i64(const int64_t* v, int64_t n, int64_t base,
                      uint8_t* out) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = static_cast<uint8_t>(v[i] - base);
}

void bias_encode16_i64(const int64_t* v, int64_t n, int64_t base,
                       uint16_t* out) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = static_cast<uint16_t>(v[i] - base);
}

void bias_encode8_i32(const int32_t* v, int64_t n, int64_t base,
                      uint8_t* out) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = static_cast<uint8_t>(static_cast<int64_t>(v[i]) - base);
}

void bias_encode16_i32(const int32_t* v, int64_t n, int64_t base,
                       uint16_t* out) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = static_cast<uint16_t>(static_cast<int64_t>(v[i]) - base);
}

// 2-decimal money check+encode: out[i] = (int32) round(v[i] * 100)
// when EVERY value reconstructs bit-exactly as out[i] / 100.0 (a true
// IEEE division, as the device decode does it).  Returns 1 on success,
// 0 (out undefined) otherwise.
int scaled_check_encode(const double* v, int64_t n, int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        double x = v[i];
        if (!std::isfinite(x)) return 0;
        double s = std::nearbyint(x * 100.0);
        if (s < -2147483648.0 || s > 2147483647.0) return 0;
        int32_t c = static_cast<int32_t>(s);
        double r = static_cast<double>(c) / 100.0;
        // bit comparison: catches -0.0 vs 0.0 and every rounding case
        uint64_t rb, xb;
        std::memcpy(&rb, &r, 8);
        std::memcpy(&xb, &x, 8);
        if (rb != xb) return 0;
        out[i] = c;
    }
    return 1;
}

}  // extern "C"
