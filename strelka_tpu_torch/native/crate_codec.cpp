// Native codecs for USD crate (.usdc) ingestion — LZ4 block decode and
// pxr Usd_IntegerCompression delta+bytecode decode.
//
// The reference opens crate stages through pxr (hdRunner/main.cpp:566-591),
// whose C++ decompressors run at GB/s; the pure-Python fallback in
// loaders/lz4.py runs at ~MB/s, which matters for production-size stages.
// C ABI only (no pybind11 in the image) — loaded via ctypes with the Python
// implementation as fallback (see loaders/crate.py / loaders/lz4.py).

#include <cstdint>
#include <cstring>

extern "C" {

// Decode one raw LZ4 block. Returns bytes written, or -1 on malformed input.
int64_t strelka_lz4_decompress(const uint8_t* src, int64_t src_len,
                               uint8_t* dst, int64_t dst_cap) {
    int64_t i = 0, o = 0;
    while (i < src_len) {
        uint8_t token = src[i++];
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (i >= src_len) return -1;
                b = src[i++];
                lit += b;
            } while (b == 255);
        }
        if (i + lit > src_len || o + lit > dst_cap) return -1;
        std::memcpy(dst + o, src + i, lit);
        i += lit;
        o += lit;
        if (i >= src_len) break;  // last sequence: literals only
        if (i + 2 > src_len) return -1;
        int64_t offset = src[i] | (int64_t(src[i + 1]) << 8);
        i += 2;
        if (offset == 0 || offset > o) return -1;
        int64_t ml = (token & 0xF) + 4;
        if ((token & 0xF) == 15) {
            uint8_t b;
            do {
                if (i >= src_len) return -1;
                b = src[i++];
                ml += b;
            } while (b == 255);
        }
        if (o + ml > dst_cap) return -1;
        const uint8_t* m = dst + o - offset;
        if (offset >= ml) {
            std::memcpy(dst + o, m, ml);
        } else {
            for (int64_t k = 0; k < ml; ++k) dst[o + k] = m[k];  // overlapping
        }
        o += ml;
    }
    return o;
}

// pxr Usd_IntegerCompression inner decode (post-LZ4): n delta-coded ints.
// wide=0 -> int32 stream/output; wide=1 -> int64. Returns 0 ok, -1 error.
int64_t strelka_int_decode(const uint8_t* buf, int64_t buf_len, int64_t n,
                           int wide, void* out) {
    int64_t common_size = wide ? 8 : 4;
    int64_t codes_off = common_size;
    int64_t n_code_bytes = (n * 2 + 7) / 8;
    int64_t pos = codes_off + n_code_bytes;
    if (buf_len < pos) return -1;
    int64_t common;
    if (wide) {
        int64_t c;
        std::memcpy(&c, buf, 8);
        common = c;
    } else {
        int32_t c;
        std::memcpy(&c, buf, 4);
        common = c;
    }
    int64_t prev = 0;
    for (int64_t idx = 0; idx < n; ++idx) {
        int code = (buf[codes_off + (idx >> 2)] >> ((idx & 3) * 2)) & 3;
        int64_t delta;
        // pxr per-code widths: 32-bit codec int8/int16/int32 for codes
        // 1/2/3; the 64-bit codec (Usd_IntegerCompression64) shifts one
        // size up, int16/int32/int64.
        switch (code) {
            case 0: delta = common; break;
            case 1: {
                if (wide) {
                    if (pos + 2 > buf_len) return -1;
                    int16_t d;
                    std::memcpy(&d, buf + pos, 2);
                    delta = d;
                    pos += 2;
                } else {
                    if (pos + 1 > buf_len) return -1;
                    delta = (int8_t)buf[pos];
                    pos += 1;
                }
                break;
            }
            case 2: {
                if (wide) {
                    if (pos + 4 > buf_len) return -1;
                    int32_t d;
                    std::memcpy(&d, buf + pos, 4);
                    delta = d;
                    pos += 4;
                } else {
                    if (pos + 2 > buf_len) return -1;
                    int16_t d;
                    std::memcpy(&d, buf + pos, 2);
                    delta = d;
                    pos += 2;
                }
                break;
            }
            default: {
                if (wide) {
                    if (pos + 8 > buf_len) return -1;
                    int64_t d;
                    std::memcpy(&d, buf + pos, 8);
                    delta = d;
                    pos += 8;
                } else {
                    if (pos + 4 > buf_len) return -1;
                    int32_t d;
                    std::memcpy(&d, buf + pos, 4);
                    delta = d;
                    pos += 4;
                }
            }
        }
        if (wide) {
            prev = (int64_t)((uint64_t)prev + (uint64_t)delta);
            ((int64_t*)out)[idx] = prev;
        } else {
            prev = (int32_t)((uint32_t)prev + (uint32_t)delta);
            ((int32_t*)out)[idx] = (int32_t)prev;
        }
    }
    return 0;
}

}  // extern "C"
