// Native point-cloud parsing — the host-side ingest hot path.
//
// The reference parses point files with per-line Python loops
// (utils/data_processing.py:68-76, core/data_loader.py) — minutes for a
// 10M-point scan. This translation unit provides a C-ABI parser used via
// ctypes (no pybind11 in the image): whitespace/comma/semicolon-separated
// text with garbage-line skipping, and LAS 1.x binary records.
//
// Build: g++ -O3 -march=native -shared -fPIC loader.cpp -o libloader.so
// (done automatically by utils/native.py, cached per source hash).

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <cstdlib>
#include <cmath>

extern "C" {

// Fast float parse: strtod is locale-dependent and slow-ish but correct;
// we use a hand-rolled parser for the common fixed-notation case and fall
// back to strtod for exponents/specials.
static inline const char* parse_double(const char* p, const char* end,
                                       double* out, bool* ok) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == ',' || *p == ';'
                       || *p == '\r')) p++;
    if (p >= end) { *ok = false; return p; }
    const char* start = p;
    bool neg = false;
    if (*p == '-' || *p == '+') { neg = (*p == '-'); p++; }
    double v = 0.0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10.0 + (*p - '0');
        p++; any = true;
    }
    if (p < end && *p == '.') {
        p++;
        double f = 0.1;
        while (p < end && *p >= '0' && *p <= '9') {
            v += (*p - '0') * f;
            f *= 0.1;
            p++; any = true;
        }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        // exponent: delegate to strtod from the token start for accuracy
        char buf[64];
        size_t n = 0;
        const char* q = start;
        while (q < end && n < 63 &&
               (*q == '-' || *q == '+' || *q == '.' || *q == 'e' ||
                *q == 'E' || (*q >= '0' && *q <= '9'))) {
            buf[n++] = *q++;
        }
        buf[n] = 0;
        char* endp = nullptr;
        v = strtod(buf, &endp);
        if (endp == buf) { *ok = false; return p; }
        *out = v;
        *ok = true;
        return start + (endp - buf);
    }
    if (!any) { *ok = false; return p; }
    *out = neg ? -v : v;
    *ok = true;
    return p;
}

// Parse text rows of >=3 numbers into out[n*3]; returns rows parsed.
// Lines that fail to yield 3 numbers are skipped (reference semantics:
// app_simplified.py:44-56). Comment lines (#, //) are skipped.
size_t parse_xyz_text(const char* data, size_t len, double* out,
                      size_t max_points) {
    const char* p = data;
    const char* end = data + len;
    size_t n = 0;
    while (p < end && n < max_points) {
        // find line bounds
        const char* line_end = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!line_end) line_end = end;
        const char* q = p;
        while (q < line_end && (*q == ' ' || *q == '\t')) q++;
        if (q < line_end && *q != '#' &&
            !(q + 1 < line_end && q[0] == '/' && q[1] == '/')) {
            double x, y, z;
            bool ok1, ok2, ok3;
            q = parse_double(q, line_end, &x, &ok1);
            q = parse_double(q, line_end, &y, &ok2);
            q = parse_double(q, line_end, &z, &ok3);
            if (ok1 && ok2 && ok3) {
                out[n * 3 + 0] = x;
                out[n * 3 + 1] = y;
                out[n * 3 + 2] = z;
                n++;
            }
        }
        p = line_end + 1;
    }
    return n;
}

// LAS 1.x: extract scaled xyz from point records. Header fields are read
// by the caller (Python) and passed in; this hot loop just converts.
size_t parse_las_points(const uint8_t* data, size_t len,
                        size_t point_offset, size_t record_len,
                        size_t n_points, double sx, double sy, double sz,
                        double ox, double oy, double oz, double* out) {
    if (record_len < 12) return 0;
    size_t avail = (len > point_offset)
        ? (len - point_offset) / record_len : 0;
    if (n_points > avail) n_points = avail;
    const uint8_t* p = data + point_offset;
    for (size_t i = 0; i < n_points; i++) {
        int32_t xi, yi, zi;
        memcpy(&xi, p, 4);
        memcpy(&yi, p + 4, 4);
        memcpy(&zi, p + 8, 4);
        out[i * 3 + 0] = xi * sx + ox;
        out[i * 3 + 1] = yi * sy + oy;
        out[i * 3 + 2] = zi * sz + oz;
        p += record_len;
    }
    return n_points;
}

// LZF decompression (liblzf stream format) — PCL writes PCD
// DATA binary_compressed bodies with it. Format: control byte c < 32 =>
// literal run of c+1 bytes; else a back-reference of length (c >> 5) + 2
// (+ extension byte when the 3-bit length field saturates at 7) at
// distance (((c & 0x1f) << 8) | next_byte) + 1. Returns bytes written,
// or 0 on malformed input / output overflow.
size_t lzf_decompress(const uint8_t* in, size_t in_len, uint8_t* out,
                      size_t out_len) {
    size_t ip = 0, op = 0;
    while (ip < in_len) {
        uint32_t c = in[ip++];
        if (c < 32) {
            uint32_t run = c + 1;
            if (ip + run > in_len || op + run > out_len) return 0;
            memcpy(out + op, in + ip, run);
            ip += run;
            op += run;
        } else {
            uint32_t len = c >> 5;
            if (len == 7) {
                if (ip >= in_len) return 0;
                len += in[ip++];
            }
            if (ip >= in_len) return 0;
            size_t dist = ((c & 0x1fu) << 8 | in[ip++]) + 1;
            if (dist > op) return 0;
            size_t ref = op - dist;
            len += 2;
            if (op + len > out_len) return 0;
            for (uint32_t i = 0; i < len; i++)  // overlapping copies OK
                out[op + i] = out[ref + i];
            op += len;
        }
    }
    return op;
}

// Count newline-terminated lines (upper bound for text allocation).
size_t count_lines(const char* data, size_t len) {
    size_t n = 0;
    const char* p = data;
    const char* end = data + len;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!nl) { n++; break; }
        n++;
        p = nl + 1;
    }
    return n;
}

}  // extern "C"
