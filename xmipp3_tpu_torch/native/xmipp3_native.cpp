// xmipp3_native: the native IO runtime of xmipp3_tpu_torch.
//
// Role: the equivalents of the reference's native IO layer (xmippCore
// Image<T> readers, BasicMemManager pinned buffers, ThreadTaskDistributor):
// a threaded particle-stack reader that fills a caller-provided buffer
// (numpy array) directly from MRC/MRCS or Spider stacks with format
// decoding, and a fast tokenizer for numeric STAR tables. Exposed as a C
// ABI consumed via ctypes (no pybind dependency), and the library that
// `xmipp_compile` links user programs against.
//
// Build: make -C xmipp3_tpu_torch/native   (g++ -O3 -shared -fPIC, into
// build/)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <string>
#include <thread>
#include <vector>
#include <atomic>

extern "C" {

// ---------------------------------------------------------------------------
// MRC
// ---------------------------------------------------------------------------

struct MrcHeader {
    int32_t nx, ny, nz, mode;
    int32_t mz;
    int32_t nsymbt;
    int32_t is_swapped;   // big-endian file on little-endian host
};

static void bswap32(void* p, size_t n_words) {
    auto* w = static_cast<uint32_t*>(p);
    for (size_t i = 0; i < n_words; ++i) {
        uint32_t v = w[i];
        w[i] = ((v & 0xFF) << 24) | ((v & 0xFF00) << 8) |
               ((v >> 8) & 0xFF00) | (v >> 24);
    }
}

// returns 0 on success
int mrc_read_header(const char* path, MrcHeader* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    int32_t h[56];
    if (std::fread(h, 4, 56, f) != 56) { std::fclose(f); return 2; }
    std::fclose(f);
    int swapped = 0;
    if (h[3] < 0 || h[3] > 101 || h[0] <= 0 || h[0] > (1 << 20)) {
        bswap32(h, 56);
        swapped = 1;
        if (h[3] < 0 || h[3] > 101 || h[0] <= 0) return 3;
    }
    out->nx = h[0]; out->ny = h[1]; out->nz = h[2]; out->mode = h[3];
    out->mz = h[9] > 0 ? h[9] : 1;
    out->nsymbt = h[23];
    out->is_swapped = swapped;
    return 0;
}

static size_t mode_size(int mode) {
    switch (mode) {
        case 0: return 1;     // int8
        case 1: return 2;     // int16
        case 2: return 4;     // float32
        case 6: return 2;     // uint16
        case 12: return 2;    // float16
        default: return 0;
    }
}

static float half_to_float(uint16_t h) {
    uint32_t sign = (h >> 15) & 1, exp = (h >> 10) & 0x1F, man = h & 0x3FF;
    uint32_t out;
    if (exp == 0) {
        if (man == 0) out = sign << 31;
        else {                      // subnormal
            exp = 127 - 15 + 1;
            while (!(man & 0x400)) { man <<= 1; --exp; }
            man &= 0x3FF;
            out = (sign << 31) | (exp << 23) | (man << 13);
        }
    } else if (exp == 31) {
        out = (sign << 31) | (0xFF << 23) | (man << 13);
    } else {
        out = (sign << 31) | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float fv;
    std::memcpy(&fv, &out, 4);
    return fv;
}

// Decode `count` samples of `mode` from src into float32 dst.
static void decode(const uint8_t* src, float* dst, size_t count, int mode,
                   int swapped) {
    switch (mode) {
        case 0: {
            auto* s = reinterpret_cast<const int8_t*>(src);
            for (size_t i = 0; i < count; ++i) dst[i] = float(s[i]);
            break;
        }
        case 1: {
            auto* s = reinterpret_cast<const int16_t*>(src);
            for (size_t i = 0; i < count; ++i) {
                int16_t v = s[i];
                if (swapped) v = int16_t((uint16_t(v) >> 8) | (uint16_t(v) << 8));
                dst[i] = float(v);
            }
            break;
        }
        case 6: {
            auto* s = reinterpret_cast<const uint16_t*>(src);
            for (size_t i = 0; i < count; ++i) {
                uint16_t v = s[i];
                if (swapped) v = uint16_t((v >> 8) | (v << 8));
                dst[i] = float(v);
            }
            break;
        }
        case 12: {
            auto* s = reinterpret_cast<const uint16_t*>(src);
            for (size_t i = 0; i < count; ++i) {
                uint16_t v = s[i];
                if (swapped) v = uint16_t((v >> 8) | (v << 8));
                dst[i] = half_to_float(v);
            }
            break;
        }
        case 2:
        default: {
            std::memcpy(dst, src, count * 4);
            if (swapped) bswap32(dst, count);
            break;
        }
    }
}

// Read selected slices (0-based indices) of an MRC stack into out
// (n_indices * ny * nx float32). Threaded over slices. Returns 0 on success.
int mrc_read_slices(const char* path, const int64_t* indices,
                    int64_t n_indices, float* out, int n_threads) {
    MrcHeader h;
    int rc = mrc_read_header(path, &h);
    if (rc) return rc;
    size_t ssz = mode_size(h.mode);
    if (!ssz) return 4;
    const size_t slice_vals = size_t(h.nx) * h.ny;
    const size_t slice_bytes = slice_vals * ssz;
    const size_t offset0 = 1024 + size_t(h.nsymbt);
    if (n_threads < 1) n_threads = 1;
    std::atomic<int64_t> next(0);
    std::atomic<int> err(0);

    auto worker = [&]() {
        FILE* f = std::fopen(path, "rb");
        if (!f) { err.store(1); return; }
        std::vector<uint8_t> buf(slice_bytes);
        for (;;) {
            int64_t k = next.fetch_add(1);
            if (k >= n_indices || err.load()) break;
            int64_t idx = indices[k];
            if (idx < 0 || idx >= h.nz) { err.store(5); break; }
            if (std::fseek(f, long(offset0 + size_t(idx) * slice_bytes),
                           SEEK_SET) != 0 ||
                std::fread(buf.data(), 1, slice_bytes, f) != slice_bytes) {
                err.store(6);
                break;
            }
            decode(buf.data(), out + size_t(k) * slice_vals, slice_vals,
                   h.mode, h.is_swapped);
        }
        std::fclose(f);
    };

    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return err.load();
}

// ---------------------------------------------------------------------------
// Spider stacks
// ---------------------------------------------------------------------------

int spider_read_header(const char* path, int64_t* dims /* n, z, y, x */,
                       int64_t* labbyt_out, int* swapped_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    float h[256];
    size_t got = std::fread(h, 4, 256, f);
    std::fclose(f);
    if (got < 24) return 2;
    int swapped = 0;
    auto check = [&](float* hh) {
        double nsam = hh[11], labrec = hh[12], labbyt = hh[21], lenbyt = hh[22];
        return nsam > 0 && nsam < (1 << 20) && lenbyt == nsam * 4 &&
               labbyt == labrec * lenbyt;
    };
    if (!check(h)) {
        bswap32(h, 256);
        swapped = 1;
        if (!check(h)) return 3;
    }
    int64_t nslice = int64_t(h[0]), nrow = int64_t(h[1]), nsam = int64_t(h[11]);
    int64_t istack = int64_t(h[23]), maxim = int64_t(h[25]);
    dims[0] = istack > 0 ? maxim : 1;
    dims[1] = nslice;
    dims[2] = nrow;
    dims[3] = nsam;
    *labbyt_out = int64_t(h[21]);
    *swapped_out = swapped;
    return 0;
}

int spider_read_slices(const char* path, const int64_t* indices,
                       int64_t n_indices, float* out, int n_threads) {
    int64_t dims[4];
    int64_t labbyt;
    int swapped;
    int rc = spider_read_header(path, dims, &labbyt, &swapped);
    if (rc) return rc;
    const size_t img_vals = size_t(dims[1]) * dims[2] * dims[3];
    const size_t img_bytes = img_vals * 4;
    // stack layout: overall header + per-image (header + data)
    const size_t per = size_t(labbyt) + img_bytes;
    if (n_threads < 1) n_threads = 1;
    std::atomic<int64_t> next(0);
    std::atomic<int> err(0);
    auto worker = [&]() {
        FILE* f = std::fopen(path, "rb");
        if (!f) { err.store(1); return; }
        for (;;) {
            int64_t k = next.fetch_add(1);
            if (k >= n_indices || err.load()) break;
            int64_t idx = indices[k];
            if (idx < 0 || idx >= dims[0]) { err.store(5); break; }
            size_t off = size_t(labbyt) + size_t(idx) * per + size_t(labbyt);
            float* dst = out + size_t(k) * img_vals;
            if (std::fseek(f, long(off), SEEK_SET) != 0 ||
                std::fread(dst, 4, img_vals, f) != img_vals) {
                err.store(6);
                break;
            }
            if (swapped) bswap32(dst, img_vals);
        }
        std::fclose(f);
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return err.load();
}

// ---------------------------------------------------------------------------
// Fast numeric STAR table parser
// ---------------------------------------------------------------------------
// Parses a loop_ block with purely numeric rows into a dense double matrix.
// Returns: 0 ok, >0 error, -1 block has non-numeric tokens (caller falls
// back to the Python parser). On entry *n_rows/*n_cols hold the buffer
// capacity; on exit the actual counts.

int star_parse_numeric(const char* path, const char* block,
                       char* labels_out, int64_t labels_cap,
                       double* values, int64_t* n_rows, int64_t* n_cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    std::string want = std::string("data_") + (block ? block : "");
    const bool first_block = want == "data_";
    char line[1 << 16];
    bool in_block = false, in_loop = false;
    std::vector<std::string> labels;
    int64_t row = 0;
    const int64_t cap_rows = *n_rows, cap_cols = *n_cols;
    while (std::fgets(line, sizeof(line), f)) {
        // trim leading space
        char* s = line;
        while (*s == ' ' || *s == '\t') ++s;
        size_t len = std::strlen(s);
        while (len && (s[len - 1] == '\n' || s[len - 1] == '\r' ||
                       s[len - 1] == ' ')) s[--len] = 0;
        if (!len || s[0] == '#') continue;
        if (std::strncmp(s, "data_", 5) == 0) {
            if (in_block) break;  // next block: done
            if (first_block || want == s) in_block = true;
            continue;
        }
        if (!in_block) continue;
        if (std::strcmp(s, "loop_") == 0) { in_loop = true; continue; }
        if (s[0] == '_') {
            if (!in_loop) { std::fclose(f); return -1; }  // row-format block
            char* sp = std::strchr(s, ' ');
            if (sp) *sp = 0;
            labels.push_back(s + 1);
            continue;
        }
        if (labels.empty()) continue;
        // numeric row parse
        if (int64_t(labels.size()) > cap_cols || row >= cap_rows) {
            std::fclose(f);
            return 2;   // capacity exceeded
        }
        char* p = s;
        for (size_t c = 0; c < labels.size(); ++c) {
            char* end = nullptr;
            double v = std::strtod(p, &end);
            if (end == p) { std::fclose(f); return -1; }  // non-numeric
            values[row * cap_cols + c] = v;
            p = end;
        }
        ++row;
    }
    std::fclose(f);
    if (labels.empty()) return 3;
    // serialize labels as '\n'-joined
    std::string joined;
    for (size_t i = 0; i < labels.size(); ++i) {
        if (i) joined += '\n';
        joined += labels[i];
    }
    if (int64_t(joined.size()) + 1 > labels_cap) return 4;
    std::memcpy(labels_out, joined.c_str(), joined.size() + 1);
    *n_rows = row;
    *n_cols = int64_t(labels.size());
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// TSAN self-test: build with -DXMIPP3_NATIVE_SELFTEST and
// -fsanitize=thread; exercises the threaded slice reader concurrently so
// the ThreadSanitizer can verify the work-stealing loop is race-free.
// ---------------------------------------------------------------------------
#ifdef XMIPP3_NATIVE_SELFTEST
#include <cstdio>
#include <cstdlib>

int main() {
    // write a tiny float32 MRC stack
    const int nx = 16, ny = 16, nz = 8;
    const char* path = "/tmp/xmipp3_native_tsan.mrc";
    {
        FILE* f = std::fopen(path, "wb");
        if (!f) return 1;
        int32_t hdr[256] = {0};
        hdr[0] = nx; hdr[1] = ny; hdr[2] = nz; hdr[3] = 2;  // mode 2
        hdr[52] = 0x2050414d;                                // "MAP "
        std::fwrite(hdr, 4, 256, f);
        std::vector<float> slice(nx * ny);
        for (int z = 0; z < nz; ++z) {
            for (int i = 0; i < nx * ny; ++i) slice[i] = float(z * 1000 + i);
            std::fwrite(slice.data(), 4, slice.size(), f);
        }
        std::fclose(f);
    }
    std::vector<int64_t> idx;
    for (int r = 0; r < 64; ++r) idx.push_back(r % nz);
    std::vector<float> out(idx.size() * nx * ny);
    int rc = mrc_read_slices(path, idx.data(), int64_t(idx.size()),
                             out.data(), 8);
    if (rc) { std::fprintf(stderr, "read rc=%d\n", rc); return rc; }
    for (size_t k = 0; k < idx.size(); ++k) {
        if (out[k * nx * ny] != float(idx[k] * 1000)) {
            std::fprintf(stderr, "value mismatch at %zu\n", k);
            return 10;
        }
    }
    std::printf("tsan selftest OK (%zu threaded reads)\n", idx.size());
    std::remove(path);
    return 0;
}
#endif
