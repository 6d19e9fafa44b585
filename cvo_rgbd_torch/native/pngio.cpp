// cvo_rgbd_torch's copy of the JAX package's native/pngio.cpp; only
// this header comment differs.
//
// Minimal PNG decoder for the TUM RGB-D frame formats.
//
// Native-runtime analog of the reference's cv::imread frame loading
// (cvo_main.cpp:104-107): 8-bit RGB/RGBA color images and 16-bit
// grayscale depth images, non-interlaced, zlib-compressed — which is
// exactly what the TUM benchmark ships.  ~300 lines instead of an
// OpenCV dependency.

#include <zlib.h>

#include <cstdlib>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Reader {
    const uint8_t* p;
    size_t n;
    size_t off = 0;

    bool read(void* dst, size_t k) {
        if (off + k > n) return false;
        memcpy(dst, p + off, k);
        off += k;
        return true;
    }
    uint32_t be32() {
        uint8_t b[4];
        if (!read(b, 4)) return 0;
        return (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
               (uint32_t(b[2]) << 8) | uint32_t(b[3]);
    }
};

int paeth(int a, int b, int c) {
    int pp = a + b - c;
    int pa = abs(pp - a), pb = abs(pp - b), pc = abs(pp - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

bool inflate_all(const std::vector<uint8_t>& src, std::vector<uint8_t>& dst) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return false;
    zs.next_in = const_cast<Bytef*>(src.data());
    zs.avail_in = static_cast<uInt>(src.size());
    zs.next_out = dst.data();
    zs.avail_out = static_cast<uInt>(dst.size());
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return rc == Z_STREAM_END || (rc == Z_OK && zs.avail_out == 0);
}

}  // namespace

extern "C" {

// Parse header only: returns 0 on success and fills w, h, channels,
// bit_depth.
int png_probe(const uint8_t* data, size_t size, int* w, int* h,
              int* channels, int* bit_depth) {
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (size < 33 || memcmp(data, sig, 8) != 0) return -1;
    Reader r{data, size, 8};
    uint32_t len = r.be32();
    char type[5] = {0};
    r.read(type, 4);
    if (len != 13 || strcmp(type, "IHDR") != 0) return -2;
    *w = static_cast<int>(r.be32());
    *h = static_cast<int>(r.be32());
    uint8_t depth, color;
    r.read(&depth, 1);
    r.read(&color, 1);
    *bit_depth = depth;
    switch (color) {
        case 0: *channels = 1; break;
        case 2: *channels = 3; break;
        case 4: *channels = 2; break;
        case 6: *channels = 4; break;
        default: return -3;  // palette unsupported
    }
    return 0;
}

// Decode into out (row-major, native uint8 for 8-bit / uint16 for
// 16-bit samples, all channels).  out must hold w*h*channels samples.
// Returns 0 on success.
int png_decode(const uint8_t* data, size_t size, void* out) {
    int w, h, ch, depth;
    int rc = png_probe(data, size, &w, &h, &ch, &depth);
    if (rc != 0) return rc;
    if (depth != 8 && depth != 16) return -4;

    Reader r{data, size, 8};
    std::vector<uint8_t> idat;
    bool interlaced = false;
    while (r.off + 12 <= r.n) {
        uint32_t len = r.be32();
        char type[5] = {0};
        r.read(type, 4);
        if (strcmp(type, "IHDR") == 0) {
            size_t body = r.off;
            interlaced = data[body + 12] != 0;
        }
        if (strcmp(type, "IDAT") == 0) {
            size_t old = idat.size();
            idat.resize(old + len);
            memcpy(idat.data() + old, data + r.off, len);
        }
        if (strcmp(type, "IEND") == 0) break;
        r.off += len + 4;  // body + crc
    }
    if (interlaced) return -5;
    if (idat.empty()) return -6;

    int bytes_per_sample = depth / 8;
    int bpp = ch * bytes_per_sample;          // filter unit
    size_t stride = static_cast<size_t>(w) * bpp;
    std::vector<uint8_t> raw((stride + 1) * h);
    if (!inflate_all(idat, raw)) return -7;

    std::vector<uint8_t> prev(stride, 0);
    uint8_t* o8 = static_cast<uint8_t*>(out);
    uint16_t* o16 = static_cast<uint16_t*>(out);

    std::vector<uint8_t> line(stride);
    for (int y = 0; y < h; ++y) {
        const uint8_t* src = raw.data() + static_cast<size_t>(y) * (stride + 1);
        uint8_t filter = src[0];
        const uint8_t* s = src + 1;
        for (size_t i = 0; i < stride; ++i) {
            int a = (i >= static_cast<size_t>(bpp)) ? line[i - bpp] : 0;
            int b = prev[i];
            int c = (i >= static_cast<size_t>(bpp)) ? prev[i - bpp] : 0;
            int x = s[i];
            switch (filter) {
                case 0: break;
                case 1: x += a; break;
                case 2: x += b; break;
                case 3: x += (a + b) / 2; break;
                case 4: x += paeth(a, b, c); break;
                default: return -8;
            }
            line[i] = static_cast<uint8_t>(x);
        }
        prev = line;
        if (depth == 8) {
            memcpy(o8 + static_cast<size_t>(y) * w * ch, line.data(), stride);
        } else {
            // 16-bit PNG samples are big-endian
            uint16_t* dst = o16 + static_cast<size_t>(y) * w * ch;
            for (int i = 0; i < w * ch; ++i) {
                dst[i] = static_cast<uint16_t>((line[2 * i] << 8) | line[2 * i + 1]);
            }
        }
    }
    return 0;
}

}  // extern "C"
