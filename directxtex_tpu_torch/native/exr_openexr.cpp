// Optional OpenEXR adapter shim.
//
// The reference's EXR support is an adapter over the official OpenEXR
// library (Auxiliary/DirectXTexEXR.cpp:112-183 LoadFromEXRFile via
// RgbaInputFile; :320+ SaveToEXRFile via RgbaOutputFile, both as half
// RGBA). This shim exposes the same RgbaInputFile/RgbaOutputFile
// round-trip through a C ABI so io/exr.py can (a) decode compressions
// the pure-numpy reader does not implement (DWAA/DWAB), and (b) pin the
// pure reader/writer against the official implementation in tests.
//
// Compiled on demand by native/__init__.py when libOpenEXR dev headers
// are present; everything degrades gracefully without it.

#include <ImfRgbaFile.h>
#include <ImfHeader.h>
#include <ImfIO.h>
#include <ImfFloatAttribute.h>
#include <ImathBox.h>

#include <cstdint>
#include <cstring>
#include <string>

using namespace OPENEXR_IMF_NAMESPACE;
using IMATH_NAMESPACE::Box2i;

namespace {

class MemIn : public IStream {
public:
    MemIn(const char *data, uint64_t size)
        : IStream("<memory>"), d_(data), n_(size), p_(0) {}
    bool read(char c[], int n) override {
        if (p_ + static_cast<uint64_t>(n) > n_)
            throw IEX_NAMESPACE::InputExc("EXR: unexpected end of input");
        std::memcpy(c, d_ + p_, n);
        p_ += n;
        return p_ < n_;
    }
    uint64_t tellg() override { return p_; }
    void seekg(uint64_t pos) override { p_ = pos; }

private:
    const char *d_;
    uint64_t n_, p_;
};

class MemOut : public OStream {
public:
    MemOut() : OStream("<memory>"), p_(0) {}
    void write(const char c[], int n) override {
        if (p_ + n > buf.size())
            buf.resize(p_ + n);
        std::memcpy(&buf[p_], c, n);
        p_ += n;
    }
    uint64_t tellp() override { return p_; }
    void seekp(uint64_t pos) override { p_ = pos; }

    std::string buf;

private:
    uint64_t p_;
};

}  // namespace

extern "C" {

// Dims of an EXR byte stream; 0 on success.
int exr_openexr_read_dims(const char *data, long long size, int *w, int *h) {
    try {
        MemIn in(data, static_cast<uint64_t>(size));
        RgbaInputFile f(in);
        Box2i dw = f.dataWindow();
        *w = dw.max.x - dw.min.x + 1;
        *h = dw.max.y - dw.min.y + 1;
        return 0;
    } catch (...) {
        return -1;
    }
}

// Decode to tightly packed half RGBA rows ([h][w][4] uint16 half bits),
// the same surface DirectXTexEXR.cpp produces; 0 on success.
int exr_openexr_read_half(const char *data, long long size,
                          unsigned short *out) {
    try {
        MemIn in(data, static_cast<uint64_t>(size));
        RgbaInputFile f(in);
        Box2i dw = f.dataWindow();
        long long w = dw.max.x - dw.min.x + 1;
        Rgba *base = reinterpret_cast<Rgba *>(out)
            - dw.min.x - static_cast<long long>(dw.min.y) * w;
        f.setFrameBuffer(base, 1, static_cast<size_t>(w));
        f.readPixels(dw.min.y, dw.max.y);
        return 0;
    } catch (...) {
        return -1;
    }
}

// Encode half RGBA rows with the given Imf::Compression id. Returns the
// byte size written into out (capacity cap), -needed if cap is too
// small, or 0 on error. dwa_level > 0 sets dwaCompressionLevel.
long long exr_openexr_write_half(const unsigned short *rgba, int w, int h,
                                 int compression, float dwa_level,
                                 char *out, long long cap) {
    try {
        MemOut os;
        Header hdr(w, h);
        hdr.compression() = static_cast<Compression>(compression);
        if (dwa_level > 0.0f)
            hdr.insert("dwaCompressionLevel", FloatAttribute(dwa_level));
        {
            RgbaOutputFile f(os, hdr, WRITE_RGBA);
            f.setFrameBuffer(reinterpret_cast<const Rgba *>(rgba), 1,
                             static_cast<size_t>(w));
            f.writePixels(h);
        }
        long long n = static_cast<long long>(os.buf.size());
        if (n > cap)
            return -n;
        std::memcpy(out, os.buf.data(), os.buf.size());
        return n;
    } catch (...) {
        return 0;
    }
}

}  // extern "C"
