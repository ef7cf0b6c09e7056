// Native host-side container codecs (the data-loader hot path).
//
// The reference implements its container parsing in C++ (DirectXTexTGA.cpp
// RLE decode :1690, DirectXTexHDR.cpp scanline codecs :413/:755); these are
// the TPU-VM equivalents, exposed through a C ABI for ctypes. Pixel math
// stays on the device — this is pure byte-stream work that Python loops
// would serialize.
//
// Build: g++ -O2 -shared -fPIC rle_codec.cpp -o librle_codec.so

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// Decode a TGA RLE stream into `count` pixels of `bytes_pp` bytes.
// Returns bytes consumed from src, or -1 on truncation/overflow.
long long tga_rle_decode(const uint8_t* src, long long src_len,
                         uint8_t* dst, long long count, int bytes_pp)
{
    long long si = 0;
    long long di = 0;
    const long long total = count * bytes_pp;
    while (di < total) {
        if (si >= src_len) return -1;
        const int hdr = src[si++];
        const int run = (hdr & 0x7F) + 1;
        if (hdr & 0x80) {
            if (si + bytes_pp > src_len) return -1;
            const uint8_t* px = src + si;
            si += bytes_pp;
            long long end = di + (long long)run * bytes_pp;
            if (end > total) end = total;
            for (; di < end; di += bytes_pp)
                memcpy(dst + di, px, (size_t)bytes_pp);
        } else {
            const long long nbytes = (long long)run * bytes_pp;
            if (si + nbytes > src_len) return -1;
            long long take = nbytes;
            if (di + take > total) take = total - di;
            memcpy(dst + di, src + si, (size_t)take);
            si += nbytes;
            di += take;
        }
    }
    return si;
}

// Decode Radiance HDR scanlines (adaptive new-style RLE + old-style runs)
// into [height][width][4] RGBE bytes. Returns 0 on success, -1 on error.
// Mirrors the semantics of DirectXTexHDR.cpp:755-885.
int hdr_decode_scanlines(const uint8_t* src, long long src_len,
                         long long offset, int width, int height,
                         uint8_t* dst)
{
    long long pos = offset;
    for (int y = 0; y < height; ++y) {
        if (pos + 4 > src_len) return -1;
        uint8_t* row = dst + (long long)y * width * 4;
        const uint8_t c0 = src[pos], c1 = src[pos + 1],
                      c2 = src[pos + 2], c3 = src[pos + 3];
        if (c0 == 2 && c1 == 2 && c2 < 128) {
            if (((int(c2) << 8) | c3) != width) return -1;
            pos += 4;
            for (int ch = 0; ch < 4; ++ch) {
                int x = 0;
                while (x < width) {
                    if (pos + 2 > src_len) return -1;
                    int run = src[pos];
                    if (run > 128) {
                        run &= 127;
                        if (x + run > width) return -1;
                        const uint8_t v = src[pos + 1];
                        for (int j = 0; j < run; ++j)
                            row[(x + j) * 4 + ch] = v;
                        pos += 2;
                    } else {
                        if (pos + 1 + run > src_len || x + run > width)
                            return -1;
                        for (int j = 0; j < run; ++j)
                            row[(x + j) * 4 + ch] = src[pos + 1 + j];
                        pos += 1 + run;
                    }
                    x += run;
                }
            }
        } else {
            // flat scanline with optional old-style (1,1,1,count) runs
            int x = 0;
            uint8_t prev[4] = {0, 0, 0, 0};
            int bit_shift = 0;
            long long p = pos;
            while (x < width) {
                if (p + 4 > src_len) return -1;
                const uint8_t* px = src + p;
                p += 4;
                if (px[0] == 1 && px[1] == 1 && px[2] == 1) {
                    if (bit_shift > 24) return -1;
                    const long long span = (long long)px[3] << bit_shift;
                    if (x + span > width) return -1;
                    for (long long j = 0; j < span; ++j)
                        memcpy(row + (x + j) * 4, prev, 4);
                    x += (int)span;
                    bit_shift += 8;
                } else {
                    memcpy(row + x * 4, px, 4);
                    memcpy(prev, px, 4);
                    bit_shift = 0;
                    ++x;
                }
            }
            pos = p;
        }
    }
    return 0;
}

// Encode one scanline's channel with new-style RLE (runs >= 4 become repeat
// packets, literals up to 128). Returns bytes written (worst case ~2x n).
long long hdr_encode_rle_channel(const uint8_t* ch, int n, uint8_t* out)
{
    long long oi = 0;
    int i = 0;
    while (i < n) {
        int run = 1;
        while (i + run < n && run < 127 && ch[i + run] == ch[i]) ++run;
        if (run >= 4) {
            out[oi++] = (uint8_t)(0x80 | run);
            out[oi++] = ch[i];
            i += run;
        } else {
            const int start = i;
            i += run;
            while (i < n && (i - start) < 128) {
                run = 1;
                while (i + run < n && run < 127 && ch[i + run] == ch[i]) ++run;
                if (run >= 4) break;
                i += run;
            }
            int cnt = i - start;
            if (cnt > 128) cnt = 128;
            i = start + cnt;
            out[oi++] = (uint8_t)cnt;
            memcpy(out + oi, ch + start, (size_t)cnt);
            oi += cnt;
        }
    }
    return oi;
}

}  // extern "C"
