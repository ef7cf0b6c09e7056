// Floyd-Steinberg error-diffusion dithering (host-side, inherently
// sequential). Mirrors StoreScanlineDither
// (DirectXTex/DirectXTexConvert.cpp:4049, STORE_SCANLINE macro :3887):
// serpentine traversal (odd rows right-to-left), per-pixel quantize to the
// per-channel scale, error distributed 7/16 to the next pixel (carried
// in-register), 3/16 below-left, 5/16 below, 1/16 below-right, with errors
// stored normalized. Output is the quantized value renormalized to [0,1]
// (or [-1,1]), so the regular pack() path stores it losslessly.
#include <cmath>
#include <cstring>
#include <vector>

extern "C" {

// img: H*W*4 float32, modified in place. scale: 4 floats (e.g. 255,255,255,255
// for 8888 UNORM; 31,63,31,1 for 565). clampzero: 1 for UNORM ([0,1] clamp),
// 0 for SNORM ([-1,1] clamp, floor at -scale+1).
void fs_dither(float* img, int h, int w, const float* scale, int clampzero)
{
    std::vector<float> err_prev((w + 2) * 4, 0.0f);
    std::vector<float> err_next((w + 2) * 4, 0.0f);

    for (int y = 0; y < h; ++y) {
        std::memset(err_next.data(), 0, err_next.size() * sizeof(float));
        const bool rtl = (y & 1) != 0;
        float verr[4] = {0, 0, 0, 0};

        for (int i = 0; i < w; ++i) {
            const int x = rtl ? (w - 1 - i) : i;
            float* px = img + (static_cast<long long>(y) * w + x) * 4;

            for (int c = 0; c < 4; ++c) {
                float v = px[c] + err_prev[(x + 1) * 4 + c];
                if (clampzero)
                    v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
                else
                    v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
                v += verr[c];
                const float vs = v * scale[c];
                const float target = nearbyintf(vs);
                const float e = (vs - target) / scale[c];

                // serpentine: below-left / below / below-right swap when RTL
                const int dl = rtl ? (x + 2) : x;
                const int dr = rtl ? x : (x + 2);
                err_next[dl * 4 + c] += e * (3.0f / 16.0f);
                err_next[(x + 1) * 4 + c] += e * (5.0f / 16.0f);
                err_next[dr * 4 + c] += e * (1.0f / 16.0f);
                verr[c] = e * (7.0f / 16.0f);

                const float lo = clampzero ? 0.0f : (-scale[c] + 1.0f);
                float t = target < lo ? lo : target;
                if (t > scale[c]) t = scale[c];
                px[c] = t / scale[c];
            }
        }
        err_prev.swap(err_next);
    }
}

}  // extern "C"
