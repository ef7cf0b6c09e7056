// BC7 shared device code: the mode table, the spec's partition tables,
// 128-bit block reads and writes, and the integer palette math that the
// decode (K1), search (K2, K7, K9) and refine (K3) kernels share.
//
// Layouts follow the JAX package's lane-major arrays, one CUDA thread per
// 4x4 block: texels are [64, NB] int32 (row = pixel * 4 + channel, values
// 0..255), packed blocks are [4, NB] u32 words (the 128 little-endian bits
// of a BC7 block). Neighbouring threads read neighbouring addresses of
// each row, so every row access is coalesced.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bc7 {

constexpr int kThreads = 128;   // threads per CUDA block; one per 4x4 block

// ---------------------------------------------------------------------------
// ms_aInfo (BC6HBC7.cpp:1106-1125) as constexpr functions of the mode
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int parts(int m) {          // subsets - 1
  return (m == 0 || m == 2) ? 2 : (m == 1 || m == 3 || m == 7) ? 1 : 0;
}
__host__ __device__ constexpr int partition_bits(int m) {
  return m == 0 ? 4 : parts(m) ? 6 : 0;
}
__host__ __device__ constexpr int p_bits(int m) {
  return m == 0 ? 6 : m == 1 ? 2 : m == 3 ? 4 : m == 6 ? 2 : m == 7 ? 4 : 0;
}
__host__ __device__ constexpr int rotation_bits(int m) {
  return (m == 4 || m == 5) ? 2 : 0;
}
__host__ __device__ constexpr int index_mode_bits(int m) {
  return m == 4 ? 1 : 0;
}
__host__ __device__ constexpr int index_prec(int m) {
  return (m == 0 || m == 1) ? 3 : m == 6 ? 4 : 2;
}
__host__ __device__ constexpr int index_prec2(int m) {
  return m == 4 ? 3 : m == 5 ? 2 : 0;
}
// endpoint precision without / with the p bit, per channel (r, g, b, a)
__host__ __device__ constexpr int prec(int m, int c) {
  return c < 3 ? (m == 0 ? 4 : m == 1 ? 6 : m == 2 ? 5 : m == 3 ? 7
                  : m == 4 ? 5 : m == 5 ? 7 : m == 6 ? 7 : 5)
               : (m == 4 ? 6 : m == 5 ? 8 : m == 6 ? 7 : m == 7 ? 5 : 0);
}
__host__ __device__ constexpr int prec_p(int m, int c) {
  return c < 3 ? (m == 0 ? 5 : m == 1 ? 7 : m == 2 ? 5 : m == 3 ? 8
                  : m == 4 ? 5 : m == 5 ? 7 : m == 6 ? 8 : 6)
               : (m == 4 ? 6 : m == 5 ? 8 : m == 6 ? 8 : m == 7 ? 6 : 0);
}
// one p bit per subset, shared by both endpoints (mode 1)
__host__ __device__ constexpr bool shared_p(int m) {
  return p_bits(m) > 0 && p_bits(m) == parts(m) + 1;
}

// ---------------------------------------------------------------------------
// Spec tables (bc67_tables.py PARTITIONS / FIXUPS, pinned equal by
// tests/test_torch_tables.py): per shape, the 16 subset ids at 2 bits per
// pixel (pixel i at bits 2i), and the anchor pixels of subsets 1 and 2 at
// 4 bits each (subset 1 in the low nibble).
// ---------------------------------------------------------------------------
static __constant__ uint32_t c_pp2[64] = {   // two subsets
    0x50505050u, 0x40404040u, 0x54545454u, 0x54505040u,
    0x50404000u, 0x55545450u, 0x55545040u, 0x54504000u,
    0x50400000u, 0x55555450u, 0x55544000u, 0x54400000u,
    0x55555440u, 0x55550000u, 0x55555500u, 0x55000000u,
    0x55150100u, 0x00004054u, 0x15010000u, 0x00405054u,
    0x00004050u, 0x15050100u, 0x05010000u, 0x40505054u,
    0x00404050u, 0x05010100u, 0x14141414u, 0x05141450u,
    0x01155440u, 0x00555500u, 0x15014054u, 0x05414150u,
    0x44444444u, 0x55005500u, 0x11441144u, 0x05055050u,
    0x05500550u, 0x11114444u, 0x41144114u, 0x44111144u,
    0x15055054u, 0x01055040u, 0x05041050u, 0x05455150u,
    0x14414114u, 0x50050550u, 0x41411414u, 0x00141400u,
    0x00041504u, 0x00105410u, 0x10541000u, 0x04150400u,
    0x50410514u, 0x41051450u, 0x05415014u, 0x14054150u,
    0x41050514u, 0x41505014u, 0x40011554u, 0x54150140u,
    0x50505500u, 0x00555050u, 0x15151010u, 0x54540404u,
};
static __constant__ uint8_t c_pa2[64] = {
    0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f,
    0x0f, 0x02, 0x08, 0x02, 0x02, 0x08, 0x08, 0x0f, 0x02, 0x08, 0x02, 0x02, 0x08, 0x08, 0x02, 0x02,
    0x0f, 0x0f, 0x06, 0x08, 0x02, 0x08, 0x0f, 0x0f, 0x02, 0x08, 0x02, 0x02, 0x02, 0x0f, 0x0f, 0x06,
    0x06, 0x02, 0x06, 0x08, 0x0f, 0x0f, 0x02, 0x02, 0x0f, 0x0f, 0x0f, 0x0f, 0x0f, 0x02, 0x02, 0x0f,
};
static __constant__ uint32_t c_pp3[64] = {   // three subsets
    0xaa685050u, 0x6a5a5040u, 0x5a5a4200u, 0x5450a0a8u,
    0xa5a50000u, 0xa0a05050u, 0x5555a0a0u, 0x5a5a5050u,
    0xaa550000u, 0xaa555500u, 0xaaaa5500u, 0x90909090u,
    0x94949494u, 0xa4a4a4a4u, 0xa9a59450u, 0x2a0a4250u,
    0xa5945040u, 0x0a425054u, 0xa5a5a500u, 0x55a0a0a0u,
    0xa8a85454u, 0x6a6a4040u, 0xa4a45000u, 0x1a1a0500u,
    0x0050a4a4u, 0xaaa59090u, 0x14696914u, 0x69691400u,
    0xa08585a0u, 0xaa821414u, 0x50a4a450u, 0x6a5a0200u,
    0xa9a58000u, 0x5090a0a8u, 0xa8a09050u, 0x24242424u,
    0x00aa5500u, 0x24924924u, 0x24499224u, 0x50a50a50u,
    0x500aa550u, 0xaaaa4444u, 0x66660000u, 0xa5a0a5a0u,
    0x50a050a0u, 0x69286928u, 0x44aaaa44u, 0x66666600u,
    0xaa444444u, 0x54a854a8u, 0x95809580u, 0x96969600u,
    0xa85454a8u, 0x80959580u, 0xaa141414u, 0x96960000u,
    0xaaaa1414u, 0xa05050a0u, 0xa0a5a5a0u, 0x96000000u,
    0x40804080u, 0xa9a8a9a8u, 0xaaaaaa44u, 0x2a4a5254u,
};
static __constant__ uint8_t c_pa3[64] = {
    0xf3, 0x83, 0x8f, 0x3f, 0xf8, 0xf3, 0x3f, 0x8f, 0xf8, 0xf8, 0xf6, 0xf6, 0xf6, 0xf5, 0xf3, 0x83,
    0xf3, 0x83, 0xf8, 0x3f, 0xf3, 0x83, 0xf6, 0x8a, 0x35, 0xf8, 0x68, 0xa6, 0xf8, 0xf5, 0xaf, 0x8f,
    0xf8, 0x3f, 0xf3, 0xa5, 0xa6, 0x8a, 0x98, 0xaf, 0x6f, 0xf3, 0x8f, 0xf5, 0x3f, 0x6f, 0x6f, 0x8f,
    0xf3, 0x3f, 0xf5, 0xf5, 0xf5, 0xf8, 0xf5, 0xfa, 0xf5, 0xfa, 0xf8, 0xfd, 0x3f, 0xfc, 0xf3, 0x83,
};

// 16-bit pixel mask of subset 1 of a two-subset shape
__device__ __forceinline__ unsigned subset1_mask(int shape) {
  const uint32_t pp = c_pp2[shape];
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) m |= ((pp >> (2 * i)) & 1u) << i;
  return m;
}

// 16-bit pixel masks of the three subsets of a three-subset shape
__device__ __forceinline__ void subset_masks3(int shape, unsigned msk[3]) {
  const uint32_t pp = c_pp3[shape];
  unsigned m1 = 0, m2 = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const unsigned s = (pp >> (2 * i)) & 3u;
    m1 |= (s == 1u ? 1u : 0u) << i;
    m2 |= (s == 2u ? 1u : 0u) << i;
  }
  msk[0] = ~(m1 | m2) & 0xFFFFu;
  msk[1] = m1;
  msk[2] = m2;
}

// ---------------------------------------------------------------------------
// 128-bit block I/O
// ---------------------------------------------------------------------------
struct Bits128 {
  unsigned long long lo, hi;
};

__device__ __forceinline__ Bits128 load_words(const uint32_t* __restrict__ w,
                                               int nb, int b) {
  Bits128 r;
  r.lo = (unsigned long long)w[b] | ((unsigned long long)w[nb + b] << 32);
  r.hi = (unsigned long long)w[2 * nb + b]
       | ((unsigned long long)w[3 * nb + b] << 32);
  return r;
}

__device__ __forceinline__ void store_words(uint32_t* __restrict__ w, int nb,
                                            int b, const Bits128& r) {
  w[b] = (uint32_t)r.lo;
  w[nb + b] = (uint32_t)(r.lo >> 32);
  w[2 * nb + b] = (uint32_t)r.hi;
  w[3 * nb + b] = (uint32_t)(r.hi >> 32);
}

// n bits (n <= 32) at bit `pos`
__device__ __forceinline__ uint32_t get_bits(const Bits128& b, int pos, int n) {
  unsigned long long v;
  if (pos >= 64) {
    v = b.hi >> (pos - 64);
  } else {
    v = b.lo >> pos;
    if (pos + n > 64) v |= b.hi << (64 - pos);
  }
  return (uint32_t)(v & ((1ull << n) - 1ull));
}

// OR an n-bit value in at bit `pos` (EmitBlock's sequential field layout)
__device__ __forceinline__ void put_bits(Bits128& b, int pos, uint32_t v,
                                         int n) {
  const unsigned long long x = v;
  if (pos >= 64) {
    b.hi |= x << (pos - 64);
  } else {
    b.lo |= x << pos;
    if (pos + n > 64) b.hi |= x >> (64 - pos);
  }
}

// mode = lowest set bit of byte 0; 8 = reserved
__device__ __forceinline__ int block_mode(const Bits128& b) {
  const unsigned b0 = (unsigned)(b.lo & 0xFFu);
  return b0 ? __ffs(b0) - 1 : 8;
}

// ---------------------------------------------------------------------------
// palette math (bc67.py:99, :387, :454, :463)
// ---------------------------------------------------------------------------

// round(64k/(K-1)): the g_aWeights2/3/4 tables as an exact multiply-shift
template <int K>
__device__ __forceinline__ int pal_weight(int k) {
  constexpr int m = (65536 + (2 * K - 2) - 1) / (2 * K - 2);
  return ((128 * k + (K - 1)) * m) >> 16;
}

// pal_weight on an integer-valued float index: floor(64k/(K-1) + 1/2)
template <int K>
__device__ __forceinline__ float pal_weight_f(float kf) {
  constexpr float s = (float)(64.0 / (K - 1));
  return floorf(kf * s + 0.5f);
}

// (c << (8-p)) | (c >> (2p-8)) (BC6HBC7.cpp:826)
__device__ __forceinline__ int unquantize(int c, int p) {
  if (p >= 8) return c;
  c = (c << (8 - p)) & 0xFF;
  return c | (c >> p);
}

// min(255, c + (1 << (7-p))) >> (8-p) (BC6HBC7.cpp:806)
__device__ __forceinline__ int quantize_u8(int c, int p) {
  if (p >= 8) return c;
  return min(c + (1 << (7 - p)), 255) >> (8 - p);
}

// one endpoint channel of mode M: code + p bit -> unquantized value
template <int M>
__device__ __forceinline__ int unquant_channel(int q, int p, int c) {
  const int v = prec(M, c) != prec_p(M, c) ? ((q << 1) | p) : q;
  return unquantize(v, prec_p(M, c));
}

// the 4-bit fields of the pixels in a 16-bit mask, in an index plane
// packed 16 to a 64-bit word (pixel i at bits 4i)
__device__ __forceinline__ unsigned long long nibble_mask(unsigned msk) {
  unsigned long long m = 0ull;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if ((msk >> i) & 1u) m |= 0xFull << (4 * i);
  return m;
}

__device__ __forceinline__ void swap_ints(int& a, int& b) {
  const int t = a;
  a = b;
  b = t;
}

// ---------------------------------------------------------------------------
// pixels: 16 packed RGBA8 words per block
// ---------------------------------------------------------------------------
__device__ __forceinline__ int px_at(const uint32_t* pix, int i, int c) {
  return (int)((pix[i] >> (8 * c)) & 0xFFu);
}

__device__ __forceinline__ void load_pixels(const int32_t* __restrict__ px,
                                            int nb, int b, uint32_t pix[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v |= ((uint32_t)px[(i * 4 + c) * nb + b] & 0xFFu) << (8 * c);
    pix[i] = v;
  }
}

// modes 4/5 rotation: swap channel rot-1 with alpha
__device__ __forceinline__ void rotate_pixels(const uint32_t src[16], int rot,
                                              uint32_t dst[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (rot == 0) {
      dst[i] = src[i];
    } else {
      const int sh = 8 * (rot - 1);
      const uint32_t x = (src[i] >> sh) & 0xFFu, a = src[i] >> 24;
      dst[i] = (src[i] & ~((0xFFu << sh) | 0xFF000000u)) | (a << sh)
             | (x << 24);
    }
  }
}

// ---------------------------------------------------------------------------
// Projection index assignment + exact palette error (_assign_indices_t,
// bc67.py:471) over channels [LO, HI) of the pixels in `msk`. Writes the
// index of every pixel to idx; the error sums the masked pixels in pixel
// order. W: the squared error of channel `wch` (the alpha channel, where
// a rotation put it) is scaled by `aw` (alpha_weight); the projection
// stays unweighted.
// ---------------------------------------------------------------------------
template <int PREC, int LO, int HI, bool W = false>
__device__ __forceinline__ float assign_indices(const uint32_t pix[16],
                                                const int u0[4],
                                                const int u1[4], unsigned msk,
                                                int idx[16], float aw = 1.0f,
                                                int wch = 3) {
  constexpr int K = 1 << PREC;
  int e[4];
  int span = 0;
#pragma unroll
  for (int c = LO; c < HI; ++c) {
    e[c] = u1[c] - u0[c];
    span += e[c] * e[c];
  }
  const float spanf = (float)span;
  const float s64 = 64.0f / (spanf > 0.0f ? spanf : 1.0f);
  float err = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    int d[4];
    int dot = 0;
#pragma unroll
    for (int c = LO; c < HI; ++c) {
      d[c] = px_at(pix, i, c) - u0[c];
      dot += d[c] * e[c];
    }
    const float p64 = fminf(fmaxf((float)dot * s64, 0.0f), 64.0f);
    int kf = (int)rintf(p64 * (float)((K - 1) / 64.0));
    kf = min(max(kf, 0), K - 1);
    const int wk = pal_weight<K>(kf);
    const int wkp = pal_weight<K>(min(kf + 1, K - 1));
    const int wkm = pal_weight<K>(max(kf - 1, 0));
    const bool up = kf < K - 1 && 2.0f * p64 > (float)(wk + wkp);
    const bool dn = kf > 0 && 2.0f * p64 < (float)(wk + wkm);
    const int k = up ? kf + 1 : (dn ? kf - 1 : kf);
    const int w = pal_weight<K>(k);
    float dist = 0.0f;
#pragma unroll
    for (int c = LO; c < HI; ++c) {
      const float r = (float)(d[c] - ((w * e[c] + 32) >> 6));
      float r2 = r * r;
      if (W && c == wch) r2 = r2 * aw;
      dist = dist + r2;
    }
    idx[i] = k;
    err = err + (((msk >> i) & 1u) ? dist : 0.0f);
  }
  return err;
}

// Anchor swaps of a two-subset block (AssignIndices, BC6HBC7.cpp:3181-3194):
// a subset whose anchor index has its MSB set swaps its endpoints and p
// bits and inverts its indices. m1: the pixel mask of subset 1.
template <int P>
__device__ __forceinline__ void anchor_swaps_2sub(int shape, unsigned m1,
                                                  int q0[2][4], int q1[2][4],
                                                  int p0[2], int p1[2],
                                                  int idx[16]) {
  const int anchor = c_pa2[shape] & 0xF;
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
    int a = idx[0];
    if (sub) {
#pragma unroll
      for (int i = 1; i < 16; ++i)
        if (i == anchor) a = idx[i];
    }
    if (a & (1 << (P - 1))) {
#pragma unroll
      for (int c = 0; c < 4; ++c) swap_ints(q0[sub][c], q1[sub][c]);
      swap_ints(p0[sub], p1[sub]);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (((m1 >> i) & 1u) == (unsigned)sub) idx[i] = (1 << P) - 1 - idx[i];
    }
  }
}

// Anchor swaps of a three-subset block (modes 0 and 2): as
// anchor_swaps_2sub, with the anchors of subsets 1 and 2 in c_pa3's low
// and high nibbles. msk: the subsets' pixel masks.
template <int P>
__device__ __forceinline__ void anchor_swaps_3sub(int shape,
                                                  const unsigned msk[3],
                                                  int q0[3][4], int q1[3][4],
                                                  int p0[3], int p1[3],
                                                  int idx[16]) {
  const int a2 = c_pa3[shape] & 0xF, a3 = c_pa3[shape] >> 4;
#pragma unroll
  for (int sub = 0; sub < 3; ++sub) {
    const int anchor = sub == 0 ? 0 : (sub == 1 ? a2 : a3);
    int a = idx[0];
#pragma unroll
    for (int i = 1; i < 16; ++i)
      if (i == anchor) a = idx[i];
    if (a & (1 << (P - 1))) {
#pragma unroll
      for (int c = 0; c < 4; ++c) swap_ints(q0[sub][c], q1[sub][c]);
      swap_ints(p0[sub], p1[sub]);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if ((msk[sub] >> i) & 1u) idx[i] = (1 << P) - 1 - idx[i];
    }
  }
}

// Independent anchor fixes of a mode-4/5 block's two index sets
// (AssignIndices, BC6HBC7.cpp:3196-3216): set 1 (P1 bits) holds colour at
// index mode 0 and alpha at index mode 1; a set whose first index has its
// MSB set inverts its indices and swaps its channels' endpoint codes.
template <int P1, int P2>
__device__ __forceinline__ void anchor_swaps_45(bool im0, int w1[16],
                                                int w2[16], int q0[4],
                                                int q1[4]) {
  const bool swap1 = w1[0] & (1 << (P1 - 1));
  const bool swap2 = w2[0] & (1 << (P2 - 1));
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (swap1) w1[i] = (1 << P1) - 1 - w1[i];
    if (swap2) w2[i] = (1 << P2) - 1 - w2[i];
  }
  const bool swap_rgb = im0 ? swap1 : swap2;
  const bool swap_a = im0 ? swap2 : swap1;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < 3 ? swap_rgb : swap_a) swap_ints(q0[c], q1[c]);
}

// codes + p bits -> unquantized endpoints (_unquantize_with_p_t)
template <int M>
__device__ __forceinline__ void unquantize_endpoints(const int q0[4],
                                                     const int q1[4], int p0,
                                                     int p1, int u0[4],
                                                     int u1[4]) {
  if (shared_p(M)) p1 = p0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (prec(M, c) == 0) {
      u0[c] = u1[c] = 255;
    } else {
      u0[c] = unquant_channel<M>(q0[c], p0, c);
      u1[c] = unquant_channel<M>(q1[c], p1, c);
    }
  }
}

// ---------------------------------------------------------------------------
// EmitBlock (BC6HBC7.cpp:3221; _emit_bc7, bc67.py:631). q0/q1 [subset][4]
// codes without p bits, p0/p1 [subset], idx1/idx2 full-precision indices
// (anchor pixels written one bit short).
// ---------------------------------------------------------------------------
template <int M>
__device__ __forceinline__ Bits128 emit_block(int shape, int rot, int im,
                                              const int (*q0)[4],
                                              const int (*q1)[4],
                                              const int* p0, const int* p1,
                                              const int idx1[16],
                                              const int idx2[16]) {
  constexpr int n_sub = parts(M) + 1;
  Bits128 b{0ull, 0ull};
  int pos = 0;
  put_bits(b, pos, 1u << M, M + 1);
  pos += M + 1;
  if (partition_bits(M)) {
    put_bits(b, pos, (uint32_t)shape, partition_bits(M));
    pos += partition_bits(M);
  }
  if (rotation_bits(M)) {
    put_bits(b, pos, (uint32_t)rot, rotation_bits(M));
    pos += rotation_bits(M);
  }
  if (index_mode_bits(M)) {
    put_bits(b, pos, (uint32_t)im, index_mode_bits(M));
    pos += index_mode_bits(M);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (prec(M, c) == 0) continue;
#pragma unroll
    for (int s = 0; s < n_sub; ++s) {
      put_bits(b, pos, (uint32_t)q0[s][c], prec(M, c));
      pos += prec(M, c);
      put_bits(b, pos, (uint32_t)q1[s][c], prec(M, c));
      pos += prec(M, c);
    }
  }
  if (p_bits(M)) {
#pragma unroll
    for (int s = 0; s < n_sub; ++s) {
      put_bits(b, pos, (uint32_t)p0[s], 1);
      pos += 1;
      if (!shared_p(M)) {
        put_bits(b, pos, (uint32_t)p1[s], 1);
        pos += 1;
      }
    }
  }
  int a2 = -1, a3 = -1;
  if (parts(M) == 1) a2 = c_pa2[shape] & 0xF;
  if (parts(M) == 2) {
    a2 = c_pa3[shape] & 0xF;
    a3 = c_pa3[shape] >> 4;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = index_prec(M) - ((i == 0 || i == a2 || i == a3) ? 1 : 0);
    put_bits(b, pos, (uint32_t)idx1[i], n);
    pos += n;
  }
  if (index_prec2(M)) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = index_prec2(M) - (i == 0 ? 1 : 0);
      put_bits(b, pos, (uint32_t)idx2[i], n);
      pos += n;
    }
  }
  return b;
}

}  // namespace bc7
