// BC6H shared device code: the mode table, the header layouts, block
// unpack and emit, the F16-int quantize / unquantize steps, the projection
// palette scorer, the LS refit and the full quantized-domain subset
// evaluation that the decode (K4), search (K5, K10, K11) and refine (K6)
// kernels share. Every function mirrors a plain-twin step of
// directxtex_tpu_torch/bc/bc6h.py in the same operation order.
//
// Layouts, one CUDA thread per 4x4 block: F16-int pixels arrive as
// [48, NB] int32 (row = channel * 16 + pixel) and are staged in shared
// memory as int16 (a signed F16-int fits), [48][kThreads], each thread
// reading and writing its own column only; packed blocks are [4, NB] u32.
#pragma once

#include "bc7_common.cuh"

namespace bc6h {

using bc7::Bits128;
using bc7::get_bits;
using bc7::kThreads;
using bc7::nibble_mask;
using bc7::pal_weight;
using bc7::pal_weight_f;
using bc7::put_bits;

constexpr int kF16Max = 0x7BFF;

// ms_aInfo (BC6HBC7.cpp:1051-1067, bc67_tables.BC6H_MODE_INFO); the
// endpoint precision W is the same for R, G and B in every row
struct ModeInfo {
  int mode_val, parts, transformed, iprec, prec_w;
  int prec_x[3], prec_y[3], prec_z[3];
};
static __constant__ ModeInfo c_info[14] = {
    {0x00, 1, 1, 3, 10, {5, 5, 5}, {5, 5, 5}, {5, 5, 5}},
    {0x01, 1, 1, 3, 7, {6, 6, 6}, {6, 6, 6}, {6, 6, 6}},
    {0x02, 1, 1, 3, 11, {5, 4, 4}, {5, 4, 4}, {5, 4, 4}},
    {0x06, 1, 1, 3, 11, {4, 5, 4}, {4, 5, 4}, {4, 5, 4}},
    {0x0A, 1, 1, 3, 11, {4, 4, 5}, {4, 4, 5}, {4, 4, 5}},
    {0x0E, 1, 1, 3, 9, {5, 5, 5}, {5, 5, 5}, {5, 5, 5}},
    {0x12, 1, 1, 3, 8, {6, 5, 5}, {6, 5, 5}, {6, 5, 5}},
    {0x16, 1, 1, 3, 8, {5, 6, 5}, {5, 6, 5}, {5, 6, 5}},
    {0x1A, 1, 1, 3, 8, {5, 5, 6}, {5, 5, 6}, {5, 5, 6}},
    {0x1E, 1, 0, 3, 6, {6, 6, 6}, {6, 6, 6}, {6, 6, 6}},
    {0x03, 0, 0, 4, 10, {10, 10, 10}, {0, 0, 0}, {0, 0, 0}},
    {0x07, 0, 1, 4, 11, {9, 9, 9}, {0, 0, 0}, {0, 0, 0}},
    {0x0B, 0, 1, 4, 12, {8, 8, 8}, {0, 0, 0}, {0, 0, 0}},
    {0x0F, 0, 1, 4, 16, {4, 4, 4}, {0, 0, 0}, {0, 0, 0}},
};

// 5-bit header value -> mode row (ms_aModeToInfo :1069), -1 reserved
static __constant__ int8_t c_mode_to_row[32] = {
    0, 1, 2, 10, -1, -1, 3, 11, -1, -1, 4, 12, -1, -1, 5, 13,
    -1, -1, 6, -1, -1, -1, 7, -1, -1, -1, 8, -1, -1, -1, 9, -1};

// Header layout per row (BC6H_DESC, BC6HBC7.cpp:879-1049) as contiguous
// runs: field id | field bit << 4 | position << 8 | length << 16; a zero
// entry ends the row. Field 1 is the mode, 2 the shape, 3 + 4c + 2r + e
// endpoint e of region r, channel c (RW RX RY RZ GW .. BZ).
// Pinned to the descriptor table by tests/test_torch_tables.py.
constexpr int kMaxRuns = 25;
static __constant__ uint32_t c_runs[14][kMaxRuns] = {
    {0x20001u, 0x10249u, 0x1034du, 0x1044eu, 0xa0503u, 0xa0f07u, 0xa190bu, 0x52304u, 0x1284au, 0x42909u, 0x52d08u, 0x1320eu, 0x4330au, 0x5370cu, 0x13c1eu, 0x43d0du, 0x54105u, 0x1462eu, 0x54706u, 0x14c3eu, 0x54d02u, 0x00000u, 0x00000u, 0x00000u, 0x00000u},
    {0x20001u, 0x10259u, 0x2034au, 0x70503u, 0x20c0eu, 0x10e4du, 0x70f07u, 0x1165du, 0x1172eu, 0x11849u, 0x7190bu, 0x1203eu, 0x1215eu, 0x1224eu, 0x62304u, 0x42909u, 0x62d08u, 0x4330au, 0x6370cu, 0x43d0du, 0x64105u, 0x64706u, 0x54d02u, 0x00000u, 0x00000u},
    {0x50001u, 0xa0503u, 0xa0f07u, 0xa190bu, 0x52304u, 0x128a3u, 0x42909u, 0x42d08u, 0x131a7u, 0x1320eu, 0x4330au, 0x4370cu, 0x13babu, 0x13c1eu, 0x43d0du, 0x54105u, 0x1462eu, 0x54706u, 0x14c3eu, 0x54d02u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u},
    {0x50001u, 0xa0503u, 0xa0f07u, 0xa190bu, 0x42304u, 0x127a3u, 0x1284au, 0x42909u, 0x52d08u, 0x132a7u, 0x4330au, 0x4370cu, 0x13babu, 0x13c1eu, 0x43d0du, 0x44105u, 0x1450eu, 0x1462eu, 0x44706u, 0x14b49u, 0x14c3eu, 0x54d02u, 0x00000u, 0x00000u, 0x00000u},
    {0x50001u, 0xa0503u, 0xa0f07u, 0xa190bu, 0x42304u, 0x127a3u, 0x1284du, 0x42909u, 0x42d08u, 0x131a7u, 0x1320eu, 0x4330au, 0x5370cu, 0x13cabu, 0x43d0du, 0x44105u, 0x2451eu, 0x44706u, 0x14b4eu, 0x14c3eu, 0x54d02u, 0x00000u, 0x00000u, 0x00000u, 0x00000u},
    {0x50001u, 0x90503u, 0x10e4du, 0x90f07u, 0x11849u, 0x9190bu, 0x1224eu, 0x52304u, 0x1284au, 0x42909u, 0x52d08u, 0x1320eu, 0x4330au, 0x5370cu, 0x13c1eu, 0x43d0du, 0x54105u, 0x1462eu, 0x54706u, 0x14c3eu, 0x54d02u, 0x00000u, 0x00000u, 0x00000u, 0x00000u},
    {0x50001u, 0x80503u, 0x10d4au, 0x10e4du, 0x80f07u, 0x1172eu, 0x11849u, 0x8190bu, 0x2213eu, 0x62304u, 0x42909u, 0x52d08u, 0x1320eu, 0x4330au, 0x5370cu, 0x13c1eu, 0x43d0du, 0x64105u, 0x64706u, 0x54d02u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u},
    {0x50001u, 0x80503u, 0x10d0eu, 0x10e4du, 0x80f07u, 0x11759u, 0x11849u, 0x8190bu, 0x1215au, 0x1224eu, 0x52304u, 0x1284au, 0x42909u, 0x62d08u, 0x4330au, 0x5370cu, 0x13c1eu, 0x43d0du, 0x54105u, 0x1462eu, 0x54706u, 0x14c3eu, 0x54d02u, 0x00000u, 0x00000u},
    {0x50001u, 0x80503u, 0x10d1eu, 0x10e4du, 0x80f07u, 0x1175du, 0x11849u, 0x8190bu, 0x1215eu, 0x1224eu, 0x52304u, 0x1284au, 0x42909u, 0x52d08u, 0x1320eu, 0x4330au, 0x6370cu, 0x43d0du, 0x54105u, 0x1462eu, 0x54706u, 0x14c3eu, 0x54d02u, 0x00000u, 0x00000u},
    {0x50001u, 0x60503u, 0x10b4au, 0x20c0eu, 0x10e4du, 0x60f07u, 0x11559u, 0x1165du, 0x1172eu, 0x11849u, 0x6190bu, 0x11f5au, 0x1203eu, 0x1215eu, 0x1224eu, 0x62304u, 0x42909u, 0x62d08u, 0x4330au, 0x6370cu, 0x43d0du, 0x64105u, 0x64706u, 0x54d02u, 0x00000u},
    {0x50001u, 0xa0503u, 0xa0f07u, 0xa190bu, 0xa2304u, 0xa2d08u, 0xa370cu, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u},
    {0x50001u, 0xa0503u, 0xa0f07u, 0xa190bu, 0x92304u, 0x12ca3u, 0x92d08u, 0x136a7u, 0x9370cu, 0x140abu, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u},
    {0x50001u, 0xa0503u, 0xa0f07u, 0xa190bu, 0x82304u, 0x12bb3u, 0x12ca3u, 0x82d08u, 0x135b7u, 0x136a7u, 0x8370cu, 0x13fbbu, 0x140abu, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u, 0x00000u},
    {0x50001u, 0xa0503u, 0xa0f07u, 0xa190bu, 0x42304u, 0x127f3u, 0x128e3u, 0x129d3u, 0x12ac3u, 0x12bb3u, 0x12ca3u, 0x42d08u, 0x131f7u, 0x132e7u, 0x133d7u, 0x134c7u, 0x135b7u, 0x136a7u, 0x4370cu, 0x13bfbu, 0x13cebu, 0x13ddbu, 0x13ecbu, 0x13fbbu, 0x140abu},
};

// mode row of a block; -1 for the reserved header values
__device__ __forceinline__ int mode_row(const Bits128& w) {
  const int b5 = (int)(w.lo & 0x1Fu);
  return c_mode_to_row[(b5 & 3) < 2 ? (b5 & 3) : b5];
}

__device__ __forceinline__ int header_bits(int row) {
  return c_info[row].parts ? 82 : 65;
}

__device__ __forceinline__ int sext(int v, int bits) {
  v &= (1 << bits) - 1;
  return v >= (1 << (bits - 1)) ? v - (1 << bits) : v;
}

// Shape + absolute quantized endpoints e[region][end][channel] of a block
// read as mode row `row` (_bc6h_unpack_endpoints: Decode :1719-1736 +
// TransformInverse :1153, stopping before Unquantize)
__device__ __forceinline__ int unpack(const Bits128& w, int row, bool sgn,
                                      int e[2][2][3]) {
  int fld[13];   // field ids 2..14
#pragma unroll
  for (int j = 0; j < 13; ++j) fld[j] = 0;
#pragma unroll 1
  for (int k = 0; k < kMaxRuns; ++k) {
    const uint32_t r = c_runs[row][k];
    if (r == 0u) break;
    const int fid = r & 0xF, fbit = (r >> 4) & 0xF, pos = (r >> 8) & 0xFF;
    const int len = (r >> 16) & 0xF;
    const int v = (int)get_bits(w, pos, len) << fbit;
#pragma unroll
    for (int j = 0; j < 13; ++j)
      if (fid == j + 2) fld[j] |= v;
  }
  const ModeInfo& m = c_info[row];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e[0][0][c] = fld[1 + 4 * c];
    e[0][1][c] = fld[2 + 4 * c];
    e[1][0][c] = fld[3 + 4 * c];
    e[1][1][c] = fld[4 + 4 * c];
    if (sgn) e[0][0][c] = sext(e[0][0][c], m.prec_w);
    if (sgn || m.transformed) {
      e[0][1][c] = sext(e[0][1][c], m.prec_x[c]);
      if (m.parts) {
        e[1][0][c] = sext(e[1][0][c], m.prec_y[c]);
        e[1][1][c] = sext(e[1][1][c], m.prec_z[c]);
      }
    }
    if (m.transformed) {
      const int mask = (1 << m.prec_w) - 1;
      const int v01 = (e[0][1][c] + e[0][0][c]) & mask;
      const int v10 = (e[1][0][c] + e[0][0][c]) & mask;
      const int v11 = (e[1][1][c] + e[0][0][c]) & mask;
      e[0][1][c] = sgn ? sext(v01, m.prec_w) : v01;
      e[1][0][c] = sgn ? sext(v10, m.prec_w) : v10;
      e[1][1][c] = sgn ? sext(v11, m.prec_w) : v11;
    }
  }
  return fld[0];
}

// D3DX_BC6H::Unquantize (BC6HBC7.cpp:1892), static or per-block bits
__device__ __forceinline__ int unquantize(int comp, int bits, bool sgn) {
  if (sgn) {
    if (bits >= 16) return comp;
    const int c = abs(comp);
    const int unq = c == 0 ? 0
                  : c >= (1 << (bits - 1)) - 1 ? 0x7FFF
                  : ((c << 15) + 0x4000) >> (bits - 1);
    return comp < 0 ? -unq : unq;
  }
  if (bits >= 15) return comp;
  return comp == 0 ? 0
       : comp == (1 << bits) - 1 ? 0xFFFF
       : ((comp << 16) + 0x8000) >> bits;
}

// FinishUnquantize (BC6HBC7.cpp:1930): 31/32 (signed) or 31/64
__device__ __forceinline__ int finish(int comp, bool sgn) {
  if (sgn) return comp < 0 ? -(((-comp) * 31) >> 5) : (comp * 31) >> 5;
  return (comp * 31) >> 6;
}

// D3DX_BC6H::Quantize (BC6HBC7.cpp:1864); v >= 0 when unsigned. The TPU's
// float-reciprocal division (_idiv_f16max1) is the same quotient.
__device__ __forceinline__ int quantize(int v, int prec, bool sgn) {
  if (sgn) {
    const int a = abs(v);
    const int q = prec >= 16 ? a : (a << (prec - 1)) / (kF16Max + 1);
    return v < 0 ? -q : q;
  }
  return prec >= 15 ? v : (v << prec) / (kF16Max + 1);
}

// true where v fits a prec-bit (two's complement if signed) field
__device__ __forceinline__ bool nbits_fit(int v, int prec, bool sgn) {
  return sgn ? (v >= -(1 << (prec - 1)) && v <= (1 << (prec - 1)) - 1)
             : (v >= 0 && v <= (1 << prec) - 1);
}

// ---------------------------------------------------------------------------
// pixels staged in shared memory
// ---------------------------------------------------------------------------
// a block's column of an int16 [48][STRIDE] array: p[row * STRIDE]
template <int STRIDE>
struct PxT {
  const int16_t* p;
  __device__ __forceinline__ int operator()(int c, int i) const {
    return p[(c * 16 + i) * STRIDE];
  }
  __device__ __forceinline__ float f(int c, int i) const {
    return (float)p[(c * 16 + i) * STRIDE];
  }
};
using Px = PxT<kThreads>;   // one column per thread of the CTA

// stage column b of px [48, NB] into this thread's shared column
__device__ __forceinline__ Px stage_pixels(const int32_t* __restrict__ px,
                                           int nb, int b, int16_t* s_px) {
  int16_t* col = s_px + threadIdx.x;
#pragma unroll 4
  for (int r = 0; r < 48; ++r) col[r * kThreads] = (int16_t)px[r * nb + b];
  return Px{col};
}

// 4-bit index planes packed 16 to a 64-bit word
__device__ __forceinline__ int idx_at(unsigned long long v, int i) {
  return (int)((v >> (4 * i)) & 0xFull);
}
__device__ __forceinline__ void idx_set(unsigned long long& v, int i, int k) {
  v = (v & ~(0xFull << (4 * i))) | ((unsigned long long)k << (4 * i));
}

// ---------------------------------------------------------------------------
// Projection palette scorer (_palette_err_u, bc6h.py): unquantized
// endpoints u0/u1 -> nearest index of every masked pixel (written into
// idx) and the masked squared error against the finished palette, summed
// in pixel order.
// ---------------------------------------------------------------------------
template <int K, class P>
__device__ __forceinline__ float palette_err(const P& px, unsigned msk,
                                             const int u0[3], const int u1[3],
                                             bool sgn,
                                             unsigned long long& idx) {
  float f0[3], e[3];
  float span = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f0[c] = (float)finish(u0[c], sgn);
    e[c] = (float)finish(u1[c], sgn) - f0[c];
    span = span + e[c] * e[c];
  }
  const float s64 = 64.0f / (span > 0.0f ? span : 1.0f);
  float err = 0.0f;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    if (!((msk >> i) & 1u)) continue;
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) dot = dot + (px.f(c, i) - f0[c]) * e[c];
    const float p64 = fminf(fmaxf(dot * s64, 0.0f), 64.0f);
    int kf = (int)rintf(p64 * (float)((K - 1) / 64.0));
    kf = min(max(kf, 0), K - 1);
    const int wk = pal_weight<K>(kf);
    const int wkp = pal_weight<K>(min(kf + 1, K - 1));
    const int wkm = pal_weight<K>(max(kf - 1, 0));
    const bool up = kf < K - 1 && 2.0f * p64 > (float)(wk + wkp);
    const bool dn = kf > 0 && 2.0f * p64 < (float)(wk + wkm);
    const int k = up ? kf + 1 : (dn ? kf - 1 : kf);
    const int w = pal_weight<K>(k);
    float best = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int pal = finish((u0[c] * (64 - w) + u1[c] * w + 32) >> 6, sgn);
      const float dd = (float)(px(c, i) - pal);
      best = best + dd * dd;
    }
    idx_set(idx, i, k);
    err = err + best;
  }
  return err;
}

// Both subsets' palette scores in one pass over the 16 pixels: pixel i
// takes its own subset's endpoints t[(m1 >> i) & 1] and adds to that
// subset's sum, so each sum runs over its subset's pixels in pixel order
// with palette_err's arithmetic; writes every entry of idx
template <int K, class P>
__device__ __forceinline__ void palette_err_pair(const P& px, unsigned m1,
                                                 const int t[2][2][3],
                                                 int prec, bool sgn,
                                                 unsigned long long& idx,
                                                 float err[2]) {
  int u0[2][3], u1[2][3];
  float f0[2][3], e[2][3], s64[2];
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
    float span = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u0[sub][c] = unquantize(t[sub][0][c], prec, sgn);
      u1[sub][c] = unquantize(t[sub][1][c], prec, sgn);
      f0[sub][c] = (float)finish(u0[sub][c], sgn);
      e[sub][c] = (float)finish(u1[sub][c], sgn) - f0[sub][c];
      span = span + e[sub][c] * e[sub][c];
    }
    s64[sub] = 64.0f / (span > 0.0f ? span : 1.0f);
  }
  err[0] = 0.0f;
  err[1] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const bool s1 = (m1 >> i) & 1u;
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      dot = dot + (px.f(c, i) - (s1 ? f0[1][c] : f0[0][c]))
                  * (s1 ? e[1][c] : e[0][c]);
    const float p64 = fminf(fmaxf(dot * (s1 ? s64[1] : s64[0]), 0.0f),
                            64.0f);
    int kf = (int)rintf(p64 * (float)((K - 1) / 64.0));
    kf = min(max(kf, 0), K - 1);
    const int wk = pal_weight<K>(kf);
    const int wkp = pal_weight<K>(min(kf + 1, K - 1));
    const int wkm = pal_weight<K>(max(kf - 1, 0));
    const bool up = kf < K - 1 && 2.0f * p64 > (float)(wk + wkp);
    const bool dn = kf > 0 && 2.0f * p64 < (float)(wk + wkm);
    const int k = up ? kf + 1 : (dn ? kf - 1 : kf);
    const int w = pal_weight<K>(k);
    float best = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a0 = s1 ? u0[1][c] : u0[0][c];
      const int a1 = s1 ? u1[1][c] : u1[0][c];
      const int pal = finish((a0 * (64 - w) + a1 * w + 32) >> 6, sgn);
      const float dd = (float)(px(c, i) - pal);
      best = best + dd * dd;
    }
    idx_set(idx, i, k);
    if (s1)
      err[1] = err[1] + best;
    else
      err[0] = err[0] + best;
  }
}

// the same on quantized endpoints at precision prec (per block or static)
template <int K, class P>
__device__ __forceinline__ float palette_err_q(const P& px, unsigned msk,
                                               const int q0[3],
                                               const int q1[3], int prec,
                                               bool sgn,
                                               unsigned long long& idx) {
  int u0[3], u1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u0[c] = unquantize(q0[c], prec, sgn);
    u1[c] = unquantize(q1[c], prec, sgn);
  }
  return palette_err<K>(px, msk, u0, u1, sgn, idx);
}

// LS magnitude cap of a subset (_mag_cap): max(|min|, |max|) + 1024 per
// channel over the masked pixels; mi/ma are the masked box
template <class P>
__device__ __forceinline__ void mag_cap(const P& px, unsigned msk,
                                        float mi[3], float ma[3],
                                        float cap[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mi[c] = 1e9f;
    ma[c] = -1e9f;
  }
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    if (!((msk >> i) & 1u)) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mi[c] = fminf(mi[c], px.f(c, i));
      ma[c] = fmaxf(ma[c], px.f(c, i));
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    cap[c] = fmaxf(fabsf(mi[c]), fabsf(ma[c])) + 1024.0f;   // BC6H_LS_MAG_CAP
}

// Least-squares endpoint refit at per-pixel weights w/64 (w from the index
// plane idx, int palette weights when INT_W, else the float trajectory's
// pal_weight_f), clipped to the F16-int range and the cap; e0/e1 keep
// their values where the system is singular (_bc6h_ls_refit)
template <int K, bool INT_W, class P>
__device__ __forceinline__ void ls_refit(const P& px, unsigned msk,
                                         unsigned long long idx,
                                         const float cap[3], bool sgn,
                                         float e0[3], float e1[3]) {
  float A = 0.0f, B = 0.0f, C = 0.0f;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const float x = (INT_W ? (float)pal_weight<K>(idx_at(idx, i))
                           : pal_weight_f<K>((float)idx_at(idx, i)))
                    * (1.0f / 64.0f);
    const float m = ((msk >> i) & 1u) ? 1.0f : 0.0f;
    const float a = (1.0f - x) * m, b = x * m;
    A = A + a * a;
    B = B + a * b;
    C = C + b * b;
  }
  const float det = A * C - B * B;
  const bool ok = fabsf(det) > 1e-6f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float lim = (float)kF16Max, lo = sgn ? -lim : 0.0f;
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const float x = (INT_W ? (float)pal_weight<K>(idx_at(idx, i))
                             : pal_weight_f<K>((float)idx_at(idx, i)))
                      * (1.0f / 64.0f);
      const float m = ((msk >> i) & 1u) ? 1.0f : 0.0f;
      const float a = (1.0f - x) * m, b = x * m;
      r0 = r0 + a * px.f(c, i);
      r1 = r1 + b * px.f(c, i);
    }
    const float lo_c = fmaxf(-cap[c], lo), hi_c = fminf(cap[c], lim);
    const float n0 = fminf(fmaxf((C * r0 - B * r1) * inv, lo_c), hi_c);
    const float n1 = fminf(fmaxf((A * r1 - B * r0) * inv, lo_c), hi_c);
    if (ok) {
      e0[c] = n0;
      e1[c] = n1;
    }
  }
}

// ---------------------------------------------------------------------------
// Both regions of a two-region candidate in one pass over the 16 pixels
// (K5's candidate jobs, K11's lane jobs): pixel i takes region
// (m1 >> i) & 1's state and adds only to its sums
// ---------------------------------------------------------------------------
// mag_cap of each region
template <class P>
__device__ __forceinline__ void mag_cap_pair(const P& px, unsigned m1,
                                             float mi[2][3], float ma[2][3],
                                             float cap[2][3]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mi[s][c] = 1e9f;
      ma[s][c] = -1e9f;
    }
  }
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const bool s1 = (m1 >> i) & 1u;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = px.f(c, i);
      if (s1) {
        mi[1][c] = fminf(mi[1][c], x);
        ma[1][c] = fmaxf(ma[1][c], x);
      } else {
        mi[0][c] = fminf(mi[0][c], x);
        ma[0][c] = fmaxf(ma[0][c], x);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cap[s][c] = fmaxf(fabsf(mi[s][c]), fabsf(ma[s][c])) + 1024.0f;
  }
}

// ls_refit of each region (a pixel of the other region adds exact zeros
// to the one-region sums, so leaving it out changes no bit)
template <int K, bool INT_W, class P>
__device__ __forceinline__ void ls_refit_pair(const P& px, unsigned m1,
                                              unsigned long long idx,
                                              const float cap[2][3],
                                              bool sgn, float e0[2][3],
                                              float e1[2][3]) {
  float A[2] = {0.0f, 0.0f}, B[2] = {0.0f, 0.0f}, C[2] = {0.0f, 0.0f};
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const bool s1 = (m1 >> i) & 1u;
    const float x = (INT_W ? (float)pal_weight<K>(idx_at(idx, i))
                           : pal_weight_f<K>((float)idx_at(idx, i)))
                    * (1.0f / 64.0f);
    const float a = 1.0f - x, b = x;
    if (s1) {
      A[1] = A[1] + a * a;
      B[1] = B[1] + a * b;
      C[1] = C[1] + b * b;
    } else {
      A[0] = A[0] + a * a;
      B[0] = B[0] + a * b;
      C[0] = C[0] + b * b;
    }
  }
  float inv[2];
  bool ok[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float det = A[s] * C[s] - B[s] * B[s];
    ok[s] = fabsf(det) > 1e-6f;
    inv[s] = 1.0f / (ok[s] ? det : 1.0f);
  }
  const float lim = (float)kF16Max, lo = sgn ? -lim : 0.0f;
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    float r0[2] = {0.0f, 0.0f}, r1[2] = {0.0f, 0.0f};
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const bool s1 = (m1 >> i) & 1u;
      const float x = (INT_W ? (float)pal_weight<K>(idx_at(idx, i))
                             : pal_weight_f<K>((float)idx_at(idx, i)))
                      * (1.0f / 64.0f);
      const float a = 1.0f - x, b = x;
      const float p = px.f(c, i);
      if (s1) {
        r0[1] = r0[1] + a * p;
        r1[1] = r1[1] + b * p;
      } else {
        r0[0] = r0[0] + a * p;
        r1[0] = r1[0] + b * p;
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float lo_c = fmaxf(-cap[s][c], lo), hi_c = fminf(cap[s][c], lim);
      const float n0 =
          fminf(fmaxf((C[s] * r0[s] - B[s] * r1[s]) * inv[s], lo_c), hi_c);
      const float n1 =
          fminf(fmaxf((A[s] * r1[s] - B[s] * r0[s]) * inv[s], lo_c), hi_c);
      if (ok[s]) {
        e0[s][c] = n0;
        e1[s][c] = n1;
      }
    }
  }
}

// LS refit rounds of the full quantized-domain evaluation
// (BC6H_REFIT_ROUNDS, bc6h.py)
constexpr int kRefitRounds = 2;

// One subset of the full quantized-domain evaluation (the per-subset part
// of _bc6h_eval_candidate, bc6h.py; the BC6H_SHARED_FIT=False search, K10
// and K11): the masked min/max box quantized at prec_w and rescored
// exactly, then kRefitRounds LS rounds at the integer palette weights of
// the latest indices (capped, singular systems keep their endpoints),
// each requantized and rescored; the last round's result is kept where it
// scores strictly lower. Writes the subset's pixels of idx (the other
// pixels keep theirs); returns the subset error.
template <int K>
__device__ __forceinline__ float eval_subset_q(const Px& px, unsigned msk,
                                               bool sgn, int prec_w,
                                               int q0[3], int q1[3],
                                               unsigned long long& idx) {
  float e0[3], e1[3], cap[3];
  mag_cap(px, msk, e0, e1, cap);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q0[c] = quantize((int)rintf(e0[c]), prec_w, sgn);
    q1[c] = quantize((int)rintf(e1[c]), prec_w, sgn);
  }
  const float err = palette_err_q<K>(px, msk, q0, q1, prec_w, sgn, idx);
  int qb0[3], qb1[3];
  unsigned long long idx_b = idx;
  float err_b = err;
#pragma unroll 1
  for (int r = 0; r < kRefitRounds; ++r) {
    ls_refit<K, true>(px, msk, idx_b, cap, sgn, e0, e1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      qb0[c] = quantize((int)rintf(e0[c]), prec_w, sgn);
      qb1[c] = quantize((int)rintf(e1[c]), prec_w, sgn);
    }
    err_b = palette_err_q<K>(px, msk, qb0, qb1, prec_w, sgn, idx_b);
  }
  if (err_b < err) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q0[c] = qb0[c];
      q1[c] = qb1[c];
    }
    idx = idx_b;
  }
  return fminf(err_b, err);
}

// Delta transform + endpoint-fit check (_bc6h_transform_fit_t,
// TransformForward + EndPointsFit :1948) on anchor-fixed quantized
// endpoints q[region][end][c]; writes the field-masked values
__device__ __forceinline__ bool transform_fit(int row, bool sgn,
                                              const int q[2][2][3],
                                              int f[2][2][3]) {
  const ModeInfo& m = c_info[row];
  bool fit = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int base = q[0][0][c];
    const int vals[3] = {q[0][1][c], q[1][0][c], q[1][1][c]};
    const int precs[3] = {m.prec_x[c], m.prec_y[c], m.prec_z[c]};
    int st[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k > 0 && !m.parts) {
        st[k] = 0;
        continue;
      }
      st[k] = m.transformed ? vals[k] - base : vals[k];
      fit = fit && nbits_fit(st[k], precs[k], m.transformed ? true : sgn);
    }
    fit = fit && nbits_fit(base, m.prec_w, sgn);
    f[0][0][c] = base & ((1 << m.prec_w) - 1);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int v = precs[k] ? st[k] & ((1 << precs[k]) - 1) : 0;
      if (k == 0) f[0][1][c] = v;
      if (k == 1) f[1][0][c] = v;
      if (k == 2) f[1][1][c] = v;
    }
  }
  return fit;
}

// EmitBlock (:2330): header runs from the field values f, then the
// indices (anchor pixels one bit short). a2 = the second anchor (2-region
// rows) or -1.
__device__ __forceinline__ Bits128 emit(int row, int shape,
                                        const int f[2][2][3],
                                        unsigned long long idx, int a2) {
  const ModeInfo& m = c_info[row];
  Bits128 b{0ull, 0ull};
#pragma unroll 1
  for (int k = 0; k < kMaxRuns; ++k) {
    const uint32_t r = c_runs[row][k];
    if (r == 0u) break;
    const int fid = r & 0xF, fbit = (r >> 4) & 0xF, pos = (r >> 8) & 0xFF;
    const int len = (r >> 16) & 0xF;
    int v;
    if (fid == 1) {
      v = m.mode_val;
    } else if (fid == 2) {
      v = shape;
    } else {
      const int c = (fid - 3) >> 2, reg = ((fid - 3) >> 1) & 1,
                end = (fid - 3) & 1;
      v = f[reg][end][c];
    }
    put_bits(b, pos, ((uint32_t)v >> fbit) & ((1u << len) - 1u), len);
  }
  int pos = header_bits(row);
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int n = m.iprec - ((i == 0 || i == a2) ? 1 : 0);
    put_bits(b, pos, (uint32_t)idx_at(idx, i), n);
    pos += n;
  }
  return b;
}

// A lane job's best so far (K5, K11): its error, its position in the
// twin's fold order and its words
struct Best {
  float err;
  int order;   // position of the candidate in the twin's fold order
  Bits128 w;
};

// the twin's strict-`<` fold, independent of visiting order
__device__ __forceinline__ bool beats(const Best& best, float err,
                                      int order) {
  return err < best.err || (err == best.err && order < best.order);
}

// the 2-region precision groups (_bc6h_row_groups): first row, row count
static __constant__ int c_group_first[6] = {0, 1, 2, 5, 6, 9};
static __constant__ int c_group_rows[6] = {1, 1, 3, 1, 3, 1};

// SwapIndices (:2228) for one subset: if its anchor index has the MSB set,
// swap the endpoints and invert the subset's indices (maxi - k = k ^ maxi)
template <int K>
__device__ __forceinline__ void anchor_swap(unsigned msk, int anchor,
                                            int q0[3], int q1[3],
                                            unsigned long long& idx) {
  if (!(idx_at(idx, anchor) & (K >> 1))) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) bc7::swap_ints(q0[c], q1[c]);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if ((msk >> i) & 1u) idx ^= (unsigned long long)(K - 1) << (4 * i);
}

// stored indices of a block (anchors one bit short)
__device__ __forceinline__ unsigned long long read_indices(const Bits128& w,
                                                           int row, int a2) {
  const int iprec = c_info[row].iprec;
  int pos = header_bits(row);
  unsigned long long idx = 0ull;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int n = iprec - ((i == 0 || i == a2) ? 1 : 0);
    idx |= (unsigned long long)get_bits(w, pos, n) << (4 * i);
    pos += n;
  }
  return idx;
}

}  // namespace bc6h
