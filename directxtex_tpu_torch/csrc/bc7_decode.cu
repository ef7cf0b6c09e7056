// K1 — BC7 decode: a lane a block for the header, a lane a pixel for the
// f32 output (decode_lanes.cuh).
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc7_decode_pallas /
// _bc7_decode_kernel. The TPU kernel decoded every block under all 8 modes
// over [16, T] planes and selected per block, since its vector unit cannot
// branch per lane. Here lane i of a warp parses block i's header under the
// block's own mode (lowest set bit of byte 0), every field at its
// compile-time position for that mode, into a record in shared memory:
// mode, shape, rotation, index mode, every subset's endpoints unquantized
// to 8 bits, and the bits of both index sets. The pixel phase is the same
// code for every mode: a lane reads its block's record, takes its pixel's
// subset from the shape table and its indices at closed-form positions
// (dec::index_at), interpolates and rotates. Plain twins:
// bc67._bc7_decode_plain (the words API) and bc67._bc7_decode_f32_plain
// (decode_bc7's f32 output); bit-exact against both and against
// tests/golden/decode_vectors.npz (integer math, then one f32 multiply).
//
// Bound: bytes. A block reads 16 bytes and writes 256 (decode_bc7's f32
// [NB, 16, 4], or the words API's int32 [64, NB]) against 518-1,557
// integer operations for its own mode (tests/test_torch_op_counts.py).
// The design reads the packed blocks directly (no word transpose), parses
// a header once (32 a warp instruction), keeps the 16 pixels' work free of
// per-mode branches, reads the shape tables from shared memory (staged
// once per CTA; no per-lane constant-cache reads), and writes f32 pixels
// as one float4 a lane (no conversion pass after the kernel).
#include "decode_lanes.cuh"

namespace bc7 {

// a warp's block records in shared memory, one slot a lane of the CTA
struct Records {
  int meta[dec::kThreads];                 // mode | shape << 4 | rot << 10
                                           // | index mode << 12; 8 = black
  uint32_t ep[6][dec::kThreads];           // endpoint 2 * subset + end, its
                                           // channels a byte each (r lowest)
  unsigned long long win[2][dec::kThreads];  // each index set from its bit 0
};

// bit position of endpoint field f (0 .. n_ep - 1) of channel c, mode M
template <int M>
__device__ __forceinline__ int endpoint_pos(int c, int f) {
  constexpr int n_ep = 2 * (parts(M) + 1);
  constexpr int p_ep = M + 1 + partition_bits(M) + rotation_bits(M)
                     + index_mode_bits(M);
  return p_ep + (c < 3 ? c * n_ep * prec(M, 0) + f * prec(M, 0)
                       : 3 * n_ep * prec(M, 0) + f * prec(M, 3));
}

// block w's header under mode M into record slot i
template <int M>
__device__ __forceinline__ void parse_header(const Bits128& w, Records& r,
                                             int i) {
  constexpr int n_ep = 2 * (parts(M) + 1);
  constexpr int p_pb = M + 1 + partition_bits(M) + rotation_bits(M)
                     + index_mode_bits(M)
                     + n_ep * (3 * prec(M, 0) + prec(M, 3));
  constexpr int p_idx = p_pb + p_bits(M);
  constexpr int p_idx2 = p_idx + 16 * index_prec(M) - (parts(M) + 1);
  const int shape = (int)get_bits(w, M + 1, partition_bits(M));
  const int rot = (int)get_bits(w, M + 1 + partition_bits(M),
                                rotation_bits(M));
  const int im = (int)get_bits(w, M + 1 + partition_bits(M)
                                      + rotation_bits(M),
                               index_mode_bits(M));
  r.meta[i] = M | shape << 4 | rot << 10 | im << 12;
  const int pbw = (int)get_bits(w, p_pb, p_bits(M));
#pragma unroll
  for (int e = 0; e < n_ep; ++e) {
    const int pb = (pbw >> (e * p_bits(M) / n_ep)) & 1;
    uint32_t word = 0xFF000000u;   // alpha 255 where the mode has none
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (prec(M, c) == 0) continue;
      const int q = (int)get_bits(w, endpoint_pos<M>(c, e), prec(M, c));
      word = (word & ~(0xFFu << (8 * c)))
           | (uint32_t)unquant_channel<M>(q, pb, c) << (8 * c);
    }
    r.ep[e][i] = word;
  }
  r.win[0][i] = dec::window<p_idx>(w);
  if (index_prec2(M)) r.win[1][i] = dec::window<p_idx2>(w);
}

// g_aWeights2/3/4 at a runtime index precision
__device__ __forceinline__ int weight(int k, int bits) {
  return bits == 2 ? pal_weight<4>(k)
       : bits == 3 ? pal_weight<8>(k) : pal_weight<16>(k);
}

// pixel p of the block in record slot i, 0..255 per channel (r, g, b, a)
__device__ __forceinline__ void decode_pixel(const Records& r, int i, int p,
                                             const uint32_t* s_pp,
                                             const uint8_t* s_pa, int px[4]) {
  const int meta = r.meta[i];
  const int m = meta & 15;
  if (m == 8) {   // reserved mode, or past the end: transparent black
    px[0] = px[1] = px[2] = px[3] = 0;
    return;
  }
  const int shape = (meta >> 4) & 63;
  const int ns = parts(m);   // subsets - 1
  int s = 0, a2 = 16, a3 = 16;
  if (ns) {
    const int t = (ns - 1) * 64 + shape;
    s = (int)(s_pp[t] >> (2 * p)) & 3;
    a2 = s_pa[t] & 0xF;
    if (ns == 2) a3 = s_pa[t] >> 4;
  }
  const int ip = index_prec(m), ip2 = index_prec2(m);
  int wc = weight(dec::index_at(r.win[0][i], p, ip, a2, a3), ip);
  int wa = wc;
  if (ip2) {
    wa = weight(dec::index_at(r.win[1][i], p, ip2, 16, 16), ip2);
    if ((meta >> 12) & 1) {
      const int t = wc;
      wc = wa;
      wa = t;
    }
  }
  const uint32_t e0 = r.ep[2 * s][i], e1 = r.ep[2 * s + 1][i];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int wt = c < 3 ? wc : wa;
    px[c] = ((64 - wt) * (int)((e0 >> (8 * c)) & 0xFF)
             + wt * (int)((e1 >> (8 * c)) & 0xFF) + 32) >> 6;
  }
  const int rot = (meta >> 10) & 3;
  if (rot) {
    const int t = px[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (rot == c + 1) {
        px[3] = px[c];
        px[c] = t;
      }
  }
}

template <bool PACKED, int OUT>
__global__ void __launch_bounds__(dec::kThreads, 4)
    bc7_decode_kernel(const uint32_t* __restrict__ src,
                      void* __restrict__ out, int nb, int n_chunks) {
  // shape tables of two and three subsets: subset ids 2 bits a pixel,
  // anchor pixels a nibble each
  __shared__ uint32_t s_pp[2 * 64];
  __shared__ uint8_t s_pa[2 * 64];
  __shared__ Records rec;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    s_pp[i] = c_pp2[i];
    s_pp[64 + i] = c_pp3[i];
    s_pa[i] = c_pa2[i];
    s_pa[64 + i] = c_pa3[i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot0 = warp * 32;   // the warp's records
  for (int chunk = blockIdx.x * dec::kWarps + warp; chunk < n_chunks;
       chunk += gridDim.x * dec::kWarps) {
    const int b0 = chunk * 32;
    // 1. lane i parses block b0 + i
    const int b = b0 + lane;
    int mode = 8;
    Bits128 w;
    if (b < nb) {
      w = dec::load_block<PACKED>(src, nb, b);
      mode = block_mode(w);
    }
    switch (mode) {
      case 0: parse_header<0>(w, rec, slot0 + lane); break;
      case 1: parse_header<1>(w, rec, slot0 + lane); break;
      case 2: parse_header<2>(w, rec, slot0 + lane); break;
      case 3: parse_header<3>(w, rec, slot0 + lane); break;
      case 4: parse_header<4>(w, rec, slot0 + lane); break;
      case 5: parse_header<5>(w, rec, slot0 + lane); break;
      case 6: parse_header<6>(w, rec, slot0 + lane); break;
      case 7: parse_header<7>(w, rec, slot0 + lane); break;
      default: rec.meta[slot0 + lane] = 8;
    }
    __syncwarp();
    // 2. the pixels
    int px[4];
    if (OUT == dec::kF32) {
      // float(c) * f32(1/255): the reference's c * (1/255)
      // (BC6HBC7.cpp:427); 0x3B808081 is float32(1/255). Texels are in
      // 0..255 already (8-bit endpoints, weights 0..64), so the plain
      // version's clamp changes nothing.
      const float k = __int_as_float(0x3B808081);
      const int p = lane & 15;
#pragma unroll 1
      for (int j = 0; j < 16; ++j) {
        const int i = 2 * j + (lane >> 4);   // the chunk's block
        if (b0 + i >= nb) break;
        decode_pixel(rec, slot0 + i, p, s_pp, s_pa, px);
        float4 v;
        v.x = (float)px[0] * k;
        v.y = (float)px[1] * k;
        v.z = (float)px[2] * k;
        v.w = (float)px[3] * k;
        reinterpret_cast<float4*>(out)[(size_t)(b0 + i) * 16 + p] = v;
      }
    } else if (b < nb) {
      int32_t* o = reinterpret_cast<int32_t*>(out);
#pragma unroll 1
      for (int p = 0; p < 16; ++p) {
        decode_pixel(rec, slot0 + lane, p, s_pp, s_pa, px);
#pragma unroll
        for (int c = 0; c < 4; ++c) o[(size_t)(p * 4 + c) * nb + b] = px[c];
      }
    }
    __syncwarp();   // the records are read before the next chunk's
  }
}

template <bool PACKED, int OUT>
int launch(const void* src, void* out, int nb, cudaStream_t stream) {
  static int occupancy = 0;
  auto kernel = bc7_decode_kernel<PACKED, OUT>;
  const int n_chunks = dec::n_chunks(nb);
  const int grid = dec::persistent_grid(kernel, &occupancy, n_chunks);
  kernel<<<grid, dec::kThreads, 0, stream>>>((const uint32_t*)src, out, nb,
                                             n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace bc7

// f32: 1 = packed blocks [NB, 16] u8 -> f32 [NB, 16, 4];
//      0 = words [4, NB] u32 -> texels [64, NB] int32
extern "C" int bc7_decode_launch(const void* src, void* out, int nb, int f32,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return f32 ? bc7::launch<true, dec::kF32>(src, out, nb, s)
             : bc7::launch<false, dec::kPlanes>(src, out, nb, s);
}
