// K1 — BC7 decode, one thread per 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc7_decode_pallas /
// _bc7_decode_kernel. The TPU kernel decoded every block under all 8 modes
// over [16, T] planes and selected per block, since its vector unit cannot
// branch per lane; here each thread reads its block's mode (lowest set bit
// of byte 0) and runs that mode's decode alone. Plain twin:
// bc67._bc7_decode_plain; bit-exact against it and against
// tests/golden/decode_vectors.npz (integer math only).
//
// Bound: operations and bytes, close together. Each block reads 16 bytes
// and needs 64 out (u8 texels; written here as int32, row by row and
// coalesced) against 518-1,557 integer operations for its own mode
// (tests/test_torch_op_counts.py); the design keeps the whole decode in
// registers and touches device memory once per input and output word.
#include "bc7_common.cuh"

namespace bc7 {

template <int M>
__device__ __forceinline__ void decode_mode(const Bits128& w,
                                            int32_t* __restrict__ out, int nb,
                                            int b) {
  constexpr int n_sub = parts(M) + 1;
  constexpr int n_ep = 2 * n_sub;
  int pos = M + 1;
  const int shape = get_bits(w, pos, partition_bits(M));
  pos += partition_bits(M);
  const int rot = get_bits(w, pos, rotation_bits(M));
  pos += rotation_bits(M);
  const int im = get_bits(w, pos, index_mode_bits(M));
  pos += index_mode_bits(M);

  int ep[n_ep][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < n_ep; ++e) {
      if (prec(M, c) == 0) {
        ep[e][c] = 255;
      } else {
        ep[e][c] = get_bits(w, pos, prec(M, c));
        pos += prec(M, c);
      }
    }
  }
  if (p_bits(M)) {
    int pb[p_bits(M) > 0 ? p_bits(M) : 1];
#pragma unroll
    for (int j = 0; j < p_bits(M); ++j) pb[j] = get_bits(w, pos + j, 1);
    pos += p_bits(M);
#pragma unroll
    for (int e = 0; e < n_ep; ++e) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (prec(M, c) != prec_p(M, c))
          ep[e][c] = (ep[e][c] << 1) | pb[e * p_bits(M) / n_ep];
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (prec_p(M, c) == 0 || prec_p(M, c) >= 8) continue;
#pragma unroll
    for (int e = 0; e < n_ep; ++e) ep[e][c] = unquantize(ep[e][c], prec_p(M, c));
  }

  uint32_t pp = 0;
  int a2 = -1, a3 = -1;
  if (parts(M) == 1) {
    pp = c_pp2[shape];
    a2 = c_pa2[shape] & 0xF;
  } else if (parts(M) == 2) {
    pp = c_pp3[shape];
    a2 = c_pa3[shape] & 0xF;
    a3 = c_pa3[shape] >> 4;
  }
  int w1[16], w2[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = index_prec(M) - ((i == 0 || i == a2 || i == a3) ? 1 : 0);
    w1[i] = get_bits(w, pos, n);
    pos += n;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (index_prec2(M)) {
      const int n = index_prec2(M) - (i == 0 ? 1 : 0);
      w2[i] = get_bits(w, pos, n);
      pos += n;
    } else {
      w2[i] = w1[i];
    }
  }

  constexpr int K1 = 1 << index_prec(M);
  constexpr int K2 = index_prec2(M) ? 1 << index_prec2(M) : K1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int s = (pp >> (2 * i)) & 3;
    int wc = pal_weight<K1>(w1[i]);
    int wa = wc;
    if (index_prec2(M)) {
      wa = pal_weight<K2>(w2[i]);
      if (im == 1) {
        const int t = wc;
        wc = wa;
        wa = t;
      }
    }
    int px[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int e0 = ep[0][c], e1 = ep[1][c];
#pragma unroll
      for (int sv = 1; sv < n_sub; ++sv) {
        if (s == sv) {
          e0 = ep[2 * sv][c];
          e1 = ep[2 * sv + 1][c];
        }
      }
      const int wt = c < 3 ? wc : wa;
      px[c] = ((64 - wt) * e0 + wt * e1 + 32) >> 6;
    }
    if (rotation_bits(M) && rot) {
      const int t = px[rot - 1];
      px[rot - 1] = px[3];
      px[3] = t;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(i * 4 + c) * nb + b] = px[c];
  }
}

__global__ void __launch_bounds__(kThreads)
    bc7_decode_kernel(const uint32_t* __restrict__ words,
                      int32_t* __restrict__ out, int nb) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const Bits128 w = load_words(words, nb, b);
  switch (block_mode(w)) {
    case 0: decode_mode<0>(w, out, nb, b); break;
    case 1: decode_mode<1>(w, out, nb, b); break;
    case 2: decode_mode<2>(w, out, nb, b); break;
    case 3: decode_mode<3>(w, out, nb, b); break;
    case 4: decode_mode<4>(w, out, nb, b); break;
    case 5: decode_mode<5>(w, out, nb, b); break;
    case 6: decode_mode<6>(w, out, nb, b); break;
    case 7: decode_mode<7>(w, out, nb, b); break;
    default:   // reserved mode: transparent black (BC6HBC7.cpp:2781)
#pragma unroll
      for (int r = 0; r < 64; ++r) out[r * nb + b] = 0;
  }
}

}  // namespace bc7

extern "C" int bc7_decode_launch(const void* words, void* out, int nb,
                                 void* stream) {
  const int grid = (nb + bc7::kThreads - 1) / bc7::kThreads;
  bc7::bc7_decode_kernel<<<grid, bc7::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int32_t*)out, nb);
  return (int)cudaGetLastError();
}
