// K4 — BC6H decode, one thread per 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc6h_decode_pallas /
// _bc6h_decode_kernel. The TPU kernel decoded every block under all 14 mode
// rows over [16, T] planes and selected per block; here each thread maps
// its header to its mode row (ms_aModeToInfo) and runs that row's decode
// alone: header runs -> endpoints (sign extension, inverse delta
// transform), Unquantize, the 16 interpolations, FinishUnquantize and
// INT2F16. Output: half bit patterns [48, NB] int32, row = pixel * 3 +
// channel; reserved modes give 0. Plain twin: bc6h._bc6h_decode_plain;
// bit-exact against it and against tests/golden/decode_vectors.npz
// (integer math only).
//
// Bound: operations, narrowly. A block reads 16 bytes and needs 96 out
// (48 halves; written here as int32) against 598-1,444 elementwise
// operations for its own mode row (tests/test_torch_op_counts.py); the
// TPU twin ran all 14 rows. The design branches to the block's own row,
// keeps the header fields and endpoints in registers, and writes each
// output row with neighbouring threads on neighbouring addresses.
#include "bc6h_common.cuh"

namespace bc6h {

__global__ void __launch_bounds__(kThreads)
    bc6h_decode_kernel(const uint32_t* __restrict__ words,
                       int32_t* __restrict__ out, int nb, int sgn_i) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const bool sgn = sgn_i != 0;
  const Bits128 w = bc7::load_words(words, nb, b);
  const int row = mode_row(w);
  if (row < 0) {   // reserved mode: black
#pragma unroll 4
    for (int r = 0; r < 48; ++r) out[r * nb + b] = 0;
    return;
  }
  const ModeInfo& m = c_info[row];
  int e[2][2][3];
  const int shape = unpack(w, row, sgn, e);
  int u[2][2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c) u[r][k][c] = unquantize(e[r][k][c], m.prec_w, sgn);
  const uint32_t pp = m.parts ? bc7::c_pp2[shape] : 0u;
  const int a2 = m.parts ? (bc7::c_pa2[shape] & 0xF) : -1;
  const unsigned long long idx = read_indices(w, row, a2);
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int k = idx_at(idx, i);
    const int wt = m.iprec == 3 ? pal_weight<8>(k) : pal_weight<16>(k);
    const int reg = (pp >> (2 * i)) & 1u;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int e0 = reg ? u[1][0][c] : u[0][0][c];
      const int e1 = reg ? u[1][1][c] : u[0][1][c];
      const int comp = finish((e0 * (64 - wt) + e1 * wt + 32) >> 6, sgn);
      int bits;
      if (sgn) {
        const int mag = abs(comp) & 0x7FFF;
        bits = comp < 0 ? (mag | 0x8000) : mag;
      } else {
        bits = comp & 0xFFFF;
      }
      out[(i * 3 + c) * nb + b] = bits;
    }
  }
}

}  // namespace bc6h

extern "C" int bc6h_decode_launch(const void* words, void* out, int nb,
                                  int sgn, void* stream) {
  const int grid = (nb + bc6h::kThreads - 1) / bc6h::kThreads;
  bc6h::bc6h_decode_kernel<<<grid, bc6h::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int32_t*)out, nb, sgn);
  return (int)cudaGetLastError();
}
