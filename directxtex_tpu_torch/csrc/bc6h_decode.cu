// K4 — BC6H decode: a lane a block for the header, a lane a pixel for the
// f32 output (decode_lanes.cuh).
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc6h_decode_pallas /
// _bc6h_decode_kernel. The TPU kernel decoded every block under all 14 mode
// rows over [16, T] planes and selected per block. Here lane i of a warp
// maps block i's header to its mode row (ms_aModeToInfo) and walks that
// row's runs of header bits (BC6HBC7.cpp:879-1049) into its fields, then
// sign-extends, inverse-transforms and unquantizes every region's
// endpoints into a record in shared memory. The pixel phase is the same
// code for every row: a lane reads its block's record, takes its pixel's
// region from the shape table and its index at a closed-form position
// (dec::index_at), interpolates, applies FinishUnquantize and forms the
// F16 bits. Plain twins: bc6h._bc6h_decode_plain (the words API: half bit
// patterns [48, NB] int32, row = pixel * 3 + channel, reserved modes 0)
// and bc6h._bc6h_decode_f32_plain (decode_bc6h's [NB, 16, 4] f32, alpha
// 1); bit-exact against both and against tests/golden/decode_vectors.npz
// (integer math, then an exact half -> f32 conversion).
//
// Bound: bytes. A block reads 16 bytes and writes 256 (f32 [NB, 16, 4])
// or 192 (the words API's int32 planes) against 598-1,444 operations for
// its own row (tests/test_torch_op_counts.py). The header is the costly
// part (up to 25 runs a row): one warp instruction walks 32 blocks' runs,
// from tables staged in shared memory (no per-lane constant-cache reads),
// and the 16 pixels of a block share its record. Signed and unsigned are
// one launch argument, each its own instance.
#include <cuda_fp16.h>

#include "bc6h_common.cuh"
#include "decode_lanes.cuh"

namespace bc6h {

// a warp's block records in shared memory, one slot a lane of the CTA
struct Records {
  int meta[dec::kThreads];           // mode row | shape << 8; row -1: black
  int u[12][dec::kThreads];          // unquantized endpoint (region r,
                                     // end e, channel c) at 6r + 3e + c
  unsigned long long hi[dec::kThreads];  // the block's bits 64..127
};

// the 13 header fields (ids 2..14: shape, then endpoint e of region r,
// channel c at 1 + 4c + 2r + e) of a block, from its row's runs
__device__ __forceinline__ void walk_runs(const Bits128& w,
                                          const uint32_t* runs, int fld[13]) {
#pragma unroll
  for (int j = 0; j < 13; ++j) fld[j] = 0;
#pragma unroll 1
  for (int k = 0; k < kMaxRuns; ++k) {
    const uint32_t r = runs[k];
    if (r == 0u) break;
    const int v = (int)dec::bits_at(w, (r >> 8) & 0xFF, (r >> 16) & 0xF)
                  << ((r >> 4) & 0xF);
#pragma unroll
    for (int j = 0; j < 13; ++j)
      if ((int)(r & 0xF) == j + 2) fld[j] |= v;
  }
}

// endpoint value of a delta field: sign extension, inverse transform
// against the base endpoint e00 (TransformInverse :1153)
template <bool SGN>
__device__ __forceinline__ int delta_field(int v, int bits, const ModeInfo& m,
                                           int e00) {
  if (SGN || m.transformed) v = sext(v, bits);
  if (m.transformed) {
    v = (v + e00) & ((1 << m.prec_w) - 1);
    if (SGN) v = sext(v, m.prec_w);
  }
  return v;
}

// block w (mode row `row`) into record slot i
template <bool SGN>
__device__ __forceinline__ void parse_header(const Bits128& w, int row,
                                             const uint32_t* s_runs,
                                             const ModeInfo* s_info,
                                             Records& r, int i) {
  int fld[13];
  walk_runs(w, s_runs + row * kMaxRuns, fld);
  const ModeInfo& m = s_info[row];
  r.meta[i] = row | fld[0] << 8;
  r.hi[i] = w.hi;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int e00 = SGN ? sext(fld[1 + 4 * c], m.prec_w) : fld[1 + 4 * c];
    r.u[c][i] = unquantize(e00, m.prec_w, SGN);
    r.u[3 + c][i] = unquantize(
        delta_field<SGN>(fld[2 + 4 * c], m.prec_x[c], m, e00), m.prec_w, SGN);
    if (m.parts) {
      r.u[6 + c][i] = unquantize(
          delta_field<SGN>(fld[3 + 4 * c], m.prec_y[c], m, e00), m.prec_w,
          SGN);
      r.u[9 + c][i] = unquantize(
          delta_field<SGN>(fld[4 + 4 * c], m.prec_z[c], m, e00), m.prec_w,
          SGN);
    }
  }
}

// pixel p of the block in record slot i: F16 bit patterns (r, g, b)
template <bool SGN>
__device__ __forceinline__ void decode_pixel(const Records& r, int i, int p,
                                             const ModeInfo* s_info,
                                             const uint32_t* s_pp,
                                             const uint8_t* s_pa,
                                             int bits[3]) {
  const int meta = r.meta[i];
  const int row = meta & 0xFF;
  if (row == 0xFF) {   // reserved mode, or past the end: black
    bits[0] = bits[1] = bits[2] = 0;
    return;
  }
  const ModeInfo& m = s_info[row];
  const int shape = (meta >> 8) & 63;
  const int reg = m.parts ? (int)(s_pp[shape] >> (2 * p)) & 1 : 0;
  const int a2 = m.parts ? (s_pa[shape] & 0xF) : 16;
  // the indices start at bit 82 (two regions) or 65 (one): all in hi
  const int k = dec::index_at(r.hi[i] >> (m.parts ? 82 - 64 : 65 - 64), p,
                              m.iprec, a2, 16);
  const int wt = m.iprec == 3 ? pal_weight<8>(k) : pal_weight<16>(k);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int u0 = r.u[6 * reg + c][i], u1 = r.u[6 * reg + 3 + c][i];
    const int comp = finish((u0 * (64 - wt) + u1 * wt + 32) >> 6, SGN);
    if (SGN) {
      const int mag = abs(comp) & 0x7FFF;
      bits[c] = comp < 0 ? (mag | 0x8000) : mag;
    } else {
      bits[c] = comp & 0xFFFF;
    }
  }
}

template <bool PACKED, int OUT, bool SGN>
__global__ void __launch_bounds__(dec::kThreads, 4)
    bc6h_decode_kernel(const uint32_t* __restrict__ src,
                       void* __restrict__ out, int nb, int n_chunks) {
  __shared__ uint32_t s_runs[14 * kMaxRuns];
  __shared__ ModeInfo s_info[14];
  __shared__ int8_t s_row[32];
  __shared__ uint32_t s_pp[64];
  __shared__ uint8_t s_pa[64];
  __shared__ Records rec;
  for (int i = threadIdx.x; i < 14 * kMaxRuns; i += blockDim.x)
    s_runs[i] = c_runs[i / kMaxRuns][i % kMaxRuns];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    if (i < 14) s_info[i] = c_info[i];
    if (i < 32) s_row[i] = c_mode_to_row[i];
    s_pp[i] = bc7::c_pp2[i];
    s_pa[i] = bc7::c_pa2[i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot0 = warp * 32;   // the warp's records
  for (int chunk = blockIdx.x * dec::kWarps + warp; chunk < n_chunks;
       chunk += gridDim.x * dec::kWarps) {
    const int b0 = chunk * 32;
    // 1. lane i parses block b0 + i
    const int b = b0 + lane;
    int row = -1;
    Bits128 w;
    if (b < nb) {
      w = dec::load_block<PACKED>(src, nb, b);
      const int b5 = (int)(w.lo & 0x1Fu);
      row = s_row[(b5 & 3) < 2 ? (b5 & 3) : b5];
    }
    if (row >= 0)
      parse_header<SGN>(w, row, s_runs, s_info, rec, slot0 + lane);
    else
      rec.meta[slot0 + lane] = 0xFF;
    __syncwarp();
    // 2. the pixels
    int bits[3];
    if (OUT == dec::kF32) {
      const int p = lane & 15;
#pragma unroll 1
      for (int j = 0; j < 16; ++j) {
        const int i = 2 * j + (lane >> 4);   // the chunk's block
        if (b0 + i >= nb) break;
        decode_pixel<SGN>(rec, slot0 + i, p, s_info, s_pp, s_pa, bits);
        float4 v;
        v.x = __half2float(__ushort_as_half((unsigned short)bits[0]));
        v.y = __half2float(__ushort_as_half((unsigned short)bits[1]));
        v.z = __half2float(__ushort_as_half((unsigned short)bits[2]));
        v.w = 1.0f;
        reinterpret_cast<float4*>(out)[(size_t)(b0 + i) * 16 + p] = v;
      }
    } else if (b < nb) {
      int32_t* o = reinterpret_cast<int32_t*>(out);
#pragma unroll 1
      for (int p = 0; p < 16; ++p) {
        decode_pixel<SGN>(rec, slot0 + lane, p, s_info, s_pp, s_pa, bits);
#pragma unroll
        for (int c = 0; c < 3; ++c) o[(size_t)(p * 3 + c) * nb + b] = bits[c];
      }
    }
    __syncwarp();   // the records are read before the next chunk's
  }
}

template <bool PACKED, int OUT, bool SGN>
int launch(const void* src, void* out, int nb, cudaStream_t stream) {
  static int occupancy = 0;
  auto kernel = bc6h_decode_kernel<PACKED, OUT, SGN>;
  const int n_chunks = dec::n_chunks(nb);
  const int grid = dec::persistent_grid(kernel, &occupancy, n_chunks);
  kernel<<<grid, dec::kThreads, 0, stream>>>((const uint32_t*)src, out, nb,
                                             n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace bc6h

// f32: 1 = packed blocks [NB, 16] u8 -> f32 [NB, 16, 4];
//      0 = words [4, NB] u32 -> half bits [48, NB] int32
extern "C" int bc6h_decode_launch(const void* src, void* out, int nb, int sgn,
                                  int f32, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (f32)
    return sgn ? bc6h::launch<true, dec::kF32, true>(src, out, nb, s)
               : bc6h::launch<true, dec::kF32, false>(src, out, nb, s);
  return sgn ? bc6h::launch<false, dec::kPlanes, true>(src, out, nb, s)
             : bc6h::launch<false, dec::kPlanes, false>(src, out, nb, s);
}
