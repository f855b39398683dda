// The K-nearest-candidate selection that csrc/fused_select.cu and
// chunk_select_kernel of csrc/fused_chunk.cu share: per shading slot, d2
// of its C candidates from their bf16 relative xyz plus (centre - locs),
// the valid / radius / layered-shell masks, and K rounds of an arg-min
// on (d2, column) - lax.top_k's order, smallest column first among equal
// distances.
//
// The cache holds, per query voxel q (models/fast_render.py::FatCache):
//   kmeta [max_q, C]     int32  pidx * 4 + shell, -1 for an empty column
//   kxyz  [max_q, 3, C]  bf16   the relative-xyz planes: the distance pass
//                               wants all C candidates of one axis in a row
//   kcand [max_q, C, PK] bf16   candidate-major payload: the 48 channels of
//                               one candidate are 96 contiguous bytes, three
//                               whole 32-byte sectors, so a chosen neighbour
//                               is read with 16-byte loads
//
// Thread shape: eight lanes serve one slot and hold its (at most) 64
// candidates, eight consecutive columns a lane, so a lane's metas are two
// 16-byte loads and each of its xyz planes one; a warp selects for four
// slots in lockstep. A round's arg-min is seven compares in registers and
// three shuffle levels inside the 8-lane group.
//
// Every function here is called by all 32 lanes of a warp (the shuffles
// name the full mask); `act` says whether the lane's slot takes part.
// The arithmetic must equal the plain version's bit for bit (masks,
// radius test, tie-breaks): the including source is compiled with
// -fmad=false, and d2 = dx*dx + dy*dy + dz*dz rounds every multiply and
// add separately, in that order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace knn {

constexpr int kPK = 48;     // payload channels of a candidate
constexpr int kCMax = 64;   // candidates per slot at most
constexpr int kKMax = 8;    // neighbours per slot at most
constexpr int kGroup = 8;   // lanes per slot; each holds 8 candidates

// the two bf16 values of a 32-bit word, exactly
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// key[i] = d2 of column l * 8 + i where that candidate may be chosen,
// +inf elsewhere; px[a][i] its relative xyz (0 where there is no column).
// cl = centre - locs of the slot.
__device__ __forceinline__ void candidate_keys(
    const int32_t* __restrict__ kmeta,
    const __nv_bfloat16* __restrict__ kxyz, int q, int C, int K, int l,
    bool act, float cl0, float cl1, float cl2, float radius2, int num_shells,
    float (&key)[8], float (&px)[3][8]) {
  int shell[8];
  bool ok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    key[i] = CUDART_INF_F;
    shell[i] = 0;
    ok[i] = false;
    px[0][i] = px[1][i] = px[2][i] = 0.f;
  }
  if (act) {
    const int32_t* meta_row = kmeta + (size_t)q * C;
    const __nv_bfloat16* xyz_row = kxyz + (size_t)q * 3 * C;
    alignas(16) int32_t meta[8];
    if ((C & 7) == 0) {   // rows and planes are 16-byte aligned
      if (l * 8 < C) {
        *(int4*)&meta[0] = *(const int4*)(meta_row + l * 8);
        *(int4*)&meta[4] = *(const int4*)(meta_row + l * 8 + 4);
        uint4 v[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          v[a] = *(const uint4*)(xyz_row + a * C + l * 8);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const uint32_t w[4] = {v[a].x, v[a].y, v[a].z, v[a].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            px[a][2 * i] = bf_lo(w[i]);
            px[a][2 * i + 1] = bf_hi(w[i]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) meta[i] = -1;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = l * 8 + i;
        meta[i] = c < C ? meta_row[c] : -1;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          px[a][i] = c < C ? __bfloat162float(xyz_row[a * C + c]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dx = px[0][i] + cl0, dy = px[1][i] + cl1,
                  dz = px[2][i] + cl2;
      const float d2 = dx * dx + dy * dy + dz * dz;
      ok[i] = l * 8 + i < C && meta[i] >= 0 &&
              (radius2 <= 0.f || d2 <= radius2);
      shell[i] = meta[i] & 3;
      key[i] = d2;
    }
  }
  if (num_shells > 1) {
    // layered eligibility: shell s is searchable only while fewer
    // than K candidates were accepted in shells < s
    bool elig[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) elig[i] = shell[i] == 0;
    int before = 0;
    for (int sh = 1; sh < num_shells; ++sh) {
      int n = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) n += ok[i] && shell[i] == sh - 1;
      n += __shfl_xor_sync(0xffffffffu, n, 1);
      n += __shfl_xor_sync(0xffffffffu, n, 2);
      n += __shfl_xor_sync(0xffffffffu, n, 4);
      before += n;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        elig[i] = elig[i] || (shell[i] == sh && before < K);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) ok[i] = ok[i] && elig[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) key[i] = ok[i] ? key[i] : CUDART_INF_F;
}

// The smallest (d2, column) of the slot's candidates, the same in all
// eight lanes of its group; bk is +inf when no candidate is left.
__device__ __forceinline__ void group_argmin(const float (&key)[8], int l,
                                             float& bk, int& bc) {
  bk = key[0];
  bc = l * 8;
#pragma unroll
  for (int i = 1; i < 8; ++i)
    if (key[i] < bk) {
      bk = key[i];
      bc = l * 8 + i;
    }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    const float ok2 = __shfl_xor_sync(0xffffffffu, bk, o);
    const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
    if (ok2 < bk || (ok2 == bk && oc < bc)) {
      bk = ok2;
      bc = oc;
    }
  }
}

}  // namespace knn
