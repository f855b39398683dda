// Candidate selection of the staged fast render path in one kernel:
// distances from the bf16 relative xyz, validity / radius / layered-shell
// masks, the K nearest candidates with smallest-column tie-break, and
// the extraction of their payload rows. Output per slot: the K selected
// payloads nsel [M, K, 48] (bf16 bits passed through, zero for unfilled
// k) and the neighbour mask pmask [M, K].
//
// Replaces the Pallas kernel pointnerf2studio_tpu/ops/fused_select.py::
// _select_kernel (fused_candidate_select).
//
// What bounds it on Hopper: device-memory bytes. A valid slot needs its
// 64 metas, the 3 xyz channels of its 64 candidates and the 48 channels
// of each selected neighbour out of a 6.4 KB candidate row, and writes
// K * 48 bf16 + K bytes; the arithmetic is a few hundred float ops. The
// TPU kernel consumed an XLA-gathered [M, 48, C] block and extracted
// each payload with a one-hot contraction on the MXU, writing f32. Here:
//   * the kernel reads kmeta/kpay rows in place through qslot, so the
//     gathered block never exists in device memory;
//   * one warp per slot holds the candidates, two per lane, and finds
//     the K nearest by K rounds of a shuffle arg-min on (d2, column) -
//     lax.top_k's order, smallest column first among equal distances;
//   * the extract is a plain load: lane c reads channel c (and c + 32)
//     of the chosen column and stores it, so the payload keeps its bf16
//     bits and the output is bf16, half the reference's f32 bytes.
// masks, radius test and tie-breaks must equal the plain version bit for
// bit, so this file is compiled with -fmad=false: d2 = dx*dx + dy*dy +
// dz*dz rounds every multiply and add separately, in that order.
// A slot whose mask is false writes zeros and an all-false pmask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;    // slots per block, one warp each
constexpr int kKMax = 8;
constexpr int kPK = 48;      // payload channels
constexpr int kCMax = 64;    // candidates per slot

__global__ void __launch_bounds__(kWarps * 32)
fused_select_kernel(const int32_t* __restrict__ kmeta,
                    const bf16* __restrict__ kpay,
                    const int32_t* __restrict__ qslot,
                    const float* __restrict__ cd0,
                    const uint8_t* __restrict__ mask,
                    bf16* __restrict__ nsel, uint8_t* __restrict__ pmask,
                    int M, int C, int K, float radius2, int num_shells) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;  // whole warps exit together
  bf16* out = nsel + (size_t)m * K * kPK;
  int nk = 0;
  if (mask[m] != 0) {
    const int q = qslot[m];
    const float c0 = cd0[(size_t)m * 3 + 0], c1 = cd0[(size_t)m * 3 + 1],
                c2 = cd0[(size_t)m * 3 + 2];
    const int32_t* meta_row = kmeta + (size_t)q * C;
    const bf16* pay_row = kpay + (size_t)q * kPK * C;
    float key[2];
    int shell[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      ok[h] = false;
      shell[h] = 0;
      key[h] = CUDART_INF_F;
      if (c < C) {
        const int32_t meta = meta_row[c];
        const float dx = __bfloat162float(pay_row[0 * C + c]) + c0;
        const float dy = __bfloat162float(pay_row[1 * C + c]) + c1;
        const float dz = __bfloat162float(pay_row[2 * C + c]) + c2;
        const float d2 = dx * dx + dy * dy + dz * dz;
        ok[h] = meta >= 0 && (radius2 <= 0.f || d2 <= radius2);
        shell[h] = meta & 3;
        key[h] = d2;
      }
    }
    if (num_shells > 1) {
      // layered eligibility: shell s is searchable only while fewer
      // than K candidates were accepted in shells < s
      bool elig[2] = {shell[0] == 0, shell[1] == 0};
      int before = 0;
      for (int s = 1; s < num_shells; ++s) {
        before += __popc(__ballot_sync(0xffffffffu,
                                       ok[0] && shell[0] == s - 1)) +
                  __popc(__ballot_sync(0xffffffffu,
                                       ok[1] && shell[1] == s - 1));
        elig[0] = elig[0] || (shell[0] == s && before < K);
        elig[1] = elig[1] || (shell[1] == s && before < K);
      }
      ok[0] = ok[0] && elig[0];
      ok[1] = ok[1] && elig[1];
    }
    key[0] = ok[0] ? key[0] : CUDART_INF_F;
    key[1] = ok[1] ? key[1] : CUDART_INF_F;

    for (int k = 0; k < K; ++k) {
      float bk = key[0];
      int bc = lane;
      if (key[1] < bk) {
        bk = key[1];
        bc = lane + 32;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ok2 = __shfl_xor_sync(0xffffffffu, bk, o);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
        if (ok2 < bk || (ok2 == bk && oc < bc)) {
          bk = ok2;
          bc = oc;
        }
      }
      if (!(bk < CUDART_INF_F)) break;  // warp-uniform: no candidate left
      if (bc == lane) key[0] = CUDART_INF_F;
      if (bc == lane + 32) key[1] = CUDART_INF_F;
      // extract: channel `lane` and `lane + 32` of column bc
      out[k * kPK + lane] = pay_row[lane * C + bc];
      if (lane < kPK - 32)
        out[k * kPK + 32 + lane] = pay_row[(32 + lane) * C + bc];
      nk = k + 1;
    }
  }
  const bf16 zero = __float2bfloat16(0.f);
  for (int k = nk; k < K; ++k) {
    out[k * kPK + lane] = zero;
    if (lane < kPK - 32) out[k * kPK + 32 + lane] = zero;
  }
  // min-extraction takes the valid candidates first: the mask is a prefix
  if (lane < K) pmask[(size_t)m * K + lane] = lane < nk;
}

}  // namespace

extern "C" int fused_candidate_select(const void* kmeta, const void* kpay,
                                      const void* qslot, const void* cd0,
                                      const void* mask, void* nsel,
                                      void* pmask, int M, int C, int K,
                                      float radius2, int num_shells,
                                      void* stream) {
  if (C < 1 || C > kCMax || K < 1 || K > kKMax)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const int blocks = (M + kWarps - 1) / kWarps;
  fused_select_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)kmeta, (const bf16*)kpay, (const int32_t*)qslot,
      (const float*)cd0, (const uint8_t*)mask, (bf16*)nsel,
      (uint8_t*)pmask, M, C, K, radius2, num_shells);
  return (int)cudaGetLastError();
}
