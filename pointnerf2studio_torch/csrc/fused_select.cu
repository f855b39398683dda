// Candidate selection of the staged fast render path in one kernel:
// distances from the bf16 relative xyz, validity / radius / layered-shell
// masks, the K nearest candidates with smallest-column tie-break, and
// the extraction of their payload rows. Output per slot: the K selected
// payloads nsel [M, K, 48] (bf16 bits passed through, zero for unfilled
// k) and the neighbour mask pmask [M, K].
//
// Replaces the Pallas kernel pointnerf2studio_tpu/ops/fused_select.py::
// _select_kernel (fused_candidate_select). Two entry points: the tuned
// fused_candidate_select (C <= 64, K <= 8: eight lanes a slot) and
// fused_candidate_select_any (C <= 256, K <= 32: 16 lanes a slot up to
// C 128 and K 16, a whole warp beyond), one kernel template on the group
// width, the same order and arithmetic.
//
// What bounds it on Hopper: device-memory bytes. A valid slot needs its
// 64 metas, the 3 xyz values of its 64 candidates and the 48 channels
// of each selected neighbour, and writes K * 48 bf16 + K bytes; the
// arithmetic is a few hundred float ops. The TPU kernel consumed an
// XLA-gathered channel-major [M, 48, C] block (channels on the sublane
// axis) and extracted each payload with a one-hot contraction on the MXU,
// writing f32. On this card a load moves whole 32-byte sectors, so the
// cache is laid out for that (csrc/select.cuh):
//   * the kernel reads the cache rows in place through qslot, so the
//     gathered block never exists in device memory;
//   * the distance pass reads kmeta and the three kxyz planes as 16-byte
//     loads, eight lanes a slot, four slots a warp, and finds the K
//     nearest by K rounds of the arg-min of select.cuh;
//   * the payload is candidate-major (kcand [max_q, C, 48]): a chosen
//     neighbour is 96 contiguous bytes, three sectors, where the
//     channel-major layout cost one sector for each 2-byte channel. The
//     slot's K rows are K * 6 pieces of 16 bytes; the group's eight lanes
//     take them in turn, so each load and each store of a warp covers four
//     runs of 128 contiguous bytes, and all of a lane's loads are started
//     before its first store. The payload keeps its bf16 bits and the
//     output is bf16, half the reference's f32 bytes.
// Masks, radius test and tie-breaks must equal the plain version bit for
// bit, so this file is compiled with -fmad=false (see select.cuh).
// A slot whose mask is false writes zeros and an all-false pmask.

#include "select.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;                     // 16 slots a block at G 8
constexpr int kPieces = knn::kPK * 2 / 16;        // 16-byte pieces of a row

// G lanes a slot, at most 8 G candidates and G neighbours
template <int G>
__global__ void __launch_bounds__(kThreads)
fused_select_kernel(const int32_t* __restrict__ kmeta,
                    const bf16* __restrict__ kcand,
                    const bf16* __restrict__ kxyz,
                    const int32_t* __restrict__ qslot,
                    const float* __restrict__ cd0,
                    const uint8_t* __restrict__ mask,
                    bf16* __restrict__ nsel, uint8_t* __restrict__ pmask,
                    int M, int C, int K, float radius2, int num_shells) {
  constexpr int kSlotsPerBlock = kThreads / G;
  constexpr int kTurns = kPieces;   // G neighbours x 6 pieces over G lanes
  const int lane = threadIdx.x & 31, l = lane & (G - 1),
            gbase = lane & ~(G - 1);
  const int j = blockIdx.x * kSlotsPerBlock + (int)threadIdx.x / G;
  const int m = min(j, M - 1);
  const bool act = j < M && mask[m] != 0;   // uniform in the group
  int q = 0;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  if (act) {
    q = qslot[m];
    c0 = cd0[(size_t)m * 3 + 0];
    c1 = cd0[(size_t)m * 3 + 1];
    c2 = cd0[(size_t)m * 3 + 2];
  }
  float key[8], px[3][8];
  knn::candidate_keys<G>(kmeta, kxyz, q, C, K, l, act, c0, c1, c2, radius2,
                         num_shells, key, px);

  // K rounds; lane k of the group keeps neighbour k's column
  int nk = 0, my_c = 0;
  for (int k = 0; k < K; ++k) {
    float bk;
    int bc;
    knn::group_argmin<G>(key, l, bk, bc);
    // group-uniform; once false it stays false (no key is left)
    const bool got = bk < CUDART_INF_F;
    if (!__any_sync(0xffffffffu, got)) break;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (bc == l * 8 + i) key[i] = CUDART_INF_F;
    if (got) {
      nk = k + 1;
      if (l == k) my_c = bc;
    }
  }

  // extract: piece p = l + G t of the slot's K * 6 pieces is piece p % 6
  // of neighbour p / 6; zeros past the count
  const uint4* rows = (const uint4*)(kcand + (size_t)q * C * knn::kPK);
  uint4 v[kTurns];
#pragma unroll
  for (int t = 0; t < kTurns; ++t) {
    const int p = l + G * t;
    const int k = min(p / kPieces, G - 1);
    const int c = __shfl_sync(0xffffffffu, my_c, gbase | k);
    v[t] = make_uint4(0u, 0u, 0u, 0u);
    if (k < nk) v[t] = rows[c * kPieces + p % kPieces];
  }
  if (j < M) {
    uint4* out = (uint4*)(nsel + (size_t)m * K * knn::kPK);
#pragma unroll
    for (int t = 0; t < kTurns; ++t) {
      const int p = l + G * t;
      if (p < K * kPieces) out[p] = v[t];
    }
    // min-extraction takes the valid candidates first: the mask is a prefix
    if (l < K) pmask[(size_t)m * K + l] = l < nk;
  }
}

template <int G>
int launch(const void* kmeta, const void* kcand, const void* kxyz,
           const void* qslot, const void* cd0, const void* mask, void* nsel,
           void* pmask, int M, int C, int K, float radius2, int num_shells,
           void* stream) {
  if (M <= 0) return 0;
  const int per_block = kThreads / G;
  fused_select_kernel<G><<<(M + per_block - 1) / per_block, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)kmeta, (const bf16*)kcand, (const bf16*)kxyz,
      (const int32_t*)qslot, (const float*)cd0, (const uint8_t*)mask,
      (bf16*)nsel, (uint8_t*)pmask, M, C, K, radius2, num_shells);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_candidate_select(const void* kmeta, const void* kcand,
                                      const void* kxyz, const void* qslot,
                                      const void* cd0, const void* mask,
                                      void* nsel, void* pmask, int M, int C,
                                      int K, float radius2, int num_shells,
                                      void* stream) {
  if (C < 1 || C > knn::kCMax || K < 1 || K > knn::kKMax)
    return (int)cudaErrorInvalidValue;
  return launch<8>(kmeta, kcand, kxyz, qslot, cd0, mask, nsel, pmask, M, C,
                   K, radius2, num_shells, stream);
}

// any C <= 256 and K <= 32: 16 lanes a slot up to C 128 and K 16,
// 32 beyond
extern "C" int fused_candidate_select_any(
    const void* kmeta, const void* kcand, const void* kxyz, const void* qslot,
    const void* cd0, const void* mask, void* nsel, void* pmask, int M, int C,
    int K, float radius2, int num_shells, void* stream) {
  if (C < 1 || C > 256 || K < 1 || K > 32)
    return (int)cudaErrorInvalidValue;
  if (C <= 128 && K <= 16)
    return launch<16>(kmeta, kcand, kxyz, qslot, cd0, mask, nsel, pmask, M, C,
                      K, radius2, num_shells, stream);
  return launch<32>(kmeta, kcand, kxyz, qslot, cd0, mask, nsel, pmask, M, C,
                    K, radius2, num_shells, stream);
}
