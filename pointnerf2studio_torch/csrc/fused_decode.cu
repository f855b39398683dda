// The per-neighbour tower of the radiance decoder in one kernel, with two
// exported entry points that share one device tower (csrc/tower.cuh):
//   fused_decode   - per (slot, k) row: aw = alpha * wk (f32) and
//                    hw = bf16(f32(bf16 h) * wk), written per row; the
//                    K-sum runs outside.
//   fused_decode2  - per slot: sum_k alpha * wk and sum_k h * wk with h
//                    kept in f32 after layer 4 (rounded to bf16 only for
//                    the density dot), summed in f32 in k order.
// Replaces the Pallas kernels pointnerf2studio_tpu/ops/fused_decode.py::
// _pair_kernel (fused_decode) and ::_kacc_kernel (fused_decode2) for the
// flagship tower (32 features, 6 dists, PE freqs 3/5, hidden 256,
// K <= 8).
//
// Per row: feature = [emb, PE_block(emb, 3), PE_block(dists, 5)] in
// bf16 (284 wide; sin/cos in f32 of the bf16-rounded input, rounded to
// bf16; an embedding channel's octaves 2x and 4x come from its sin and
// cos by the double-angle formulas), four layers 284->256, 256->256, (256+7)->256, 256->256 of bf16
// operands accumulated in f32, + f32 bias, LeakyReLU(0.1) in f32, cast
// to bf16; alpha = ReLU(bf16(h) . wd + bd).
//
// What bounds it on Hopper: tensor-core operations, 0.54 MFLOP per row
// that has a non-zero weight against 150 bytes of input per row. The
// TPU kernels ran every (slot, k) row, valid or not, in 4096-row tiles
// with the weights resident in VMEM, and fused_decode2 carried its sums
// from one grid step to the next. Here (tower.cuh has the tower's side):
//   * a row whose wk is exactly 0 adds exactly 0 to every sum and
//     writes exactly 0, so only the non-zero rows are packed into tiles:
//     a warpgroup reads the wk of a span of 128 slots, takes runs of
//     slots that fill its 64 rows, builds their layer-1 input and
//     colour/dirdot columns in shared memory in the layout wgmma reads
//     (one warp per slot, a lane per embedding channel), and runs the
//     four wgmma layers against the weight slabs the producer warp
//     streams through a ring of 4 stages of 32 KB; a warp keeps four
//     rows' loads and sin/cos chains in flight;
//   * one persistent block per SM (132) of 2 consumer warpgroups + the
//     producer's; spans are dealt to the warpgroups round robin; 225,872
//     bytes of shared memory a block (80 KB activations, 128 KB ring, the
//     span's weights, tables); 232 registers a consumer thread;
//   * nothing carries across blocks: a slot's K rows live in one tile
//     and fused_decode2's sums are taken there in k order;
//   * fused_decode's rows leave through shared memory, 512 contiguous
//     bytes a row; rows with a zero weight are written as zeros.
// The kernel's body is run_tower of tower.cuh; this file holds its policy
// (DecodePolicy: rows from wk != 0, the zero writes, the two output
// forms) and the launcher.
// Compiled with -fmad=false so that acc + bias, 0.1 * x and h * wk round
// as the plain version's separate multiplies and adds do.

#include "tower.cuh"

using namespace tower;

namespace {

constexpr int kNWeightBytes = kTowerSlabs * kSlabBytes;

// The tower's policy (run_tower in tower.cuh). KACC = false: fused_decode
// (per-row outputs); true: fused_decode2 (per-slot sums). Row g = m * K +
// k of the [M, K, c] inputs; a row is run where its wk is not 0.
template <bool KACC>
struct DecodePolicy {
  static constexpr bool kRoundBias = false;
  const bf16* emb;     // [M*K, 32]
  const float* dists;  // [M*K, 6]
  const float* cd;     // [M*K, 7]
  const float* wk;     // [M*K]
  float* aw_out;       // [M*K] | [M]
  void* hw_out;        // bf16 [M*K, 256] | f32 [M, 256]

  __device__ __forceinline__ unsigned load_slot(int m, int K, float* w,
                                                bool& live) const {
    const float* src = wk + (size_t)m * K;
    unsigned b = 0;
    for (int k = 0; k < K; ++k) {
      const float v = src[k];
      w[k] = v;
      if (v != 0.f) b |= 1u << k;
    }
    live = b != 0;
    return b;
  }

  // rows and slots with no weight write zeros
  __device__ __forceinline__ void no_row(int m, unsigned bits, int K,
                                         int nrows, int lane) const {
    if (KACC) {
      // in a tile with rows, the K-sums write a slot without rows too
      if (nrows == 0) {
        float4* hw = (float4*)((float*)hw_out + (size_t)m * kH);
        hw[lane] = hw[lane + 32] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (lane == 0) aw_out[m] = 0.f;
      }
    } else {
      for (int k = 0; k < K; ++k) {
        if ((bits >> k) & 1u) continue;
        const size_t g = (size_t)m * K + k;
        ((uint4*)((bf16*)hw_out + g * kH))[lane] = make_uint4(0, 0, 0, 0);
        if (lane == 0) aw_out[g] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void finish(const float (&acc)[128], float d0,
                                         float d1, const float* F, Tables& T,
                                         unsigned char* A, int m0, int n_take,
                                         int nrows, int wg, int ww,
                                         int lane) const {
    const float bd = __ldg(F + kBD);
    const float al0 = fmaxf(d0 + bd, 0.f), al1 = fmaxf(d1 + bd, 0.f);
    if (KACC) {
      float* aw = aw_out + m0;
      float* hw = (float*)hw_out + (size_t)m0 * kH;
      slot_sums(
          acc, al0, al1, T, A, n_take, wg, ww, lane,
          [aw](int i, float s, int) { aw[i] = s; },
          [hw](int i, int col, float s) { hw[i * kH + col] = s; });
      return;
    }
    if (TOWER_PROBE & 8) {
      keep_alive(al0 + al1 + acc[5]);
      wg_bar(wg);
      return;
    }
    // the rows leave through the warpgroup's activation slabs 0-3, 512
    // contiguous bytes a row
    const int q = lane & 3, r0 = ww * 16 + (lane >> 2), rx = r0 & 7;
    const float w0 = r0 < nrows ? T.row_wk[r0] : 0.f;
    const float w1 = r0 + 8 < nrows ? T.row_wk[r0 + 8] : 0.f;
    if (q == 0) {
      if (r0 < nrows) aw_out[T.row_src[r0]] = al0 * w0;
      if (r0 + 8 < nrows) aw_out[T.row_src[r0 + 8]] = al1 * w1;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      unsigned char* p = A + (j >> 3) * kASlabBytes + r0 * 128 +
                         (((j & 7) ^ rx) << 4) + q * 4;
      *(__nv_bfloat162*)p = __floats2bfloat162_rn(
          bf_round(acc[4 * j]) * w0, bf_round(acc[4 * j + 1]) * w0);
      *(__nv_bfloat162*)(p + 8 * 128) = __floats2bfloat162_rn(
          bf_round(acc[4 * j + 2]) * w1, bf_round(acc[4 * j + 3]) * w1);
    }
    wg_bar(wg);
    for (int r = ww; r < nrows; r += 4) {
      const uint4 v = *(const uint4*)(A + (lane >> 3) * kASlabBytes +
                                      r * 128 + (((lane & 7) ^ (r & 7)) << 4));
      ((uint4*)((bf16*)hw_out + (size_t)T.row_src[r] * kH))[lane] = v;
    }
    wg_bar(wg);
  }
};

template <bool KACC>
__global__ void __launch_bounds__(kThreads, 1)
fused_decode_kernel(const DecodePolicy<KACC> p,
                    const unsigned char* __restrict__ W,  // packed slabs
                    const float* __restrict__ F,          // biases, wd, bd
                    int M, int K) {
  run_tower(p, W, F, M, K);
}

template <bool KACC>
int launch(const void* emb, const void* dists, const void* cd, const void* wk,
           const void* weights, const void* params, void* aw, void* hw, int M,
           int K, void* stream) {
  if (K < 1 || K > kKMax) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  int blocks = 0;
  const cudaError_t err = persistent_blocks(
      fused_decode_kernel<KACC>, (M + kSpan - 1) / kSpan, blocks);
  if (err != cudaSuccess) return (int)err;
  const DecodePolicy<KACC> p = {(const bf16*)emb, (const float*)dists,
                                (const float*)cd, (const float*)wk,
                                (float*)aw, hw};
  fused_decode_kernel<KACC>
      <<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
          p, (const unsigned char*)weights, (const float*)params, M, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_decode_n_weight_bytes() { return kNWeightBytes; }
extern "C" int fused_decode_n_params() { return kNTowerF32; }

// emb bf16 [M, K, 32], dists f32 [M, K, 6], cd f32 [M, K, 7], wk f32
// [M, K], weights: the packed slabs, params: f32 biases, wd, bd
// -> aw f32 [M, K], hw bf16 [M, K, 256]
extern "C" int fused_decode(const void* emb, const void* dists,
                            const void* cd, const void* wk,
                            const void* weights, const void* params,
                            void* aw, void* hw, int M, int K, void* stream) {
  return launch<false>(emb, dists, cd, wk, weights, params, aw, hw, M, K,
                       stream);
}

// same inputs -> aw f32 [M], hw f32 [M, 256], summed over k in k order
extern "C" int fused_decode2(const void* emb, const void* dists,
                             const void* cd, const void* wk,
                             const void* weights, const void* params,
                             void* aw, void* hw, int M, int K, void* stream) {
  return launch<true>(emb, dists, cd, wk, weights, params, aw, hw, M, K,
                      stream);
}
