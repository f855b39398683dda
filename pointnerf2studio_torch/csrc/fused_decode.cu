// The per-neighbour tower of the radiance decoder in one kernel, with two
// exported entry points that share one device tower:
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
// bf16), four layers 284->256, 256->256, (256+7)->256, 256->256 of bf16
// operands accumulated in f32, + f32 bias, LeakyReLU(0.1) in f32, cast
// to bf16; alpha = ReLU(bf16(h) . wd + bd).
//
// What bounds it on Hopper: tensor-core operations, 0.54 MFLOP per row
// that has a non-zero weight against 150 bytes of input per row. The
// TPU kernels ran every (slot, k) row, valid or not, in 4096-row tiles
// with the weights resident in VMEM, and fused_decode2 carried its sums
// from one grid step to the next. Here:
//   * a row whose wk is exactly 0 adds exactly 0 to every sum and
//     writes exactly 0, so a block packs only the non-zero rows of its
//     8 slots into at most 64 rows of shared memory and runs the tower
//     on those;
//   * each layer is a bf16 x bf16 -> f32 tensor-core product
//     (nvcuda::wmma 16x16x16), weights read from global memory / L2,
//     each weight fragment once per block and reused for up to four
//     16-row tiles;
//   * blocks run in no order, so nothing carries across them: a slot's
//     K rows live in one block and fused_decode2's sums are taken there,
//     per column by one lane walking the rows in k order.
// Compiled with -fmad=false so that acc + bias, 0.1 * x and h * wk round
// as the plain version's separate multiplies and adds do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kSlots = 8;               // slots per block, one warp each
constexpr int kThreads = kSlots * 32;
constexpr int kKMax = 8;
constexpr int kRows = kSlots * kKMax;   // packed rows per block
constexpr int kH = 256;                 // tower width
constexpr int kC = 32;                  // embedding width
constexpr int kD = 6;                   // dists width
constexpr int kCD = 7;                  // colour (3) + dirdot (4)
constexpr int kNff = 3, kNdf = 5;
constexpr int kLd = 288;                // activation row stride (elements)
constexpr int kCdLd = 16;               // colour + dirdot row (7 used)

// packed bf16 weights, [in, out] row-major, input rows zero padded to 16
constexpr int kW1 = 0;                        // [288, 256]
constexpr int kW2 = kW1 + 288 * kH;           // [256, 256]
constexpr int kW3 = kW2 + kH * kH;            // [272, 256]
constexpr int kW4 = kW3 + 272 * kH;           // [256, 256]
constexpr int kWD = kW4 + kH * kH;            // [256, 16], column 0 used
constexpr int kNWeights = kWD + kH * 16;
// f32 biases
constexpr int kB1 = 0, kB2 = kH, kB3 = 2 * kH, kB4 = 3 * kH, kBD = 4 * kH;
constexpr int kNBiases = kBD + 16;

struct Smem {
  bf16 a[kRows * kLd];
  bf16 b[kRows * kLd];
  bf16 cd[kRows * kCdLd];
  float stage[kSlots * 256];
  float hws[kSlots * kH];
  float row_wk[kRows];
  float row_alpha[kRows];
  int row_slot[kRows];
  int nk[kSlots];
  int off[kSlots + 1];
};

enum Mode { kHidden = 0, kHiddenAcc = 1, kDensity = 2 };

__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float leaky(float x) {
  return x > 0.f ? x : 0.1f * x;
}

// out = epilogue(A @ W + bias): A is [rtiles*16, ka*16] (+ [.., ka2*16]
// from A2) bf16 in shared memory, W is [(ka+ka2)*16, ntiles*16] bf16 in
// global memory, bias f32. Warp w computes column tiles w, w+8, ...
template <int MODE>
__device__ void gemm(Smem& sm, const bf16* A, int lda, int ka,
                     const bf16* A2, int lda2, int ka2,
                     const bf16* __restrict__ W, int ldw,
                     const float* __restrict__ bias, int ntiles, int rtiles,
                     int nrows, bf16* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = sm.stage + warp * 256;
  for (int ct = warp; ct < ntiles; ct += kSlots) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int rt = 0; rt < 4; ++rt) wmma::fill_fragment(acc[rt], 0.f);
    for (int kk = 0; kk < ka + ka2; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, W + (size_t)kk * 16 * ldw + ct * 16, ldw);
#pragma unroll
      for (int rt = 0; rt < 4; ++rt) {
        if (rt < rtiles) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              af;
          if (kk < ka)
            wmma::load_matrix_sync(af, A + rt * 16 * lda + kk * 16, lda);
          else
            wmma::load_matrix_sync(af, A2 + rt * 16 * lda2 + (kk - ka) * 16,
                                   lda2);
          wmma::mma_sync(acc[rt], af, bf, acc[rt]);
        }
      }
    }
#pragma unroll
    for (int rt = 0; rt < 4; ++rt) {
      if (rt >= rtiles) continue;
      wmma::store_matrix_sync(st, acc[rt], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const int row = rt * 16 + r, col = ct * 16 + c;
        const float y = st[e] + bias[col];
        if (MODE == kDensity) {
          if (c == 0) sm.row_alpha[row] = fmaxf(y, 0.f);
        } else {
          const float z = leaky(y);
          out[row * ldo + col] = __float2bfloat16(z);
          st[e] = z;
        }
      }
      __syncwarp();
      if (MODE == kHiddenAcc && lane < 16) {
        // f32 h * w_k summed over k in k order: one lane per column
        // walks the packed rows in order (slot-major, k ascending)
        const int col = ct * 16 + lane;
        for (int r = 0; r < 16; ++r) {
          const int row = rt * 16 + r;
          if (row < nrows)
            sm.hws[sm.row_slot[row] * kH + col] +=
                st[r * 16 + lane] * sm.row_wk[row];
        }
      }
      __syncwarp();
    }
  }
}

// KACC = false: fused_decode (per-row outputs); true: fused_decode2
// (per-slot sums). Row g = m * K + k of the [M, K, c] inputs.
template <bool KACC>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const bf16* __restrict__ emb,     // [M*K, 32]
                    const float* __restrict__ dists,  // [M*K, 6]
                    const float* __restrict__ cd,     // [M*K, 7]
                    const float* __restrict__ wk,     // [M*K]
                    const bf16* __restrict__ P,       // packed weights
                    const float* __restrict__ Bv,     // biases
                    float* __restrict__ aw_out,       // [M*K] | [M]
                    void* __restrict__ hw_out,  // bf16 [M*K,256] | f32 [M,256]
                    int M, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kSlots + warp;
  const bool live = m < M;

  // ---- pack the rows whose weight is non-zero ----
  float w = 0.f;
  if (live && lane < K) w = wk[(size_t)m * K + lane];
  const unsigned bal = __ballot_sync(0xffffffffu, w != 0.f);
  const int nk = __popc(bal);
  if (lane == 0) sm.nk[warp] = nk;
  if (KACC)
    for (int i = threadIdx.x; i < kSlots * kH; i += kThreads) sm.hws[i] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int s = 0; s < kSlots; ++s) {
      sm.off[s] = acc;
      acc += sm.nk[s];
    }
    sm.off[kSlots] = acc;
  }
  __syncthreads();
  const int nrows = sm.off[kSlots];
  const int row0 = sm.off[warp];

  // ---- layer-1 input rows and colour/dirdot rows ----
  {
    unsigned rest = bal;
    for (int i = 0; i < nk; ++i) {
      const int k = __ffs(rest) - 1;
      rest &= rest - 1;
      const int row = row0 + i;
      const size_t g = (size_t)m * K + k;
      const float wv = __shfl_sync(0xffffffffu, w, k);
      bf16* xr = sm.a + row * kLd;
      const bf16 eb = emb[g * kC + lane];
      const float e = __bfloat162float(eb);
      xr[lane] = eb;
#pragma unroll
      for (int j = 0; j < kNff; ++j) {
        const float v = e * (float)(1 << j);
        xr[kC + j * kC + lane] = __float2bfloat16(sinf(v));
        xr[kC + kC * kNff + j * kC + lane] = __float2bfloat16(cosf(v));
      }
      constexpr int kDist0 = kC + 2 * kC * kNff;   // 224
      if (lane < kD * kNdf) {
        const int j = lane / kD, c = lane % kD;
        const float v = bf_round(dists[g * kD + c]) * (float)(1 << j);
        xr[kDist0 + lane] = __float2bfloat16(sinf(v));
        xr[kDist0 + kD * kNdf + lane] = __float2bfloat16(cosf(v));
      } else {
        const int base = kDist0 + 2 * kD * kNdf + 2 * (lane - kD * kNdf);
        xr[base] = xr[base + 1] = __float2bfloat16(0.f);
      }
      if (lane < kCdLd)
        sm.cd[row * kCdLd + lane] =
            __float2bfloat16(lane < kCD ? cd[g * kCD + lane] : 0.f);
      if (lane == 0) {
        sm.row_slot[row] = warp;
        sm.row_wk[row] = wv;
      }
    }
  }
  __syncthreads();

  // ---- the tower on the packed rows ----
  const int rtiles = (nrows + 15) / 16;
  if (rtiles > 0) {
    gemm<kHidden>(sm, sm.a, kLd, 18, nullptr, 0, 0, P + kW1, kH, Bv + kB1,
                  16, rtiles, nrows, sm.b, kLd);
    __syncthreads();
    gemm<kHidden>(sm, sm.b, kLd, 16, nullptr, 0, 0, P + kW2, kH, Bv + kB2,
                  16, rtiles, nrows, sm.a, kLd);
    __syncthreads();
    gemm<kHidden>(sm, sm.a, kLd, 16, sm.cd, kCdLd, 1, P + kW3, kH, Bv + kB3,
                  16, rtiles, nrows, sm.b, kLd);
    __syncthreads();
    gemm<KACC ? kHiddenAcc : kHidden>(sm, sm.b, kLd, 16, nullptr, 0, 0,
                                      P + kW4, kH, Bv + kB4, 16, rtiles,
                                      nrows, sm.a, kLd);
    __syncthreads();
    gemm<kDensity>(sm, sm.a, kLd, 16, nullptr, 0, 0, P + kWD, 16, Bv + kBD,
                   1, rtiles, nrows, nullptr, 0);
    __syncthreads();
  }
  if (!live) return;

  // ---- outputs ----
  if (KACC) {
    if (lane == 0) {
      float aw = 0.f;
      for (int i = 0; i < nk; ++i)
        aw = aw + sm.row_alpha[row0 + i] * sm.row_wk[row0 + i];
      aw_out[m] = aw;
    }
    float* hw = (float*)hw_out + (size_t)m * kH;
    for (int c = lane; c < kH; c += 32) hw[c] = sm.hws[warp * kH + c];
  } else {
    bf16* hw = (bf16*)hw_out;
    int i = 0;
    for (int k = 0; k < K; ++k) {
      const size_t g = (size_t)m * K + k;
      if ((bal >> k) & 1u) {
        const int row = row0 + i++;
        const float wv = sm.row_wk[row];
        if (lane == 0) aw_out[g] = sm.row_alpha[row] * wv;
        for (int c = lane; c < kH; c += 32)
          hw[g * kH + c] = __float2bfloat16(
              __bfloat162float(sm.a[row * kLd + c]) * wv);
      } else {
        if (lane == 0) aw_out[g] = 0.f;
        for (int c = lane; c < kH; c += 32)
          hw[g * kH + c] = __float2bfloat16(0.f);
      }
    }
  }
}

template <bool KACC>
int launch(const void* emb, const void* dists, const void* cd, const void* wk,
           const void* weights, const void* biases, void* aw, void* hw, int M,
           int K, void* stream) {
  if (K < 1 || K > kKMax) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel<KACC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + kSlots - 1) / kSlots;
  fused_decode_kernel<KACC><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)emb, (const float*)dists, (const float*)cd,
      (const float*)wk, (const bf16*)weights, (const float*)biases,
      (float*)aw, hw, M, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_decode_n_weights() { return kNWeights; }
extern "C" int fused_decode_n_biases() { return kNBiases; }

// emb bf16 [M, K, 32], dists f32 [M, K, 6], cd f32 [M, K, 7], wk f32
// [M, K] -> aw f32 [M, K], hw bf16 [M, K, 256]
extern "C" int fused_decode(const void* emb, const void* dists,
                            const void* cd, const void* wk,
                            const void* weights, const void* biases,
                            void* aw, void* hw, int M, int K, void* stream) {
  return launch<false>(emb, dists, cd, wk, weights, biases, aw, hw, M, K,
                       stream);
}

// same inputs -> aw f32 [M], hw f32 [M, 256], summed over k in k order
extern "C" int fused_decode2(const void* emb, const void* dists,
                             const void* cd, const void* wk,
                             const void* weights, const void* biases,
                             void* aw, void* hw, int M, int K, void* stream) {
  return launch<true>(emb, dists, cd, wk, weights, biases, aw, hw, M, K,
                      stream);
}
