// The whole post-gather chunk of the fast render path in one kernel:
// candidate selection, payload extract, inverse-distance weights,
// rotated/perspective dists, the per-neighbour MLP tower with weighted
// alpha/feature sums over K, and the colour tower. Output per slot:
// (sigma, rgb, found).
//
// Replaces the Pallas kernel pointnerf2studio_tpu/ops/fused_chunk.py::
// _kernel (fused_chunk_decode) for the flagship configuration
// (fused_chunk_eligible; hidden 256, colour 128 with 3 layers, 32
// features, PE freqs 3/5/4, K <= 8, C <= 64 candidates of PK = 48 bf16
// channels).
//
// What bounds it on Hopper: the tower is ~0.27 MFLOP per valid
// (slot, neighbour) pair and ~0.14 MFLOP of colour tower per slot, and
// every pair needs 42 of the 48 payload channels of one candidate
// gathered from a 6 KB candidate row. The TPU kernel consumed an
// XLA-gathered [M, 48, C] block (1.8 GB per 65k-ray chunk at chair
// scale) and ran the tower on all K lanes, valid or not. Here:
//   * the kernel reads kmeta/kpay rows itself through qslot, so the
//     gathered candidate block never exists in device memory: a slot
//     costs its 64 metas, 3 xyz channels of 64 candidates and the 42
//     channels of each selected neighbour;
//   * one warp per slot holds the 64 candidates, two per lane, and
//     finds the K nearest by K rounds of a shuffle arg-min on
//     (d2, column) — the smallest-index tie-break of the reference;
//   * the valid (slot, k) pairs of a block's 8 slots pack into at most
//     64 rows in shared memory (invalid neighbours contribute exactly 0
//     to every sum, so skipping them changes no result), and each layer
//     is a bf16 x bf16 -> f32 tensor-core product (nvcuda::wmma
//     16x16x16) with the weights read straight from global memory /
//     L2, each weight fragment once per block and reused for up to four
//     16-row tiles;
//   * the rounding points are the reference's: products of bf16
//     operands accumulated in f32, (bf16(acc) + bf16(bias)) rounded to
//     bf16, LeakyReLU(0.1) in f32, alpha*w and h*w summed over K in f32
//     in k order, sigmoid*(1+2e-3)-1e-3.
// Selection geometry must equal the plain version bit for bit (masks,
// radius test, tie-breaks), so this file is compiled with -fmad=false:
// every multiply and add rounds separately, in the reference's order.
// Slots whose mask is false exit early and output (0, 0, false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kSlots = 8;               // slots per block, one warp each
constexpr int kThreads = kSlots * 32;
constexpr int kKMax = 8;
constexpr int kRows = kSlots * kKMax;   // pair rows per block
constexpr int kH = 256;                 // per-neighbour tower width
constexpr int kHC = 128;                // colour tower width
constexpr int kPK = 48;                 // payload channels
constexpr int kCMax = 64;               // candidates per slot
constexpr int kNff = 3, kNdf = 5, kNvf = 4;
constexpr int kLd = 288;                // activation row stride (elements)
constexpr int kCdLd = 16;               // colour + dirdot row (7 used)
constexpr int kVdLd = 32;               // PE(viewdir) row (24 used)

// packed bf16 parameter buffer, [in, out] row-major, zero padded
constexpr int kW1 = 0;                        // [288, 256]
constexpr int kB1 = kW1 + 288 * kH;
constexpr int kW2 = kB1 + kH;                 // [256, 256]
constexpr int kB2 = kW2 + kH * kH;
constexpr int kW3 = kB2 + kH;                 // [272, 256]
constexpr int kB3 = kW3 + 272 * kH;
constexpr int kW4 = kB3 + kH;                 // [256, 256]
constexpr int kB4 = kW4 + kH * kH;
constexpr int kWD = kB4 + kH;                 // [256, 16], column 0 used
constexpr int kBD = kWD + kH * 16;
constexpr int kWC0 = kBD + 16;                // [288, 128]
constexpr int kBC0 = kWC0 + 288 * kHC;
constexpr int kWC1 = kBC0 + kHC;              // [128, 128]
constexpr int kBC1 = kWC1 + kHC * kHC;
constexpr int kWC2 = kBC1 + kHC;              // [128, 128]
constexpr int kBC2 = kWC2 + kHC * kHC;
constexpr int kWCH = kBC2 + kHC;              // [128, 16], columns 0-2
constexpr int kBCH = kWCH + kHC * 16;
constexpr int kNParams = kBCH + 16;

struct Smem {
  bf16 a[kRows * kLd];
  bf16 b[kRows * kLd];
  bf16 cd[kRows * kCdLd];
  bf16 vd[16 * kVdLd];
  float stage[kSlots * 256];
  float hws[kSlots * kH];
  float row_wk[kRows];
  float row_alpha[kRows];
  int row_slot[kRows];
  float consts[32];
  int nk[kSlots];
  int off[kSlots + 1];
};

enum Mode { kHidden = 0, kHiddenAcc = 1, kDensity = 2, kRgb = 3 };

__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float leaky(float x) {
  return x > 0.f ? x : 0.1f * x;
}

// out = epilogue(A @ W): A is [rtiles*16, ka*16] (+ [.., ka2*16] from
// A2) bf16 in shared memory, W is [(ka+ka2)*16, ntiles*16] bf16 in
// global memory. Warp w computes column tiles w, w+8, ...
template <int MODE>
__device__ void gemm(Smem& sm, const bf16* A, int lda, int ka,
                     const bf16* A2, int lda2, int ka2,
                     const bf16* __restrict__ W, int ldw,
                     const bf16* __restrict__ bias, int ntiles, int rtiles,
                     int nrows, bf16* out, int ldo, int act_super,
                     float* rgb_out, int slot0, int M) {
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
        const float y = bf_round(bf_round(st[e]) +
                                 __bfloat162float(bias[col]));
        if (MODE == kHidden || MODE == kHiddenAcc) {
          const float z = leaky(y);
          out[row * ldo + col] = __float2bfloat16(z);
          st[e] = z;
        } else if (MODE == kDensity) {
          if (c == 0)
            sm.row_alpha[row] =
                act_super ? log1pf(expf(-fabsf(y - 1.f))) + fmaxf(y - 1.f, 0.f)
                          : fmaxf(y, 0.f);
        } else {  // kRgb: row = local slot
          if (c < 3 && row < kSlots && slot0 + row < M &&
              sm.nk[row] >= 0) {
            const float s = 1.f / (1.f + expf(-y));
            rgb_out[(size_t)(slot0 + row) * 3 + c] =
                s * (1.f + 2e-3f) - 1e-3f;
          }
        }
      }
      __syncwarp();
      if (MODE == kHiddenAcc && lane < 16) {
        // h * w_k summed over k in k order: one lane per column walks
        // the rows in order, so every sum has the reference's order
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

__global__ void __launch_bounds__(kThreads)
fused_chunk_kernel(const int32_t* __restrict__ kmeta,
                   const bf16* __restrict__ kpay,
                   const int32_t* __restrict__ qslot,
                   const float* __restrict__ locs,
                   const float* __restrict__ center,
                   const float* __restrict__ rd,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ consts,
                   const bf16* __restrict__ P, float* __restrict__ sig,
                   float* __restrict__ rgb, uint8_t* __restrict__ found,
                   int M, int C, int K, float radius2, int num_shells,
                   int act_super) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot0 = blockIdx.x * kSlots;
  const int m = slot0 + warp;
  const bool active = m < M && mask[m] != 0;

  if (threadIdx.x < 21) sm.consts[threadIdx.x] = consts[threadIdx.x];
  for (int i = threadIdx.x; i < kSlots * kH; i += kThreads) sm.hws[i] = 0.f;
  if (lane == 0) sm.nk[warp] = active ? 0 : -1;
  if (!active && m < M && lane == 0) {
    sig[m] = 0.f;
    rgb[(size_t)m * 3 + 0] = rgb[(size_t)m * 3 + 1] = rgb[(size_t)m * 3 + 2] =
        0.f;
    found[m] = 0;
  }
  if (!__syncthreads_or(active)) return;

  const float* cam = sm.consts;       // campos
  const float* Rc = sm.consts + 3;    // camrotc2w, row-major
  const float* Wr = sm.consts + 12;   // Rw2c, row-major

  // ---- selection: one warp per slot, candidates lane and lane + 32 ----
  int q = 0;
  float loc[3], cen[3], pxa[3] = {0, 0, 0}, pxb[3] = {0, 0, 0};
  int selc[kKMax];
  float wraw[kKMax];
  int nk = 0;
  float wnorm = 0.f;
  if (active) {
    q = qslot[m];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      loc[i] = locs[(size_t)m * 3 + i];
      cen[i] = center[(size_t)m * 3 + i];
    }
    const float cl0 = cen[0] - loc[0], cl1 = cen[1] - loc[1],
                cl2 = cen[2] - loc[2];
    const int32_t* meta_row = kmeta + (size_t)q * C;
    const bf16* pay_row = kpay + (size_t)q * kPK * C;
    float key[2];
    int shell[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      float* px = h ? pxb : pxa;
      ok[h] = false;
      shell[h] = 0;
      key[h] = CUDART_INF_F;
      if (c < C) {
        const int32_t meta = meta_row[c];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          px[i] = __bfloat162float(pay_row[i * C + c]);
        const float dx = px[0] + cl0, dy = px[1] + cl1, dz = px[2] + cl2;
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

    float wsum = 0.f;
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      if (k >= K) break;
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
      float dw2 = 0.f;
      float dw[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float mine = (bc >> 5) ? pxb[i] : pxa[i];
        const float sx = __shfl_sync(0xffffffffu, mine, bc & 31);
        dw[i] = (sx + cen[i]) - loc[i];
      }
      dw2 = dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2];
      const float w = 1.0f / fmaxf(sqrtf(dw2), 1e-6f);
      wsum = wsum + w;
      selc[k] = bc;
      wraw[k] = w;
      nk = k + 1;
    }
    wnorm = 1.0f / fmaxf(wsum, 1e-8f);
    if (lane == 0) sm.nk[warp] = nk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int s = 0; s < kSlots; ++s) {
      sm.off[s] = acc;
      acc += max(sm.nk[s], 0);
    }
    sm.off[kSlots] = acc;
  }
  __syncthreads();
  const int nrows = sm.off[kSlots];

  // ---- per-pair features: layer-1 input rows + colour/dirdot rows ----
  if (active) {
    float vd[3], lc[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float r0 = rd[(size_t)m * 3 + 0], r1 = rd[(size_t)m * 3 + 1],
            r2 = rd[(size_t)m * 3 + 2];
      vd[j] = r0 * Wr[0 * 3 + j] + r1 * Wr[1 * 3 + j] + r2 * Wr[2 * 3 + j];
    }
    {
      const float ls0 = loc[0] - cam[0], ls1 = loc[1] - cam[1],
                  ls2 = loc[2] - cam[2];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        lc[j] = ls0 * Rc[0 * 3 + j] + ls1 * Rc[1 * 3 + j] + ls2 * Rc[2 * 3 + j];
    }
    const float lpx = lc[0] / lc[2], lpy = lc[1] / lc[2];
    // PE(viewdir) block layout: sin(v*2^j) at j*3+i, cos at 12+j*3+i
    {
      bf16* vrow = sm.vd + warp * kVdLd;
      if (lane < 3 * kNvf) {
        const int j = lane / 3, i = lane % 3;
        const float v = bf_round(vd[i]) * (float)(1 << j);
        vrow[lane] = __float2bfloat16(sinf(v));
        vrow[3 * kNvf + lane] = __float2bfloat16(cosf(v));
      } else if (lane >= 6 * kNvf) {
        vrow[lane] = __float2bfloat16(0.f);
      }
    }
    const bf16* pay_row = kpay + (size_t)q * kPK * C;
    for (int k = 0; k < nk; ++k) {
      const int row = sm.off[warp] + k;
      const int c = selc[k];
      const float p_lo = __bfloat162float(pay_row[lane * C + c]);
      const float p_hi =
          lane < 16 ? __bfloat162float(pay_row[(32 + lane) * C + c]) : 0.f;
      // channels: 0-2 rel xyz, 3-34 emb, 35 conf, 36-38 dir, 39-41 colour
      const float e_lo = __shfl_sync(0xffffffffu, p_lo, min(lane + 3, 31));
      const float e_hi = __shfl_sync(0xffffffffu, p_hi, max(lane - 29, 0));
      const float emb = lane <= 28 ? e_lo : e_hi;
      float pv[3], ndir[3], ncol[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pv[i] = __shfl_sync(0xffffffffu, p_lo, i);
        ndir[i] = __shfl_sync(0xffffffffu, p_hi, 4 + i);
        ncol[i] = __shfl_sync(0xffffffffu, p_hi, 7 + i);
      }
      float nx[3], dw[3], ns[3], nc[3], dr[3], ndr[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        nx[i] = pv[i] + cen[i];
        dw[i] = nx[i] - loc[i];
        ns[i] = nx[i] - cam[i];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        nc[j] = ns[0] * Rc[0 * 3 + j] + ns[1] * Rc[1 * 3 + j] +
                ns[2] * Rc[2 * 3 + j];
        dr[j] = dw[0] * Wr[0 * 3 + j] + dw[1] * Wr[1 * 3 + j] +
                dw[2] * Wr[2 * 3 + j];
        ndr[j] = ndir[0] * Wr[0 * 3 + j] + ndir[1] * Wr[1 * 3 + j] +
                 ndir[2] * Wr[2 * 3 + j];
      }
      const float npx = nc[0] / nc[2], npy = nc[1] / nc[2];
      float dist[6] = {dr[0], dr[1], dr[2], npx * nc[2] - lpx * lc[2],
                       npy * nc[2] - lpy * lc[2], nc[2] - lc[2]};
#pragma unroll
      for (int i = 0; i < 6; ++i) dist[i] = bf_round(dist[i]);

      bf16* xr = sm.a + row * kLd;
      xr[lane] = __float2bfloat16(emb);
#pragma unroll
      for (int j = 0; j < kNff; ++j) {
        const float v = emb * (float)(1 << j);
        xr[32 + j * 32 + lane] = __float2bfloat16(sinf(v));
        xr[32 + 32 * kNff + j * 32 + lane] = __float2bfloat16(cosf(v));
      }
      if (lane < 6 * kNdf) {
        const int j = lane / 6, i = lane % 6;
        float d = dist[0];
#pragma unroll
        for (int t = 1; t < 6; ++t) d = i == t ? dist[t] : d;
        const float v = d * (float)(1 << j);
        xr[224 + lane] = __float2bfloat16(sinf(v));
        xr[224 + 6 * kNdf + lane] = __float2bfloat16(cosf(v));
      } else {
        const int base = 284 + 2 * (lane - 30);
        xr[base] = xr[base + 1] = __float2bfloat16(0.f);
      }
      if (lane < kCdLd) {
        const float dot = ndr[0] * vd[0] + ndr[1] * vd[1] + ndr[2] * vd[2];
        float v = 0.f;
        if (lane < 3) v = ncol[lane];
        else if (lane < 6) v = ndr[lane - 3] - vd[lane - 3];
        else if (lane == 6) v = dot;
        sm.cd[row * kCdLd + lane] = __float2bfloat16(v);
      }
      if (lane == 0) {
        sm.row_slot[row] = warp;
        sm.row_wk[row] = wraw[k] * wnorm;
      }
    }
  }
  __syncthreads();

  // ---- per-neighbour tower on the packed pair rows ----
  const int rtiles = (nrows + 15) / 16;
  if (rtiles > 0) {
    gemm<kHidden>(sm, sm.a, kLd, 18, nullptr, 0, 0, P + kW1, kH, P + kB1,
                  16, rtiles, nrows, sm.b, kLd, act_super, nullptr, 0, M);
    __syncthreads();
    gemm<kHidden>(sm, sm.b, kLd, 16, nullptr, 0, 0, P + kW2, kH, P + kB2,
                  16, rtiles, nrows, sm.a, kLd, act_super, nullptr, 0, M);
    __syncthreads();
    gemm<kHidden>(sm, sm.a, kLd, 16, sm.cd, kCdLd, 1, P + kW3, kH, P + kB3,
                  16, rtiles, nrows, sm.b, kLd, act_super, nullptr, 0, M);
    __syncthreads();
    gemm<kHiddenAcc>(sm, sm.b, kLd, 16, nullptr, 0, 0, P + kW4, kH,
                     P + kB4, 16, rtiles, nrows, sm.a, kLd, act_super,
                     nullptr, 0, M);
    __syncthreads();
    gemm<kDensity>(sm, sm.a, kLd, 16, nullptr, 0, 0, P + kWD, 16, P + kBD,
                   1, rtiles, nrows, nullptr, 0, act_super, nullptr, 0, M);
    __syncthreads();
  }

  // ---- per-slot sums, then the colour tower (slot rows 0-7) ----
  if (active && lane == 0) {
    float aw = 0.f;
    for (int k = 0; k < nk; ++k) {
      const int row = sm.off[warp] + k;
      aw = aw + sm.row_alpha[row] * sm.row_wk[row];
    }
    sig[m] = aw;
    found[m] = nk > 0;
  }
  for (int i = lane; i < kH; i += 32)
    sm.b[warp * kLd + i] = __float2bfloat16(sm.hws[warp * kH + i]);
  __syncthreads();
  gemm<kHidden>(sm, sm.b, kLd, 16, sm.vd, kVdLd, 2, P + kWC0, kHC, P + kBC0,
                8, 1, kSlots, sm.a, kLd, act_super, nullptr, 0, M);
  __syncthreads();
  gemm<kHidden>(sm, sm.a, kLd, 8, nullptr, 0, 0, P + kWC1, kHC, P + kBC1, 8,
                1, kSlots, sm.b, kLd, act_super, nullptr, 0, M);
  __syncthreads();
  gemm<kHidden>(sm, sm.b, kLd, 8, nullptr, 0, 0, P + kWC2, kHC, P + kBC2, 8,
                1, kSlots, sm.a, kLd, act_super, nullptr, 0, M);
  __syncthreads();
  gemm<kRgb>(sm, sm.a, kLd, 8, nullptr, 0, 0, P + kWCH, 16, P + kBCH, 1, 1,
             kSlots, nullptr, 0, act_super, rgb, slot0, M);
}

}  // namespace

extern "C" int fused_chunk_n_params() { return kNParams; }

extern "C" int fused_chunk_decode(const void* kmeta, const void* kpay,
                                  const void* qslot, const void* locs,
                                  const void* center, const void* rd,
                                  const void* mask, const void* consts,
                                  const void* params, void* sig, void* rgb,
                                  void* found, int M, int C, int K,
                                  float radius2, int num_shells,
                                  int act_super, void* stream) {
  if (C < 1 || C > kCMax || K < 1 || K > kKMax)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      fused_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + kSlots - 1) / kSlots;
  fused_chunk_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)kmeta, (const bf16*)kpay, (const int32_t*)qslot,
      (const float*)locs, (const float*)center, (const float*)rd,
      (const uint8_t*)mask, (const float*)consts, (const bf16*)params,
      (float*)sig, (float*)rgb, (uint8_t*)found, M, C, K, radius2,
      num_shells, act_super);
  return (int)cudaGetLastError();
}
