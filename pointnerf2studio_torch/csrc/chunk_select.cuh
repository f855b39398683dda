// The first of the fused chunk's device kernels, shared by csrc/
// fused_chunk.cu (the tuned widths, G = 8) and csrc/chunk_any.cu (every
// other width of the envelope): per shading slot the K-nearest selection
// of csrc/select.cuh with the neighbour's inverse-distance weight taken in
// each round, the payload extract (the 96-byte candidate-major row of each
// chosen neighbour, 16-byte loads), and the neighbour geometry (lane k of
// the slot's group does neighbour k: Rw2c-rotated dists and the w2pers
// offsets, colour and dirdot). It writes, for the valid (slot, k) pairs
// only, the tower's inputs to a scratch buffer (`Scratch`: 120 bytes a
// pair) and per slot the neighbour count and the rotated view direction;
// a slot whose mask is false gets (0, 0, false) here and no pair. The
// embedding is 32 channels and dists 6, as the reference's gate
// (fused_chunk_eligible) fixes them. The including sources are compiled
// with -fmad=false: the geometry must equal the plain version's.

#pragma once

#include "select.cuh"

namespace chunksel {

typedef __nv_bfloat16 bf16;

constexpr int kChunkC = 32;          // embedding width the payload fixes
constexpr int kChunkD = 6;           // dists width
constexpr int kChunkCD = 7;          // colour (3) + dirdot (4)
constexpr int kSelectThreads = 128;

__device__ __forceinline__ float sel_bf_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the scratch buffer between the kernels, for M slots of K pairs and a
// colour-tower input row of hs bf16 (a multiple of 8)
struct Scratch {
  bf16* emb;        // [M*K, 32]
  bf16* hw;         // [M, hs] sum_k h * w_k, the colour tower's input
  float* dists;     // [M*K, 6] bf16-rounded values
  float* cd;        // [M*K, 7] colour, dirdot
  float* wk;        // [M*K] normalised weights
  float* vd;        // [M, 3] Rw2c-rotated view direction
  signed char* nk;  // [M] neighbours found, -1: slot masked off
};
constexpr int kPairBytes = kChunkC * 2 + (kChunkD + kChunkCD + 1) * 4;  // 120
__host__ __device__ inline long long slot_bytes(int hs) {
  return (long long)hs * 2 + 3 * 4 + 1;
}

__host__ __device__ inline Scratch carve(void* base, int M, int K, int hs) {
  const size_t mk = (size_t)M * K;
  Scratch s;
  s.emb = (bf16*)base;
  s.hw = s.emb + mk * kChunkC;
  s.dists = (float*)(s.hw + (size_t)M * hs);
  s.cd = s.dists + mk * kChunkD;
  s.wk = s.cd + mk * kChunkCD;
  s.vd = s.wk + mk;
  s.nk = (signed char*)(s.vd + (size_t)M * 3);
  return s;
}

// ---------------------------------------------------------------------
// selection, extract, weights and geometry: 32 / G slots a warp
// ---------------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(kSelectThreads)
chunk_select_kernel(const int32_t* __restrict__ kmeta,
                    const bf16* __restrict__ kcand,
                    const bf16* __restrict__ kxyz,
                    const int32_t* __restrict__ qslot,
                    const float* __restrict__ locs,
                    const float* __restrict__ center,
                    const float* __restrict__ rd,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ consts, Scratch out,
                    float* __restrict__ sig, float* __restrict__ rgb,
                    uint8_t* __restrict__ found, int M, int C, int K,
                    float radius2, int num_shells) {
  __shared__ float sc[32];
  if (threadIdx.x < 21) sc[threadIdx.x] = consts[threadIdx.x];
  __syncthreads();
  const float* cam = sc;        // campos
  const float* Rc = sc + 3;     // camrotc2w, row-major
  const float* Wr = sc + 12;    // Rw2c, row-major
  const int lane = threadIdx.x & 31, l = lane & (G - 1),
            gbase = lane & ~(G - 1);
  const int j =
      (blockIdx.x * (kSelectThreads / 32) + (threadIdx.x >> 5)) * (32 / G) +
      lane / G;
  const int m = min(j, M - 1);
  const bool act = j < M && mask[m] != 0;   // uniform in the group
  int q = 0;
  float key[8], px[3][8], loc[3], cen[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) loc[i] = cen[i] = 0.f;
  if (act) {
    q = qslot[m];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      loc[i] = locs[(size_t)m * 3 + i];
      cen[i] = center[(size_t)m * 3 + i];
    }
  }
  knn::candidate_keys<G>(kmeta, kxyz, q, C, K, l, act, cen[0] - loc[0],
                         cen[1] - loc[1], cen[2] - loc[2], radius2,
                         num_shells, key, px);

  // K rounds; lane k of the group keeps neighbour k's column and weight
  float wsum = 0.f, my_w = 0.f;
  int nk = 0, my_c = 0;
  for (int k = 0; k < K; ++k) {
    // the smallest (d2, column) of the slot's candidates
    float bk;
    int bc;
    knn::group_argmin<G>(key, l, bk, bc);
    // group-uniform; once false it stays false (no key is left)
    const bool got = bk < CUDART_INF_F;
    if (!__any_sync(0xffffffffu, got)) break;
    float mine[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (bc == l * 8 + i) {
        key[i] = CUDART_INF_F;
        mine[0] = px[0][i];
        mine[1] = px[1][i];
        mine[2] = px[2][i];
      }
    float dw[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float sx = __shfl_sync(0xffffffffu, mine[a], gbase | (bc >> 3));
      dw[a] = (sx + cen[a]) - loc[a];
    }
    const float dw2 = dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2];
    const float w = 1.0f / fmaxf(sqrtf(dw2), 1e-6f);
    if (got) {
      wsum = wsum + w;
      nk = k + 1;
      if (l == k) {
        my_c = bc;
        my_w = w;
      }
    }
  }
  const float wnorm = 1.0f / fmaxf(wsum, 1e-8f);
  my_w = my_w * wnorm;

  // per slot: count, view direction, and the sample in camera space
  float vd[3], lc[3];
  {
    const float r0 = act ? rd[(size_t)m * 3 + 0] : 0.f,
                r1 = act ? rd[(size_t)m * 3 + 1] : 0.f,
                r2 = act ? rd[(size_t)m * 3 + 2] : 0.f;
    const float ls0 = loc[0] - cam[0], ls1 = loc[1] - cam[1],
                ls2 = loc[2] - cam[2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      vd[a] = r0 * Wr[0 * 3 + a] + r1 * Wr[1 * 3 + a] + r2 * Wr[2 * 3 + a];
      lc[a] = ls0 * Rc[0 * 3 + a] + ls1 * Rc[1 * 3 + a] + ls2 * Rc[2 * 3 + a];
    }
  }
  const float lpx = lc[0] / lc[2], lpy = lc[1] / lc[2];
  if (l == 0 && j < M) {
    out.nk[m] = (signed char)(act ? nk : -1);
    if (act) {
      out.vd[(size_t)m * 3 + 0] = vd[0];
      out.vd[(size_t)m * 3 + 1] = vd[1];
      out.vd[(size_t)m * 3 + 2] = vd[2];
    } else {
      sig[m] = 0.f;
      rgb[(size_t)m * 3 + 0] = rgb[(size_t)m * 3 + 1] =
          rgb[(size_t)m * 3 + 2] = 0.f;
      found[m] = 0;
    }
  }

  // extract: neighbour k's payload row is 96 contiguous bytes of kcand
  // (channels 0-2 rel xyz, 3-34 emb, 35 conf, 36-38 dir, 39-41 colour);
  // the group's lanes 0-5 load 16 bytes of it each, channels 8 l .. 8 l + 7
  // as the 32-bit words 4 l .. 4 l + 3 of the row. The embedding starts
  // three channels in, so lane l < 4 forms its 16 bytes of the scratch row
  // from its words 1-3 and the next lane's words 0-1, shifted by one
  // channel; xyz (lane 0) and dir / colour (lanes 4 and 5) go to lane k,
  // which does row k's geometry
  const bf16* cand_rows = kcand + (size_t)q * C * knn::kPK;
  float pv[3] = {0.f, 0.f, 0.f}, ndir[3] = {0.f, 0.f, 0.f},
        ncol[3] = {0.f, 0.f, 0.f};
  const int kmax = __reduce_max_sync(0xffffffffu, nk);
  for (int k = 0; k < kmax; ++k) {
    const int c = __shfl_sync(0xffffffffu, my_c, gbase | k);
    const bool row = k < nk;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row && l < 6)
      v = *(const uint4*)(cand_rows + (size_t)c * knn::kPK + l * 8);
    const uint32_t n0 = __shfl_down_sync(0xffffffffu, v.x, 1, 8);
    const uint32_t n1 = __shfl_down_sync(0xffffffffu, v.y, 1, 8);
    if (row && l < 4) {
      uint4 e;
      e.x = __funnelshift_r(v.y, v.z, 16);
      e.y = __funnelshift_r(v.z, v.w, 16);
      e.z = __funnelshift_r(v.w, n0, 16);
      e.w = __funnelshift_r(n0, n1, 16);
      *(uint4*)(out.emb + ((size_t)m * K + k) * kChunkC + l * 8) = e;
    }
    const uint32_t x0 = __shfl_sync(0xffffffffu, v.x, gbase);
    const uint32_t x1 = __shfl_sync(0xffffffffu, v.y, gbase);
    const uint32_t d0 = __shfl_sync(0xffffffffu, v.z, gbase | 4);
    const uint32_t d1 = __shfl_sync(0xffffffffu, v.w, gbase | 4);
    const uint32_t c0 = __shfl_sync(0xffffffffu, v.x, gbase | 5);
    if (l == k) {
      pv[0] = knn::bf_lo(x0);
      pv[1] = knn::bf_hi(x0);
      pv[2] = knn::bf_lo(x1);
      ndir[0] = knn::bf_lo(d0);
      ndir[1] = knn::bf_hi(d0);
      ndir[2] = knn::bf_lo(d1);
      ncol[0] = knn::bf_hi(d1);
      ncol[1] = knn::bf_lo(c0);
      ncol[2] = knn::bf_hi(c0);
    }
  }
  if (l < nk) {
    float nx[3], dw[3], ns[3], nc[3], dr[3], ndr[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      nx[a] = pv[a] + cen[a];
      dw[a] = nx[a] - loc[a];
      ns[a] = nx[a] - cam[a];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      nc[a] = ns[0] * Rc[0 * 3 + a] + ns[1] * Rc[1 * 3 + a] +
              ns[2] * Rc[2 * 3 + a];
      dr[a] = dw[0] * Wr[0 * 3 + a] + dw[1] * Wr[1 * 3 + a] +
              dw[2] * Wr[2 * 3 + a];
      ndr[a] = ndir[0] * Wr[0 * 3 + a] + ndir[1] * Wr[1 * 3 + a] +
               ndir[2] * Wr[2 * 3 + a];
    }
    const float npx = nc[0] / nc[2], npy = nc[1] / nc[2];
    const size_t g = (size_t)m * K + l;
    float* d = out.dists + g * kChunkD;
    d[0] = sel_bf_round(dr[0]);
    d[1] = sel_bf_round(dr[1]);
    d[2] = sel_bf_round(dr[2]);
    d[3] = sel_bf_round(npx * nc[2] - lpx * lc[2]);
    d[4] = sel_bf_round(npy * nc[2] - lpy * lc[2]);
    d[5] = sel_bf_round(nc[2] - lc[2]);
    float* o = out.cd + g * kChunkCD;
    o[0] = ncol[0];
    o[1] = ncol[1];
    o[2] = ncol[2];
    o[3] = ndr[0] - vd[0];
    o[4] = ndr[1] - vd[1];
    o[5] = ndr[2] - vd[2];
    o[6] = ndr[0] * vd[0] + ndr[1] * vd[1] + ndr[2] * vd[2];
    out.wk[g] = my_w;
  }
}

}  // namespace chunksel
