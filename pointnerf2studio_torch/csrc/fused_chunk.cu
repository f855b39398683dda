// The whole post-gather chunk of the fast render path behind one entry
// point: candidate selection, payload extract, inverse-distance weights,
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
// What bounds it on Hopper: tensor-core operations. The tower is ~0.27
// MFLOP per valid (slot, neighbour) pair and the colour tower ~0.14
// MFLOP per slot, and every pair needs 42 of the 48 payload channels of
// one candidate. The TPU kernel consumed an XLA-gathered channel-major
// [M, 48, C] block (1.8 GB per 65k-ray chunk at chair scale) and ran the
// tower on all K lanes, valid or not. On the TPU one kernel did all of
// it; here its parts want different shapes, so the entry point launches
// three kernels back to back:
//   * chunk_select_kernel, many small blocks (the gathers are bound by
//     memory latency and need warps in flight, which a tower block of 8
//     consumer warps does not have): it reads the cache rows itself
//     through qslot, so the gathered candidate block never exists in
//     device memory: a slot costs its 64 metas, the 3 xyz planes of its
//     64 candidates (kxyz) and, for each selected neighbour, its 96-byte
//     row of the candidate-major payload (kcand): three 32-byte sectors,
//     read as 16-byte loads. The selection is the one of csrc/select.cuh
//     (eight lanes a slot, eight candidates a lane, K rounds of an
//     arg-min on (d2, column), four slots a warp in lockstep), with the
//     neighbour's inverse-distance weight taken in each round. Then a
//     lane per neighbour does the geometry. It writes, for the valid
//     (slot, k) pairs only, the tower's inputs (embedding bf16 [32] as
//     four 16-byte stores, dists f32 [6], colour/dirdot f32 [7], weight)
//     to a scratch buffer of 120 bytes a pair, and per slot the
//     neighbour count and the rotated view direction;
//   * chunk_tower_kernel, the tower of csrc/tower.cuh on those pairs
//     (invalid neighbours contribute exactly 0 to every sum, so skipping
//     them changes no result): one persistent block per SM of 2 consumer
//     warpgroups + the producer's, wgmma m64n256k16 on bf16 with both
//     operands in shared memory, the weights streamed as pre-swizzled
//     32 KB slabs through a ring of 4 stages by cp.async.bulk on
//     mbarriers. The 256->1 density head is a dot product from the
//     registers; the K-sums leave as bf16 rows of 256 per slot. Its
//     body is run_tower with ChunkPolicy (rows from the scratch, sigma
//     and `found` out). 225,872 bytes of shared memory a block; 232
//     registers a consumer thread;
//   * chunk_colour_kernel, the colour tower on the slots: the same block
//     shape and ring; a warpgroup's tile is 64 consecutive slots, a row
//     per slot (the K-sums and PE(viewdir), 280 columns), three wgmma
//     m64n128k16 layers against five stage uses of colour weights, and
//     the 128->3 head as dot products from the registers. Run per tower
//     tile instead, on at most 32 slots in 64 rows and five more stage
//     uses per tile, it cost four times as much.
// The rounding points are the reference's: products of bf16 operands
// accumulated in f32, (bf16(acc) + bf16(bias)) rounded to bf16,
// LeakyReLU(0.1) in f32, alpha*w and h*w summed over K in f32 in k
// order, sigmoid*(1+2e-3)-1e-3.
// Selection geometry must equal the plain version bit for bit (masks,
// radius test, tie-breaks), so this file is compiled with -fmad=false:
// every multiply and add rounds separately, in the reference's order.
// Slots whose mask is false output (0, 0, false).

#include "select.cuh"
#include "tower.cuh"

using namespace tower;

namespace {

constexpr int kHC = 128;                // colour tower width
constexpr int kNvf = 4;                 // PE octaves of the view direction
constexpr int kColourSeq = 5;           // stage uses of a colour tile
constexpr int kSelectThreads = 128;     // chunk_select_kernel: 16 slots
// colour weights after the tower's slabs: sub-slabs of 64 inputs x 128
// outputs (16 KB): wc0 five (k 0-319, 280 used), wc1 two, wc2 two
constexpr int kColour0 = kTowerSlabs * kSlabBytes;
constexpr int kSubSlab = 64 * kHC * 2;
constexpr int kNWeightBytes = kColour0 + 9 * kSubSlab;
// f32 parameters after the tower's
constexpr int kBC0 = kNTowerF32, kBC1 = kBC0 + kHC, kBC2 = kBC1 + kHC;
constexpr int kWCH = kBC2 + kHC;        // [3][128] colour head (bf16 values)
constexpr int kBCH = kWCH + 3 * kHC;
constexpr int kNParams = kBCH + 16;
// the scratch buffer between the kernels, for M slots of K pairs
struct Scratch {
  bf16* emb;        // [M*K, 32]
  bf16* hw;         // [M, 256] sum_k h * w_k, the colour tower's input
  float* dists;     // [M*K, 6] bf16-rounded values
  float* cd;        // [M*K, 7] colour, dirdot
  float* wk;        // [M*K] normalised weights
  float* vd;        // [M, 3] Rw2c-rotated view direction
  signed char* nk;  // [M] neighbours found, -1: slot masked off
};
constexpr int kPairBytes = kC * 2 + (kD + kCD + 1) * 4;   // 120
constexpr int kSlotBytes = kH * 2 + 3 * 4 + 1;

__host__ __device__ inline Scratch carve(void* base, int M, int K) {
  const size_t mk = (size_t)M * K;
  Scratch s;
  s.emb = (bf16*)base;
  s.hw = s.emb + mk * kC;
  s.dists = (float*)(s.hw + (size_t)M * kH);
  s.cd = s.dists + mk * kD;
  s.wk = s.cd + mk * kCD;
  s.vd = s.wk + mk;
  s.nk = (signed char*)(s.vd + (size_t)M * 3);
  return s;
}

// ---------------------------------------------------------------------
// selection, extract, weights and geometry: four slots a warp
// ---------------------------------------------------------------------
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
  const int lane = threadIdx.x & 31, l = lane & 7, gbase = lane & ~7;
  const int j = (blockIdx.x * (kSelectThreads / 32) + (threadIdx.x >> 5)) * 4 +
                (lane >> 3);
  const int m = min(j, M - 1);
  const bool act = j < M && mask[m] != 0;   // uniform in the 8-lane group
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
  knn::candidate_keys(kmeta, kxyz, q, C, K, l, act, cen[0] - loc[0],
                      cen[1] - loc[1], cen[2] - loc[2], radius2, num_shells,
                      key, px);

  // K rounds; lane k of the group keeps neighbour k's column and weight
  float wsum = 0.f, my_w = 0.f;
  int nk = 0, my_c = 0;
  for (int k = 0; k < K; ++k) {
    // the smallest (d2, column) of the slot's 64 candidates
    float bk;
    int bc;
    knn::group_argmin(key, l, bk, bc);
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
      *(uint4*)(out.emb + ((size_t)m * K + k) * kC + l * 8) = e;
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
    float* d = out.dists + g * kD;
    d[0] = bf_round(dr[0]);
    d[1] = bf_round(dr[1]);
    d[2] = bf_round(dr[2]);
    d[3] = bf_round(npx * nc[2] - lpx * lc[2]);
    d[4] = bf_round(npy * nc[2] - lpy * lc[2]);
    d[5] = bf_round(nc[2] - lc[2]);
    float* o = out.cd + g * kCD;
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

// ---------------------------------------------------------------------
// the towers on the selected pairs
// ---------------------------------------------------------------------
struct ColourEntry {
  __device__ void operator()(int idx, uint32_t& off, uint32_t& bytes) const {
    // wc0: k 0-127, 128-255, 256-319; wc1; wc2
    const int sub0 = idx < 3 ? 2 * idx : 2 * idx - 1;
    off = kColour0 + sub0 * kSubSlab;
    bytes = idx == 2 ? kSubSlab : 2 * kSubSlab;
  }
};

// one stage of a colour layer's products: NSUB 64-wide sub-slabs of the
// colour activations from slab `a_slab0` on against the stage, LAST
// k-steps in the last of them; FIRST overwrites the accumulators
template <int NSUB, int LAST, bool FIRST>
__device__ __forceinline__ void colour_stage(float (&acc)[64],
                                             Consumer<kStages>& c,
                                             uint32_t a_base, int a_slab0,
                                             uint32_t& prev, int lane) {
  const uint32_t st = c.wait();
#pragma unroll
  for (int u = 0; u < NSUB; ++u) {
    const uint32_t a = a_base + (a_slab0 + u) * kASlabBytes;
    const uint32_t b = c.r.data + st * kSlabBytes + u * kSubSlab;
#pragma unroll
    for (int ks = 0; ks < (u == NSUB - 1 ? LAST : 4); ++ks)
      wgmma_n128(acc, make_desc(a + ks * 32), make_desc(b + ks * 32),
                 !(FIRST && u == 0 && ks == 0));
  }
  wg_commit();
  if (!FIRST) {
    wg_wait<1>();
    c.release(prev, lane);
  }
  prev = st;
  ++c.n;
}

__device__ __forceinline__ void colour_finish(float (&acc)[64],
                                              Consumer<kStages>& c,
                                              uint32_t prev, int lane) {
  wg_wait<0>();
  c.release(prev, lane);
  fence_regs(acc);
}

// The tower's policy (run_tower in tower.cuh): the rows are the pairs the
// selection wrote, k = 0 .. nk - 1 of every slot that is not masked off;
// a slot's sigma and `found` leave here, its K-sums go to the scratch as
// the colour tower's bf16 input row.
struct ChunkPolicy {
  static constexpr bool kRoundBias = true;
  const bf16* emb;
  const float* dists;
  const float* cd;
  Scratch in;
  float* sig;
  uint8_t* found;
  int act_super;

  __device__ __forceinline__ unsigned load_slot(int m, int K, float* w,
                                                bool& live) const {
    const int nk = in.nk[m];
    for (int k = 0; k < nk; ++k) w[k] = in.wk[(size_t)m * K + k];
    live = nk >= 0;
    return (1u << max(nk, 0)) - 1u;
  }

  // the selection has written the slots that are masked off
  __device__ __forceinline__ void no_row(int, unsigned, int, int, int) const {}

  __device__ __forceinline__ void finish(const float (&acc)[128], float d0,
                                         float d1, const float* F, Tables& T,
                                         unsigned char* A, int m0, int n_take,
                                         int, int wg, int ww, int lane) const {
    const float bd = __ldg(F + kBD);
    float al[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float y = bf_round(bf_round(h ? d1 : d0) + bd);
      al[h] = act_super ? log1pf(expf(-fabsf(y - 1.f))) + fmaxf(y - 1.f, 0.f)
                        : fmaxf(y, 0.f);
    }
    const signed char* nk = in.nk + m0;
    float* sg = sig + m0;
    uint8_t* fnd = found + m0;
    bf16* hw = in.hw + (size_t)m0 * kH;
    slot_sums(
        acc, al[0], al[1], T, A, n_take, wg, ww, lane,
        [nk, sg, fnd](int i, float s, int n) {
          if (nk[i] >= 0) {
            sg[i] = s;
            fnd[i] = n > 0;
          }
        },
        [hw](int i, int col, float v) {
          hw[i * kH + col] = __float2bfloat16(v);
        });
  }
};

__global__ void __launch_bounds__(kThreads, 1)
chunk_tower_kernel(const ChunkPolicy p, const unsigned char* __restrict__ W,
                   const float* __restrict__ F, int M, int K) {
  run_tower(p, W, F, M, K);
}

// ---------------------------------------------------------------------
// the colour tower on the slots: a warpgroup's tile is 64 consecutive
// slots, a row per slot
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
chunk_colour_kernel(Scratch in, const unsigned char* __restrict__ W,
                    const float* __restrict__ F, float* __restrict__ rgb,
                    int M) {
  Block& sm = block_smem();
  Consumer<kStages> ring_c;
  int warp, lane;
  if (!block_begin<kColourSeq>(sm, W, ColourEntry(), ring_c, warp, lane))
    return;
  const int wg = warp >> 2, ww = warp & 3;
  unsigned char* A = sm.a[wg];
  const uint32_t a_base = smem_u32(A);
  const int n_tiles = (M + kWgRows - 1) / kWgRows;
  const int q4 = lane & 3, r0 = ww * 16 + (lane >> 2), rx = r0 & 7;
  float cacc[64];

  // both warpgroups make the same number of rounds: the ring is shared
  for (int it = 0; (it * (int)gridDim.x + (int)blockIdx.x) * 2 < n_tiles;
       ++it) {
    const int tile = (it * (int)gridDim.x + (int)blockIdx.x) * 2 + wg;
    if (tile >= n_tiles || (TOWER_PROBE & 16)) {
      ring_c.drain(kColourSeq, lane);
      continue;
    }
    const int m0 = tile * kWgRows;

    // ---- rows: the slot's K-sums (256) and PE(viewdir) (24), zeros to
    // 288. Rows of slots that are masked off or past M stay as they are:
    // a row's products touch no other row and are not written out ----
#pragma unroll 4
    for (int r = ww; r < kWgRows; r += 4) {
      const int m = m0 + r;
      if (m >= M || in.nk[m] < 0) continue;   // warp-uniform
      *(uint4*)(A + a_offset(r, 8 * lane)) =
          *(const uint4*)(in.hw + (size_t)m * kH + 8 * lane);
      // block layout: sin(v*2^j) at 256 + j*3+a, cos at 268 + j*3+a
      if (lane < 3 * kNvf) {
        const int f = lane / 3, a = lane % 3;
        const float v =
            bf_round(in.vd[(size_t)m * 3 + a]) * (float)(1 << f);
        *(bf16*)(A + a_offset(r, 256 + lane)) = __float2bfloat16(sinf(v));
        *(bf16*)(A + a_offset(r, 256 + 3 * kNvf + lane)) =
            __float2bfloat16(cosf(v));
      } else if (lane >= 6 * kNvf) {
        *(bf16*)(A + a_offset(r, 256 + lane)) = __float2bfloat16(0.f);
      }
    }
    fence_async_smem();
    wg_bar(wg);

#pragma unroll
    for (int layer = 0; layer < 3; ++layer) {
      uint32_t prev = 0;
      wg_fence();
      colour_stage<2, 4, true>(cacc, ring_c, a_base, 0, prev, lane);
      if (layer == 0) {
        colour_stage<2, 4, false>(cacc, ring_c, a_base, 2, prev, lane);
        colour_stage<1, 2, false>(cacc, ring_c, a_base, 4, prev, lane);
      }
      colour_finish(cacc, ring_c, prev, lane);
      const float* bias = F + (layer == 0 ? kBC0 : layer == 1 ? kBC1 : kBC2);
      if (layer < 2) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 b = __ldg((const float2*)(bias + 8 * j + 2 * q4));
          unsigned char* p = A + (j >> 3) * kASlabBytes + r0 * 128 +
                             (((j & 7) ^ rx) << 4) + q4 * 4;
          *(__nv_bfloat162*)p = __floats2bfloat162_rn(
              bias_act<true>(cacc[4 * j], b.x),
              bias_act<true>(cacc[4 * j + 1], b.y));
          *(__nv_bfloat162*)(p + 8 * 128) = __floats2bfloat162_rn(
              bias_act<true>(cacc[4 * j + 2], b.x),
              bias_act<true>(cacc[4 * j + 3], b.y));
        }
        fence_async_smem();
        wg_bar(wg);
      } else {
        // colour head 128 -> 3 from the registers
        float o[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 b = __ldg((const float2*)(bias + 8 * j + 2 * q4));
          const float x00 = bf_round(bias_act<true>(cacc[4 * j], b.x));
          const float x01 = bf_round(bias_act<true>(cacc[4 * j + 1], b.y));
          const float x10 = bf_round(bias_act<true>(cacc[4 * j + 2], b.x));
          const float x11 = bf_round(bias_act<true>(cacc[4 * j + 3], b.y));
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float2 w = __ldg(
                (const float2*)(F + kWCH + ch * kHC + 8 * j + 2 * q4));
            o[0][ch] = o[0][ch] + x00 * w.x;
            o[0][ch] = o[0][ch] + x01 * w.y;
            o[1][ch] = o[1][ch] + x10 * w.x;
            o[1][ch] = o[1][ch] + x11 * w.y;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            float v = o[h][ch];
            v = v + __shfl_xor_sync(0xffffffffu, v, 1);
            v = v + __shfl_xor_sync(0xffffffffu, v, 2);
            const int m = m0 + r0 + 8 * h;
            if (q4 == 0 && m < M && in.nk[m] >= 0) {
              const float y = bf_round(bf_round(v) + __ldg(F + kBCH + ch));
              const float sg = 1.f / (1.f + expf(-y));
              rgb[(size_t)m * 3 + ch] = sg * (1.f + 2e-3f) - 1e-3f;
            }
          }
      }
    }
    wg_bar(wg);   // the next tile's rows overwrite this tile's
  }
  block_end(sm, ring_c);
}

}  // namespace

extern "C" int fused_chunk_n_weight_bytes() { return kNWeightBytes; }
extern "C" int fused_chunk_n_params() { return kNParams; }
// bytes of scratch the entry point needs for M slots of K neighbours
extern "C" long long fused_chunk_scratch_bytes(int M, int K) {
  return (long long)M * K * kPairBytes + (long long)M * kSlotBytes;
}

extern "C" int fused_chunk_decode(const void* kmeta, const void* kcand,
                                  const void* kxyz, const void* qslot,
                                  const void* locs, const void* center,
                                  const void* rd, const void* mask,
                                  const void* consts, const void* weights,
                                  const void* params, void* scratch,
                                  void* sig, void* rgb, void* found, int M,
                                  int C, int K, float radius2,
                                  int num_shells, int act_super,
                                  void* stream) {
  if (C < 1 || C > knn::kCMax || K < 1 || K > kKMax)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const Scratch s = carve(scratch, M, K);
  const int per_block = kSelectThreads / 32 * 4;
  chunk_select_kernel<<<(M + per_block - 1) / per_block, kSelectThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)kmeta, (const bf16*)kcand, (const bf16*)kxyz,
      (const int32_t*)qslot, (const float*)locs, (const float*)center,
      (const float*)rd, (const uint8_t*)mask, (const float*)consts, s,
      (float*)sig, (float*)rgb, (uint8_t*)found, M, C, K, radius2,
      num_shells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  if ((err = persistent_blocks(chunk_tower_kernel, (M + kSpan - 1) / kSpan,
                               blocks)) != cudaSuccess)
    return (int)err;
  const ChunkPolicy p = {s.emb, s.dists, s.cd, s, (float*)sig,
                         (uint8_t*)found, act_super};
  chunk_tower_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      p, (const unsigned char*)weights, (const float*)params, M, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = persistent_blocks(chunk_colour_kernel,
                               (M + kWgRows - 1) / kWgRows, blocks)) !=
      cudaSuccess)
    return (int)err;
  chunk_colour_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      s, (const unsigned char*)weights, (const float*)params, (float*)rgb,
      M);
  return (int)cudaGetLastError();
}
