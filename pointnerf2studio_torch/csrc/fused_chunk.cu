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
//   * chunk_select_kernel (csrc/chunk_select.cuh, at eight lanes a
//     slot; csrc/chunk_any.cu launches it at 16 and 32 for the widths
//     this file is not built for), many small blocks (the gathers are bound by
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

#include "chunk_select.cuh"
#include "tower.cuh"

using namespace tower;
using chunksel::Scratch;

namespace {

constexpr int kHC = 128;                // colour tower width
constexpr int kNvf = 4;                 // PE octaves of the view direction
constexpr int kColourSeq = 5;           // stage uses of a colour tile
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
  return (long long)M * K * chunksel::kPairBytes +
         (long long)M * chunksel::slot_bytes(kH);
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
  const Scratch s = chunksel::carve(scratch, M, K, kH);
  const int per_block = chunksel::kSelectThreads / 32 * 4;
  chunksel::chunk_select_kernel<8>
      <<<(M + per_block - 1) / per_block, chunksel::kSelectThreads, 0,
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
