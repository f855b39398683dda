// The radiance decoder's MLP towers at any width of the port's envelope,
// for the widths the tuned wgmma tower of csrc/tower.cuh is not built for.
// Shared by csrc/decode_any.cu (fused_decode_any, fused_decode2_any) and
// csrc/chunk_any.cu (fused_chunk_decode_any). They replace, at those
// widths, the towers inside the Pallas kernels pointnerf2studio_tpu/ops/
// fused_decode.py::_pair_kernel / ::_kacc_kernel and ops/fused_chunk.py::
// _kernel, which take every width as a static shape.
//
// The per-neighbour tower: layer 1 [emb (C), PE(emb) (2 C nff), PE(dists)
// (2 D ndf)] -> H, layer 2 H -> H, layer 3 [h (H), colour and dirdot (7)]
// -> H, layer 4 H -> H, and the H -> 1 density head; runtime C <= 64,
// D <= 8, H <= 512, octaves <= 10, K <= 32. The colour tower of the fused
// chunk: [K-sum (H), PE(viewdir) (6 nvf)] -> HC, then HC -> HC layers,
// and the HC -> 3 head; HC <= 512, up to 8 layers.
//
// What bounds it on Hopper: tensor-core operations (at hidden 512 some
// 1.95 MFLOP a row against 150 bytes of input), and under them the weights
// that every 64-row tile reads from L2 (2 MB at hidden 512). This is the
// simple generic design; the tuned tower of tower.cuh is the fast one:
//   * a block of 8 warps runs tiles of 64 rows; a slot's rows never split
//     across tiles, so the K-sums are taken in the tile in k order. Rows
//     whose weight is exactly 0 (or, in the chunk, k >= the neighbours
//     found) add exactly 0 to every sum and write exactly 0, so only the
//     live rows are packed into tiles: the block scans up to 256 slots of
//     its span at a time (a thread a slot, a block-wide prefix sum of the
//     row counts) and takes the longest run whose rows fit 64;
//   * products are mma.sync m16n8k16 (bf16 x bf16 -> f32) fed by ldmatrix;
//     a warp owns all 64 rows and NT n-tiles of 8 columns (the layer's
//     width padded to 64 NT, NT = 1, 2, 4 or 8, a template parameter), so a
//     thread holds 16 NT f32 accumulators;
//   * the weights are packed on the host as [out][in] bf16, zero padded
//     (zero weights with zero bias add exactly 0, so padding is exact); a
//     layer streams them through a double buffer of 32-input stages with
//     cp.async (16-byte pieces, the chunk index XOR-swizzled by the row so
//     that ldmatrix reads them without bank conflicts);
//   * activations ping-pong between two shared-memory buffers in bf16 (row
//     stride padded by 16 bytes: conflict-free ldmatrix); a first layer's
//     inputs - 1,464 columns at 64 features and 10 octaves - are formed per
//     32-column stage in shared memory, each PE value by one precise sinf
//     or cosf of the bf16 input times 2^f (no double-angle recurrence);
//   * the last layer leaves as an f32 tile over both activation buffers;
//     the density head, the row outputs and the K-sums are read from it.
// The rounding points are the plain versions': bf16 operands, f32
// accumulation, f32 bias (decode) or bf16(bf16(acc) + bf16 bias) (chunk),
// LeakyReLU(0.1) in f32, bf16 between layers, alpha * w and h * w summed
// over k in f32 in k order. The including sources are compiled with
// -fmad=false so that those adds and multiplies round separately.
// Shared memory at hidden 512: 222,248 bytes a block (138 KB activations,
// 64 KB weight stages, 15 KB tables), one block an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tany {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;             // rows of a tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKc = 32;               // inputs of one weight stage
constexpr int kStageRow = kKc * 2;    // bytes of a weight row in a stage
constexpr int kChunkStride = kKc * 2 + 16;   // a formed input stage's rows
constexpr int kEmbMax = 64;           // widest embedding
constexpr int kDistMax = 8;
constexpr int kCD = 7;                // colour (3) + dirdot (4)
constexpr int kSlotsMax = kThreads;   // slots one tile may cover

// the first-layer inputs of the per-neighbour tower, padded to a stage
__host__ __device__ inline int tower_kin1(int C, int D, int nff, int ndf) {
  const int n = C + 2 * C * nff + 2 * D * ndf;
  return (n + kKc - 1) / kKc * kKc;
}
// a layer's width padded to 64 NT outputs, NT a power of two up to 8
__host__ __device__ inline int padded_width(int h) {
  return h <= 64 ? 64 : h <= 128 ? 128 : h <= 256 ? 256 : 512;
}
// bf16 elements of the tower's packed weights: [Np][kin1], [Np][Np],
// [Np][Np + 32] (h, then colour and dirdot at Np .. Np + 6), [Np][Np]
__host__ __device__ inline long long tower_weights(int C, int D, int H,
                                                   int nff, int ndf) {
  const long long np = padded_width(H);
  return np * (tower_kin1(C, D, nff, ndf) + np + (np + 32) + np);
}
// f32 parameters: b1 b2 b3 b4 wd, each [Np], then bd padded to 16
__host__ __device__ inline int tower_params(int H) {
  return 5 * padded_width(H) + 16;
}
// the activation buffers' row stride (bytes) for inputs up to kin wide;
// at least 96 inputs, so that a first layer's two formed stages (64 rows
// of kChunkStride) fit in the buffer that layer writes
__host__ __device__ inline int act_stride(int kin) {
  return (kin < 96 ? 96 : kin) * 2 + 16;
}

struct Tables {
  bf16 emb[kRows][kEmbMax];
  float dist[kRows][kDistMax];
  float cd[kRows][8];
  float wk[kRows];
  float alpha[kRows];
  int src[kRows];               // row g = m * K + k of the inputs
  unsigned bits[kSlotsMax];     // the tile's slots' live rows
  int first[kSlotsMax];         // a slot's first row in the tile
  int wsum[kWarps];
  int nrows;
};

__host__ __device__ inline int tower_smem(int np) {
  return 2 * kRows * act_stride(np + 32) + 2 * np * kStageRow +
         (int)sizeof(Tables);
}
__host__ __device__ inline int colour_smem(int nc) {
  return 2 * kRows * act_stride(nc) + 2 * nc * kStageRow;
}

// ---- small numerics ----
__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float leaky(float x) {
  return fmaxf(x, 0.1f * x);   // = x > 0 ? x : 0.1 x
}
// LeakyReLU of the biased sum: f32 bias (decode) or bf16(bf16(acc) + b),
// b a bf16 value (chunk)
template <bool kRoundBias>
__device__ __forceinline__ float bias_act(float acc, float b) {
  return leaky(kRoundBias ? bf_round(bf_round(acc) + b) : acc + b);
}

// ---- PTX ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one stage of weights: inputs k0 .. k0 + 31 of the np rows of w [np][kin],
// 64 bytes a row, the 16-byte chunk c of row n stored at c ^ ((n >> 1) & 3)
__device__ __forceinline__ void load_stage(uint32_t dst,
                                           const bf16* __restrict__ w,
                                           int kin, int k0, int np) {
  for (int i = threadIdx.x; i < np * 4; i += kThreads) {
    const int n = i >> 2, c = i & 3;
    cp16(dst + n * kStageRow + ((c ^ ((n >> 1) & 3)) << 4),
         w + (size_t)n * kin + k0 + c * 8);
  }
}

// the products of one stage: rows 0-63 of A (columns a_k0 .. a_k0 + 31,
// row stride a_stride bytes) against the warp's NT n-tiles of the stage
template <int NT>
__device__ __forceinline__ void stage_mma(float (&acc)[4][NT][4],
                                          uint32_t a_base, int a_stride,
                                          int a_k0, uint32_t w_stage,
                                          int warp, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = mt * 16 + (lane & 15);
      const int c = a_k0 + ks * 16 + ((lane >> 4) << 3);
      ldsm_x4(a_base + r * a_stride + c * 2, a[mt][0], a[mt][1], a[mt][2],
              a[mt][3]);
    }
    const int kc = ks * 2 + ((lane >> 3) & 1);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      if (NT >= 2) {
        const int n = warp * NT * 8 + nt * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(w_stage + n * kStageRow + ((kc ^ ((n >> 1) & 3)) << 4), b[0],
                b[1], b[2], b[3]);
      } else {
        const int n = warp * 8 + (lane & 7);
        ldsm_x2(w_stage + n * kStageRow + ((kc ^ ((n >> 1) & 3)) << 4), b[0],
                b[1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
        if (NT >= 2) mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// One layer's products: acc = A [64, kin] x W [kin, 64 NT], W packed as
// [64 NT][kin]. A is the activation buffer `a` (row stride a_stride), or,
// with a `fill`, formed stage by stage: fill(dst, k0) writes columns
// k0 .. k0 + 31 of all 64 rows at dst (row stride kChunkStride); the two
// formed stages live at `a`. Every thread of the block calls it.
template <int NT, bool FORMED, class Fill>
__device__ __forceinline__ void run_layer(float (&acc)[4][NT][4],
                                          const bf16* __restrict__ w, int kin,
                                          unsigned char* wst, unsigned char* a,
                                          int a_stride, const Fill& fill,
                                          int warp, int lane) {
  constexpr int np = NT * 64;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const int nst = kin / kKc;
  const uint32_t wst0 = smem_u32(wst);
  load_stage(wst0, w, kin, 0, np);
  cp_commit();
  if (FORMED) fill(a, 0);
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) {
      load_stage(wst0 + ((s + 1) & 1) * np * kStageRow, w, kin, (s + 1) * kKc,
                 np);
      cp_commit();
      if (FORMED) fill(a + ((s + 1) & 1) * kRows * kChunkStride, (s + 1) * kKc);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (FORMED)
      stage_mma<NT>(acc, smem_u32(a + (s & 1) * kRows * kChunkStride),
                    kChunkStride, 0, wst0 + (s & 1) * np * kStageRow, warp,
                    lane);
    else
      stage_mma<NT>(acc, smem_u32(a), a_stride, s * kKc,
                    wst0 + (s & 1) * np * kStageRow, warp, lane);
    __syncthreads();
  }
}

struct NoFill {
  __device__ void operator()(unsigned char*, int) const {}
};

// bias + LeakyReLU of the accumulators, rounded to bf16 into the
// activation buffer `out` (row stride `stride` bytes)
template <int NT, bool kRoundBias>
__device__ __forceinline__ void store_act(const float (&acc)[4][NT][4],
                                          const float* __restrict__ bias,
                                          unsigned char* out, int stride,
                                          int warp, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = warp * NT * 8 + nt * 8 + (lane & 3) * 2;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = mt * 16 + (lane >> 2);
      *(__nv_bfloat162*)(out + row * stride + col * 2) = __floats2bfloat162_rn(
          bias_act<kRoundBias>(acc[mt][nt][0], b0),
          bias_act<kRoundBias>(acc[mt][nt][1], b1));
      *(__nv_bfloat162*)(out + (row + 8) * stride + col * 2) =
          __floats2bfloat162_rn(bias_act<kRoundBias>(acc[mt][nt][2], b0),
                                bias_act<kRoundBias>(acc[mt][nt][3], b1));
    }
  }
}

// the same into the f32 tile F (row stride ldf floats), rounded to bf16
// values where `round_out`
template <int NT, bool kRoundBias>
__device__ __forceinline__ void store_f32(const float (&acc)[4][NT][4],
                                          const float* __restrict__ bias,
                                          float* F, int ldf, bool round_out,
                                          int warp, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = warp * NT * 8 + nt * 8 + (lane & 3) * 2;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = mt * 16 + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = bias_act<kRoundBias>(acc[mt][nt][2 * h], b0);
        float v1 = bias_act<kRoundBias>(acc[mt][nt][2 * h + 1], b1);
        if (round_out) {
          v0 = bf_round(v0);
          v1 = bf_round(v1);
        }
        *(float2*)(F + (row + 8 * h) * ldf + col) = make_float2(v0, v1);
      }
    }
  }
}

// the per-neighbour tower's inputs and outputs
enum Mode { kPair = 0, kKacc = 1, kChunk = 2 };

struct TowerArgs {
  const bf16* emb;          // [M*K, C]
  const float* dists;       // [M*K, D]
  const float* cd;          // [M*K, 7] colour, dirdot
  const float* wk;          // [M*K]
  const signed char* nk;    // kChunk: [M] neighbours found, -1 masked off
  const bf16* w;            // packed weights (tower_weights)
  const float* f;           // packed parameters (tower_params)
  float* aw;                // kPair [M*K], kKacc [M], kChunk sigma [M]
  void* hw;                 // kPair bf16 [M*K, H], kKacc f32 [M, H],
                            // kChunk bf16 [M, hs]
  unsigned char* found;     // kChunk [M]
  int M, K, C, D, H, nff, ndf, span, hs, act_super;
};

// PE value j of the block layout of x [n]: sin(x_i 2^f) for j < n * nf
// (octave f = j / n, channel i = j % n), then the cosines; x bf16 values
template <class T>
__device__ __forceinline__ float pe_value(const T* x, int n, int nf, int j) {
  const int sc = j >= n * nf;
  j -= sc * n * nf;
  const int f = j / n, i = j - f * n;
  const float v = (float)x[i] * (float)(1 << f);
  return sc ? cosf(v) : sinf(v);
}

// eight bf16 values as one 16-byte store
__device__ __forceinline__ void store8(unsigned char* dst, const float (&v)[8]) {
  uint4 u;
  uint32_t* w = (uint32_t*)&u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *(const uint32_t*)&p;
  }
  *(uint4*)dst = u;
}

// The per-neighbour tower at 64 NT padded outputs, one mode. A block
// walks spans of a.span slots (span, span + gridDim.x, ...).
template <int NT, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
tower_any_kernel(const TowerArgs a) {
  constexpr int np = NT * 64;
  constexpr bool kRB = MODE == kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = act_stride(np + 32);
  unsigned char* X = smem;
  unsigned char* Y = smem + kRows * S;
  float* Ft = (float*)smem;           // the last layer, f32, over X and Y
  const int ldf = np + 4;
  unsigned char* wst = smem + 2 * kRows * S;
  Tables& T = *(Tables*)(wst + 2 * np * kStageRow);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int K = a.K, C = a.C, D = a.D, H = a.H;
  const int kin1 = tower_kin1(C, D, a.nff, a.ndf);
  const bf16* w1 = a.w;
  const bf16* w2 = w1 + (size_t)np * kin1;
  const bf16* w3 = w2 + (size_t)np * np;
  const bf16* w4 = w3 + (size_t)np * (np + 32);
  const float* b1 = a.f;
  const float* b2 = b1 + np;
  const float* b3 = b2 + np;
  const float* b4 = b3 + np;
  const float* wd = b4 + np;
  const float bd = __ldg(wd + np);
  float acc[4][NT][4];
  const int nspans = (a.M + a.span - 1) / a.span;

  for (int span = blockIdx.x; span < nspans; span += gridDim.x) {
    int s0 = span * a.span;
    const int s_end = min(a.M, s0 + a.span);
    while (s0 < s_end) {
      // ---- the tile: the longest run of slots from s0 whose rows fit
      const int m = s0 + t;
      unsigned bits = 0;
      bool on = false;
      if (m < s_end) {
        if (MODE == kChunk) {
          const int nk = a.nk[m];
          on = nk >= 0;
          bits = nk <= 0 ? 0u : nk >= 32 ? 0xffffffffu : (1u << nk) - 1u;
        } else {
          on = true;
          for (int k = 0; k < K; ++k)
            if (a.wk[(size_t)m * K + k] != 0.f) bits |= 1u << k;
        }
      }
      const int cnt = __popc(bits);
      int pre = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, pre, o);
        if (lane >= o) pre += v;
      }
      if (lane == 31) T.wsum[warp] = pre;
      __syncthreads();
      for (int w = 0; w < warp; ++w) pre += T.wsum[w];
      const bool take_me = m < s_end && pre <= kRows;
      const int take = __syncthreads_count(take_me);
      if (take_me) {
        const int first = pre - cnt;
        T.bits[t] = bits;
        T.first[t] = on ? first : -1;
        int j = first;
        for (int k = 0; k < K; ++k)
          if ((bits >> k) & 1u) T.src[j++] = m * K + k;
        if (t == take - 1) T.nrows = pre;
      }
      __syncthreads();
      const int nrows = T.nrows;

      if (nrows > 0) {
        // ---- the rows' inputs
        for (int i = t; i < nrows * C; i += kThreads) {
          const int r = i / C, c = i - r * C;
          T.emb[r][c] = a.emb[(size_t)T.src[r] * C + c];
        }
        for (int i = t; i < nrows * D; i += kThreads) {
          const int r = i / D, c = i - r * D;
          T.dist[r][c] = bf_round(a.dists[(size_t)T.src[r] * D + c]);
        }
        for (int i = t; i < nrows * kCD; i += kThreads) {
          const int r = i / kCD, c = i - r * kCD;
          T.cd[r][c] = bf_round(a.cd[(size_t)T.src[r] * kCD + c]);
        }
        if (t < nrows) T.wk[t] = a.wk[T.src[t]];
        __syncthreads();

        // ---- layer 1 on inputs formed stage by stage (in X)
        const int ne = 2 * C * a.nff, nd = 2 * D * a.ndf;
        auto fill = [&](unsigned char* dst, int k0) {
          const int r = t >> 2, c0 = (t & 3) * 8;
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int j = k0 + c0 + i;
            float x = 0.f;
            if (r >= nrows)
              x = 0.f;
            else if (j < C)
              x = __bfloat162float(T.emb[r][j]);
            else if (j < C + ne)
              x = pe_value(T.emb[r], C, a.nff, j - C);
            else if (j < C + ne + nd)
              x = pe_value(T.dist[r], D, a.ndf, j - C - ne);
            v[i] = x;
          }
          store8(dst + r * kChunkStride + c0 * 2, v);
        };
        run_layer<NT, true>(acc, w1, kin1, wst, X, 0, fill, warp, lane);
        store_act<NT, kRB>(acc, b1, X, S, warp, lane);
        __syncthreads();
        // ---- layer 2: X -> Y; then colour and dirdot at Y's columns np ..
        run_layer<NT, false>(acc, w2, np, wst, X, S, NoFill(), warp, lane);
        store_act<NT, kRB>(acc, b2, Y, S, warp, lane);
        for (int i = t; i < kRows * 32; i += kThreads) {
          const int r = i >> 5, c = i & 31;
          const float v = r < nrows && c < kCD ? T.cd[r][c] : 0.f;
          *(bf16*)(Y + r * S + (np + c) * 2) = __float2bfloat16(v);
        }
        __syncthreads();
        // ---- layer 3: Y -> X; layer 4: X -> the f32 tile
        run_layer<NT, false>(acc, w3, np + 32, wst, Y, S, NoFill(), warp,
                             lane);
        store_act<NT, kRB>(acc, b3, X, S, warp, lane);
        __syncthreads();
        run_layer<NT, false>(acc, w4, np, wst, X, S, NoFill(), warp, lane);
        store_f32<NT, kRB>(acc, b4, Ft, ldf, MODE == kPair, warp, lane);
        __syncthreads();

        // ---- the density head, a warp a row: alpha
        for (int r = warp; r < nrows; r += kWarps) {
          float d = 0.f;
          for (int c = lane; c < H; c += 32)
            d = d + bf_round(Ft[r * ldf + c]) * __ldg(wd + c);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            d = d + __shfl_xor_sync(0xffffffffu, d, o);
          float al;
          if (MODE == kChunk) {
            const float y = bf_round(bf_round(d) + bd);
            al = a.act_super
                     ? log1pf(expf(-fabsf(y - 1.f))) + fmaxf(y - 1.f, 0.f)
                     : fmaxf(y, 0.f);
          } else {
            al = fmaxf(d + bd, 0.f);
          }
          if (lane == 0) T.alpha[r] = al;
        }
        __syncthreads();
      }

      // ---- the outputs
      if (MODE == kPair) {
        bf16* hw = (bf16*)a.hw;
        for (int r = warp; r < nrows; r += kWarps) {
          const float wr = T.wk[r];
          const size_t g = (size_t)T.src[r];
          if (lane == 0) a.aw[g] = T.alpha[r] * wr;
          for (int c = lane; c < H; c += 32)
            hw[g * H + c] = __float2bfloat16(Ft[r * ldf + c] * wr);
        }
        // rows with no weight write zeros
        for (int e = warp; e < take * K; e += kWarps) {
          const int i = e / K, k = e - i * K;
          if ((T.bits[i] >> k) & 1u) continue;
          const size_t g = (size_t)(s0 + i) * K + k;
          if (lane == 0) a.aw[g] = 0.f;
          for (int c = lane; c < H; c += 32) hw[g * H + c] = __float2bfloat16(0.f);
        }
      } else {
        // the K-sums of each slot in k order; a slot with no rows gets 0
        for (int i = t; i < take; i += kThreads) {
          if (T.first[i] < 0) continue;
          const int r0 = T.first[i], n = __popc(T.bits[i]);
          float s = 0.f;
          for (int r = r0; r < r0 + n; ++r) s = s + T.alpha[r] * T.wk[r];
          a.aw[s0 + i] = s;
          if (MODE == kChunk) a.found[s0 + i] = n > 0;
        }
        for (int e = t; e < take * H; e += kThreads) {
          const int i = e / H, c = e - i * H;
          if (T.first[i] < 0) continue;
          const int r0 = T.first[i], n = __popc(T.bits[i]);
          float s = 0.f;
          for (int r = r0; r < r0 + n; ++r) s = s + Ft[r * ldf + c] * T.wk[r];
          if (MODE == kKacc)
            ((float*)a.hw)[(size_t)(s0 + i) * H + c] = s;
          else
            ((bf16*)a.hw)[(size_t)(s0 + i) * a.hs + c] = __float2bfloat16(s);
        }
      }
      __syncthreads();
      s0 += take;
    }
  }
}

// the colour tower of the fused chunk on its slots, a row a slot
struct ColourArgs {
  const bf16* hw;           // [M, hs] the K-sums, bf16
  const float* vd;          // [M, 3] Rw2c-rotated view direction
  const signed char* nk;    // [M] -1: slot masked off
  const bf16* w;            // colour weights: [Nc][kin1], then [Nc][Nc]...
  const float* f;           // bc_l [Nc] each layer, wch [3][Nc], bch [3]
  float* rgb;               // [M, 3]
  int M, H, hs, nvf, HC, layers;
};

__host__ __device__ inline int colour_kin1(int H, int nvf) {
  return (H + 6 * nvf + kKc - 1) / kKc * kKc;
}
__host__ __device__ inline long long colour_weights(int H, int HC, int layers,
                                                    int nvf) {
  const long long nc = padded_width(HC);
  return nc * colour_kin1(H, nvf) + (long long)(layers - 1) * nc * nc;
}
__host__ __device__ inline int colour_params(int HC, int layers) {
  return layers * padded_width(HC) + 3 * padded_width(HC) + 16;
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
colour_any_kernel(const ColourArgs a) {
  constexpr int nc = NT * 64;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = act_stride(nc);
  unsigned char* buf[2] = {smem, smem + kRows * S};
  unsigned char* wst = smem + 2 * kRows * S;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int H = a.H, nvf = a.nvf;
  const int kin1 = colour_kin1(H, nvf);
  const float* wch = a.f + a.layers * nc;
  const float* bch = wch + 3 * nc;
  float acc[4][NT][4];
  const int n_tiles = (a.M + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * kRows;
    // layer 1 on [K-sum, PE(viewdir)] formed stage by stage (in buffer 0)
    auto fill = [&](unsigned char* dst, int k0) {
      const int r = t >> 2, c0 = (t & 3) * 8, m = m0 + r;
      const bool live = m < a.M && a.nk[m] >= 0;
      float vd[3] = {0.f, 0.f, 0.f};
      if (live)
        for (int ax = 0; ax < 3; ++ax)
          vd[ax] = bf_round(a.vd[(size_t)m * 3 + ax]);
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = k0 + c0 + i;
        float x = 0.f;
        if (live) {
          if (j < H)
            x = __bfloat162float(a.hw[(size_t)m * a.hs + j]);
          else if (j < H + 6 * nvf)
            x = pe_value(vd, 3, nvf, j - H);
        }
        v[i] = x;
      }
      store8(dst + r * kChunkStride + c0 * 2, v);
    };
    run_layer<NT, true>(acc, a.w, kin1, wst, buf[0], 0, fill, warp, lane);
    store_act<NT, true>(acc, a.f, buf[0], S, warp, lane);
    __syncthreads();
    int cur = 0;
    const bf16* wl = a.w + (size_t)nc * kin1;
    for (int l = 1; l < a.layers; ++l) {
      run_layer<NT, false>(acc, wl, nc, wst, buf[cur], S, NoFill(), warp,
                           lane);
      store_act<NT, true>(acc, a.f + l * nc, buf[cur ^ 1], S, warp, lane);
      __syncthreads();
      cur ^= 1;
      wl += (size_t)nc * nc;
    }
    // the head HC -> 3, a warp a row
    const unsigned char* x = buf[cur];
    for (int r = warp; r < kRows; r += kWarps) {
      const int m = m0 + r;
      if (m >= a.M || a.nk[m] < 0) continue;     // warp-uniform
      float o[3] = {0.f, 0.f, 0.f};
      for (int c = lane; c < a.HC; c += 32) {
        const float v = __bfloat162float(*(const bf16*)(x + r * S + c * 2));
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) o[ch] = o[ch] + v * __ldg(wch + ch * nc + c);
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float d = o[ch];
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          d = d + __shfl_xor_sync(0xffffffffu, d, s);
        if (lane == 0) {
          const float y = bf_round(bf_round(d) + __ldg(bch + ch));
          const float sg = 1.f / (1.f + expf(-y));
          a.rgb[(size_t)m * 3 + ch] = sg * (1.f + 2e-3f) - 1e-3f;
        }
      }
    }
    __syncthreads();   // the next tile's layer 1 overwrites buffer 0
  }
}

// blocks for a kernel of `smem` bytes: every SM filled, at most `work`
template <class Kern>
cudaError_t grid_for(Kern kern, int smem, int work, int& blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per, kern, kThreads, smem)) != cudaSuccess)
    return err;
  if (per < 1) return cudaErrorInvalidConfiguration;
  blocks = max(1, min(work, sms * per));
  return cudaSuccess;
}

// the per-neighbour tower on M slots: slots split into spans of at least
// 32 so that every SM gets some
template <int NT, int MODE>
cudaError_t launch_tower_nt(TowerArgs a, cudaStream_t stream) {
  const int smem = tower_smem(NT * 64);
  int blocks = 0;
  cudaError_t err =
      grid_for(tower_any_kernel<NT, MODE>, smem, a.M, blocks);
  if (err != cudaSuccess) return err;
  a.span = max(32, (a.M + blocks - 1) / blocks);
  a.span = (a.span + 31) / 32 * 32;
  blocks = (a.M + a.span - 1) / a.span;
  tower_any_kernel<NT, MODE><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_tower(const TowerArgs& a, cudaStream_t stream) {
  if (a.M <= 0) return cudaSuccess;
  switch (padded_width(a.H)) {
    case 64: return launch_tower_nt<1, MODE>(a, stream);
    case 128: return launch_tower_nt<2, MODE>(a, stream);
    case 256: return launch_tower_nt<4, MODE>(a, stream);
    default: return launch_tower_nt<8, MODE>(a, stream);
  }
}

template <int NT>
cudaError_t launch_colour_nt(const ColourArgs& a, cudaStream_t stream) {
  const int smem = colour_smem(NT * 64);
  int blocks = 0;
  const cudaError_t err = grid_for(colour_any_kernel<NT>, smem,
                                   (a.M + kRows - 1) / kRows, blocks);
  if (err != cudaSuccess) return err;
  colour_any_kernel<NT><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

inline cudaError_t launch_colour(const ColourArgs& a, cudaStream_t stream) {
  if (a.M <= 0) return cudaSuccess;
  switch (padded_width(a.HC)) {
    case 64: return launch_colour_nt<1>(a, stream);
    case 128: return launch_colour_nt<2>(a, stream);
    case 256: return launch_colour_nt<4>(a, stream);
    default: return launch_colour_nt<8>(a, stream);
  }
}

// the envelope the generic towers take
__host__ __device__ inline bool tower_widths_ok(int C, int D, int H, int nff,
                                                int ndf, int K) {
  return C >= 1 && C <= kEmbMax && D >= 1 && D <= kDistMax && H >= 1 &&
         H <= 512 && nff >= 1 && nff <= 10 && ndf >= 1 && ndf <= 10 &&
         K >= 1 && K <= 32;
}

}  // namespace tany
