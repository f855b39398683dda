// The per-neighbour tower of the radiance decoder at every width of the
// port's envelope, warp-specialised on wgmma for Hopper. It serves the
// K-summing entry points of the generic sources: fused_decode2_any
// (csrc/decode_any.cu, mode kKacc) and the tower of
// fused_chunk_decode_any (csrc/chunk_any.cu, mode kChunk). They replace,
// at the widths the tuned tower of csrc/tower.cuh is not built for, the
// towers inside the Pallas kernels pointnerf2studio_tpu/ops/
// fused_decode.py::_kacc_kernel and ops/fused_chunk.py::_kernel.
//
// The tower: layer 1 [emb (C), PE(emb) (2 C nff), PE(dists) (2 D ndf)]
// -> H, layer 2 H -> H, layer 3 [h (H), colour and dirdot (7)] -> H,
// layer 4 H -> H, the H -> 1 density head, then per slot the sums over
// its K rows in k order of alpha * wk and h * wk; runtime C <= 64,
// D <= 8, H <= 512, octaves <= 10, K <= 32.
//
// What bounds it on Hopper: tensor-core operations (at hidden 512 some
// 1.95 MFLOP a row against 150 bytes of input), and under them the
// weights every row tile streams from L2 (2 MB a tile at hidden 512). As
// built, the work around the products bounds it first: at 512 one team
// works one tile an SM, and its PE, epilogues and K-sums (about half its
// time on the card) overlap none of its products (chip_smoke.py's probe
// builds, PERF.md). The design follows tower.cuh's, at any of the padded
// widths
// Np = 64, 128, 256, 512 (NT = Np / 64, a template parameter):
//   * Persistent blocks, one an SM: two consumer warpgroups and one
//     producer warpgroup, of which one thread works; setmaxnreg gives the
//     consumers 232 registers a thread and the producer's group 40.
//   * The weights are packed on the host once per set of weights
//     (ops/fused_decode.py::pack_tower_wg) in the shared-memory image
//     wgmma reads, in the order the tile consumes them: K-major slabs of
//     64 inputs, the 16-byte chunk c of output row n at c ^ (n & 7) (the
//     128-byte swizzle). One slab is one cp.async.bulk into a stage of a
//     ring (4 to 8 stages) on a "full" mbarrier; the consuming warps
//     release it on an "empty" one after the wgmma group that read it has
//     completed. The producer runs the tile's slab sequence over and over
//     and so prefetches across layers and tiles.
//   * Products are wgmma.mma_async m64nNk16, A and B from shared memory.
//     At Np <= 256 each warpgroup is a team of its own with its own
//     64-row tile, N = Np, so each weight byte serves 128 rows; at 512 a
//     warpgroup would need 256 accumulators a thread, so the two
//     warpgroups are one team on one 64-row tile and split N, one
//     256-output half each (each stage then holds one half: 64 rows per
//     weight byte, some 64 flop a byte of L2). The activations stay in
//     shared memory in the same swizzled K-major image, overwritten in
//     place by every hidden layer's epilogue (bias, LeakyReLU, bf16) from
//     the accumulators once the team's wgmma groups have completed.
//   * Layer 1's inputs are formed in the activation tile. First every
//     load the tile needs is issued at once (the embedding straight into
//     its columns, 16 bytes a load; the dists and weights into tables),
//     so that the rows' latencies overlap; then a thread takes a column
//     pair for 16 rows at a time, one sincosf a PE pair (each value by the
//     precise function: no double-angle recurrence, the octaves reach
//     10). Where the inputs are wider than the tile (up to 1,504 at 64
//     features, 8 dists, 10 octaves), layer 1 runs in passes of as many
//     64-column slabs as the tile holds, the accumulators carried over.
//   * Tiles are cut from one scan of a span of slots (a thread a slot:
//     its live rows as a bit mask): the longest run of up to 64 slots
//     whose rows fit 64; a slot's rows never split, rows with no weight
//     (kKacc: wk == 0; kChunk: k >= the neighbours found) are left out
//     and slots with no row get exactly 0. Spans are dealt to the teams
//     so that each team gets as many; a span is at least 16 slots, so a
//     small launch (the XLA route's 4,096 slots) still fills the SMs.
//   * The density head is a dot on the CUDA cores from the registers; the
//     K-sums are taken in f32 in k order by a thread a column over an
//     f32 staging tile of 64 rows and up to 128 columns (one or two column
//     passes a warpgroup).
// The rounding points are the plain versions': bf16 operands, f32
// accumulation, f32 bias (kKacc) or bf16(bf16(acc) + bf16 bias) (kChunk),
// LeakyReLU(0.1) in f32, bf16 between layers, h in f32 after layer 4
// (bf16-rounded for the density dot only), alpha * w and h * w summed in
// f32 in k order. The including sources are compiled with -fmad=false.
// Shared memory: 202-218 KiB a block (block_bytes), one block an SM.
// Probe builds (-DTOWER_PROBE=bits, as tower.cuh's; timed by chip_smoke.py
// --widths --probe; the results are wrong on purpose) leave one part out:
// 1 the PE columns of layer 1, 2 the wgmma products, 4 the weight copies
// and the waits on them, 8 the K-sums and slot outputs.

#pragma once

#include <algorithm>

#include "tower.cuh"

namespace twg {

typedef __nv_bfloat16 bf16;
using tower::bar_sync;
using tower::bf_round;
using tower::leaky;
using tower::make_desc;
using tower::smem_u32;

constexpr int kRows = 64;               // rows of a tile
constexpr int kConsumerThreads = 256;   // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + the producer's group
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kASlab = kRows * 128;     // 64 rows x 64 bf16 columns, 8 KB
constexpr int kTakeMax = 64;            // slots of one tile at most
constexpr int kMinSpan = 16;            // slots of a span at least
constexpr int kCD = 7;                  // colour (3) + dirdot (4)

enum Mode { kKacc = 1, kChunk = 2 };

// a K-sum column pass of a warpgroup with N outputs: kW columns staged
// as f32 [64][kLd]; kParts threads a column, each walking a share of the
// tile's slots
template <int N>
struct Ksum {
  static constexpr int kW = N < 128 ? N : 128;
  static constexpr int kLd = kW + 8;
  static constexpr int kParts = 128 / kW;
  static constexpr int kBytes = kRows * kLd * 4;
};

// the block's layout at NT = Np / 64
template <int NT>
struct Shape {
  static constexpr int kNp = 64 * NT;
  static constexpr bool kShared = NT == 8;      // one team, N split
  static constexpr int kN = kShared ? 256 : kNp;  // a warpgroup's outputs
  static constexpr int kTeams = kShared ? 1 : 2;
  static constexpr int kTeamThreads = kConsumerThreads / kTeams;
  static constexpr int kSpanMax = kTeamThreads;
  static constexpr int kHalves = kShared ? 2 : 1;   // stages a slab
  static constexpr int kSlab = 64 * kN * 2;       // bytes of a stage
  static constexpr int kStages = NT == 1 ? 8 : NT == 2 ? 6 : 4;
  static constexpr int kASlabs = NT == 1 ? 8 : NT == 2 ? 6 : NT == 4 ? 5 : 9;
  static constexpr int kReaders = kShared ? 4 : 8;  // warps reading a stage
  static_assert(kASlabs >= NT + 1, "the tile must hold layer 3's inputs");
  static_assert(kASlabs * kASlab >= Ksum<kN>::kBytes * (kShared ? 2 : 1),
                "the K-sum staging tiles must fit the activations");
};

// ---- host-side sizes ----
__host__ __device__ inline int padded_width(int h) {
  return h <= 64 ? 64 : h <= 128 ? 128 : h <= 256 ? 256 : 512;
}
__host__ __device__ inline int feature_count(int C, int D, int nff,
                                             int ndf) {
  return C + 2 * C * nff + 2 * D * ndf;
}
// 64-input slabs of the packed tower: layer 1, then Np / 64 for layers 2
// and 4 and Np / 64 + 1 for layer 3 (its colour and dirdot rows at
// inputs Np .. Np + 6 of the last)
__host__ __device__ inline int tower_slabs(int C, int D, int H, int nff,
                                           int ndf) {
  return (feature_count(C, D, nff, ndf) + 63) / 64 +
         3 * (padded_width(H) / 64) + 1;
}
// bf16 elements of the packed weights: every slab 64 inputs x Np outputs
__host__ __device__ inline long long tower_weights(int C, int D, int H,
                                                   int nff, int ndf) {
  return (long long)tower_slabs(C, D, H, nff, ndf) * 64 * padded_width(H);
}
// f32 parameters: b1 b2 b3 b4 wd, each [Np], then bd padded to 16
__host__ __device__ inline int tower_params(int H) {
  return 5 * padded_width(H) + 16;
}
// the envelope the tower takes
__host__ __device__ inline bool widths_ok(int C, int D, int H, int nff,
                                          int ndf, int K) {
  return C >= 1 && C <= 64 && D >= 1 && D <= 8 && H >= 1 && H <= 512 &&
         nff >= 1 && nff <= 10 && ndf >= 1 && ndf <= 10 && K >= 1 &&
         K <= 32;
}

struct Args {
  const bf16* emb;          // [M*K, C]
  const float* dists;       // [M*K, D]
  const float* cd;          // [M*K, 7] colour, dirdot
  const float* wk;          // [M*K]
  const signed char* nk;    // kChunk: [M] neighbours found, -1 masked off
  const bf16* w;            // packed weights (tower_weights)
  const float* f;           // packed parameters (tower_params)
  float* aw;                // [M] sum_k alpha * wk (kChunk: sigma)
  void* hw;                 // kKacc f32 [M, H]; kChunk bf16 [M, hs]
  unsigned char* found;     // kChunk [M]
  int M, K, C, D, H, nff, ndf, hs, act_super, span, nspans;
};

// per-team tables of the span being scanned and of the tile in work
template <int NT>
struct Tables {
  unsigned bits[Shape<NT>::kSpanMax];      // a slot's live rows
  unsigned char live[Shape<NT>::kSpanMax];  // the slot wants outputs
  int slot_row0[kTakeMax];                 // a slot's first row in the tile
  int slot_cnt[kTakeMax];
  int row_src[kRows];                      // row m * K + k of the inputs
  float row_wk[kRows];
  float row_alpha[kRows];
  float dist[kRows][8];                    // the rows' dists, bf16 values
  float dpart[2][kRows];                   // kShared: the halves' dots
};

template <int NT>
struct Block {
  unsigned char a[Shape<NT>::kTeams][Shape<NT>::kASlabs * kASlab];
  unsigned char ring[Shape<NT>::kStages][Shape<NT>::kSlab];
  uint64_t full[Shape<NT>::kStages], empty[Shape<NT>::kStages];
  Tables<NT> t[Shape<NT>::kTeams];
  int have[2][2];                          // [round parity][team]
  volatile int done, consumed;
};
template <int NT>
constexpr int block_bytes() {
  return (int)sizeof(Block<NT>) + 1024;    // + the alignment
}

template <int NT>
__device__ __forceinline__ Block<NT>& block_smem() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<Block<NT>*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
}

// ---- wgmma at N = 64 (tower.cuh has 128 and 256) ----
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (N == 256)
    tower::wgmma_n256(d, da, db, scale_d);
  else if constexpr (N == 128)
    tower::wgmma_n128(d, da, db, scale_d);
  else
    wgmma_n64(d, da, db, scale_d);
}

// ---- the ring ----
__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Waits for phase `parity` of an mbarrier. A stage that takes 20 s is a
// fault of the kernel (a lost copy or a miscounted release), not a wait:
// the kernel traps, and its launch reports an error, rather than hold the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (tower::mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!tower::mbar_try_wait(bar, parity))
    if (globaltimer() - t0 > 20000000000ull) __trap();
}
// The producer (one thread): stage use n takes piece n % seq of the
// packed weights. It stops when the consumers raise `done`, then waits
// for the copies they did not consume.
template <int NT>
__device__ void produce(Block<NT>& sm, const unsigned char* weights,
                        int seq) {
  using S = Shape<NT>;
  const uint32_t data = smem_u32(sm.ring), full = smem_u32(sm.full),
                 empty = smem_u32(sm.empty);
  uint32_t n = 0;
  if (TOWER_PROBE & 4) return;
  for (;; ++n) {
    const uint32_t st = n % S::kStages, parity = ((n / S::kStages) & 1) ^ 1;
    bool stop = false;
    const uint64_t t0 = globaltimer();
    while (!tower::mbar_try_wait(empty + 8 * st, parity)) {
      if (sm.done) {
        stop = true;
        break;
      }
      if (globaltimer() - t0 > 20000000000ull) __trap();
    }
    if (stop) break;
    tower::mbar_expect_tx(full + 8 * st, S::kSlab);
    tower::bulk_load(data + st * S::kSlab,
                     weights + (size_t)(n % (uint32_t)seq) * S::kSlab,
                     S::kSlab, full + 8 * st);
  }
  for (uint32_t j = (uint32_t)sm.consumed; j < n; ++j)
    mbar_wait(full + 8 * (j % S::kStages), (j / S::kStages) & 1);
}

// a consumer warp's view of the ring: n is the next stage use it reads
// (kShared: warpgroup h reads the uses n = h mod 2, its half of a slab)
template <int NT>
struct Consumer {
  uint32_t data, full, empty, n;
  __device__ __forceinline__ uint32_t wait() {
    const uint32_t st = n % Shape<NT>::kStages;
    if (!(TOWER_PROBE & 4))
      mbar_wait(full + 8 * st, (n / Shape<NT>::kStages) & 1);
    return st;
  }
  __device__ __forceinline__ void release(uint32_t st, int lane) {
    if (lane == 0 && !(TOWER_PROBE & 4)) tower::mbar_arrive(empty + 8 * st);
  }
  __device__ __forceinline__ void advance() { n += Shape<NT>::kHalves; }
  // pass `count` stage uses by without reading them
  __device__ __forceinline__ void drain(int count, int lane) {
    for (int i = 0; i < count; ++i) {
      const uint32_t st = wait();
      __syncwarp();
      release(st, lane);
      advance();
    }
  }
};

// acc (+)= A @ W over `n_slabs` 64-column slabs of the activation tile at
// a_base against as many stages, the last one `last_ks` k-steps of 16
// deep; `accumulate` carries acc in (layer 1's later passes)
template <int NT>
__device__ __forceinline__ void layer_mma(float (&acc)[Shape<NT>::kN / 2],
                                          Consumer<NT>& c, uint32_t a_base,
                                          int n_slabs, int last_ks,
                                          bool accumulate, int lane) {
  using S = Shape<NT>;
  tower::wg_fence();
  uint32_t prev = 0;
  for (int s = 0; s < n_slabs; ++s) {
    const uint32_t st = c.wait();
    const uint32_t a = a_base + s * kASlab;
    const uint32_t b = c.data + st * S::kSlab;
    const int nks = s == n_slabs - 1 ? last_ks : 4;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < nks && !(TOWER_PROBE & 2))
        wgmma<S::kN>(acc, make_desc(a + ks * 32), make_desc(b + ks * 32),
                     (accumulate || s > 0 || ks > 0) ? 1 : 0);
    tower::wg_commit();
    if (s > 0) {
      tower::wg_wait<1>();
      c.release(prev, lane);
    }
    prev = st;
    c.advance();
  }
  tower::wg_wait<0>();
  c.release(prev, lane);
  tower::fence_regs(acc);
}

// byte offset of element (row, col) in an activation tile
__device__ __forceinline__ int a_offset(int row, int col) {
  return (col >> 6) * kASlab + row * 128 +
         ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// bf16(LeakyReLU(acc + bias)) of the warpgroup's columns col_base ..
// col_base + N - 1 into the tile in place (rows ww*16 + lane/4, + 8)
template <int N, bool kRoundBias>
__device__ __forceinline__ void store_hidden(const float (&acc)[N / 2],
                                             const float* __restrict__ bias,
                                             unsigned char* A, int col_base,
                                             int ww, int lane) {
  const int q = lane & 3, r0 = ww * 16 + (lane >> 2), rx = r0 & 7;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col_base + 8 * j + 2 * q;
    const float2 b = __ldg((const float2*)(bias + col));
    unsigned char* p = A + (col >> 6) * kASlab + r0 * 128 +
                       (((j & 7) ^ rx) << 4) + q * 4;
    *(__nv_bfloat162*)p = __floats2bfloat162_rn(
        tower::bias_act<kRoundBias>(acc[4 * j], b.x),
        tower::bias_act<kRoundBias>(acc[4 * j + 1], b.y));
    *(__nv_bfloat162*)(p + 8 * 128) = __floats2bfloat162_rn(
        tower::bias_act<kRoundBias>(acc[4 * j + 2], b.x),
        tower::bias_act<kRoundBias>(acc[4 * j + 3], b.y));
  }
}

// eight bf16 values as one 16-byte store
__device__ __forceinline__ void store8(unsigned char* dst,
                                       const float (&v)[8]) {
  uint4 u;
  uint32_t* w = (uint32_t*)&u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *(const uint32_t*)&p;
  }
  *(uint4*)dst = u;
}

// The next tile of a span: the longest run of slots from `cursor` on, at
// most kTakeMax, whose rows fit kRows. Every warp computes the same
// answer; lane i holds slots cursor + i (h = 0) and cursor + 32 + i
// (h = 1): their row counts in c[h], their first rows in row0[h].
__device__ __forceinline__ void form_tile(const unsigned* bits, int span_n,
                                          int cursor, int lane, int& n_take,
                                          int& nrows, int (&c)[2],
                                          int (&row0)[2]) {
  int incl[2];
  int base = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = cursor + 32 * h + lane;
    c[h] = i < span_n ? __popc(bits[i]) : 1000;
    int v = c[h];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    incl[h] = v + base;
    base = __shfl_sync(0xffffffffu, incl[h], 31);
    row0[h] = incl[h] - c[h];
  }
  const int n0 = __popc(__ballot_sync(0xffffffffu, incl[0] <= kRows));
  const int n1 = __popc(__ballot_sync(0xffffffffu, incl[1] <= kRows));
  n_take = n0 + n1;
  const int last = n1 ? __shfl_sync(0xffffffffu, incl[1], max(n1 - 1, 0))
                      : __shfl_sync(0xffffffffu, incl[0], max(n0 - 1, 0));
  nrows = n_take ? last : 0;
}

// The tile's row inputs that layer 1 reads, fetched at once so that the
// loads overlap: each row's weight into T.row_wk, its dists (bf16-rounded)
// into T.dist, and its embedding into the tile's columns 0 .. C-1 (layer
// 1's first pass), 16 bytes a load where the rows allow it.
template <int NT>
__device__ __forceinline__ void load_rows(unsigned char* A, Tables<NT>& T,
                                          int nrows, const Args& a, int tt) {
  constexpr int kT = Shape<NT>::kTeamThreads;
  const int C = a.C, D = a.D;
  if (tt < nrows) T.row_wk[tt] = __ldg(a.wk + T.row_src[tt]);
#pragma unroll 4
  for (int i = tt; i < nrows * D; i += kT) {
    const int r = i / D, d = i - r * D;
    T.dist[r][d] = bf_round(__ldg(a.dists + (size_t)T.row_src[r] * D + d));
  }
  if ((C & 7) == 0 && ((uintptr_t)a.emb & 15) == 0) {
    const int cpr = C / 8;
#pragma unroll 4
    for (int i = tt; i < nrows * cpr; i += kT) {
      const int r = i / cpr, c = i - r * cpr;
      *(uint4*)(A + a_offset(r, 8 * c)) = __ldg(
          (const uint4*)(a.emb + (size_t)T.row_src[r] * C) + c);
    }
  } else {
#pragma unroll 4
    for (int i = tt; i < nrows * C; i += kT) {
      const int r = i / C, c = i - r * C;
      *(bf16*)(A + a_offset(r, c)) = a.emb[(size_t)T.row_src[r] * C + c];
    }
  }
}

// Layer 1's input columns col0 .. col0 + 64 ncols - 1 of the tile's rows
// past the embedding: [PE_block(emb, nff), PE_block(dists, ndf)], zeros
// up to the last slab's end. A thread takes a column pair (or a padding
// column) for 16 rows at a time; each PE pair (sin, cos of x 2^f) is one
// sincosf of the bf16-rounded input, read from the tile (the embedding,
// in the first pass), T.dist, or (later passes) the embedding in memory.
template <int NT>
__device__ __forceinline__ void form_features(unsigned char* A,
                                              const Tables<NT>& T,
                                              int nrows, const Args& a,
                                              int col0, int ncols, int tt) {
  if (TOWER_PROBE & 1) return;
  const int C = a.C, D = a.D;
  const int ne = C * a.nff, nd = D * a.ndf;
  const int nfeat = C + 2 * ne + 2 * nd;
  const int col1 = col0 + 64 * ncols;
  const int nz = (nfeat + 63) / 64 * 64 - nfeat;
  const int nrb = (nrows + 15) / 16;
  for (int e = tt; e < (ne + nd + nz) * nrb; e += Shape<NT>::kTeamThreads) {
    const int j = e / nrb, r0 = (e - j * nrb) * 16;
    const int r1 = min(nrows, r0 + 16);
    if (j >= ne + nd) {   // a padding column
      const int col = nfeat + (j - ne - nd);
      if (col >= col0 && col < col1)
        for (int r = r0; r < r1; ++r)
          *(bf16*)(A + a_offset(r, col - col0)) = __float2bfloat16(0.f);
      continue;
    }
    const bool is_emb = j < ne;
    const int p = is_emb ? j : j - ne;
    const int n = is_emb ? C : D;
    const int f = p / n, i = p - f * n;
    const int sc = is_emb ? C + p : C + 2 * ne + p;
    const int cc = sc + (is_emb ? ne : nd);
    const bool s_in = sc >= col0 && sc < col1, c_in = cc >= col0 && cc < col1;
    if (!s_in && !c_in) continue;
    const float scale = (float)(1 << f);
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      float x;
      if (!is_emb)
        x = T.dist[r][i];
      else if (col0 == 0)
        x = __bfloat162float(*(const bf16*)(A + a_offset(r, i)));
      else
        x = __bfloat162float(a.emb[(size_t)T.row_src[r] * C + i]);
      float sn, cs;
      sincosf(x * scale, &sn, &cs);
      if (s_in) *(bf16*)(A + a_offset(r, sc - col0)) = __float2bfloat16(sn);
      if (c_in) *(bf16*)(A + a_offset(r, cc - col0)) = __float2bfloat16(cs);
    }
  }
}

// The K-sums of h * wk of one column pass (the warpgroup's accumulator
// columns kW P .. kW P + kW - 1, tile columns col0 + those): staged as f32
// at `st`, then thread (part, column) walks the rows of its share of the
// tile's slots in k order and hands each sum to sink(i, column, s).
template <int N, int P, class Sink>
__device__ __forceinline__ void ksum_pass(const float (&acc)[N / 2],
                                          float* st, const int* slot_row0,
                                          const int* slot_cnt,
                                          const float* row_wk, int n_take,
                                          int col0, int wg, int ww, int lane,
                                          Sink sink) {
  using KS = Ksum<N>;
  const int q = lane & 3, r0 = ww * 16 + (lane >> 2);
#pragma unroll
  for (int jj = 0; jj < KS::kW / 8; ++jj) {
    const int j = P * (KS::kW / 8) + jj;
    *(float2*)(st + r0 * KS::kLd + jj * 8 + 2 * q) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *(float2*)(st + (r0 + 8) * KS::kLd + jj * 8 + 2 * q) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  bar_sync(2 + wg, 128);
  const int t = ww * 32 + lane, col = t % KS::kW, part = t / KS::kW;
  const int per = (n_take + KS::kParts - 1) / KS::kParts;
  const int i0 = part * per, i1 = min(n_take, i0 + per);
  for (int ib = i0; ib < i1; ib += 4) {
    int row0[4], n[4], nmax = 0;
    float s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = ib + u < i1;
      row0[u] = in ? slot_row0[ib + u] : 0;
      n[u] = in ? slot_cnt[ib + u] : 0;
      nmax = max(nmax, n[u]);
      s[u] = 0.f;
    }
    for (int r = 0; r < nmax; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r < n[u])
          s[u] = s[u] +
                 st[(row0[u] + r) * KS::kLd + col] * row_wk[row0[u] + r];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ib + u < i1 && n[u] > 0) sink(ib + u, col0 + P * KS::kW + col, s[u]);
  }
  bar_sync(2 + wg, 128);
}

template <int N, class Sink>
__device__ __forceinline__ void ksums(const float (&acc)[N / 2], float* st,
                                      const int* slot_row0,
                                      const int* slot_cnt,
                                      const float* row_wk, int n_take,
                                      int col0, int wg, int ww, int lane,
                                      Sink sink) {
  ksum_pass<N, 0>(acc, st, slot_row0, slot_cnt, row_wk, n_take, col0, wg,
                  ww, lane, sink);
  if constexpr (N > Ksum<N>::kW)
    ksum_pass<N, 1>(acc, st, slot_row0, slot_cnt, row_wk, n_take, col0, wg,
                    ww, lane, sink);
}

// The per-neighbour tower on M slots of K rows, one mode. A team walks
// spans of a.span slots: span (i * gridDim.x + blockIdx.x) * teams + team
// for i = 0, 1, ...
template <int NT, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
tower_wg_kernel(const Args a) {
  using S = Shape<NT>;
  constexpr bool kRB = MODE == kChunk;
  constexpr int kN = S::kN, kNp = S::kNp;
  Block<NT>& sm = block_smem<NT>();
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  const int K = a.K, H = a.H;
  const int nfeat = feature_count(a.C, a.D, a.nff, a.ndf);
  const int n1 = (nfeat + 63) / 64;
  const int last1 = (nfeat - 64 * (n1 - 1) + 15) / 16;
  const int seq = (n1 + 3 * NT + 1) * S::kHalves;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      tower::mbar_init(smem_u32(&sm.full[s]), 1);
      tower::mbar_init(smem_u32(&sm.empty[s]), S::kReaders);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm.done = 0;
    sm.consumed = 0;
  }
  __syncthreads();
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 8 && lane == 0)
      produce<NT>(sm, (const unsigned char*)a.w, seq);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int wg = warp >> 2, ww = warp & 3;
  const int team = S::kShared ? 0 : wg;
  const int tt = S::kShared ? (int)threadIdx.x : ww * 32 + lane;
  const int tw = S::kShared ? warp : ww;          // warp within the team
  constexpr int kTeamWarps = S::kTeamThreads / 32;
  const int col_base = S::kShared ? wg * 256 : 0;
  auto team_bar = [&]() {
    if (S::kShared)
      bar_sync(1, 256);
    else
      bar_sync(2 + wg, 128);
  };
  Tables<NT>& T = sm.t[team];
  unsigned char* A = sm.a[team];
  const uint32_t a_base = smem_u32(A);
  Consumer<NT> cons;
  cons.data = smem_u32(sm.ring);
  cons.full = smem_u32(sm.full);
  cons.empty = smem_u32(sm.empty);
  cons.n = S::kShared ? wg : 0;

  const float* b1 = a.f;
  const float* b2 = b1 + kNp;
  const float* b3 = b2 + kNp;
  const float* b4 = b3 + kNp;
  const float* wd = b4 + kNp;
  const float bd = __ldg(wd + kNp);
  float* st = (float*)(A + (S::kShared ? wg * Ksum<kN>::kBytes : 0));

  // what a slot with no row gets: 0 (and, in the chunk, not found)
  auto zero_slot = [&](int m) {
    if (lane == 0) {
      a.aw[m] = 0.f;
      if (MODE == kChunk) a.found[m] = 0;
    }
    for (int c = lane; c < H; c += 32) {
      if (MODE == kKacc)
        ((float*)a.hw)[(size_t)m * H + c] = 0.f;
      else
        ((bf16*)a.hw)[(size_t)m * a.hs + c] = __float2bfloat16(0.f);
    }
  };

  int span_it = 0, span_base = 0, span_n = 0, cursor = 0, agree = 0;
  float acc[kN / 2];

  for (;;) {
    // ---- the team's next tile with rows
    bool have = false;
    int first = 0, n_take = 0, nrows = 0;
    for (;;) {
      if (cursor >= span_n) {
        const int span =
            (span_it * (int)gridDim.x + (int)blockIdx.x) * S::kTeams + team;
        ++span_it;
        if (span >= a.nspans) break;
        span_base = span * a.span;
        span_n = min(a.span, a.M - span_base);
        cursor = 0;
        team_bar();
        if (tt < span_n) {
          const int m = span_base + tt;
          unsigned bits = 0;
          bool live = true;
          if (MODE == kChunk) {
            const int nk = a.nk[m];
            live = nk >= 0;
            bits = nk <= 0 ? 0u : nk >= 32 ? 0xffffffffu : (1u << nk) - 1u;
          } else if ((K & 3) == 0 && ((uintptr_t)a.wk & 15) == 0) {
            const float4* w4 = (const float4*)(a.wk + (size_t)m * K);
            for (int k = 0; k < K; k += 4) {
              const float4 v = __ldg(w4 + k / 4);
              bits |= (unsigned)(v.x != 0.f) << k |
                      (unsigned)(v.y != 0.f) << (k + 1) |
                      (unsigned)(v.z != 0.f) << (k + 2) |
                      (unsigned)(v.w != 0.f) << (k + 3);
            }
          } else {
            for (int k = 0; k < K; ++k)
              bits |= (unsigned)(__ldg(a.wk + (size_t)m * K + k) != 0.f) << k;
          }
          T.bits[tt] = bits;
          T.live[tt] = live;
        }
        team_bar();
      }
      int c[2], row0[2];
      form_tile(T.bits, span_n, cursor, lane, n_take, nrows, c, row0);
      first = cursor;
      cursor += n_take;
      if (tw == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 32 * h + lane;
          if (i < n_take) {
            T.slot_row0[i] = row0[h];
            T.slot_cnt[i] = c[h];
            const int m = span_base + first + i;
            unsigned rest = T.bits[first + i];
            for (int r = row0[h]; rest; ++r) {
              const int k = __ffs(rest) - 1;
              rest &= rest - 1;
              T.row_src[r] = m * K + k;
            }
          }
        }
      }
      for (int i = tw; i < n_take; i += kTeamWarps)
        if (T.bits[first + i] == 0 && T.live[first + i])
          zero_slot(span_base + first + i);
      if (nrows > 0) {
        have = true;
        break;
      }
    }
    if (S::kShared) {
      if (!have) break;
    } else {
      // the two teams read every stage: both run a tile or neither
      if (tt == 0) sm.have[agree & 1][team] = have;
      bar_sync(1, 256);
      const int go = sm.have[agree & 1][0] | sm.have[agree & 1][1] << 1;
      ++agree;
      if (go == 0) break;
      if (!((go >> team) & 1)) {
        cons.drain(seq, lane);
        continue;
      }
    }
    team_bar();   // the tile's tables

    // ---- layer 1, in passes of the slabs the tile holds
    for (int base = 0; base < n1; base += S::kASlabs) {
      const int cnt = min(S::kASlabs, n1 - base);
      if (base > 0) team_bar();   // the last pass's products are done
      if (base == 0) {
        load_rows<NT>(A, T, nrows, a, tt);
        team_bar();
      }
      form_features<NT>(A, T, nrows, a, 64 * base, cnt, tt);
      tower::fence_async_smem();
      team_bar();
      layer_mma<NT>(acc, cons, a_base, cnt, base + cnt == n1 ? last1 : 4,
                    base > 0, lane);
    }
    team_bar();
    store_hidden<kN, kRB>(acc, b1, A, col_base, ww, lane);
    // colour and dirdot at columns Np .. Np + 6, zeros to Np + 15
    for (int i = tt; i < nrows * 2; i += S::kTeamThreads) {
      const int r = i >> 1, h = i & 1;
      const size_t g = (size_t)T.row_src[r];
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = h == 0 && j < kCD ? a.cd[g * kCD + j] : 0.f;
      store8(A + a_offset(r, kNp + 8 * h), v);
    }
    tower::fence_async_smem();
    team_bar();
    // ---- layers 2 and 3 in place; layer 4 stays in the accumulators
    layer_mma<NT>(acc, cons, a_base, NT, 4, false, lane);
    team_bar();
    store_hidden<kN, kRB>(acc, b2, A, col_base, ww, lane);
    tower::fence_async_smem();
    team_bar();
    layer_mma<NT>(acc, cons, a_base, NT + 1, 1, false, lane);
    team_bar();
    store_hidden<kN, kRB>(acc, b3, A, col_base, ww, lane);
    tower::fence_async_smem();
    team_bar();
    layer_mma<NT>(acc, cons, a_base, NT, 4, false, lane);
    {
      const int q = lane & 3;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const float2 b = __ldg((const float2*)(b4 + col_base + 8 * j + 2 * q));
        acc[4 * j] = tower::bias_act<kRB>(acc[4 * j], b.x);
        acc[4 * j + 1] = tower::bias_act<kRB>(acc[4 * j + 1], b.y);
        acc[4 * j + 2] = tower::bias_act<kRB>(acc[4 * j + 2], b.x);
        acc[4 * j + 3] = tower::bias_act<kRB>(acc[4 * j + 3], b.y);
      }
    }

    // ---- the density head: bf16(h) . wd, alpha a row
    {
      const int q = lane & 3, r0 = ww * 16 + (lane >> 2);
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const float2 w = __ldg((const float2*)(wd + col_base + 8 * j + 2 * q));
        d0 = d0 + bf_round(acc[4 * j]) * w.x;
        d0 = d0 + bf_round(acc[4 * j + 1]) * w.y;
        d1 = d1 + bf_round(acc[4 * j + 2]) * w.x;
        d1 = d1 + bf_round(acc[4 * j + 3]) * w.y;
      }
      d0 = d0 + __shfl_xor_sync(0xffffffffu, d0, 1);
      d0 = d0 + __shfl_xor_sync(0xffffffffu, d0, 2);
      d1 = d1 + __shfl_xor_sync(0xffffffffu, d1, 1);
      d1 = d1 + __shfl_xor_sync(0xffffffffu, d1, 2);
      auto alpha = [&](float d) {
        if (MODE == kChunk) {
          const float y = bf_round(bf_round(d) + bd);
          return a.act_super
                     ? log1pf(expf(-fabsf(y - 1.f))) + fmaxf(y - 1.f, 0.f)
                     : fmaxf(y, 0.f);
        }
        return fmaxf(d + bd, 0.f);
      };
      if (S::kShared) {
        if (q == 0) {
          T.dpart[wg][r0] = d0;
          T.dpart[wg][r0 + 8] = d1;
        }
        team_bar();
        if (tt < kRows) T.row_alpha[tt] = alpha(T.dpart[0][tt] + T.dpart[1][tt]);
      } else if (q == 0) {
        T.row_alpha[r0] = alpha(d0);
        T.row_alpha[r0 + 8] = alpha(d1);
      }
    }
    team_bar();   // the alphas; every product of the tile has read A

    // ---- the slots' sums in k order: alpha * wk, then h * wk
    if (TOWER_PROBE & 8) {
      tower::keep_alive(acc[5] + T.row_alpha[tt & 63]);
      if (S::kShared) team_bar();
      continue;
    }
    if (tt < n_take && T.slot_cnt[tt] > 0) {
      const int r0 = T.slot_row0[tt], n = T.slot_cnt[tt];
      float s = 0.f;
      for (int r = r0; r < r0 + n; ++r) s = s + T.row_alpha[r] * T.row_wk[r];
      const int m = span_base + first + tt;
      a.aw[m] = s;
      if (MODE == kChunk) a.found[m] = 1;
    }
    const int m0 = span_base + first;
    auto sink = [&](int i, int col, float s) {
      if (col >= H) return;
      if (MODE == kKacc)
        ((float*)a.hw)[(size_t)(m0 + i) * H + col] = s;
      else
        ((bf16*)a.hw)[(size_t)(m0 + i) * a.hs + col] = __float2bfloat16(s);
    };
    ksums<kN>(acc, st, T.slot_row0, T.slot_cnt, T.row_wk, n_take, col_base,
              wg, ww, lane, sink);
    if (S::kShared) team_bar();   // both halves' sums read the tables
  }
  if (threadIdx.x == 0) {
    sm.consumed = (int)cons.n;
    __threadfence_block();
    sm.done = 1;
  }
}

namespace {
// the SM count of each device, once the kernel of (NT index, mode) has
// its shared memory limit raised there; 0 before. Internal to each
// source that includes this header: a function-local static of a
// template would be one object across every library of the process
// (the probe builds of a source are libraries of their own).
int g_sms[4][3][64];
}  // namespace

// Blocks and spans of a launch over M slots: every SM one block, at most
// one team a kMinSpan slots, every team as many spans of at most
// kSpanMax slots. The dynamic shared memory limit and the SM count are
// looked up once an instantiation and device.
template <int NT, int MODE>
cudaError_t launch_nt(Args a, cudaStream_t stream) {
  using S = Shape<NT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  int (&sms_of)[64] = g_sms[__builtin_ctz(NT)][MODE];
  if (sms_of[dev] == 0) {
    int sms = 0, per = 0;
    if ((err = cudaFuncSetAttribute(
             tower_wg_kernel<NT, MODE>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             block_bytes<NT>())) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, tower_wg_kernel<NT, MODE>, kThreads,
             block_bytes<NT>())) != cudaSuccess)
      return err;
    if (per < 1) return cudaErrorInvalidConfiguration;
    sms_of[dev] = sms;
  }
  const long long teams_wanted = ((long long)a.M + kMinSpan - 1) / kMinSpan;
  const int blocks = (int)std::max(
      1LL, std::min<long long>(sms_of[dev],
                               (teams_wanted + S::kTeams - 1) / S::kTeams));
  const long long units = (long long)blocks * S::kTeams;
  const long long rounds = (a.M + units * S::kSpanMax - 1) /
                           (units * S::kSpanMax);
  a.span = (int)std::max<long long>(
      kMinSpan, (a.M + units * rounds - 1) / (units * rounds));
  a.nspans = (a.M + a.span - 1) / a.span;
  tower_wg_kernel<NT, MODE><<<blocks, kThreads, block_bytes<NT>(), stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.M <= 0) return cudaSuccess;
  switch (padded_width(a.H)) {
    case 64: return launch_nt<1, MODE>(a, stream);
    case 128: return launch_nt<2, MODE>(a, stream);
    case 256: return launch_nt<4, MODE>(a, stream);
    default: return launch_nt<8, MODE>(a, stream);
  }
}

}  // namespace twg
