// The per-neighbour tower of the radiance decoder and the colour tower of
// the fused chunk at every width of the port's envelope, warp-specialised
// on wgmma for Hopper. The per-neighbour tower serves the entry points of
// the generic sources in three modes: fused_decode_any (csrc/
// decode_any.cu, mode kPair: an output row a (slot, k) row),
// fused_decode2_any (the same source, mode kKacc: the K-sums) and the
// tower of fused_chunk_decode_any (csrc/chunk_any.cu, mode kChunk);
// colour_wg_kernel is the chunk's colour tower. They replace, at the
// widths the tuned kernels of csrc/tower.cuh and csrc/fused_chunk.cu are
// not built for, the towers inside the Pallas kernels
// pointnerf2studio_tpu/ops/fused_decode.py::_pair_kernel and
// ::_kacc_kernel and ops/fused_chunk.py::_kernel.
//
// The tower: layer 1 [emb (C), PE(emb) (2 C nff), PE(dists) (2 D ndf)]
// -> H, layer 2 H -> H, layer 3 [h (H), colour and dirdot (7)] -> H,
// layer 4 H -> H, the H -> 1 density head, then per slot the sums over
// its K rows in k order of alpha * wk and h * wk (kKacc, kChunk), or per
// row alpha * wk and bf16(bf16(h) * wk) (kPair); runtime C <= 64, D <= 8,
// H <= 512, octaves <= 10, K <= 32. The colour tower: [K-sum (H),
// PE(viewdir) (6 nvf)] -> HC, then HC -> HC layers (1-8 in all), and the
// HC -> 3 head; HC <= 512.
//
// What bounds it on Hopper: tensor-core operations (at hidden 512 some
// 1.95 MFLOP a row against 150 bytes of input; kPair also writes 1 KB a
// row), and under them the weights every row tile streams from L2 (2 MB a
// tile at hidden 512). As built, the work around the products bounds it
// first: at 512 one team works one tile an SM, and its PE, epilogues and
// K-sums (about half its time on the card) overlap none of its products
// (chip_smoke.py's probe builds, PERF.md). The design follows tower.cuh's,
// at any of the padded widths
// Np = 64, 128, 256, 512 (NT = Np / 64, a template parameter):
//   * Persistent blocks, one an SM: two consumer warpgroups and one
//     producer warpgroup, of which one thread works; setmaxnreg gives the
//     consumers 232 registers a thread and the producer's group 40.
//   * The weights are packed on the host once per set of weights
//     (ops/fused_decode.py::pack_tower_wg, ops/fused_chunk.py::
//     _kernel_params_any) in the shared-memory image wgmma reads, in the
//     order the tile consumes them: K-major slabs of 64 inputs, the 16-byte
//     chunk c of output row n at c ^ (n & 7) (the 128-byte swizzle). One
//     slab is one cp.async.bulk into a stage of a ring (4 to 8 stages) on
//     a "full" mbarrier; the consuming warps release it on an "empty" one
//     after the wgmma group that read it has completed. The producer runs
//     the tile's slab sequence over and over and so prefetches across
//     layers and tiles.
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
//     (kKacc, kPair: wk == 0; kChunk: k >= the neighbours found) are left
//     out and slots with no row get exactly 0. Spans are dealt to the teams
//     so that each team gets as many; a span is at least 16 slots, so a
//     small launch (the XLA route's 4,096 slots) still fills the SMs.
//   * The density head is a dot on the CUDA cores from the registers; the
//     K-sums are taken in f32 in k order by a thread a column over an
//     f32 staging tile of 64 rows and up to 128 columns (one or two column
//     passes a warpgroup). kPair instead writes bf16(bf16(h) * wk) into
//     the activation tile and copies the tile's output rows out: its slots
//     own one contiguous run of rows, live and zero alike, written in
//     order with the widest stores (16 bytes, or 8, 4, 2 where the rows'
//     stride of 2H bytes allows no more), the zero rows as zeros; a run of
//     slots with no row at all is written 0 without running the tower.
//   * The colour tower (colour_wg_kernel) has the same block, ring and
//     teams. A team compacts the live slots (nk >= 0) of a span of up to
//     512 slots into a list, so masked slots cost nothing, and runs the
//     list 64 slots a tile: a row a slot, layer 1's inputs (the slot's
//     bf16 K-sum row by cp.async, 16 bytes a copy, every copy of the tile
//     issued at once; then PE(viewdir), one precise sinf or cosf a value)
//     formed in the tile in passes where they outgrow it, then the
//     runtime count of hidden layers in place, each a fixed number of
//     slabs through the ring, and the head as dots from the registers.
// The rounding points are the plain versions': bf16 operands, f32
// accumulation, f32 bias (kKacc, kPair) or bf16(bf16(acc) + bf16 bias)
// (kChunk, the colour tower), LeakyReLU(0.1) in f32, bf16 between layers,
// h in f32 after layer 4 (bf16-rounded for the density dot; kPair: h is
// bf16), alpha * w and h * w summed in f32 in k order; the colour head
// bf16(bf16(dot) + bf16 bias), then sigmoid * (1 + 2e-3) - 1e-3. The
// including sources are compiled with -fmad=false.
// Shared memory: 202-218 KiB a block (block_bytes), one block an SM.
// Probe builds (-DTOWER_PROBE=bits, as tower.cuh's; timed by chip_smoke.py
// --widths --probe; the results are wrong on purpose) leave one part out:
// 1 the PE columns of layer 1, 2 the wgmma products, 4 the weight copies
// and the waits on them, 8 the K-sums and slot outputs (kPair: the row
// outputs).

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

enum Mode { kKacc = 1, kChunk = 2, kPair = 3 };

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
// kPair: the bytes of a store into hw [M*K, H] bf16 at `hw`: the widest
// of 16, 8, 4 and 2 that divides the rows' stride (2H bytes) and the
// address, so that every row's pieces are aligned
inline int pair_vw(int H, const void* hw) {
  int vw = 16;
  while (vw > 2 && ((2 * H) % vw || (uintptr_t)hw % vw)) vw /= 2;
  return vw;
}
// the colour tower's inputs (the K-sums, PE(viewdir)), its 64-input slabs
// (layer 1's, then Nc / 64 for each further layer, Nc = padded_width(HC))
// and bf16 weights (every slab 64 inputs x Nc outputs)
__host__ __device__ inline int colour_inputs(int H, int nvf) {
  return H + 6 * nvf;
}
__host__ __device__ inline int colour_slabs(int H, int HC, int layers,
                                            int nvf) {
  return (colour_inputs(H, nvf) + 63) / 64 +
         (layers - 1) * (padded_width(HC) / 64);
}
__host__ __device__ inline long long colour_weights(int H, int HC,
                                                    int layers, int nvf) {
  return (long long)colour_slabs(H, HC, layers, nvf) * 64 * padded_width(HC);
}
// f32 parameters: each layer's bias [Nc], the head's weights [3][Nc]
// (bf16 values), its bias padded to 16
__host__ __device__ inline int colour_params(int HC, int layers) {
  return (layers + 3) * padded_width(HC) + 16;
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
  float* aw;                // [M] sum_k alpha * wk (kChunk: sigma;
                            // kPair: [M*K] alpha * wk)
  void* hw;                 // kKacc f32 [M, H]; kChunk bf16 [M, hs];
                            // kPair bf16 [M*K, H]
  unsigned char* found;     // kChunk [M]
  int M, K, C, D, H, nff, ndf, hs, act_super, span, nspans;
  int vw;                   // kPair: bytes of a store into hw (pair_vw)
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

// the colour tower's per-team tables: the span's live slots and the tile's
// head dots
constexpr int kColourSpanMax = 512;        // slots of a colour span at most
struct ColourTables {
  int live[kColourSpanMax];
  int wsum[8];                             // a scan pass's live slots a warp
  float head[2][kRows][3];                 // kShared: the halves' dots
};

template <int NT, class Tab = Tables<NT>>
struct Block {
  unsigned char a[Shape<NT>::kTeams][Shape<NT>::kASlabs * kASlab];
  unsigned char ring[Shape<NT>::kStages][Shape<NT>::kSlab];
  uint64_t full[Shape<NT>::kStages], empty[Shape<NT>::kStages];
  Tab t[Shape<NT>::kTeams];
  int have[2][2];                          // [round parity][team]
  volatile int done, consumed;
};
template <int NT, class Tab = Tables<NT>>
constexpr int block_bytes() {
  return (int)sizeof(Block<NT, Tab>) + 1024;    // + the alignment
}

template <class B>
__device__ __forceinline__ B& block_smem() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<B*>(
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
template <int NT, class B>
__device__ void produce(B& sm, const unsigned char* weights, int seq) {
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

// The block's start: the ring's barriers, then the producer's warpgroup
// gives up registers and its one thread streams the weights (piece n %
// seq at stage use n); false there. The consumers take their registers.
template <int NT, class B>
__device__ __forceinline__ bool block_begin(B& sm, const void* weights,
                                            int seq, int warp, int lane) {
  using S = Shape<NT>;
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
      produce<NT>(sm, (const unsigned char*)weights, seq);
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  return true;
}
// The block's end, by consumer thread 0 once its warpgroup has consumed
// `consumed` stage uses: the producer stops.
template <class B>
__device__ __forceinline__ void block_end(B& sm, uint32_t consumed) {
  if (threadIdx.x == 0) {
    sm.consumed = (int)consumed;
    __threadfence_block();
    sm.done = 1;
  }
}
// the barrier of a team: both consumer warpgroups at Np = 512, else one
template <int NT>
__device__ __forceinline__ void team_sync(int wg) {
  if (Shape<NT>::kShared)
    bar_sync(1, 256);
  else
    bar_sync(2 + wg, 128);
}

// The teams that hold a tile this round, a bit each: the two teams read
// every stage, so both run a tile or neither, and one without a tile
// passes the tile's stage uses by (kShared: one team, `have`).
template <int NT, class B>
__device__ __forceinline__ int teams_with_tile(B& sm, bool have, int team,
                                               int tt, int& agree) {
  if (Shape<NT>::kShared) return have;
  if (tt == 0) sm.have[agree & 1][team] = have;
  bar_sync(1, 256);
  const int go = sm.have[agree & 1][0] | sm.have[agree & 1][1] << 1;
  ++agree;
  return go;
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

// kPair: bf16(bf16(h) * wk) of the warpgroup's columns col_base ..
// col_base + N - 1 into the tile (rows ww*16 + lane/4, + 8), h the
// activations of layer 4 (bias and LeakyReLU taken) in acc
template <int N>
__device__ __forceinline__ void store_weighted(const float (&acc)[N / 2],
                                               const float* row_wk,
                                               unsigned char* A, int col_base,
                                               int ww, int lane) {
  const int q = lane & 3, r0 = ww * 16 + (lane >> 2), rx = r0 & 7;
  const float w0 = row_wk[r0], w1 = row_wk[r0 + 8];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col_base + 8 * j + 2 * q;
    unsigned char* p = A + (col >> 6) * kASlab + r0 * 128 +
                       (((j & 7) ^ rx) << 4) + q * 4;
    *(__nv_bfloat162*)p = __floats2bfloat162_rn(bf_round(acc[4 * j]) * w0,
                                                bf_round(acc[4 * j + 1]) * w0);
    *(__nv_bfloat162*)(p + 8 * 128) = __floats2bfloat162_rn(
        bf_round(acc[4 * j + 2]) * w1, bf_round(acc[4 * j + 3]) * w1);
  }
}

// a store of VW bytes
template <int VW> struct Piece;
template <> struct Piece<16> { typedef uint4 T; };
template <> struct Piece<8> { typedef uint2 T; };
template <> struct Piece<4> { typedef unsigned T; };
template <> struct Piece<2> { typedef unsigned short T; };

// kPair: the outputs of the n_take slots of a tile from slot m0 on (span
// entries first ..), rows m0 K .. (m0 + n_take) K - 1, one contiguous run
// of aw and of hw written in order. A live row takes alpha * wk and its
// row of the tile (store_weighted's); a row with no weight gets 0. hw goes
// in pieces of VW bytes, a group of lanes a row: every piece is aligned
// and no byte past column H - 1 is written (pair_vw). For a run of slots
// with no row only T.bits is read.
template <int NT, int VW>
__device__ __forceinline__ void pair_rows_vw(const unsigned char* A,
                                             const Tables<NT>& T,
                                             const Args& a, int m0,
                                             int first, int n_take, int tt,
                                             int tw, int lane) {
  typedef typename Piece<VW>::T P;
  constexpr int kT = Shape<NT>::kTeamThreads;
  constexpr int kTeamWarps = kT / 32;
  const int K = a.K, nr = n_take * K, ppr = 2 * a.H / VW;
  const size_t g0 = (size_t)m0 * K;
  auto tile_row = [&](int row) {       // the row's place in the tile, or -1
    const int i = row / K, k = row - i * K;
    const unsigned bits = T.bits[first + i];
    return (bits >> k) & 1u
               ? T.slot_row0[i] + __popc(bits & ((1u << k) - 1u))
               : -1;
  };
  for (int e = tt; e < nr; e += kT) {
    const int r = tile_row(e);
    a.aw[g0 + e] = r < 0 ? 0.f : T.row_alpha[r] * T.row_wk[r];
  }
  int lpr = 1;                         // lanes a row
  while (lpr < 32 && lpr < ppr) lpr <<= 1;
  const int rpw = 32 / lpr, sub = lane / lpr, sl = lane - sub * lpr;
  unsigned char* out = (unsigned char*)a.hw + g0 * 2 * a.H;
  for (int row = tw * rpw + sub; row - sub < nr; row += kTeamWarps * rpw) {
    if (row >= nr) continue;
    const int r = tile_row(row);
    P* dst = (P*)(out + (size_t)row * 2 * a.H);
    for (int p = sl; p < ppr; p += lpr) {
      P v = {};
      if (r >= 0) {
        const int b = p * VW;          // the piece's first byte in the row
        v = *(const P*)(A + (b >> 7) * kASlab + r * 128 +
                        ((((b >> 4) & 7) ^ (r & 7)) << 4) + (b & 15));
      }
      dst[p] = v;
    }
  }
}

template <int NT>
__device__ __forceinline__ void pair_rows(const unsigned char* A,
                                          const Tables<NT>& T, const Args& a,
                                          int m0, int first, int n_take,
                                          int tt, int tw, int lane) {
  if (TOWER_PROBE & 8) return;
  switch (a.vw) {
    case 16: return pair_rows_vw<NT, 16>(A, T, a, m0, first, n_take, tt, tw, lane);
    case 8: return pair_rows_vw<NT, 8>(A, T, a, m0, first, n_take, tt, tw, lane);
    case 4: return pair_rows_vw<NT, 4>(A, T, a, m0, first, n_take, tt, tw, lane);
    default: return pair_rows_vw<NT, 2>(A, T, a, m0, first, n_take, tt, tw, lane);
  }
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
  Block<NT>& sm = block_smem<Block<NT>>();
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  const int K = a.K, H = a.H;
  const int nfeat = feature_count(a.C, a.D, a.nff, a.ndf);
  const int n1 = (nfeat + 63) / 64;
  const int last1 = (nfeat - 64 * (n1 - 1) + 15) / 16;
  const int seq = (n1 + 3 * NT + 1) * S::kHalves;
  if (!block_begin<NT>(sm, a.w, seq, warp, lane)) return;

  const int wg = warp >> 2, ww = warp & 3;
  const int team = S::kShared ? 0 : wg;
  const int tt = S::kShared ? (int)threadIdx.x : ww * 32 + lane;
  const int tw = S::kShared ? warp : ww;          // warp within the team
  constexpr int kTeamWarps = S::kTeamThreads / 32;
  const int col_base = S::kShared ? wg * 256 : 0;
  auto team_bar = [&]() { team_sync<NT>(wg); };
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
      if (MODE == kPair) {
        if (nrows == 0)
          pair_rows<NT>(A, T, a, span_base + first, first, n_take, tt, tw,
                        lane);
      } else {
        for (int i = tw; i < n_take; i += kTeamWarps)
          if (T.bits[first + i] == 0 && T.live[first + i])
            zero_slot(span_base + first + i);
      }
      if (nrows > 0) {
        have = true;
        break;
      }
    }
    const int go = teams_with_tile<NT>(sm, have, team, tt, agree);
    if (go == 0) break;
    if (!((go >> team) & 1)) {
      cons.drain(seq, lane);
      continue;
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
    if (MODE == kPair) {
      // ---- the rows: bf16(bf16(h) * wk) through the tile, in order
      store_weighted<kN>(acc, T.row_wk, A, col_base, ww, lane);
      team_bar();
      pair_rows<NT>(A, T, a, span_base + first, first, n_take, tt, tw, lane);
      team_bar();   // the tile and its tables are read
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
  block_end(sm, cons.n);
}

// ---- the colour tower of the fused chunk ----
struct ColourArgs {
  const bf16* hw;           // [M, hs] the K-sums, bf16, columns < H
  const float* vd;          // [M, 3] Rw2c-rotated view direction
  const signed char* nk;    // [M] -1: the slot is masked off
  const bf16* w;            // packed colour weights (colour_weights)
  const float* f;           // packed colour parameters (colour_params)
  float* rgb;               // [M, 3]
  int M, H, hs, nvf, layers, span, nspans;
};

// A team's scan of the span [s0, s0 + sn): its live slots (nk >= 0), in
// order, into T.live; returns their count.
template <int NT>
__device__ __forceinline__ int colour_scan(ColourTables& T,
                                           const ColourArgs& a, int s0,
                                           int sn, int tt, int tw, int lane,
                                           int wg) {
  using S = Shape<NT>;
  constexpr int kTeamWarps = S::kTeamThreads / 32;
  auto team_bar = [&]() { team_sync<NT>(wg); };
  int base = 0;
  for (int p0 = 0; p0 < sn; p0 += S::kTeamThreads) {
    const int i = p0 + tt;
    const bool live = i < sn && a.nk[s0 + i] >= 0;
    const unsigned b = __ballot_sync(0xffffffffu, live);
    team_bar();   // the last pass's counts are read
    if (lane == 0) T.wsum[tw] = __popc(b);
    team_bar();
    int at = base, total = base;
    for (int w = 0; w < kTeamWarps; ++w) {
      if (w < tw) at += T.wsum[w];
      total += T.wsum[w];
    }
    if (live) T.live[at + __popc(b & ((1u << lane) - 1u))] = s0 + i;
    base = total;
  }
  team_bar();   // the list
  return base;
}

// 16 bytes from global to shared memory, asynchronously (cp_wait_all
// waits for the thread's copies)
__device__ __forceinline__ void cp16(unsigned char* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Layer 1's input columns col0 .. col0 + 64 ncols - 1 of the tile's rows
// (slots slots[0 .. nrows-1]): the slot's K-sum row, then PE(viewdir) in
// the block layout (sin(v_a 2^f) at H + 3 f + a, the cosines 3 nvf later,
// v the bf16-rounded view direction), zeros to the end of the last slab.
// The 16-byte chunks that lie below H are copied by cp.async, every copy
// of the tile issued at once (the caller waits); the rest of the K-sums
// and the zeros go an element a thread, the PE a pair a thread (one
// sincosf, each value by the precise function).
template <int NT>
__device__ __forceinline__ void colour_rows(unsigned char* A,
                                            const int* slots, int nrows,
                                            const ColourArgs& a, int col0,
                                            int ncols, int tt) {
  if (TOWER_PROBE & 1) return;
  constexpr int kT = Shape<NT>::kTeamThreads;
  const int H = a.H, n3 = 3 * a.nvf, nin = H + 2 * n3;
  const int col1 = col0 + 64 * ncols;
  // the chunks of a row in this pass that cp.async copies
  const int hv = ((uintptr_t)a.hw & 15) == 0 ? H / 8 : 0;
  const int nv = min(8 * ncols, max(0, hv - col0 / 8));
#pragma unroll 4
  for (int e = tt; e < nrows * nv; e += kT) {
    const int r = e / nv, c = e - r * nv;
    cp16(A + a_offset(r, 8 * c),
         a.hw + (size_t)slots[r] * a.hs + col0 + 8 * c);
  }
  // the K-sums past those chunks, then the zeros past the inputs
  const int k0 = max(col0, 8 * hv), nk = max(0, min(col1, H) - k0);
  const int z0 = max(col0, nin), ne = nk + max(0, col1 - z0);
  for (int e = tt; e < nrows * ne; e += kT) {
    const int r = e / ne, j = e - r * ne;
    const int col = j < nk ? k0 + j : z0 + j - nk;
    *(bf16*)(A + a_offset(r, col - col0)) =
        j < nk ? a.hw[(size_t)slots[r] * a.hs + col] : __float2bfloat16(0.f);
  }
  // PE(viewdir): pair p is sin at H + p and cos at H + 3 nvf + p
  if (nin <= col0 || H >= col1) return;
  for (int e = tt; e < nrows * n3; e += kT) {
    const int r = e / n3, p = e - r * n3;
    const int sc = H + p, cc = sc + n3;
    const bool s_in = sc >= col0 && sc < col1, c_in = cc >= col0 && cc < col1;
    if (!s_in && !c_in) continue;
    const int f = p / 3, ax = p - 3 * f;
    float sn, cs;
    sincosf(bf_round(__ldg(a.vd + (size_t)slots[r] * 3 + ax)) *
                (float)(1 << f),
            &sn, &cs);
    if (s_in) *(bf16*)(A + a_offset(r, sc - col0)) = __float2bfloat16(sn);
    if (c_in) *(bf16*)(A + a_offset(r, cc - col0)) = __float2bfloat16(cs);
  }
}

// The colour tower on M slots, a row a live slot. A team walks spans of
// a.span slots as tower_wg_kernel's teams do; within a span it runs the
// compacted list of live slots 64 a tile.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
colour_wg_kernel(const ColourArgs a) {
  using S = Shape<NT>;
  using B = Block<NT, ColourTables>;
  constexpr int kN = S::kN, kNp = S::kNp;
  B& sm = block_smem<B>();
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  const int nin = colour_inputs(a.H, a.nvf);
  const int n1 = (nin + 63) / 64;
  const int last1 = (nin - 64 * (n1 - 1) + 15) / 16;
  const int seq = (n1 + (a.layers - 1) * NT) * S::kHalves;
  if (!block_begin<NT>(sm, a.w, seq, warp, lane)) return;

  const int wg = warp >> 2, ww = warp & 3;
  const int team = S::kShared ? 0 : wg;
  const int tt = S::kShared ? (int)threadIdx.x : ww * 32 + lane;
  const int tw = S::kShared ? warp : ww;
  const int col_base = S::kShared ? wg * 256 : 0;
  auto team_bar = [&]() { team_sync<NT>(wg); };
  ColourTables& T = sm.t[team];
  unsigned char* A = sm.a[team];
  const uint32_t a_base = smem_u32(A);
  Consumer<NT> cons;
  cons.data = smem_u32(sm.ring);
  cons.full = smem_u32(sm.full);
  cons.empty = smem_u32(sm.empty);
  cons.n = S::kShared ? wg : 0;
  const float* bc = a.f;                        // [layers][Np]
  const float* wch = bc + a.layers * kNp;       // [3][Np]
  const float* bch = wch + 3 * kNp;

  int span_it = 0, n_live = 0, cursor = 0, agree = 0;
  float acc[kN / 2];
  for (;;) {
    // ---- the team's next tile: up to 64 slots of its list
    while (cursor >= n_live) {
      const int span =
          (span_it * (int)gridDim.x + (int)blockIdx.x) * S::kTeams + team;
      if (span >= a.nspans) break;
      ++span_it;
      const int s0 = span * a.span;
      n_live = colour_scan<NT>(T, a, s0, min(a.span, a.M - s0), tt, tw, lane,
                               wg);
      cursor = 0;
    }
    const bool have = cursor < n_live;
    const int first = cursor, nrows = have ? min(kRows, n_live - cursor) : 0;
    cursor += nrows;
    const int go = teams_with_tile<NT>(sm, have, team, tt, agree);
    if (go == 0) break;
    if (!((go >> team) & 1)) {
      cons.drain(seq, lane);
      continue;
    }
    const int* slots = T.live + first;

    // ---- layer 1 on [K-sum, PE(viewdir)], in passes of the slabs the
    // tile holds
    for (int base = 0; base < n1; base += S::kASlabs) {
      const int cnt = min(S::kASlabs, n1 - base);
      team_bar();   // the last pass's (or tile's) products are done
      colour_rows<NT>(A, slots, nrows, a, 64 * base, cnt, tt);
      cp_wait_all();
      tower::fence_async_smem();
      team_bar();
      layer_mma<NT>(acc, cons, a_base, cnt, base + cnt == n1 ? last1 : 4,
                    base > 0, lane);
    }
    // ---- the hidden layers in place
    for (int l = 1; l < a.layers; ++l) {
      team_bar();
      store_hidden<kN, true>(acc, bc + (l - 1) * kNp, A, col_base, ww, lane);
      tower::fence_async_smem();
      team_bar();
      layer_mma<NT>(acc, cons, a_base, NT, 4, false, lane);
    }

    // ---- the head HC -> 3 from the registers
    const float* bl = bc + (a.layers - 1) * kNp;
    const int q = lane & 3, r0 = ww * 16 + (lane >> 2);
    float o[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = col_base + 8 * j + 2 * q;
      const float2 b = __ldg((const float2*)(bl + col));
      const float x00 = bf_round(tower::bias_act<true>(acc[4 * j], b.x));
      const float x01 = bf_round(tower::bias_act<true>(acc[4 * j + 1], b.y));
      const float x10 = bf_round(tower::bias_act<true>(acc[4 * j + 2], b.x));
      const float x11 = bf_round(tower::bias_act<true>(acc[4 * j + 3], b.y));
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float2 w = __ldg((const float2*)(wch + ch * kNp + col));
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
        o[h][ch] = o[h][ch] + __shfl_xor_sync(0xffffffffu, o[h][ch], 1);
        o[h][ch] = o[h][ch] + __shfl_xor_sync(0xffffffffu, o[h][ch], 2);
      }
    auto put = [&](int r, int ch, float d) {
      const float y = bf_round(bf_round(d) + __ldg(bch + ch));
      const float sg = 1.f / (1.f + expf(-y));
      a.rgb[(size_t)slots[r] * 3 + ch] = sg * (1.f + 2e-3f) - 1e-3f;
    };
    if (S::kShared) {
      if (q == 0)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          T.head[wg][r0][ch] = o[0][ch];
          T.head[wg][r0 + 8][ch] = o[1][ch];
        }
      team_bar();
      if (tt < nrows * 3) {
        const int r = tt / 3, ch = tt - 3 * r;
        put(r, ch, T.head[0][r][ch] + T.head[1][r][ch]);
      }
    } else if (q == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (r0 < nrows) put(r0, ch, o[0][ch]);
        if (r0 + 8 < nrows) put(r0 + 8, ch, o[1][ch]);
      }
    }
  }
  block_end(sm, cons.n);
}

namespace {
// the SM count of each device, once the kernel of (NT index, mode) has
// its shared memory limit raised there (mode 0: colour_wg_kernel); 0
// before. Internal to each source that includes this header: a
// function-local static of a template would be one object across every
// library of the process (the probe builds of a source are libraries of
// their own).
int g_sms[4][4][64];
}  // namespace

// Blocks and spans of a launch of `kern` (`bytes` of shared memory a
// block) over M slots: every SM one block, at most one team a kMinSpan
// slots, every team as many spans of at most span_max slots. The dynamic
// shared memory limit and the SM count are looked up once a kernel
// (`sms_of`: its row of g_sms) and device.
template <class Kern>
cudaError_t plan(Kern kern, int bytes, int (&sms_of)[64], long long M,
                 int teams, int span_max, int& blocks, int& span,
                 int& nspans) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int sms = 0, per = 0;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, kern, kThreads, bytes)) != cudaSuccess)
      return err;
    if (per < 1) return cudaErrorInvalidConfiguration;
    sms_of[dev] = sms;
  }
  const long long teams_wanted = (M + kMinSpan - 1) / kMinSpan;
  blocks = (int)std::max(
      1LL, std::min<long long>(sms_of[dev], (teams_wanted + teams - 1) / teams));
  const long long units = (long long)blocks * teams;
  const long long rounds = (M + units * span_max - 1) / (units * span_max);
  span = (int)std::max<long long>(
      kMinSpan, (M + units * rounds - 1) / (units * rounds));
  nspans = (int)((M + span - 1) / span);
  return cudaSuccess;
}

template <int NT, int MODE>
cudaError_t launch_nt(Args a, cudaStream_t stream) {
  using S = Shape<NT>;
  int blocks = 0;
  const cudaError_t err =
      plan(tower_wg_kernel<NT, MODE>, block_bytes<NT>(),
           g_sms[__builtin_ctz(NT)][MODE], a.M, S::kTeams, S::kSpanMax,
           blocks, a.span, a.nspans);
  if (err != cudaSuccess) return err;
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

template <int NT>
cudaError_t launch_colour_nt(ColourArgs a, cudaStream_t stream) {
  constexpr int kBytes = block_bytes<NT, ColourTables>();
  int blocks = 0;
  const cudaError_t err =
      plan(colour_wg_kernel<NT>, kBytes, g_sms[__builtin_ctz(NT)][0], a.M,
           Shape<NT>::kTeams, kColourSpanMax, blocks, a.span, a.nspans);
  if (err != cudaSuccess) return err;
  colour_wg_kernel<NT><<<blocks, kThreads, kBytes, stream>>>(a);
  return cudaGetLastError();
}

// the colour tower at colour width HC (padded_width(HC) = 64 NT)
inline cudaError_t launch_colour(const ColourArgs& a, int HC,
                                 cudaStream_t stream) {
  if (a.M <= 0) return cudaSuccess;
  switch (padded_width(HC)) {
    case 64: return launch_colour_nt<1>(a, stream);
    case 128: return launch_colour_nt<2>(a, stream);
    case 256: return launch_colour_nt<4>(a, stream);
    default: return launch_colour_nt<8>(a, stream);
  }
}

}  // namespace twg
