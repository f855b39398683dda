// The per-neighbour MLP tower of the radiance decoder for Hopper, shared
// by csrc/fused_decode.cu (fused_decode, fused_decode2) and
// csrc/fused_chunk.cu (fused_chunk_decode). It replaces the tower inside
// the Pallas kernels pointnerf2studio_tpu/ops/fused_decode.py::
// _pair_kernel / ::_kacc_kernel and ops/fused_chunk.py::_kernel: four
// layers 284->256, 256->256, (256+7)->256, 256->256 of bf16 operands
// summed in f32, bias, LeakyReLU(0.1), bf16 between layers, and the
// 256->1 density head.
//
// What bounds it: tensor-core operations (0.54 MFLOP per row against
// ~150 bytes of input), and under that the 557 KB of weights that every
// row tile needs. The design, point by point:
//   * Persistent blocks, one per SM: two consumer warpgroups (128
//     threads, 64 packed rows each) and one producer warpgroup, of which
//     one thread works. Each weight byte fetched from L2 is used on up
//     to 128 rows. The producer's group gives its registers up
//     (setmaxnreg 40) and the consumers take 232 a thread.
//   * The weights are packed on the host, once per set of weights, in
//     the shared-memory image wgmma reads: k-slabs of 64 inputs x 256
//     outputs, K-major (row n holds its 64 k values in 128 bytes), 8-row
//     groups 1024 bytes apart, the 16-byte chunk c of row n stored at
//     chunk c ^ (n & 7) (the 128-byte swizzle). One slab is one
//     contiguous 32 KB cp.async.bulk into a stage of a shared-memory
//     ring (4 stages), completing on the stage's "full" mbarrier;
//     each consumer warp releases a stage on its "empty" mbarrier after
//     the wgmma group that read it has completed. The producer runs the
//     fixed slab sequence of a tile over and over and so prefetches
//     across layers and tiles; it stops when the consumers raise `done`
//     and waits for the copies still in flight.
//   * Products are wgmma.mma_async m64n256k16 (bf16 x bf16 -> f32), both
//     operands through shared-memory descriptors. A comes from shared
//     memory: each warpgroup keeps its 64 x 320 bf16 activation tile in
//     the same swizzled K-major layout (five slabs of 64 columns; slab 4
//     holds layer 1's columns 256-287 and the colour/dirdot columns of
//     layer 3 at 288-303) and every hidden layer's epilogue overwrites
//     slabs 0-3 in place, straight from the accumulator registers (128
//     f32 a thread): bias, LeakyReLU, bf16 round, one 4-byte store per
//     column pair, bank-conflict free under the swizzle. One named
//     barrier per layer per warpgroup; the warpgroups meet only on the
//     ring and once per tile to agree whether to go on.
//   * Tiles are full: a warpgroup scans a span of 128 slots for their
//     row counts, then takes, tile by tile, the longest run of up to 32
//     consecutive slots whose rows fit 64 (a slot's K rows never split).
//   * The density head is a dot product on the CUDA cores from the
//     registers (quad shuffle); the K-sums are taken in f32 in k order
//     by one thread per column walking the rows of a 64 x 64 f32 staging
//     tile (four slots' chains at a time), four column passes per tile.
//   * The positional encodings take one precise sincosf per input; the
//     embedding's octaves 2x and 4x follow by the double-angle formulas
//     (next_octave). With eight warps an SM the feature rows are bound
//     by latency, so a warp keeps four rows' loads and chains in flight
//     (feature_rows).
//   * run_tower is the one body of the persistent tower kernels: roles,
//     ring, span scan, tiles, the agreement of the two warpgroups on
//     going on, the four layers and the shutdown. A kernel gives it a
//     policy: where a slot's rows and weights come from, what is written
//     for rows the tower skips, and where a tile's results go.
//     block_begin / block_end are its role split and shutdown, which the
//     colour kernel of fused_chunk.cu uses around its own loop.
// The rounding points are the callers': kRoundBias picks
// bf16(bf16(acc) + bias) (fused_chunk) or acc + f32 bias (fused_decode).
// Both sources are compiled with -fmad=false, so the epilogue's adds and
// multiplies round separately as the plain versions' do; wgmma is not
// affected by the flag.
// Registers: the kernels start with 168 a thread (384 threads); after the
// role split the consumers hold 232 and the producer's group 40
// (setmaxnreg). nvcc 12.8 -Xptxas -v: 168 registers and no spill in the
// tower kernels of fused_decode.cu and fused_chunk.cu and in the colour
// kernel. Shared memory: kSmemBytes = 225,872 a block (80 KB activations,
// 128 KB ring, 11.5 KB tables), one block an SM.
// What the parts cost is measured by `chip_smoke.py --probe` (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Probe builds (-DTOWER_PROBE=bits, timed by chip_smoke.py --probe; the
// results are wrong on purpose) leave one part of the kernel out to show
// what the others cost: 1 the feature rows, 2 the wgmma products,
// 4 the weight copies and the waits on them, 8 the K-sums and
// row outputs, 16 fused_chunk's colour tower.
#ifndef TOWER_PROBE
#define TOWER_PROBE 0
#endif

namespace tower {

typedef __nv_bfloat16 bf16;

constexpr int kH = 256;               // tower width
constexpr int kKMax = 8;              // neighbours per slot at most
constexpr int kStages = 4;            // depth of the ring of weight stages
constexpr int kWgRows = 64;           // packed rows of one warpgroup's tile
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer's group
constexpr int kConsumerRegs = 232;    // registers a thread after the split
constexpr int kProducerRegs = 40;
constexpr int kSpan = 128;            // slots a warpgroup scans at a time
constexpr int kTakeMax = 32;          // slots of one tile at most
constexpr int kSlabBytes = 64 * kH * 2;       // one weight k-slab, 32 KB
constexpr int kASlabBytes = kWgRows * 128;    // one activation slab, 8 KB
constexpr int kARegion = 5 * kASlabBytes;     // a warpgroup's activations
constexpr int kTowerSlabs = 17;       // W1: 0-3 + 4 (tail), W2: 5-8,
                                      // W3: 9-12 (+ 4 again), W4: 13-16
constexpr int kTowerSeq = 18;         // stages a tile's tower consumes
constexpr int kStLd = 72;             // K-sum staging row stride, floats
constexpr int kC = 32;                // embedding width
constexpr int kD = 6;                 // dists width
constexpr int kCD = 7;                // colour (3) + dirdot (4)
constexpr int kNff = 3, kNdf = 5;     // PE octaves of emb and dists
// the f32 parameter buffer of the tower
constexpr int kB1 = 0, kB2 = kH, kB3 = 2 * kH, kB4 = 3 * kH;
constexpr int kWD = 4 * kH;           // density head weights (bf16 values)
constexpr int kBD = 5 * kH;           // density head bias
constexpr int kNTowerF32 = 5 * kH + 16;

// ---- small numerics ----
__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float leaky(float x) {
  return fmaxf(x, 0.1f * x);   // = x > 0 ? x : 0.1 x
}
// (sin x, cos x) -> (sin 2x, cos 2x): the embedding's higher octaves
// from one sincosf. Each step adds a few f32 ulp of a value near 1 (near
// a zero of cos 2x that is far more than an ulp of the result, and still
// ~1e-7 absolute), so a feature differs from the directly evaluated one
// in a bf16 rounding now and then; tests/test_torch_cuda.py holds the
// feature rows to that. What evaluating every octave with sincosf costs
// the tower kernels instead is in PERF.md.
__device__ __forceinline__ void next_octave(float& sn, float& cs) {
  const float s2 = 2.f * (sn * cs);
  cs = (cs - sn) * (cs + sn);
  sn = s2;
}
template <bool kRoundBias>
__device__ __forceinline__ float bias_act(float acc, float b) {
  return leaky(kRoundBias ? bf_round(bf_round(acc) + b) : acc + b);
}

// ---- PTX: shared addresses, mbarriers, bulk copies, barriers ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
// `bytes` (a multiple of 16) from global to shared memory, completing on
// the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// generic-proxy writes to shared memory before async-proxy (wgmma) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// the 128 threads of consumer warpgroup `wg`
__device__ __forceinline__ void wg_bar(int wg) { bar_sync(2 + wg, 128); }
// all consumer threads
__device__ __forceinline__ void consumers_bar() {
  bar_sync(1, kConsumerThreads);
}

// ---- PTX: wgmma ----
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// descriptor of a K-major, 128-byte-swizzled operand at shared address
// `addr`: 8-row groups 1024 bytes apart (SBO), LBO unused under the
// swizzle. A k-step of 16 inside a 64-wide slab is 32 bytes on `addr`.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// D[64, 256] (+)= A[64, 16] * B[16, 256], A and B through shared-memory
// descriptors, D in 128 registers a thread; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64, 128] (+)= A[64, 16] * B[16, 128], A and B through shared-memory
// descriptors, D in 64 registers a thread; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// keeps the compiler from moving reads of `d` above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- the ring of weight stages ----
// shared addresses of a ring of S stages of kSlabBytes and its barriers
struct Ring {
  uint32_t data, full, empty;
};

template <int S>
__device__ __forceinline__ void ring_init(const Ring& r) {
  for (int s = 0; s < S; ++s) {
    mbar_init(r.full + 8 * s, 1);
    mbar_init(r.empty + 8 * s, kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// slab of the packed tower weights that stage use `idx` of a tile reads
__device__ __forceinline__ int tower_slab(int idx) {
  return idx == 13 ? 4 : (idx > 13 ? idx - 1 : idx);
}

// the tower's slab sequence as the producer's `entry`
struct TowerEntry {
  __device__ void operator()(int idx, uint32_t& off, uint32_t& bytes) const {
    off = (uint32_t)tower_slab(idx) * kSlabBytes;
    bytes = kSlabBytes;
  }
};

// The producer (one thread). `entry(idx, off, bytes)` gives the piece of
// `weights` for stage use idx of the tile's sequence of SEQ. `done` is
// raised by the consumers after their last tile, `consumed` is the
// number of stage uses they made.
template <int S, int SEQ, class Entry>
__device__ void produce(const Ring& r, const unsigned char* weights,
                        Entry entry, volatile int* done,
                        volatile int* consumed) {
  uint32_t n = 0;
  if (TOWER_PROBE & 4) return;
  for (;; ++n) {
    const uint32_t st = n % S, parity = ((n / S) & 1) ^ 1;
    bool stop = false;
    while (!mbar_try_wait(r.empty + 8 * st, parity)) {
      if (*done) {
        stop = true;
        break;
      }
    }
    if (stop) break;
    uint32_t off, bytes;
    entry((int)(n % SEQ), off, bytes);
    mbar_expect_tx(r.full + 8 * st, bytes);
    bulk_load(r.data + st * kSlabBytes, weights + off, bytes,
              r.full + 8 * st);
  }
  // copies started and never consumed must land before the block exits
  for (uint32_t j = (uint32_t)*consumed; j < n; ++j)
    mbar_wait(r.full + 8 * (j % S), (j / S) & 1);
}

// a consumer warp's view of the ring: n counts the stage uses so far
template <int S>
struct Consumer {
  Ring r;
  uint32_t n;
  __device__ __forceinline__ uint32_t wait() {   // -> stage index
    const uint32_t st = n % S;
    if (!(TOWER_PROBE & 4)) mbar_wait(r.full + 8 * st, (n / S) & 1);
    return st;
  }
  __device__ __forceinline__ void release(uint32_t st, int lane) {
    if (lane == 0 && !(TOWER_PROBE & 4)) mbar_arrive(r.empty + 8 * st);
  }
  // pass `count` stage uses by without reading them
  __device__ __forceinline__ void drain(int count, int lane) {
    for (int i = 0; i < count; ++i) {
      const uint32_t st = wait();
      __syncwarp();
      release(st, lane);
      ++n;
    }
  }
};

// acc[64, 256] = A @ W for one layer: the four 64-wide slabs of the
// warpgroup's activations at a_base against as many stages, then, if
// TAIL_STEPS > 0, that many k-steps of activation slab 4 from byte
// TAIL_OFF on against the shared tail slab from the same byte on.
template <int S, int TAIL_STEPS, int TAIL_OFF>
__device__ __forceinline__ void layer_mma(float (&acc)[128], Consumer<S>& c,
                                          uint32_t a_base, int lane) {
  wg_fence();
  uint32_t prev = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t st = c.wait();
    const uint32_t a = a_base + s * kASlabBytes;
    const uint32_t b = c.r.data + st * kSlabBytes;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (!(TOWER_PROBE & 2))
        wgmma_n256(acc, make_desc(a + ks * 32), make_desc(b + ks * 32),
                   (s | ks) != 0);
    wg_commit();
    if (s > 0) {
      wg_wait<1>();
      c.release(prev, lane);
    }
    prev = st;
    ++c.n;
  }
  if (TAIL_STEPS > 0) {
    const uint32_t st = c.wait();
    const uint32_t a = a_base + 4 * kASlabBytes + TAIL_OFF;
    const uint32_t b = c.r.data + st * kSlabBytes + TAIL_OFF;
#pragma unroll
    for (int ks = 0; ks < TAIL_STEPS; ++ks)
      if (!(TOWER_PROBE & 2))
        wgmma_n256(acc, make_desc(a + ks * 32), make_desc(b + ks * 32), 1);
    wg_commit();
    wg_wait<1>();
    c.release(prev, lane);
    prev = st;
    ++c.n;
  }
  wg_wait<0>();
  c.release(prev, lane);
  fence_regs(acc);
}

// byte offset of element (row, col) in a warpgroup's activation region
__device__ __forceinline__ int a_offset(int row, int col) {
  return (col >> 6) * kASlabBytes + row * 128 +
         ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// hidden layer epilogue: bf16(LeakyReLU(acc + bias)) into activation
// slabs 0-3 in place, then the fence and barrier the next layer's wgmma
// needs. ww: warp within the warpgroup.
template <bool kRoundBias>
__device__ __forceinline__ void hidden_epilogue(float (&acc)[128],
                                                const float* __restrict__ bias,
                                                unsigned char* A, int wg,
                                                int ww, int lane) {
  const int q = lane & 3, r0 = ww * 16 + (lane >> 2), rx = r0 & 7;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 b = __ldg((const float2*)(bias + 8 * j + 2 * q));
    unsigned char* p = A + (j >> 3) * kASlabBytes + r0 * 128 +
                       (((j & 7) ^ rx) << 4) + q * 4;
    *(__nv_bfloat162*)p = __floats2bfloat162_rn(
        bias_act<kRoundBias>(acc[4 * j], b.x),
        bias_act<kRoundBias>(acc[4 * j + 1], b.y));
    *(__nv_bfloat162*)(p + 8 * 128) = __floats2bfloat162_rn(
        bias_act<kRoundBias>(acc[4 * j + 2], b.x),
        bias_act<kRoundBias>(acc[4 * j + 3], b.y));
  }
  fence_async_smem();
  wg_bar(wg);
}

// layer 4's activation in place, kept in f32
template <bool kRoundBias>
__device__ __forceinline__ void activate(float (&acc)[128],
                                         const float* __restrict__ bias,
                                         int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 b = __ldg((const float2*)(bias + 8 * j + 2 * q));
    acc[4 * j] = bias_act<kRoundBias>(acc[4 * j], b.x);
    acc[4 * j + 1] = bias_act<kRoundBias>(acc[4 * j + 1], b.y);
    acc[4 * j + 2] = bias_act<kRoundBias>(acc[4 * j + 2], b.x);
    acc[4 * j + 3] = bias_act<kRoundBias>(acc[4 * j + 3], b.y);
  }
}

// bf16(h) . wd for the thread's two rows (r0 and r0 + 8), complete in
// every lane of the quad
__device__ __forceinline__ void density_dot(const float (&acc)[128],
                                            const float* __restrict__ wd,
                                            int lane, float& d0, float& d1) {
  const int q = lane & 3;
  d0 = d1 = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 w = __ldg((const float2*)(wd + 8 * j + 2 * q));
    d0 = d0 + bf_round(acc[4 * j]) * w.x;
    d0 = d0 + bf_round(acc[4 * j + 1]) * w.y;
    d1 = d1 + bf_round(acc[4 * j + 2]) * w.x;
    d1 = d1 + bf_round(acc[4 * j + 3]) * w.y;
  }
  d0 = d0 + __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 = d0 + __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 = d1 + __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 = d1 + __shfl_xor_sync(0xffffffffu, d1, 2);
}

// ---- tiles ----
// per-warpgroup tables of the span being scanned and the tile in work
struct Tables {
  int cnt[kSpan];               // rows of each slot of the span
  float wkv[kSpan][kKMax];      // the span's weights
  unsigned char bits[kSpan];    // which k of each slot have a row
  unsigned char live[kSpan];    // the slot wants the tower's outputs
  int slot_row0[kTakeMax];      // first packed row of each slot of the tile
  int slot_cnt[kTakeMax];
  int row_src[kWgRows];         // row m * K + k of the kernel's inputs
  float row_wk[kWgRows];
  float row_alpha[kWgRows];
};

// The next tile of a span: the longest run of slots from `cursor` on, at
// most kTakeMax, whose rows fit kWgRows. Every warp computes the same
// answer; lane i holds slot cursor + i: its count in `c`, its first row
// in `row0`.
__device__ __forceinline__ void form_tile(const int* cnt, int span_n,
                                          int cursor, int lane, int& n_take,
                                          int& nrows, int& c, int& row0) {
  c = cursor + lane < span_n ? cnt[cursor + lane] : 1000;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  n_take = __popc(__ballot_sync(0xffffffffu, incl <= kWgRows));
  nrows = n_take ? __shfl_sync(0xffffffffu, incl, n_take - 1) : 0;
  row0 = incl - c;
}

// Layer-1 input rows and colour/dirdot columns of a tile: packed row r
// is row T.row_src[r] of emb bf16 [., 32], dists f32 [., 6] and cd f32
// [., 7]; feature = [emb, PE_block(emb, 3), PE_block(dists, 5)], sin/cos
// in f32 of the bf16-rounded input. A warp takes every fourth row, a
// lane per embedding channel, four rows in flight so that the loads and
// the sin/cos chains overlap.
__device__ __forceinline__ void feature_rows(unsigned char* A,
                                             const Tables& T, int nrows,
                                             const bf16* __restrict__ emb,
                                             const float* __restrict__ dists,
                                             const float* __restrict__ cd,
                                             int ww, int lane) {
  for (int rb = ww; rb < nrows && !(TOWER_PROBE & 1); rb += 16) {
    bf16 eb[4];
    float dv[4], cv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = rb + 4 * u;
      eb[u] = __float2bfloat16(0.f);
      dv[u] = cv[u] = 0.f;
      if (r < nrows) {
        const size_t g = (size_t)T.row_src[r];
        eb[u] = emb[g * kC + lane];
        if (lane < kD * kNdf) dv[u] = dists[g * kD + lane % kD];
        if (lane < kCD) cv[u] = cd[g * kCD + lane];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = rb + 4 * u;
      if (r >= nrows) continue;
      *(bf16*)(A + a_offset(r, lane)) = eb[u];
      float sn, cs;
      sincosf(__bfloat162float(eb[u]), &sn, &cs);
#pragma unroll
      for (int j = 0; j < kNff; ++j) {
        *(bf16*)(A + a_offset(r, kC + j * kC + lane)) = __float2bfloat16(sn);
        *(bf16*)(A + a_offset(r, kC + kC * kNff + j * kC + lane)) =
            __float2bfloat16(cs);
        next_octave(sn, cs);
      }
      constexpr int kDist0 = kC + 2 * kC * kNff;   // 224
      if (lane < kD * kNdf) {
        sincosf(bf_round(dv[u]) * (float)(1 << (lane / kD)), &sn, &cs);
        *(bf16*)(A + a_offset(r, kDist0 + lane)) = __float2bfloat16(sn);
        *(bf16*)(A + a_offset(r, kDist0 + kD * kNdf + lane)) =
            __float2bfloat16(cs);
      } else {
        // columns 284-287 (layer 1's padding)
        const int col = kDist0 + 2 * kD * kNdf + 2 * (lane - kD * kNdf);
        *(__nv_bfloat162*)(A + a_offset(r, col)) =
            __floats2bfloat162_rn(0.f, 0.f);
      }
      if (lane < 16)   // columns 288-303: colour, dirdot, zeros
        *(bf16*)(A + a_offset(r, 288 + lane)) = __float2bfloat16(cv[u]);
    }
  }
  fence_async_smem();
}

// One column pass (columns 64 P .. 64 P + 63) of the K-sums of h * wk:
// the warpgroup stages its accumulators' quarter as f32 [64][kStLd] in
// `st`, then thread (half, column) walks the rows of half the tile's
// slots in k order and hands each slot's sum to sink(slot, column, sum).
template <int P, class Sink>
__device__ __forceinline__ void ksum_pass(const float (&acc)[128], float* st,
                                          const Tables& T, int n_take, int wg,
                                          int ww, int lane, Sink sink) {
  const int q = lane & 3, r0 = ww * 16 + (lane >> 2);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = P * 8 + jj;
    *(float2*)(st + r0 * kStLd + jj * 8 + 2 * q) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *(float2*)(st + (r0 + 8) * kStLd + jj * 8 + 2 * q) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  wg_bar(wg);
  // four slots' chains at a time, so that their loads overlap
  const int t = ww * 32 + lane, col = t & 63;
  const int mid = (n_take + 1) >> 1;
  const int i0 = t < 64 ? 0 : mid, i1 = t < 64 ? mid : n_take;
  for (int ib = i0; ib < i1; ib += 4) {
    int row0[4], n[4];
    float s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = ib + u < i1;
      row0[u] = in ? T.slot_row0[ib + u] : 0;
      n[u] = in ? T.slot_cnt[ib + u] : 0;
      s[u] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kKMax; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r < n[u])
          s[u] = s[u] + st[(row0[u] + r) * kStLd + col] * T.row_wk[row0[u] + r];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ib + u < i1) sink(ib + u, P * 64 + col, s[u]);
  }
  wg_bar(wg);
}

// keeps `x`, and the work it depends on, alive in a probe build
__device__ __forceinline__ void keep_alive(float x) {
  asm volatile("" ::"f"(x));
}

// The per-slot outputs of a tile whose K-sums are taken in the kernel.
// al0, al1: the alphas of the thread's two rows (r0 and r0 + 8). Slot i
// of the tile gets its sum_k alpha_k * wk with its row count through
// slot_out(i, sum, rows), and its sum_k h_k * wk, column by column,
// through sink(i, column, sum). The K-sums' staging tile overwrites the
// warpgroup's activations.
template <class SlotOut, class Sink>
__device__ __forceinline__ void slot_sums(const float (&acc)[128], float al0,
                                          float al1, Tables& T,
                                          unsigned char* A, int n_take,
                                          int wg, int ww, int lane,
                                          SlotOut slot_out, Sink sink) {
  if (TOWER_PROBE & 8) {
    keep_alive(al0 + al1 + acc[5]);
    wg_bar(wg);
    return;
  }
  const int t = ww * 32 + lane, r0 = ww * 16 + (lane >> 2);
  if ((lane & 3) == 0) {
    T.row_alpha[r0] = al0;
    T.row_alpha[r0 + 8] = al1;
  }
  wg_bar(wg);
  if (t < n_take) {
    float aw = 0.f;
    const int row0 = T.slot_row0[t], n = T.slot_cnt[t];
    for (int r = row0; r < row0 + n; ++r)
      aw = aw + T.row_alpha[r] * T.row_wk[r];
    slot_out(t, aw, n);
  }
  float* st = (float*)A;
  ksum_pass<0>(acc, st, T, n_take, wg, ww, lane, sink);
  ksum_pass<1>(acc, st, T, n_take, wg, ww, lane, sink);
  ksum_pass<2>(acc, st, T, n_take, wg, ww, lane, sink);
  ksum_pass<3>(acc, st, T, n_take, wg, ww, lane, sink);
}

// ---- the block: shared memory, roles, shutdown ----
// a block's shared memory (dynamic, kSmemBytes): the two warpgroups'
// activation regions, the ring, the tables, and the words the consumers
// agree and shut down by
struct Block {
  unsigned char a[2][kARegion];
  unsigned char ring[kStages][kSlabBytes];
  uint64_t full[kStages], empty[kStages];
  Tables t[2];
  int have[2];
  volatile int done, consumed;
};
constexpr int kSmemBytes = (int)sizeof(Block) + 1024;   // + the alignment

__device__ __forceinline__ Block& block_smem() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<Block*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
}

// Sets the ring up and splits the block's roles. The producer's group
// gives its registers up (setmaxnreg), one of its threads streams
// `weights` by `entry`'s sequence of SEQ stage uses until the consumers
// are done, and the group gets false: it returns from the kernel. The
// consumers take their registers and get true, their view of the ring
// in `c`, and their warp (through a shuffle, so that the compiler knows
// it is warp-uniform) and lane.
template <int SEQ, class Entry>
__device__ __forceinline__ bool block_begin(Block& sm,
                                            const unsigned char* weights,
                                            Entry entry, Consumer<kStages>& c,
                                            int& warp, int& lane) {
  warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
  lane = threadIdx.x & 31;
  const Ring ring = {smem_u32(sm.ring), smem_u32(sm.full),
                     smem_u32(sm.empty)};
  if (threadIdx.x == 0) {
    ring_init<kStages>(ring);
    sm.done = 0;
    sm.consumed = 0;
  }
  __syncthreads();
  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0)
      produce<kStages, SEQ>(ring, weights, entry, &sm.done, &sm.consumed);
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  c.r = ring;
  c.n = 0;
  return true;
}

// the consumers' last act: tells the producer how many stage uses they
// made and that it may stop
__device__ __forceinline__ void block_end(Block& sm,
                                          const Consumer<kStages>& c) {
  if (threadIdx.x == 0) {
    sm.consumed = (int)c.n;
    __threadfence_block();
    sm.done = 1;
  }
}

// Host side: raises `kernel`'s dynamic shared memory limit to kSmemBytes
// and gives the blocks of a persistent launch over `units` warpgroup
// units: two a block, one block an SM at most.
template <class Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, int units, int& blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  blocks = min(sms, (units + 1) / 2);
  return cudaSuccess;
}

// The body of a persistent tower kernel over M slots of K rows: spans
// are dealt to the warpgroups round robin, a warpgroup packs its span's
// rows into tiles and runs the four layers and the density dot on each.
// The policy P says where the rows come from and where the results go:
//   P::kRoundBias            the epilogues' rounding (bias_act)
//   p.emb, p.dists, p.cd     the rows' inputs; row m * K + k is (m, k)
//   p.load_slot(m, K, w, live) -> bits
//       slot m's weights into w[0..K); bit k of the result is set where
//       (m, k) is a row for the tower; `live`: the slot wants the
//       tower's outputs, rows or not
//   p.no_row(m, bits, K, nrows, lane)
//       called by one warp for each slot of a tile of `nrows` rows
//       before the tower runs: writes what the tower will not
//   p.finish(acc, d0, d1, F, T, A, m0, n_take, nrows, wg, ww, lane)
//       the tile's outputs from layer 4's activations `acc` (f32) and
//       the thread's two rows' density dots; the tile holds slots m0 ..
//       m0 + n_take - 1. Ends on a barrier of the warpgroup if it wrote
//       to T or A.
// A tile none of whose slots is live is passed over. The two warpgroups
// share the ring, so one that has run out of tiles while the other has
// not lets a tile's stages pass by.
template <class P>
__device__ __forceinline__ void run_tower(const P& p,
                                          const unsigned char* __restrict__ W,
                                          const float* __restrict__ F, int M,
                                          int K) {
  Block& sm = block_smem();
  Consumer<kStages> ring_c;
  int warp, lane;
  if (!block_begin<kTowerSeq>(sm, W, TowerEntry(), ring_c, warp, lane)) return;
  const int wg = warp >> 2, ww = warp & 3, t = ww * 32 + lane;
  Tables& T = sm.t[wg];
  unsigned char* A = sm.a[wg];
  const uint32_t a_base = smem_u32(A);
  const int n_spans = (M + kSpan - 1) / kSpan;
  int span_it = 0, span_base = 0, span_n = 0, cursor = 0;
  float acc[128];

  for (;;) {
    // ---- the next tile of this warpgroup that has a live slot ----
    bool have = false;
    int first = 0, n_take = 0, nrows = 0;
    for (;;) {
      if (cursor >= span_n) {
        const int span = (span_it * (int)gridDim.x + (int)blockIdx.x) * 2 + wg;
        ++span_it;
        if (span >= n_spans) break;
        span_base = span * kSpan;
        span_n = min(kSpan, M - span_base);
        cursor = 0;
        wg_bar(wg);
        if (t < span_n) {
          bool live;
          const unsigned b = p.load_slot(span_base + t, K, T.wkv[t], live);
          T.bits[t] = (unsigned char)b;
          T.live[t] = live;
          T.cnt[t] = __popc(b);
        }
        wg_bar(wg);
      }
      int c, row0;
      form_tile(T.cnt, span_n, cursor, lane, n_take, nrows, c, row0);
      first = cursor;
      cursor += n_take;
      if (ww == 0 && lane < n_take) {
        T.slot_row0[lane] = row0;
        T.slot_cnt[lane] = c;
        const int m = span_base + first + lane;
        unsigned rest = T.bits[first + lane];
        for (int r = row0; rest; ++r) {
          const int k = __ffs(rest) - 1;
          rest &= rest - 1;
          T.row_src[r] = m * K + k;
          T.row_wk[r] = T.wkv[first + lane][k];
        }
      }
      for (int i = ww; i < n_take; i += 4)
        p.no_row(span_base + first + i, T.bits[first + i], K, nrows, lane);
      if (__ballot_sync(0xffffffffu,
                        lane < n_take && T.live[first + lane] != 0)) {
        have = true;
        break;
      }
    }
    if (t == 0) sm.have[wg] = have;
    consumers_bar();
    const int go = __shfl_sync(0xffffffffu, sm.have[0] | sm.have[1] << 1, 0);
    if (go == 0) break;
    if (!((go >> wg) & 1)) {
      ring_c.drain(kTowerSeq, lane);
      continue;
    }

    // ---- layer-1 input rows and colour/dirdot columns ----
    feature_rows(A, T, nrows, p.emb, p.dists, p.cd, ww, lane);
    wg_bar(wg);

    // ---- the four layers and the density dot ----
    layer_mma<kStages, 2, 0>(acc, ring_c, a_base, lane);
    hidden_epilogue<P::kRoundBias>(acc, F + kB1, A, wg, ww, lane);
    layer_mma<kStages, 0, 0>(acc, ring_c, a_base, lane);
    hidden_epilogue<P::kRoundBias>(acc, F + kB2, A, wg, ww, lane);
    layer_mma<kStages, 1, 64>(acc, ring_c, a_base, lane);
    hidden_epilogue<P::kRoundBias>(acc, F + kB3, A, wg, ww, lane);
    layer_mma<kStages, 0, 0>(acc, ring_c, a_base, lane);
    activate<P::kRoundBias>(acc, F + kB4, lane);
    float d0, d1;
    density_dot(acc, F + kWD, lane, d0, d1);
    p.finish(acc, d0, d1, F, T, A, span_base + first, n_take, nrows, wg, ww,
             lane);
  }
  block_end(sm, ring_c);
}

}  // namespace tower
