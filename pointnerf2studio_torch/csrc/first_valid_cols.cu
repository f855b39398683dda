// Per-row ids of the first BP valid (>= 0) entries of qs [R, D].
//
// Replaces the Pallas kernel pointnerf2studio_tpu/ops/select.py::_kernel
// (first_valid_cols). On the TPU the prefix rank of the valid columns is
// one bf16 upper-triangular matmul on the MXU plus BP masked lane
// reductions. On Hopper the same question is a warp's bit count, in
// integers throughout, so no rank can round.
//
// Bound: device-memory bytes. Each row is read once (D int32) and BP + 1
// int32 are written; there is no arithmetic to speak of, so the design is
// about keeping bytes in flight and stores whole:
//   * one warp owns one row. A lane loads an int4, four consecutive
//     columns, so one load of the warp covers 128 columns (512 bytes),
//     and the loads of up to four such tiles are all started before the
//     first ballot looks at any of them (D = 192: two loads in flight
//     where a walk in 32-column tiles had six, one after another);
//   * rank: four ballots, one per column of the lane's int4. The columns
//     are lane-major, so a valid column's rank is the number of valid
//     columns in the lanes below (the ballots' bits under the lane mask)
//     plus those before it in the lane's own four;
//   * stores: a valid column of rank < BP goes to the warp's row in
//     shared memory; then the warp writes the BP ids, the D fill past the
//     count included, 32 consecutive ints a store: whole 128-byte lines
//     where the row starts on one, not scattered 4-byte stores.
// A row that does not start on a 16-byte boundary (D no multiple of 4, or
// a qs pointer that is not aligned), or a BP whose rows do not fit the
// block's shared memory, takes the scalar kernel: 32-column tiles, one
// ballot each, direct stores.
//
// Outputs: col_sel [R, BP] int32 — the (b+1)-th valid column id in
// ascending order for b < count, D in the slots past the count; cnt [R]
// int32 — the raw per-row valid count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTiles = 4;           // 128-column tiles loaded before any rank
constexpr int kMaxSharedBP = 1024;  // 8 rows of 4 KB: inside the 48 KB default

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
first_valid_cols_kernel(const int32_t* __restrict__ qs,
                        int32_t* __restrict__ col_sel,
                        int32_t* __restrict__ cnt, int R, int D, int BP) {
  extern __shared__ int32_t srows[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= R) return;  // whole warps exit together; no block barrier below
  const int4* q = (const int4*)(qs + (int64_t)row * D);
  int32_t* srow = srows + warp * BP;
  const unsigned lt_mask = (1u << lane) - 1u;
  int seen = 0;  // valid columns before this tile
  for (int base = 0; base < D; base += kTiles * 128) {
    int4 v[kTiles];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const int col = base + t * 128 + lane * 4;
      v[t] = make_int4(-1, -1, -1, -1);
      if (col < D) v[t] = q[col >> 2];   // D is a multiple of 4
    }
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const int col = base + t * 128 + lane * 4;
      if (base + t * 128 >= D) break;    // warp-uniform
      const bool ok[4] = {v[t].x >= 0, v[t].y >= 0, v[t].z >= 0,
                          v[t].w >= 0};
      int below = 0, total = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned bal = __ballot_sync(0xffffffffu, ok[i]);
        below += __popc(bal & lt_mask);
        total += __popc(bal);
      }
      int rank = seen + below;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ok[i] && rank < BP) srow[rank] = col + i;
        rank += ok[i];
      }
      seen += total;
    }
  }
  __syncwarp();
  int32_t* out = col_sel + (int64_t)row * BP;
  const int n = min(seen, BP);
  for (int b = lane; b < BP; b += 32) out[b] = b < n ? srow[b] : D;
  if (lane == 0) cnt[row] = seen;
}

__global__ void first_valid_cols_scalar_kernel(
    const int32_t* __restrict__ qs, int32_t* __restrict__ col_sel,
    int32_t* __restrict__ cnt, int R, int D, int BP) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warps exit together
  const int32_t* q = qs + (int64_t)row * D;
  int32_t* out = col_sel + (int64_t)row * BP;
  const unsigned lt_mask = (1u << lane) - 1u;
  int seen = 0;  // valid columns in the tiles before this one
  for (int base = 0; base < D; base += 32) {
    const int col = base + lane;
    const bool ok = col < D && q[col] >= 0;
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    const int rank = seen + __popc(bal & lt_mask);
    if (ok && rank < BP) out[rank] = col;
    seen += __popc(bal);
  }
  for (int b = min(seen, BP) + lane; b < BP; b += 32) out[b] = D;
  if (lane == 0) cnt[row] = seen;
}

}  // namespace

extern "C" int first_valid_cols(const void* qs, void* col_sel, void* cnt,
                                int R, int D, int BP, void* stream) {
  if (R <= 0) return 0;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec = D % 4 == 0 && (uintptr_t)qs % 16 == 0 &&
                   BP <= kMaxSharedBP;
  if (vec)
    first_valid_cols_kernel<<<blocks, kWarpsPerBlock * 32,
                              kWarpsPerBlock * BP * sizeof(int32_t),
                              (cudaStream_t)stream>>>(
        (const int32_t*)qs, (int32_t*)col_sel, (int32_t*)cnt, R, D, BP);
  else
    first_valid_cols_scalar_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                     (cudaStream_t)stream>>>(
        (const int32_t*)qs, (int32_t*)col_sel, (int32_t*)cnt, R, D, BP);
  return (int)cudaGetLastError();
}
