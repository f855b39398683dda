// Per-row ids of the first BP valid (>= 0) entries of qs [R, D].
//
// Replaces the Pallas kernel pointnerf2studio_tpu/ops/select.py::_kernel
// (first_valid_cols). On the TPU the prefix rank of the valid columns is
// one bf16 upper-triangular matmul on the MXU plus BP masked lane
// reductions. On Hopper the same question is a warp's bit count: one
// warp owns one row and walks it in 32-column tiles; __ballot_sync marks
// the valid lanes of a tile, __popc of the ballot under the lane mask
// gives each valid lane its exact integer rank, and the lane whose rank
// is below BP writes its column id to that slot. The counts are integers
// throughout, so no rank can round.
//
// Bound: device-memory bytes. Each row is read once (D int32) and BP + 1
// int32 are written; there is no arithmetic to speak of. The reads of a
// tile are 128 contiguous bytes per warp, so loads coalesce fully.
//
// Outputs: col_sel [R, BP] int32 — the (b+1)-th valid column id in
// ascending order for b < count, D in the slots past the count; cnt [R]
// int32 — the raw per-row valid count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void first_valid_cols_kernel(const int32_t* __restrict__ qs,
                                        int32_t* __restrict__ col_sel,
                                        int32_t* __restrict__ cnt, int R,
                                        int D, int BP) {
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
  first_valid_cols_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)qs, (int32_t*)col_sel, (int32_t*)cnt, R, D, BP);
  return (int)cudaGetLastError();
}
