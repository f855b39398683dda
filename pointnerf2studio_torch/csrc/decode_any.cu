// The per-neighbour tower of the radiance decoder at every width of the
// port's envelope that csrc/fused_decode.cu is not built for, with the same
// two entry points and outputs:
//   fused_decode_any   - per (slot, k) row: aw = alpha * wk (f32) and
//                        hw = bf16(bf16(h) * wk), rows with wk == 0 zero;
//   fused_decode2_any  - per slot: sum_k alpha * wk and sum_k h * wk, h in
//                        f32 after layer 4, summed in f32 in k order.
// Replaces the Pallas kernels pointnerf2studio_tpu/ops/fused_decode.py::
// _pair_kernel and ::_kacc_kernel at those widths: any embedding width
// C <= 64, dists D <= 8 (3, 4 or 6 from agg_dist_pers), hidden H <= 512,
// PE octaves 1-10 for the embedding and the dists, K <= 32. csrc/
// fused_decode.cu keeps the flagship widths (32, 6, 256, octaves 3 / 5,
// K <= 8).
//
// What bounds it on Hopper: tensor-core operations. Both entry points run
// the warp-specialised wgmma tower of csrc/tower_wg.cuh (weights packed
// by ops/fused_decode.py::pack_tower_wg), fused_decode_any in its mode
// kPair, fused_decode2_any in kKacc; the header says how. Compiled with
// -fmad=false so that acc + bias, 0.1 * x and h * wk round as the plain
// version's separate operations do.

#include "tower_wg.cuh"

using namespace twg;

// bf16 elements of the packed weights and f32 parameters (either entry
// point's)
extern "C" long long decode_any_n_weights(int C, int D, int H, int nff,
                                          int ndf) {
  return tower_weights(C, D, H, nff, ndf);
}
extern "C" int decode_any_n_params(int H) { return tower_params(H); }

namespace {

template <int MODE>
int run(const void* emb, const void* dists, const void* cd, const void* wk,
        const void* weights, const void* params, void* aw, void* hw, int M,
        int K, int C, int D, int H, int nff, int ndf, void* stream) {
  if (!widths_ok(C, D, H, nff, ndf, K)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.emb = (const bf16*)emb;
  a.dists = (const float*)dists;
  a.cd = (const float*)cd;
  a.wk = (const float*)wk;
  a.w = (const bf16*)weights;
  a.f = (const float*)params;
  a.aw = (float*)aw;
  a.hw = hw;
  a.M = M;
  a.K = K;
  a.C = C;
  a.D = D;
  a.H = H;
  a.nff = nff;
  a.ndf = ndf;
  a.vw = pair_vw(H, hw);
  return (int)launch<MODE>(a, (cudaStream_t)stream);
}

}  // namespace

// emb bf16 [M, K, C], dists f32 [M, K, D], cd f32 [M, K, 7], wk f32
// [M, K] -> aw f32 [M, K], hw bf16 [M, K, H]
extern "C" int fused_decode_any(const void* emb, const void* dists,
                                const void* cd, const void* wk,
                                const void* weights, const void* params,
                                void* aw, void* hw, int M, int K, int C, int D,
                                int H, int nff, int ndf, void* stream) {
  return run<kPair>(emb, dists, cd, wk, weights, params, aw, hw, M, K, C, D,
                    H, nff, ndf, stream);
}

// same inputs -> aw f32 [M], hw f32 [M, H], summed over k in k order
extern "C" int fused_decode2_any(const void* emb, const void* dists,
                                 const void* cd, const void* wk,
                                 const void* weights, const void* params,
                                 void* aw, void* hw, int M, int K, int C, int D,
                                 int H, int nff, int ndf, void* stream) {
  return run<kKacc>(emb, dists, cd, wk, weights, params, aw, hw, M, K, C, D,
                    H, nff, ndf, stream);
}
