// The whole post-gather chunk of the fast render path at every width of
// the port's envelope that csrc/fused_chunk.cu is not built for: K <= 32
// neighbours of C <= 256 candidates, hidden H <= 512, a colour tower of
// 1-8 layers of width HC <= 512, PE octaves 1-10 for the embedding, the
// dists and the view direction (32 features and 6 dists, as the
// reference's gate fixes them). Output per slot: (sigma, rgb, found).
//
// Replaces the Pallas kernel pointnerf2studio_tpu/ops/fused_chunk.py::
// _kernel (fused_chunk_decode) at those widths. One entry point launches
// three kernels back to back, as csrc/fused_chunk.cu does:
//   * chunk_select_kernel<G> (csrc/chunk_select.cuh): selection, extract,
//     weights and geometry, G = 8, 16 or 32 lanes a slot by C and K, into
//     the scratch buffer (120 bytes a valid pair, 2 round8(H) + 13 a slot);
//   * tower_any_kernel (csrc/tower_any.cuh) on the valid pairs: sigma,
//     found and the K-sums, a bf16 row of H per slot;
//   * colour_any_kernel (csrc/tower_any.cuh) on the slots, 64 a tile.
// What bounds it on Hopper: tensor-core operations (the tower and the
// colour tower), under them the selection's bytes; tower_any.cuh says how
// the generic towers go about it. The rounding points are the reference's
// fused chunk's: (bf16(acc) + bf16(bias)) rounded to bf16, LeakyReLU(0.1)
// in f32, alpha*w and h*w summed over K in f32 in k order,
// sigmoid*(1+2e-3)-1e-3. Compiled with -fmad=false: the selection's
// geometry must equal the plain version's bit for bit.
// Weights: the tower's packed layout (tower_any.cuh) with the biases
// rounded to bf16, then the colour tower's, made by ops/fused_chunk.py::
// _kernel_params_any.

#include "chunk_select.cuh"
#include "tower_any.cuh"

using namespace tany;

namespace {

constexpr int kC = chunksel::kChunkC, kD = chunksel::kChunkD;

// the colour-tower input row of the scratch: H bf16, padded to 8
int row_width(int H) { return (H + 7) / 8 * 8; }

bool widths_ok(int C, int K, int H, int HC, int layers, int nff, int ndf,
               int nvf) {
  return C >= 1 && C <= 256 && K >= 1 && K <= 32 &&
         tower_widths_ok(kC, kD, H, nff, ndf, K) && HC >= 1 && HC <= 512 &&
         layers >= 1 && layers <= 8 && nvf >= 1 && nvf <= 10;
}

template <int G>
cudaError_t run_select(const void* kmeta, const void* kcand, const void* kxyz,
                   const void* qslot, const void* locs, const void* center,
                   const void* rd, const void* mask, const void* consts,
                   const chunksel::Scratch& s, void* sig, void* rgb,
                   void* found, int M, int C, int K, float radius2,
                   int num_shells, cudaStream_t stream) {
  const int per_block = chunksel::kSelectThreads / G;
  chunksel::chunk_select_kernel<G>
      <<<(M + per_block - 1) / per_block, chunksel::kSelectThreads, 0,
         stream>>>((const int32_t*)kmeta, (const bf16*)kcand,
                   (const bf16*)kxyz, (const int32_t*)qslot,
                   (const float*)locs, (const float*)center, (const float*)rd,
                   (const uint8_t*)mask, (const float*)consts, s, (float*)sig,
                   (float*)rgb, (uint8_t*)found, M, C, K, radius2, num_shells);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long chunk_any_n_weights(int H, int HC, int layers, int nff,
                                         int ndf, int nvf) {
  return tower_weights(kC, kD, H, nff, ndf) +
         colour_weights(H, HC, layers, nvf);
}
extern "C" int chunk_any_n_params(int H, int HC, int layers) {
  return tower_params(H) + colour_params(HC, layers);
}
// bytes of scratch the entry point needs for M slots of K neighbours
extern "C" long long chunk_any_scratch_bytes(int M, int K, int H) {
  return (long long)M * K * chunksel::kPairBytes +
         (long long)M * chunksel::slot_bytes(row_width(H));
}

extern "C" int fused_chunk_decode_any(
    const void* kmeta, const void* kcand, const void* kxyz, const void* qslot,
    const void* locs, const void* center, const void* rd, const void* mask,
    const void* consts, const void* weights, const void* params,
    void* scratch, void* sig, void* rgb, void* found, int M, int C, int K,
    float radius2, int num_shells, int act_super, int H, int HC, int layers,
    int nff, int ndf, int nvf, void* stream) {
  if (!widths_ok(C, K, H, HC, layers, nff, ndf, nvf))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int hs = row_width(H);
  const chunksel::Scratch s = chunksel::carve(scratch, M, K, hs);
  cudaError_t err;
  if (C <= 64 && K <= 8)
    err = run_select<8>(kmeta, kcand, kxyz, qslot, locs, center, rd, mask, consts,
                    s, sig, rgb, found, M, C, K, radius2, num_shells, st);
  else if (C <= 128 && K <= 16)
    err = run_select<16>(kmeta, kcand, kxyz, qslot, locs, center, rd, mask,
                     consts, s, sig, rgb, found, M, C, K, radius2, num_shells,
                     st);
  else
    err = run_select<32>(kmeta, kcand, kxyz, qslot, locs, center, rd, mask,
                     consts, s, sig, rgb, found, M, C, K, radius2, num_shells,
                     st);
  if (err != cudaSuccess) return (int)err;

  TowerArgs t = {};
  t.emb = s.emb;
  t.dists = s.dists;
  t.cd = s.cd;
  t.wk = s.wk;
  t.nk = s.nk;
  t.w = (const bf16*)weights;
  t.f = (const float*)params;
  t.aw = (float*)sig;
  t.hw = s.hw;
  t.found = (unsigned char*)found;
  t.M = M;
  t.K = K;
  t.C = kC;
  t.D = kD;
  t.H = H;
  t.nff = nff;
  t.ndf = ndf;
  t.hs = hs;
  t.act_super = act_super;
  if ((err = launch_tower<kChunk>(t, st)) != cudaSuccess) return (int)err;

  ColourArgs c = {};
  c.hw = s.hw;
  c.vd = s.vd;
  c.nk = s.nk;
  c.w = (const bf16*)weights + tower_weights(kC, kD, H, nff, ndf);
  c.f = (const float*)params + tower_params(H);
  c.rgb = (float*)rgb;
  c.M = M;
  c.H = H;
  c.hs = hs;
  c.nvf = nvf;
  c.HC = HC;
  c.layers = layers;
  return (int)launch_colour(c, st);
}
