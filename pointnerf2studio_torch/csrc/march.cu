// Distance-field ray march: one stage of the walk, one thread a ray.
//
// Counterpart of pointnerf2studio_tpu/ops/march.py::march_rays, which is
// no Pallas kernel on the TPU but a lax.fori_loop of array ops over
// packed ray buckets. As a Python loop of torch ops that would be
// sum(march_steps) iterations of some forty small launches a chunk, so on
// the card the data-dependent loop lives in a kernel: a thread walks its
// ray for up to T iterations and returns as soon as the ray is done. The
// staged packing by top_k, which on the TPU shrinks the ray set, is not
// needed for that; but the stages decide the result (a ray that does not
// fit the next bucket sits the stage out, a ray runs out of fuel after
// sum(steps) iterations), so the wrapper launches once per stage and
// hands later stages each ray's rank among the still-active rays (an
// ordered prefix count by ray id): the first RS of them walk.
//
// Per iteration: one 4-byte gather from the packed table
// (qslot + 1) << 5 | min(c, 31), one 4-byte store into the ray's emit row
// when the voxel is occupied, and the skip arithmetic. Bound: the gathers'
// 32-byte sectors (the table mostly fits the L2, so they come from there
// after the first touch) plus the ray and state bytes; the loop is
// latency-bound on the dependent gather -> skip -> next position chain,
// and rays of one warp end at different iterations.
//
// Rounding. fast_render_rays recomputes every emitted sample's position,
// voxel and centre with separately rounded torch ops, and the plain
// version (march_rays_reference) and the host planner (simulate_march)
// do the same arithmetic. So this file is built with -fmad=false and
// without fast math: every +, -, *, / and sqrt below rounds once, IEEE,
// in the reference's order of operations. A contracted campos + rd * t
// would put a sample on a voxel face into the other voxel.
//
// float -> int casts go through clamp_i32: the plain version clamps to
// +-2^30 in float before it casts (a ray nearly parallel to a slab has
// t_enter around 1e9 and more), and the cast here must see the same value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kI32Safe = 1073741824.0f;  // 2^30

__device__ __forceinline__ int clamp_i32(float x) {
  return (int)fminf(fmaxf(x, -kI32Safe), kI32Safe);
}

// geom: ranges_min[3], scaled_vsize[3], campos[3], near, far, step_t
__global__ void __launch_bounds__(kThreads)
march_stage_kernel(const int32_t* __restrict__ table,
                   const int32_t* __restrict__ dims,
                   const float* __restrict__ geom,
                   const float* __restrict__ raydirs,
                   const float* __restrict__ t_tab, int R, int gy, int gz,
                   int D, int cap, int T, int first, float jfac, float jlow,
                   float hj, const uint8_t* __restrict__ live,
                   const int32_t* __restrict__ rank, int RS,
                   int32_t* __restrict__ d_io,
                   int32_t* __restrict__ k_io, uint8_t* __restrict__ done_io,
                   int32_t* __restrict__ emit, int32_t* __restrict__ used) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  // later stages: a finished ray returns; so does an active one past the
  // bucket (rank counts the active rays up to and including this one)
  if (!first && (done_io[r] || (rank != nullptr && rank[r] > RS))) return;

  const float rmin[3] = {geom[0], geom[1], geom[2]};
  const float svs[3] = {geom[3], geom[4], geom[5]};
  const float cam[3] = {geom[6], geom[7], geom[8]};
  const float near = geom[9], far = geom[10], step_t = geom[11];
  const int gdim[3] = {dims[0], dims[1], dims[2]};
  const float rd[3] = {raydirs[3 * (int64_t)r], raydirs[3 * (int64_t)r + 1],
                       raydirs[3 * (int64_t)r + 2]};
  const bool jittered = t_tab != nullptr;

  // slab test: the float math of the depth-window front-end
  float t_enter = -INFINITY, t_exit = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float rmax = rmin[a] + (float)gdim[a] * svs[a];
    const float safe =
        fabsf(rd[a]) < 1e-9f ? (rd[a] >= 0.0f ? 1e-9f : -1e-9f) : rd[a];
    const float inv = 1.0f / safe;
    const float ta = (rmin[a] - cam[a]) * inv;
    const float tb = (rmax - cam[a]) * inv;
    t_enter = fmaxf(t_enter, fminf(ta, tb));
    t_exit = fminf(t_exit, fmaxf(ta, tb));
  }
  const float far_c = jittered ? far + hj * (far - near) : far;
  int d_lo, d_hi;
  if (!jittered) {
    d_lo = clamp_i32(floorf((t_enter - near) / step_t - 0.5f));
    d_hi = clamp_i32(ceilf((fminf(t_exit, far) - near) / step_t - 0.5f));
  } else {
    d_lo = clamp_i32(floorf((t_enter - near) / (step_t * jfac) - 0.5f));
    d_hi = clamp_i32(ceilf(
        (fminf(t_exit, far_c) + step_t - near) / (step_t * jlow) - 0.5f));
  }
  d_hi = min(d_hi, D - 1);
  const float t_stop = fminf(t_exit, far_c) + step_t;
  const float stepw =
      step_t * sqrtf(rd[0] * rd[0] + rd[1] * rd[1] + rd[2] * rd[2]);
  const float s_min = fminf(svs[0], fminf(svs[1], svs[2]));
  const float B = stepw * jfac;

  int d, k;
  bool done;
  if (first) {
    d = min(max(d_lo, 0), D - 1);
    k = 0;
    done = !((t_exit >= t_enter) && (d_hi >= 0)) || (d > d_hi) ||
           (live != nullptr && !live[r]);
  } else {
    d = d_io[r];
    k = k_io[r];
    done = false;
  }

  int32_t* row = emit + (int64_t)r * cap;
  int it = 0;
  for (; it < T && !done; ++it) {
    const int64_t ti = (int64_t)r * D + d, t_last = (int64_t)R * D - 1;
    const float t = jittered ? t_tab[ti < t_last ? ti : t_last]
                             : near + ((float)d + 0.5f) * step_t;
    int gc[3];
    bool inb = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = cam[a] + rd[a] * t;
      gc[a] = (int)floorf((pos - rmin[a]) / svs[a]);
      inb = inb && gc[a] >= 0 && gc[a] < gdim[a];
    }
    const int qsd = inb ? table[((int64_t)gc[0] * gy + gc[1]) * gz + gc[2]] : 0;
    const int qs1 = qsd >> 5;
    const bool occ = qs1 > 0;
    if (occ) row[k++] = (qs1 << 9) | min(d, 511);
    // the largest q with q * B < A: an IEEE division seed and a
    // multiply-only fix-up, as the plain version and the planner have it
    const int cfree = inb ? (qsd & 31) : 1;
    int skip = 1;
    if (!occ && cfree > 1) {
      const float A = (float)(cfree - 1) * s_min;
      int q1 = clamp_i32(floorf(A / B - 1e-4f));
      q1 += (float)(q1 + 1) * B < A;
      q1 += (float)(q1 + 1) * B < A;
      q1 -= (float)q1 * B >= A;
      q1 -= (float)q1 * B >= A;
      skip = max(1, q1);
    }
    d += skip;
    done = (d > d_hi) || (k >= cap) || (jittered && t > t_stop);
  }
  d_io[r] = d;
  k_io[r] = k;
  done_io[r] = done;
  if (used != nullptr) used[r] += it;
}

}  // namespace

extern "C" int march_stage(const void* table, const void* dims,
                           const void* geom, const void* raydirs,
                           const void* t_tab, int R, int gy, int gz, int D,
                           int cap, int T, int first, float jfac, float jlow,
                           float hj, const void* live, const void* rank,
                           int RS, void* d, void* k, void* done, void* emit,
                           void* used, void* stream) {
  if (R <= 0) return 0;
  march_stage_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)dims, (const float*)geom,
      (const float*)raydirs, (const float*)t_tab, R, gy, gz, D, cap, T, first,
      jfac, jlow, hj, (const uint8_t*)live, (const int32_t*)rank, RS,
      (int32_t*)d, (int32_t*)k, (uint8_t*)done, (int32_t*)emit,
      (int32_t*)used);
  return (int)cudaGetLastError();
}
