// The joint step's plane-sweep cost volume, forward and backward.
//
// Replaces no Pallas kernel: the JAX package builds the volume from array
// ops (pointnerf2studio_tpu/models/mvsnet/costvol.py::build_cost_volume).
// The port did the same in torch until this source: four advanced-index
// taps a source view (models/mvsnet/layers.py::bilinear_grid_sample), each
// a [D, Hp, Wp, 35] tensor, then the variance and a concatenation; and
// autograd sent every tap's gradient through a sorted index_put_
// accumulate that adds each source pixel's ~128 duplicates in series.
//
// vol[d, py, px, :] = [ref rgb, the warped rgb of each source view in
// ascending order, the variance over the views whose sample lies in
// (-1, 1)^2 of the ref and warped source features], Ct = 3V + 32 channels,
// channel-last. The sample coordinates gx, gy [D, Hp, Wp] of each source
// view come from the caller (models/mvsnet/costvol.py::_sweep_grid).
//
// Forward (costvol_forward_kernel). Bound: device-memory bytes, the volume
// written once and the maps read once (0.857 GB at the joint cell's 128
// planes of 200x200, 0.256 ms at 3.35 TB/s); the coordinates add 82 MB.
// Eight lanes a (plane, padded pixel), four feature channels each, so that
// a warp's load of a tap reads four whole 128-byte rows: each lane reads
// the ref pixel and the four taps of each source view from the maps
// (15 MB: they stay in the L2), keeps its channels' sum and sum of squares
// in registers and writes its variance channels, lanes 0-2 the colours, to
// shared memory; the block then stores its 32 rows as one contiguous run
// of float4s. No tap tensor, no partial sum and no concatenation reaches
// device memory. Built with -fmad=false, every operation is the
// composite's, in its order (the weights (1 - wx) * (1 - wy) ..., the taps
// summed 00 + 10 + 01 + 11, the sums from the ref view then the sources
// ascending, x ** 2 as x * x, cnt = 1 / in_cnt, then sq * cnt -
// (sum * cnt)^2), so the volume equals the composite's bit for bit and the
// depth draw downstream does not move.
//
// Backward (costvol_backward: three kernels, to the features only; the
// images and coordinates carry no gradient in the joint step). Only the
// variance channels reach the features:
//   g_wf_s = g * (2 cnt) * (wf_s - mean),  g_ref = g * (2 cnt) * (ref - mean)
// with wf_s, mean recomputed from the coordinates. No float atomics: each
// gradient is a sum in a fixed order, the same bits on every run.
//   1. costvol_bins_kernel, one block a (source view, plane): a counting
//      sort of the plane's padded pixels by the cell (x0, y0) of their
//      first tap, floored exactly as the forward floors it; cells
//      x0 in [-1, w-1], y0 in [-1, h-1], the only ones with a tap in the
//      image. The counts are integer atomics; the placement walks the
//      pixels in raster order a tile at a time, ranking equal cells within
//      the tile, so each cell lists its pixels ascending. Whatever the
//      geometry (an epipole in the frame, a plane behind the source
//      camera) every pixel lands in exactly the cell its taps name.
//   2. costvol_gwf_kernel, eight lanes a padded pixel (four channels
//      each), walking the planes: recomputes the samples and the mean,
//      writes g_wf_s [S, D, Hp*Wp, 32] and sums g_ref over the planes in
//      ascending order into the ref view's gradient.
//   3. costvol_gather_kernel, eight lanes a source pixel: tap 00 of the
//      cell (sx, sy), tap 10 of (sx-1, sy), tap 01 of (sx, sy-1) and tap
//      11 of (sx-1, sy-1) reach it, so it merges those four lists plane by
//      plane (planes ascending, candidates in raster order; a pixel lies
//      in one cell, so no two lists share one), recomputing each
//      candidate's weight from its coordinates, and writes its gradient
//      once.
// Bound: the gradient's 32 variance channels read once, the features read
// and their gradient written once (0.685 GB, 0.205 ms); g_wf's 1.31 GB are
// written and read again on top.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;               // feature channels (the FPN's)
constexpr int kQuads = kC / 4;       // float4s a feature row
constexpr int kMaxSrc = 7;           // source views (V <= 8)
constexpr int kBinThreads = 128;     // placement tile of the counting sort
constexpr int kPix = 32;             // pixels a block, 8 lanes each
constexpr int kNone = 0x7fffffff;

struct Grids {
  const float* gx[kMaxSrc];
  const float* gy[kMaxSrc];
};

// The composite's sample position: fx = (gx + 1) * 0.5 * (w - 1), its
// floor and fraction.
__device__ __forceinline__ void sample_at(float gx, float gy, int h, int w,
                                          float& x0, float& y0, float& wx,
                                          float& wy) {
  const float fx = ((gx + 1.0f) * 0.5f) * (float)(w - 1);
  const float fy = ((gy + 1.0f) * 0.5f) * (float)(h - 1);
  x0 = floorf(fx);
  y0 = floorf(fy);
  wx = fx - x0;
  wy = fy - y0;
}

__device__ __forceinline__ bool in_frame(float gx, float gy) {
  return gx > -1.0f && gx < 1.0f && gy > -1.0f && gy < 1.0f;
}

// Taps 00, 10, 01, 11: the clamped pixel, 1 or 0 for inside the image,
// and the weight, each rounded as the composite rounds it.
struct Taps {
  int o[4];
  float m[4];
  float wt[4];
};

__device__ __forceinline__ Taps make_taps(float gx, float gy, int h, int w) {
  float x0, y0, wx, wy;
  sample_at(gx, gy, h, w, x0, y0, wx, wy);
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float fw = (float)w, fh = (float)h;
  const bool ix0 = x0 >= 0.0f && x0 < fw, ix1 = x1 >= 0.0f && x1 < fw;
  const bool iy0 = y0 >= 0.0f && y0 < fh, iy1 = y1 >= 0.0f && y1 < fh;
  const int cx0 = (int)fminf(fmaxf(x0, 0.0f), fw - 1.0f);
  const int cx1 = (int)fminf(fmaxf(x1, 0.0f), fw - 1.0f);
  const int cy0 = (int)fminf(fmaxf(y0, 0.0f), fh - 1.0f);
  const int cy1 = (int)fminf(fmaxf(y1, 0.0f), fh - 1.0f);
  const float ax = 1.0f - wx, ay = 1.0f - wy;
  Taps t;
  t.o[0] = cy0 * w + cx0;
  t.o[1] = cy0 * w + cx1;
  t.o[2] = cy1 * w + cx0;
  t.o[3] = cy1 * w + cx1;
  t.m[0] = (ix0 && iy0) ? 1.0f : 0.0f;
  t.m[1] = (ix1 && iy0) ? 1.0f : 0.0f;
  t.m[2] = (ix0 && iy1) ? 1.0f : 0.0f;
  t.m[3] = (ix1 && iy1) ? 1.0f : 0.0f;
  t.wt[0] = ax * ay;
  t.wt[1] = wx * ay;
  t.wt[2] = ax * wy;
  t.wt[3] = wx * wy;
  return t;
}

// tap(v) * mask * weight, summed 00 + 10 + 01 + 11 left to right
__device__ __forceinline__ float lerp4(const Taps& t, float a0, float a1,
                                       float a2, float a3) {
  return (a0 * t.m[0]) * t.wt[0] + (a1 * t.m[1]) * t.wt[1]
         + (a2 * t.m[2]) * t.wt[2] + (a3 * t.m[3]) * t.wt[3];
}

__device__ __forceinline__ float4 lerp4(const Taps& t, float4 a0, float4 a1,
                                        float4 a2, float4 a3) {
  return make_float4(lerp4(t, a0.x, a1.x, a2.x, a3.x),
                     lerp4(t, a0.y, a1.y, a2.y, a3.y),
                     lerp4(t, a0.z, a1.z, a2.z, a3.z),
                     lerp4(t, a0.w, a1.w, a2.w, a3.w));
}

// The cell (x0, y0) of a sample's first tap as an index into the
// (h + 1) x (w + 1) cells that have a tap in the image; -1 for none.
__device__ __forceinline__ int cell_of(float gx, float gy, int h, int w) {
  float x0, y0, wx, wy;
  sample_at(gx, gy, h, w, x0, y0, wx, wy);
  if (!(x0 >= -1.0f && x0 <= (float)(w - 1) && y0 >= -1.0f
        && y0 <= (float)(h - 1)))
    return -1;
  return ((int)y0 + 1) * (w + 1) + (int)x0 + 1;
}

__device__ __forceinline__ int source_view(int s, int vid) {
  return s < vid ? s : s + 1;
}

// g.gx[s], g.gy[s] for a run-time s. Every index into the parameter
// array is a constant: one indexed at run time makes each thread copy the
// whole array to local memory first.
__device__ __forceinline__ void grid_of(const Grids& g, int s,
                                        const float*& gx, const float*& gy) {
  gx = g.gx[0];
  gy = g.gy[0];
#pragma unroll
  for (int i = 1; i < kMaxSrc; ++i) {
    if (i == s) {
      gx = g.gx[i];
      gy = g.gy[i];
    }
  }
}

__global__ void __launch_bounds__(kPix * kQuads)
costvol_forward_kernel(const float* __restrict__ feats,
                       const float* __restrict__ imgs, Grids g,
                       float* __restrict__ out, int V, int vid, int h, int w,
                       int pad, int Hp, int Wp, long long n) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const int S = V - 1, Ct = 3 * V + kC, Np = Hp * Wp;
  const int q = threadIdx.x & (kQuads - 1), i = threadIdx.x / kQuads;
  const long long e0 = (long long)blockIdx.x * kPix, e = e0 + i;
  if (e < n) {
    float* row = stage + i * Ct;
    const int p = (int)(e % Np);
    const int y = p / Wp - pad, x = p % Wp - pad;
    const bool inside = y >= 0 && y < h && x >= 0 && x < w;
    const long long r = ((long long)vid * h + y) * w + x;
    float4 sum = inside ? reinterpret_cast<const float4*>(feats + r * kC)[q]
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 sq = make_float4(sum.x * sum.x, sum.y * sum.y, sum.z * sum.z,
                            sum.w * sum.w);
    if (q < 3) row[q] = inside ? imgs[r * 3 + q] : 0.0f;
    float count = 1.0f;
#pragma unroll
    for (int s = 0; s < kMaxSrc; ++s) {
      if (s >= S) break;
      const int v = source_view(s, vid);
      const float gx = g.gx[s][e], gy = g.gy[s][e];
      const Taps t = make_taps(gx, gy, h, w);
      count = count + (in_frame(gx, gy) ? 1.0f : 0.0f);
      const float4* F =
          reinterpret_cast<const float4*>(feats + (long long)v * h * w * kC);
      const float4 wf = lerp4(t, F[t.o[0] * kQuads + q],
                              F[t.o[1] * kQuads + q], F[t.o[2] * kQuads + q],
                              F[t.o[3] * kQuads + q]);
      sum = make_float4(sum.x + wf.x, sum.y + wf.y, sum.z + wf.z,
                        sum.w + wf.w);
      sq = make_float4(sq.x + wf.x * wf.x, sq.y + wf.y * wf.y,
                       sq.z + wf.z * wf.z, sq.w + wf.w * wf.w);
      if (q < 3) {
        const float* I = imgs + (long long)v * h * w * 3 + q;
        row[3 + 3 * s + q] = lerp4(t, I[t.o[0] * 3], I[t.o[1] * 3],
                                   I[t.o[2] * 3], I[t.o[3] * 3]);
      }
    }
    const float cnt = 1.0f / count;
    const float4 a = make_float4(sq.x * cnt, sq.y * cnt, sq.z * cnt,
                                 sq.w * cnt);
    const float4 b = make_float4(sum.x * cnt, sum.y * cnt, sum.z * cnt,
                                 sum.w * cnt);
    float* var = row + 3 * V + 4 * q;
    var[0] = a.x - b.x * b.x;
    var[1] = a.y - b.y * b.y;
    var[2] = a.z - b.z * b.z;
    var[3] = a.w - b.w * b.w;
  }
  __syncthreads();
  // the block's rows are one contiguous run of the volume
  const long long live = n - e0 < kPix ? n - e0 : kPix;
  float* dst = out + e0 * Ct;
  if (live == kPix) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < kPix * Ct / 4; k += kPix * kQuads)
      d4[k] = stage4[k];
  } else {
    for (long long k = threadIdx.x; k < live * Ct; k += kPix * kQuads)
      dst[k] = stage[k];
  }
}

// One block a (plane d, source view s): CSR of the plane's padded pixels
// by cell. off [K + 1] (prefix of the counts), cur [K] (scratch), ent
// [Np] (pixel ids, each cell's ascending).
__global__ void __launch_bounds__(kBinThreads)
costvol_bins_kernel(Grids g, int* __restrict__ bins, int* __restrict__ cursor,
                    int* __restrict__ entries, int h, int w, int Np, int D,
                    int K) {
  __shared__ int keys[kBinThreads];
  __shared__ int warp_sums[kBinThreads / 32];
  const int d = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const long long plane = (long long)s * D + d;
  const float *gx, *gy;
  grid_of(g, s, gx, gy);
  gx += (long long)d * Np;
  gy += (long long)d * Np;
  int* off = bins + plane * (K + 1);
  int* cur = cursor + plane * K;
  int* ent = entries + plane * Np;

  for (int k = tid; k < K; k += kBinThreads) cur[k] = 0;
  __syncthreads();
  for (int p = tid; p < Np; p += kBinThreads) {
    const int k = cell_of(gx[p], gy[p], h, w);
    if (k >= 0) atomicAdd(cur + k, 1);
  }
  __syncthreads();

  // exclusive prefix of the counts, a tile at a time
  const int lane = tid & 31, wid = tid >> 5;
  int carry = 0;
  for (int k0 = 0; k0 < K; k0 += kBinThreads) {
    const int k = k0 + tid;
    const int c = k < K ? cur[k] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_sums[wid] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kBinThreads / 32; ++i) {
      before += i < wid ? warp_sums[i] : 0;
      total += warp_sums[i];
    }
    if (k < K) off[k] = cur[k] = carry + before + incl - c;
    carry += total;
    __syncthreads();
  }
  if (tid == 0) off[K] = carry;
  __syncthreads();

  // stable placement: pixels in raster order, a tile at a time; within the
  // tile a pixel's rank among the pixels of its cell before it. The next
  // tile's coordinates load while this one is ranked.
  float nx = tid < Np ? gx[tid] : 0.0f, ny = tid < Np ? gy[tid] : 0.0f;
  for (int p0 = 0; p0 < Np; p0 += kBinThreads) {
    const int p = p0 + tid;
    const float cx = nx, cy = ny;
    if (p + kBinThreads < Np) {
      nx = gx[p + kBinThreads];
      ny = gy[p + kBinThreads];
    }
    const int k = p < Np ? cell_of(cx, cy, h, w) : -1;
    keys[tid] = k;
    __syncthreads();
    int rank = 0, same = 0, pos = 0;
    if (k >= 0) {
      for (int j = 0; j < kBinThreads; ++j) {
        const bool eq = keys[j] == k;
        rank += eq && j < tid;
        same += eq;
      }
      pos = cur[k] + rank;
    }
    __syncthreads();
    if (k >= 0) {
      ent[pos] = p;
      if (rank == same - 1) cur[k] += same;
    }
    __syncthreads();
  }
}

// Eight lanes a padded pixel, four channels each, walking the planes:
// g_wf of every source view, and the ref view's gradient summed over the
// planes in ascending order.
__global__ void __launch_bounds__(kPix * kQuads)
costvol_gwf_kernel(const float* __restrict__ G, long long sd, long long sy,
                   long long sx, long long sc,
                   const float* __restrict__ feats, Grids g,
                   float* __restrict__ gwf, float* __restrict__ gfeat, int V,
                   int vid, int h, int w, int pad, int Hp, int Wp, int D) {
  const int S = V - 1, Np = Hp * Wp;
  const int q = threadIdx.x & (kQuads - 1);
  const int p = blockIdx.x * kPix + (threadIdx.x / kQuads);
  if (p >= Np) return;
  const int py = p / Wp, px = p % Wp, y = py - pad, x = px - pad;
  const bool inside = y >= 0 && y < h && x >= 0 && x < w;
  const long long r = ((long long)vid * h + y) * w + x;
  const float4 ref =
      inside ? reinterpret_cast<const float4*>(feats + r * kC)[q]
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* gq = G + py * sy + px * sx + (3LL * V + 4 * q) * sc;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int d = 0; d < D; ++d) {
    const long long e = (long long)d * Np + p;
    const float* gd = gq + d * sd;
    const float4 gv = make_float4(gd[0], gd[sc], gd[2 * sc], gd[3 * sc]);
    float4 sum = ref, wf[kMaxSrc];
    float count = 1.0f;
#pragma unroll
    for (int s = 0; s < kMaxSrc; ++s) {
      if (s < S) {
        const float gx = g.gx[s][e], gy = g.gy[s][e];
        const Taps t = make_taps(gx, gy, h, w);
        count = count + (in_frame(gx, gy) ? 1.0f : 0.0f);
        const float4* F = reinterpret_cast<const float4*>(
            feats + (long long)source_view(s, vid) * h * w * kC);
        wf[s] = lerp4(t, F[t.o[0] * kQuads + q], F[t.o[1] * kQuads + q],
                      F[t.o[2] * kQuads + q], F[t.o[3] * kQuads + q]);
        sum = make_float4(sum.x + wf[s].x, sum.y + wf[s].y, sum.z + wf[s].z,
                          sum.w + wf[s].w);
      }
    }
    const float cnt = 1.0f / count, two = 2.0f * cnt;
    const float4 mean =
        make_float4(sum.x * cnt, sum.y * cnt, sum.z * cnt, sum.w * cnt);
    const float4 gs = make_float4(gv.x * two, gv.y * two, gv.z * two,
                                  gv.w * two);
    acc = make_float4(acc.x + gs.x * (ref.x - mean.x),
                      acc.y + gs.y * (ref.y - mean.y),
                      acc.z + gs.z * (ref.z - mean.z),
                      acc.w + gs.w * (ref.w - mean.w));
#pragma unroll
    for (int s = 0; s < kMaxSrc; ++s) {
      if (s < S)
        reinterpret_cast<float4*>(gwf + ((long long)s * D * Np + e) * kC)[q] =
            make_float4(gs.x * (wf[s].x - mean.x), gs.y * (wf[s].y - mean.y),
                        gs.z * (wf[s].z - mean.z), gs.w * (wf[s].w - mean.w));
    }
  }
  if (inside) reinterpret_cast<float4*>(gfeat + r * kC)[q] = acc;
}

// Eight lanes a source pixel of source view blockIdx.y: the four lists of
// cells whose taps reach it, merged plane by plane.
__global__ void __launch_bounds__(kPix * kQuads)
costvol_gather_kernel(const float* __restrict__ gwf, Grids g,
                      const int* __restrict__ bins,
                      const int* __restrict__ entries,
                      float* __restrict__ gfeat, int vid, int h, int w,
                      int Np, int D, int K) {
  const int s = blockIdx.y;
  const int q = threadIdx.x & (kQuads - 1);
  const int sp = blockIdx.x * kPix + (threadIdx.x / kQuads);
  if (sp >= h * w) return;
  const int sy = sp / w, sx = sp % w;
  const int k0 = (sy + 1) * (w + 1) + sx + 1;   // tap 00's cell
  const int k2 = k0 - (w + 1);                  // tap 01's cell
  const float *gxs, *gys;
  grid_of(g, s, gxs, gys);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int d = 0; d < D; ++d) {
    const long long plane = (long long)s * D + d;
    const int* off = bins + plane * (K + 1);
    const int* ent = entries + plane * Np;
    // taps 00, 10, 01, 11 come from cells k0, k0 - 1, k2, k2 - 1
    int a0 = off[k0], b0 = off[k0 + 1];
    int a1 = off[k0 - 1], b1 = a0;
    int a2 = off[k2], b2 = off[k2 + 1];
    int a3 = off[k2 - 1], b3 = a2;
    int h0 = a0 < b0 ? ent[a0] : kNone, h1 = a1 < b1 ? ent[a1] : kNone;
    int h2 = a2 < b2 ? ent[a2] : kNone, h3 = a3 < b3 ? ent[a3] : kNone;
    const float4* gw = reinterpret_cast<const float4*>(gwf + plane * Np * kC);
    for (;;) {
      const int m = min(min(h0, h1), min(h2, h3));
      if (m == kNone) break;
      const long long e = (long long)d * Np + m;
      float x0, y0, wx, wy;
      sample_at(gxs[e], gys[e], h, w, x0, y0, wx, wy);
      float wt;
      if (m == h0) {
        wt = (1.0f - wx) * (1.0f - wy);
        h0 = ++a0 < b0 ? ent[a0] : kNone;
      } else if (m == h1) {
        wt = wx * (1.0f - wy);
        h1 = ++a1 < b1 ? ent[a1] : kNone;
      } else if (m == h2) {
        wt = (1.0f - wx) * wy;
        h2 = ++a2 < b2 ? ent[a2] : kNone;
      } else {
        wt = wx * wy;
        h3 = ++a3 < b3 ? ent[a3] : kNone;
      }
      const float4 gv = gw[(long long)m * kQuads + q];
      acc = make_float4(acc.x + wt * gv.x, acc.y + wt * gv.y,
                        acc.z + wt * gv.z, acc.w + wt * gv.w);
    }
  }
  const int v = source_view(s, vid);
  reinterpret_cast<float4*>(gfeat + ((long long)v * h * w + sp) * kC)[q] =
      acc;
}

Grids grids_of(const void* const* gx, const void* const* gy, int S) {
  Grids g = {};
  for (int s = 0; s < S; ++s) {
    g.gx[s] = static_cast<const float*>(gx[s]);
    g.gy[s] = static_cast<const float*>(gy[s]);
  }
  return g;
}

}  // namespace

// gx, gy: host arrays of V - 1 device pointers, the source views' [D, Hp,
// Wp] coordinates in ascending view order (vid left out). out [D, Hp, Wp,
// 3V + 32].
extern "C" int costvol_forward(const void* feats, const void* imgs,
                               const void* const* gx, const void* const* gy,
                               void* out, int V, int vid, int h, int w,
                               int pad, int D, void* stream) {
  const int Hp = h + 2 * pad, Wp = w + 2 * pad, Ct = 3 * V + kC;
  const long long n = (long long)D * Hp * Wp;
  if (n <= 0) return 0;
  costvol_forward_kernel<<<(unsigned)((n + kPix - 1) / kPix), kPix * kQuads,
                           kPix * Ct * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)feats, (const float*)imgs, grids_of(gx, gy, V - 1),
      (float*)out, V, vid, h, w, pad, Hp, Wp, n);
  return (int)cudaGetLastError();
}

// G: the volume's gradient, element strides (sd, sy, sx, sc) over [D, Hp,
// Wp, 3V + 32]. work: int32 scratch of (V - 1) * D * (2K + 1 + Hp * Wp),
// K = (h + 1)(w + 1); gwf: float scratch of (V - 1) * D * Hp * Wp * 32.
// gfeat [V, h, w, 32]: every element written.
extern "C" int costvol_backward(const void* G, long long sd, long long sy,
                                long long sx, long long sc, const void* feats,
                                const void* const* gx, const void* const* gy,
                                void* work, void* gwf, void* gfeat, int V,
                                int vid, int h, int w, int pad, int D,
                                void* stream) {
  const int S = V - 1, Hp = h + 2 * pad, Wp = w + 2 * pad, Np = Hp * Wp;
  const int K = (h + 1) * (w + 1);
  if (D <= 0 || h <= 0 || w <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const Grids g = grids_of(gx, gy, S);
  int* bins = (int*)work;
  int* cursor = bins + (long long)S * D * (K + 1);
  int* entries = cursor + (long long)S * D * K;
  if (S > 0) {
    costvol_bins_kernel<<<dim3(D, S), kBinThreads, 0, st>>>(
        g, bins, cursor, entries, h, w, Np, D, K);
  }
  costvol_gwf_kernel<<<(Np + kPix - 1) / kPix, kPix * kQuads, 0, st>>>(
      (const float*)G, sd, sy, sx, sc, (const float*)feats, g, (float*)gwf,
      (float*)gfeat, V, vid, h, w, pad, Hp, Wp, D);
  if (S > 0) {
    costvol_gather_kernel<<<dim3((h * w + kPix - 1) / kPix, S),
                            kPix * kQuads, 0, st>>>(
        (const float*)gwf, g, bins, entries, (float*)gfeat, vid, h, w, Np, D,
        K);
  }
  return (int)cudaGetLastError();
}
