// Pyramidal Lucas-Kanade point tracking over a whole video, for Hopper (sm_90a).
//
// Replaces the TPU kernel tdspa/kernels/lk.py::track_video_lk_pallas
// (pallas_call at :787, body `_lk_pair_kernel` :415 with
// `_track_group_one_dir`, `_corr_refine_group`, `_gn_polish_group`). It
// computes the arithmetic of tdspa/ops/lk.py (ported as
// tdspa_torch/ops/lk.py, this kernel's plain version), not the Mosaic layout:
// the strip loads, cyclic rolls and 0/1 selector matmuls of the TPU kernel
// exist only to avoid gathers there, and bilinear samples here clamp each
// corner to the frame as ops/lk.py does (the TPU kernel shifts border windows
// inward instead).
//
// Per point and frame pair: the constant-velocity prior (clipped to +-32 px),
// coarse-to-fine Gauss-Newton with the closed-form 2x2 solve, and
// visibility = in bounds && min_eig > 1e-6 && the optional forward-backward,
// step-NCC and frame-0-template-NCC checks (centre-weighted NCC); with
// corr_radius > 0, the frame-0 cost volume at the fine level and at the
// rescue level, each snap GN-polished at the fine level and accepted only
// when its template NCC beats corr_accept and the LK estimate's by 0.1.
//
// Layout: one warp per point, four points per block. A point's trajectory
// depends only on its own previous position and velocity, so the TPU's
// sequential grid over frame pairs (positions carried in VMEM scratch)
// becomes a loop over frame pairs inside the kernel, with position, velocity
// and the frame-0 template in registers: one launch per call. Lanes take the
// window's pixels (49 for window 7: lane k holds pixels k and k + 32) and a
// window sum is the lane's partial, then a butterfly over the warp: the
// order in which the plain version's CUDA reductions sum a 49-pixel row, so
// the kernel's sums, and the thresholded decisions on them, equal the plain
// version's on the card. (A point per 8-lane group with a window row per lane
// measured 1.7x slower, with 8 warps per SM to hide each pair's chain of
// dependent samples and sums, and its sums in another order moved 4 % of
// the (point, frame) pairs of a 150-frame video past 0.05 px.)
//
// Against a kernel that clamps every corner of every sample and samples
// every window it needs:
//  - each sampling of the window votes once: where every corner of every
//    lane lies inside the level (the clamps would do nothing) the warp reads
//    the corners at one base offset with no clamps, bit for bit the clamped
//    values; otherwise the clamped per-sample path runs;
//  - the template side's coordinates (px + ox, py + oy) are formed once per
//    level and reused by every Gauss-Newton step;
//  - the step NCC's frame-t window is the fine level's template patch,
//    already sampled at the same coordinates of the same frame; the frame-0
//    template is centred once per launch and the tracked window once per
//    pair for both NCCs;
//  - in the cost volume (lanes take the candidates), an odd window puts the
//    candidates and their taps on pixels, where a bilinear sample is the
//    pixel itself: one load per tap, with no clamps where the candidate's
//    patch lies inside the frame.
//
// What bounds it on an H100: the default configuration (3 levels, 3
// iterations, step and template NCC, no backward pass) does about 17k f32
// operations per point and pair against one read of the pyramids (206 MB
// for 150 frames of 512x512): about 0.22 ms of f32 work at 67 TFLOP/s and
// 0.06 ms of device memory, so operations bound it on paper. Measured
// (PERF.md), it runs at about 6 % of that bound, and the chain of each
// frame pair's dependent samplings and warp sums holds it: the gathers'
// addresses and the clamps are each a small part (the interior path saves
// about an eighth). With at most 64 registers a thread (a few hundred
// bytes of spills), the 4096 warps are all resident at once, about 31 per
// SM. Built with --fmad=false so that every product and sum rounds as in
// the plain version (thresholded decisions sit on these values).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int MAX_WINDOW = 11;  // K = window^2 <= 121 pixels: at most 4 per lane
constexpr int MAX_K = MAX_WINDOW * MAX_WINDOW;
constexpr int WARPS = 4;        // points per block
constexpr unsigned FULL = 0xffffffffu;

struct Pyramid {
  const float* img[MAX_LEVELS];  // level l: [T, h[l], w[l]] f32, fine first
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

struct Params {
  int levels, window, iterations, corr_radius, corr_iterations, rescue_level, N, T;
  float fb_threshold, ncc_threshold, tncc_threshold, corr_accept;
};

struct Image {
  const float* __restrict__ p;
  int h, w;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Clamp before the conversion so that a position far outside stays defined.
__device__ __forceinline__ int to_index(float v) {
  return static_cast<int>(fminf(fmaxf(v, -1e9f), 1e9f));
}

// ops/lk.py::_bilinear: weights from the unclamped floor, each corner index
// clamped to the frame on its own.
__device__ __forceinline__ float bilinear(const Image& im, float x, float y) {
  const float x0f = floorf(x), y0f = floorf(y);
  const float wx = x - x0f, wy = y - y0f;
  const int xi = to_index(x0f), yi = to_index(y0f);
  const int x0 = min(max(xi, 0), im.w - 1), x1 = min(max(xi + 1, 0), im.w - 1);
  const int y0 = min(max(yi, 0), im.h - 1), y1 = min(max(yi + 1, 0), im.h - 1);
  return __ldg(im.p + y0 * im.w + x0) * (1.f - wx) * (1.f - wy) +
         __ldg(im.p + y0 * im.w + x1) * wx * (1.f - wy) +
         __ldg(im.p + y1 * im.w + x0) * (1.f - wx) * wy +
         __ldg(im.p + y1 * im.w + x1) * wx * wy;
}

// The lane's share of the window: pixel k = lane + 32 j for j < PL.
template <int PL>
struct Lane {
  float ox[PL], oy[PL], wt[PL];  // offset and Gaussian weight (0 past K)
  bool valid[PL];
};

// out[j] = bilinear(im, xs[j], ys[j]) for the lane's pixels, 0 past K. One
// vote per call: where all corners of the warp's samples lie inside the
// level, they are read with no clamps (the clamps would change nothing).
template <int PL>
__device__ __forceinline__ void sample_at(const Image& im, const float (&xs)[PL],
                                          const float (&ys)[PL], const Lane<PL>& L,
                                          float (&out)[PL]) {
  float wx[PL], wy[PL];
  int at[PL];
  bool inside = true;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const float x0f = floorf(xs[j]), y0f = floorf(ys[j]);
    wx[j] = xs[j] - x0f;
    wy[j] = ys[j] - y0f;
    // The conversion saturates far outside, where the test below fails.
    const int xi = __float2int_rz(x0f), yi = __float2int_rz(y0f);
    at[j] = yi * im.w + xi;
    inside = inside && (!L.valid[j] ||
                        (static_cast<unsigned>(xi) < static_cast<unsigned>(im.w - 1) &&
                         static_cast<unsigned>(yi) < static_cast<unsigned>(im.h - 1)));
  }
  if (__all_sync(FULL, inside)) {
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      if (L.valid[j]) {
        const float* p0 = im.p + at[j];
        const float* p1 = p0 + im.w;
        out[j] = __ldg(p0) * (1.f - wx[j]) * (1.f - wy[j]) +
                 __ldg(p0 + 1) * wx[j] * (1.f - wy[j]) + __ldg(p1) * (1.f - wx[j]) * wy[j] +
                 __ldg(p1 + 1) * wx[j] * wy[j];
      } else {
        out[j] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < PL; ++j) out[j] = L.valid[j] ? bilinear(im, xs[j], ys[j]) : 0.f;
  }
}

// The window at (px, py): coordinates px + ox, py + oy as ops/lk.py forms them.
template <int PL>
__device__ __forceinline__ void sample_window(const Image& im, float px, float py,
                                              const Lane<PL>& L, float (&out)[PL]) {
  float xs[PL], ys[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    xs[j] = px + L.ox[j];
    ys[j] = py + L.oy[j];
  }
  sample_at(im, xs, ys, L, out);
}

// The centring of ops/lk.py::_weighted_ncc: c = v - sum(w v); returns
// sum(w c c) over the window.
template <int PL>
__device__ __forceinline__ float centre(const Lane<PL>& L, const float (&v)[PL], float (&c)[PL]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) s += v[j] * L.wt[j];
  const float m = warp_sum(s);
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    c[j] = v[j] - m;
    q += L.wt[j] * c[j] * c[j];
  }
  return warp_sum(q);
}

// ops/lk.py::_weighted_ncc(a, b) from centred a, b and their centre() sums.
template <int PL>
__device__ __forceinline__ float weighted_ncc(const Lane<PL>& L, const float (&a)[PL], float va,
                                              const float (&b)[PL], float vb) {
  float cov = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) cov += L.wt[j] * a[j] * b[j];
  return warp_sum(cov) / (sqrtf(va * vb) + 1e-6f);
}

// The template side of one ops/lk.py::_lk_level: the window's coordinates,
// patch, central-difference gradients and the normal matrix at (px, py) in i0.
template <int PL>
struct Level {
  float cx[PL], cy[PL], t[PL], ix[PL], iy[PL];
  float gxx, gxy, gyy, inv_det, min_eig;
};

template <int PL>
__device__ __forceinline__ void level_prepare(const Image& i0, float px, float py,
                                              const Lane<PL>& L, Level<PL>& s) {
  float xs[PL], ys[PL], a[PL], b[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    s.cx[j] = px + L.ox[j];
    s.cy[j] = py + L.oy[j];
  }
  sample_at(i0, s.cx, s.cy, L, s.t);
#pragma unroll
  for (int j = 0; j < PL; ++j) xs[j] = s.cx[j] + 0.5f;
  sample_at(i0, xs, s.cy, L, a);
#pragma unroll
  for (int j = 0; j < PL; ++j) xs[j] = s.cx[j] - 0.5f;
  sample_at(i0, xs, s.cy, L, b);
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    s.ix[j] = a[j] - b[j];
    ys[j] = s.cy[j] + 0.5f;
  }
  sample_at(i0, s.cx, ys, L, a);
#pragma unroll
  for (int j = 0; j < PL; ++j) ys[j] = s.cy[j] - 0.5f;
  sample_at(i0, s.cx, ys, L, b);
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    s.iy[j] = a[j] - b[j];
    sxx += s.ix[j] * s.ix[j];
    sxy += s.ix[j] * s.iy[j];
    syy += s.iy[j] * s.iy[j];
  }
  s.gxx = warp_sum(sxx);
  s.gxy = warp_sum(sxy);
  s.gyy = warp_sum(syy);
  const float det = s.gxx * s.gyy - s.gxy * s.gxy;
  const float trace = s.gxx + s.gyy;
  s.min_eig = (trace - sqrtf(fmaxf(trace * trace - 4.f * det, 0.f))) / 2.f;
  s.inv_det = fabsf(det) > 1e-8f ? 1.f / det : 0.f;
}

// Gauss-Newton steps of the displacement (dx, dy) against i1.
template <int PL>
__device__ __forceinline__ void level_iterate(const Image& i1, const Lane<PL>& L,
                                              const Level<PL>& s, int iterations, float& dx,
                                              float& dy) {
  float xs[PL], ys[PL], v[PL];
  for (int it = 0; it < iterations; ++it) {
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      xs[j] = s.cx[j] + dx;
      ys[j] = s.cy[j] + dy;
    }
    sample_at(i1, xs, ys, L, v);
    float bx = 0.f, by = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      if (L.valid[j]) {
        const float r = v[j] - s.t[j];
        bx += r * s.ix[j];
        by += r * s.iy[j];
      }
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float ddx = s.inv_det * (s.gyy * bx - s.gxy * by);
    const float ddy = s.inv_det * (-s.gxy * bx + s.gxx * by);
    dx = dx - ddx;
    dy = dy - ddy;
  }
}

__device__ __forceinline__ Image frame(const Pyramid& pyr, int level, int t) {
  const int h = pyr.h[level], w = pyr.w[level];
  return Image{pyr.img[level] + static_cast<size_t>(t) * h * w, h, w};
}

// ops/lk.py::_track_pair from frame ta to frame tb. Leaves the finest
// level's template side in `fine`.
template <int PL>
__device__ __forceinline__ void track_pair(const Pyramid& pyr, const Params& p, int ta, int tb,
                                           float x, float y, float init_dx, float init_dy,
                                           const Lane<PL>& L, float& nx, float& ny,
                                           Level<PL>& fine) {
  const float coarse = static_cast<float>(1 << (p.levels - 1));
  float dx = init_dx / coarse, dy = init_dy / coarse;
  for (int lvl = p.levels - 1; lvl >= 0; --lvl) {
    const float scale = static_cast<float>(1 << lvl);
    level_prepare(frame(pyr, lvl, ta), x / scale, y / scale, L, fine);
    level_iterate(frame(pyr, lvl, tb), L, fine, p.iterations, dx, dy);
    if (lvl > 0) {
      dx = dx * 2.f;
      dy = dy * 2.f;
    }
  }
  nx = x + dx;
  ny = y + dy;
}

// ops/lk.py::_corr_refine: the template's centre-weighted NCC at every
// integer offset of the (2R+1)^2 grid around round-half-up(ex, ey); the
// first maximum (in candidate order) wins. Lanes take the candidates.
template <int PL>
__device__ __forceinline__ void corr_refine(const float (&tmpl)[PL], const Image& im, float ex,
                                            float ey, int R, int window, const Lane<PL>& L,
                                            const float* s_ox, const float* s_oy,
                                            const float* s_w, float* s_am, float& sx,
                                            float& sy) {
  const int lane = threadIdx.x & 31, K = window * window;
  float am[PL];
  const float va = centre(L, tmpl, am);
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    if (L.valid[j]) s_am[lane + 32 * j] = am[j];
  }
  __syncwarp();
  const float cxb = floorf(ex + 0.5f), cyb = floorf(ey + 0.5f);
  const int side = 2 * R + 1, C = side * side;
  const float half = (window - 1) / 2.f;
  // Odd window: every tap lies on a pixel (wx = wy = 0), where the bilinear
  // sample is the clamped pixel itself.
  const bool on_pixels = (window & 1) == 1;
  float best = -INFINITY;
  int best_c = C;
  for (int c = lane; c < C; c += 32) {
    const float ccx = cxb + static_cast<float>(c % side - R);
    const float ccy = cyb + static_cast<float>(c / side - R);
    const bool inside = on_pixels && ccx - half >= 0.f &&
                        ccx + half <= static_cast<float>(im.w - 1) && ccy - half >= 0.f &&
                        ccy + half <= static_cast<float>(im.h - 1);
    const float* base =
        inside ? im.p + static_cast<int>(ccy - half) * im.w + static_cast<int>(ccx - half) : im.p;
    auto tap = [&](int k) -> float {
      if (inside) return __ldg(base + (k / window) * im.w + k % window);
      const float x = ccx + s_ox[k], y = ccy + s_oy[k];
      if (!on_pixels) return bilinear(im, x, y);
      return __ldg(im.p + min(max(to_index(y), 0), im.h - 1) * im.w +
                   min(max(to_index(x), 0), im.w - 1));
    };
    float mb = 0.f;
    for (int k = 0; k < K; ++k) mb += tap(k) * s_w[k];
    float cov = 0.f, vb = 0.f;
    for (int k = 0; k < K; ++k) {
      const float bm = tap(k) - mb;
      cov += s_w[k] * s_am[k] * bm;
      vb += s_w[k] * bm * bm;
    }
    const float ncc = cov / (sqrtf(va * vb) + 1e-6f);
    if (ncc > best) {
      best = ncc;
      best_c = c;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oc = __shfl_xor_sync(FULL, best_c, o);
    if (ob > best || (ob == best && oc < best_c)) {
      best = ob;
      best_c = oc;
    }
  }
  __syncwarp();  // s_am is rewritten by the next call
  sx = cxb + static_cast<float>(best_c % side - R);
  sy = cyb + static_cast<float>(best_c / side - R);
}

// At most 64 registers a thread, so that 8 blocks fit on an SM: the
// pipeline's 4096 points then run in one wave (1,024 blocks on 132 SMs); at
// 80 registers a second wave of whole 150-frame chains followed the first.
template <int PL>
__global__ void __launch_bounds__(WARPS * 32, 8)
    lk_track_kernel(Pyramid pyr, const float* __restrict__ tmpl0, Image tmpl_rescue,
                    const float* __restrict__ queries, const float* __restrict__ tpos,
                    const float* __restrict__ init_vel, const float* __restrict__ gauss_w,
                    float* __restrict__ tracks, float* __restrict__ vis,
                    float* __restrict__ vel_out, Params p) {
  __shared__ float s_ox[MAX_K], s_oy[MAX_K], s_w[MAX_K];
  __shared__ float s_am[WARPS][MAX_K];
  const int K = p.window * p.window;
  const float r = (p.window - 1) / 2.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_ox[k] = static_cast<float>(k % p.window) - r;
    s_oy[k] = static_cast<float>(k / p.window) - r;
    s_w[k] = gauss_w[k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= p.N) return;  // the whole warp leaves; no block barrier follows

  Lane<PL> L;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int k = lane + 32 * j;
    L.valid[j] = k < K;
    L.ox[j] = L.valid[j] ? s_ox[k] : 0.f;
    L.oy[j] = L.valid[j] ? s_oy[k] : 0.f;
    L.wt[j] = L.valid[j] ? s_w[k] : 0.f;
  }
  const int h = pyr.h[0], w = pyr.w[0];
  const float tx = tpos[2 * n], ty = tpos[2 * n + 1];
  float tmpl[PL], tmpl_c[PL], tam[PL];
  sample_window(Image{tmpl0, h, w}, tx, ty, L, tmpl);
  const float tva = centre(L, tmpl, tam);  // the template NCC's centred template
  const bool rescue = p.corr_radius > 0 && p.rescue_level > 0;
  const float rescue_scale = static_cast<float>(1 << p.rescue_level);
  if (rescue) {
    sample_window(tmpl_rescue, tx / rescue_scale, ty / rescue_scale, L, tmpl_c);
  } else {
#pragma unroll
    for (int j = 0; j < PL; ++j) tmpl_c[j] = 0.f;
  }

  float x = queries[2 * n], y = queries[2 * n + 1];
  float vx = init_vel[2 * n], vy = init_vel[2 * n + 1];
  float* tr = tracks + static_cast<size_t>(n) * p.T * 2;
  float* vi = vis + static_cast<size_t>(n) * p.T;
  if (lane == 0) {
    tr[0] = x;
    tr[1] = y;
    vi[0] = 1.f;
  }
  Level<PL> fine;
  float win[PL], wc[PL];
  for (int t = 0; t + 1 < p.T; ++t) {
    float nx, ny;
    track_pair(pyr, p, t, t + 1, x, y, vx, vy, L, nx, ny, fine);
    const float min_eig = fine.min_eig;
    const Image f1 = frame(pyr, 0, t + 1);
    if (p.corr_radius > 0) {
      float cand_x[2], cand_y[2];
      int n_cand = 0;
      float sx, sy;
      corr_refine(tmpl, f1, nx, ny, p.corr_radius, p.window, L, s_ox, s_oy, s_w, s_am[warp], sx,
                  sy);
      float dx = sx - x, dy = sy - y;
      level_iterate(f1, L, fine, p.corr_iterations, dx, dy);
      cand_x[n_cand] = x + dx;
      cand_y[n_cand++] = y + dy;
      if (rescue) {
        corr_refine(tmpl_c, frame(pyr, p.rescue_level, t + 1), nx / rescue_scale,
                    ny / rescue_scale, p.corr_radius, p.window, L, s_ox, s_oy, s_w, s_am[warp],
                    sx, sy);
        dx = sx * rescue_scale - x;
        dy = sy * rescue_scale - y;
        level_iterate(f1, L, fine, p.corr_iterations, dx, dy);
        cand_x[n_cand] = x + dx;
        cand_y[n_cand++] = y + dy;
      }
      sample_window(f1, nx, ny, L, win);
      float vw = centre(L, win, wc);
      const float score_lk = weighted_ncc(L, tam, tva, wc, vw);
      float best_x = nx, best_y = ny, best_score = score_lk;
      for (int c = 0; c < n_cand; ++c) {
        sample_window(f1, cand_x[c], cand_y[c], L, win);
        vw = centre(L, win, wc);
        const float s = weighted_ncc(L, tam, tva, wc, vw);
        if (s > best_score) {
          best_x = cand_x[c];
          best_y = cand_y[c];
        }
        best_score = fmaxf(best_score, s);
      }
      if (best_score > p.corr_accept && best_score > score_lk + 0.1f) {
        nx = best_x;
        ny = best_y;
      }
    }
    bool visible = nx >= 0.f && nx <= static_cast<float>(w - 1) && ny >= 0.f &&
                   ny <= static_cast<float>(h - 1) && min_eig > 1e-6f;
    if (p.ncc_threshold > -1.f || p.tncc_threshold > -1.f) {
      sample_window(f1, nx, ny, L, win);
      const float vw = centre(L, win, wc);
      if (p.ncc_threshold > -1.f) {
        // ops/lk.py samples frame t at (x, y) + offsets: the fine level's
        // template patch, the same coordinates in the same frame.
        float pc[PL];
        const float vp = centre(L, fine.t, pc);
        visible = visible && weighted_ncc(L, pc, vp, wc, vw) > p.ncc_threshold;
      }
      if (p.tncc_threshold > -1.f) {
        visible = visible && weighted_ncc(L, tam, tva, wc, vw) > p.tncc_threshold;
      }
    }
    if (p.fb_threshold > -1.f) {  // last: the backward pass overwrites `fine`
      float bx, by;
      track_pair(pyr, p, t + 1, t, nx, ny, x - nx, y - ny, L, bx, by, fine);
      const float ex = bx - x, ey = by - y;
      visible = visible && sqrtf(ex * ex + ey * ey) < p.fb_threshold;
    }
    const float cx = fminf(fmaxf(nx, 0.f), static_cast<float>(w - 1));
    const float cy = fminf(fmaxf(ny, 0.f), static_cast<float>(h - 1));
    vx = fminf(fmaxf(cx - x, -32.f), 32.f);
    vy = fminf(fmaxf(cy - y, -32.f), 32.f);
    x = cx;
    y = cy;
    if (lane == 0) {
      tr[2 * (t + 1)] = x;
      tr[2 * (t + 1) + 1] = y;
      vi[t + 1] = visible ? 1.f : 0.f;
    }
  }
  if (lane == 0) {
    vel_out[2 * n] = vx;
    vel_out[2 * n + 1] = vy;
  }
}

template <int PL>
cudaError_t launch(const Pyramid& pyr, const float* tmpl0, Image tmpl_rescue, const float* queries,
                   const float* tpos, const float* init_vel, const float* gauss_w, float* tracks,
                   float* vis, float* vel_out, const Params& p, cudaStream_t stream) {
  const int blocks = (p.N + WARPS - 1) / WARPS;
  lk_track_kernel<PL><<<blocks, WARPS * 32, 0, stream>>>(pyr, tmpl0, tmpl_rescue, queries, tpos,
                                                         init_vel, gauss_w, tracks, vis, vel_out, p);
  return cudaGetLastError();
}

}  // namespace

// Tracks N points through T frames in one launch on `stream`.
// level_ptrs / level_h / level_w: host arrays of `levels` entries (device
// pointers to [T, h, w] f32 luma levels, fine first). tmpl0 [h0, w0] is the
// template frame; tmpl_rescue [h_r, w_r] its pyramid level `rescue_level`
// (read only when corr_radius > 0 and rescue_level > 0). queries, tpos and
// init_vel are [N, 2] f32; gauss_w is [window^2] f32. Writes tracks
// [N, T, 2], vis [N, T] (0/1) and vel_out [N, 2]. Returns a cudaError_t.
extern "C" int tdspa_lk_track(const void* level_ptrs, const void* level_h, const void* level_w,
                              int levels, const void* tmpl0, const void* tmpl_rescue, int h_r,
                              int w_r, const void* queries, const void* tpos, const void* init_vel,
                              const void* gauss_w, void* tracks, void* vis, void* vel_out, int N,
                              int T, int window, int iterations, float fb_threshold,
                              float ncc_threshold, float tncc_threshold, int corr_radius,
                              int corr_iterations, float corr_accept, int rescue_level,
                              void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || window < 1 || window > MAX_WINDOW || N < 1 || T < 1 ||
      iterations < 0 || corr_radius < 0 || corr_iterations < 0 || rescue_level < 0 ||
      rescue_level >= levels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pyramid pyr{};
  const uint64_t* ptrs = static_cast<const uint64_t*>(level_ptrs);
  const int* hs = static_cast<const int*>(level_h);
  const int* ws = static_cast<const int*>(level_w);
  for (int l = 0; l < levels; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    pyr.img[l] = reinterpret_cast<const float*>(ptrs[l]);
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
  }
  Params p{levels, window, iterations, corr_radius, corr_iterations, rescue_level, N, T,
           fb_threshold, ncc_threshold, tncc_threshold, corr_accept};
  const Image rescue{static_cast<const float*>(tmpl_rescue), h_r, w_r};
  const float* t0 = static_cast<const float*>(tmpl0);
  const float* q = static_cast<const float*>(queries);
  const float* tp = static_cast<const float*>(tpos);
  const float* iv = static_cast<const float*>(init_vel);
  const float* gw = static_cast<const float*>(gauss_w);
  float* tr = static_cast<float*>(tracks);
  float* vi = static_cast<float*>(vis);
  float* vo = static_cast<float*>(vel_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_lane = (window * window + 31) / 32;
  cudaError_t err;
  switch (per_lane) {
    case 1: err = launch<1>(pyr, t0, rescue, q, tp, iv, gw, tr, vi, vo, p, s); break;
    case 2: err = launch<2>(pyr, t0, rescue, q, tp, iv, gw, tr, vi, vo, p, s); break;
    case 3: err = launch<3>(pyr, t0, rescue, q, tp, iv, gw, tr, vi, vo, p, s); break;
    default: err = launch<4>(pyr, t0, rescue, q, tp, iv, gw, tr, vi, vo, p, s); break;
  }
  return static_cast<int>(err);
}
