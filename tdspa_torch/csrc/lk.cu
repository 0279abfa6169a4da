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
// and the frame-0 template windows in registers: one launch per call. Lanes
// take the window's pixels (49 for window 7: lane k holds pixels k and
// k + 32), and warp shuffles form the normal-matrix, residual and NCC sums.
// In the cost volume, lanes take the candidate offsets instead.
//
// What bounds it on an H100: the default configuration (3 levels, 3
// iterations, step and template NCC, no backward pass) does about 17k f32
// operations per point and pair against one read of the pyramids (206 MB
// for 150 frames of 512x512): about 0.15 ms of f32 work at 67 TFLOP/s and
// 0.06 ms of device memory, so operations bound it on paper. In practice a
// point's work is a chain of ~12 dependent rounds of gathers per pair
// (window samples, then a warp reduction, then the next step), so the
// latency of L1/L2 gathers bounds it; 4096 points give 4096 warps, about 31
// per SM, to hide that latency. Built with --fmad=false so that every
// product and sum rounds as in the plain version (thresholded decisions sit
// on these values).

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

// ops/lk.py::_bilinear: weights from the unclamped floor, each corner index
// clamped to the frame on its own.
__device__ __forceinline__ float bilinear(const Image& im, float x, float y) {
  const float x0f = floorf(x), y0f = floorf(y);
  const float wx = x - x0f, wy = y - y0f;
  // Clamp before the conversion so that a position far outside stays defined.
  const int xi = static_cast<int>(fminf(fmaxf(x0f, -1e9f), 1e9f));
  const int yi = static_cast<int>(fminf(fmaxf(y0f, -1e9f), 1e9f));
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

template <int PL>
__device__ __forceinline__ void sample(const Image& im, float px, float py, const Lane<PL>& L,
                                       float (&out)[PL]) {
#pragma unroll
  for (int j = 0; j < PL; ++j) out[j] = L.valid[j] ? bilinear(im, px + L.ox[j], py + L.oy[j]) : 0.f;
}

// ops/lk.py::_weighted_ncc over the warp's window.
template <int PL>
__device__ __forceinline__ float weighted_ncc(const float (&a)[PL], const float (&b)[PL],
                                              const Lane<PL>& L) {
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    sa += a[j] * L.wt[j];
    sb += b[j] * L.wt[j];
  }
  const float ma = warp_sum(sa), mb = warp_sum(sb);
  float cov = 0.f, va = 0.f, vb = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const float am = a[j] - ma, bm = b[j] - mb;
    cov += L.wt[j] * am * bm;
    va += L.wt[j] * am * am;
    vb += L.wt[j] * bm * bm;
  }
  cov = warp_sum(cov);
  const float var = warp_sum(va) * warp_sum(vb);
  return cov / (sqrtf(var) + 1e-6f);
}

// The template side of one ops/lk.py::_lk_level: patch, central-difference
// gradients and the normal matrix at (px, py) in i0.
template <int PL>
struct Level {
  float t[PL], ix[PL], iy[PL];
  float gxx, gxy, gyy, inv_det, min_eig;
};

template <int PL>
__device__ void level_prepare(const Image& i0, float px, float py, const Lane<PL>& L,
                              Level<PL>& s) {
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    if (L.valid[j]) {
      const float cx = px + L.ox[j], cy = py + L.oy[j];
      s.t[j] = bilinear(i0, cx, cy);
      s.ix[j] = bilinear(i0, cx + 0.5f, cy) - bilinear(i0, cx - 0.5f, cy);
      s.iy[j] = bilinear(i0, cx, cy + 0.5f) - bilinear(i0, cx, cy - 0.5f);
    } else {
      s.t[j] = s.ix[j] = s.iy[j] = 0.f;
    }
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
__device__ void level_iterate(const Image& i1, float px, float py, const Lane<PL>& L,
                              const Level<PL>& s, int iterations, float& dx, float& dy) {
  for (int it = 0; it < iterations; ++it) {
    float bx = 0.f, by = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      if (L.valid[j]) {
        const float r = bilinear(i1, (px + L.ox[j]) + dx, (py + L.oy[j]) + dy) - s.t[j];
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
// level's template side in `fine` (the cost-volume polish reuses it).
template <int PL>
__device__ void track_pair(const Pyramid& pyr, const Params& p, int ta, int tb, float x, float y,
                           float init_dx, float init_dy, const Lane<PL>& L, float& nx, float& ny,
                           Level<PL>& fine) {
  const float coarse = static_cast<float>(1 << (p.levels - 1));
  float dx = init_dx / coarse, dy = init_dy / coarse;
  for (int lvl = p.levels - 1; lvl >= 0; --lvl) {
    const float scale = static_cast<float>(1 << lvl);
    const float px = x / scale, py = y / scale;
    level_prepare(frame(pyr, lvl, ta), px, py, L, fine);
    level_iterate(frame(pyr, lvl, tb), px, py, L, fine, p.iterations, dx, dy);
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
__device__ void corr_refine(const float (&tmpl)[PL], const Image& im, float ex, float ey, int R,
                            int K, const Lane<PL>& L, const float* s_ox, const float* s_oy,
                            const float* s_w, float* s_am, float& sx, float& sy) {
  float st = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) st += tmpl[j] * L.wt[j];
  const float mt = warp_sum(st);
  float sv = 0.f;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const float am = tmpl[j] - mt;
    sv += L.wt[j] * am * am;
    if (L.valid[j]) s_am[lane + 32 * j] = am;
  }
  const float va = warp_sum(sv);
  __syncwarp();
  const float cxb = floorf(ex + 0.5f), cyb = floorf(ey + 0.5f);
  const int side = 2 * R + 1, C = side * side;
  float best = -INFINITY;
  int best_c = C;
  for (int c = lane; c < C; c += 32) {
    const float ccx = cxb + static_cast<float>(c % side - R);
    const float ccy = cyb + static_cast<float>(c / side - R);
    float mb = 0.f;
    for (int k = 0; k < K; ++k) mb += bilinear(im, ccx + s_ox[k], ccy + s_oy[k]) * s_w[k];
    float cov = 0.f, vb = 0.f;
    for (int k = 0; k < K; ++k) {
      const float bm = bilinear(im, ccx + s_ox[k], ccy + s_oy[k]) - mb;
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

template <int PL>
__global__ void __launch_bounds__(WARPS * 32)
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
  float tmpl[PL], tmpl_c[PL];
  sample(Image{tmpl0, h, w}, tx, ty, L, tmpl);
  const bool rescue = p.corr_radius > 0 && p.rescue_level > 0;
  const float rescue_scale = static_cast<float>(1 << p.rescue_level);
  if (rescue) sample(tmpl_rescue, tx / rescue_scale, ty / rescue_scale, L, tmpl_c);

  float x = queries[2 * n], y = queries[2 * n + 1];
  float vx = init_vel[2 * n], vy = init_vel[2 * n + 1];
  float* tr = tracks + static_cast<size_t>(n) * p.T * 2;
  float* vi = vis + static_cast<size_t>(n) * p.T;
  if (lane == 0) {
    tr[0] = x;
    tr[1] = y;
    vi[0] = 1.f;
  }
  Level<PL> fine, scratch;
  float win[PL], prev[PL];
  for (int t = 0; t + 1 < p.T; ++t) {
    float nx, ny;
    track_pair(pyr, p, t, t + 1, x, y, vx, vy, L, nx, ny, fine);
    const float min_eig = fine.min_eig;
    const Image f0 = frame(pyr, 0, t), f1 = frame(pyr, 0, t + 1);
    if (p.corr_radius > 0) {
      float cand_x[2], cand_y[2];
      int n_cand = 0;
      float sx, sy;
      corr_refine(tmpl, f1, nx, ny, p.corr_radius, K, L, s_ox, s_oy, s_w, s_am[warp], sx, sy);
      float dx = sx - x, dy = sy - y;
      level_iterate(f1, x, y, L, fine, p.corr_iterations, dx, dy);
      cand_x[n_cand] = x + dx;
      cand_y[n_cand++] = y + dy;
      if (rescue) {
        corr_refine(tmpl_c, frame(pyr, p.rescue_level, t + 1), nx / rescue_scale,
                    ny / rescue_scale, p.corr_radius, K, L, s_ox, s_oy, s_w, s_am[warp], sx, sy);
        dx = sx * rescue_scale - x;
        dy = sy * rescue_scale - y;
        level_iterate(f1, x, y, L, fine, p.corr_iterations, dx, dy);
        cand_x[n_cand] = x + dx;
        cand_y[n_cand++] = y + dy;
      }
      sample(f1, nx, ny, L, win);
      const float score_lk = weighted_ncc(tmpl, win, L);
      float best_x = nx, best_y = ny, best_score = score_lk;
      for (int c = 0; c < n_cand; ++c) {
        sample(f1, cand_x[c], cand_y[c], L, win);
        const float s = weighted_ncc(tmpl, win, L);
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
    if (p.fb_threshold > -1.f) {
      float bx, by;
      track_pair(pyr, p, t + 1, t, nx, ny, x - nx, y - ny, L, bx, by, scratch);
      const float ex = bx - x, ey = by - y;
      visible = visible && sqrtf(ex * ex + ey * ey) < p.fb_threshold;
    }
    if (p.ncc_threshold > -1.f || p.tncc_threshold > -1.f) {
      sample(f1, nx, ny, L, win);
      if (p.ncc_threshold > -1.f) {
        sample(f0, x, y, L, prev);
        visible = visible && weighted_ncc(prev, win, L) > p.ncc_threshold;
      }
      if (p.tncc_threshold > -1.f) visible = visible && weighted_ncc(tmpl, win, L) > p.tncc_threshold;
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
