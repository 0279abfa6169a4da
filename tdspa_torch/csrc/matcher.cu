// Learned-matcher correlation cost patches against a template bank, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tdspa/kernels/matcher.py::cost_patches_multi_pallas
// (pallas_call at :210, body `_cost_kernel` :68; `cost_patches_pallas` :157
// is its M = 1 case). It computes the XLA path of the matcher,
// tdspa/features/matcher.py::_cost_patches_multi (ported as
// tdspa_torch/kernels/matcher.py::cost_patches_reference, this kernel's plain
// version):
//
//   costs[n,t,m,k] = sum_d bilinear(feats[t], fpos[n,t] + off[k])[d] * tvec[n,m,d]
//
// with off[k] = (k % (2R+1) - R, k / (2R+1) - R) and the corner rule of
// ops/geometry.bilinear_sample (weights from the unclamped floor, each corner
// clamped on its own). The TPU kernel shifts border windows inward instead.
//
// Layout: one warp per (point, frame), eight per block, frames slowest so
// that the blocks in flight share one frame's feature map in L2 (256 x 256 x
// 16 f32 = 4 MB at the pipeline's shape). Lanes take the (2R+1)^2 = 81
// offsets; a lane samples its offset's D channels from the four corners
// (16-byte loads, one corner pixel's channels are contiguous) and contracts
// them with each of the M template vectors (the same address on every lane:
// one broadcast load). The 81 samples of a (point, frame) overlap within a
// (2R+2)^2 window of the map, so after the first touch their corners come
// from L1.
//
// What bounds it on an H100: the feature map is read once (T x Hf x Wf x D
// f32, 629 MB for 150 frames of 512x512) and the costs written once (N x T x
// M x 81 f32: 199 MB at M = 1, 796 MB at M = 4), against ~4 x D + 2 x D x M
// flops per cost: device-memory bytes bound it (about 0.25 ms at M = 1 and
// 0.43 ms at M = 4 at 3.35 TB/s). The costs are written with one coalesced
// 81-float row per (point, frame, template).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

struct Shape {
  int N, T, Hf, Wf, M, R;
};

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
    cost_patches_kernel(const float* __restrict__ feats, const float* __restrict__ tvec,
                        const float* __restrict__ fpos, float* __restrict__ out, Shape s) {
  const long long gw = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (gw >= static_cast<long long>(s.N) * s.T) return;
  const int t = static_cast<int>(gw / s.N), n = static_cast<int>(gw % s.N);
  const int lane = threadIdx.x & 31;
  const int side = 2 * s.R + 1, K2 = side * side;
  const float px = fpos[(static_cast<size_t>(n) * s.T + t) * 2];
  const float py = fpos[(static_cast<size_t>(n) * s.T + t) * 2 + 1];
  const float* frame = feats + static_cast<size_t>(t) * s.Hf * s.Wf * D;
  const float* tv = tvec + static_cast<size_t>(n) * s.M * D;
  float* o = out + (static_cast<size_t>(n) * s.T + t) * s.M * K2;
  for (int k = lane; k < K2; k += 32) {
    const float x = px + static_cast<float>(k % side - s.R);
    const float y = py + static_cast<float>(k / side - s.R);
    const float x0f = floorf(x), y0f = floorf(y);
    const float wx = x - x0f, wy = y - y0f;
    const int xi = static_cast<int>(fminf(fmaxf(x0f, -1e9f), 1e9f));
    const int yi = static_cast<int>(fminf(fmaxf(y0f, -1e9f), 1e9f));
    const int x0 = min(max(xi, 0), s.Wf - 1), x1 = min(max(xi + 1, 0), s.Wf - 1);
    const int y0 = min(max(yi, 0), s.Hf - 1), y1 = min(max(yi + 1, 0), s.Hf - 1);
    const float4* g00 = reinterpret_cast<const float4*>(frame + (static_cast<size_t>(y0) * s.Wf + x0) * D);
    const float4* g01 = reinterpret_cast<const float4*>(frame + (static_cast<size_t>(y0) * s.Wf + x1) * D);
    const float4* g10 = reinterpret_cast<const float4*>(frame + (static_cast<size_t>(y1) * s.Wf + x0) * D);
    const float4* g11 = reinterpret_cast<const float4*>(frame + (static_cast<size_t>(y1) * s.Wf + x1) * D);
    const float w00 = (1.f - wx) * (1.f - wy), w01 = wx * (1.f - wy);
    const float w10 = (1.f - wx) * wy, w11 = wx * wy;
    float v[D];
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const float4 a = __ldg(g00 + c), b = __ldg(g01 + c), e = __ldg(g10 + c), f = __ldg(g11 + c);
      v[4 * c + 0] = a.x * w00 + b.x * w01 + e.x * w10 + f.x * w11;
      v[4 * c + 1] = a.y * w00 + b.y * w01 + e.y * w10 + f.y * w11;
      v[4 * c + 2] = a.z * w00 + b.z * w01 + e.z * w10 + f.z * w11;
      v[4 * c + 3] = a.w * w00 + b.w * w01 + e.w * w10 + f.w * w11;
    }
    for (int m = 0; m < s.M; ++m) {
      const float4* tm = reinterpret_cast<const float4*>(tv + static_cast<size_t>(m) * D);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 q = __ldg(tm + c);
        acc += v[4 * c] * q.x + v[4 * c + 1] * q.y + v[4 * c + 2] * q.z + v[4 * c + 3] * q.w;
      }
      o[static_cast<size_t>(m) * K2 + k] = acc;
    }
  }
}

template <int D>
cudaError_t launch(const float* feats, const float* tvec, const float* fpos, float* out,
                   const Shape& s, cudaStream_t stream) {
  const long long warps = static_cast<long long>(s.N) * s.T;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cost_patches_kernel<D><<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(feats, tvec,
                                                                                  fpos, out, s);
  return cudaGetLastError();
}

}  // namespace

// feats [T, Hf, Wf, D] f32 (16-byte aligned), tvec [N, M, D] f32 (16-byte
// aligned), fpos [N, T, 2] f32 feature-pixel (x, y); writes out
// [N, T, M, (2R+1)^2] f32 on `stream`. D is 8, 16 or 32. Returns a
// cudaError_t.
extern "C" int tdspa_cost_patches(const void* feats, const void* tvec, const void* fpos, void* out,
                                  int N, int T, int Hf, int Wf, int D, int M, int R,
                                  void* stream) {
  if (N < 1 || T < 1 || Hf < 1 || Wf < 1 || M < 1 || R < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{N, T, Hf, Wf, M, R};
  const float* f = static_cast<const float*>(feats);
  const float* tv = static_cast<const float*>(tvec);
  const float* p = static_cast<const float*>(fpos);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return static_cast<int>(launch<8>(f, tv, p, o, s, st));
    case 16: return static_cast<int>(launch<16>(f, tv, p, o, s, st));
    case 32: return static_cast<int>(launch<32>(f, tv, p, o, s, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
