// Fused key-masked multi-head attention forward for Hopper (sm_90a).
//
// Replaces the two TPU bodies on the 3DSPA path, tdspa/kernels/attention.py
// `_mha_kernel` (whole KV per batch tile) and `_mha_flash_kernel` (KV-blocked
// online softmax). Those two exist only because of VMEM sizing; here one
// key-looping online-softmax kernel computes both functions:
//
//   out[b,s,h,:] = softmax_k(q[b,s,h,:] . k[b,k,h,:] * scale, key-masked) . v[b,k,h,:]
//
// q/k/v are bf16 in the JAX layout [B, S|K, H, D] (D a multiple of 8 up to
// 128); the mask is uint8 [B, K] (nonzero = attend) or null; the output is
// f32 or bf16 [B, S, H, D].
//
// Numerics follow the Pallas kernels: bf16 products with f32 accumulation,
// logits scaled in f32 afterwards, running max / denominator / accumulator
// in f32, P rounded to bf16 before P.V. The logits are kept in log2 units
// (the product times scale * log2(e), one f32 multiply) and the exponentials
// are exp2 on the special-function unit (ex2.approx.ftz), as in
// vit_attention.cu: the same softmax, with the scale folded into the one
// multiply. A user-masked logit is FLT_MAX-negated (finfo(f32).min, never
// -inf), and the running max starts there too, so a row whose keys are all
// masked sees 2^0 = 1 on every key and returns the mean of all K values.
// Keys past K are excluded by index (their logit is -inf, so exp2 gives 0)
// and never enter that mean. Scaling and masking are one FMA per logit,
// s * c + b with the key's (c, b): (scale log2(e), 0) to attend, (0,
// -FLT_MAX) masked, (0, -inf) past K.
//
// What bounds it on an H100: at the main-path shapes the work is
// 4 S K D flops per (item, head) against reading q, k, v once and writing
// the output once, about 50-120 flops per byte: far below the ~295 flops per
// byte where bf16 tensor cores take over, so device-memory bytes bound it.
// The design keeps logits and probabilities out of device memory and keeps
// TMA loads in flight ahead of the compute.
//
// Design: a persistent grid walks work items (item, head, 192 query rows,
// key chunk), in that order. At the main-path shapes (S <= 192) one item
// holds every query row of an (item, head), so its K and V are loaded once.
// Warpgroup 0 gives its registers up (setmaxnreg): one thread issues the TMA
// loads of each item's Q tile and of its 64-key K and V tiles into a ring of
// KV_STAGES, guarded by mbarriers, running ahead into the next item; warp 1
// writes each key tile's (c, b) beside it from the mask, since a [B, K] mask
// row (K bytes) cannot be a TMA box. q, k, v and the output are 4-D tensor
// maps over [B, S|K, H, D] with D innermost, so a box that runs past D, S or
// K arrives as zeros (and a store past them writes nothing), never as
// another head's or item's data. D is loaded as 64-column boxes (128-byte
// rows, 128-byte swizzle), one or two; the second ends at D (D = 96:
// columns 32-95) where D is a multiple of 32, since a box that runs past D
// loads much more slowly: on an H100 the encoder shape ran slower with D =
// 96 in boxes of columns 0-63 and 64-127 than with D = 128, which moves a
// third more bytes. Warpgroups 1-3 own 64 query rows each: S = Q.K^T with
// wgmma m64n64k16 (both K-major), the online softmax in registers, P in
// bf16 registers as the A operand of wgmma m64n64k16 for P.V (V MN-major,
// one wgmma per 64-column box); the three warpgroups' tiles interleave on
// the tensor cores and the special-function units. A warpgroup whose rows
// all lie past S only releases the stages. The epilogue divides by the
// denominator in f32, stages the tile in 128-byte-swizzled shared memory and
// writes it with TMA stores, which drain while the warpgroup runs its next
// item. The ring depth is what fits 227 KB beside Q and the staging: 3
// stages of 32 KB for D = 96 (2 for D > 96), 4 of 16 KB for D <= 64.
//
// Small batches (the B = 1 stacks: 8 heads x 1 row tile) split the keys into
// chunks so that the work items fill the SMs: each chunk writes its f32
// (O, m, l) and a second launch (merge_chunks_kernel) combines them,
// O = sum_c 2^(m_c - M) O_c / sum_c 2^(m_c - M) l_c. Chunks whose keys are
// all masked keep m = -FLT_MAX, so a fully masked row still weighs every
// chunk by 2^0 and returns the mean.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 3;           // warpgroups 1-3 compute, 64 query rows each
constexpr int ROWS = 64 * CONSUMERS;   // query rows per work item
constexpr int KT = 64;                 // keys per ring stage
constexpr int THREADS = 128 * (1 + CONSUMERS);  // warpgroup 0 loads
constexpr int BOX = 8192;              // 64 rows of 128 bytes: a K, V or output box
constexpr int Q_BOX = ROWS * 128;
constexpr int Q_STAGES = 1;            // the next item's Q loads once the last S is done

// 2^x on the special-function unit; results below 2^-126 flush to zero
// (probabilities 2^-126 below their row's largest, nothing in an f32 sum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the kernel with KSTEPS k16 steps over the head width:
// NB = 64-column boxes per row.
template <int KSTEPS>
struct Smem {
  static constexpr int NB = (KSTEPS + 3) / 4;
  // A stage is 16 or 32 KB of K and V; D > 96 keeps two to fit 227 KB.
  static constexpr int KV_STAGES = NB == 1 ? 4 : KSTEPS == 8 ? 2 : 3;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = 2 * NB * BOX;  // NB boxes of K, then NB of V
  // Per consumer warpgroup: 64 rows of 16 KSTEPS f32 columns, in boxes of 32.
  static constexpr int OUT_BYTES = KSTEPS / 2 * BOX;
  static constexpr size_t BYTES = 1024 + static_cast<size_t>(Q_STAGES) * Q_BYTES +
                                  static_cast<size_t>(KV_STAGES) * KV_BYTES + CONSUMERS * OUT_BYTES +
                                  (2 * Q_STAGES + 2 * KV_STAGES) * sizeof(uint64_t) +
                                  KV_STAGES * KT * sizeof(float2);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The work item's coordinates; items run (b, h, row tile, chunk), chunk fastest.
struct Item {
  int b, h, rt, t0, t1;
};

__device__ __forceinline__ Item decode(int w, int H, int row_tiles, int chunk_tiles, int chunks,
                                       int tiles) {
  Item it;
  const int c = w % chunks;
  int r = w / chunks;
  it.rt = r % row_tiles;
  r /= row_tiles;
  it.h = r % H;
  it.b = r / H;
  it.t0 = c * chunk_tiles;
  it.t1 = min(tiles, it.t0 + chunk_tiles);
  return it;
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// KSTEPS k16 steps of Q.K^T over the head width (D rounded up to 32); NB =
// 64-column boxes per row.
template <int KSTEPS, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 1) masked_attention_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_out,
    const uint8_t* __restrict__ mask, float* __restrict__ part_o, float* __restrict__ part_ml,
    int B, int S, int K, int H, int D, int c1, int row_tiles, int chunk_tiles, int chunks,
    float scale_log2) {
  using L = Smem<KSTEPS>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = sm90::align1024(smem_raw);         // [Q_STAGES][NB boxes of 128 rows]
  uint8_t* kv_s = q_s + Q_STAGES * L::Q_BYTES;       // [KV_STAGES][K boxes, V boxes]
  uint8_t* out_s = kv_s + L::KV_STAGES * L::KV_BYTES;  // [CONSUMERS][OUT_BYTES]
  // [KV_STAGES][KT] per key (c, b): its logit in log2 units is s c + b.
  float2* key_s = reinterpret_cast<float2*>(out_s + CONSUMERS * L::OUT_BYTES);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(key_s + L::KV_STAGES * KT);
  uint64_t* q_empty = q_full + Q_STAGES;
  uint64_t* kv_full = q_empty + Q_STAGES;
  uint64_t* kv_empty = kv_full + L::KV_STAGES;

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tiles = (K + KT - 1) / KT;
  const int work = B * H * row_tiles * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_STAGES; ++s) {
      sm90::mbar_init(&q_full[s], 1);                  // the producer's expect_tx; TMA bytes complete it
      sm90::mbar_init(&q_empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    for (int s = 0; s < L::KV_STAGES; ++s) {
      sm90::mbar_init(&kv_full[s], 1 + 32);  // expect_tx, and each lane of the key-state warp
      sm90::mbar_init(&kv_empty[s], 4 * CONSUMERS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<24>();
    if (warp == 0) {
      if (lane == 0) {
        int qs = 0, st = 0;
        uint32_t qph = 0, ph = 0;
        for (int w = blockIdx.x; w < work; w += gridDim.x) {
          const Item it = decode(w, H, row_tiles, chunk_tiles, chunks, tiles);
          sm90::mbar_wait(&q_empty[qs], qph ^ 1);
          sm90::mbar_expect_tx(&q_full[qs], L::Q_BYTES);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            sm90::tma_load_4d(q_s + qs * L::Q_BYTES + nb * Q_BOX, &map_q, &q_full[qs], nb * c1,
                              it.h, it.rt * ROWS, it.b);
          }
          advance(qs, qph, Q_STAGES);
          for (int t = it.t0; t < it.t1; ++t) {
            sm90::mbar_wait(&kv_empty[st], ph ^ 1);
            sm90::mbar_expect_tx(&kv_full[st], L::KV_BYTES);
            uint8_t* dst = kv_s + st * L::KV_BYTES;
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              sm90::tma_load_4d(dst + nb * BOX, &map_k, &kv_full[st], nb * c1, it.h, t * KT, it.b);
              sm90::tma_load_4d(dst + (NB + nb) * BOX, &map_v, &kv_full[st], nb * c1, it.h,
                                t * KT, it.b);
            }
            advance(st, ph, L::KV_STAGES);
          }
        }
      }
    } else if (warp == 1) {
      int st = 0;
      uint32_t ph = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x) {
        const Item it = decode(w, H, row_tiles, chunk_tiles, chunks, tiles);
        const uint8_t* mrow = mask == nullptr ? nullptr : mask + static_cast<long long>(it.b) * K;
        for (int t = it.t0; t < it.t1; ++t) {
          sm90::mbar_wait(&kv_empty[st], ph ^ 1);
#pragma unroll
          for (int i = 0; i < KT / 32; ++i) {
            const int key = lane + 32 * i, j = t * KT + key;
            key_s[st * KT + key] = j >= K ? make_float2(0.f, -INFINITY)
                                 : (mrow == nullptr || mrow[j] != 0) ? make_float2(scale_log2, 0.f)
                                                                     : make_float2(0.f, -FLT_MAX);
          }
          sm90::mbar_arrive(&kv_full[st]);  // release: the states are visible with the tile
          advance(st, ph, L::KV_STAGES);
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<160>();
  const int half = wg - 1;  // this warpgroup's 64 query rows of each item
  const int g = lane / 4, t4 = lane % 4;
  uint8_t* stage_out = out_s + half * L::OUT_BYTES;
  const long long rows_total = static_cast<long long>(B) * S * H;
  int qs = 0, st = 0;
  uint32_t qph = 0, ph = 0;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };

  for (int w = blockIdx.x; w < work; w += gridDim.x) {
    const Item it = decode(w, H, row_tiles, chunk_tiles, chunks, tiles);
    const int row_base = it.rt * ROWS + half * 64;
    sm90::mbar_wait(&q_full[qs], qph);
    if (row_base >= S) {  // no live row: hand the stages back unread
      release(&q_empty[qs]);
      for (int t = it.t0; t < it.t1; ++t) {
        sm90::mbar_wait(&kv_full[st], ph);
        release(&kv_empty[st]);
        advance(st, ph, L::KV_STAGES);
      }
      advance(qs, qph, Q_STAGES);
      continue;
    }

    float o[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
    }
    float m_run[2] = {-FLT_MAX, -FLT_MAX};  // rows g, g + 8 of each warp's 16
    float l_run[2] = {0.f, 0.f};            // this thread's share of the denominator
    float alpha[2] = {0.f, 0.f};            // the last softmax's rescale of O
    uint32_t p[KT / 16][4];                 // the tile's P: bf16 A fragments of P.V
    const uint8_t* q_tile = q_s + qs * L::Q_BYTES + half * 64 * 128;

    // S = Q.K^T of the tile in stage `sk`: k16 steps of 32 bytes along the
    // 128-byte rows; the first overwrites s.
    auto issue_s = [&](float (&s)[32], int sk) {
      const uint8_t* k_tile = kv_s + sk * L::KV_BYTES;
      sm90::fence_regs(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {  // columns 16 kk .. +15: box 0, or box 1 from c1
        const int step = kk < 4 ? 2 * kk : (16 * kk - c1) / 8;
        const uint64_t dq = sm90::desc_sw128(q_tile + (kk / 4) * Q_BOX) + step;
        const uint64_t dk = sm90::desc_sw128(k_tile + (kk / 4) * BOX) + step;
        sm90::wgmma_bf16<64>(s, dq, dk, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::fence_regs(s);
    };
    // O = O alpha + P.V of the tile in stage `sv`: four k16 steps of 16 keys
    // (two 8-row groups of V, 2048 bytes), one wgmma per 64-column box.
    auto issue_pv = [&](int sv) {
      const uint8_t* v_tile = kv_s + sv * L::KV_BYTES + NB * BOX;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[nb][4 * j] *= alpha[0];
          o[nb][4 * j + 1] *= alpha[0];
          o[nb][4 * j + 2] *= alpha[1];
          o[nb][4 * j + 3] *= alpha[1];
        }
        sm90::fence_regs(o[nb]);
      }
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) sm90::fence_regs(p[kk]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          sm90::wgmma_rs<64>(o[nb], p[kk], sm90::desc_sw128(v_tile + nb * BOX) + 128 * kk, 1);
        }
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) sm90::fence_regs(o[nb]);
    };
    // The online softmax of the logits of the tile in stage `sk` into pn:
    // scale and mask in one FMA per logit (attend: s scale log2(e); masked:
    // -FLT_MAX; past K: -inf), the rows' maxima (a row lives on the 4 lanes
    // of a quad), alpha, and P = 2^(x - max), f32 into the denominator and
    // bf16 into the A fragments. Fragment kk covers
    // keys 16 kk .. +15: columns j = 2 kk (keys 2t, 2t+1) and j = 2 kk + 1
    // (keys 8 + 2t, +1), rows g and g + 8.
    auto softmax = [&](float (&s)[32], int sk, uint32_t (&pn)[KT / 16][4]) {
      sm90::fence_regs(s);
      const float4* keys = reinterpret_cast<const float4*>(key_s + sk * KT);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 cb = keys[4 * j + t4];  // (c, b) of keys 8j + 2t and 8j + 2t + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = (e & 1) ? fmaf(s[4 * j + e], cb.z, cb.w) : fmaf(s[4 * j + e], cb.x, cb.y);
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2(m_run[r] - mx[r]);
        m_run[r] = mx[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          e[i] = ex2(s[8 * kk + i] - mx[(i >> 1) & 1]);
          l_run[(i >> 1) & 1] += e[i];
        }
        pn[kk][0] = pack_bf16(e[0], e[1]);
        pn[kk][1] = pack_bf16(e[2], e[3]);
        pn[kk][2] = pack_bf16(e[4], e[5]);
        pn[kk][3] = pack_bf16(e[6], e[7]);
      }
    };

    // Per key tile: S = Q.K^T, the softmax, then O = O alpha + P.V. The
    // three warpgroups' tiles interleave on the tensor cores and the
    // special-function units.
    for (int t = it.t0; t < it.t1; ++t) {
      float s[32];
      sm90::mbar_wait(&kv_full[st], ph);
      issue_s(s, st);
      sm90::wgmma_wait<0>();
      if (t == it.t1 - 1) release(&q_empty[qs]);  // the item's last read of Q is done
      softmax(s, st, p);
      issue_pv(st);
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) sm90::fence_regs(o[nb]);
      release(&kv_empty[st]);
      advance(st, ph, L::KV_STAGES);
    }
    advance(qs, qph, Q_STAGES);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const int r_in = warp * 16 + g;  // this thread's first row within the warpgroup's 64

    if (chunks > 1) {  // this chunk's unnormalised O and its (m, l), f32
      const int c = w % chunks;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_base + r_in + 8 * r;
        if (row >= S) continue;
        const long long grow =
            static_cast<long long>(c) * rows_total + (static_cast<long long>(it.b) * S + row) * H + it.h;
        if (t4 == 0) {
          part_ml[2 * grow] = m_run[r];
          part_ml[2 * grow + 1] = l_run[r];
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = nb * c1 + 8 * j + 2 * t4;
            if (col < D && (nb == 0 || col >= 64)) {  // box 1 repeats columns c1 .. 63
              *reinterpret_cast<float2*>(part_o + grow * D + col) =
                  make_float2(o[nb][4 * j + 2 * r], o[nb][4 * j + 2 * r + 1]);
            }
          }
        }
      }
      continue;
    }

    // O / l into this warpgroup's staging tile: column c of row r lies in box
    // c / CB (CB = 32 f32 or 64 bf16 columns of 128 bytes) at 16-byte chunk
    // (c % CB / (CB / 8)) ^ (r % 8); TMA stores write only rows below S and
    // columns below D.
    constexpr int CB = OUT_BF16 ? 64 : 32;
    if (threadIdx.x % 128 == 0) sm90::bulk_wait_read<0>();  // the last item's store has read it
    sm90::named_sync(1 + half, 128);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = nb * c1 + 8 * j + 2 * t4, box = c / CB, chunk = c % CB / (CB / 8);
        // Box 1 repeats columns c1 .. 63; columns from 16 KSTEPS on lie past D.
        if ((nb == 1 && c < 64) || c >= KSTEPS * 16) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r_in + 8 * r;
          const float v0 = o[nb][4 * j + 2 * r] / l_run[r], v1 = o[nb][4 * j + 2 * r + 1] / l_run[r];
          uint8_t* dst = stage_out + box * BOX + row * 128 + ((chunk ^ (row % 8)) * 16);
          if (OUT_BF16) {
            *reinterpret_cast<uint32_t*>(dst + (c % 8) * 2) = pack_bf16(v0, v1);
          } else {
            *reinterpret_cast<float2*>(dst + (c % 4) * 4) = make_float2(v0, v1);
          }
        }
      }
    }
    sm90::fence_proxy_async();  // the generic-proxy stores, visible to TMA
    sm90::named_sync(1 + half, 128);
    if (threadIdx.x % 128 == 0) {
      for (int box = 0; box * CB < D; ++box) {
        sm90::tma_store_4d(&map_out, stage_out + box * BOX, box * CB, it.h, row_base, it.b);
      }
      sm90::bulk_commit();
    }
  }
  if (threadIdx.x % 128 == 0) sm90::bulk_wait<0>();  // the stores are done before the block exits
}

// out[row, :] = sum_c 2^(m_c - M) O_c[row, :] / sum_c 2^(m_c - M) l_c over
// the key chunks, M = max_c m_c (maxima in log2 units); rows are (b, s, h),
// one thread per element.
template <bool OUT_BF16>
__global__ void __launch_bounds__(256) merge_chunks_kernel(const float* __restrict__ part_o,
                                                           const float* __restrict__ part_ml,
                                                           void* __restrict__ out,
                                                           long long rows, int D, int chunks) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * D) return;
  const long long row = i / D;
  const int col = static_cast<int>(i % D);
  float m = -FLT_MAX;
  for (int c = 0; c < chunks; ++c) m = fmaxf(m, part_ml[2 * (c * rows + row)]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const long long cr = c * rows + row;
    const float wgt = exp2f(part_ml[2 * cr] - m);
    l += wgt * part_ml[2 * cr + 1];
    acc += wgt * part_o[cr * D + col];
  }
  const float v = acc / l;
  if (OUT_BF16) {
    __nv_bfloat16 bv = __float2bfloat16_rn(v);
    static_cast<uint16_t*>(out)[i] = *reinterpret_cast<uint16_t*>(&bv);
  } else {
    static_cast<float*>(out)[i] = v;
  }
}

template <int KSTEPS, bool OUT_BF16>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           const CUtensorMap& mo, const void* mask, void* part_o, void* part_ml, int grid, int B,
           int S, int K, int H, int D, int row_tiles, int chunk_tiles, int chunks, float scale_log2,
           cudaStream_t st) {
  auto kernel = masked_attention_kernel<KSTEPS, OUT_BF16>;
  constexpr size_t smem = Smem<KSTEPS>::BYTES;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // Box 1 ends at D where D is a multiple of 32 (a box past D loads slowly),
  // else it starts at column 64 and its tail past D arrives as zeros.
  const int c1 = D > 64 && D % 32 == 0 ? D - 64 : 64;
  kernel<<<grid, THREADS, smem, st>>>(mq, mk, mv, mo, static_cast<const uint8_t*>(mask),
                                      static_cast<float*>(part_o), static_cast<float*>(part_ml), B,
                                      S, K, H, D, c1, row_tiles, chunk_tiles, chunks, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <bool OUT_BF16>
int launch_ksteps(int ksteps, const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                  const CUtensorMap& mo, const void* mask, void* part_o, void* part_ml, int grid,
                  int B, int S, int K, int H, int D, int row_tiles, int chunk_tiles, int chunks,
                  float scale_log2, cudaStream_t st) {
  switch (ksteps) {
    case 2: return launch<2, OUT_BF16>(mq, mk, mv, mo, mask, part_o, part_ml, grid, B, S, K, H, D, row_tiles, chunk_tiles, chunks, scale_log2, st);
    case 4: return launch<4, OUT_BF16>(mq, mk, mv, mo, mask, part_o, part_ml, grid, B, S, K, H, D, row_tiles, chunk_tiles, chunks, scale_log2, st);
    case 6: return launch<6, OUT_BF16>(mq, mk, mv, mo, mask, part_o, part_ml, grid, B, S, K, H, D, row_tiles, chunk_tiles, chunks, scale_log2, st);
    default: return launch<8, OUT_BF16>(mq, mk, mv, mo, mask, part_o, part_ml, grid, B, S, K, H, D, row_tiles, chunk_tiles, chunks, scale_log2, st);
  }
}

}  // namespace

// Returns a cudaError_t: the launches' own error, or cudaErrorInvalidValue for
// arguments the kernels do not take. `grid` persistent blocks walk the
// B * H * ceil(S/128) * chunks work items, chunks = ceil(ceil(K/64) /
// chunk_tiles); with more than one chunk, part_o (f32 [chunks, B*S*H, D]) and
// part_ml (f32 [chunks, B*S*H, 2]) hold the chunks' partial results and a
// second launch merges them into `out`.
extern "C" int tdspa_attention_forward(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, void* part_o, void* part_ml,
                                       int out_bf16, int B, int S, int K, int H, int D,
                                       int chunk_tiles, int grid, float scale, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0 || chunk_tiles < 1 ||
      grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (K + KT - 1) / KT;
  const int row_tiles = (S + ROWS - 1) / ROWS;
  const int chunks = (tiles + chunk_tiles - 1) / chunk_tiles;
  const long long work = static_cast<long long>(B) * H * row_tiles * chunks;
  if (work > 0x7fffffffLL || grid > work ||
      (chunks > 1 && (part_o == nullptr || part_ml == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv, mo;
  int err = sm90::encode_bshd(&mq, BF16, 2, q, B, S, H, D, 64, ROWS);
  if (!err) err = sm90::encode_bshd(&mk, BF16, 2, k, B, K, H, D, 64, KT);
  if (!err) err = sm90::encode_bshd(&mv, BF16, 2, v, B, K, H, D, 64, KT);
  if (!err) {
    err = out_bf16 ? sm90::encode_bshd(&mo, BF16, 2, out, B, S, H, D, 64, 64)
                   : sm90::encode_bshd(&mo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, B, S, H, D, 32, 64);
  }
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  const int ksteps = (D + 31) / 32 * 2;  // k16 steps: D rounded up to 32
  const float scale_log2 = scale * 1.4426950408889634f;
  err = out_bf16 ? launch_ksteps<true>(ksteps, mq, mk, mv, mo, mask, part_o, part_ml, grid, B, S,
                                       K, H, D, row_tiles, chunk_tiles, chunks, scale_log2, st)
                 : launch_ksteps<false>(ksteps, mq, mk, mv, mo, mask, part_o, part_ml, grid, B,
                                        S, K, H, D, row_tiles, chunk_tiles, chunks, scale_log2, st);
  if (err || chunks == 1) return err;
  const long long rows = static_cast<long long>(B) * S * H;
  const long long blocks = (rows * D + 255) / 256;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16) {
    merge_chunks_kernel<true><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        static_cast<const float*>(part_o), static_cast<const float*>(part_ml), out, rows, D, chunks);
  } else {
    merge_chunks_kernel<false><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        static_cast<const float*>(part_o), static_cast<const float*>(part_ml), out, rows, D, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
