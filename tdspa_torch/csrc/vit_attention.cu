// Maskless multi-head attention forward for ViT frames on Hopper (sm_90a).
//
// Replaces the TPU kernel that both ViT backbones (DINOv2 features and the
// VDA depth backbone) run: tdspa/kernels/attention.py `_flash_perhead`
// (pallas_call at :214) with its body `_mha_flash_perhead_kernel` (:138):
//
//   out[b,s,h,:] = softmax_k(q[b,s,h,:] . k[b,k,h,:] * scale) . v[b,k,h,:]
//
// q/k/v are bf16 in the JAX layout [B, S|K, H, 64]; the output is f32 or
// bf16 [B, S, H, 64]. Every DINOv2 preset has a head width of 64, so that is
// the only width this kernel takes. There is no mask: keys past K (the
// ragged last tile) are excluded by index, as the TPU body excludes the
// padded tail of its last KV block from the static kv_len.
//
// Numerics follow the Pallas body: bf16 products with f32 accumulation, the
// logits scaled in f32 after the product, running max / denominator /
// accumulator in f32, P rounded to bf16 before P.V. The exponentials are
// exp2 of the logits times scale * log2(e) less the row's maximum, one fused
// multiply-add, on the special-function unit (ex2.approx.ftz: a probability
// more than 2^126 below its row's largest flushes to zero); the maximum is
// taken on the unscaled logits, which the positive scale leaves in order.
// The TPU body's head-major [B,H,S,D] layout, transposed [KB,S] logits and
// per-head grid exist only to fit VMEM; none of them carries over.
//
// What bounds it on an H100: at the main-path shapes (B=8 frames, S=K=1297
// or 1370 tokens, H=12) a launch does 4*B*H*S*K*64 flops, 41-46 GFLOP,
// against 64-80 MB of q, k, v and output: about 600 flops per byte, above
// the ~295 where bf16 tensor cores rather than memory set the limit. So
// operations bound it (0.042 / 0.047 ms at 989 TFLOP/s). At head width 64 the
// softmax's exponentials (one per logit, on the 16-per-clock special-function
// units) take about as long as the two products on the tensor cores, so the
// design keeps both busy at once and spends few other instructions per logit.
//
// Design (FlashAttention-3's shape): one block per (batch item, head, 128
// query rows), three warpgroups. Warpgroup 0 gives its registers up
// (setmaxnreg) and one of its threads loads Q once and 128-key K and V tiles
// into a 3-stage ring with TMA, guarded by mbarriers. q, k and v are
// described as 3-D tensors [B, S|K, H*64], so rows past a frame's S or K
// arrive as zeros and never as the next frame's tokens. Warpgroups 1 and 2
// own 64 query rows each: S = Q.K^T with wgmma m64n128k16 (Q and K K-major in
// 128-byte-swizzled shared memory), the online softmax in registers, P
// rounded to bf16 in registers as the A operand of wgmma m64n64k16 for P.V
// (V from shared memory as an MN-major B operand). Within a warpgroup, tile
// j's Q.K^T is issued with tile j-1's P.V, and tile j's softmax runs while
// that P.V is still on the tensor cores; across the two warpgroups, one's
// softmax overlaps the other's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int HEAD = 64;      // head width: one 128-byte row per token
constexpr int ROWS = 128;     // query rows per block (two consumer warpgroups of 64)
constexpr int KV_TILE = 128;  // keys per step
constexpr int STAGES = 3;     // K/V ring depth: tile j+1 loads while j-1 and j are in use
constexpr int THREADS = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int TILE_BYTES = 128 * HEAD * 2;  // a Q, K or V tile: 128 rows of 128 bytes
constexpr size_t SMEM_BYTES =
    1024 + static_cast<size_t>(1 + 2 * STAGES) * TILE_BYTES + (1 + 2 * STAGES) * sizeof(uint64_t);

// 2^x on the special-function unit; results below 2^-126 flush to zero
// (probabilities 2^-126 below their row's largest, nothing in an f32 sum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[64 x 128] = Q[64 x 16] . K[128 x 16]^T (+ S when accumulate), bf16 in,
// f32 out; both K-major.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 64] += P[64 x 16] . V[16 x 64], P bf16 in registers (the A
// fragment), V MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 1) vit_attention_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, void* __restrict__ out, int S, int K, int H,
    int q_blocks, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = sm90::align1024(smem_raw);  // [128 rows of 128 B]
  uint8_t* k_s = q_s + TILE_BYTES;           // [STAGES][128 keys of 128 B]
  uint8_t* v_s = k_s + STAGES * TILE_BYTES;  // [STAGES][128 keys of 128 B]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * TILE_BYTES);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int qb = static_cast<int>(blockIdx.x % q_blocks);
  const int h = static_cast<int>((blockIdx.x / q_blocks) % H);
  const int b = static_cast<int>(blockIdx.x / (static_cast<unsigned>(q_blocks) * H));
  const int tiles = (K + KV_TILE - 1) / KV_TILE;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&kv_full[s], 1);   // the producer's expect_tx; TMA bytes complete it
      sm90::mbar_init(&kv_empty[s], 8);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<24>();
    if (warp == 0 && lane == 0) {
      sm90::mbar_expect_tx(q_full, TILE_BYTES);
      sm90::tma_load_3d(q_s, &map_q, q_full, h * HEAD, qb * ROWS, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = 0; tile < tiles; ++tile) {
        sm90::mbar_wait(&kv_empty[stage], phase ^ 1);
        sm90::mbar_expect_tx(&kv_full[stage], 2 * TILE_BYTES);
        sm90::tma_load_3d(k_s + stage * TILE_BYTES, &map_k, &kv_full[stage], h * HEAD,
                          tile * KV_TILE, b);
        sm90::tma_load_3d(v_s + stage * TILE_BYTES, &map_v, &kv_full[stage], h * HEAD,
                          tile * KV_TILE, b);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int half = wg - 1;  // this warpgroup's 64 query rows
  const int g = lane / 4, t = lane % 4;
  // Accumulator fragments: element 4j + e of a thread lies in row
  // 16 warp + g (+8 for e >= 2) of the warpgroup's 64, column 8j + 2t + (e & 1).
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  uint32_t p[KV_TILE / 16][4];  // the previous tile's P, bf16 A fragments of P.V
#pragma unroll
  for (int kk = 0; kk < KV_TILE / 16; ++kk) p[kk][0] = p[kk][1] = p[kk][2] = p[kk][3] = 0u;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8: running max of the raw logits
  float l_run[2] = {0.f, 0.f};              // this thread's share of the denominator
  float alpha[2] = {0.f, 0.f};              // the last softmax's rescale of O

  sm90::mbar_wait(q_full, 0);
  const uint64_t dq = sm90::desc_sw128(q_s + half * 64 * 128);

  // S = Q.K^T of the tile in `st`: four k16 steps of 32 bytes along each row
  // of Q and K; the first overwrites s (scale-d 0).
  auto issue_s = [&](float (&s)[64], int st) {
    const uint64_t dk = sm90::desc_sw128(k_s + st * TILE_BYTES);
    sm90::fence_regs(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HEAD / 16; ++kk) wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    sm90::wgmma_commit();
    sm90::fence_regs(s);
  };
  // O = O alpha + P.V of the tile in `st`: eight k16 steps of 16 keys, each
  // two 8-key groups of V's rows (2048 bytes).
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int j = 0; j < HEAD / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    const uint64_t dv = sm90::desc_sw128(v_s + st * TILE_BYTES);
    sm90::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) sm90::fence_regs(p[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) wgmma_pv(o, p[kk], dv + 128 * kk);
    sm90::wgmma_commit();
    sm90::fence_regs(o);
  };
  // The online softmax of the logits of keys kv0 .. kv0 + 127 into pn.
  auto softmax = [&](float (&s)[64], int kv0, uint32_t (&pn)[KV_TILE / 16][4]) {
    sm90::fence_regs(s);
    // Drop keys past K (the ragged last tile only), then the rows' maxima by
    // a tree over the thread's 32 values of each row and the row's 4 lanes.
    // The scale is positive, so the raw logits' maximum is the scaled ones'.
    if (kv0 + KV_TILE > K) {
#pragma unroll
      for (int j = 0; j < KV_TILE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kv0 + 8 * j + 2 * t + (e & 1) >= K) s[4 * j + e] = -INFINITY;
        }
      }
    }
    float t0[8], t1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      t0[j] = fmaxf(fmaxf(s[4 * j], s[4 * j + 1]), fmaxf(s[4 * j + 32], s[4 * j + 33]));
      t1[j] = fmaxf(fmaxf(s[4 * j + 2], s[4 * j + 3]), fmaxf(s[4 * j + 34], s[4 * j + 35]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      t0[j] = fmaxf(t0[j], t0[j + 4]);
      t1[j] = fmaxf(t1[j], t1[j + 4]);
    }
    float mx[2] = {fmaxf(fmaxf(t0[0], t0[1]), fmaxf(t0[2], t0[3])),
                   fmaxf(fmaxf(t1[0], t1[1]), fmaxf(t1[2], t1[3]))};
    float neg_max[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], m_run[r]);
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2((m_run[r] - mx[r]) * scale_log2);  // 0 on the first tile (m_run = -inf)
      m_run[r] = mx[r];
      neg_max[r] = -mx[r] * scale_log2;
    }
    // P = exp2(S scale log2(e) - max): f32 into the denominator (four
    // partial sums per row), bf16 into the A fragments. Fragment kk covers
    // keys 16 kk .. +15: logit columns j = 2 kk (keys 2t, 2t+1) and
    // j = 2 kk + 1 (keys 8 + 2t, +1), rows g and g + 8.
    float sum0[4] = {0.f, 0.f, 0.f, 0.f}, sum1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) {
      float e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // keys past K: exp2(-inf) = 0
        e[i] = ex2(fmaf(s[8 * kk + i], scale_log2, neg_max[(i >> 1) & 1]));
      }
      sum0[kk % 4] += (e[0] + e[1]) + (e[4] + e[5]);
      sum1[kk % 4] += (e[2] + e[3]) + (e[6] + e[7]);
      pn[kk][0] = pack_bf16(e[0], e[1]);
      pn[kk][1] = pack_bf16(e[2], e[3]);
      pn[kk][2] = pack_bf16(e[4], e[5]);
      pn[kk][3] = pack_bf16(e[6], e[7]);
    }
    l_run[0] = l_run[0] * alpha[0] + ((sum0[0] + sum0[1]) + (sum0[2] + sum0[3]));
    l_run[1] = l_run[1] * alpha[1] + ((sum1[0] + sum1[1]) + (sum1[2] + sum1[3]));
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&kv_empty[st]);
  };

  // Within a warpgroup, tile j's S = Q.K_j is issued together with tile
  // j-1's P.V, and tile j's softmax runs while that P.V is still on the
  // tensor cores. Across the two, named barriers 1 and 2 hand the tensor
  // cores back and forth (warpgroup 1 first): one issues its products while
  // the other runs its softmax. The first and last tiles are peeled off, so
  // the loop issues its wgmmas on every pass.
  const int own_bar = 1 + half, other_bar = 2 - half;
  if (half == 1) sm90::named_arrive(1, 256);
  int stage = 0, prev_stage = 0;
  uint32_t phase = 0;
  {
    float s[64];
    sm90::mbar_wait(&kv_full[0], 0);
    sm90::named_sync(own_bar, 256);
    issue_s(s, 0);
    sm90::named_arrive(other_bar, 256);
    sm90::wgmma_wait<0>();
    softmax(s, 0, p);
    stage = 1 % STAGES;
  }
  for (int tile = 1; tile < tiles; ++tile) {
    float s[64];
    uint32_t pn[KV_TILE / 16][4];
    sm90::mbar_wait(&kv_full[stage], phase);
    sm90::named_sync(own_bar, 256);
    issue_s(s, stage);
    issue_pv(prev_stage);
    sm90::named_arrive(other_bar, 256);
    sm90::wgmma_wait<1>();  // S is done; P.V of the previous tile may still run
    softmax(s, tile * KV_TILE, pn);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) sm90::fence_regs(p[kk]);
    release(prev_stage);
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[kk][i] = pn[kk][i];
    }
    prev_stage = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  sm90::named_sync(own_bar, 256);
  issue_pv(prev_stage);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  release(prev_stage);
  if (half == 0) sm90::named_arrive(other_bar, 256);  // warpgroup 2's last turn

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const long long row_stride = static_cast<long long>(H) * HEAD;  // elements per token
  const int row0 = qb * ROWS + half * 64 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const long long base = (static_cast<long long>(b) * S + row) * row_stride + h * HEAD;
#pragma unroll
    for (int j = 0; j < HEAD / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float o0 = o[4 * j + 2 * r] / l_run[r], o1 = o[4 * j + 2 * r + 1] / l_run[r];
      if (OUT_BF16) {
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(out) + base + c) = pack_bf16(o0, o1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + base + c) = make_float2(o0, o1);
      }
    }
  }
}

template <bool OUT_BF16>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out, int S,
           int K, int H, int q_blocks, float scale_log2, unsigned blocks, cudaStream_t st) {
  auto kernel = vit_attention_kernel<OUT_BF16>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<blocks, THREADS, SMEM_BYTES, st>>>(mq, mk, mv, out, S, K, H, q_blocks, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// arguments the kernel does not take. `q_blocks` blocks of 128 query rows per
// (item, head): q_blocks * 128 >= S. `scale` is the softmax scale (1/sqrt(D)).
extern "C" int tdspa_vit_attention_forward(const void* q, const void* k, const void* v, void* out,
                                           int out_bf16, int B, int S, int K, int H, int D,
                                           int q_blocks, float scale, void* stream) {
  const long long blocks = static_cast<long long>(B) * H * q_blocks;
  if (B < 1 || S < 1 || K < 1 || H < 1 || D != HEAD || q_blocks < 1 ||
      static_cast<long long>(q_blocks) * ROWS < S || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // [B, S|K, H*64] bf16, innermost first; rows are H*128 bytes apart.
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(H) * HEAD * 2;
  const cuuint64_t dims_q[3] = {static_cast<cuuint64_t>(H) * HEAD, static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t dims_kv[3] = {static_cast<cuuint64_t>(H) * HEAD, static_cast<cuuint64_t>(K),
                                 static_cast<cuuint64_t>(B)};
  const cuuint64_t strides_q[2] = {row_bytes, row_bytes * S};
  const cuuint64_t strides_kv[2] = {row_bytes, row_bytes * K};
  const cuuint32_t box[3] = {HEAD, 128, 1};
  CUtensorMap mq, mk, mv;
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = sm90::encode_sw128(&mq, BF16, 3, q, dims_q, strides_q, box);
  if (!err) err = sm90::encode_sw128(&mk, BF16, 3, k, dims_kv, strides_kv, box);
  if (!err) err = sm90::encode_sw128(&mv, BF16, 3, v, dims_kv, strides_kv, box);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto n = static_cast<unsigned>(blocks);
  return out_bf16 ? launch<true>(mq, mk, mv, out, S, K, H, q_blocks, scale_log2, n, st)
                  : launch<false>(mq, mk, mv, out, S, K, H, q_blocks, scale_log2, n, st);
}
