// One unmasked self-attention ParallelTransformerBlock layer for Hopper (sm_90a).
//
// Replaces tdspa/kernels/block.py `_block_forward` (body `_block_kernel`):
//
//   ln1 = LayerNorm(bf16(x)) * g1                      -> bf16
//   q   = RMSNorm_head(ln1 . Wq) * sq, k likewise      -> bf16;  v = ln1 . Wv -> bf16
//   att = softmax(q . k^T * scale) . v                 (P normalised, then bf16) -> bf16
//   y   = (x + att . Wo) + bo                          f32
//   ln2 = LayerNorm(y) * g2                            -> bf16
//   hid = GELU_tanh(ln2 . W1 + b1)                     -> bf16
//   out = y + (hid . W2 + b2)                          f32 or bf16
//
// Every operand is bf16 (weights given transposed, [out, in]); products are
// bf16 with f32 accumulation; LayerNorm takes the two-pass variance;
// statistics and residual sums are f32, as in the TPU body.
//
// The TPU body keeps one item and ~16 MB of weights in VMEM. An SM has 228 KB
// of shared memory, less than one readout item (129 x 1280 bf16 = 330 KB), so
// the layer runs as seven launches on one stream (tdspa_block_forward):
//   1. layernorm_kernel  x -> ln1 (and x rounded to bf16, the residual)
//   2. qkv_gemm_kernel   ln1 . Wqkv -> qkv [rows, 3 H Dh]; each N tile holds
//      whole heads (192 columns for Dh = 96, else 128), so the RMSNorm
//      epilogue sees each head's row: q, k normalised, v as is
//   3. block_attention_kernel  softmax(q k^T) v per (item, head), all S <= 256
//      keys in one pass, q, k and v loaded once
//   4. gemm_pp_kernel<RESID>  att . Wo + residual + bias -> y (f32)
//   5. layernorm_kernel  y -> ln2
//   6. gemm_pp_kernel<GELU>  ln2 . W1 + b1, tanh GELU -> hid (bf16)
//   7. gemm_pp_kernel<OUT>  hid . W2 + b2 + y -> out
//
// LayerNorm: a streaming pass, two rows per warp, each row held in registers
// (8 columns a lane per 256-column step, 16-byte loads and stores), so x is
// read from device memory once for the mean, the two-pass variance and the
// output. Rows wider than LN_MAX_STEPS steps read their tail again.
//
// GEMMs: persistent, one block per SM walking output tiles, the N tiles of a
// row stripe back to back so that the stripe stays in L2. One thread keeps
// TMA loads of the activation [rows, 64] and weight [BN, 64] tiles (both
// K-major, 128-byte rows, 128-byte swizzle; every K here is a multiple of 8,
// and the tail past K arrives as zeros) in flight through a 4-stage mbarrier
// ring, and the consumers run wgmma m64nBNk16 bf16 -> f32, keeping one
// stage's group in flight while the next is issued.
//   - The Q/K/V GEMM is cooperative: warpgroup 0 loads and gives its
//     registers up (setmaxnreg), warpgroups 1 and 2 take 64 rows each of
//     every 128 x BN tile.
//   - The other three are ping-pong: warpgroups 0 and 1 take the block's
//     tiles in turn (128 x 128, or 64 x 128 where 128-row tiles would leave
//     SMs idle) and a producer warp loads, so that one warpgroup's epilogue
//     runs under the other's wgmmas; an order barrier alternates their main
//     loops. Each warpgroup loads its tile's residual (bf16 x, or f32 y) with
//     TMA into its epilogue buffer, the first 64-row half under its main loop.
// The epilogue applies the stage's function in f32 in a 128-byte-swizzled
// staging tile and writes it with TMA stores, which clip at M and N and drain
// while the warpgroup goes on. ptxas sizes a kernel's registers for whole
// warpgroups: 168 a thread at 384 threads (the ping-pong's 288 count as 384).
//
// Attention: a persistent grid walks (item, head) work items. Thread 0 loads
// q, k and v of the item's head with TMA straight out of the qkv buffer (a
// 3-D tensor map over [N, S, 3 H Dh]: a box of 32 columns of one head and all
// 64 ceil(S / 64) rows, 64-byte rows, 64-byte swizzle; rows past S arrive as
// zeros), each once, into one of two buffers where two fit, so that the next
// item's loads run under this one's products. Warpgroups of 64 query rows (a
// fourth slab goes to the first again): S = q k^T with wgmma m64n64k16 per 64
// keys, every logit of the row kept in registers; the exact row max and sum;
// P = 2^(s - max) / sum normalised before its rounding to bf16 (the TPU
// body's order); then O = P . V with P as the register A operand (V N-major,
// one wgmma m64nDhk16 per 16 keys). O is staged as bf16 in the slab's own
// rows of q's tile and written out with TMA stores.
//
// What bounds it on an H100: at the readout shape (66,048 rows of 1280,
// MLP 1536) the layer does about 1.07 TFLOP of bf16 products against about
// 0.7 GB of input and output, over 1000 operations per byte: the tensor
// cores bound the whole layer. Stage by stage, the LayerNorms and the
// attention stage are bound by device-memory bytes, the GEMMs by operations
// or by bytes within a factor of 1.4; the GEMMs' 128-row tiles read their A
// and B operands from L2 at 8.3-8.7 TB/s, which holds them above either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float EPS = 1e-6f;

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f32(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f32(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 2^x on the special-function unit (2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x / d with rinv the correctly rounded 1 / d: the product and one fma
// correction (Markstein), the correctly rounded quotient but for rare ties.
__device__ __forceinline__ float div_by(float x, float d, float rinv) {
  const float q = x * rinv;
  return fmaf(fmaf(-q, d, x), rinv, q);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// ---------------------------------------------------------------------------
// LayerNorm, bias-free, two-pass variance. Each warp takes LN_ROWS rows; lane
// l holds columns 256 i + 8 l .. +7 of step i in registers.
// X_BF16: the input is bf16; ROUND: round an f32 input to bf16 first (the
// block's entry cast) and write the rounded row to `xb` (the residual).
constexpr int LN_THREADS = 256;
constexpr int LN_ROWS = 2;
constexpr int LN_COLS = 256;      // columns per step: 8 a lane
constexpr int LN_MAX_STEPS = 8;   // rows up to 2048 wide stay in registers

template <bool X_BF16, bool ROUND>
__device__ __forceinline__ void ln_load(const void* x, long long off, float (&v)[8]) {
  if constexpr (X_BF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(x) + off);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = lo_f32(w[i]);
      v[2 * i + 1] = hi_f32(w[i]);
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(x) + off);
    const float4 a = p[0], b = p[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    if (ROUND) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = round_bf16(v[i]);
    }
  }
}

// One step of 8 values out: ((v - mean) * rstd) * g as bf16, and the rounded
// input to xb when ROUND.
template <bool ROUND>
__device__ __forceinline__ void ln_store(const float (&v)[8], float mean, float rstd,
                                         const uint16_t* g, uint16_t* xb, uint16_t* out,
                                         long long off, int c) {
  const uint4 gu = *reinterpret_cast<const uint4*>(g + c);
  const uint32_t gw[4] = {gu.x, gu.y, gu.z, gu.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = pack_bf16(((v[2 * i] - mean) * rstd) * lo_f32(gw[i]),
                     ((v[2 * i + 1] - mean) * rstd) * hi_f32(gw[i]));
  }
  *reinterpret_cast<uint4*>(out + off) = make_uint4(o[0], o[1], o[2], o[3]);
  if (ROUND) {
    *reinterpret_cast<uint4*>(xb + off) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                   pack_bf16(v[6], v[7]));
  }
}

template <int NV, bool X_BF16, bool ROUND>
__global__ void __launch_bounds__(LN_THREADS, 1) layernorm_kernel(
    const void* __restrict__ x, const uint16_t* __restrict__ g, uint16_t* __restrict__ xb,
    uint16_t* __restrict__ out, int R, int C) {
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32) * LN_ROWS;
  if (row0 >= R) return;
  const int steps = (C + LN_COLS - 1) / LN_COLS;  // > NV only past LN_MAX_STEPS
  float v[LN_ROWS][NV][8];
  float mean[LN_ROWS], rstd[LN_ROWS];
  auto live = [&](int r, int i) { return row0 + r < R && i * LN_COLS + 8 * lane < C; };
  auto at = [&](int r, int i) {
    return static_cast<long long>(row0 + r) * C + i * LN_COLS + 8 * lane;
  };
#pragma unroll
  for (int r = 0; r < LN_ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live(r, i)) {
        ln_load<X_BF16, ROUND>(x, at(r, i), v[r][i]);
      } else {
        zero(v[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < LN_ROWS; ++r) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[r][i][e];
    }
    for (int i = NV; i < steps; ++i) {
      if (!live(r, i)) continue;
      float t[8];
      ln_load<X_BF16, ROUND>(x, at(r, i), t);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += t[e];
    }
    mean[r] = warp_sum(s) / static_cast<float>(C);
  }
#pragma unroll
  for (int r = 0; r < LN_ROWS; ++r) {
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (!live(r, i)) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[r][i][e] - mean[r];
        s2 += d * d;
      }
    }
    for (int i = NV; i < steps; ++i) {
      if (!live(r, i)) continue;
      float t[8];
      ln_load<X_BF16, ROUND>(x, at(r, i), t);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = t[e] - mean[r];
        s2 += d * d;
      }
    }
    rstd[r] = rsqrtf(warp_sum(s2) / static_cast<float>(C) + EPS);
  }
#pragma unroll
  for (int r = 0; r < LN_ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live(r, i)) ln_store<ROUND>(v[r][i], mean[r], rstd[r], g, xb, out, at(r, i), i * LN_COLS + 8 * lane);
    }
    for (int i = NV; i < steps; ++i) {
      if (!live(r, i)) continue;
      float t[8];
      ln_load<X_BF16, ROUND>(x, at(r, i), t);
      ln_store<ROUND>(t, mean[r], rstd[r], g, xb, out, at(r, i), i * LN_COLS + 8 * lane);
    }
  }
}

template <int NV, bool X_BF16, bool ROUND>
int layernorm_nv(const void* x, const uint16_t* g, uint16_t* xb, uint16_t* out, int R, int C,
                 cudaStream_t st) {
  constexpr int rows_per_block = LN_THREADS / 32 * LN_ROWS;
  layernorm_kernel<NV, X_BF16, ROUND>
      <<<(R + rows_per_block - 1) / rows_per_block, LN_THREADS, 0, st>>>(x, g, xb, out, R, C);
  return static_cast<int>(cudaGetLastError());
}

// The launch with NV = the row's steps, at most LN_MAX_STEPS.
template <bool X_BF16, bool ROUND>
int layernorm(const void* x, const uint16_t* g, uint16_t* xb, uint16_t* out, int R, int C,
              cudaStream_t st) {
  const int steps = (C + LN_COLS - 1) / LN_COLS;
  switch (steps < LN_MAX_STEPS ? steps : LN_MAX_STEPS) {
    case 1: return layernorm_nv<1, X_BF16, ROUND>(x, g, xb, out, R, C, st);
    case 2: return layernorm_nv<2, X_BF16, ROUND>(x, g, xb, out, R, C, st);
    case 3: return layernorm_nv<3, X_BF16, ROUND>(x, g, xb, out, R, C, st);
    case 4: return layernorm_nv<4, X_BF16, ROUND>(x, g, xb, out, R, C, st);
    case 5: return layernorm_nv<5, X_BF16, ROUND>(x, g, xb, out, R, C, st);
    case 6: return layernorm_nv<6, X_BF16, ROUND>(x, g, xb, out, R, C, st);
    case 7: return layernorm_nv<7, X_BF16, ROUND>(x, g, xb, out, R, C, st);
    default: return layernorm_nv<LN_MAX_STEPS, X_BF16, ROUND>(x, g, xb, out, R, C, st);
  }
}

// ---------------------------------------------------------------------------
// GEMMs: C[M, N] = A[M, K] . Bt[N, K]^T with an epilogue. A and Bt bf16,
// row-major, both K-major operands; the output goes through a 2-D tensor map
// over [M, N] (bf16 or f32).
enum Epi { EPI_RESID = 1, EPI_GELU = 2, EPI_OUT = 3 };

constexpr int GBM = 128;        // rows per tile
constexpr int GBK = 64;         // K per stage: one 128-byte swizzled row of bf16 per tile row
constexpr int G_STAGES = 4;     // depth of the Q/K/V GEMM's TMA ring
constexpr int G_THREADS = 384;  // Q/K/V GEMM: warpgroup 0 loads, warpgroups 1 and 2 compute
// Ping-pong GEMMs: warpgroups 0 and 1 compute, one producer warp loads.
// Registers are sized for whole warpgroups, by ptxas and by the launch: 168 a
// thread, as at 384 (a 224-register cap fails to launch). A 128 x 128 tile's
// 128 accumulators leave the epilogue little room: ptxas spills up to 128
// bytes a thread there. With the loads issued by the consumers instead (255
// registers, no spills) the three GEMMs ran slower on an H100: a consumer's
// leader then waits for its warpgroup at every stage it refills.
constexpr int PP_THREADS = 256 + 32;

template <int BN>
constexpr size_t qkv_smem_bytes() {
  return 1024 + static_cast<size_t>(G_STAGES) * (GBM + BN) * 128 +
         2 * static_cast<size_t>(64) * BN * 2 + 2 * G_STAGES * sizeof(uint64_t);
}

// The Q/K/V product, cooperative: warpgroups 1 and 2 take 64 rows each of a
// 128 x BN tile, BN a whole number of heads (DH each), so that the RMSNorm
// sees each head's row in one tile. q and k (the first 2 H DH columns) are
// RMS-normalised per head and scaled by sq, sk; v passes as is; bf16 out.
template <int BN, int DH>
__global__ void __launch_bounds__(G_THREADS, 1) qkv_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_out, int M, int N, int K,
    const uint16_t* __restrict__ sq, const uint16_t* __restrict__ sk, int heads) {
  constexpr int CB = 64;               // bf16 output columns per 128-byte box
  constexpr int STAGE_OUT = 64 * BN * 2;  // a warpgroup's 64 x BN output tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = sm90::align1024(smem_raw);  // [G_STAGES][GBM rows of 128 B]
  uint8_t* b_s = a_s + G_STAGES * GBM * 128;  // [G_STAGES][BN rows of 128 B]
  uint8_t* o_s = b_s + G_STAGES * BN * 128;   // [2 warpgroups][STAGE_OUT]
  uint64_t* full = reinterpret_cast<uint64_t*>(o_s + 2 * STAGE_OUT);
  uint64_t* empty = full + G_STAGES;

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);   // the producer's expect_tx; TMA bytes complete it
      sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + GBM - 1) / GBM * n_tiles;
  const int k_steps = (K + GBK - 1) / GBK;

  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (warp == 0 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * GBM, n0 = tile % n_tiles * BN;
        for (int ks = 0; ks < k_steps; ++ks) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          sm90::mbar_expect_tx(&full[stage], (GBM + BN) * 128);
          sm90::tma_load_2d(a_s + stage * GBM * 128, &map_a, &full[stage], ks * GBK, m0);
          sm90::tma_load_2d(b_s + stage * BN * 128, &map_b, &full[stage], ks * GBK, n0);
          advance(stage, phase, G_STAGES);
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  const int half = wg - 1;  // this warpgroup's 64 rows of the tile
  const int g = lane / 4, t = lane % 4;
  uint8_t* stage_out = o_s + half * STAGE_OUT;
  int stage = 0;
  uint32_t phase = 0;
  float acc[BN / 2];  // each tile's first k-step overwrites it
  zero(acc);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * GBM, n0 = tile % n_tiles * BN;
    // One group of wgmmas stays in flight: stage ks is released once stage
    // ks + 1's group is issued and ks's has completed.
    int prev = stage;
    for (int ks = 0; ks < k_steps; ++ks) {
      sm90::mbar_wait(&full[stage], phase);
      const uint64_t da = sm90::desc_sw128(a_s + stage * GBM * 128 + half * 64 * 128);
      const uint64_t db = sm90::desc_sw128(b_s + stage * BN * 128);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < GBK / 16; ++k) {  // k16 steps: +32 bytes along the swizzled rows
        sm90::wgmma_bf16<BN>(acc, da + 2 * k, db + 2 * k, ks > 0 || k > 0);
      }
      sm90::wgmma_commit();
      sm90::fence_regs(acc);
      if (ks > 0) {
        sm90::wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[prev]);
      }
      prev = stage;
      advance(stage, phase, G_STAGES);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[prev]);

    // acc[4j + e]: row 16 warp + g (+8 for e >= 2), column 8j + 2t + (e & 1).
    // Each head's RMSNorm factor per row (q and k only), from the sum of
    // squares over the thread's columns of the head and its quad's.
    constexpr int HP = BN / DH, JH = DH / 8;
    float mul[HP][2];
#pragma unroll
    for (int hh = 0; hh < HP; ++hh) {
      float ss[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < JH; ++jj) {
        const int j = hh * JH + jj;
        ss[0] += acc[4 * j] * acc[4 * j] + acc[4 * j + 1] * acc[4 * j + 1];
        ss[1] += acc[4 * j + 2] * acc[4 * j + 2] + acc[4 * j + 3] * acc[4 * j + 3];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
        mul[hh][h] = rsqrtf(ss[h] / static_cast<float>(DH) + EPS);
      }
    }

    // Into this warpgroup's staging tile, where column c of row r lies in box
    // c / CB at 16-byte chunk (c % CB / 8) ^ (r % 8); the TMA store writes
    // only the rows below M and columns below N.
    if (threadIdx.x % 128 == 0) sm90::bulk_wait_read<0>();  // the last tile's store has read it
    sm90::named_sync(1 + half, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const int hh = j / (DH / 8);
      const int which = (n0 + hh * DH) / (heads * DH);  // 0 q, 1 k, 2 v
      float p0 = 1.f, p1 = 1.f, m[2] = {1.f, 1.f};
      if (which < 2) {
        const uint16_t* scale = which == 0 ? sq : sk;
        p0 = bf16_to_f32(scale[c - hh * DH]);
        p1 = bf16_to_f32(scale[c - hh * DH + 1]);
        m[0] = mul[hh][0];
        m[1] = mul[hh][1];
      }
      const int box = c / CB, chunk = c % CB / 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const float o0 = (acc[4 * j + 2 * h] * m[h]) * p0;
        const float o1 = (acc[4 * j + 2 * h + 1] * m[h]) * p1;
        uint8_t* dst = stage_out + box * 64 * 128 + r * 128 + ((chunk ^ (r % 8)) * 16);
        *reinterpret_cast<uint32_t*>(dst + (c % 8) * 2) = pack_bf16(o0, o1);
      }
    }
    sm90::fence_proxy_async();  // the generic-proxy stores, visible to TMA
    sm90::named_sync(1 + half, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int box = 0; box < BN / CB; ++box) {
        if (n0 + box * CB < N) {
          sm90::tma_store_2d(&map_out, stage_out + box * 64 * 128, n0 + box * CB, m0 + half * 64);
        }
      }
      sm90::bulk_commit();
    }
  }
  if (threadIdx.x % 128 == 0) sm90::bulk_wait<0>();  // the stores are done before the block exits
}

// The ping-pong GEMMs. Warpgroups 0 and 1 take the block's tiles in turn, MH
// 64-row halves each (MH = 2: 128 x 128 tiles, two wgmma m64n128k16 per k16
// step; MH = 1, 64 x 128 tiles, where 128-row tiles would leave SMs idle),
// and the first thread of warpgroup 2 keeps the ring's TMA loads in flight.
// Each warpgroup has an epilogue buffer of HALF bytes in 8 KB boxes of 64 rows
// x 128 bytes: the f32 output or f32 residual in boxes of 32 columns from
// byte 0, the bf16 output in boxes of 64 columns from byte 0, the bf16
// residual in boxes of 64 columns from byte 16384. Its first thread loads a
// half's residual into it with TMA: a tile's first half while the main loop
// runs, the second once the first half's stores have read the buffer (under
// the other warpgroup's main loop). The epilogue takes PIECE columns at a time;
// each thread reads their residual before any thread of its warpgroup writes
// their output (named barrier), and no output lands on residual columns still
// to be read (output column c lands on residual columns below c, or, f32 on
// f32, on c itself), so it may overwrite what was read.
template <int EPI, bool OUT_BF16, int MH>
struct PingPong {
  static constexpr int BM = 64 * MH, BN = 128;
  static constexpr bool RESID = EPI != EPI_GELU;  // a residual tile to load
  static constexpr bool RESID_F32 = EPI == EPI_OUT;
  static constexpr int HALF = RESID || !OUT_BF16 ? 32768 : 16384;
  static constexpr int RESID_BYTES = RESID_F32 ? 32768 : 16384;
  // Epilogue columns per step: 16 keep the f32 residual's registers beside
  // the accumulators without spilling; 32 need fewer barriers.
  static constexpr int PIECE = RESID_F32 ? 16 : 32;
  static constexpr int STAGES = 4;
  static constexpr size_t BYTES = 1024 + static_cast<size_t>(STAGES) * (BM + BN) * 128 +
                                  2 * static_cast<size_t>(HALF) + (2 * STAGES + 4) * sizeof(uint64_t);
};

// A 128-byte-swizzled tile's descriptor built where it is used (see desc_k).
__device__ __forceinline__ uint64_t desc_sw128_at(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return sm90::desc(addr, 1, 1024, 1024);
}

template <int EPI, bool OUT_BF16, int MH>
__global__ void __launch_bounds__(PP_THREADS, 1) gemm_pp_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_out, const __grid_constant__ CUtensorMap map_resid,
    int M, int N, int K, const uint16_t* __restrict__ bias) {
  using P = PingPong<EPI, OUT_BF16, MH>;
  constexpr int BM = P::BM, BN = P::BN, STAGES = P::STAGES, HALF = P::HALF;
  constexpr int CB = OUT_BF16 ? 64 : 32;  // output columns per 128-byte box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = sm90::align1024(smem_raw);  // [STAGES][BM rows of 128 B]
  uint8_t* b_s = a_s + STAGES * BM * 128;     // [STAGES][BN rows of 128 B]
  uint8_t* e_s = b_s + STAGES * BN * 128;     // [2 warpgroups][HALF]
  uint64_t* full = reinterpret_cast<uint64_t*>(e_s + 2 * HALF);
  uint64_t* empty = full + STAGES;
  uint64_t* eb_full = empty + STAGES;  // [2]: a warpgroup's residual half has landed
  // [2]: a warpgroup has seen every stage of its tile land. The other waits
  // for that before its next tile: the two share the ring but each skips the
  // other's stages, and without the order a warpgroup could wait on a stage
  // whose previous use has not landed yet, where the phase parity it waits
  // for reads as complete.
  uint64_t* order = eb_full + 2;

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    for (int w = 0; w < 2; ++w) {
      sm90::mbar_init(&eb_full[w], 1);
      sm90::mbar_init(&order[w], 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int k_steps = (K + GBK - 1) / GBK;

  if (wg == 2) {  // the producer warp: one thread issues the loads
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        for (int ks = 0; ks < k_steps; ++ks) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          sm90::mbar_expect_tx(&full[stage], (BM + BN) * 128);
          sm90::tma_load_2d(a_s + stage * BM * 128, &map_a, &full[stage], ks * GBK, m0);
          sm90::tma_load_2d(b_s + stage * BN * 128, &map_b, &full[stage], ks * GBK, n0);
          advance(stage, phase, STAGES);
        }
      }
    }
    return;
  }

  const int w = wg;
  const int g = lane / 4, t = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  uint8_t* e = e_s + w * HALF;
  // Rows m of the residual into the buffer (the leader, once the buffer's
  // last stores have read it).
  auto load_resid = [&](int m, int n0) {
    sm90::bulk_wait_read<0>();
    sm90::mbar_expect_tx(&eb_full[w], P::RESID_BYTES);
    if constexpr (P::RESID_F32) {
#pragma unroll
      for (int bx = 0; bx < 4; ++bx) {
        sm90::tma_load_2d(e + bx * 8192, &map_resid, &eb_full[w], n0 + 32 * bx, m);
      }
    } else {
#pragma unroll
      for (int bx = 0; bx < 2; ++bx) {
        sm90::tma_load_2d(e + 16384 + bx * 8192, &map_resid, &eb_full[w], n0 + 64 * bx, m);
      }
    }
  };
  int n_resid = 0;  // this warpgroup's residual halves so far
  float acc[MH][BN / 2];
#pragma unroll
  for (int h = 0; h < MH; ++h) zero(acc[h]);
  for (int i = w;; i += 2) {
    const long long tile_l = blockIdx.x + static_cast<long long>(i) * gridDim.x;
    if (tile_l >= tiles) break;
    const int tile = static_cast<int>(tile_l);
    const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
    if (P::RESID && leader) load_resid(m0, n0);
    // The ring position of this tile's first stage: the block's tiles
    // before it took k_steps stages each.
    const int n_first = i * k_steps;
    if (i > 0) sm90::mbar_wait(&order[1 - w], ((i - 1) / 2) & 1);  // tile i - 1's stages landed
    int prev = 0;
    for (int ks = 0; ks < k_steps; ++ks) {
      const int stage = (n_first + ks) % STAGES;
      sm90::mbar_wait(&full[stage], ((n_first + ks) / STAGES) & 1);
      if (ks == k_steps - 1 && leader) sm90::mbar_arrive(&order[w]);
      const uint32_t a_at = sm90::smem_u32(a_s + stage * BM * 128);
      const uint32_t b_at = sm90::smem_u32(b_s + stage * BN * 128);
#pragma unroll
      for (int h = 0; h < MH; ++h) sm90::fence_regs(acc[h]);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < GBK / 16; ++k) {  // k16 steps: +32 bytes along the swizzled rows
#pragma unroll
        for (int h = 0; h < MH; ++h) {      // rows 64 h .. +63: 64 rows of 128 bytes further
          sm90::wgmma_bf16<BN>(acc[h], desc_sw128_at(a_at + h * 64 * 128 + 32 * k),
                               desc_sw128_at(b_at + 32 * k), ks > 0 || k > 0);
        }
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int h = 0; h < MH; ++h) sm90::fence_regs(acc[h]);
      if (ks > 0) {
        sm90::wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[prev]);
      }
      prev = stage;
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < MH; ++h) sm90::fence_regs(acc[h]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[prev]);

    // acc[h][4j + e]: row 64 h + 16 warp + g (+8 for e >= 2), column 8j + 2t + (e & 1).
#pragma unroll
    for (int h = 0; h < MH; ++h) {
      if constexpr (P::RESID) {
        sm90::mbar_wait(&eb_full[w], n_resid & 1);
        ++n_resid;
      } else {
        if (leader) sm90::bulk_wait_read<0>();  // the last stores have read the buffer
        sm90::named_sync(1 + w, 128);
      }
#pragma unroll
      for (int qc = 0; qc < BN / P::PIECE; ++qc) {  // PIECE columns at a time
        constexpr int JP = P::PIECE / 8;
        float res[JP][2][2];
        if constexpr (P::RESID) {
#pragma unroll
          for (int jj = 0; jj < JP; ++jj) {
            const int c = 8 * (JP * qc + jj) + 2 * t;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = warp * 16 + g + 8 * r;
              if constexpr (P::RESID_F32) {
                const float2 y = *reinterpret_cast<const float2*>(
                    e + (c / 32) * 8192 + row * 128 + (((c % 32 / 4) ^ (row % 8)) * 16) + (c % 4) * 4);
                res[jj][r][0] = y.x;
                res[jj][r][1] = y.y;
              } else {
                const uint32_t xr = *reinterpret_cast<const uint32_t*>(
                    e + 16384 + (c / 64) * 8192 + row * 128 + (((c % 64 / 8) ^ (row % 8)) * 16) +
                    (c % 8) * 2);
                res[jj][r][0] = lo_f32(xr);
                res[jj][r][1] = hi_f32(xr);
              }
            }
          }
          sm90::named_sync(1 + w, 128);  // read before any output overwrites it
        }
#pragma unroll
        for (int jj = 0; jj < JP; ++jj) {
          const int j = JP * qc + jj, c = 8 * j + 2 * t;
          const uint32_t bp = n0 + c < N ? *reinterpret_cast<const uint32_t*>(bias + n0 + c) : 0u;
          const float p0 = lo_f32(bp), p1 = hi_f32(bp);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;
            float o0 = acc[h][4 * j + 2 * r], o1 = acc[h][4 * j + 2 * r + 1];
            if constexpr (EPI == EPI_RESID) {  // y = (x + att . Wo) + bo
              o0 = (res[jj][r][0] + o0) + p0;
              o1 = (res[jj][r][1] + o1) + p1;
            } else if constexpr (EPI == EPI_GELU) {  // x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
              float v[2] = {o0 + p0, o1 + p1};
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const float x = v[q];
                const float cdf = 0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
                v[q] = x * cdf;
              }
              o0 = v[0];
              o1 = v[1];
            } else {  // EPI_OUT: out = y + (hid . W2 + b2)
              o0 = res[jj][r][0] + (o0 + p0);
              o1 = res[jj][r][1] + (o1 + p1);
            }
            uint8_t* dst = e + (c / CB) * 8192 + row * 128 + (((c % CB / (CB / 8)) ^ (row % 8)) * 16);
            if constexpr (OUT_BF16) {
              *reinterpret_cast<uint32_t*>(dst + (c % 8) * 2) = pack_bf16(o0, o1);
            } else {
              *reinterpret_cast<float2*>(dst + (c % 4) * 4) = make_float2(o0, o1);
            }
          }
        }
      }
      sm90::fence_proxy_async();  // the generic-proxy stores, visible to TMA
      sm90::named_sync(1 + w, 128);
      if (leader) {
#pragma unroll
        for (int box = 0; box < BN / CB; ++box) {
          if (n0 + box * CB < N) {
            sm90::tma_store_2d(&map_out, e + box * 8192, n0 + box * CB, m0 + 64 * h);
          }
        }
        sm90::bulk_commit();
        if (P::RESID && h + 1 < MH) load_resid(m0 + 64 * (h + 1), n0);
      }
    }
  }
  if (leader) sm90::bulk_wait<0>();  // the stores are done before the block exits
}

// The maps of a GEMM: A [M, K] and Bt [N, K] in [rows, 64] boxes; out [M, N]
// in boxes of 128 bytes by 64 rows.
template <bool OUT_BF16>
int gemm_maps(CUtensorMap* map_a, CUtensorMap* map_b, CUtensorMap* map_out, const void* A,
              const void* Bt, void* out, int M, int N, int K, int rows_a, int rows_b) {
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box_a[2] = {GBK, static_cast<cuuint32_t>(rows_a)};
  const cuuint32_t box_b[2] = {GBK, static_cast<cuuint32_t>(rows_b)};
  int err = sm90::encode_sw128(map_a, BF16, 2, A, dims_a, row_bytes, box_a);
  if (!err) err = sm90::encode_sw128(map_b, BF16, 2, Bt, dims_b, row_bytes, box_b);
  const cuuint64_t dims_out[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t out_row_bytes[1] = {static_cast<cuuint64_t>(N) * (OUT_BF16 ? 2 : 4)};
  const cuuint32_t box_out[2] = {OUT_BF16 ? 64u : 32u, 64};
  if (!err) {
    err = sm90::encode_sw128(map_out, OUT_BF16 ? BF16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out,
                             dims_out, out_row_bytes, box_out);
  }
  return err;
}

template <int BN, int DH>
int qkv_gemm(const void* A, const void* Bt, void* out, int M, int N, int K, const uint16_t* sq,
             const uint16_t* sk, int heads, int sms, cudaStream_t st) {
  CUtensorMap map_a, map_b, map_out;
  const int err = gemm_maps<true>(&map_a, &map_b, &map_out, A, Bt, out, M, N, K, GBM, BN);
  if (err) return err;
  auto kernel = qkv_gemm_kernel<BN, DH>;
  constexpr size_t smem = qkv_smem_bytes<BN>();
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = static_cast<long long>((M + GBM - 1) / GBM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, G_THREADS, smem, st>>>(map_a, map_b, map_out, M, N, K, sq, sk, heads);
  return static_cast<int>(cudaGetLastError());
}

// One ping-pong GEMM launch: `sms` persistent blocks at most, one per tile.
// `resid` is bf16 [M, N] (EPI_RESID), f32 [M, N] (EPI_OUT) or unused.
template <int EPI, bool OUT_BF16, int MH>
int gemm_pp_mh(const void* A, const void* Bt, void* out, const void* resid, const uint16_t* bias,
               int M, int N, int K, int sms, cudaStream_t st) {
  using P = PingPong<EPI, OUT_BF16, MH>;
  CUtensorMap map_a, map_b, map_out, map_resid;
  int err = gemm_maps<OUT_BF16>(&map_a, &map_b, &map_out, A, Bt, out, M, N, K, P::BM, P::BN);
  map_resid = map_out;  // EPI_GELU reads none
  if (!err && P::RESID) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
    const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(N) * (P::RESID_F32 ? 4 : 2)};
    const cuuint32_t box[2] = {P::RESID_F32 ? 32u : 64u, 64};
    err = sm90::encode_sw128(&map_resid,
                             P::RESID_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             2, resid, dims, row_bytes, box);
  }
  if (err) return err;
  auto kernel = gemm_pp_kernel<EPI, OUT_BF16, MH>;
  constexpr size_t smem = P::BYTES;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = static_cast<long long>((M + P::BM - 1) / P::BM) * ((N + P::BN - 1) / P::BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, PP_THREADS, smem, st>>>(map_a, map_b, map_out, map_resid, M, N, K, bias);
  return static_cast<int>(cudaGetLastError());
}

// 128-row tiles where they fill the SMs, else 64-row tiles (the decompress
// layer's 128 rows: each warpgroup a tile of its own, as many at once as the
// cooperative split would run).
template <int EPI, bool OUT_BF16>
int gemm_pp(const void* A, const void* Bt, void* out, const void* resid, const uint16_t* bias,
            int M, int N, int K, int sms, cudaStream_t st) {
  const long long tiles = static_cast<long long>((M + 127) / 128) * ((N + 127) / 128);
  return tiles >= sms ? gemm_pp_mh<EPI, OUT_BF16, 2>(A, Bt, out, resid, bias, M, N, K, sms, st)
                      : gemm_pp_mh<EPI, OUT_BF16, 1>(A, Bt, out, resid, bias, M, N, K, sms, st);
}

// ---------------------------------------------------------------------------
// Attention of one (item, head) over S <= 256 keys, all in one pass: qkv bf16
// [N, S, 3 H DH] (q, k, v side by side, head-major), out bf16 [N, S, H, DH].
// NBX = DH / 32 boxes of 32 columns; KT = ceil(S / 64) tiles of 64 keys.
// Warpgroups of 64 query rows; thread 0 also issues the loads. ptxas sizes a
// kernel's registers for whole warpgroups, so a producer warp or warpgroup
// beside them would cap every thread at 128, too few for a row's logits.
// Three warpgroups (168 registers a thread) up to 192 keys and heads of 96;
// two (255) beyond, where 256 logits or 64 output columns a row do not fit.
constexpr int A_CONSUMERS = 3;
template <int NBX, int KT>
__host__ __device__ constexpr int attention_warpgroups() {
  return KT <= 3 && NBX <= 3 ? A_CONSUMERS : 2;
}
constexpr int SMEM_LIMIT = 232448;                // an H100 block's dynamic shared memory

template <int NBX, int KT>
struct AttnSmem {
  static constexpr int ROWS = 64 * KT;     // query and key rows of the (item, head), padded
  static constexpr int BOXB = ROWS * 64;   // one 32-column box of 64-byte rows
  static constexpr int TILE = NBX * BOXB;  // q, k or v
  static constexpr int ITEM = 3 * TILE;
  static constexpr int BARS = 3;  // per buffer: q and k landed, v landed, free
  // Two buffers where they fit (the next item's loads run under this one's
  // products), else one.
  static constexpr int BUFS = 1024 + 2 * (ITEM + BARS * 8) <= SMEM_LIMIT ? 2 : 1;
  static constexpr size_t BYTES = 1024 + static_cast<size_t>(BUFS) * (ITEM + BARS * 8);
};

// The 64-byte-swizzled tiles: K-major (rows of 64 bytes, 8-row groups 512
// bytes apart) and N-major (rows along K; the leading offset steps from one
// 32-column box to the next). Each descriptor is built where it is used: the
// empty asm keeps the compiler from computing every step's descriptor ahead
// and holding them all in registers beside the logits.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return sm90::desc(addr, 2, 16, 512);
}
template <int BOXB>
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return sm90::desc(addr, 2, BOXB, 512);
}

template <int NBX, int KT>
__global__ void __launch_bounds__(128 * attention_warpgroups<NBX, KT>(), 1) block_attention_kernel(
    const __grid_constant__ CUtensorMap map_qkv, const __grid_constant__ CUtensorMap map_out,
    int items, int S, int H, float scale_log2) {
  using L = AttnSmem<NBX, KT>;
  constexpr int D = 32 * NBX;
  constexpr int KS = D / 16;  // k16 steps over the head width
  constexpr int WGS = attention_warpgroups<NBX, KT>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* buf = sm90::align1024(smem_raw);  // [BUFS][q, k, v tiles]
  uint64_t* bars = reinterpret_cast<uint64_t*>(buf + L::BUFS * L::ITEM);
  auto qk_full = [&](int b) { return &bars[3 * b]; };
  auto v_full = [&](int b) { return &bars[3 * b + 1]; };
  auto free_ = [&](int b) { return &bars[3 * b + 2]; };

  const int c = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int work = items * H;
  const int slabs = (S + 63) / 64;
  // Work item w's q and k, then v, into buffer bb (thread 0).
  auto load = [&](int w, int bb) {
    const int item = w / H, h = w % H;
    uint8_t* q_t = buf + bb * L::ITEM;
    sm90::mbar_expect_tx(qk_full(bb), 2 * L::TILE);
#pragma unroll
    for (int bx = 0; bx < NBX; ++bx) {
      sm90::tma_load_3d(q_t + bx * L::BOXB, &map_qkv, qk_full(bb), h * D + 32 * bx, 0, item);
      sm90::tma_load_3d(q_t + L::TILE + bx * L::BOXB, &map_qkv, qk_full(bb), (H + h) * D + 32 * bx,
                        0, item);
    }
    sm90::mbar_expect_tx(v_full(bb), L::TILE);
#pragma unroll
    for (int bx = 0; bx < NBX; ++bx) {
      sm90::tma_load_3d(q_t + 2 * L::TILE + bx * L::BOXB, &map_qkv, v_full(bb),
                        (2 * H + h) * D + 32 * bx, 0, item);
    }
  };
  if (threadIdx.x == 0) {
    for (int bb = 0; bb < L::BUFS; ++bb) {
      sm90::mbar_init(qk_full(bb), 1);  // thread 0's expect_tx; TMA bytes complete it
      sm90::mbar_init(v_full(bb), 1);
      sm90::mbar_init(free_(bb), WGS);  // one arrival per warpgroup
    }
    sm90::mbar_fence_init();
    for (int bb = 0; bb < L::BUFS; ++bb) {  // the block's first items
      if (blockIdx.x + bb * gridDim.x < work) load(blockIdx.x + bb * gridDim.x, bb);
    }
  }
  __syncthreads();

  int b = 0;
  uint32_t ph = 0;
  for (int w = blockIdx.x; w < work; w += gridDim.x) {
    const int item = w / H, h = w % H;
    uint8_t* q_t = buf + b * L::ITEM;
    const uint32_t qa = sm90::smem_u32(q_t), ka = qa + L::TILE, va = ka + L::TILE;
    sm90::mbar_wait(qk_full(b), ph);
    for (int slab = c; slab < slabs; slab += WGS) {
      // s[t] = q k^T of the slab's 64 rows and keys 64 t .. +63; element
      // 4j + e: row 16 warp + g (+8 for e >= 2), key 64 t + 8j + 2 t4 + (e & 1).
      float s[KT][32];
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        zero(s[t]);
        sm90::fence_regs(s[t]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int t = 0; t < KT; ++t) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {  // 16 columns: box kk / 2, bytes 32 (kk % 2)
          const uint32_t at = (kk / 2) * L::BOXB + 32 * (kk % 2);
          sm90::wgmma_ss<64>(s[t], desc_k(qa + slab * 64 * 64 + at), desc_k(ka + t * 64 * 64 + at),
                             kk > 0);
        }
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int t = 0; t < KT; ++t) sm90::fence_regs(s[t]);
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < KT; ++t) sm90::fence_regs(s[t]);

      // The softmax of each row over its S keys (a row lives on the 4 lanes
      // of a quad): logits in log2 units, keys past S at -inf, the exact max
      // and sum, then P = 2^(s - max) / sum rounded to bf16 into the A
      // fragments of P . V. Fragment kk of tile t covers keys 64 t + 16 kk
      // .. +15: elements 8 kk .. 8 kk + 7 of s[t].
      float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
      for (int t = 0; t < KT; ++t) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = 64 * t + 8 * (i / 4) + 2 * t4 + (i & 1);
          const float x = key < S ? s[t][i] * scale_log2 : -INFINITY;
          s[t][i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
      }
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int t = 0; t < KT; ++t) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[t][i] = ex2(s[t][i] - mx[(i >> 1) & 1]);
          l[(i >> 1) & 1] += s[t][i];
        }
      }
      float rl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        rl[r] = __frcp_rn(l[r]);
      }
      uint32_t p[KT][4][4];
#pragma unroll
      for (int t = 0; t < KT; ++t) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // rows g (q even) and g + 8 (q odd)
            const int i = 8 * kk + 2 * q;
            const int r = q & 1;
            p[t][kk][q] = pack_bf16(div_by(s[t][i], l[r], rl[r]), div_by(s[t][i + 1], l[r], rl[r]));
          }
          sm90::fence_regs(p[t][kk]);
        }
      }

      // O = P . V: 16 keys per wgmma, V's rows 64 t + 16 kk .. +15.
      sm90::mbar_wait(v_full(b), ph);
      float o[D / 2];
      zero(o);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int t = 0; t < KT; ++t) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::wgmma_rs<D>(o, p[t][kk], desc_mn<L::BOXB>(va + (64 * t + 16 * kk) * 64), 1);
        }
      }
      sm90::wgmma_commit();
      sm90::fence_regs(o);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);

      // O as bf16 into the slab's rows of q's tile (only this warpgroup reads
      // them, and its products are done), then TMA stores; rows past S are
      // not written.
      const uint32_t slab_at = slab * 64 * 64;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(q_t + (j / 4) * L::BOXB + slab_at + row * 64 +
                                       (((j % 4) ^ ((row >> 1) & 3)) << 4) + 4 * t4) =
              pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        }
      }
      sm90::fence_proxy_async();
      sm90::named_sync(1 + c, 128);
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int bx = 0; bx < NBX; ++bx) {
          sm90::tma_store_4d(&map_out, q_t + bx * L::BOXB + slab_at, 32 * bx, h, 64 * slab, item);
        }
        sm90::bulk_commit();
      }
    }
    // The buffer is free once every warpgroup's products are done (waited
    // above) and its stores have read their rows; then thread 0 loads the
    // item after next into it, while the next item's products run.
    if (threadIdx.x % 128 == 0) {
      sm90::bulk_wait_read<0>();
      sm90::mbar_arrive(free_(b));
    }
    if (threadIdx.x == 0 && w + L::BUFS * gridDim.x < work) {
      sm90::mbar_wait(free_(b), ph);
      load(w + L::BUFS * gridDim.x, b);
    }
    advance(b, ph, L::BUFS);
  }
  if (threadIdx.x % 128 == 0) sm90::bulk_wait<0>();  // the stores are done before the block exits
}

template <int NBX, int KT>
int attention_launch(const void* qkv, void* att, int items, int S, int H, float scale, int sms,
                     cudaStream_t st) {
  using L = AttnSmem<NBX, KT>;
  constexpr int D = 32 * NBX;
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto SW64 = CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap map_qkv, map_out;
  const cuuint64_t width = 3ull * H * D;
  const cuuint64_t dims[3] = {width, static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(items)};
  const cuuint64_t strides[2] = {width * 2, width * 2 * S};
  const cuuint32_t box[3] = {32, L::ROWS, 1};
  int err = sm90::encode_tiled(&map_qkv, BF16, 3, qkv, dims, strides, box, SW64);
  if (!err) err = sm90::encode_bshd(&map_out, BF16, 2, att, items, S, H, D, 32, 64, SW64);
  if (err) return err;
  auto kernel = block_attention_kernel<NBX, KT>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::BYTES));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int work = items * H;
  const int grid = work < sms ? work : sms;
  kernel<<<grid, 128 * attention_warpgroups<NBX, KT>(), L::BYTES, st>>>(map_qkv, map_out, items, S, H,
                                            scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int NBX>
int attention(const void* qkv, void* att, int items, int S, int H, float scale, int sms,
              cudaStream_t st) {
  switch ((S + 63) / 64) {
    case 1: return attention_launch<NBX, 1>(qkv, att, items, S, H, scale, sms, st);
    case 2: return attention_launch<NBX, 2>(qkv, att, items, S, H, scale, sms, st);
    case 3: return attention_launch<NBX, 3>(qkv, att, items, S, H, scale, sms, st);
    default: return attention_launch<NBX, 4>(qkv, att, items, S, H, scale, sms, st);
  }
}

// Launch 2: q, k, v (one GEMM, heads whole in each N tile: 192 columns for
// DH = 96, else 128); launch 3: attention.
template <int DH>
int qkv_and_attention(const uint16_t* ln1, const uint16_t* wqkv_t, const uint16_t* sq,
                      const uint16_t* sk, uint16_t* qkv, uint16_t* att, int items, int S, int C,
                      int H, float scale, int stages, int sms, cudaStream_t st) {
  const int R = items * S;
  constexpr int BN = DH == 96 ? 192 : 128;
  if (stages & 2) {
    const int rc = qkv_gemm<BN, DH>(ln1, wqkv_t, qkv, R, 3 * H * DH, C, sq, sk, H, sms, st);
    if (rc) return rc;
  }
  if (!(stages & 4)) return 0;
  return attention<DH / 32>(qkv, att, items, S, H, scale, sms, st);
}

}  // namespace

// Runs the seven launches of one block layer on `stream` (those whose bit
// 1 << (launch - 1) is set in `stages`; all 127 for the layer, one alone to
// time it). x [N*S, C] (f32 or bf16) -> out [N*S, C] (f32 or bf16). Scratch,
// each [N*S, width] and bf16 unless noted: xb (C; unused for a bf16 x), ln1
// (C), qkv (3*H*DH), att (H*DH), y (C, f32), ln2 (C), hid (MLP). `sms` bounds
// the persistent kernels' grids. Returns a cudaError_t: the first launch's
// error, or cudaErrorInvalidValue for shapes the kernels do not take (DH in
// {32, 64, 96, 128}, 1 <= S <= 256, C and MLP multiples of 8).
extern "C" int tdspa_block_forward(
    const void* x, void* out, const void* g1, const void* wqkv_t, const void* sq,
    const void* sk, const void* wo_t, const void* bo, const void* g2, const void* w1_t,
    const void* b1, const void* w2_t, const void* b2, void* xb, void* ln1, void* qkv, void* att,
    void* y, void* ln2, void* hid, int x_bf16, int out_bf16, int N, int S, int C, int H, int DH,
    int MLP, int stages, int sms, float scale, void* stream) {
  const long long rows = static_cast<long long>(N) * S;
  if (N < 1 || S < 1 || S > 256 || C < 8 || C % 8 != 0 || MLP < 8 || MLP % 8 != 0 || H < 1 ||
      (DH != 32 && DH != 64 && DH != 96 && DH != 128) || rows > 0x7fffffffLL ||
      static_cast<long long>(N) * H > 0x7fffffffLL || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int R = static_cast<int>(rows);
  auto c16 = [](const void* p) { return static_cast<const uint16_t*>(p); };
  auto m16 = [](void* p) { return static_cast<uint16_t*>(p); };
  int rc = 0;

  // 1. ln1 (and the residual, x rounded to bf16)
  if (stages & 1) {
    rc = x_bf16 ? layernorm<true, false>(x, c16(g1), nullptr, m16(ln1), R, C, st)
                : layernorm<false, true>(x, c16(g1), m16(xb), m16(ln1), R, C, st);
    if (rc) return rc;
  }

  // 2-3. q, k, v and attention
  switch (DH) {
    case 32: rc = qkv_and_attention<32>(c16(ln1), c16(wqkv_t), c16(sq), c16(sk), m16(qkv), m16(att), N, S, C, H, scale, stages, sms, st); break;
    case 64: rc = qkv_and_attention<64>(c16(ln1), c16(wqkv_t), c16(sq), c16(sk), m16(qkv), m16(att), N, S, C, H, scale, stages, sms, st); break;
    case 96: rc = qkv_and_attention<96>(c16(ln1), c16(wqkv_t), c16(sq), c16(sk), m16(qkv), m16(att), N, S, C, H, scale, stages, sms, st); break;
    default: rc = qkv_and_attention<128>(c16(ln1), c16(wqkv_t), c16(sq), c16(sk), m16(qkv), m16(att), N, S, C, H, scale, stages, sms, st); break;
  }
  if (rc) return rc;

  // 4. y = (x + att . Wo) + bo
  if (stages & 8) {
    rc = gemm_pp<EPI_RESID, false>(att, wo_t, y, x_bf16 ? x : xb, c16(bo), R, C, H * DH, sms, st);
    if (rc) return rc;
  }

  // 5. ln2
  if (stages & 16) {
    rc = layernorm<false, false>(y, c16(g2), nullptr, m16(ln2), R, C, st);
    if (rc) return rc;
  }

  // 6. hid = GELU(ln2 . W1 + b1)
  if (stages & 32) {
    rc = gemm_pp<EPI_GELU, true>(ln2, w1_t, hid, nullptr, c16(b1), R, MLP, C, sms, st);
    if (rc) return rc;
  }

  // 7. out = y + (hid . W2 + b2)
  if (stages & 64) {
    rc = out_bf16 ? gemm_pp<EPI_OUT, true>(hid, w2_t, out, y, c16(b2), R, C, MLP, sms, st)
                  : gemm_pp<EPI_OUT, false>(hid, w2_t, out, y, c16(b2), R, C, MLP, sms, st);
  }
  return rc;
}
