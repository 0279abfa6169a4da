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
//   2. gemm_kernel<QKV>  ln1 . Wqkv -> qkv [rows, 3 H Dh]; each N tile holds
//      whole heads (192 columns for Dh = 96, else 128), so the RMSNorm
//      epilogue sees each head's row: q, k normalised, v as is
//   3. attention_kernel  one block per (item, head, query rows); all S <= 256
//      keys and values of the (item, head) in shared memory; a first pass
//      over the keys finds each row's max and denominator, a second
//      normalises P before rounding it to bf16 and accumulates P . V
//      (mma.sync m16n8k16)
//   4. gemm_kernel<RESID>  att . Wo + residual + bias -> y (f32)
//   5. layernorm_kernel  y -> ln2
//   6. gemm_kernel<GELU>  ln2 . W1 + b1, tanh GELU -> hid (bf16)
//   7. gemm_kernel<OUT>  hid . W2 + b2 + y -> out
// The GEMM (launches 2, 4, 6, 7) is persistent, one block per SM walking
// 128 x BN output tiles, the N tiles of a 128-row stripe back to back so that
// the stripe stays in L2. Warpgroup 0 gives its registers up (setmaxnreg) and
// one of its threads keeps TMA loads of the activation [128, 64] and weight
// [BN, 64] tiles (both K-major, 128-byte rows, 128-byte swizzle; every K
// here is a multiple of 8, and the tail past K arrives as zeros) in flight
// through a 4-stage mbarrier ring; warpgroups 1 and 2 take 64 rows each and
// run wgmma m64nBNk16 bf16 -> f32, keeping one stage's group in flight while
// the next is issued. The epilogue applies the stage's
// function in f32 into a 128-byte-swizzled staging tile per warpgroup and
// writes it with TMA stores, which clip at M and N and drain while the
// warpgroup runs its next tile.
//
// What bounds it on an H100: at the readout shape (66,048 rows of 1280,
// MLP 1536) the layer does about 1.07 TFLOP of bf16 products against about
// 0.7 GB of input and output, over 1000 operations per byte: the tensor
// cores bound it, and the four products are 4.31 of its 4.32 ms bound over
// the four layers of a forward. Not done yet: fusing the LayerNorms into the
// GEMMs' prologues, putting the attention stage on csrc/attention.cu's
// design, and keeping intermediates (qkv, att, ln2, hid) out of device
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float EPS = 1e-6f;
constexpr int THREADS = 256;

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ uint16_t f32_to_bf16(float v) {
  __nv_bfloat16 b = __float2bfloat16_rn(v);
  return *reinterpret_cast<uint16_t*>(&b);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D[16x8] += A[16x16] . B[16x8], bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// LayerNorm, bias-free, two-pass variance: one warp per row.
// X_BF16: the input is bf16; ROUND: round an f32 input to bf16 first (the
// block's entry cast) and write the rounded row to `xb` (the residual).
template <bool X_BF16, bool ROUND>
__global__ void __launch_bounds__(THREADS) layernorm_kernel(
    const void* __restrict__ x, const uint16_t* __restrict__ g, uint16_t* __restrict__ xb,
    uint16_t* __restrict__ out, int R, int C) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const long long base = static_cast<long long>(row) * C;
  auto value = [&](int c) -> float {
    if (X_BF16) return bf16_to_f32(static_cast<const uint16_t*>(x)[base + c]);
    const float v = static_cast<const float*>(x)[base + c];
    return ROUND ? bf16_to_f32(f32_to_bf16(v)) : v;
  };
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += value(c);
  const float mean = warp_sum(s) / static_cast<float>(C);
  float s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = value(c) - mean;
    s2 += d * d;
  }
  const float r = rsqrtf(warp_sum(s2) / static_cast<float>(C) + EPS);
  for (int c = lane; c < C; c += 32) {
    const float v = value(c);
    if (ROUND) xb[base + c] = f32_to_bf16(v);
    out[base + c] = f32_to_bf16(((v - mean) * r) * bf16_to_f32(g[c]));
  }
}

// ---------------------------------------------------------------------------
// C[M, N] = A[M, K] . Bt[N, K]^T with an epilogue: a persistent TMA + wgmma
// GEMM. A and Bt bf16, row-major, both K-major operands; the output goes
// through a 2-D tensor map over [M, N] (bf16 or f32).
enum Epi { EPI_QKV = 0, EPI_RESID = 1, EPI_GELU = 2, EPI_OUT = 3 };

struct EpiArgs {
  const uint16_t* sq;    // EPI_QKV: RMSNorm scales [Dh] of q and k
  const uint16_t* sk;
  int heads;             // EPI_QKV: the output is [M, 3 H Dh], (projection, head, d)
  const uint16_t* bias;  // [N]
  const void* resid;     // EPI_RESID: bf16 [M, N] (the block input); EPI_OUT: f32 y [M, N]
};

constexpr int GBM = 128;       // rows per tile: two consumer warpgroups of 64
constexpr int GBK = 64;        // K per stage: one 128-byte swizzled row of bf16 per tile row
constexpr int G_STAGES = 4;    // depth of the TMA ring
constexpr int G_THREADS = 384; // warpgroup 0 loads, warpgroups 1 and 2 compute

template <int BN, bool OUT_BF16>
constexpr size_t gemm_smem_bytes() {
  return 1024 + static_cast<size_t>(G_STAGES) * (GBM + BN) * 128 +
         2 * static_cast<size_t>(64) * BN * (OUT_BF16 ? 2 : 4) + 2 * G_STAGES * sizeof(uint64_t);
}

// BN output columns per tile; for EPI_QKV a whole number of heads (DH each),
// so that the RMSNorm sees each head's row in one tile.
template <int BN, int EPI, int DH, bool OUT_BF16>
__global__ void __launch_bounds__(G_THREADS, 1) gemm_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_out, int M, int N, int K, EpiArgs e) {
  constexpr int OUT_ELEM = OUT_BF16 ? 2 : 4;
  constexpr int CB = 128 / OUT_ELEM;            // output columns per 128-byte box
  constexpr int STAGE_OUT = 64 * BN * OUT_ELEM;  // a warpgroup's 64 x BN output tile
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
          if (++stage == G_STAGES) {
            stage = 0;
            phase ^= 1;
          }
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
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
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
      if (++stage == G_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[prev]);

    // acc[4j + e]: row 16 warp + g (+8 for e >= 2), column 8j + 2t + (e & 1).
    const int rows[2] = {m0 + half * 64 + warp * 16 + g, m0 + half * 64 + warp * 16 + g + 8};
    // EPI_QKV: each head's RMSNorm factor per row (q and k only), from the
    // sum of squares over the thread's columns of the head and its quad's.
    constexpr int HP = EPI == EPI_QKV ? BN / (DH > 0 ? DH : BN) : 1;
    float mul[HP][2];
    if constexpr (EPI == EPI_QKV) {
      constexpr int JH = DH / 8;
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
    }

    // Into this warpgroup's staging tile, where column c of row r lies in box
    // c / CB at 16-byte chunk (c % CB / (CB / 8)) ^ (r % 8); the TMA store
    // writes only the rows below M and columns below N.
    if (threadIdx.x % 128 == 0) sm90::bulk_wait_read<0>();  // the last tile's store has read it
    sm90::named_sync(1 + half, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t, col = n0 + c;
      const bool col_ok = col < N;
      float p0 = 1.f, p1 = 1.f;  // EPI_QKV: the column's RMSNorm scale (1 for v)
      int hh = 0;
      if constexpr (EPI == EPI_QKV) {
        hh = j / (DH / 8);
        const int which = (n0 + hh * DH) / (e.heads * DH);
        if (which < 2) {
          const uint16_t* scale = which == 0 ? e.sq : e.sk;
          p0 = bf16_to_f32(scale[c - hh * DH]);
          p1 = bf16_to_f32(scale[c - hh * DH + 1]);
        } else {
          mul[hh][0] = mul[hh][1] = 1.f;
        }
      } else {
        p0 = col_ok ? bf16_to_f32(e.bias[col]) : 0.f;
        p1 = col_ok ? bf16_to_f32(e.bias[col + 1]) : 0.f;
      }
      const int box = c / CB, chunk = c % CB / (CB / 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        float o0 = acc[4 * j + 2 * h], o1 = acc[4 * j + 2 * h + 1];
        const long long off = static_cast<long long>(rows[h]) * N + col;
        const bool in = col_ok && rows[h] < M;
        if constexpr (EPI == EPI_QKV) {
          o0 = (o0 * mul[hh][h]) * p0;
          o1 = (o1 * mul[hh][h]) * p1;
        } else if constexpr (EPI == EPI_RESID) {  // y = (x + att . Wo) + bo
          const uint32_t xr = in ? *reinterpret_cast<const uint32_t*>(
                                       static_cast<const uint16_t*>(e.resid) + off)
                                 : 0u;
          o0 = (__uint_as_float(xr << 16) + o0) + p0;
          o1 = (__uint_as_float(xr & 0xffff0000u) + o1) + p1;
        } else if constexpr (EPI == EPI_GELU) {  // x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
          float v[2] = {o0 + p0, o1 + p1};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float x = v[i];
            const float cdf = 0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
            v[i] = x * cdf;
          }
          o0 = v[0];
          o1 = v[1];
        } else {  // EPI_OUT: out = y + (hid . W2 + b2)
          const float2 y = in ? *reinterpret_cast<const float2*>(static_cast<const float*>(e.resid) + off)
                              : make_float2(0.f, 0.f);
          o0 = y.x + (o0 + p0);
          o1 = y.y + (o1 + p1);
        }
        uint8_t* dst = stage_out + box * 64 * 128 + r * 128 + ((chunk ^ (r % 8)) * 16);
        if constexpr (OUT_BF16) {
          *reinterpret_cast<uint32_t*>(dst + (c % 8) * 2) = pack_bf16(o0, o1);
        } else {
          *reinterpret_cast<float2*>(dst + (c % 4) * 4) = make_float2(o0, o1);
        }
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

// ---------------------------------------------------------------------------
// Attention of one (item, head) over S <= 256 keys: qkv bf16 [N*S, 3*H*DH]
// (q, k, v side by side, head-major), out bf16 [N*S, H*DH].
// Each warp owns 16 query rows; all keys and values of the (item, head) sit
// in shared memory. Pass 1 takes each row's running max and denominator over
// 16-key steps; pass 2 recomputes the logits, normalises P = exp(s - max) /
// sum before rounding it to bf16 (the TPU body's order), and accumulates
// P . V in f32. Keys past S are excluded by index.
template <int DH>
__global__ void __launch_bounds__(THREADS) attention_kernel(
    const uint16_t* __restrict__ qkv, uint16_t* __restrict__ out, int S, int H, int q_blocks,
    float scale) {
  constexpr int KSTEPS = DH / 16;
  constexpr int NT = DH / 8;
  constexpr int LD = DH + 8;  // bank spread
  extern __shared__ __align__(16) uint16_t kv_s[];
  const int s_pad = (S + 15) / 16 * 16;
  uint16_t* k_s = kv_s;
  uint16_t* v_s = kv_s + s_pad * LD;

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const long long blk = blockIdx.x;
  const int qb = static_cast<int>(blk % q_blocks);
  const int h = static_cast<int>((blk / q_blocks) % H);
  const long long b = blk / (static_cast<long long>(q_blocks) * H);
  const long long out_stride = static_cast<long long>(H) * DH;
  const long long row_stride = 3 * out_stride;  // elements per token of qkv
  const uint16_t* qh = qkv + b * S * row_stride + h * DH;
  const uint16_t* kh = qh + out_stride;
  const uint16_t* vh = qh + 2 * out_stride;

  for (int i = threadIdx.x; i < s_pad * (DH / 8); i += blockDim.x) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    uint4 kc = make_uint4(0u, 0u, 0u, 0u), vc = kc;
    if (r < S) {
      kc = *reinterpret_cast<const uint4*>(kh + r * row_stride + c);
      vc = *reinterpret_cast<const uint4*>(vh + r * row_stride + c);
    }
    *reinterpret_cast<uint4*>(&k_s[r * LD + c]) = kc;
    *reinterpret_cast<uint4*>(&v_s[r * LD + c]) = vc;
  }
  __syncthreads();

  const int row0 = (qb * warps + warp) * 16;
  if (row0 >= S) return;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c0 = kk * 16 + 2 * t, c1 = c0 + 8;
    qf[kk][0] = r_lo < S ? ld_pair(qh + r_lo * row_stride + c0) : 0u;
    qf[kk][1] = r_hi < S ? ld_pair(qh + r_hi * row_stride + c0) : 0u;
    qf[kk][2] = r_lo < S ? ld_pair(qh + r_lo * row_stride + c1) : 0u;
    qf[kk][3] = r_hi < S ? ld_pair(qh + r_hi * row_stride + c1) : 0u;
  }

  // Scaled logits of 16 keys from j0: s[n] covers keys j0 + 8n .. j0 + 8n + 7.
  auto logits = [&](int j0, float s[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint16_t* kr = &k_s[(j0 + n * 8 + g) * LD + kk * 16 + 2 * t];
        const uint32_t bf[2] = {ld_pair(kr), ld_pair(kr + 8)};
        mma_16816(s[n], qf[kk], bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = col < S ? s[n][e] * scale : -FLT_MAX;
      }
    }
  };

  float m_run[2] = {-FLT_MAX, -FLT_MAX}, l_run[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < s_pad; j0 += 16) {
    float s[2][4];
    logits(j0, s);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      l_run[r] *= expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + n * 8 + 2 * t + (e & 1) < S) l_run[e >> 1] += expf(s[n][e] - mx[e >> 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int j0 = 0; j0 < s_pad; j0 += 16) {
    float s[2][4];
    logits(j0, s);
    uint32_t pf[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + n * 8 + 2 * t + (e & 1);
        p[e] = col < S ? __fdiv_rn(expf(s[n][e] - m_run[e >> 1]), l_run[e >> 1]) : 0.f;
      }
      pf[n * 2 + 0] = pack_bf16(p[0], p[1]);  // row r_lo
      pf[n * 2 + 1] = pack_bf16(p[2], p[3]);  // row r_hi
    }
    const uint16_t* vr = &v_s[(j0 + 2 * t) * LD];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + g;
      const uint32_t bf[2] = {
          static_cast<uint32_t>(vr[c]) | (static_cast<uint32_t>(vr[LD + c]) << 16),
          static_cast<uint32_t>(vr[8 * LD + c]) | (static_cast<uint32_t>(vr[9 * LD + c]) << 16)};
      mma_16816(acc[n], pf, bf);
    }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? r_lo : r_hi;
      if (row >= S) continue;
      *reinterpret_cast<uint32_t*>(out + (b * S + row) * out_stride + h * DH + c) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// One GEMM launch: `sms` persistent blocks at most, one per tile.
template <int BN, int EPI, int DH, bool OUT_BF16>
int gemm(const void* A, const void* Bt, void* out, int M, int N, int K, const EpiArgs& e, int sms,
         cudaStream_t st) {
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_a, map_b, map_out;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box_a[2] = {GBK, GBM}, box_b[2] = {GBK, BN};
  int err = sm90::encode_sw128(&map_a, BF16, 2, A, dims_a, row_bytes, box_a);
  if (!err) err = sm90::encode_sw128(&map_b, BF16, 2, Bt, dims_b, row_bytes, box_b);
  const cuuint64_t dims_out[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t out_row_bytes[1] = {static_cast<cuuint64_t>(N) * (OUT_BF16 ? 2 : 4)};
  const cuuint32_t box_out[2] = {OUT_BF16 ? 64u : 32u, 64};  // 128 bytes by a warpgroup's 64 rows
  if (!err) {
    err = sm90::encode_sw128(&map_out, OUT_BF16 ? BF16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out,
                             dims_out, out_row_bytes, box_out);
  }
  if (err) return err;
  auto kernel = gemm_kernel<BN, EPI, DH, OUT_BF16>;
  constexpr size_t smem = gemm_smem_bytes<BN, OUT_BF16>();
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = static_cast<long long>((M + GBM - 1) / GBM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, G_THREADS, smem, st>>>(map_a, map_b, map_out, M, N, K, e);
  return static_cast<int>(cudaGetLastError());
}

// Launch 2: q, k, v (one GEMM, heads whole in each N tile: 192 columns for
// DH = 96, else 128); launch 3: attention.
template <int DH>
int qkv_and_attention(const uint16_t* ln1, const uint16_t* wqkv_t, const EpiArgs& e,
                      uint16_t* qkv, uint16_t* att, int items, int S, int C, float scale,
                      int stages, int sms, cudaStream_t st) {
  const int R = items * S;
  constexpr int BN = DH == 96 ? 192 : 128;
  if (stages & 2) {
    const int rc = gemm<BN, EPI_QKV, DH, true>(ln1, wqkv_t, qkv, R, 3 * e.heads * DH, C, e, sms, st);
    if (rc) return rc;
  }
  if (!(stages & 4)) return 0;
  // Query rows: 16 per warp, at most 8 warps per block, spread evenly.
  const int row_tiles = (S + 15) / 16;
  const int q_blocks = (row_tiles + 7) / 8;
  const int warps = (row_tiles + q_blocks - 1) / q_blocks;
  const int smem = 2 * ((S + 15) / 16 * 16) * (DH + 8) * static_cast<int>(sizeof(uint16_t));
  auto kernel = attention_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(items) * e.heads * q_blocks;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, st>>>(qkv, att, S, e.heads, q_blocks,
                                                                   scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the seven launches of one block layer on `stream` (those whose bit
// 1 << (launch - 1) is set in `stages`; all 127 for the layer, one alone to
// time it). x [N*S, C] (f32 or bf16) -> out [N*S, C] (f32 or bf16). Scratch,
// each [N*S, width] and bf16 unless noted: xb (C; unused for a bf16 x), ln1
// (C), qkv (3*H*DH), att (H*DH), y (C, f32), ln2 (C), hid (MLP). `sms` bounds
// the persistent GEMMs' grids. Returns a cudaError_t: the first launch's
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
      static_cast<long long>(N) * H * 16 > 0x7fffffffLL || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int R = static_cast<int>(rows);
  auto c16 = [](const void* p) { return static_cast<const uint16_t*>(p); };
  auto m16 = [](void* p) { return static_cast<uint16_t*>(p); };
  const int norm_blocks = (R + THREADS / 32 - 1) / (THREADS / 32);
  int rc = 0;

  // 1. ln1 (and the residual, x rounded to bf16)
  if (stages & 1) {
    if (x_bf16) {
      layernorm_kernel<true, false><<<norm_blocks, THREADS, 0, st>>>(x, c16(g1), nullptr, m16(ln1), R, C);
    } else {
      layernorm_kernel<false, true><<<norm_blocks, THREADS, 0, st>>>(x, c16(g1), m16(xb), m16(ln1), R, C);
    }
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
  }

  // 2-3. q, k, v and attention
  EpiArgs e{};
  e.sq = c16(sq);
  e.sk = c16(sk);
  e.heads = H;
  switch (DH) {
    case 32: rc = qkv_and_attention<32>(c16(ln1), c16(wqkv_t), e, m16(qkv), m16(att), N, S, C, scale, stages, sms, st); break;
    case 64: rc = qkv_and_attention<64>(c16(ln1), c16(wqkv_t), e, m16(qkv), m16(att), N, S, C, scale, stages, sms, st); break;
    case 96: rc = qkv_and_attention<96>(c16(ln1), c16(wqkv_t), e, m16(qkv), m16(att), N, S, C, scale, stages, sms, st); break;
    default: rc = qkv_and_attention<128>(c16(ln1), c16(wqkv_t), e, m16(qkv), m16(att), N, S, C, scale, stages, sms, st); break;
  }
  if (rc) return rc;

  // 4. y = (x + att . Wo) + bo
  if (stages & 8) {
    EpiArgs r{};
    r.bias = c16(bo);
    r.resid = x_bf16 ? x : xb;
    rc = gemm<128, EPI_RESID, 0, false>(att, wo_t, y, R, C, H * DH, r, sms, st);
    if (rc) return rc;
  }

  // 5. ln2
  if (stages & 16) {
    layernorm_kernel<false, false><<<norm_blocks, THREADS, 0, st>>>(y, c16(g2), nullptr, m16(ln2), R, C);
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
  }

  // 6. hid = GELU(ln2 . W1 + b1)
  if (stages & 32) {
    EpiArgs m{};
    m.bias = c16(b1);
    rc = gemm<128, EPI_GELU, 0, true>(ln2, w1_t, hid, R, MLP, C, m, sms, st);
    if (rc) return rc;
  }

  // 7. out = y + (hid . W2 + b2)
  if (stages & 64) {
    EpiArgs o{};
    o.bias = c16(b2);
    o.resid = y;
    rc = out_bf16 ? gemm<128, EPI_OUT, 0, true>(hid, w2_t, out, R, C, MLP, o, sms, st)
                  : gemm<128, EPI_OUT, 0, false>(hid, w2_t, out, R, C, MLP, o, sms, st);
  }
  return rc;
}
