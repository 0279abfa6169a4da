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
// bf16 mma.sync m16n8k16 with f32 accumulation; LayerNorm takes the two-pass
// variance; statistics and residual sums are f32, as in the TPU body.
//
// The TPU body keeps one item and ~16 MB of weights in VMEM. An SM has 228 KB
// of shared memory, less than one readout item (129 x 1280 bf16 = 330 KB), so
// the layer runs as seven launches on one stream (tdspa_block_forward):
//   1. layernorm_kernel  x -> ln1 (and x rounded to bf16, the residual)
//   2. gemm_kernel<Dh, QKV>  one N tile per head (Dh columns), so the RMSNorm
//      epilogue sees the head's whole row: q, k normalised, v as is
//   3. attention_kernel  one block per (item, head, query rows); all S <= 256
//      keys and values of the (item, head) in shared memory; a first pass
//      over the keys finds each row's max and denominator, a second
//      normalises P before rounding it to bf16 and accumulates P . V
//   4. gemm_kernel<128, RESID>  att . Wo + residual + bias -> y (f32)
//   5. layernorm_kernel  y -> ln2
//   6. gemm_kernel<128, GELU>  ln2 . W1 + b1, tanh GELU -> hid (bf16)
//   7. gemm_kernel<128, OUT>  hid . W2 + b2 + y -> out
// The GEMM: 8 warps of 16 rows each (a 128-row M tile) over BN columns,
// 32-deep K tiles double buffered with cp.async.
//
// What bounds it on an H100: at the readout shape (66,048 rows of 1280,
// MLP 1536) the layer does about 1.07 TFLOP of bf16 products against about
// 0.7 GB of input and output, over 1000 operations per byte: the tensor
// cores bound it. Not done yet: wgmma and TMA, fusing the LayerNorms into
// the GEMMs' prologues, and keeping intermediates (q, k, v, att, ln2, hid)
// out of device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
// C[M, N] = A[M, K] . Bt[N, K]^T with an epilogue. A and Bt bf16, row-major.
enum Epi { EPI_QKV = 0, EPI_RESID = 1, EPI_GELU = 2, EPI_OUT = 3 };

struct EpiArgs {
  uint16_t* q;  // EPI_QKV: outputs [M, H*Dh] each, RMSNorm scales [Dh]
  uint16_t* k;
  uint16_t* v;
  const uint16_t* sq;
  const uint16_t* sk;
  int heads;
  const uint16_t* bias;  // [N]
  const void* resid;     // EPI_RESID: bf16 [M, N] (the block input); EPI_OUT: f32 y [M, N]
  void* out;             // EPI_RESID: f32 y; EPI_GELU: bf16; EPI_OUT: f32 or bf16
  int out_bf16;
};

constexpr int GBM = 128;       // rows per block: 8 warps x 16
constexpr int GBK = 32;        // K per stage
constexpr int GLD = GBK + 8;   // bf16 elements per staged row (80 bytes: bank spread)

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const uint16_t* __restrict__ A, const uint16_t* __restrict__ Bt, int M, int N, int K,
    EpiArgs e) {
  constexpr int NT = BN / 8;
  __shared__ __align__(16) uint16_t a_s[2][GBM * GLD];
  __shared__ __align__(16) uint16_t b_s[2][BN * GLD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * GBM;

  auto load_stage = [&](int stage, int k0) {
    for (int i = threadIdx.x; i < GBM * (GBK / 8); i += THREADS) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < K;
      cp_async16(&a_s[stage][r * GLD + c], ok ? A + static_cast<long long>(m) * K + k : A,
                 ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < BN * (GBK / 8); i += THREADS) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      const int n = n0 + r, k = k0 + c;
      const bool ok = n < N && k < K;
      cp_async16(&b_s[stage][r * GLD + c], ok ? Bt + static_cast<long long>(n) * K + k : Bt,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int k_tiles = (K + GBK - 1) / GBK;
  load_stage(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load_stage((kt + 1) & 1, (kt + 1) * GBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* as = a_s[kt & 1];
    const uint16_t* bs = b_s[kt & 1];
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      const uint16_t* ar = as + (warp * 16 + g) * GLD + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld_pair(ar), ld_pair(ar + 8 * GLD), ld_pair(ar + 8),
                             ld_pair(ar + 8 * GLD + 8)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint16_t* br = bs + (n * 8 + g) * GLD + kk * 16 + 2 * t;
        const uint32_t b[2] = {ld_pair(br), ld_pair(br + 8)};
        mma_16816(acc[n], a, b);
      }
    }
    __syncthreads();  // this stage is read before the next load overwrites it
  }

  const int rows[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  if constexpr (EPI == EPI_QKV) {
    // BN is the head width: tile blockIdx.x is (projection, head).
    const int which = blockIdx.x / e.heads, head = blockIdx.x % e.heads;
    const long long hd = static_cast<long long>(e.heads) * BN;
    uint16_t* dst = which == 0 ? e.q : which == 1 ? e.k : e.v;
    float mul[2] = {1.f, 1.f};
    if (which < 2) {
      float ss[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        ss[0] += acc[n][0] * acc[n][0] + acc[n][1] * acc[n][1];
        ss[1] += acc[n][2] * acc[n][2] + acc[n][3] * acc[n][3];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
        mul[h] = rsqrtf(ss[h] / static_cast<float>(BN) + EPS);
      }
    }
    const uint16_t* scale = which == 0 ? e.sq : e.sk;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float s0 = which < 2 ? bf16_to_f32(scale[c]) : 1.f;
      const float s1 = which < 2 ? bf16_to_f32(scale[c + 1]) : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= M) continue;
        float o0 = acc[n][2 * h], o1 = acc[n][2 * h + 1];
        if (which < 2) {
          o0 = (o0 * mul[h]) * s0;
          o1 = (o1 * mul[h]) * s1;
        }
        *reinterpret_cast<uint32_t*>(dst + rows[h] * hd + head * BN + c) = pack_bf16(o0, o1);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n0 + n * 8 + 2 * t;
      if (col >= N) continue;
      const float b0 = bf16_to_f32(e.bias[col]), b1 = bf16_to_f32(e.bias[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= M) continue;
        const long long off = static_cast<long long>(rows[h]) * N + col;
        float o0 = acc[n][2 * h], o1 = acc[n][2 * h + 1];
        if constexpr (EPI == EPI_RESID) {  // y = (x + att . Wo) + bo
          const uint16_t* x = static_cast<const uint16_t*>(e.resid) + off;
          o0 = (bf16_to_f32(x[0]) + o0) + b0;
          o1 = (bf16_to_f32(x[1]) + o1) + b1;
          *reinterpret_cast<float2*>(static_cast<float*>(e.out) + off) = make_float2(o0, o1);
        } else if constexpr (EPI == EPI_GELU) {  // x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
          float v[2] = {o0 + b0, o1 + b1};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float x = v[j];
            const float cdf = 0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
            v[j] = x * cdf;
          }
          *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(e.out) + off) = pack_bf16(v[0], v[1]);
        } else {  // EPI_OUT: out = y + (hid . W2 + b2)
          const float* y = static_cast<const float*>(e.resid) + off;
          o0 = y[0] + (o0 + b0);
          o1 = y[1] + (o1 + b1);
          if (e.out_bf16) {
            *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(e.out) + off) = pack_bf16(o0, o1);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(e.out) + off) = make_float2(o0, o1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Attention of one (item, head) over S <= 256 keys, q/k/v/out bf16 [N*S, H*DH].
// Each warp owns 16 query rows; all keys and values of the (item, head) sit
// in shared memory. Pass 1 takes each row's running max and denominator over
// 16-key steps; pass 2 recomputes the logits, normalises P = exp(s - max) /
// sum before rounding it to bf16 (the TPU body's order), and accumulates
// P . V in f32. Keys past S are excluded by index.
template <int DH>
__global__ void __launch_bounds__(THREADS) attention_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, uint16_t* __restrict__ out, int S, int H, int q_blocks,
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
  const long long row_stride = static_cast<long long>(H) * DH;
  const uint16_t* qh = q + b * S * row_stride + h * DH;
  const uint16_t* kh = k + b * S * row_stride + h * DH;
  const uint16_t* vh = v + b * S * row_stride + h * DH;

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
      *reinterpret_cast<uint32_t*>(out + (b * S + row) * row_stride + h * DH + c) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

template <int BN, int EPI>
int gemm(const uint16_t* A, const uint16_t* Bt, int M, int N, int K, const EpiArgs& e,
         cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + GBM - 1) / GBM);
  gemm_kernel<BN, EPI><<<grid, THREADS, 0, st>>>(A, Bt, M, N, K, e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int qkv_and_attention(const uint16_t* ln1, const uint16_t* wqkv_t, const EpiArgs& e,
                      uint16_t* att, int items, int S, int C, float scale, cudaStream_t st) {
  const int R = items * S;
  int rc = gemm<DH, EPI_QKV>(ln1, wqkv_t, R, 3 * e.heads * DH, C, e, st);
  if (rc) return rc;
  // Query rows: 16 per warp, at most 8 warps per block, spread evenly.
  const int row_tiles = (S + 15) / 16;
  const int q_blocks = (row_tiles + 7) / 8;
  const int warps = (row_tiles + q_blocks - 1) / q_blocks;
  const int smem = 2 * ((S + 15) / 16 * 16) * (DH + 8) * static_cast<int>(sizeof(uint16_t));
  auto kernel = attention_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(items) * e.heads * q_blocks;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, st>>>(e.q, e.k, e.v, att, S, e.heads,
                                                                   q_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the seven launches of one block layer on `stream`. x [N*S, C] (f32 or
// bf16) -> out [N*S, C] (f32 or bf16). Scratch, each [N*S, width] and bf16
// unless noted: xb (C; unused for a bf16 x), ln1 (C), q, k, v, att (H*DH),
// y (C, f32), ln2 (C), hid (MLP). Returns a cudaError_t: the first launch's
// error, or cudaErrorInvalidValue for shapes the kernels do not take
// (DH in {32, 64, 96, 128}, 1 <= S <= 256, C and MLP multiples of 8).
extern "C" int tdspa_block_forward(
    const void* x, void* out, const void* g1, const void* wqkv_t, const void* sq,
    const void* sk, const void* wo_t, const void* bo, const void* g2, const void* w1_t,
    const void* b1, const void* w2_t, const void* b2, void* xb, void* ln1, void* q, void* k,
    void* v, void* att, void* y, void* ln2, void* hid, int x_bf16, int out_bf16, int N, int S,
    int C, int H, int DH, int MLP, float scale, void* stream) {
  const long long rows = static_cast<long long>(N) * S;
  if (N < 1 || S < 1 || S > 256 || C < 8 || C % 8 != 0 || MLP < 8 || MLP % 8 != 0 || H < 1 ||
      (DH != 32 && DH != 64 && DH != 96 && DH != 128) || rows > 0x7fffffffLL ||
      (rows + GBM - 1) / GBM > 65535 || static_cast<long long>(N) * H * 16 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int R = static_cast<int>(rows);
  auto c16 = [](const void* p) { return static_cast<const uint16_t*>(p); };
  auto m16 = [](void* p) { return static_cast<uint16_t*>(p); };
  const int norm_blocks = (R + THREADS / 32 - 1) / (THREADS / 32);

  // 1. ln1 (and the residual, x rounded to bf16)
  if (x_bf16) {
    layernorm_kernel<true, false><<<norm_blocks, THREADS, 0, st>>>(x, c16(g1), nullptr, m16(ln1), R, C);
  } else {
    layernorm_kernel<false, true><<<norm_blocks, THREADS, 0, st>>>(x, c16(g1), m16(xb), m16(ln1), R, C);
  }
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;

  // 2-3. q, k, v and attention
  EpiArgs e{};
  e.q = m16(q);
  e.k = m16(k);
  e.v = m16(v);
  e.sq = c16(sq);
  e.sk = c16(sk);
  e.heads = H;
  switch (DH) {
    case 32: rc = qkv_and_attention<32>(c16(ln1), c16(wqkv_t), e, m16(att), N, S, C, scale, st); break;
    case 64: rc = qkv_and_attention<64>(c16(ln1), c16(wqkv_t), e, m16(att), N, S, C, scale, st); break;
    case 96: rc = qkv_and_attention<96>(c16(ln1), c16(wqkv_t), e, m16(att), N, S, C, scale, st); break;
    default: rc = qkv_and_attention<128>(c16(ln1), c16(wqkv_t), e, m16(att), N, S, C, scale, st); break;
  }
  if (rc) return rc;

  // 4. y = (x + att . Wo) + bo
  EpiArgs r{};
  r.bias = c16(bo);
  r.resid = x_bf16 ? x : xb;
  r.out = y;
  rc = gemm<128, EPI_RESID>(c16(att), c16(wo_t), R, C, H * DH, r, st);
  if (rc) return rc;

  // 5. ln2
  layernorm_kernel<false, false><<<norm_blocks, THREADS, 0, st>>>(y, c16(g2), nullptr, m16(ln2), R, C);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;

  // 6. hid = GELU(ln2 . W1 + b1)
  EpiArgs m{};
  m.bias = c16(b1);
  m.out = hid;
  rc = gemm<128, EPI_GELU>(c16(ln2), c16(w1_t), R, MLP, C, m, st);
  if (rc) return rc;

  // 7. out = y + (hid . W2 + b2)
  EpiArgs o{};
  o.bias = c16(b2);
  o.resid = y;
  o.out = out;
  o.out_bf16 = out_bf16;
  return gemm<128, EPI_OUT>(c16(hid), c16(w2_t), R, C, MLP, o, st);
}
