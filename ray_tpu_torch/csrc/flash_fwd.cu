// Flash-attention forward for Hopper (sm_90a), bf16 and f32.
//
// Replaces the TPU forward of ray_tpu/ops/flash_attention.py: `_flash_fwd`
// (the pl.pallas_call at :294), whose bodies are `_fwd_kernel_1pass`
// (:172-212, the whole key row as one tile) and `_fwd_kernel` (:88-169,
// online softmax over key tiles). One online-softmax kernel serves both:
// the single-tile row is the case where the key loop below runs once.
//
// Contract (same as the TPU kernel): q [B,Hq,T,D], k/v [B,Hkv,S,D], all
// contiguous, one dtype; query head h reads kv head h / (Hq/Hkv). Scale
// d^-1/2; softmax statistics in f32 (log2 domain inside); probabilities
// are cast to v's dtype before P.V, with f32 accumulation. The causal mask
// is end-aligned: query row i sees keys <= i + S - T. Rows that see no key
// output 0 with lse = +1e30. lse is the natural log, stored [B,Hq,T] f32.
// Ragged T and S edges are masked here, so no block divisibility is needed.
//
// What bounds it on this card: at the main-path shape (B=2, T=S=2048,
// Hq=16, Hkv=8, D=128, causal) the two products are ~3.4e10 flops against
// ~51 MB of q/k/v/out/lse, far above the H100's ~295 flops per byte, so
// it is bound by tensor-core operations (~35 us at 989 TFLOP/s bf16).
// What the design does about it (bf16): each block takes 64 query rows of
// one head, four warps of 16 rows; a warp keeps its q fragments, its
// score tile and its output accumulator in registers and runs both
// products as mma.sync m16n8k16 (bf16 in, f32 accumulate), with the
// probabilities repacked from the score accumulators straight into the
// A operand of P.V, so S and P never touch memory. k/v tiles of 32 keys
// (few score registers, so three blocks fit an SM) are double-buffered in
// shared memory by cp.async, the next tile loading while this one
// computes, and read with ldmatrix (rows padded by 16 bytes against bank
// conflicts). Key tiles wholly above the causal diagonal are never visited
// (about half the work), the heaviest query tiles start first, and only
// tiles that straddle the diagonal or the ragged S edge pay for the mask.
// It reaches ~6x its bound and ~2.7x the time of the library's attention
// (PERF.md): two query m-tiles per warp, wgmma, TMA and warp
// specialisation are later work.
// f32 runs a plain-FMA kernel (no TF32) to keep full f32 precision.
//
// Built by ray_tpu_torch/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through a plain C interface (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 32;  // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// c += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Number of key tiles a block visits: under the causal mask, tiles past
// the last live key of the block's last real row are dead.
__device__ __forceinline__ int live_tiles(int q_start, int T_len, int S_len,
                                          int causal) {
  int n = (S_len + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q_start + kBQ, T_len) - 1;
    const int last_key = min(last_row + S_len - T_len, S_len - 1);
    n = last_key < 0 ? 0 : min(n, last_key / kBK + 1);
  }
  return n;
}

// ---------------------------------------------------------------- bf16

template <int D>
struct SmemBf16 {
  static constexpr int ld = D + 8;  // row stride (elements): +16 bytes
  static constexpr int tile = kBK * ld;
  static constexpr int bytes = (kBQ * ld + 4 * tile) * 2;  // q, 2 x (k, v)
};

// Queue async copies of `rows` rows of a [*, D] bf16 tensor from global
// row `row0` into a padded shared tile; rows at or past n_rows are zeros.
template <int D>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                int row0, int n_rows, int rows) {
  constexpr int ld = SmemBf16<D>::ld;
  constexpr int per_row = D / 8;  // 16-byte chunks
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * ld + c, ok ? src + (int64_t)(row0 + r) * D + c : src,
               ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int Hq, int Hkv, int T_len,
                      int S_len, int causal, float scale2) {
  constexpr int ld = SmemBf16<D>::ld;
  constexpr int kDk = D / 16;    // k16 steps over head_dim (q.k)
  constexpr int kNs = kBK / 8;   // n8 score tiles per key tile
  constexpr int kNo = D / 8;     // n8 output tiles over head_dim
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kBQ * ld;                   // two stages
  bf16* v_s = k_s + 2 * SmemBf16<D>::tile;      // two stages

  // last q tile first: under the causal mask it has the most live key
  // tiles, and starting the heaviest blocks first shortens the grid's tail
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S_len - T_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = warp * 16 + g;           // this thread's rows: row0, row0+8
  const int qi0 = q_start + row0, qi1 = qi0 + 8;

  const bf16* q_bh = q + ((int64_t)b * Hq + h) * T_len * D;
  const bf16* k_bh = k + ((int64_t)b * Hkv + hk) * S_len * D;
  const bf16* v_bh = v + ((int64_t)b * Hkv + hk) * S_len * D;

  const int n_tiles = live_tiles(q_start, T_len, S_len, causal);
  load_rows_async<D>(q_s, q_bh, q_start, T_len, kBQ);
  if (n_tiles > 0) {
    load_rows_async<D>(k_s, k_bh, 0, S_len, kBK);
    load_rows_async<D>(v_s, v_bh, 0, S_len, kBK);
  }
  cp_async_commit();

  float o[kNo][4];
#pragma unroll
  for (int i = 0; i < kNo; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums
  uint32_t qf[kDk][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k_start = j * kBK;
    const bf16* ks = k_s + (j & 1) * SmemBf16<D>::tile;
    const bf16* vs = v_s + (j & 1) * SmemBf16<D>::tile;
    if (j + 1 < n_tiles) {
      bf16* kn = k_s + ((j + 1) & 1) * SmemBf16<D>::tile;
      bf16* vn = v_s + ((j + 1) & 1) * SmemBf16<D>::tile;
      load_rows_async<D>(kn, k_bh, k_start + kBK, S_len, kBK);
      load_rows_async<D>(vn, v_bh, k_start + kBK, S_len, kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk)
        ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane % 16)) * ld + kk * 16 + (lane / 16) * 8);
    }

    // ---- s = q . k^T, 16 x 64 per warp, in registers ----
    float s[kNs][4];
#pragma unroll
    for (int i = 0; i < kNs; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
      for (int nn = 0; nn < kNs / 2; ++nn) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, ks + (nn * 16 + (lane / 16) * 8 + (lane % 8)) * ld +
                             kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * nn], qf[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * nn + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // ---- online softmax (log2 domain); thread holds rows qi0 and qi1 ----
    const bool need_mask = (k_start + kBK > S_len) ||
                           (causal && k_start + kBK - 1 > q_start + offset);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < kNs; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = s[i][e] * scale2, v1 = s[i][2 + e] * scale2;
        if (need_mask) {
          const int key = k_start + i * 8 + 2 * t4 + e;
          if (key >= S_len || (causal && key > qi0 + offset)) v0 = kNegInf;
          if (key >= S_len || (causal && key > qi1 + offset)) v1 = kNegInf;
        }
        s[i][e] = v0;
        s[i][2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
    const float mn0 = fmaxf(m_r[0], quad_max(mx0));
    const float mn1 = fmaxf(m_r[1], quad_max(mx1));
    // a row whose keys are all masked so far keeps m = -1e30; exp2(s - m)
    // would be 1 there, so p is forced to 0
    const bool live0 = mn0 > kNegInf * 0.5f, live1 = mn1 > kNegInf * 0.5f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < kNs; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[i][e] = live0 ? exp2f(s[i][e] - mn0) : 0.f;
        s[i][2 + e] = live1 ? exp2f(s[i][2 + e] - mn1) : 0.f;
        sum0 += s[i][e];
        sum1 += s[i][2 + e];
      }
    }
    const float c0 = exp2f(m_r[0] - mn0), c1 = exp2f(m_r[1] - mn1);
    m_r[0] = mn0;
    m_r[1] = mn1;
    l_r[0] = l_r[0] * c0 + sum0;
    l_r[1] = l_r[1] * c1 + sum1;
#pragma unroll
    for (int i = 0; i < kNo; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }

    // ---- o += p . v: p (cast to bf16) repacked as the A operand ----
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < kNo / 2; ++dn) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, vs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ld +
                                   dn * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * dn], pa, bfr[0], bfr[1]);
        mma_bf16(o[2 * dn + 1], pa, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_async_wait<0>();

  // ---- epilogue: normalise, write out and the natural-log lse ----
  const float l0 = quad_sum(l_r[0]), l1 = quad_sum(l_r[1]);
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  bf16* o_bh = out + ((int64_t)b * Hq + h) * T_len * D;
  float* lse_bh = lse + ((int64_t)b * Hq + h) * T_len;
#pragma unroll
  for (int i = 0; i < kNo; ++i) {
    const int d = i * 8 + 2 * t4;
    if (qi0 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(o_bh + (int64_t)qi0 * D + d) =
          __floats2bfloat162_rn(o[i][0] * inv0, o[i][1] * inv0);
    if (qi1 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(o_bh + (int64_t)qi1 * D + d) =
          __floats2bfloat162_rn(o[i][2] * inv1, o[i][3] * inv1);
  }
  if (t4 == 0) {
    if (qi0 < T_len)
      lse_bh[qi0] = l0 == 0.f ? -kNegInf : (m_r[0] + log2f(l0)) * (1.f / kLog2e);
    if (qi1 < T_len)
      lse_bh[qi1] = l1 == 0.f ? -kNegInf : (m_r[1] + log2f(l1)) * (1.f / kLog2e);
  }
}

// ---------------------------------------------------------------- f32

template <int D>
struct SmemF32 {
  // rows padded to an odd count so lanes walking keys at a fixed d hit
  // distinct banks
  static constexpr int ld = D + 1;
  static constexpr int ldS = kBK + 4;
  static constexpr int bytes = ((kBQ + 2 * kBK) * ld + kBQ * ldS + kBQ * ld + 2 * kBQ) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Hq, int Hkv, int T_len,
                     int S_len, int causal, float scale2) {
  using L = SmemF32<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kBQ * L::ld;
  float* v_s = k_s + kBK * L::ld;
  float* s_s = v_s + kBK * L::ld;  // scores, then probabilities
  float* o_s = s_s + kBQ * L::ldS;
  float* m_s = o_s + kBQ * L::ld;
  float* l_s = m_s + kBQ;

  const int q_start = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S_len - T_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;

  const float* q_bh = q + ((int64_t)b * Hq + h) * T_len * D;
  const float* k_bh = k + ((int64_t)b * Hkv + hk) * S_len * D;
  const float* v_bh = v + ((int64_t)b * Hkv + hk) * S_len * D;

  auto load = [&](float* dst, const float* src, int r0, int n_rows, int rows) {
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      dst[r * L::ld + c] = (r0 + r < n_rows) ? src[(int64_t)(r0 + r) * D + c] : 0.f;
    }
  };
  load(q_s, q_bh, q_start, T_len, kBQ);
  for (int i = threadIdx.x; i < kBQ * L::ld; i += kThreads) o_s[i] = 0.f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  const int n_tiles = live_tiles(q_start, T_len, S_len, causal);
  for (int j = 0; j < n_tiles; ++j) {
    const int k_start = j * kBK;
    __syncthreads();  // previous tile's k/v reads are done (and q/o init)
    load(k_s, k_bh, k_start, S_len, kBK);
    load(v_s, v_bh, k_start, S_len, kBK);
    __syncthreads();

    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      for (int c = lane; c < kBK; c += 32) {
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc = fmaf(q_s[r * L::ld + d], k_s[c * L::ld + d], acc);
        s_s[r * L::ldS + c] = acc;
      }
    }
    __syncwarp();

    const bool need_mask = (k_start + kBK > S_len) ||
                           (causal && k_start + kBK - 1 > q_start + offset);
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const int qi = q_start + r;
      float sv[kBK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const int c = lane + 32 * i;
        float sc = s_s[r * L::ldS + c] * scale2;
        if (need_mask) {
          const int kj = k_start + c;
          if (kj >= S_len || (causal && kj > qi + offset)) sc = kNegInf;
        }
        sv[i] = sc;
        mx = fmaxf(mx, sc);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const float p = m_new > kNegInf * 0.5f ? exp2f(sv[i] - m_new) : 0.f;
        sum += p;
        s_s[r * L::ldS + lane + 32 * i] = p;
      }
      sum = warp_sum(sum);
      const float corr = exp2f(m_prev - m_new);
      for (int d = lane; d < D; d += 32) o_s[r * L::ld + d] *= corr;
      __syncwarp();  // every lane has read m_s[r] before lane 0 writes
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = corr * l_s[r] + sum;
      }
    }
    __syncwarp();

    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      for (int d = lane; d < D; d += 32) {
        float acc = o_s[r * L::ld + d];
#pragma unroll 8
        for (int c = 0; c < kBK; ++c) acc = fmaf(s_s[r * L::ldS + c], v_s[c * L::ld + d], acc);
        o_s[r * L::ld + d] = acc;
      }
    }
    __syncwarp();
  }
  __syncthreads();  // covers n_tiles == 0 (init by other warps)

  for (int rr = 0; rr < 16; ++rr) {
    const int r = row0 + rr;
    const int qi = q_start + r;
    if (qi >= T_len) break;
    const float l = l_s[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    float* o_row = out + (((int64_t)b * Hq + h) * T_len + qi) * D;
    for (int d = lane; d < D; d += 32) o_row[d] = o_s[r * L::ld + d] * inv;
    if (lane == 0)
      lse[((int64_t)b * Hq + h) * T_len + qi] =
          l == 0.f ? -kNegInf : (m_s[r] + log2f(l)) * (1.f / kLog2e);
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Hq, int Hkv, int T_len, int S_len,
                   int causal, cudaStream_t stream) {
  void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, int,
                 int, int, float);
  int bytes;
  if constexpr (sizeof(T) == 2) {
    kernel = flash_fwd_bf16_kernel<D>;
    bytes = SmemBf16<D>::bytes;
  } else {
    kernel = flash_fwd_f32_kernel<D>;
    bytes = SmemF32<D>::bytes;
  }
  static bool configured = false;  // one per (dtype, head_dim) instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((T_len + kBQ - 1) / kBQ, Hq, B);
  const float scale2 = (1.0f / sqrtf((float)D)) * kLog2e;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      Hq, Hkv, T_len, S_len, causal, scale2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int Hq, int Hkv,
                       int T_len, int S_len, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, lse, B, Hq, Hkv, T_len, S_len, causal, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, B, Hq, Hkv, T_len, S_len, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, Hq, Hkv, T_len, S_len, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, Hq, Hkv, T_len, S_len, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). is_bf16: 1 = bfloat16, 0 = float32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int Hq, int Hkv,
                         int T_len, int S_len, int D, int is_bf16,
                         int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || T_len <= 0 ||
      S_len <= 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? dispatch_d<bf16>(D, q, k, v, out, lse, B, Hq, Hkv, T_len, S_len, causal, s)
      : dispatch_d<float>(D, q, k, v, out, lse, B, Hq, Hkv, T_len, S_len, causal, s);
  return (int)err;
}
