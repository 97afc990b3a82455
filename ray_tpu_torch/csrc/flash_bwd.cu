// Flash-attention backward for Hopper (sm_90a), bf16 and f32.
//
// Three entry points, one per TPU kernel of ray_tpu/ops/flash_attention.py:
//
//   flash_bwd_fused  replaces `_flash_bwd_fused` (the pl.pallas_call at
//                    :575, body `_bwd_fused_kernel` :432-529): dq, dk and dv
//                    in one visit of each live (q tile, k tile) pair. bf16
//                    at head_dim 128 (the 350m and 1B training shapes) is
//                    flash_bwd_sm90.cu's; this one takes 16/32/64 and f32.
//   flash_bwd_dkv    replaces `_flash_bwd`'s dkv kernel (:707, body
//                    `_dkv_kernel` :368-429): the fused loop without dq.
//   flash_bwd_dq     replaces `_flash_bwd`'s dq kernel (:678, body
//                    `_dq_kernel` :315-365): dq, with the k loop innermost.
//
// bf16 at head_dim 128 (every main path) takes the Hopper kernels of
// flash_bwd_sm90.cu (fused, dkv) and flash_bwd_dq_sm90.cu instead; these
// take head_dim 16/32/64 and f32. flash_bwd_dq and flash_bwd_dkv still
// build bf16 at 128, which no wrapper launches: chip_smoke.py times them
// there beside the Hopper kernels that replaced them.
//
// Contract (as the TPU kernels): q/do [B,Hq,T,D], k/v [B,Hkv,S,D], all
// contiguous, one dtype; lse [B,Hq,T] f32, natural log, from the forward;
// delta = rowsum(do*o) [B,Hq,T] f32, computed by the caller. Query head h
// reads kv head h / (Hq/Hkv). Per pair: p = exp2(s*scale*log2e -
// lse*log2e) with the end-aligned causal mask (row i sees keys <= i + S -
// T); dv += p^T.do with p cast to do's dtype first; dp = do.v^T; ds =
// p*(dp - delta)*scale, cast to the input dtype; dk += ds^T.q; dq +=
// ds.k. Products accumulate in f32. Ragged T and S edges are masked, so
// no divisibility is needed; rows that see no key (lse = +1e30) get p = 0
// and dq = 0.
//
// Rounding: the TPU kernels round per-k-tile dq partials and per-query-
// head dk/dv to the input dtype before summing them (:602, :618-621).
// Here dk/dv sum over the GQA group in f32 registers and dq sums in f32
// (atomics, or registers in flash_bwd_dq), each rounded once at the end.
//
// What bounds them on this card: at the 350m training shape (B=8, Hq=Hkv
// =8, T=S=2048, D=128, causal) the fused kernel does five products per
// live pair, ~1.7e11 flops against ~0.24 GB of inputs and outputs, so it
// is bound by tensor-core operations (~0.17 ms at 989 TFLOP/s bf16). The
// dq kernel does three products per pair, the dkv kernel four.
//
// What the design does about it (bf16):
// - flash_bwd_fused / flash_bwd_dkv: a block owns 128 keys of one
//   (batch, kv head), eight warps of 16 keys. k and v stay in shared
//   memory; the block walks the query heads of its GQA group and, for
//   each, the q tiles of 32 rows from the causal diagonal on (dead tiles
//   are never visited). q, do, lse and delta tiles are double-buffered by
//   cp.async. Each warp computes its 16 x 32 slice of s^T = k.q^T and
//   dp^T = v.do^T with mma.sync m16n8k16 (bf16 in, f32 accumulate), forms
//   p^T and ds^T in registers and repacks them straight into the A operand
//   of dv += p^T.do and dk += ds^T.q; dk and dv (16 x D each) stay in f32
//   registers for the whole walk and are written once. dq is the one sum
//   that crosses blocks: ds goes through shared memory, the block computes
//   its 32 x D piece of ds.k with mma.sync and adds it into an f32 buffer
//   with atomics (the GPU answer that :446-449 names), four floats per
//   vector atomic. The atomic traffic is D floats per query row per key
//   block; 128-key blocks and vector atomics keep it 8x below one scalar
//   atomic per 64 keys. The caller takes the two-kernel path past 8192
//   keys by the reference's rule, not for speed. The atomics' order
//   changes from run to run, so dq is not bitwise reproducible.
// - flash_bwd_dq: a block owns 64 query rows of one (batch, head), four
//   warps of 16 rows, keeps its q and do fragments in registers and walks
//   the live key tiles of 32 (double-buffered by cp.async, as the
//   forward); dq accumulates in f32 registers and is written once, with
//   no atomics, so it is deterministic.
// f32 runs plain-FMA kernels (no TF32) to keep full f32 precision.
//
// Built by ray_tpu_torch/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through a plain C interface (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kBig = 1e30f;  // lse2 of a row past T: p = exp2(-big) = 0

using bf16 = __nv_bfloat16;

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

// Two 8x8 matrices, transposed; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)) : "memory");
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

// The A operand (16 x 16, k16 step kk) from f32 accumulators laid out as
// n8 tiles 2kk and 2kk+1 of a 16-row mma result, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Queue async copies of `rows` rows of a [*, D] bf16 tensor from global
// row `row0` into a shared tile of row stride ld; rows at or past n_rows
// are zeros.
template <int D, int ld, int NT = kThreads>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                int row0, int n_rows, int rows) {
  constexpr int per_row = D / 8;  // 16-byte chunks
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * ld + c, ok ? src + (int64_t)(row0 + r) * D + c : src,
               ok ? 16 : 0);
  }
}

// ------------------------------------------------ bf16: fused and dkv

constexpr int kKB = 128;  // keys per block (16 per warp)
constexpr int kQB = 32;   // query rows per inner tile
constexpr int kKvWarps = kKB / 16;
constexpr int kKvThreads = kKvWarps * 32;

template <int D>
struct KvSmem {
  static constexpr int ld = D + 8;        // row stride (elements): +16 bytes
  static constexpr int ldds = kKB + 8;    // ds tile row stride
  static constexpr int kv = kKB * ld;     // one of k, v
  static constexpr int qt = kQB * ld;     // one stage of q or do
  static constexpr int halves = 2 * kv + 4 * qt + kQB * ldds;
  static constexpr int bytes = halves * 2 + 4 * kQB * 4;  // + lse2, delta x 2
};

// First q tile that a causal k tile starting at k0 is live for: rows i
// with i + offset >= k0.
__device__ __forceinline__ int first_q_tile(int k0, int offset, int causal, int qb) {
  if (!causal) return 0;
  const int first = k0 - offset;
  return first > 0 ? first / qb : 0;
}

// Adds (a, b, c, d) to 4 consecutive floats (16-byte aligned) in one
// vector atomic (sm_90).
__device__ __forceinline__ void atomic_add4(float* p, float a, float b, float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

template <int D, bool kDq>
__global__ void __launch_bounds__(kKvThreads)
flash_bwd_kv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq_acc, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int Hq, int Hkv, int T_len, int S_len,
                  int causal, float scale, float scale2) {
  using L = KvSmem<D>;
  constexpr int ld = L::ld;
  constexpr int kDk = D / 16;   // k16 steps over head_dim
  constexpr int kNq = kQB / 8;  // n8 tiles over a q tile
  constexpr int kNd = D / 8;    // n8 tiles over head_dim
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + L::kv;
  bf16* q_s = v_s + L::kv;         // two stages
  bf16* do_s = q_s + 2 * L::qt;    // two stages
  bf16* ds_s = do_s + 2 * L::qt;   // [kQB][ldds], ds of the current pair
  float* lse2_s = reinterpret_cast<float*>(ds_s + kQB * L::ldds);  // two stages
  float* dl_s = lse2_s + 2 * kQB;                                  // two stages

  const int k0 = blockIdx.x * kKB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int offset = S_len - T_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;  // this thread's keys

  const int qt0 = first_q_tile(k0, offset, causal, kQB);
  const int per_head = (T_len + kQB - 1) / kQB - qt0;
  const int n_iter = per_head > 0 ? per_head * group : 0;

  const int64_t kv_off = ((int64_t)b * Hkv + hk) * S_len * D;
  load_rows_async<D, ld, kKvThreads>(k_s, k + kv_off, k0, S_len, kKB);
  load_rows_async<D, ld, kKvThreads>(v_s, v + kv_off, k0, S_len, kKB);

  // queue the q/do tile of iteration `it` into `stage`; lse/delta by plain
  // stores (read only after the barrier that follows the wait)
  auto issue = [&](int it, int stage) {
    const int h = hk * group + it / per_head;
    const int q0 = (qt0 + it % per_head) * kQB;
    const int64_t bh = (int64_t)b * Hq + h;
    load_rows_async<D, ld, kKvThreads>(q_s + stage * L::qt, q + bh * T_len * D, q0,
                                       T_len, kQB);
    load_rows_async<D, ld, kKvThreads>(do_s + stage * L::qt, dout + bh * T_len * D, q0,
                                       T_len, kQB);
    for (int i = threadIdx.x; i < kQB; i += kKvThreads) {
      const int qi = q0 + i;
      lse2_s[stage * kQB + i] = qi < T_len ? lse[bh * T_len + qi] * kLog2e : kBig;
      dl_s[stage * kQB + i] = qi < T_len ? delta[bh * T_len + qi] : 0.f;
    }
  };
  if (n_iter > 0) issue(0, 0);
  cp_async_commit();

  float dk_acc[kNd][4], dv_acc[kNd][4];
#pragma unroll
  for (int i = 0; i < kNd; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const bf16* kw = k_s + (warp * 16 + (lane % 16)) * ld + (lane / 16) * 8;  // A rows
  const bf16* vw = v_s + (warp * 16 + (lane % 16)) * ld + (lane / 16) * 8;

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) {
      issue(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int h = hk * group + it / per_head;
    const int q0 = (qt0 + it % per_head) * kQB;
    const bf16* qs = q_s + stage * L::qt;
    const bf16* dos = do_s + stage * L::qt;
    const float* l2 = lse2_s + stage * kQB;
    const float* dl = dl_s + stage * kQB;

    // ---- s^T = k_w . q^T and dp^T = v_w . do^T, 16 keys x 32 rows ----
    float st[kNq][4], dpt[kNq][4];
#pragma unroll
    for (int i = 0; i < kNq; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, kw + kk * 16);
      ldmatrix_x4(va, vw + kk * 16);
#pragma unroll
      for (int nn = 0; nn < kNq / 2; ++nn) {
        const int off = (nn * 16 + (lane / 16) * 8 + (lane % 8)) * ld + kk * 16 +
                        ((lane / 8) % 2) * 8;
        uint32_t bq[4], bd[4];
        ldmatrix_x4(bq, qs + off);
        ldmatrix_x4(bd, dos + off);
        mma_bf16(st[2 * nn], ka, bq[0], bq[1]);
        mma_bf16(st[2 * nn + 1], ka, bq[2], bq[3]);
        mma_bf16(dpt[2 * nn], va, bd[0], bd[1]);
        mma_bf16(dpt[2 * nn + 1], va, bd[2], bd[3]);
      }
    }

    // ---- p^T (masked) into st; ds^T into dpt ----
    const bool need_mask = (k0 + kKB > S_len) || (causal && k0 + kKB - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < kNq; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = i * 8 + 2 * t4 + e;
        const int qi = q0 + ql;
        float p0 = exp2f(st[i][e] * scale2 - l2[ql]);
        float p1 = exp2f(st[i][2 + e] * scale2 - l2[ql]);
        if (need_mask) {
          if (key0 >= S_len || (causal && key0 > qi + offset)) p0 = 0.f;
          if (key1 >= S_len || (causal && key1 > qi + offset)) p1 = 0.f;
        }
        st[i][e] = p0;
        st[i][2 + e] = p1;
        dpt[i][e] = p0 * (dpt[i][e] - dl[ql]) * scale;
        dpt[i][2 + e] = p1 * (dpt[i][2 + e] - dl[ql]) * scale;
      }
    }

    // ---- dv_w += p^T . do and dk_w += ds^T . q (16 x D) ----
#pragma unroll
    for (int kk = 0; kk < kQB / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kNd / 2; ++dn) {
        const int off = (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ld + dn * 16 +
                        (lane / 16) * 8;
        uint32_t bd[4], bq[4];
        ldmatrix_x4_trans(bd, dos + off);
        ldmatrix_x4_trans(bq, qs + off);
        mma_bf16(dv_acc[2 * dn], pa, bd[0], bd[1]);
        mma_bf16(dv_acc[2 * dn + 1], pa, bd[2], bd[3]);
        mma_bf16(dk_acc[2 * dn], da, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * dn + 1], da, bq[2], bq[3]);
      }
    }

    if constexpr (kDq) {
      // ---- ds (bf16) to shared memory as [q row][key] ----
#pragma unroll
      for (int i = 0; i < kNq; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = i * 8 + 2 * t4 + e;
          ds_s[ql * L::ldds + warp * 16 + g] = __float2bfloat16_rn(dpt[i][e]);
          ds_s[ql * L::ldds + warp * 16 + g + 8] = __float2bfloat16_rn(dpt[i][2 + e]);
        }
      }
      __syncthreads();
      // ---- dq[q0 + 16 mt .., n8 tile nt] += ds . k, added atomically;
      // warp w takes m tile w % 2 and every (kKvWarps / 2)-th n8 tile ----
      constexpr int kNg = kKvWarps / 2;
      constexpr int kJ = (kNd + kNg - 1) / kNg;
      const int mt = warp & 1;
      float dq_c[kJ][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_c[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKB / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, ds_s + (mt * 16 + (lane % 16)) * L::ldds + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int nt = (warp >> 1) + kNg * j;
          if (nt < kNd) {  // warp-uniform
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1, k_s + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ld +
                                          nt * 8);
            mma_bf16(dq_c[j], a, b0, b1);
          }
        }
      }
      // lanes t4 and t4^1 trade halves so that each adds 4 consecutive
      // columns of one row: even t4 row r0, odd t4 row r1
      float* dq_bh = dq_acc + ((int64_t)b * Hq + h) * T_len * D;
      const bool even = (t4 & 1) == 0;
      const int row = q0 + mt * 16 + g + (even ? 0 : 8);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int nt = (warp >> 1) + kNg * j;
        const float o0 = __shfl_xor_sync(0xffffffffu, dq_c[j][0], 1);
        const float o1 = __shfl_xor_sync(0xffffffffu, dq_c[j][1], 1);
        const float o2 = __shfl_xor_sync(0xffffffffu, dq_c[j][2], 1);
        const float o3 = __shfl_xor_sync(0xffffffffu, dq_c[j][3], 1);
        if (nt < kNd && row < T_len) {
          float* dst = dq_bh + (int64_t)row * D + nt * 8 + 2 * (t4 & ~1);
          if (even)
            atomic_add4(dst, dq_c[j][0], dq_c[j][1], o0, o1);
          else
            atomic_add4(dst, o2, o3, dq_c[j][2], dq_c[j][3]);
        }
      }
    }
    __syncthreads();  // this stage and ds_s are free for the next tiles
  }
  cp_async_wait<0>();

  // ---- epilogue: dk, dv rounded once to bf16 ----
  bf16* dk_b = dk + kv_off;
  bf16* dv_b = dv + kv_off;
#pragma unroll
  for (int i = 0; i < kNd; ++i) {
    const int d = i * 8 + 2 * t4;
    if (key0 < S_len) {
      *reinterpret_cast<__nv_bfloat162*>(dk_b + (int64_t)key0 * D + d) =
          __floats2bfloat162_rn(dk_acc[i][0], dk_acc[i][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_b + (int64_t)key0 * D + d) =
          __floats2bfloat162_rn(dv_acc[i][0], dv_acc[i][1]);
    }
    if (key1 < S_len) {
      *reinterpret_cast<__nv_bfloat162*>(dk_b + (int64_t)key1 * D + d) =
          __floats2bfloat162_rn(dk_acc[i][2], dk_acc[i][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv_b + (int64_t)key1 * D + d) =
          __floats2bfloat162_rn(dv_acc[i][2], dv_acc[i][3]);
    }
  }
}

// ------------------------------------------------------- bf16: dq

constexpr int kQR = 64;  // query rows per block (16 per warp)
constexpr int kKT = 32;  // keys per tile

template <int D>
struct DqSmem {
  static constexpr int ld = D + 8;
  static constexpr int tile = kKT * ld;
  static constexpr int bytes = (2 * kQR * ld + 4 * tile) * 2;  // q, do, 2 x (k, v)
};

// Number of key tiles a dq block visits: under the causal mask, tiles
// past the last live key of the block's last real row are dead.
__device__ __forceinline__ int live_key_tiles(int q_start, int qr, int kt, int T_len,
                                              int S_len, int causal) {
  int n = (S_len + kt - 1) / kt;
  if (causal) {
    const int last_row = min(q_start + qr, T_len) - 1;
    const int last_key = min(last_row + S_len - T_len, S_len - 1);
    n = last_key < 0 ? 0 : min(n, last_key / kt + 1);
  }
  return n;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int Hq, int Hkv, int T_len, int S_len,
                  int causal, float scale, float scale2) {
  using L = DqSmem<D>;
  constexpr int ld = L::ld;
  constexpr int kDk = D / 16;
  constexpr int kNs = kKT / 8;
  constexpr int kNd = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kQR * ld;
  bf16* k_s = do_s + kQR * ld;     // two stages
  bf16* v_s = k_s + 2 * L::tile;   // two stages

  // last q tile first: under the causal mask it has the most key tiles
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kQR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S_len - T_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qi0 = q_start + warp * 16 + g, qi1 = qi0 + 8;

  const int64_t bh = (int64_t)b * Hq + h;
  const bf16* q_bh = q + bh * T_len * D;
  const bf16* do_bh = dout + bh * T_len * D;
  const bf16* k_bh = k + ((int64_t)b * Hkv + hk) * S_len * D;
  const bf16* v_bh = v + ((int64_t)b * Hkv + hk) * S_len * D;
  const float l0 = qi0 < T_len ? lse[bh * T_len + qi0] * kLog2e : kBig;
  const float l1 = qi1 < T_len ? lse[bh * T_len + qi1] * kLog2e : kBig;
  const float d0 = qi0 < T_len ? delta[bh * T_len + qi0] : 0.f;
  const float d1 = qi1 < T_len ? delta[bh * T_len + qi1] : 0.f;

  const int n_tiles = live_key_tiles(q_start, kQR, kKT, T_len, S_len, causal);
  load_rows_async<D, ld>(q_s, q_bh, q_start, T_len, kQR);
  load_rows_async<D, ld>(do_s, do_bh, q_start, T_len, kQR);
  if (n_tiles > 0) {
    load_rows_async<D, ld>(k_s, k_bh, 0, S_len, kKT);
    load_rows_async<D, ld>(v_s, v_bh, 0, S_len, kKT);
  }
  cp_async_commit();

  float dq_acc[kNd][4];
#pragma unroll
  for (int i = 0; i < kNd; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;
  uint32_t qf[kDk][4], df[kDk][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k_start = j * kKT;
    const bf16* ks = k_s + (j & 1) * L::tile;
    const bf16* vs = v_s + (j & 1) * L::tile;
    if (j + 1 < n_tiles) {
      load_rows_async<D, ld>(k_s + ((j + 1) & 1) * L::tile, k_bh, k_start + kKT, S_len, kKT);
      load_rows_async<D, ld>(v_s + ((j + 1) & 1) * L::tile, v_bh, k_start + kKT, S_len, kKT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk) {
        const int off = (warp * 16 + (lane % 16)) * ld + kk * 16 + (lane / 16) * 8;
        ldmatrix_x4(qf[kk], q_s + off);
        ldmatrix_x4(df[kk], do_s + off);
      }
    }

    // ---- s = q . k^T and dp = do . v^T, 16 rows x 32 keys per warp ----
    float s[kNs][4], dp[kNs][4];
#pragma unroll
    for (int i = 0; i < kNs; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
      for (int nn = 0; nn < kNs / 2; ++nn) {
        const int off = (nn * 16 + (lane / 16) * 8 + (lane % 8)) * ld + kk * 16 +
                        ((lane / 8) % 2) * 8;
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, ks + off);
        ldmatrix_x4(bv, vs + off);
        mma_bf16(s[2 * nn], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * nn + 1], qf[kk], bk[2], bk[3]);
        mma_bf16(dp[2 * nn], df[kk], bv[0], bv[1]);
        mma_bf16(dp[2 * nn + 1], df[kk], bv[2], bv[3]);
      }
    }

    // ---- ds = p (dp - delta) scale, p masked ----
    const bool need_mask = (k_start + kKT > S_len) ||
                           (causal && k_start + kKT - 1 > q_start + offset);
#pragma unroll
    for (int i = 0; i < kNs; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2f(s[i][e] * scale2 - l0);
        float p1 = exp2f(s[i][2 + e] * scale2 - l1);
        if (need_mask) {
          const int key = k_start + i * 8 + 2 * t4 + e;
          if (key >= S_len || (causal && key > qi0 + offset)) p0 = 0.f;
          if (key >= S_len || (causal && key > qi1 + offset)) p1 = 0.f;
        }
        s[i][e] = p0 * (dp[i][e] - d0) * scale;
        s[i][2 + e] = p1 * (dp[i][2 + e] - d1) * scale;
      }
    }

    // ---- dq += ds . k: ds (bf16) repacked as the A operand ----
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kNd / 2; ++dn) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, ks + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ld +
                                   dn * 16 + (lane / 16) * 8);
        mma_bf16(dq_acc[2 * dn], a, bfr[0], bfr[1]);
        mma_bf16(dq_acc[2 * dn + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_async_wait<0>();

  bf16* dq_bh = dq + bh * T_len * D;
#pragma unroll
  for (int i = 0; i < kNd; ++i) {
    const int d = i * 8 + 2 * t4;
    if (qi0 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(dq_bh + (int64_t)qi0 * D + d) =
          __floats2bfloat162_rn(dq_acc[i][0], dq_acc[i][1]);
    if (qi1 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(dq_bh + (int64_t)qi1 * D + d) =
          __floats2bfloat162_rn(dq_acc[i][2], dq_acc[i][3]);
  }
}

// ------------------------------------------------------------ f32

constexpr int kF = 32;  // query rows and keys per f32 tile

template <int D>
struct F32Smem {
  // rows padded to an odd count so lanes walking keys at a fixed d hit
  // distinct banks
  static constexpr int ld = D + 1;
  static constexpr int ldp = kF + 1;
  static constexpr int bytes = (4 * kF * ld + 2 * kF * ldp + 2 * kF) * 4;
};

// p and ds of one [kF rows x kF keys] tile into p_s / ds_s ([row][key]).
// q_s/do_s hold rows q0.., k_s/v_s keys k0..; l2 (lse*log2e, kBig past T)
// and dl (delta) per row.
template <int D>
__device__ __forceinline__ void p_ds_tile_f32(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* l2, const float* dl, float* p_s, float* ds_s, int q0, int k0,
    int S_len, int offset, int causal, float scale, float scale2) {
  using L = F32Smem<D>;
  for (int e = threadIdx.x; e < kF * kF; e += kThreads) {
    const int r = e / kF, c = e % kF;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      s = fmaf(q_s[r * L::ld + d], k_s[c * L::ld + d], s);
      dp = fmaf(do_s[r * L::ld + d], v_s[c * L::ld + d], dp);
    }
    const int kj = k0 + c;
    float p = exp2f(s * scale2 - l2[r]);
    if (kj >= S_len || (causal && kj > q0 + r + offset)) p = 0.f;
    p_s[r * L::ldp + c] = p;
    ds_s[r * L::ldp + c] = p * (dp - dl[r]) * scale;
  }
}

template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int row0,
                                              int n_rows) {
  for (int i = threadIdx.x; i < kF * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = (row0 + r < n_rows) ? src[(int64_t)(row0 + r) * D + c] : 0.f;
  }
}

template <int D, bool kDq>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq_acc, float* __restrict__ dk,
                 float* __restrict__ dv, int Hq, int Hkv, int T_len, int S_len,
                 int causal, float scale, float scale2) {
  using L = F32Smem<D>;
  constexpr int kPer = kF * D / kThreads;  // accumulator elements per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + kF * L::ld;
  float* q_s = v_s + kF * L::ld;
  float* do_s = q_s + kF * L::ld;
  float* p_s = do_s + kF * L::ld;
  float* ds_s = p_s + kF * L::ldp;
  float* l2_s = ds_s + kF * L::ldp;
  float* dl_s = l2_s + kF;

  const int k0 = blockIdx.x * kF;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int offset = S_len - T_len;
  const int qt0 = first_q_tile(k0, offset, causal, kF);
  const int per_head = (T_len + kF - 1) / kF - qt0;
  const int n_iter = per_head > 0 ? per_head * group : 0;

  const int64_t kv_off = ((int64_t)b * Hkv + hk) * S_len * D;
  load_rows_f32<D>(k_s, k + kv_off, k0, S_len);
  load_rows_f32<D>(v_s, v + kv_off, k0, S_len);

  float dk_r[kPer], dv_r[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dk_r[i] = dv_r[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int h = hk * group + it / per_head;
    const int q0 = (qt0 + it % per_head) * kF;
    const int64_t bh = (int64_t)b * Hq + h;
    __syncthreads();  // the previous tile's reads are done
    load_rows_f32<D>(q_s, q + bh * T_len * D, q0, T_len);
    load_rows_f32<D>(do_s, dout + bh * T_len * D, q0, T_len);
    for (int i = threadIdx.x; i < kF; i += kThreads) {
      const int qi = q0 + i;
      l2_s[i] = qi < T_len ? lse[bh * T_len + qi] * kLog2e : kBig;
      dl_s[i] = qi < T_len ? delta[bh * T_len + qi] : 0.f;
    }
    __syncthreads();
    p_ds_tile_f32<D>(q_s, do_s, k_s, v_s, l2_s, dl_s, p_s, ds_s, q0, k0, S_len,
                     offset, causal, scale, scale2);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int c = e / D, d = e % D;  // key, column
#pragma unroll 8
      for (int r = 0; r < kF; ++r) {
        dv_r[i] = fmaf(p_s[r * L::ldp + c], do_s[r * L::ld + d], dv_r[i]);
        dk_r[i] = fmaf(ds_s[r * L::ldp + c], q_s[r * L::ld + d], dk_r[i]);
      }
    }
    if constexpr (kDq) {
      float* dq_bh = dq_acc + bh * T_len * D;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = threadIdx.x + kThreads * i;
        const int r = e / D, d = e % D;  // row, column
        if (q0 + r >= T_len) continue;
        float acc = 0.f;
#pragma unroll 8
        for (int c = 0; c < kF; ++c) acc = fmaf(ds_s[r * L::ldp + c], k_s[c * L::ld + d], acc);
        atomicAdd(dq_bh + (int64_t)(q0 + r) * D + d, acc);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int c = e / D, d = e % D;
    if (k0 + c < S_len) {
      dk[kv_off + (int64_t)(k0 + c) * D + d] = dk_r[i];
      dv[kv_off + (int64_t)(k0 + c) * D + d] = dv_r[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int Hq, int Hkv, int T_len, int S_len,
                 int causal, float scale, float scale2) {
  using L = F32Smem<D>;
  constexpr int kPer = kF * D / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + kF * L::ld;
  float* q_s = v_s + kF * L::ld;
  float* do_s = q_s + kF * L::ld;
  float* p_s = do_s + kF * L::ld;
  float* ds_s = p_s + kF * L::ldp;
  float* l2_s = ds_s + kF * L::ldp;
  float* dl_s = l2_s + kF;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S_len - T_len;
  const int64_t bh = (int64_t)b * Hq + h;
  const int64_t kv_off = ((int64_t)b * Hkv + hk) * S_len * D;

  load_rows_f32<D>(q_s, q + bh * T_len * D, q0, T_len);
  load_rows_f32<D>(do_s, dout + bh * T_len * D, q0, T_len);
  for (int i = threadIdx.x; i < kF; i += kThreads) {
    const int qi = q0 + i;
    l2_s[i] = qi < T_len ? lse[bh * T_len + qi] * kLog2e : kBig;
    dl_s[i] = qi < T_len ? delta[bh * T_len + qi] : 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  const int n_tiles = live_key_tiles(q0, kF, kF, T_len, S_len, causal);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kF;
    __syncthreads();  // the previous tile's reads are done
    load_rows_f32<D>(k_s, k + kv_off, k0, S_len);
    load_rows_f32<D>(v_s, v + kv_off, k0, S_len);
    __syncthreads();
    p_ds_tile_f32<D>(q_s, do_s, k_s, v_s, l2_s, dl_s, p_s, ds_s, q0, k0, S_len,
                     offset, causal, scale, scale2);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / D, d = e % D;
#pragma unroll 8
      for (int c = 0; c < kF; ++c) acc[i] = fmaf(ds_s[r * L::ldp + c], k_s[c * L::ld + d], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int r = e / D, d = e % D;
    if (q0 + r < T_len) dq[(bh * T_len + q0 + r) * D + d] = acc[i];
  }
}

// ---------------------------------------------------------- launch

enum class Mode { kFused, kDkv, kDq };

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;  // dq: f32 accumulator (fused), or dq in the input dtype (dq)
  int B, Hq, Hkv, T_len, S_len, causal;
};

template <typename K>
cudaError_t set_smem(K kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename T, int D, Mode M>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const float scale2 = scale * kLog2e;
  static bool configured = false;  // one per (dtype, head_dim, mode) instance
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if constexpr (M == Mode::kDq) {
    constexpr bool bf = sizeof(T) == 2;
    const int rows = bf ? kQR : kF;
    const dim3 grid((a.T_len + rows - 1) / rows, a.Hq, a.B);
    if constexpr (bf) {
      err = set_smem(flash_bwd_dq_bf16<D>, DqSmem<D>::bytes, configured);
      if (err != cudaSuccess) return err;
      flash_bwd_dq_bf16<D><<<grid, kThreads, DqSmem<D>::bytes, stream>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.Hq, a.Hkv, a.T_len,
          a.S_len, a.causal, scale, scale2);
    } else {
      err = set_smem(flash_bwd_dq_f32<D>, F32Smem<D>::bytes, configured);
      if (err != cudaSuccess) return err;
      flash_bwd_dq_f32<D><<<grid, kThreads, F32Smem<D>::bytes, stream>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.Hq, a.Hkv, a.T_len,
          a.S_len, a.causal, scale, scale2);
    }
  } else {
    constexpr bool kDq = M == Mode::kFused;
    constexpr bool bf = sizeof(T) == 2;
    const int keys = bf ? kKB : kF;
    const dim3 grid((a.S_len + keys - 1) / keys, a.Hkv, a.B);
    float* dq_acc = static_cast<float*>(a.dq);
    if constexpr (bf) {
      err = set_smem(flash_bwd_kv_bf16<D, kDq>, KvSmem<D>::bytes, configured);
      if (err != cudaSuccess) return err;
      flash_bwd_kv_bf16<D, kDq><<<grid, kKvThreads, KvSmem<D>::bytes, stream>>>(
          q, k, v, dout, lse, delta, dq_acc, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.Hq, a.Hkv, a.T_len, a.S_len, a.causal, scale, scale2);
    } else {
      err = set_smem(flash_bwd_kv_f32<D, kDq>, F32Smem<D>::bytes, configured);
      if (err != cudaSuccess) return err;
      flash_bwd_kv_f32<D, kDq><<<grid, kThreads, F32Smem<D>::bytes, stream>>>(
          q, k, v, dout, lse, delta, dq_acc, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.Hq, a.Hkv, a.T_len, a.S_len, a.causal, scale, scale2);
    }
  }
  return cudaGetLastError();
}

template <typename T, Mode M>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16, M>(a, s);
    case 32: return launch<T, 32, M>(a, s);
    case 64: return launch<T, 64, M>(a, s);
    case 128:  // the fused bf16 kernel at 128 is flash_bwd_sm90's (dq and dkv: see the top note)
      if constexpr (sizeof(T) == 2 && M == Mode::kFused) return cudaErrorInvalidValue;
      else return launch<T, 128, M>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <Mode M>
int run(const Args& a, int D, int is_bf16, void* stream) {
  if (a.B <= 0 || a.Hq <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.T_len <= 0 ||
      a.S_len <= 0 || a.Hq > 65535 || a.B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch_d<bf16, M>(D, a, s) : dispatch_d<float, M>(D, a, s));
}

}  // namespace

// Each returns a cudaError_t (0 = launched). is_bf16: 1 = bfloat16, 0 =
// float32. dq_acc is a zeroed f32 [B,Hq,T,D] buffer that flash_bwd_fused
// adds into; dq, dk and dv are written in the input dtype.
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               void* dq_acc, void* dk, void* dv, int B, int Hq,
                               int Hkv, int T_len, int S_len, int D, int is_bf16,
                               int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq_acc, dk, dv, B, Hq, Hkv, T_len, S_len, causal};
  return run<Mode::kFused>(a, D, is_bf16, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv, int B, int Hq, int Hkv, int T_len,
                             int S_len, int D, int is_bf16, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, B, Hq, Hkv, T_len, S_len, causal};
  return run<Mode::kDkv>(a, D, is_bf16, stream);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            void* dq, int B, int Hq, int Hkv, int T_len, int S_len,
                            int D, int is_bf16, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Hq, Hkv, T_len, S_len, causal};
  return run<Mode::kDq>(a, D, is_bf16, stream);
}
