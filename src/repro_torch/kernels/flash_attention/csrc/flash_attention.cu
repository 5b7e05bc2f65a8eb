// Flash-attention forward (causal or not, GQA) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel of the reference package:
//   src/repro/kernels/flash_attention/kernel.py:91 flash_attention_pallas
//     (body _kernel :26)
//
// What it computes, for query head h (reading KV head h / n_rep), query row
// i at position q_pos = q_offset + i and key j at kv_pos = j:
//   s = q . k * scale                        f32 scores (the f32 kernel and
//                                            the twin scale q first)
//   valid = kv_pos < kv_valid  [&& kv_pos <= q_pos when causal]
//   s = valid ? s : -1e30                    never -inf
// then the online softmax over key blocks, from m = -1e30, l = 0, acc = 0:
//   m' = max(m, max_j s);  p = exp(s - m');  corr = exp(m - m')
//   l  = l * corr + sum_j p;  acc = acc * corr + p . v;  m = m'
// and out = acc / max(l, 1e-30), cast to the input type.  A row with no
// valid key (kv_valid <= 0) meets p = exp(0) = 1 at every key the
// reference walks, so its output is the mean of V over the reference's
// round_up(Tk, bk) logical keys, zero padding included.
//
// Two kernels, by input type:
//
// * float32: flash_attention_kernel<float, HD>, on CUDA cores.  It walks
//   the reference's own logical key blocks of bk keys and spells each step
//   as the reference does, so it holds to its plain twin (kernel.py) within
//   2e-5: only the order of the sums inside a block differs.
// * bfloat16: flash_attention_bf16_tc<HD>, on the tensor cores (wgmma).
//   It sums in the tensor cores' order, not the twin's, and is held instead
//   to an f64 oracle within the forward-error bound of ref.py
//   (oracle_and_bound).  Its design is described above the kernel.
//
// Skipped blocks.  A CTA stops after the last key block that holds a valid
// key for one of its rows.  That is exact: when kv_valid > 0 and
// q_offset >= 0, key 0 is valid for every row, so every row has met a valid
// key in its first block and m is a real score from then on; a later block
// whose keys are all masked for a row gives p = exp(-1e30 - m) = 0 exactly
// and corr = exp(0) = 1 exactly, so l and acc do not change by a bit.  With
// kv_valid <= 0 no key is ever valid, the reference's p = exp(0) = 1 runs
// through every block, and the CTA then walks every key.
//
// The float32 kernel: one CTA of 128 threads per (q tile of 32 rows, head,
// batch); Q^T, the K^T and V tiles of one logical block and P^T staged in
// shared memory as f32; each thread holds a 4 x 8 score tile and a
// 4 x (hd / 16) output tile in registers, with m and l per row kept in
// registers and reduced across the 16 threads of a half-warp with shuffles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kQRows = 32;            // query rows per CTA
constexpr int kThreads = 128;         // thread t: rows 4 * (t / 16) .. +3, lane group t % 16
constexpr int kMaxBk = 128;           // longest logical KV block
constexpr int kKeys = kMaxBk / 16;    // keys per thread in the score tile
constexpr int kRowStride = kQRows + 4;  // Q^T / P^T row stride in floats (16-byte rows)
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sqb, sqt, sqh;  // element strides; the head dim is contiguous
  long long skb, skt, skh;
  long long svb, svt, svh;
  long long sob, sot, soh;
  int Tq, Tk, n_rep;
  float scale;
  int causal, q_offset, kv_valid, bk, n_k;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__host__ __device__ constexpr size_t smem_floats(int hd, int bk) {
  return (size_t)hd * kRowStride + (size_t)hd * (bk + 1) + (size_t)bk * hd + (size_t)bk * kRowStride;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Params p) {
  constexpr int kCols = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bk = p.bk;
  float* qT = smem;                        // [HD][kRowStride]  q * scale, transposed
  float* kT = qT + HD * kRowStride;        // [HD][bk + 1]      K tile, transposed (odd stride)
  float* vS = kT + HD * (bk + 1);          // [bk][HD]          V tile
  float* pT = vS + bk * HD;                // [bk][kRowStride]  P tile, transposed

  const int t = threadIdx.x;
  const int rg = t >> 4;  // row group: rows 4 * rg .. 4 * rg + 3 of the tile
  const int lg = t & 15;  // lane group: keys lg + 16 * i (scores), columns 4 * lg + 64 * g (output)
  const int q0 = blockIdx.x * kQRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.n_rep;

  const T* qg = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;

  for (int e = t; e < kQRows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int row = q0 + r;
    qT[d * kRowStride + r] = row < p.Tq ? __fmul_rn(to_f32(qg[row * p.sqt + d]), p.scale) : 0.0f;
  }

  // Blocks this CTA must walk (see "Skipped blocks" above).
  int n_blocks = p.n_k;
  if (p.kv_valid > 0) {
    int limit = p.kv_valid;
    if (p.causal) limit = min(limit, p.q_offset + min(q0 + kQRows, p.Tq));
    n_blocks = max(1, min(p.n_k, (limit + bk - 1) / bk));
  }
  const int n_mine = lg < bk ? (bk - lg + 15) / 16 : 0;  // keys of this thread that exist
  const float neg_inf = __int_as_float(0xff800000u);     // marks keys past bk: no part in max or sum

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  for (int kb = 0; kb < n_blocks; ++kb) {
    const int kv0 = kb * bk;
    __syncthreads();  // the previous block's P^T and V are consumed
    for (int e = t; e < bk * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const int key = kv0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < p.Tk) {
        kx = to_f32(kg[key * p.skt + d]);
        vx = to_f32(vg[key * p.svt + d]);
      }
      kT[d * (bk + 1) + j] = kx;
      vS[j * HD + d] = vx;
    }
    __syncthreads();

    // Scores for rows 4rg..4rg+3 and keys lg + 16 i.
    float s[4][kKeys];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < kKeys; ++i) s[r][i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qT[d * kRowStride + 4 * rg]);
      const float* kr = &kT[d * (bk + 1) + lg];
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        if (i < n_mine) {
          const float kx = kr[16 * i];
          s[0][i] = fmaf(qv.x, kx, s[0][i]);
          s[1][i] = fmaf(qv.y, kx, s[1][i]);
          s[2][i] = fmaf(qv.z, kx, s[2][i]);
          s[3][i] = fmaf(qv.w, kx, s[3][i]);
        }
      }
    }

    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q_pos = p.q_offset + q0 + 4 * rg + r;
      float mx = neg_inf;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const int kv_pos = kv0 + lg + 16 * i;
        bool valid = kv_pos < p.kv_valid;
        if (p.causal) valid = valid && kv_pos <= q_pos;
        s[r][i] = i < n_mine ? (valid ? s[r][i] : kNeg) : neg_inf;
        mx = fmaxf(mx, s[r][i]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float ps = 0.0f;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        s[r][i] = expf(__fsub_rn(s[r][i], m_new));  // exp(-inf) = 0 for keys past bk
        ps = __fadd_rn(ps, s[r][i]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, off));
      corr[r] = expf(__fsub_rn(m[r], m_new));
      l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), ps);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      if (i < n_mine) {
        *reinterpret_cast<float4*>(&pT[(lg + 16 * i) * kRowStride + 4 * rg]) =
            make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V for rows 4rg..4rg+3, columns 64 g + 4 lg + c.
    float pv[4][kCols];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) pv[r][c] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < bk; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(&pT[j * kRowStride + 4 * rg]);
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&vS[j * HD + 64 * g + 4 * lg]);
        const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[r][4 * g + c] = fmaf(pr[r], vc[c], pv[r][4 * g + c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = __fadd_rn(__fmul_rn(acc[r][c], corr[r]), pv[r][c]);
  }

  T* og = static_cast<T*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * rg + r;
    if (row >= p.Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int g = 0; g < kCols / 4; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        og[row * p.sot + 64 * g + 4 * lg + c] = from_f32<T>(__fdiv_rn(acc[r][4 * g + c], denom));
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  static bool configured = false;
  const size_t max_bytes = smem_floats(HD, kMaxBk) * sizeof(float);
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((p.Tq + kQRows - 1) / kQRows, H, B);
  const size_t bytes = smem_floats(HD, p.bk) * sizeof(float);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The bfloat16 kernel on the tensor cores
// ---------------------------------------------------------------------------
//
// Bound on this card: at the lm_logits shape (B=2, T=1000, 14 query heads
// on 2 KV heads, hd=64, causal) the work is 4 * hd flops per live score
// entry, 0.00363 ms at the dense bf16 peak, against 0.00245 ms to read q,
// k, v and write the output once: the call is bound by operations, so the
// products belong on the tensor cores.  The design:
//
// * GQA packing.  A CTA is one warpgroup (128 threads) and owns 64 rows of
//   one KV head's query rows, row rho = i * n_rep + (h mod n_rep): the
//   n_rep query heads that read one KV head sit in one M tile, so each K
//   and V tile is read once for all of them, and the 64-row M tile of
//   wgmma is full even at the short serve prompts (Tq = 16 .. 64).  In the
//   (B, T, H, hd) layout those rows are contiguous runs of the query.
//   Under a causal mask the CTAs of the last rows walk the most key tiles,
//   so they are dispatched first (blockIdx.x counts rows from the end).
// * S = Q K^T on wgmma m64n64k16, bf16 x bf16 -> f32, Q from registers
//   (loaded once, in the A-fragment layout) and K from shared memory.  The
//   products of bf16 values are exact; scale (times log2 e, for exp2) is
//   applied to the f32 scores after the product, since q * scale would
//   round in bf16 (hd = 128: the scale is not a power of two).
// * P . V on wgmma with P from registers: the f32 score fragment of S is
//   laid out as the A fragment of the next product, so P never goes through
//   shared memory.  P is split into kPTerms = 2 bf16 terms, p = hi + lo
//   (lo the bf16 rounding of p - hi), and each term is one wgmma into the
//   same f32 accumulator.  One term rounds each p to 8 bits and fails the
//   bound of ref.py by 9-12x; two leave at most 2^-18 p, far below the
//   output's own bf16 rounding wherever the output does not cancel, and
//   hold the bound in every case tried on the card, as does a third term
//   at 20% more time (PERF.md).  A third term is the change to make if a
//   row ever needs it: few live keys (n_i < 16), scores near zero and an
//   output that cancels, all at once.
// * K and V tiles of 64 keys by TMA (cuTensorMapEncodeTiled on the
//   strided (B, T, KV, hd) view, no copy), 128-byte swizzle, into a ring
//   of two stages with one mbarrier each: the tile after the current one
//   is in flight while the current one is multiplied.  Keys past Tk are
//   filled with zeros by the TMA unit (the reference's zero padding).
// * Online softmax in registers: each thread holds two rows (the
//   accumulator layout of wgmma), row max and sum over the four lanes of a
//   row by shuffles; -1e30 masks, m from -1e30, l * corr + sum p, and the
//   max(l, 1e-30) guard as in the reference.  The CTA's key tiles are its
//   own (64 keys), not the reference's bk: the online softmax computes the
//   same function under any partition of the keys.  Only rows with no
//   valid key depend on bk, and they divide by round_up(Tk, bk)
//   (empty_denom).

constexpr int kTcRows = 64;        // rows (query position x head) per CTA: the wgmma M
constexpr int kTcKeys = 64;        // keys per tile: the wgmma N of S and K of P . V
constexpr int kTcThreads = 128;    // one warpgroup
constexpr int kTcStages = 2;       // K/V ring
constexpr uint32_t kHalfBytes = kTcKeys * 128;  // one 64-column (128-byte) half of a K or V tile
constexpr int kPTerms = 2;         // bf16 terms of P in P . V (see the design note)

struct TcParams {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  long long sqb, sqt, sqh;
  long long sob, sot, soh;
  int Tq, Tk, n_rep;
  float scale_log2;   // scale * log2(e)
  int causal, q_offset, kv_valid;
  float empty_denom;  // round_up(Tk, bk): the divisor of rows with no valid key
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart.  The stride between 8-row
// groups is the SBO field; the LBO field is not read by these layouts (K-
// major operands never cross a 128-byte row in one k16 step; the MN-major
// V tile is one 64-column atom wide) and is set to the same 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) += a (64 x 16, bf16, registers) . b (16 x 64, bf16,
// shared memory; TRANS_B = 0: stored K-major, 1: stored N-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TRANS_B), "r"(accumulate));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat162 h) { return *reinterpret_cast<uint32_t*>(&h); }

// (x, y) as N bf16 terms, each the bf16 rounding of what the terms before
// it leave (hi, mid, lo for N = 3), packed as the A fragment wants them (x
// in the low half); every subtraction is exact.
template <int N>
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t (&terms)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    terms[n] = pack_bf16x2(h);
    x = __fsub_rn(x, __low2float(h));
    y = __fsub_rn(y, __high2float(h));
  }
}

// Thread 0: load key tile `tile` of K and V into its stage of the ring
// (stage tile % kTcStages) and arm the stage's mbarrier with the bytes to
// come.
template <int HD>
__device__ __forceinline__ void issue_tile(const CUtensorMap* mk, const CUtensorMap* mv, uint32_t bar0,
                                           uint32_t base, int tile, int kvh, int b) {
  constexpr int kHalves = HD / 64;
  constexpr uint32_t kTileBytes = kHalves * kHalfBytes;
  const int s = tile % kTcStages;
  const uint32_t bar = bar0 + 8 * s, dst = base + s * 2 * kTileBytes;
  mbar_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh) {
    tma_load_4d(dst + hh * kHalfBytes, mk, bar, 64 * hh, kvh, tile * kTcKeys, b);
    tma_load_4d(dst + kTileBytes + hh * kHalfBytes, mv, bar, 64 * hh, kvh, tile * kTcKeys, b);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads) flash_attention_bf16_tc(const __grid_constant__ CUtensorMap tmk,
                                                                      const __grid_constant__ CUtensorMap tmv,
                                                                      const TcParams p) {
  constexpr int kHalves = HD / 64;
  constexpr int kSteps = HD / 16;  // k16 steps of S = Q K^T
  constexpr uint32_t kTileBytes = kHalves * kHalfBytes;
  constexpr uint32_t kStageBytes = 2 * kTileBytes;  // K tile, then V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ alignas(8) uint64_t full[kTcStages];

  const int t = threadIdx.x;
  const int w = t >> 5, ln = t & 31;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rows = p.Tq * p.n_rep;
  const int rho0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // under a causal mask the longest rows go first
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t bar0 = smem_u32(&full[0]);

  // Key tiles to walk (see "Skipped blocks").
  const int kv_lim = min(p.kv_valid, p.Tk);
  int limit = p.Tk;
  if (p.kv_valid > 0) {
    limit = kv_lim;
    if (p.causal) limit = min(limit, p.q_offset + (min(rho0 + kTcRows, rows) - 1) / p.n_rep + 1);
  }
  const int n_tiles = max(1, (limit + kTcKeys - 1) / kTcKeys);

  if (t == 0) {
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) issue_tile<HD>(&tmk, &tmv, bar0, base, 0, kvh, b);

  // This thread's two rows of the tile (the wgmma accumulator layout):
  // e = 0: row 16 w + ln / 4, e = 1: that row + 8.
  int q_pos[2];
  long long q_off[2], o_off[2];
  bool row_live[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int rho = rho0 + 16 * w + (ln >> 2) + 8 * e;
    const int i = rho / p.n_rep;
    const int h = kvh * p.n_rep + rho % p.n_rep;
    row_live[e] = rho < rows;
    q_pos[e] = p.q_offset + i;
    q_off[e] = b * p.sqb + i * p.sqt + h * p.sqh;
    o_off[e] = b * p.sob + i * p.sot + h * p.soh;
  }
  // Q in the A-fragment layout of m64n64k16: k step kt holds columns
  // 16 kt + 2 (ln % 4) + {0, 1} and + 8, of both rows.
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kt = 0; kt < kSteps; ++kt) {
    const int c = 16 * kt + 2 * (ln & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = j & 1;
      qa[kt][j] = row_live[e] ? *reinterpret_cast<const uint32_t*>(p.q + q_off[e] + c + 8 * (j >> 1)) : 0u;
    }
  }

  float o[kHalves][32];
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile % kTcStages;
    if (t == 0 && tile + 1 < n_tiles) issue_tile<HD>(&tmk, &tmv, bar0, base, tile + 1, kvh, b);  // its stage
    // was released at the end of tile - 1
    mbar_wait(bar0 + 8 * s, (tile / kTcStages) & 1);  // the stage's use count, mod 2
    __syncwarp();
    const uint32_t ks = base + s * kStageBytes, vs = ks + kTileBytes;

    // S = Q K^T for 64 rows x 64 keys; element i of sc is row e = (i >> 1) & 1,
    // key 8 (i / 4) + 2 (ln % 4) + (i % 2) of the tile.
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < kSteps; ++kt)
      wgmma_m64n64k16<0>(sc, qa[kt], sw128_desc(ks + (kt >> 2) * kHalfBytes + (kt & 3) * 32), kt > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int key0 = tile * kTcKeys;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      const int key = key0 + 8 * (i >> 2) + 2 * (ln & 3) + (i & 1);
      bool valid = key < kv_lim;
      if (p.causal) valid = valid && key <= q_pos[e];
      sc[i] = valid ? __fmul_rn(sc[i], p.scale_log2) : kNeg;
      mx[e] = fmaxf(mx[e], sc[i]);
    }
    float corr[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float m_new = fmaxf(m[e], mx[e]);
      corr[e] = exp2f(__fsub_rn(m[e], m_new));
      m[e] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      sc[i] = exp2f(__fsub_rn(sc[i], m[e]));
      ps[e] = __fadd_rn(ps[e], sc[i]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = __fadd_rn(__fmul_rn(l[e], corr[e]), ps[e]);  // this thread's keys
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] = __fmul_rn(o[hh][i], corr[(i >> 1) & 1]);

    // P as kPTerms bf16 terms in the A-fragment layout: key step kt (keys
    // 16 kt .. + 15) takes score elements 8 kt .. 8 kt + 7.
    uint32_t pa[4][4][kPTerms];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int j = 0; j < 4; ++j) split_bf16(sc[8 * kt + 2 * j], sc[8 * kt + 2 * j + 1], pa[kt][j]);

#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) fence_regs(o[hh]);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int n = 0; n < kPTerms; ++n) {
        const uint32_t a[4] = {pa[kt][0][n], pa[kt][1][n], pa[kt][2][n], pa[kt][3][n]};
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh)
          wgmma_m64n64k16<1>(o[hh], a, sw128_desc(vs + hh * kHalfBytes + kt * 2048), 1);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) fence_regs(o[hh]);
    __syncthreads();  // every warp is done with stage s before the TMA refills it
  }

  float den[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] = __fadd_rn(l[e], __shfl_xor_sync(0xffffffffu, l[e], 1));
    l[e] = __fadd_rn(l[e], __shfl_xor_sync(0xffffffffu, l[e], 2));
    den[e] = p.kv_valid > 0 ? fmaxf(l[e], 1e-30f) : p.empty_denom;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!row_live[e]) continue;
    __nv_bfloat16* og = p.o + o_off[e];
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int c = 64 * hh + 8 * jb + 2 * (ln & 3);
        const float x = __fdiv_rn(o[hh][4 * jb + 2 * e], den[e]);
        const float y = __fdiv_rn(o[hh][4 * jb + 2 * e + 1], den[e]);
        *reinterpret_cast<__nv_bfloat162*>(og + c) = __floats2bfloat162_rn(x, y);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, from the copy the process has loaded
// (nothing more to link at build time).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A (B, T, KV, hd) bf16 view as a 4-d tensor map (hd innermost) with boxes
// of 64 columns x 1 head x 64 keys x 1 batch, 128-byte swizzle, zero fill
// past the edges.  A dimension of extent 1 takes a stride that fits the
// TMA's rules: its coordinate is always 0.
int encode_kv(CUtensorMap* map, const void* ptr, int hd, int KV, int T, int B, long long sh, long long st,
              long long sb) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -8;
  const cuuint64_t row = (cuuint64_t)hd * 2;
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  if (KV == 1) strides[0] = row;
  if (T == 1) strides[1] = strides[0] * KV;
  if (B == 1) strides[2] = strides[1] * T;
  if ((reinterpret_cast<uintptr_t>(ptr) & 15) || (strides[0] & 15) || (strides[1] & 15) || (strides[2] & 15))
    return -7;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KV, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kTcKeys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(1000 + (int)r);
}

template <int HD>
int launch_tc(const CUtensorMap& mk, const CUtensorMap& mv, const TcParams& p, int B, int KV,
              cudaStream_t stream) {
  static bool configured = false;
  const size_t bytes = (size_t)kTcStages * 2 * (HD / 64) * kHalfBytes + 1024;  // + alignment slack
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16_tc<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((p.Tq * p.n_rep + kTcRows - 1) / kTcRows, KV, B);
  flash_attention_bf16_tc<HD><<<grid, kTcThreads, bytes, stream>>>(mk, mv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (CUDA-core kernel), 1 bfloat16 (tensor-core kernel);
// q, k, v and the output share it.  Returns 0, a negative code for
// arguments the kernels do not take (-7: a bf16 view the kernel cannot
// address: odd strides, or k / v not 16-byte aligned with 16-byte strides;
// -8: libcuda's tensor-map encoder not found; -1000 - r: the encoder's error r), or
// the CUDA error of the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int hd,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh,
    int B, int H, int KV, int Tq, int Tk,
    float scale, int causal, int q_offset, int kv_valid, int bk, void* stream) {
  if (hd != 64 && hd != 128) return -1;
  if (dtype != 0 && dtype != 1) return -2;
  if (bk < 1 || bk > kMaxBk) return -3;
  if (KV < 1 || H % KV != 0) return -4;
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535) return -5;
  if (q_offset < 0) return -6;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sqb = sqb; p.sqt = sqt; p.sqh = sqh;
  p.skb = skb; p.skt = skt; p.skh = skh;
  p.svb = svb; p.svt = svt; p.svh = svh;
  p.sob = sob; p.sot = sot; p.soh = soh;
  p.Tq = Tq;
  p.Tk = Tk;
  p.n_rep = H / KV;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_valid = kv_valid;
  p.bk = bk;
  p.n_k = (Tk + bk - 1) / bk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return hd == 64 ? launch<float, 64>(p, B, H, s) : launch<float, 128>(p, B, H, s);
  if ((sqb | sqt | sqh | sob | sot | soh) & 1) return -7;  // the bf16 kernel moves bf16 pairs
  CUtensorMap mk, mv;
  int rc = encode_kv(&mk, k, hd, KV, Tk, B, skh, skt, skb);
  if (rc == 0) rc = encode_kv(&mv, v, hd, KV, Tk, B, svh, svt, svb);
  if (rc != 0) return rc;
  TcParams tp;
  tp.q = static_cast<const __nv_bfloat16*>(q);
  tp.o = static_cast<__nv_bfloat16*>(o);
  tp.sqb = sqb; tp.sqt = sqt; tp.sqh = sqh;
  tp.sob = sob; tp.sot = sot; tp.soh = soh;
  tp.Tq = Tq;
  tp.Tk = Tk;
  tp.n_rep = H / KV;
  tp.scale_log2 = (float)((double)scale * 1.4426950408889634);
  tp.causal = causal;
  tp.q_offset = q_offset;
  tp.kv_valid = kv_valid;
  tp.empty_denom = (float)(p.n_k * bk);
  return hd == 64 ? launch_tc<64>(mk, mv, tp, B, KV, s) : launch_tc<128>(mk, mv, tp, B, KV, s);
}
