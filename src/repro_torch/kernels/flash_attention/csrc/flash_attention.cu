// Flash-attention forward (causal or not, GQA) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel of the reference package:
//   src/repro/kernels/flash_attention/kernel.py:91 flash_attention_pallas
//     (body _kernel :26)
//
// What it computes, for query head h (reading KV head h / n_rep), query row
// i at position q_pos = q_offset + i and key j at kv_pos = j:
//   s = (f32(q) * scale) . f32(k)            f32 scores
//   valid = kv_pos < kv_valid  [&& kv_pos <= q_pos when causal]
//   s = valid ? s : -1e30                    never -inf
// then, over the keys in logical blocks of bk (the reference's KV grid
// axis, here a loop inside the CTA), the online softmax from
// m = -1e30, l = 0, acc = 0:
//   m' = max(m, max_j s);  p = exp(s - m');  corr = exp(m - m')
//   l  = l * corr + sum_j p;  acc = acc * corr + p . f32(v);  m = m'
// and out = acc / max(l, 1e-30), cast to the input type.  Keys at or past
// Tk inside the last block are the reference's zero padding: zero K and V,
// masked (kv_valid <= Tk).  The block partition is the reference's, so the
// kernel holds to its plain twin (kernel.py) to float rounding: only the
// order of the sums inside a block differs.
//
// Skipped blocks.  A CTA stops after the last block that holds a valid key
// for one of its rows.  That is exact: when kv_valid > 0 and q_offset >= 0,
// key 0 is valid for every row, so every row has met a valid key in its
// first block and m is a real score from then on; a later block whose keys
// are all masked for a row gives p = exp(-1e30 - m) = 0 exactly and
// corr = exp(0) = 1 exactly, so l and acc do not change by a bit.  With
// kv_valid <= 0 no key is ever valid, the reference's p = exp(0) = 1 runs
// through every block, and the CTA then walks all n_k blocks as it does.
//
// Bound on this card: at the served shapes (hd = 64, T <= a few thousand)
// the work is 4 * hd flops per live score entry against q, k, v and the
// output read and written once; both are microseconds, so the call is bound
// by latency and by this kernel's CUDA-core arithmetic.  This first
// version: one CTA of 128 threads per (q tile of 32 rows, head, batch);
// Q^T, the K^T and V tiles of one logical block and P^T staged in shared
// memory as f32 (bf16 is upcast once at the load, as the reference upcasts
// its tiles); each thread holds a 4 x 8 score tile and a 4 x (hd / 16)
// output tile in registers, with m and l per row kept in registers and
// reduced across the 16 threads of a half-warp with shuffles.  Tensor cores
// (mma.sync / wgmma bf16 with f32 accumulate) and a TMA ring for K and V
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

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

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and the output share it).
// Returns 0, a negative code for arguments the kernel does not take, or the
// CUDA error of the launch.
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
  return hd == 64 ? launch<__nv_bfloat16, 64>(p, B, H, s) : launch<__nv_bfloat16, 128>(p, B, H, s);
}
