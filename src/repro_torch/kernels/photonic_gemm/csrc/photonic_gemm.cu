// Photonic (bit-sliced, psum-chunked, analog-channel) GEMM for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of the reference package:
//   src/repro/kernels/photonic_gemm/kernel.py:412 photonic_gemm_fused_pallas
//     (body _fused_kernel :218, datapath _accumulate :69)  -> fused = 1
//   src/repro/kernels/photonic_gemm/kernel.py:319 photonic_gemm_pallas
//     (body _kernel :164, same _accumulate)                -> fused = 0
// Both are one template, photonic_gemm_kernel<FUSED>, so the integer core
// and the fused hot path can never drift apart.
//
// What it computes, per output element (row, col), over K in N-sized chunks:
//   [prologue, fused with f32 x]  q = clip(rint(x / x_scale), -qmax, qmax)
//   for each slice pair (si, ti) of the signed-magnitude B-bit slices:
//     ideal channel (no analog stage, no ADC): one exact int dot over K
//       (the shift-added slice passes equal the exact product bitwise);
//     otherwise, per chunk g of n_chunk contraction elements:
//       a = psum; a += eps_im * dot(nbr(x_c), w_c); a += eps_cw * dot(x_c, nbr(w_c));
//       a *= (1 - alpha); a += sigma * gaussian(fold_seed(tile_seed, pass, g), ctr)
//       psum = clip(rint(a), +-(2^(adc-1)-1));  acc += psum << (B * (si + ti))
//   [epilogue, fused]  y = acc * x_scale * w_scale[col] (+ bias[col]) (gelu_tanh | silu)
// Every float stage is one IEEE op spelled with __fmul_rn / __fadd_rn /
// __fdiv_rn (no FMA contraction), rounding is rintf (half to even), and the
// transcendental calls are the accurate logf / cosf / sqrtf (built without
// --use_fast_math), so the kernel agrees with its plain PyTorch twin bitwise
// except for the last ulp of the Box-Muller noise draws.
//
// Noise stream ids come from the reference's *logical* Pallas tiling, not
// from this kernel's CTA shape: tile_seed = fold_seed(seed, i, j, kk) for the
// logical (tile_r, tile_c) output tile (i, j) and K-tile kk, per-chunk seed
// fold_seed(tile_seed, si*S+ti, g) with g the chunk index inside the K-tile,
// and element counter row_in_tile * tile_c + col_in_tile; chunks at or past
// valid_chunks (pure K padding) draw no noise.
//
// Bound on this card: at the server's decode shapes (R <= 64 rows) the call
// is bound by bytes (the int8 weight, read once, dominates: K*C bytes against
// 2*R*K*C int8 ops per pass).  This first version is a simple CUDA-core
// kernel: one CTA per 8 rows x 128 columns (one warp per row, four columns a
// thread, int32 accumulators in registers), the weight chunk staged through
// shared memory with 16-byte loads and read once per CTA, the K loop inside
// the block.  Its analog passes are integer multiply-adds on CUDA cores; the
// tensor-core (wgmma int8), TMA and multi-stage pipelining work comes later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileC = 128;   // logical tile_c this kernel supports
constexpr int kRows = 8;      // rows per CTA: one warp per row
constexpr int kThreads = 256; // 8 warps
constexpr int kMaxN = 256;    // longest chunk staged in shared memory

struct Params {
  const void* x;
  int x_f32;
  const int8_t* w;
  const float* x_scale;
  const float* w_scale;
  const float* bias;
  const uint32_t* seed;
  void* out;
  int R, K, C;
  int tile_r, tile_c, tile_k, n_chunk;
  int slice_bits, num_slices, qmax;
  int adc_lim;  // < 0: no ADC saturation
  int analog;
  float sigma;
  int use_filter;
  float filter_scale;  // f32(1 - alpha)
  float eps_im, eps_cw;
  int valid_chunks;  // < 0: no noise mask
  int activation;    // 0 none, 1 gelu (tanh form), 2 silu
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// One step of repro.noise.stages.fold_seed: s ^ ((v + 1) * GOLDEN) ^ i, mixed.
__device__ __forceinline__ uint32_t fold1(uint32_t s, uint32_t v, uint32_t i) {
  return mix32(s ^ ((v + 1u) * 0x9E3779B9u) ^ i);
}

// repro.noise.stages.gaussian_from_counter for one element counter.
__device__ __forceinline__ float gaussian(uint32_t base, uint32_t ctr) {
  const uint32_t u1 = mix32(base ^ (ctr * 0x27D4EB2Fu));
  const uint32_t u2 = mix32(base ^ (ctr * 0x165667B1u) ^ 0x5BF03635u);
  const float inv24 = 5.9604644775390625e-08f;  // 2^-24
  const float f1 = __fadd_rn(__fmul_rn(__uint2float_rn(u1 >> 8), inv24),
                             2.98023223876953125e-08f);  // + 2^-25
  const float f2 = __fmul_rn(__uint2float_rn(u2 >> 8), inv24);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(f1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.28318548202514648f, f2)));  // f32(2*pi)
}

__device__ __forceinline__ int slice_of(int v, int shift, int mask) {
  const int s = ((v < 0 ? -v : v) >> shift) & mask;
  return v < 0 ? -s : s;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

template <bool FUSED>
__global__ void __launch_bounds__(kThreads) photonic_gemm_kernel(Params p) {
  // Quantized activations and weight slices of one chunk, with a zero guard
  // entry on both sides so the neighbour sums need no edge branches (the
  // guards are the reference's zero padding at chunk boundaries).
  __shared__ int xs[kRows][kMaxN + 2];
  __shared__ __align__(16) int8_t ws[kMaxN + 2][kTileC];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = p.n_chunk;
  const int row = blockIdx.y * kRows + warp;
  const int col0 = blockIdx.x * kTileC + lane * 4;
  const uint32_t i_tile = row / p.tile_r;
  const uint32_t r_in = row % p.tile_r;
  const uint32_t j_tile = blockIdx.x;  // tile_c == kTileC
  const uint32_t c_in0 = lane * 4;

  for (int e = threadIdx.x; e < kRows * 2; e += kThreads) {
    xs[e >> 1][(e & 1) ? n + 1 : 0] = 0;
  }
  for (int e = threadIdx.x; e < 2 * kTileC; e += kThreads) {
    ws[(e < kTileC) ? 0 : n + 1][e % kTileC] = 0;
  }

  const float x_scale = FUSED ? *p.x_scale : 0.0f;
  const float qmax = (float)p.qmax;
  const bool ideal = !p.analog && p.adc_lim < 0;
  const int chunks = p.tile_k / n;
  const int num_kk = p.K / p.tile_k;
  const int mask = (1 << p.slice_bits) - 1;
  const uint32_t seed = p.seed != nullptr ? *p.seed : 0u;
  const int8_t* xi8 = static_cast<const int8_t*>(p.x);
  const float* xf32 = static_cast<const float*>(p.x);

  int acc[4] = {0, 0, 0, 0};
  for (int kk = 0; kk < num_kk; ++kk) {
    const uint32_t tile_seed = fold1(fold1(fold1(seed, i_tile, 0u), j_tile, 1u), (uint32_t)kk, 2u);
    for (int g = 0; g < chunks; ++g) {
      const int k0 = kk * p.tile_k + g * n;
      __syncthreads();  // the previous chunk is fully consumed
      for (int e = threadIdx.x; e < kRows * n; e += kThreads) {
        const int rr = e / n;
        const int nn = e - rr * n;
        const size_t off = (size_t)(blockIdx.y * kRows + rr) * p.K + k0 + nn;
        int v;
        if (FUSED && p.x_f32) {
          const float q = rintf(__fdiv_rn(xf32[off], x_scale));
          v = (int)fminf(fmaxf(q, -qmax), qmax);
        } else {
          v = xi8[off];
        }
        xs[rr][nn + 1] = v;
      }
      constexpr int kVec = kTileC / 16;
      for (int e = threadIdx.x; e < n * kVec; e += kThreads) {
        const int nn = e / kVec;
        const int v16 = e - nn * kVec;
        const int4* src = reinterpret_cast<const int4*>(
            p.w + (size_t)(k0 + nn) * p.C + (size_t)blockIdx.x * kTileC);
        reinterpret_cast<int4*>(&ws[nn + 1][0])[v16] = src[v16];
      }
      __syncthreads();

      if (ideal) {
        for (int nn = 1; nn <= n; ++nn) {
          const int xv = xs[warp][nn];
          const char4 w4 = *reinterpret_cast<const char4*>(&ws[nn][lane * 4]);
          acc[0] += xv * w4.x;
          acc[1] += xv * w4.y;
          acc[2] += xv * w4.z;
          acc[3] += xv * w4.w;
        }
        continue;
      }

      for (int si = 0; si < p.num_slices; ++si) {
        const int xsh = p.slice_bits * si;
        for (int ti = 0; ti < p.num_slices; ++ti) {
          const int wsh = p.slice_bits * ti;
          int ps[4] = {0, 0, 0, 0}, im[4] = {0, 0, 0, 0}, cw[4] = {0, 0, 0, 0};
          for (int nn = 1; nn <= n; ++nn) {
            const int xv = slice_of(xs[warp][nn], xsh, mask);
            const char4 w4 = *reinterpret_cast<const char4*>(&ws[nn][lane * 4]);
            const int wv[4] = {slice_of(w4.x, wsh, mask), slice_of(w4.y, wsh, mask),
                               slice_of(w4.z, wsh, mask), slice_of(w4.w, wsh, mask)};
#pragma unroll
            for (int q = 0; q < 4; ++q) ps[q] += xv * wv[q];
            if (p.eps_im > 0.0f) {
              const int xn = slice_of(xs[warp][nn - 1], xsh, mask) + slice_of(xs[warp][nn + 1], xsh, mask);
#pragma unroll
              for (int q = 0; q < 4; ++q) im[q] += xn * wv[q];
            }
            if (p.eps_cw > 0.0f) {
              const char4 wl = *reinterpret_cast<const char4*>(&ws[nn - 1][lane * 4]);
              const char4 wr = *reinterpret_cast<const char4*>(&ws[nn + 1][lane * 4]);
              cw[0] += xv * (slice_of(wl.x, wsh, mask) + slice_of(wr.x, wsh, mask));
              cw[1] += xv * (slice_of(wl.y, wsh, mask) + slice_of(wr.y, wsh, mask));
              cw[2] += xv * (slice_of(wl.z, wsh, mask) + slice_of(wr.z, wsh, mask));
              cw[3] += xv * (slice_of(wl.w, wsh, mask) + slice_of(wr.w, wsh, mask));
            }
          }
          const bool noisy = p.sigma > 0.0f && (p.valid_chunks < 0 || kk * chunks + g < p.valid_chunks);
          const uint32_t base = noisy ? fold1(fold1(tile_seed, (uint32_t)(si * p.num_slices + ti), 0u), (uint32_t)g, 1u) : 0u;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            int psum = ps[q];
            if (p.analog) {
              float a = __int2float_rn(psum);
              if (p.eps_im > 0.0f) a = __fadd_rn(a, __fmul_rn(p.eps_im, __int2float_rn(im[q])));
              if (p.eps_cw > 0.0f) a = __fadd_rn(a, __fmul_rn(p.eps_cw, __int2float_rn(cw[q])));
              if (p.use_filter) a = __fmul_rn(a, p.filter_scale);
              if (noisy) {
                const uint32_t ctr = r_in * (uint32_t)p.tile_c + c_in0 + q;
                a = __fadd_rn(a, __fmul_rn(p.sigma, gaussian(base, ctr)));
              }
              psum = (int)rintf(a);
            }
            if (p.adc_lim >= 0) psum = min(max(psum, -p.adc_lim), p.adc_lim);
            acc[q] += psum * (1 << (xsh + wsh));
          }
        }
      }
    }
  }

  const size_t out_off = (size_t)row * p.C + col0;
  if (FUSED) {
    float y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[q]), x_scale), p.w_scale[col0 + q]);
      if (p.bias != nullptr) v = __fadd_rn(v, p.bias[col0 + q]);
      if (p.activation == 1) v = gelu_tanh(v);
      else if (p.activation == 2) v = silu(v);
      y[q] = v;
    }
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + out_off) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    *reinterpret_cast<int4*>(static_cast<int32_t*>(p.out) + out_off) = make_int4(acc[0], acc[1], acc[2], acc[3]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns 0 on a clean launch,
// a negative code for arguments the kernel does not take, or the value of
// cudaGetLastError() after the launch.
extern "C" int photonic_gemm_launch(
    const void* x, int x_f32, const void* w, const void* x_scale, const void* w_scale,
    const void* bias, const void* seed, void* out, int fused,
    int R, int K, int C, int tile_r, int tile_c, int tile_k, int n_chunk,
    int slice_bits, int num_slices, int operand_bits, int adc_bits,
    float sigma, int use_filter, float filter_scale, float eps_im, float eps_cw,
    int valid_chunks, int activation, void* stream) {
  if (tile_c != kTileC || C % kTileC != 0) return -1;
  if (tile_r % kRows != 0 || R % tile_r != 0) return -2;
  if (n_chunk < 1 || n_chunk > kMaxN || tile_k % n_chunk != 0 || K % tile_k != 0) return -3;
  if (x_f32 && !fused) return -4;
  if (slice_bits < 1 || num_slices < 1 || slice_bits * num_slices > 16) return -5;
  Params p;
  p.x = x;
  p.x_f32 = x_f32;
  p.w = static_cast<const int8_t*>(w);
  p.x_scale = static_cast<const float*>(x_scale);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.seed = static_cast<const uint32_t*>(seed);
  p.out = out;
  p.R = R;
  p.K = K;
  p.C = C;
  p.tile_r = tile_r;
  p.tile_c = tile_c;
  p.tile_k = tile_k;
  p.n_chunk = n_chunk;
  p.slice_bits = slice_bits;
  p.num_slices = num_slices;
  p.qmax = (1 << (operand_bits - 1)) - 1;
  p.adc_lim = adc_bits > 0 ? (1 << (adc_bits - 1)) - 1 : -1;
  p.sigma = sigma;
  p.use_filter = use_filter;
  p.filter_scale = filter_scale;
  p.eps_im = eps_im;
  p.eps_cw = eps_cw;
  p.analog = (sigma > 0.0f || use_filter || eps_im > 0.0f || eps_cw > 0.0f) ? 1 : 0;
  p.valid_chunks = valid_chunks;
  p.activation = activation;
  const dim3 grid(C / kTileC, R / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused) {
    photonic_gemm_kernel<true><<<grid, kThreads, 0, s>>>(p);
  } else {
    photonic_gemm_kernel<false><<<grid, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
