// Photonic (bit-sliced, psum-chunked, analog-channel) GEMM for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of the reference package:
//   src/repro/kernels/photonic_gemm/kernel.py:412 photonic_gemm_fused_pallas
//     (body _fused_kernel :218, datapath _accumulate :69)  -> fused = 1
//   src/repro/kernels/photonic_gemm/kernel.py:319 photonic_gemm_pallas
//     (body _kernel :164, same _accumulate)                -> fused = 0
// Both are one template, photonic_gemm_kernel<BN, WN, IDEAL>, so the integer core
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
// valid_chunks (pure K padding) draw no noise.  A launch may be a rank's
// column block of a wider weight: column c is then column c_origin + c of
// the whole (any c_origin), in logical tile (c_origin + c) / tile_c, so a
// CTA's 128 columns may straddle two logical tiles and it derives both
// tiles' seeds; w_scale and bias stay indexed by the launch's own columns.
// Likewise a launch may be a block of a taller operand's rows: row r is
// then row r_origin + r of the whole (any r_origin), in logical row tile
// (r_origin + r) / tile_r at (r_origin + r) % tile_r, where tile_r is the
// whole operand's; a CTA's rows may then straddle two logical row tiles,
// and it derives the seeds of every (row tile, column tile) pair it meets.
// At r_origin = 0 a CTA's rows lie in one row tile (BN divides tile_r).
//
// Bound on this card: at decode (R = 4 live rows) the call is bound by bytes
// (the int8 weight, read once); under a noisy channel by the Box-Muller
// draws, R * C * chunks * passes of them, on the CUDA cores; at R = 2000 by
// the int8 products.  What held the first version back, and what this one
// does instead:
//   * The grid was C/128 x Rp/8 CTAs, each walking the whole K: 7 CTAs for
//     attn.wq at decode on 132 SMs.  Here the contraction is split across
//     CTAs.  Each chunk's psum is clipped and shifted on its own and its
//     noise id is fixed by the logical tiling, so any partition of the
//     chunks over CTAs gives the same int32 sum, bitwise.  The partial sums
//     meet in an int32 workspace by atomics, and the last CTA of each output
//     tile (an atomic ticket) runs the epilogue and zeroes its workspace
//     rows and ticket, so a GEMM stays one launch and a CUDA graph can
//     replay it.  The wrapper picks the split (plan_launch) so that the
//     grid covers the SMs when there are that many chunk-tiles.
//   * Half the warps computed padding rows at R = 4.  Here rows past the
//     live count are neither drawn for nor written; the wrapper passes it.
//   * Every chunk was staged synchronously between two __syncthreads.  Here
//     the weight chunks come in through a cp.async ring, read once per CTA.
//   * The MACs were scalar int32 on CUDA cores.  Here they run on the
//     integer tensor cores, mma.sync m16n8k32 s8 x s8 -> s32, exact.
//   * slice_of ran for x, w and both neighbours inside the innermost loop.
//     Here each chunk's slice tiles are built once in shared memory, four
//     bytes at a time.
//
// Layout.  The product is taken as out^T = w^T . x^T: the 128 weight columns
// of a CTA fill the 16-row side of the mma, its rows (8 at decode, 64
// otherwise) the 8-wide side.  Integer mma.sync takes only .row.col, so both
// operands must be contiguous in K, and the (K, C) int8 weight is not.  The
// ideal path transposes it in registers: a lane reads four K rows of four
// adjacent columns from the swizzled stage and four byte permutes give it
// the four columns' K quads, which are its A fragments when the mma's rows
// are mapped to columns 4g, 4g + 1 (tile 0) and 4g + 2, 4g + 3 (tile 1).
// The slice path writes its slice tiles transposed, [col][k].
//
// The ideal channel is one exact pass over the full int8 operands in
// 64-wide K steps.  Every other channel takes the slice path: per chunk,
// the x slices and, per weight slice, w_s and nbr(w_s) are built in shared
// memory, zero-padded to the mma depth; the padding is exact and supplies
// the reference's zero neighbour at the chunk edges.  dot(nbr(x_c), w_c)
// and dot(x_c, nbr(w_c)) are the same integer (both are x^T (S + S^T) w for
// the shift S within the chunk), so one mma gives both crosstalk terms.
// Slices lie in +-(2^B - 1) and neighbour sums in +-2(2^B - 1), which fits
// int8 for B <= 6.  Wider slices (the 8-bit planes of the bit-sliced mode,
// one slice of the whole operand) keep the two neighbours apart: w_s[k - 1]
// and w_s[k + 1] are two int8 tiles and the crosstalk dot is two mmas into
// one int32 sum, the same integer, so the result stays bitwise.  The psum tiles then go through shared memory to a
// layout where every lane holds a live element, and the float chain and
// the Box-Muller draw run there, the counter from the element's (row, col).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileC = 128;   // a CTA's columns; the logical tile_c is a multiple, so a CTA meets at most two logical tiles
constexpr int kMaxN = 256;    // longest chunk
constexpr int kKStep = 64;    // K step of the ideal path (its split unit)
constexpr int kStages = 4;    // cp.async ring depth, ideal path
constexpr int kAccStride = kTileC + 4;  // int32 row stride of the psum / acc tiles

struct Params {
  const void* x;
  int x_f32;
  const int8_t* w;
  const float* x_scale;
  const float* w_scale;
  const float* bias;
  const uint32_t* seed;
  void* out;
  int fused;
  int* ws_acc;   // split workspace, int32 [tiles][BN][128]; zero on entry and exit
  int* tickets;  // one per output tile; zero on entry and exit
  int K, C;      // padded contraction and column counts
  int live_rows; // rows computed and written: [0, live_rows)
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
  int ideal;         // one exact pass in kKStep steps
  int n_units;       // K steps (ideal) or chunks (slice path)
  int n_split;       // CTAs per output tile along K
  int npad;          // slice path: chunk padded to the mma depth
  int c_origin;      // the launch's column 0 is column c_origin of the whole weight (noise ids)
  int r_origin;      // the launch's row 0 is row r_origin of the whole operand (noise ids)
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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ int quantize(float x, float x_scale, float qmax) {
  const float q = rintf(__fdiv_rn(x, x_scale));
  return (int)fminf(fmaxf(q, -qmax), qmax);
}

// Four signed bytes' slices sign(v) * ((|v| >> shift) & mask), bytewise.
// `mask` is replicated into each byte and already cut to 8 - shift bits.
__device__ __forceinline__ uint32_t slice4(uint32_t v, int shift, uint32_t mask) {
  const uint32_t neg = __vcmplts4(v, 0u);             // 0xff where v < 0
  const uint32_t mag = __vsub4(v ^ neg, neg);         // |v| as unsigned bytes (128 for -128)
  const uint32_t s = (mag >> shift) & mask;
  return __vsub4(s ^ neg, neg);                       // re-signed
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// d += a . b, m16n8k32, s8 x s8 -> s32 (exact).
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 x 4 byte transpose: r[i] holds byte j of row i; o[j] gets byte i of row j.
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t* o) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140), hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140), hi23 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Ideal path stage layout: the weight rows of one K step, 128 bytes each,
// 16-byte chunks XOR-swizzled by K quad so the transposing reads are free of
// bank conflicts; then x, int8 rows of kXStrideI8 bytes or f32 rows of
// kXStrideF32 bytes (strides chosen for conflict-free fragment reads).
constexpr int kWStage = kKStep * kTileC;
constexpr int kXStrideI8 = kKStep + 16;
constexpr int kXStrideF32 = kKStep * 4 + 64;

__device__ __forceinline__ int wswz(int k, int chunk) {
  return k * kTileC + ((chunk ^ (((k >> 2) & 3) << 1)) << 4);
}

__host__ __device__ constexpr int ideal_stage_bytes(int bn, int x_f32) {
  return kWStage + bn * (x_f32 ? kXStrideF32 : kXStrideI8);
}

// Slice path shared memory: the raw weight ring (2 stages of n x 128
// bytes), w_s and nbr(w_s) (or its two halves, `nb` = 2) as [128][npad + 4]
// bytes each, the x slices as
// [S][BN][npad + 16] bytes (row strides of 1 and 4 words mod 8: fragment
// reads free of bank conflicts).  8-row CTAs add the int32 psum and
// crosstalk tiles, [BN][kAccStride], through which the float chain moves to
// the compact layout (the last one holds the CTA's sums at the end); 64-row
// CTAs run the chain in the fragment layout and put their sums over the
// start of the buffer at the end.
__host__ __device__ constexpr int slice_smem_bytes(int bn, int n, int npad, int S, int nb) {
  return bn == 8 ? 2 * n * kTileC + (1 + nb) * kTileC * (npad + 4) + S * bn * (npad + 16) +
                       (1 + (nb > 0)) * bn * kAccStride * 4
                 : (2 * n * kTileC + (1 + nb) * kTileC * (npad + 4) + S * bn * (npad + 16) >
                            bn * kAccStride * 4
                        ? 2 * n * kTileC + (1 + nb) * kTileC * (npad + 4) + S * bn * (npad + 16)
                        : bn * kAccStride * 4);
}

// Neighbour tiles of the slice path: none without crosstalk, their sum when
// it fits int8 (slice_bits <= 6), else the two neighbours apart.
__host__ __device__ constexpr int neighbour_tiles(int xtalk, int slice_bits) {
  return xtalk ? (slice_bits > 6 ? 2 : 1) : 0;
}

template <int BN, int WN>
struct Shape {
  static constexpr int kWarps = 4 * WN;          // 4 warps along the columns, WN along the rows
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kNT = BN / WN / 8;         // n8 tiles per warp
  static constexpr int kEPT = BN * kTileC / kThreads;  // elements per thread, compact layout
};

// The output element of accumulator register e of m-tile mt, n-tile nt for
// lane (g, t) of warp (wm, wn): the mma's rows are columns, its columns rows.
template <int BN, int WN>
__device__ __forceinline__ void frag_pos(int wm, int wn, int g, int t, int mt, int nt, int e, int& row, int& col) {
  col = wm * 32 + 4 * g + 2 * mt + (e >> 1);
  row = wn * (BN / WN) + nt * 8 + 2 * t + (e & 1);
}

// The CTA's partial sums (acc, [BN][kAccStride] int32 in shared memory) to
// the output: directly when the CTA owns the whole K, else through the
// workspace, the last CTA of the tile (by ticket) finishing it.
template <int BN, int WN>
__device__ void finish(const Params& p, const int* acc, int tile, int row0, int col0, int live) {
  using S = Shape<BN, WN>;
  __shared__ int last;
  const int tid = threadIdx.x;
  const float x_scale = p.fused ? *p.x_scale : 0.0f;
  auto store = [&](int rr, int c, int v) {
    const size_t off = (size_t)(row0 + rr) * p.C + col0 + c;
    if (p.fused) {
      float y = __fmul_rn(__fmul_rn(__int2float_rn(v), x_scale), p.w_scale[col0 + c]);
      if (p.bias != nullptr) y = __fadd_rn(y, p.bias[col0 + c]);
      if (p.activation == 1) y = gelu_tanh(y);
      else if (p.activation == 2) y = silu(y);
      static_cast<float*>(p.out)[off] = y;
    } else {
      static_cast<int32_t*>(p.out)[off] = v;
    }
  };
  if (p.n_split == 1) {
    for (int e = tid; e < live * kTileC; e += S::kThreads) store(e / kTileC, e % kTileC, acc[(e / kTileC) * kAccStride + e % kTileC]);
    return;
  }
  int* ws = p.ws_acc + (size_t)tile * BN * kTileC;
  for (int e = tid; e < live * kTileC; e += S::kThreads) atomicAdd(ws + e, acc[(e / kTileC) * kAccStride + e % kTileC]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.tickets + tile, 1) == p.n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < live * kTileC; e += S::kThreads) {
    const int v = __ldcg(ws + e);
    __stcg(ws + e, 0);
    store(e / kTileC, e % kTileC, v);
  }
  if (tid == 0) p.tickets[tile] = 0;
}

// The ideal channel: one exact int8 pass over this CTA's K steps.
template <int BN, int WN>
__device__ void ideal_path(const Params& p, unsigned char* smem, int row0, int col0, int live, int u0, int u1) {
  using S = Shape<BN, WN>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
  const int stage_bytes = ideal_stage_bytes(BN, p.x_f32);
  const uint32_t s0 = smem_addr(smem);
  const float x_scale = p.x_f32 ? *p.x_scale : 1.0f;
  const float qmax = (float)p.qmax;

  auto load = [&](int u, int stage) {
    const uint32_t sw = s0 + stage * stage_bytes, sx = sw + kWStage;
    const int k0 = u * kKStep;
    for (int e = tid; e < kKStep * 8; e += S::kThreads) {  // 8 chunks of 16 bytes per weight row
      const int k = e >> 3, c = e & 7;
      cp_async16(sw + wswz(k, c), p.w + (size_t)(k0 + k) * p.C + col0 + c * 16, true);
    }
    if (p.x_f32) {
      const float* xg = static_cast<const float*>(p.x);
      for (int e = tid; e < BN * 16; e += S::kThreads) {
        const int r = e >> 4, c = e & 15;
        const bool ok = r < live;
        cp_async16(sx + r * kXStrideF32 + c * 16, xg + (ok ? (size_t)(row0 + r) * p.K + k0 + c * 4 : 0), ok);
      }
    } else {
      const int8_t* xg = static_cast<const int8_t*>(p.x);
      for (int e = tid; e < BN * 4; e += S::kThreads) {
        const int r = e >> 2, c = e & 3;
        const bool ok = r < live;
        cp_async16(sx + r * kXStrideI8 + c * 16, xg + (ok ? (size_t)(row0 + r) * p.K + k0 + c * 16 : 0), ok);
      }
    }
  };

  int acc[2][S::kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (u0 + i < u1) load(u0 + i, i);
    cp_async_commit();
  }
  const int chunk = 2 * wm + (g >> 2);  // the lane's 16-byte weight chunk
  for (int u = u0; u < u1; ++u) {
    const int stage = (u - u0) % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step u has landed; every warp is done with step u - 1
    if (u + kStages - 1 < u1) load(u + kStages - 1, (u - u0 + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* sw = smem + stage * stage_bytes;
    const unsigned char* sx = sw + kWStage;
#pragma unroll
    for (int ks = 0; ks < kKStep / 32; ++ks) {
      uint32_t r[4], lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = *reinterpret_cast<const uint32_t*>(sw + wswz(ks * 32 + 4 * t + i, chunk) + (g & 3) * 4);
      transpose4(r, lo);
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = *reinterpret_cast<const uint32_t*>(sw + wswz(ks * 32 + 16 + 4 * t + i, chunk) + (g & 3) * 4);
      transpose4(r, hi);
      const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};  // columns 4g, 4g + 1
      const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};  // columns 4g + 2, 4g + 3
#pragma unroll
      for (int nt = 0; nt < S::kNT; ++nt) {
        const int rr = wn * (BN / WN) + nt * 8 + g;
        uint32_t b0, b1;
        if (p.x_f32) {
          const float4 v0 = *reinterpret_cast<const float4*>(sx + rr * kXStrideF32 + (ks * 32 + 4 * t) * 4);
          const float4 v1 = *reinterpret_cast<const float4*>(sx + rr * kXStrideF32 + (ks * 32 + 16 + 4 * t) * 4);
          b0 = (quantize(v0.x, x_scale, qmax) & 0xff) | (quantize(v0.y, x_scale, qmax) & 0xff) << 8 |
               (quantize(v0.z, x_scale, qmax) & 0xff) << 16 | (uint32_t)(quantize(v0.w, x_scale, qmax) & 0xff) << 24;
          b1 = (quantize(v1.x, x_scale, qmax) & 0xff) | (quantize(v1.y, x_scale, qmax) & 0xff) << 8 |
               (quantize(v1.z, x_scale, qmax) & 0xff) << 16 | (uint32_t)(quantize(v1.w, x_scale, qmax) & 0xff) << 24;
        } else {
          b0 = *reinterpret_cast<const uint32_t*>(sx + rr * kXStrideI8 + ks * 32 + 4 * t);
          b1 = *reinterpret_cast<const uint32_t*>(sx + rr * kXStrideI8 + ks * 32 + 16 + 4 * t);
        }
        mma_s8(acc[0][nt], a0, b0, b1);
        mma_s8(acc[1][nt], a1, b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the acc tile reuses it
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row, col;
        frag_pos<BN, WN>(wm, wn, g, t, mt, nt, e, row, col);
        tile[row * kAccStride + col] = acc[mt][nt][e];
      }
}

// Every other channel: per chunk and slice pair, the psum and crosstalk dots
// on the tensor cores, then the float chain, noise and ADC per element.
// Returns the [BN][kAccStride] tile of the CTA's sums in shared memory.
template <int BN, int WN>
__device__ int* slice_path(const Params& p, unsigned char* smem, int row0, int col0, int live, int u0, int u1) {
  using S = Shape<BN, WN>;
  constexpr bool kCompact = BN == 8;  // decode: half the fragment rows are dead
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
  const int n = p.n_chunk, npad = p.npad, nq = npad / 4;
  const int ns = p.num_slices;
  const bool xtalk = p.eps_im > 0.0f || p.eps_cw > 0.0f;
  const int nb = neighbour_tiles(xtalk, p.slice_bits);
  const bool split_nb = nb == 2;  // w_s[k - 1] and w_s[k + 1] in two tiles
  const int sws = npad + 4, sxs = npad + 16;  // byte strides of the w and x slice rows
  unsigned char* raw = smem;                                    // [2][n][128]
  unsigned char* wsl = raw + 2 * n * kTileC;                    // [128][sws]
  unsigned char* wnb = wsl + kTileC * sws;                      // [128][sws] if xtalk: the sum, or w_s[k - 1]
  unsigned char* wnb2 = wnb + kTileC * sws;                     // [128][sws] if split_nb: w_s[k + 1]
  unsigned char* xsl = wsl + (1 + nb) * kTileC * sws;           // [S][BN][sxs]
  int* ptile = reinterpret_cast<int*>(xsl + ns * BN * sxs);    // [BN][kAccStride], compact only
  int* xtile = ptile + BN * kAccStride;                         // [BN][kAccStride], compact with xtalk
  const uint32_t raw0 = smem_addr(raw);
  const float x_scale = p.x_f32 ? *p.x_scale : 1.0f;
  const float qmax = (float)p.qmax;
  const int chunks = p.tile_k / n;
  const uint32_t seed = p.seed != nullptr ? *p.seed : 0u;
  const int live_elems = live * kTileC;
  // The CTA's columns in the whole weight: [gc0, gc0 + 128), logical tile
  // j_lo up to local column c_cut, j_lo + 1 from there (c_cut >= 128: one tile).
  const uint32_t gc0 = (uint32_t)(p.c_origin + col0);
  const uint32_t j_lo = gc0 / (uint32_t)p.tile_c;
  const int c_cut = (int)((j_lo + 1u) * (uint32_t)p.tile_c - gc0);
  // The CTA's rows in the whole operand: [gr0, gr0 + BN), logical row tile
  // i_lo up to local row r_cut, i_lo + 1 from there (r_cut >= BN: one tile).
  const uint32_t gr0 = (uint32_t)(p.r_origin + row0);
  const uint32_t i_lo = gr0 / (uint32_t)p.tile_r;
  const int r_cut = (int)((i_lo + 1u) * (uint32_t)p.tile_r - gr0);
  const bool r_two = r_cut < BN, c_two = c_cut < kTileC;

  auto load = [&](int u, int stage) {
    const uint32_t dst = raw0 + stage * n * kTileC;
    for (int e = tid; e < n * 8; e += S::kThreads) {
      const int k = e >> 3, c = e & 7;
      cp_async16(dst + k * kTileC + c * 16, p.w + (size_t)(u * n + k) * p.C + col0 + c * 16, true);
    }
  };

  int acc[S::kEPT];  // compact: element tid + i * threads; else fragment (mt, nt, e)
#pragma unroll
  for (int i = 0; i < S::kEPT; ++i) acc[i] = 0;

  load(u0, 0);
  cp_async_commit();
  for (int u = u0; u < u1; ++u) {
    const int stage = (u - u0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk u has landed; the previous chunk's tiles are consumed
    if (u + 1 < u1) load(u + 1, stage ^ 1);
    cp_async_commit();
    const int k0 = u * n;
    const int kk = u / chunks, gl = u % chunks;
    const unsigned char* rw = raw + stage * n * kTileC;

    // x slices, [si][row][k], four K values per word (zero past n and for dead rows).
    for (int e = tid; e < BN * nq; e += S::kThreads) {
      const int rr = e / nq, q = e % nq;
      uint32_t v = 0;
      if (rr < live) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = 4 * q + b;
          if (k < n) {
            const size_t off = (size_t)(row0 + rr) * p.K + k0 + k;
            const int xv = p.x_f32 ? quantize(static_cast<const float*>(p.x)[off], x_scale, qmax)
                                   : (int)static_cast<const int8_t*>(p.x)[off];
            v |= (uint32_t)(xv & 0xff) << (8 * b);
          }
        }
      }
      for (int si = 0; si < ns; ++si) {
        const int sh = p.slice_bits * si;
        const uint32_t m = ((1u << p.slice_bits) - 1u) & (0xffu >> min(sh, 8));
        *reinterpret_cast<uint32_t*>(xsl + (si * BN + rr) * sxs + 4 * q) = slice4(v, sh, m * 0x01010101u);
      }
    }

    for (int ti = 0; ti < ns; ++ti) {
      const int wsh = p.slice_bits * ti;
      const uint32_t wmask = (((1u << p.slice_bits) - 1u) & (0xffu >> min(wsh, 8))) * 0x01010101u;
      // w_s and nbr(w_s) for slice ti, transposed to [col][k].
      for (int c = tid; c < kTileC; c += S::kThreads) {
        auto word = [&](int q) -> uint32_t {
          if (q < 0 || q >= nq) return 0u;
          uint32_t v = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int k = 4 * q + b;
            if (k < n) v |= (uint32_t)rw[k * kTileC + c] << (8 * b);
          }
          return slice4(v, wsh, wmask);
        };
        uint32_t prev = 0, cur = word(0);
        for (int q = 0; q < nq; ++q) {
          const uint32_t next = word(q + 1);
          *reinterpret_cast<uint32_t*>(wsl + c * sws + 4 * q) = cur;
          if (xtalk) {
            const uint32_t left = __funnelshift_l(prev, cur, 8);   // byte b: s[k - 1]
            const uint32_t right = __funnelshift_r(cur, next, 8);  // byte b: s[k + 1]
            if (split_nb) {
              *reinterpret_cast<uint32_t*>(wnb + c * sws + 4 * q) = left;
              *reinterpret_cast<uint32_t*>(wnb2 + c * sws + 4 * q) = right;
            } else {
              *reinterpret_cast<uint32_t*>(wnb + c * sws + 4 * q) = __vadd4(left, right);
            }
          }
          prev = cur;
          cur = next;
        }
      }
      __syncthreads();

      for (int si = 0; si < ns; ++si) {
        const int pass = si * ns + ti;
        const unsigned char* xs = xsl + si * BN * sxs;
        const bool noisy = p.sigma > 0.0f && (p.valid_chunks < 0 || u < p.valid_chunks);
        auto chunk_seed = [&](uint32_t i_tile, uint32_t j_tile) -> uint32_t {
          return fold1(fold1(fold1(fold1(fold1(seed, i_tile, 0u), j_tile, 1u), (uint32_t)kk, 2u), (uint32_t)pass, 0u),
                       (uint32_t)gl, 1u);
        };
        // The seeds of the (row tile, column tile) pairs the CTA meets.
        const uint32_t b00 = noisy ? chunk_seed(i_lo, j_lo) : 0u;
        const uint32_t b01 = noisy && c_two ? chunk_seed(i_lo, j_lo + 1u) : b00;
        const uint32_t b10 = noisy && r_two ? chunk_seed(i_lo + 1u, j_lo) : b00;
        const uint32_t b11 = noisy && r_two && c_two ? chunk_seed(i_lo + 1u, j_lo + 1u) : (r_two ? b10 : b01);
        const int shift = p.slice_bits * (si + ti);
        // psum -> float chain (crosstalk, filter, noise) -> rint -> ADC -> shifted into acc.
        auto chain = [&](int psum, int xdot, int row, int col) -> int {
          if (p.analog) {
            float a = __int2float_rn(psum);
            if (xtalk) {
              const float xd = __int2float_rn(xdot);
              if (p.eps_im > 0.0f) a = __fadd_rn(a, __fmul_rn(p.eps_im, xd));
              if (p.eps_cw > 0.0f) a = __fadd_rn(a, __fmul_rn(p.eps_cw, xd));
            }
            if (p.use_filter) a = __fmul_rn(a, p.filter_scale);
            if (noisy) {
              const uint32_t ctr = ((gr0 + (uint32_t)row) % (uint32_t)p.tile_r) * (uint32_t)p.tile_c +
                                   (gc0 + (uint32_t)col) % (uint32_t)p.tile_c;
              const uint32_t base = row < r_cut ? (col < c_cut ? b00 : b01) : (col < c_cut ? b10 : b11);
              a = __fadd_rn(a, __fmul_rn(p.sigma, gaussian(base, ctr)));
            }
            psum = (int)rintf(a);
          }
          if (p.adc_lim >= 0) psum = min(max(psum, -p.adc_lim), p.adc_lim);
          return psum * (1 << shift);
        };
        // The A fragments of one K step: w_s (and nbr(w_s), or its two
        // halves) for the lane's columns.
        auto frag = [&](const unsigned char* t, int c0, int w0, uint32_t* f) {
          f[0] = *reinterpret_cast<const uint32_t*>(t + c0 * sws + w0);
          f[1] = *reinterpret_cast<const uint32_t*>(t + (c0 + 1) * sws + w0);
          f[2] = *reinterpret_cast<const uint32_t*>(t + c0 * sws + w0 + 16);
          f[3] = *reinterpret_cast<const uint32_t*>(t + (c0 + 1) * sws + w0 + 16);
        };
        auto load_a = [&](int ks, uint32_t (*a)[4], uint32_t (*an)[4], uint32_t (*an2)[4]) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int c0 = wm * 32 + 4 * g + 2 * mt;
            const int w0 = 4 * (ks * 8 + t);
            frag(wsl, c0, w0, a[mt]);
            if (xtalk) frag(wnb, c0, w0, an[mt]);
            if (split_nb) frag(wnb2, c0, w0, an2[mt]);
          }
        };

        if constexpr (kCompact) {
          // All n tiles' dots, then through shared memory to the compact layout,
          // where every lane holds a live element.
          int ps[2][S::kNT][4], xt[2][S::kNT][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) ps[mt][nt][e] = xt[mt][nt][e] = 0;
          for (int ks = 0; ks < npad / 32; ++ks) {
            uint32_t a[2][4], an[2][4], an2[2][4];
            load_a(ks, a, an, an2);
#pragma unroll
            for (int nt = 0; nt < S::kNT; ++nt) {
              const int rr = wn * (BN / WN) + nt * 8 + g;
              const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xs + rr * sxs + 4 * (ks * 8 + t));
              const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xs + rr * sxs + 4 * (ks * 8 + 4 + t));
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_s8(ps[mt][nt], a[mt], b0, b1);
                if (xtalk) mma_s8(xt[mt][nt], an[mt], b0, b1);
                if (split_nb) mma_s8(xt[mt][nt], an2[mt], b0, b1);
              }
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                int row, col;
                frag_pos<BN, WN>(wm, wn, g, t, mt, nt, e, row, col);
                ptile[row * kAccStride + col] = ps[mt][nt][e];
                if (xtalk) xtile[row * kAccStride + col] = xt[mt][nt][e];
              }
          __syncthreads();
#pragma unroll
          for (int i = 0; i < S::kEPT; ++i) {
            const int e = tid + i * S::kThreads;
            if (e < live_elems) {
              const int rr = e / kTileC, c = e % kTileC;
              acc[i] += chain(ptile[rr * kAccStride + c], xtalk ? xtile[rr * kAccStride + c] : 0, rr, c);
            }
          }
          __syncthreads();  // the psum tiles are consumed
        } else {
          // One n tile at a time, the chain on the accumulator fragments.
#pragma unroll
          for (int nt = 0; nt < S::kNT; ++nt) {
            int ps[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}}, xt[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
            const int rr = wn * (BN / WN) + nt * 8 + g;
            for (int ks = 0; ks < npad / 32; ++ks) {
              uint32_t a[2][4], an[2][4], an2[2][4];
              load_a(ks, a, an, an2);
              const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xs + rr * sxs + 4 * (ks * 8 + t));
              const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xs + rr * sxs + 4 * (ks * 8 + 4 + t));
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_s8(ps[mt], a[mt], b0, b1);
                if (xtalk) mma_s8(xt[mt], an[mt], b0, b1);
                if (split_nb) mma_s8(xt[mt], an2[mt], b0, b1);
              }
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                int row, col;
                frag_pos<BN, WN>(wm, wn, g, t, mt, nt, e, row, col);
                if (row < live) acc[mt * S::kNT * 4 + nt * 4 + e] += chain(ps[mt][e], xt[mt][e], row, col);
              }
          }
        }
      }
      // Every warp is done reading slice ti's weight tiles before any writes
      // slice ti + 1's over them (the compact path's per-pass barrier does this).
      if constexpr (!kCompact) __syncthreads();
    }
  }
  cp_async_wait<0>();
  if constexpr (kCompact) {
#pragma unroll
    for (int i = 0; i < S::kEPT; ++i) {
      const int e = tid + i * S::kThreads;
      ptile[(e / kTileC) * kAccStride + e % kTileC] = acc[i];
    }
    return ptile;
  } else {
    __syncthreads();  // every warp is done with the slice tiles: the sums go over them
    int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int row, col;
          frag_pos<BN, WN>(wm, wn, g, t, mt, nt, e, row, col);
          tile[row * kAccStride + col] = acc[mt * S::kNT * 4 + nt * 4 + e];
        }
    return tile;
  }
}

template <int BN, int WN, bool IDEAL>
__global__ void __launch_bounds__(Shape<BN, WN>::kThreads) photonic_gemm_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int j = blockIdx.x, rt = blockIdx.y, s = blockIdx.z;
  const int col0 = j * kTileC, row0 = rt * BN;
  const int live = min(BN, p.live_rows - row0);
  const int u0 = (int)((long long)s * p.n_units / p.n_split);
  const int u1 = (int)((long long)(s + 1) * p.n_units / p.n_split);
  const int tile = rt * gridDim.x + j;
  const int* acc;
  if constexpr (IDEAL) {
    ideal_path<BN, WN>(p, smem, row0, col0, live, u0, u1);
    acc = reinterpret_cast<const int*>(smem);
  } else {
    acc = slice_path<BN, WN>(p, smem, row0, col0, live, u0, u1);
  }
  __syncthreads();
  finish<BN, WN>(p, acc, tile, row0, col0, live);
}

template <int BN, int WN, bool IDEAL>
int launch(const Params& p, int row_tiles, int bytes, cudaStream_t stream) {
  static int configured = 0;
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(photonic_gemm_kernel<BN, WN, IDEAL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  const dim3 grid(p.C / kTileC, row_tiles, p.n_split);
  photonic_gemm_kernel<BN, WN, IDEAL><<<grid, Shape<BN, WN>::kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  `bn` (8 or 64) is the CTA's row
// count and `n_split` the CTAs per output tile along K, both chosen by the
// wrapper's plan_launch; `ws_acc` (int32, bn * 128 per output tile) and
// `tickets` (one int32 per output tile) must be zero and are left zero;
// they may be null when n_split == 1.  Returns 0 on a clean launch, a
// negative code for arguments the kernel does not take, or the value of
// cudaGetLastError() after the launch.  `c_origin` (>= 0) is the column of
// the whole weight that the launch's column 0 is, and `r_origin` (>= 0) the
// row of the whole operand that its row 0 is, for the noise ids.
extern "C" int photonic_gemm_launch(
    const void* x, int x_f32, const void* w, const void* x_scale, const void* w_scale,
    const void* bias, const void* seed, void* out, int fused,
    int R, int K, int C, int live_rows, int tile_r, int tile_c, int tile_k, int n_chunk,
    int slice_bits, int num_slices, int operand_bits, int adc_bits,
    float sigma, int use_filter, float filter_scale, float eps_im, float eps_cw,
    int valid_chunks, int activation, int bn, int ideal, int n_split, int c_origin, int r_origin,
    void* ws_acc, void* tickets, void* stream) {
  if (tile_c < kTileC || tile_c % kTileC != 0 || C % tile_c != 0) return -1;
  if (tile_r % 8 != 0 || R % tile_r != 0 || live_rows < 1 || live_rows > R) return -2;
  if (n_chunk < 1 || n_chunk > kMaxN || tile_k % n_chunk != 0 || K % tile_k != 0) return -3;
  if (x_f32 && !fused) return -4;
  if (slice_bits < 1 || num_slices < 1 || slice_bits * num_slices > 16) return -5;
  const int xtalk = (eps_im > 0.0f || eps_cw > 0.0f) ? 1 : 0;
  if (!ideal && slice_bits > 8) return -6;  // slices overflow int8
  if (bn != 8 && bn != 64) return -7;
  if (R % bn != 0 || (!ideal && tile_r % bn != 0)) return -8;
  const int analog = (sigma > 0.0f || use_filter || eps_im > 0.0f || eps_cw > 0.0f) ? 1 : 0;
  if (ideal && (analog || adc_bits > 0 || K % kKStep != 0)) return -9;
  const int n_units = ideal ? K / kKStep : K / n_chunk;
  if (n_split < 1 || n_split > n_units) return -10;
  if (n_split > 1 && (ws_acc == nullptr || tickets == nullptr)) return -11;
  if (c_origin < 0 || c_origin > 0x7fffffff - C) return -13;
  if (r_origin < 0 || r_origin > 0x7fffffff - R) return -14;
  Params p;
  p.x = x;
  p.x_f32 = x_f32;
  p.w = static_cast<const int8_t*>(w);
  p.x_scale = static_cast<const float*>(x_scale);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.seed = static_cast<const uint32_t*>(seed);
  p.out = out;
  p.fused = fused;
  p.ws_acc = static_cast<int*>(ws_acc);
  p.tickets = static_cast<int*>(tickets);
  p.K = K;
  p.C = C;
  p.live_rows = live_rows;
  p.tile_r = tile_r;
  p.tile_c = tile_c;
  p.tile_k = tile_k;
  p.n_chunk = n_chunk;
  p.slice_bits = slice_bits;
  p.num_slices = num_slices;
  p.qmax = (1 << (operand_bits - 1)) - 1;
  p.adc_lim = adc_bits > 0 ? (1 << (adc_bits - 1)) - 1 : -1;
  p.analog = analog;
  p.sigma = sigma;
  p.use_filter = use_filter;
  p.filter_scale = filter_scale;
  p.eps_im = eps_im;
  p.eps_cw = eps_cw;
  p.valid_chunks = valid_chunks;
  p.activation = activation;
  p.ideal = ideal;
  p.n_units = n_units;
  p.n_split = n_split;
  p.npad = (n_chunk + 31) & ~31;
  p.c_origin = c_origin;
  p.r_origin = r_origin;
  const int row_tiles = (live_rows + bn - 1) / bn;
  int bytes;
  if (ideal) {
    bytes = kStages * ideal_stage_bytes(bn, x_f32);
    const int acc_bytes = bn * kAccStride * 4;
    if (acc_bytes > bytes) bytes = acc_bytes;
  } else {
    bytes = slice_smem_bytes(bn, n_chunk, p.npad, num_slices, neighbour_tiles(xtalk, slice_bits));
  }
  if (bytes > 227 * 1024 - 128) return -12;  // the static `last` flag shares the SM's 227 KB
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ideal) return bn == 8 ? launch<8, 1, true>(p, row_tiles, bytes, s) : launch<64, 2, true>(p, row_tiles, bytes, s);
  return bn == 8 ? launch<8, 1, false>(p, row_tiles, bytes, s) : launch<64, 2, false>(p, row_tiles, bytes, s);
}
