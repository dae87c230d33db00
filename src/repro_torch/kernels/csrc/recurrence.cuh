// The scaled float32 Legendre recurrence shared by the port's kernels
// (legendre.cu, fused.cu), so every kernel computes bit-identical P_lm.
//
// P_{l,m} is carried as a (mantissa, scale) pair, P = mant * 2^(64 scale),
// renormalised by 2^+-64 with selects, and a value counts only where
// scale == 0, as in the reference's `_f32_step`
// (src/repro/kernels/legendre_pallas.py:76).  Every operation is a
// separately rounded IEEE one (no contraction) and 1/sqrt is a correctly
// rounded square root and division, as in the plain PyTorch version
// (repro_torch/kernels/ref.py): the recurrence amplifies a last-bit
// difference to about 4e-4 of max|Delta| by l_max 256.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 4294967296.0f;                  // 2^32
constexpr float kInvBig = 2.3283064365386963e-10f;     // 2^-32
constexpr float kBig2 = 18446744073709551616.0f;       // 2^64
constexpr float kInvBig2 = 5.421010862427522e-20f;     // 2^-64

constexpr int kTile = 128;     // rings per tile = threads per block
constexpr int kLT = 32;        // l rows per staged tile / panel
constexpr int kVpuAnalTiles = 8;   // anal_vpu: 1024-ring chunks
constexpr int kMxuAnalTiles = 4;   // anal_mxu: 512-ring chunks

// beta_{l,m} and beta_{l,m} / beta_{l-1,m} for l >= m + 2, in float32 as
// `_f32_step` computes them.
__device__ __forceinline__ void beta_pair(int l, int m, float* bl,
                                          float* ratio) {
  const float lf = static_cast<float>(l), mf = static_cast<float>(m);
  const float lb = fmaxf(lf, mf + 2.0f);
  const float b = __fdiv_rn(1.0f, __fsqrt_rn(__fdiv_rn(
      __fsub_rn(__fmul_rn(lb, lb), __fmul_rn(mf, mf)),
      __fsub_rn(__fmul_rn(__fmul_rn(4.0f, lb), lb), 1.0f))));
  const float lb1 = fmaxf(lf - 1.0f, mf + 1.0f);
  const float b1 = __fdiv_rn(1.0f, __fsqrt_rn(__fdiv_rn(
      __fsub_rn(__fmul_rn(lb1, lb1), __fmul_rn(mf, mf)),
      __fsub_rn(__fmul_rn(__fmul_rn(4.0f, lb1), lb1), 1.0f))));
  *bl = b;
  *ratio = __fdiv_rn(b, b1);
}

// Threads below kLT fill the block's beta table for rows l0 .. l0 + kLT - 1.
__device__ __forceinline__ void fill_beta(int l0, int m, float* bl_s,
                                          float* ratio_s) {
  if (threadIdx.x < kLT) {
    const int l = l0 + static_cast<int>(threadIdx.x);
    float bl = 0.0f, ratio = 0.0f;
    if (l >= m + 2) beta_pair(l, m, &bl, &ratio);
    bl_s[threadIdx.x] = bl;
    ratio_s[threadIdx.x] = ratio;
  }
}

// The (mantissa, scale) carry of one ring.
struct Rec {
  float pp = 0.0f;   // P_{l-2} mantissa
  float pc = 0.0f;   // P_{l-1} mantissa
  int sc = 0;        // shared scale
};

// Rescale and descale after the new mantissa `c` was formed (not at a seed).
__device__ __forceinline__ float rec_finish(Rec* s, float c) {
  float p = s->pc;
  int sc = s->sc;
  if (fabsf(c) > kBig && sc < 0) {
    c = c * kInvBig2;
    p = p * kInvBig2;
    sc += 1;
  }
  if (fabsf(c) < kInvBig && fabsf(p) < kInvBig) {
    c = c * kBig2;
    p = p * kBig2;
    sc -= 1;
  }
  s->pp = p;
  s->pc = c;
  s->sc = sc;
  return sc == 0 ? c : 0.0f;
}

// One step at multipole l >= m (block-uniform branches): the seed at l == m,
// P_{m+1,m} = sqrt(2m+3) x P_mm at l == m + 1, the three-term recurrence
// after.  Returns the descaled P_{l,m}.
__device__ __forceinline__ float rec_advance(Rec* s, int l, int m, float x,
                                             float bl, float ratio, float p1,
                                             float pmm, int pms) {
  if (l == m) {
    float c = pmm;
    int sc = pms;
    if (fabsf(c) > kBig && sc < 0) {
      c = c * kInvBig2;
      sc += 1;
    }
    s->pp = 0.0f;
    s->pc = c;
    s->sc = sc;
    return sc == 0 ? c : 0.0f;
  }
  float c;
  if (l == m + 1) {
    c = __fmul_rn(__fmul_rn(p1, x), s->pc);
  } else {
    c = __fsub_rn(__fmul_rn(__fmul_rn(bl, x), s->pc), __fmul_rn(ratio, s->pp));
  }
  return rec_finish(s, c);
}

__device__ __forceinline__ float p_first_coef(int m) {
  return __fsqrt_rn(fmaxf(2.0f * static_cast<float>(m) + 3.0f, 0.0f));
}

// Map (or channel) chunk per block: the smallest power of two >= n, from
// `lo`, capped at `cap`.
inline int chunk_for(int n, int cap, int lo = 2) {
  int kc = lo;
  while (kc < n && kc < cap) kc *= 2;
  return kc;
}

// Ring chunks of the analysis partials; the Python wrappers (ANAL_CHUNK in
// legendre_cuda.py) size the buffer, the launchers check it agrees.
inline int chunks_of(int R, int tiles) {
  return (R + tiles * kTile - 1) / (tiles * kTile);
}

}  // namespace
