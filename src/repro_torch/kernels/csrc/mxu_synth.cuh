// The mxu synthesis template, carrying synth_mxu (legendre.cu, kernel 2)
// and synth_fused_mxu / synth_packed_mxu (fused.cu, kernels 10 and 6, with
// kernel 10's bfloat16 branch).  The kernels keep only their prologue (the
// block's coefficient rows, handed over one (l, channel) at a time) and
// their epilogue (kernel 2: both fold planes as they are; kernels 10 and 6:
// fold combine, rotation; the place each output goes).
//
// A block of 256 threads carries one row (m, m') of a 512-ring chunk at a
// time, thread t the ring pair 2t, 2t + 1.  Every 256
// multipoles (a group) all threads fill the recurrence table (mxu_fill of
// mxu_anal.cuh: one float4 an l) and the coefficient rows a_s of the
// group, one l a thread, between two barriers.  Within a group, in
// float32:
//   each step advances the thread's rings by the steps of recurrence.cuh
//   (seed and P_{m+1,m} peeled off the row's first group, so every P_lm
//   keeps the plain version's bits, and no per-step branch or guard) and
//   adds each ring's value times the l's CC coefficients (broadcast
//   16-byte loads, four channels at a time) into its accumulators
//   acc[ring][plane][channel] in registers.  Synthesis sums over l, not
//   over rings, so no panel, no partials and no reduction: each output is
//   one fmaf chain over ascending l from 0.0f, the bits of a one-ring-a-
//   thread contraction.  With the fold the group starts at an even l - m,
//   so even steps add into plane 0 and odd ones into plane 1 (a two-step
//   unroll).  Without the fold (2 x CC <= 32 accumulators) three blocks
//   run on an SM (24 warps, 80 registers); across each group's fill the
//   sums wait in shared memory (stash_s), so the fill's slow-path calls of
//   the correctly rounded divisions spill nothing.  With the fold, 2.
// The bfloat16 branch (BF16, kernel 10 only) builds 32-row panels of P in
// shared memory with the analysis template's mxu_build (one barrier) and
// contracts each with mma.sync m16n8k16 (one barrier): warp w takes rings
// 64 w .. 64 w + 63 of the 512-ring chunk against the [plane 0 | plane 1]
// coefficient columns, each row keeping its parity's half; its sums are
// staged once per row in shared memory (aliasing the panel and a_s).
// Either way the kernel's epilogue gets out(rr, v) per live ring rr of the
// chunk, v[plane][channel] with all CC channels.
//
// Shared memory at 16 channels: a_s 16 KB, the table 4 KB and the stash
// 32 KB (64 with the fold); bf16: a_s, the table and the 67 KB panel.

#pragma once

#include "mxu_anal.cuh"
#include "recurrence.cuh"

namespace {

constexpr int kMxuSynthBlocks = 3;   // float32 without the fold: blocks an SM

// Shared-memory shape of CC channels: the group's a rows and recurrence
// table, and for BF16 the HL-row panel and the stage of its sums.
template <int CC_, bool FOLD, bool BF16>
struct MxuSynthShape {
  static constexpr int CC = CC_;
  static constexpr int P = FOLD ? 2 : 1;
  // blocks an SM: kMxuSynthBlocks in float32 without the fold (2 x CC
  // <= 32 accumulators in the 80 registers), else 2
  static constexpr int MIN_BLOCKS =
      BF16 || FOLD ? kMxuBlocksPerSm : kMxuSynthBlocks;
  static constexpr int LG = kMxuThreads;            // multipoles a group
  static constexpr int HL = kLT;                    // BF16 panel rows
  static constexpr int PS = kMxuChunk + 8;          // BF16 panel row stride
  static constexpr int NT = (P * CC + 7) / 8;       // BF16 n8 tiles
  static constexpr int SS = CC + 1;                 // BF16 stage row stride
  static constexpr int panel_floats = BF16 ? HL * PS : 0;
  static constexpr int a_floats = LG * CC;          // the group's a rows
  static constexpr int coef_floats = LG * 4;        // one float4 an l
  static constexpr int stash_floats =
      BF16 ? 0 : kMxuRings * P * CC * kMxuThreads;
  static constexpr size_t smem_bytes =
      static_cast<size_t>(panel_floats + a_floats + coef_floats +
                          stash_floats) * sizeof(float);
  static_assert(CC % 4 == 0 || CC == 2, "a rows load as float4 or float2");
  static_assert(!BF16 || P * kMxuChunk * SS <= panel_floats + a_floats,
                "the bfloat16 stage fits the panel and a_s");
};

// One row of CC coefficients from shared memory (16- or 8-byte loads).
template <int CC>
__device__ __forceinline__ void load_row(const float* src, float (&a)[CC]) {
  if constexpr (CC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CC; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + c);
      a[c] = v.x;
      a[c + 1] = v.y;
      a[c + 2] = v.z;
      a[c + 3] = v.w;
    }
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    a[0] = v.x;
    a[1] = v.y;
  }
}

// The float32 first steps of a row's first group: the seed at lz (plane 0;
// its seeds read here), then, for spin 0 and n > 1, P_{m+1,m} (plane
// P - 1), each sum starting as fmaf(v, a, 0.0f) as in the steady steps.
// Returns the first row left to the steady steps.
template <class Sh, bool SPIN>
__device__ __forceinline__ int mxu_synth_first(
    Rec (&s)[kMxuRings], const float (&xr)[kMxuRings], const float* a_s,
    int n, int m, const float* __restrict__ pmm,
    const int* __restrict__ pms, int r0, int R,
    float (&acc)[kMxuRings][Sh::P][Sh::CC]) {
  constexpr int CC = Sh::CC;
  float a[CC];
  load_row<CC>(a_s, a);
#pragma unroll
  for (int k = 0; k < kMxuRings; ++k) {
    const bool live = r0 + k < R;
    const float v = rec_seed(&s[k], live ? pmm[r0 + k] : 0.0f,
                             live ? pms[r0 + k] : 0);
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[k][0][c] = fmaf(v, a[c], acc[k][0][c]);
  }
  if (SPIN || n < 2) return 1;
  const float p1 = p_first_coef(m);
  load_row<CC>(a_s + CC, a);
#pragma unroll
  for (int k = 0; k < kMxuRings; ++k) {
    const float v = rec_first(&s[k], xr[k], p1);
#pragma unroll
    for (int c = 0; c < CC; ++c)
      acc[k][Sh::P - 1][c] = fmaf(v, a[c], acc[k][Sh::P - 1][c]);
  }
  return 2;
}

// The float32 steady steps j0 <= j < n of one group: the thread's rings
// advance by the three-term recurrence (one table entry for all) and add
// their products, the coefficients read four at a time; even j into plane
// 0, odd j into plane P - 1.
template <class Sh, bool SPIN>
__device__ __forceinline__ void mxu_synth_steps(
    Rec (&s)[kMxuRings], const float (&xr)[kMxuRings], const float4* tab,
    const float* a_s, int j, int n, float (&acc)[kMxuRings][Sh::P][Sh::CC]) {
  constexpr int CC = Sh::CC;
  constexpr int W = CC % 4 == 0 ? 4 : 2;
  auto step = [&](int jj, int p) {
    const float4 e = tab[jj];
    float v[kMxuRings];
#pragma unroll
    for (int k = 0; k < kMxuRings; ++k) {
      if constexpr (SPIN) {
        v[k] = rec_next_spin(&s[k], xr[k], e.x, e.y, e.z);
      } else {
        v[k] = rec_next(&s[k], xr[k], e.x, e.y);
      }
    }
#pragma unroll
    for (int c0 = 0; c0 < CC; c0 += W) {
      float a[W];
      load_row<W>(a_s + jj * CC + c0, a);
#pragma unroll
      for (int k = 0; k < kMxuRings; ++k)
#pragma unroll
        for (int c = 0; c < W; ++c)
          acc[k][p][c0 + c] = fmaf(v[k], a[c], acc[k][p][c0 + c]);
    }
  };
  for (; j + 1 < n; j += 2) {
    step(j, 0);
    step(j + 1, Sh::P - 1);
  }
  if (j < n) step(j, 0);
}

// The bfloat16 contraction of one panel on the tensor cores: warp w over
// rings 64 w .. 64 w + 63 (skipped past the built quads), panel rows past
// n read as zero, column col of plane col / CC taking only rows of its
// parity (the panel starts at an even l - m).  The B fragments are formed
// once a k-step, the A fragments one m16 tile at a time.
template <class Sh>
__device__ __forceinline__ void mxu_synth_contract_bf16(
    const float* panel_s, const float* arows, int n, int nq,
    float (&dacc)[4][Sh::NT][4]) {
  constexpr int CC = Sh::CC, NC = Sh::P * CC;       // [plane 0 | plane 1]
  const int t = threadIdx.x;
  const int warp = t / 32, lg = (t % 32) / 4, lq = t % 4;
  if (warp * 64 >= 4 * nq) return;                  // warp-uniform
  auto pv = [&](int j, int ring) {
    return j < n ? panel_s[j * Sh::PS + ring] : 0.0f;
  };
  auto cv = [&](int j, int col) {
    const bool on = col < NC && (Sh::P == 1 || (j & 1) == col / CC);
    return on ? arows[j * CC + col % CC] : 0.0f;
  };
#pragma unroll
  for (int ks = 0; ks < Sh::HL / 16; ++ks) {
    const int lk = ks * 16 + 2 * lq;
    uint32_t b[Sh::NT][2];
#pragma unroll
    for (int nt = 0; nt < Sh::NT; ++nt) {
      const int col = nt * 8 + lg;
      b[nt][0] = pack_bf16(cv(lk, col), cv(lk + 1, col));
      b[nt][1] = pack_bf16(cv(lk + 8, col), cv(lk + 9, col));
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int rr = warp * 64 + mt * 16 + lg;
      const uint32_t a[4] = {pack_bf16(pv(lk, rr), pv(lk + 1, rr)),
                             pack_bf16(pv(lk, rr + 8), pv(lk + 1, rr + 8)),
                             pack_bf16(pv(lk + 8, rr), pv(lk + 9, rr)),
                             pack_bf16(pv(lk + 8, rr + 8),
                                       pv(lk + 9, rr + 8))};
#pragma unroll
      for (int nt = 0; nt < Sh::NT; ++nt) mma_bf16(dacc[mt][nt], a, b[nt]);
    }
  }
}

// One row (m, m') of the block's chunk: every multipole lz .. l_end - 1
// contracted, then out(rr, v) for each live ring rr of the chunk, v[p][c]
// its sum of plane p, channel c < CC.  arow(l, c): the row's coefficient
// of local channel c at multipole l (read once, at the fill); xr: the
// thread's rings' x (0 past R); live: the chunk's rings below R; pmm,
// pms: the row's seeds.  An empty row (l_end <= lz) hands out zeros.
template <int CC, bool FOLD, bool SPIN, bool BF16, class ARow, class Out>
__device__ __forceinline__ void mxu_synth_row(float* smem,
                                              const float (&xr)[kMxuRings],
                                              int live, int m, int mp, int lz,
                                              int l_end,
                                              const float* __restrict__ pmm,
                                              const int* __restrict__ pms,
                                              int base, int R, ARow arow,
                                              Out out) {
  using Sh = MxuSynthShape<CC, FOLD, BF16>;
  constexpr int P = Sh::P, HL = Sh::HL;
  float* panel_s = smem;
  float* a_s = panel_s + Sh::panel_floats;
  float4* coef_s = reinterpret_cast<float4*>(a_s + Sh::a_floats);
  const int t = threadIdx.x;
  float* stash_s = reinterpret_cast<float*>(coef_s + Sh::LG) + t;
  const int nq = (live + 3) / 4;                  // quads with a live ring
  // bf16: the pair of a live quad; float32: a pair with a live ring
  const bool builds = BF16 ? t / 2 < nq : kMxuRings * t < live;
  float acc[kMxuRings][P][CC];
  float dacc[4][Sh::NT][4];
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < Sh::NT; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) dacc[i][j][k] = 0.0f;
  } else {
#pragma unroll
    for (int k = 0; k < kMxuRings; ++k)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int c = 0; c < CC; ++c) acc[k][p][c] = 0.0f;
  }
  Rec s[kMxuRings];
  for (int l0 = lz; l0 < l_end; l0 += Sh::LG) {   // block-uniform
    const int n = min(Sh::LG, l_end - l0);
    if (!BF16 && l0 != lz) {
      // the sums wait in shared memory while the fill runs (its correctly
      // rounded divisions call a slow path that would spill them)
#pragma unroll
      for (int k = 0; k < kMxuRings; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int c = 0; c < CC; ++c)
            stash_s[((k * P + p) * CC + c) * kMxuThreads] = acc[k][p][c];
      __syncthreads();                            // previous group read
    }
    mxu_fill<SPIN>(l0, m, mp, coef_s);            // the group's table and
    const int l = l0 + t;                         // a rows, one l a thread
#pragma unroll
    for (int c = 0; c < CC; ++c)
      a_s[t * CC + c] = l < l_end ? arow(l, c) : 0.0f;
    __syncthreads();
    if (!BF16 && l0 != lz) {
#pragma unroll
      for (int k = 0; k < kMxuRings; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int c = 0; c < CC; ++c)
            acc[k][p][c] = stash_s[((k * P + p) * CC + c) * kMxuThreads];
    }
    if constexpr (BF16) {
      for (int p0 = 0; p0 < n; p0 += HL) {        // block-uniform
        const int np = min(HL, n - p0);
        if (builds)
          mxu_build<SPIN, Sh::PS>(s, xr, coef_s + p0, panel_s + 2 * t,
                                  l0 == lz && p0 == 0, np, m, pmm, pms,
                                  base + 2 * t, R);
        __syncthreads();                          // panel built
        mxu_synth_contract_bf16<Sh>(panel_s, a_s + p0 * CC, np, nq, dacc);
        __syncthreads();                          // panel read: next build
      }
    } else if (builds) {
      const int j = l0 == lz
          ? mxu_synth_first<Sh, SPIN>(s, xr, a_s, n, m, pmm, pms,
                                      base + kMxuRings * t, R, acc)
          : 0;
      mxu_synth_steps<Sh, SPIN>(s, xr, coef_s, a_s, j, n, acc);
    }
  }
  if constexpr (BF16) {
    // the warps' tiles through shared memory, ring-major (the last barrier
    // let go of the panel), then two rings a thread
    float* stage = smem;
    const int warp = t / 32, lg = (t % 32) / 4, lq = t % 4;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < Sh::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ring = warp * 64 + mt * 16 + lg + 8 * (e / 2);
          const int col = nt * 8 + 2 * lq + e % 2;
          if (col < P * CC)
            stage[((col / CC) * kMxuChunk + ring) * Sh::SS + col % CC] =
                dacc[mt][nt][e];
        }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMxuRings; ++k) {
      const int rr = t + k * kMxuThreads;
      if (rr >= live) continue;
      float v[P][CC];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int c = 0; c < CC; ++c)
          v[p][c] = stage[(p * kMxuChunk + rr) * Sh::SS + c];
      out(rr, v);
    }
    __syncthreads();                              // stage read: next fill
  } else {
    __syncthreads();                              // a_s read: next fill
#pragma unroll
    for (int k = 0; k < kMxuRings; ++k)
      if (kMxuRings * t + k < live) out(kMxuRings * t + k, acc[k]);
  }
}

}  // namespace
