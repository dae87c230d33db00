// The mxu analysis template, shared by anal_mxu (legendre.cu, kernel 4) and
// anal_fused_mxu / anal_packed_mxu (fused.cu, kernels 12 and 8): the panel
// build, the register-tiled contraction and the fixed-order reduction of
// the ring slices.  The kernels keep only their prologue (the chunk's Delta
// into shared memory: kernel 4 copies its rows, kernels 12 and 8 rotate and
// combine the FFT rows) and the place each output goes.
//
// A block of 256 threads carries one row (m, m') of a 512-ring chunk at a
// time, the chunk's weighted Delta resident in shared memory, channel-major
// (d_s[plane][c][ring]).  Per panel of HL rows (32; 16 with the fold):
//   1. build: thread t steps rings 2t, 2t + 1 through the rows with the
//      steps of recurrence.cuh (seed and P_{m+1,m} peeled off the row's
//      first panel, so every P_lm keeps the plain version's bits), reading
//      each row's coefficients once for both rings (one float4 table entry)
//      and storing both values with one 8-byte store; threads whose ring
//      quad holds no live ring skip it.  One barrier.
//   2. contract: thread (tile, slice) owns TL = 4 rows x TC = min(CC, 8)
//      channels and sums them over its ring slice, the quads slice,
//      slice + NS, ... below the live quads, each quad read as one float4
//      of P per row and one float4 of Delta per channel (16 or 32 FFMA a
//      16-byte load).  With the fold a tile's rows share one parity (rows
//      8 (g / 2) + 2 i + g % 2), so it reads one plane.
//   3. reduce: a tile's NS ring slices are lanes of one warp, so a
//      reduce-scatter butterfly sums them in registers (shuffles, no shared
//      memory): each output is summed on one lane in one fixed order, the
//      same bits on every run, and goes straight to the kernel's output.
//      One barrier before the next build.
// Every GROUP = 256 / HL panels all threads fill the coefficient table of
// the next GROUP panels, one row each, and meet at a barrier.
// The bfloat16 branch (BF16, kernel 12 only) builds the same panel and
// contracts it with mma.sync m16n8k16 instead: warp w takes rings 64 w ..
// 64 w + 63 of the chunk for every row and the [plane 0 | plane 1] Delta
// columns, each row keeping its parity's plane; the warps' sums meet in
// red_s (aliasing the panel) and every output adds them in warp order
// (two more barriers).
//
// Shared memory at 16 channels: Delta 33 KB a plane, the panel 67 KB (33
// with the fold), the table 4 KB: 104 KB, two blocks (16 warps) an SM with
// or without the fold.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "recurrence.cuh"

namespace {

constexpr int kMxuBlocksPerSm = 2;
constexpr int kMxuThreads = 256;
constexpr int kMxuChunk = kMxuAnalTiles * kTile;    // rings of a chunk
constexpr int kMxuRings = kMxuChunk / kMxuThreads;  // rings a thread builds
static_assert(kMxuRings == 2, "the build stores a ring pair as one float2");

// Shared-memory shape of CC channels: HL panel rows, TL x TC thread tiles
// (TL 2 where 4 would leave more than 32 slices), NS ring slices (BF16: one
// per warp), row strides padded so that the float4 loads of the
// contraction, the float2 fragment loads of BF16 and the red_s stores of
// BF16 avoid bank conflicts.
template <int CC_, bool FOLD, bool BF16>
struct MxuAnalShape {
  static constexpr int CC = CC_;
  static constexpr int P = FOLD ? 2 : 1;
  static constexpr int HL = FOLD ? 16 : 32;
  static constexpr int TC = CC < 8 ? CC : 8;
  static constexpr int TL = (HL / 4) * (CC / TC) >= 8 ? 4 : 2;
  static constexpr int NT = (HL / TL) * (CC / TC);
  static constexpr int NS = BF16 ? kMxuThreads / 32 : kMxuThreads / NT;
  static_assert(BF16 || NS <= 32, "a tile's ring slices are lanes of a warp");
  static constexpr int PS = kMxuChunk + 8;          // panel row stride
  static constexpr int DS = kMxuChunk + 8;          // Delta row stride
  static constexpr int RS = HL * CC + 4;            // red_s row stride
  static constexpr int d_floats = P * CC * DS;
  static constexpr int panel_floats =
      HL * PS > NS * RS ? HL * PS : NS * RS;
  static constexpr int GROUP = kMxuThreads / HL;   // panels a table covers
  static constexpr int coef_floats = kMxuThreads * 4;  // one float4 an l
  static constexpr size_t smem_bytes =
      static_cast<size_t>(d_floats + panel_floats + coef_floats) *
      sizeof(float);
  static_assert(kMxuThreads % NT == 0 && HL % (2 * TL) == 0 && HL % 16 == 0,
                "thread tiles divide the block");
};

// Two float32 values rounded to bfloat16 and packed into one register, lo in
// the low half (the element of the smaller k or column index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// d += a b on the tensor cores: a 16 x 16 row-major bf16 fragment, b a
// 16 x 8 column-major bf16 fragment, d the 16 x 8 float32 accumulator.
// Lane layout (g = lane / 4, q = lane % 4): a {(g, 2q..2q+1), (g + 8, 2q..),
// (g, 2q+8..), (g + 8, 2q+8..)}, b {(2q..2q+1, g), (2q+8.., g)}, d {(g, 2q),
// (g, 2q+1), (g + 8, 2q), (g + 8, 2q+1)}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Thread t fills entry t of the coefficient table of rows l0 .. l0 +
// kMxuThreads - 1 (GROUP panels): (beta, beta ratio) for spin 0 as
// fill_beta, (a, b, c) for spin as fill_spin, one float4 an l.
template <bool SPIN>
__device__ __forceinline__ void mxu_fill(int l0, int m, int mp, float4* tab) {
  const int l = l0 + static_cast<int>(threadIdx.x);
  float4 e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (SPIN) {
    spin_coef(l, m, mp, &e.x, &e.y, &e.z);
  } else {
    if (l >= m + 2) beta_pair(l, m, &e.x, &e.y);
  }
  tab[threadIdx.x] = e;
}

// Rows j0 <= j < n of the panel for the thread's ring pair, `col` its
// column pair in row 0; on the row's first panel (first) the seed (its
// seeds read here) and, for spin 0, P_{m+1,m} come first.
template <bool SPIN, int PS>
__device__ __forceinline__ void mxu_build(Rec (&s)[kMxuRings],
                                          const float (&xr)[kMxuRings],
                                          const float4* tab, float* col,
                                          bool first, int n, int m,
                                          const float* __restrict__ pmm,
                                          const int* __restrict__ pms,
                                          int r0, int R) {
  int j = 0;
  if (first) {
    float v[kMxuRings];
#pragma unroll
    for (int k = 0; k < kMxuRings; ++k) {
      const bool live = r0 + k < R;
      v[k] = rec_seed(&s[k], live ? pmm[r0 + k] : 0.0f,
                      live ? pms[r0 + k] : 0);
    }
    *reinterpret_cast<float2*>(col) = make_float2(v[0], v[1]);
    j = 1;
    if (!SPIN && n > 1) {
      const float p1 = p_first_coef(m);
#pragma unroll
      for (int k = 0; k < kMxuRings; ++k) v[k] = rec_first(&s[k], xr[k], p1);
      *reinterpret_cast<float2*>(col + PS) = make_float2(v[0], v[1]);
      j = 2;
    }
  }
  for (; j < n; ++j) {
    const float4 e = tab[j];
    float v[kMxuRings];
#pragma unroll
    for (int k = 0; k < kMxuRings; ++k) {
      if constexpr (SPIN) {
        v[k] = rec_next_spin(&s[k], xr[k], e.x, e.y, e.z);
      } else {
        v[k] = rec_next(&s[k], xr[k], e.x, e.y);
      }
    }
    *reinterpret_cast<float2*>(col + j * PS) = make_float2(v[0], v[1]);
  }
}

// Panel row of row i of row group g (TL rows): with the fold every row of
// a group has the group's parity.
template <int TL>
__device__ __forceinline__ int mxu_row(int g, int i) {
  return 2 * TL * (g >> 1) + 2 * i + (g & 1);
}

// Level LV of the reduce-scatter butterfly over NS lanes (slice s) of V
// values: at lane offset O = NS >> (LV + 1) a lane keeps the half H = V >>
// (LV + 1) of its values picked by bit O of s, adds the partner's sums of
// that half, and gives the other half away; once a single value is left it
// is added across the remaining offsets and only the lane with the bit
// clear writes it.  `first` collects the kept halves' offsets.
template <int LV, int NS, int V>
__device__ __forceinline__ void mxu_butterfly(float (&v)[V], int s,
                                              int& first, bool& writes) {
  if constexpr ((NS >> (LV + 1)) >= 1) {
    constexpr int O = NS >> (LV + 1), H = V >> (LV + 1);
    const bool hi = (s & O) != 0;
    if constexpr (H >= 1) {
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float keep = hi ? v[k + H] : v[k];
        const float give = hi ? v[k] : v[k + H];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, give, O);
      }
      if (hi) first += H;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      writes = writes && !hi;
    }
    mxu_butterfly<LV + 1, NS, V>(v, s, first, writes);
  }
}

// The float32 contraction of the thread's tile (row group g, channel tile
// ct) over its ring slice, then the tile's NS slices (the lanes t % NS of
// its warp) summed by a reduce-scatter butterfly: at lane offset o = NS/2
// .. 1 each lane keeps one half of its values, adds its partner's sums of
// that half, and gives the other half away; a value left alone is added
// across the remaining offsets.  Each output is summed on one lane, in one
// fixed order, and handed to out(j, c, sum) for panel row j and channel c.
// `parity` is (l0 + m) & 1: row j takes plane (parity + j) & 1.
template <class Sh, class Out>
__device__ __forceinline__ void mxu_contract(const float* panel_s,
                                             const float* d_s, int nq,
                                             int parity, Out out) {
  constexpr int TL = Sh::TL, TC = Sh::TC, NS = Sh::NS, CC = Sh::CC;
  constexpr int V = TL * TC;
  const int t = threadIdx.x;
  const int s = t % NS, tile = t / NS;
  const int g = tile / (CC / TC), ct = tile % (CC / TC);
  const int plane = Sh::P == 2 ? ((parity + g) & 1) : 0;
  const float* dp = d_s + (plane * CC + ct * TC) * Sh::DS;
  float acc[TL][TC];
#pragma unroll
  for (int i = 0; i < TL; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.0f;
#pragma unroll 1                     // (2 is 5-7% slower, and spills)
  for (int q = s; q < nq; q += NS) {
    float4 pv[TL];
#pragma unroll
    for (int i = 0; i < TL; ++i)
      pv[i] = *reinterpret_cast<const float4*>(
          panel_s + mxu_row<TL>(g, i) * Sh::PS + 4 * q);
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const float4 d = *reinterpret_cast<const float4*>(dp + c * Sh::DS +
                                                        4 * q);
#pragma unroll
      for (int i = 0; i < TL; ++i) {
        acc[i][c] = fmaf(pv[i].x, d.x, acc[i][c]);
        acc[i][c] = fmaf(pv[i].y, d.y, acc[i][c]);
        acc[i][c] = fmaf(pv[i].z, d.z, acc[i][c]);
        acc[i][c] = fmaf(pv[i].w, d.w, acc[i][c]);
      }
    }
  }
  float v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = acc[k / TC][k % TC];
  int first = 0;                       // this lane's outputs: first + k
  bool writes = true;
  mxu_butterfly<0, NS, V>(v, s, first, writes);
  constexpr int VF = V / NS > 0 ? V / NS : 1;
  if (writes) {
#pragma unroll
    for (int k = 0; k < VF; ++k) {
      const int i = (first + k) / TC, c = (first + k) % TC;
      out(mxu_row<TL>(g, i), ct * TC + c, v[k]);
    }
  }
}

// The bfloat16 contraction on the tensor cores: warp w over rings 64 w ..
// 64 w + 63 (ring pairs past the built quads read as zero), its sums
// stored into slice w of red_s after a barrier.
template <class Sh>
__device__ __forceinline__ void mxu_contract_bf16(float* panel_s,
                                                  const float* d_s, int nq,
                                                  int parity) {
  constexpr int CC = Sh::CC, NC = Sh::P * CC;       // [plane 0 | plane 1]
  constexpr int MT = Sh::HL / 16, NT = (NC + 7) / 8;
  const int t = threadIdx.x;
  const int warp = t / 32, lg = (t % 32) / 4, lq = t % 4;
  const int lim = 4 * nq;
  float dacc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) dacc[i][j][k] = 0.0f;
  auto pv = [&](int j, int ring) {
    return ring < lim ? *reinterpret_cast<const float2*>(
                            panel_s + j * Sh::PS + ring)
                      : make_float2(0.0f, 0.0f);
  };
  auto dv = [&](int ring, int col) {
    return col < NC ? *reinterpret_cast<const float2*>(
                          d_s + col * Sh::DS + ring)
                    : make_float2(0.0f, 0.0f);
  };
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int k0 = warp * 64 + ks * 16;
    if (k0 >= lim) break;                            // warp-uniform
    const int rk = k0 + 2 * lq;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int j = mt * 16 + lg;
      float2 p = pv(j, rk);
      a[mt][0] = pack_bf16(p.x, p.y);
      p = pv(j + 8, rk);
      a[mt][1] = pack_bf16(p.x, p.y);
      p = pv(j, rk + 8);
      a[mt][2] = pack_bf16(p.x, p.y);
      p = pv(j + 8, rk + 8);
      a[mt][3] = pack_bf16(p.x, p.y);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + lg;
      const float2 d0 = dv(rk, col), d1 = dv(rk + 8, col);
      const uint32_t b[2] = {pack_bf16(d0.x, d0.y), pack_bf16(d1.x, d1.y)};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(dacc[mt][nt], a[mt], b);
    }
  }
  __syncthreads();                     // panel read: red_s aliases it
  // each row keeps the columns of its parity's plane
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = mt * 16 + lg + 8 * (e / 2);
        const int col = nt * 8 + 2 * lq + e % 2;
        if (col < NC && (Sh::P == 1 || col / CC == ((parity + j) & 1)))
          panel_s[warp * Sh::RS + j * CC + col % CC] = dacc[mt][nt][e];
      }
}

// One row (m, m') of the block's chunk, its Delta already stored in d_s by
// the caller (visible after the first barrier here): every panel of rows
// lz .. l_end - 1 built, contracted and reduced, each output handed to
// out(l, c, sum) for channel c < CC.  xr: the thread's rings' x (0 past R);
// live: the chunk's rings below R; pmm, pms: the row's seeds.
template <int CC, bool FOLD, bool SPIN, bool BF16, class Out>
__device__ __forceinline__ void mxu_anal_row(float* smem,
                                             const float (&xr)[kMxuRings],
                                             int live, int m, int mp, int lz,
                                             int l_end,
                                             const float* __restrict__ pmm,
                                             const int* __restrict__ pms,
                                             int base, int R, Out out) {
  using Sh = MxuAnalShape<CC, FOLD, BF16>;
  constexpr int HL = Sh::HL;
  float* d_s = smem;
  float* panel_s = d_s + Sh::d_floats;
  float4* coef_s = reinterpret_cast<float4*>(panel_s + Sh::panel_floats);
  const int t = threadIdx.x;
  const int nq = (live + 3) / 4;                  // quads with a live ring
  const bool builds = t / 2 < nq;                 // rings 2t, 2t + 1
  Rec s[kMxuRings];
  int it = 0;
  for (int l0 = lz; l0 < l_end; l0 += HL, ++it) {  // block-uniform
    const int n = min(HL, l_end - l0);
    if (it % Sh::GROUP == 0) {                    // the next GROUP panels'
      mxu_fill<SPIN>(l0, m, mp, coef_s);          // coefficients, one row a
      __syncthreads();                            // thread (and Delta)
    }
    if (builds)
      mxu_build<SPIN, Sh::PS>(s, xr, coef_s + (it % Sh::GROUP) * HL,
                              panel_s + 2 * t, l0 == lz, n, m, pmm, pms,
                              base + 2 * t, R);
    __syncthreads();                              // panel built
    if constexpr (BF16) {
      mxu_contract_bf16<Sh>(panel_s, d_s, nq, (l0 + m) & 1);
      __syncthreads();                            // slices stored
      for (int o4 = t; o4 < HL * CC / 4; o4 += kMxuThreads) {
        float tot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < Sh::NS; ++k) {
          const float4 v = *reinterpret_cast<const float4*>(
              panel_s + k * Sh::RS + 4 * o4);
          tot[0] += v.x;
          tot[1] += v.y;
          tot[2] += v.z;
          tot[3] += v.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int o = 4 * o4 + u;
          if (o / CC < n) out(l0 + o / CC, o % CC, tot[u]);
        }
      }
    } else {
      mxu_contract<Sh>(panel_s, d_s, nq, (l0 + m) & 1,
                       [&](int j, int c, float v) {
                         if (j < n) out(l0 + j, c, v);
                       });
    }
    __syncthreads();                              // panel read: next build
  }
}

}  // namespace
