// Slot kernels of the spherical harmonic transforms, for Hopper, on the
// packed slot layout (repro_torch/kernels/pack.py): the fused Legendre+phase
// kernels and the packed staged Legendre kernels, one template each.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math); bound through the plain C
//        interface at the end of this file (ctypes,
//        repro_torch.kernels.fused_cuda).
//
// A slot holds up to two m rows (segments) back to back in one l-stream of
// length S: segment 0 (m0) at positions [0, l_max + 1 - m0), segment 1 (m1)
// from position `seed` (seed == S: no segment 1).  Positions past both are
// dead.  The recurrence (recurrence.cuh) re-seeds at each segment's l == m,
// so every P_lm is bit-identical to the staged kernels' (legendre.cu) and
// to the plain PyTorch versions (kernels/ref.py).  Channels are 2K (re | im);
// a block takes a chunk of KM maps, i.e. the channel pairs (k, K + k), so
// that the phase rotation, which mixes re and im, stays inside the block.
//
// Rotation tables tab (n_slots, 2 segments, P planes, 4, R) f32:
//   h_re = t0 d_re + t1 d_im,  h_im = t2 d_re + t3 d_im
// (core/phase.py uniform_rotation_tables); tab == nullptr is the identity.
// With the equator fold P = 2: synthesis sums even and odd (l + m) into two
// planes and writes north = even + odd, south = even - odd; analysis takes
// north and south rows and contracts even = N + S, odd = N - S.  The
// rotation and the combine are separately rounded, as in the plain version.
//
// The packed staged kernels are the same templates with COMBINE = false and
// no tables: the even and odd planes stay apart (Q = 2 x P planes per slot,
// plane q = segment x P + parity) and nothing is rotated, so the host's
// phase stage runs after (synthesis) or before (analysis) them.  With the
// fold off a packed and a fused kernel run the same code and give the same
// bits.
//
// Every template also has its spin branch (SPIN = true, selected by non-null
// mp0/mp1 slot maps): the Wigner-d rows (m, m') of the spin-2 transforms, run
// by the reference's `_f32_step_spin` (legendre_pallas.py:116) through
// recurrence.cuh's fill_coef / rec_general.  A segment then starts at
// l0 = max(m, |m'|) (segment(), live_end()), as the spin slot layout of
// kernels/pack.py places it; the phase rotation and the channel layout are
// spin-blind.  The spin-2 plans never fold, so SPIN comes with FOLD = false
// only, and its packed kernels run the fused instantiation too.
//
// Kernels (TPU kernel each replaces; what bounds it on the H100; design):
//
//   synth_fused_vpu  replaces synth_fused_vpu, src/repro/kernels/fused.py:222.
//                    Bound by instruction issue, as anal_fused_vpu: the
//                    bit-faithful step (separately rounded operations, two
//                    rescale tests, the descale select) issues ~22 SASS
//                    instructions a triple at K 1 against the 6 float32
//                    instructions (8 operations) the flop bound counts.  One
//                    block per (128 RT-ring block, slot, chunk of <= 8
//                    maps); each thread carries RT = synth_rings(KM) rings,
//                    base + k * 128 + t, so the writes stay coalesced: 4 at
//                    KM 1 and 2, 8 / KM above, so the accumulators stay at
//                    <= 32 floats a thread and up to 8 maps share one
//                    recurrence per ring (at KM 1, 8 rings a thread issue
//                    the same instructions a triple but take 126 registers
//                    against 56, 4 blocks an SM against 9, too few warps to
//                    hide each step's dependent latency: 10% slower; 2 rings
//                    issue more a triple: 6% slower).  Per segment the block
//                    stages each 32-l tile's a rows and coefficients in
//                    shared memory; the seed and P_{m+1,m} are peeled off
//                    the l loop, full ring blocks run
//                    unguarded and the fold's two planes are a two-step
//                    unroll, so the steady step has no branch and loads its
//                    coefficients and a row once for all RT rings, whose
//                    dependent chains interleave.  Each ring's sum is the
//                    fmaf chain over ascending l from 0.0f of one ring per
//                    thread: the same bits.  Then the fold combine and the
//                    rotation run on the registers and only the rotated rows
//                    are written, (n_slots, 2, P, 2K, R): Delta never
//                    reaches HBM.
//   synth_fused_mxu  replaces synth_fused_mxu, fused.py:385.  Bound by
//                    instruction issue, as synth_fused_vpu: the
//                    bit-faithful step (~20 SASS instructions a (row, l,
//                    ring) triple) and the 2K FFMA of each triple issue far
//                    more than the float32 operations of the flop bound.
//                    One block of 256 threads per (slot, 512-ring chunk,
//                    chunk of <= 8 maps) on the mxu synthesis template of
//                    mxu_synth.cuh: per segment each thread steps a ring
//                    pair (seed and P_{m+1,m} peeled off, no guard, one
//                    table entry an l for both) and adds each value times
//                    the l's 2KM coefficients (broadcast float4 loads of
//                    rows staged 256 l at a time) into its registers: no
//                    panel, two barriers per 256 l, three blocks (24
//                    warps) an SM without the fold.  Then the fold combine
//                    and the rotation run on the registers of each ring,
//                    into (n_slots, 2, P, R, 2K).
//   anal_fused_vpu   replaces anal_fused_vpu, fused.py:526.  Bound by
//                    instruction issue: the bit-faithful step issues ~23
//                    SASS instructions a triple at K 1, of which the float32
//                    flop bound counts 6 (8 operations).  One block per
//                    (slot, 1024-ring chunk, chunk of <= 2 maps); per
//                    segment each thread rotates the FFT rows of its 8
//                    rings into Delta in registers, once.  The seed (its
//                    seeds read there and dropped) and P_{m+1,m} are peeled
//                    off the l loop, and full ring chunks run unguarded, so
//                    the steady step has no branch and loads its two
//                    coefficients once for all 8 rings, whose dependent
//                    chains interleave.  Per l each thread stores its rings'
//                    sum per channel into a shared-memory column; per 32-l
//                    tile every output sums the 128 columns in one fixed
//                    order (the vpu analysis template of recurrence.cuh,
//                    shared with anal_vpu): no per-l shuffle chain, the same
//                    bits every run.
//   anal_fused_mxu   replaces anal_fused_mxu, fused.py:666.  Bound by
//                    instruction issue and shared-memory loads: the
//                    bit-faithful step and the 2K FFMA of each triple issue
//                    far more than the float32 operations of the flop
//                    bound.  One block of 256 threads per (slot, 512-ring
//                    chunk, chunk of <= 8 maps); per segment the chunk's FFT
//                    rows are rotated and combined into Delta in shared
//                    memory once, channel-major, then the mxu analysis
//                    template of mxu_anal.cuh (shared with anal_mxu) builds
//                    each 32-l panel (16 with the fold) with a ring pair a
//                    thread, the first steps peeled and no guard, contracts
//                    it with 4 l x 8 channel register tiles fed by float4
//                    loads, and sums the ring slices by a register butterfly
//                    in one fixed order into the chunk's partial rows.
//   synth_packed_vpu replaces synth_vpu_packed,
//                    src/repro/kernels/legendre_pallas.py:591: synth_fused_vpu
//                    without combine or rotation, (n_slots, Q, 2K, R).
//   synth_packed_mxu replaces synth_mxu_packed, legendre_pallas.py:698:
//                    synth_fused_mxu without combine or rotation,
//                    (n_slots, Q, R, 2K).
//   anal_packed_vpu  replaces anal_vpu_packed, legendre_pallas.py:814:
//                    anal_fused_vpu on the parity planes as given (the same
//                    template and design, COMBINE = false, no tables).
//   anal_packed_mxu  replaces anal_mxu_packed, legendre_pallas.py:937:
//                    anal_fused_mxu on the parity planes as given.
//                    All four are bound as their fused twins (by
//                    instruction issue): the P_lm triples and
//                    the per-step code are the same, and the packed layout's
//                    point on this card, as on the TPU, is that every slot
//                    walks a near-constant 2 l_max - m_max + 2 steps, so no
//                    block idles on the triangle's short rows.
//
// bfloat16 branch (BF16 = true, the reference's bf16=True option of kernels
// 10 and 12; fused mxu kernels only, fold on or off, spin 0 and 2): the
// float32 recurrence and the float32 shared-memory panel are untouched; the
// panel entries and the coefficient rows (synthesis) or the rotated Delta
// rows (analysis) are rounded to bfloat16 (__float2bfloat16_rn) as the
// fragments are loaded, and each warp contracts them with
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 into float32
// accumulators.  A product of two bfloat16 values is exact in float32, so
// the kernels differ from their plain versions (kernels/ref.py, bf16=True)
// only in the order of the float32 sums.  The fold's even and odd (l + m)
// rows are the two halves of the N axis ([even | odd] coefficient columns in
// synthesis, [plane 0 | plane 1] Delta columns in analysis, each row taking
// the half of its parity).  Bound: the contraction at the tensor cores' bf16
// rate (989 TFLOP/s) plus the float32 recurrence at 67 TFLOP/s; one warp
// per 64-ring slice of the 512-ring chunk on 32-l panels of P in shared
// memory (the synthesis on mxu_synth.cuh's, the analysis on mxu_anal.cuh's
// panel build), fragments loaded straight from shared memory.
//
// The TPU analysis kernels add into one output block across ring blocks in
// sequential grid order (fused.py:477, :600; legendre_pallas.py:844, :955);
// CUDA blocks run in no order, so the analysis kernels write per-ring-chunk
// partials (n_slots, n_chunks, S, 2K), dead positions zero, and the
// chunk-order second pass anal_reduce (legendre.cu, its slot route: every
// stream position kept) sums them: no atomics, identical bits on every
// run.  Within a chunk each kernel sums its rings in one fixed order of its
// own (the vpu kernels: per thread in ring order, then the 128 threads'
// columns in four interleaved partial sums; the mxu analysis: per thread
// over its ring slice, then the slices by a register butterfly), which
// the plain versions' einsum over rings does not share: they agree within
// the tolerance.

#include <cstdint>

#include "mxu_anal.cuh"
#include "mxu_synth.cuh"
#include "recurrence.cuh"

namespace {

// The per-slot maps of the layout: m and (spin branch) m' per segment, and
// the stream position where segment 1 seeds (S: no segment 1).
struct SlotMaps {
  const int* m0;
  const int* m1;
  const int* mp0;   // null unless SPIN
  const int* mp1;
  const int* seed;
};

// One segment of a slot's l-stream: its m and m', first multipole lz (m, or
// max(m, |m'|) with SPIN), first stream position g0, and number of l steps
// (0 for an empty segment 1).
struct Seg {
  int m;
  int mp;
  int lz;
  int g0;
  int len;
};

template <bool SPIN>
__device__ __forceinline__ Seg segment(const SlotMaps& sm, int si, int seg,
                                       int S, int l_max) {
  const int m = seg == 0 ? sm.m0[si] : sm.m1[si];
  const int mp = SPIN ? (seg == 0 ? sm.mp0[si] : sm.mp1[si]) : 0;
  const int lz = row_start<SPIN>(m, mp);
  if (seg == 0) return {m, mp, lz, 0, l_max + 1 - lz};
  const int seed = sm.seed[si];
  return {m, mp, lz, seed, seed < S ? l_max + 1 - lz : 0};
}

// First stream position past both segments: the dead tail starts here.
template <bool SPIN>
__device__ __forceinline__ int live_end(const SlotMaps& sm, int si, int S,
                                        int l_max) {
  const Seg s1 = segment<SPIN>(sm, si, 1, S, l_max);
  return s1.len > 0 ? s1.g0 + s1.len
                    : segment<SPIN>(sm, si, 0, S, l_max).len;
}

// Global channel of local channel c of a chunk of KM maps from map k0:
// local [0, KM) are the real parts, [KM, 2KM) the imaginary parts.
template <int KM>
__device__ __forceinline__ int channel(int c, int k0, int K) {
  return c < KM ? k0 + c : K + k0 + (c - KM);
}

// (t0 re + t1 im, t2 re + t3 im), separately rounded as the plain version.
__device__ __forceinline__ void rotate(const float* __restrict__ tab,
                                       size_t row, int R, float* re,
                                       float* im) {
  const float t0 = tab[row], t1 = tab[row + R], t2 = tab[row + 2 * R],
              t3 = tab[row + 3 * R];
  const float a = *re, b = *im;
  *re = __fadd_rn(__fmul_rn(t0, a), __fmul_rn(t1, b));
  *im = __fadd_rn(__fmul_rn(t2, a), __fmul_rn(t3, b));
}

// Offset of table row (slot, seg, plane, q = 0, ring r).
__device__ __forceinline__ size_t tab_row(int si, int seg, int p, int P,
                                          int R, int r) {
  return ((static_cast<size_t>(si) * 2 + seg) * P + p) * 4 * R + r;
}

// Zero the partial rows [end, S) of the dead stream tail (a block of
// kThreads threads).
template <int KM, int kThreads = kTile>
__device__ __forceinline__ void zero_tail(float* __restrict__ part,
                                          size_t chunk_row, int end, int S,
                                          int k0, int nk, int K) {
  constexpr int CC = 2 * KM;
  for (int i = threadIdx.x; i < (S - end) * CC; i += kThreads) {
    const int g = end + i / CC, c = i % CC;
    if (c % KM < nk)
      part[(chunk_row + g) * 2 * K + channel<KM>(c, k0, K)] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// synth_fused_vpu: grid (ceil(R / (128 RT)), n_slots, ceil(K / KM)), block
// 128.  Thread t carries rings base + k * 128 + t, k < RT = synth_rings(KM),
// through the vpu synthesis template (recurrence.cuh).
// out (n_slots, 2, P, 2K, R).
// ---------------------------------------------------------------------------
template <int KM, bool FOLD, bool COMBINE, bool SPIN>
__global__ void __launch_bounds__(kTile)
synth_fused_vpu_kernel(const float* __restrict__ a_pk,
                       const SlotMaps sm,
                       const float* __restrict__ x,
                       const float* __restrict__ pmm_pk,
                       const int* __restrict__ pms_pk,
                       const float* __restrict__ tab, float* __restrict__ out,
                       int S, int K, int R, int l_max) {
  constexpr int P = FOLD ? 2 : 1;
  constexpr int CC = 2 * KM;
  constexpr int RT = synth_rings(KM);
  __shared__ __align__(16) float a_s[kLT][CC];
  __shared__ float bl_s[kLT], ratio_s[kLT], c_s[SPIN ? kLT : 1];
  const int si = blockIdx.y;
  const int base = blockIdx.x * RT * kTile;
  const int t = threadIdx.x;
  const int k0 = blockIdx.z * KM;
  const int nk = min(KM, K - k0);
  const int K2 = 2 * K;
  // ring tiles with a live ring (the tail block's tiles past ntile hold
  // none, so r < R alone tells a live ring)
  const int ntile = min(RT, (R - base + kTile - 1) / kTile);
  float xr[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int r = base + k * kTile + t;
    xr[k] = r < R ? x[r] : 0.0f;
  }

  for (int seg = 0; seg < 2; ++seg) {
    const Seg sg = segment<SPIN>(sm, si, seg, S, l_max);
    const size_t srow0 = (static_cast<size_t>(si) * 2 + seg) * R;
    const int l_end = sg.lz + sg.len;
    float acc[RT][P][CC];
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int c = 0; c < CC; ++c) acc[k][p][c] = 0.0f;
    Rec s[RT];
    for (int l0 = sg.lz; l0 < l_end; l0 += kLT) {  // block-uniform
      const int n = min(kLT, l_end - l0);
      __syncthreads();                             // previous tile consumed
#pragma unroll
      for (int i0 = 0; i0 < kLT * CC; i0 += kTile) {  // CC / 4 entries a thread
        const int i = i0 + t, j = i / CC, c = i % CC;
        if (i < kLT * CC)
          a_s[j][c] = (j < n && c % KM < nk)
              ? a_pk[(static_cast<size_t>(si) * S + sg.g0 + l0 - sg.lz + j) *
                         K2 + channel<KM>(c, k0, K)]
              : 0.0f;
      }
      fill_coef<SPIN>(l0, sg.m, sg.mp, bl_s, ratio_s, c_s);
      __syncthreads();
      // the seed and (spin 0) P_{m+1,m} peeled off the first tile
      const int j = l0 == sg.lz
          ? vpu_synth_first<RT, CC, P, SPIN>(s, xr, acc, ntile, n, sg.m,
                                             base, R, pmm_pk + srow0,
                                             pms_pk + srow0, a_s)
          : 0;
      if (ntile == RT)                             // block-uniform
        vpu_synth_steps<RT, CC, P, SPIN, true>(s, xr, acc, ntile, j, n,
                                               bl_s, ratio_s, c_s, a_s);
      else
        vpu_synth_steps<RT, CC, P, SPIN, false>(s, xr, acc, ntile, j, n,
                                                bl_s, ratio_s, c_s, a_s);
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int r = base + k * kTile + t;
      if (r >= R) continue;
      if (FOLD && COMBINE) {
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const float e = acc[k][0][c], o = acc[k][P - 1][c];
          acc[k][0][c] = e + o;                    // north
          acc[k][P - 1][c] = e - o;                // south
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int kk = 0; kk < KM; ++kk) {
          if (kk >= nk) continue;
          float re = acc[k][p][kk], im = acc[k][p][KM + kk];
          if (tab != nullptr)
            rotate(tab, tab_row(si, seg, p, P, R, r), R, &re, &im);
          const size_t o = ((static_cast<size_t>(si) * 2 + seg) * P + p) * K2;
          out[(o + k0 + kk) * R + r] = re;
          out[(o + K + k0 + kk) * R + r] = im;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// synth_fused_mxu: per segment the mxu synthesis template (mxu_synth.cuh)
// steps the chunk's rings and sums their products in registers; the
// kernel hands it the segment's coefficient rows and combines, rotates and
// writes each ring's sums.  grid (ceil(R / 512), n_slots, ceil(K / KM)),
// block kMxuThreads, dynamic shared memory and blocks an SM: MxuSynthShape.
// out (n_slots, 2, P, R, 2K).  BF16: the template's tensor-core
// contraction.
// ---------------------------------------------------------------------------
template <int KM, bool FOLD, bool COMBINE, bool SPIN, bool BF16 = false>
__global__ void __launch_bounds__(
    kMxuThreads, MxuSynthShape<2 * KM, FOLD, BF16>::MIN_BLOCKS)
synth_fused_mxu_kernel(const float* __restrict__ a_pk,
                       const SlotMaps sm,
                       const float* __restrict__ x,
                       const float* __restrict__ pmm_pk,
                       const int* __restrict__ pms_pk,
                       const float* __restrict__ tab, float* __restrict__ out,
                       int S, int K, int R, int l_max) {
  constexpr int P = FOLD ? 2 : 1;
  constexpr int CC = 2 * KM;
  extern __shared__ __align__(16) float smem[];
  const int si = blockIdx.y;
  const int base = blockIdx.x * kMxuChunk;
  const int k0 = blockIdx.z * KM;
  const int nk = min(KM, K - k0);
  const int K2 = 2 * K;
  const int t = threadIdx.x;
  float xr[kMxuRings];
#pragma unroll
  for (int k = 0; k < kMxuRings; ++k) {
    const int r = base + kMxuRings * t + k;
    xr[k] = r < R ? x[r] : 0.0f;
  }
  for (int seg = 0; seg < 2; ++seg) {
    const Seg sg = segment<SPIN>(sm, si, seg, S, l_max);
    const size_t srow = (static_cast<size_t>(si) * 2 + seg) * R;
    // stream position of multipole l: l + pos0
    const long long pos0 = static_cast<long long>(si) * S + sg.g0 - sg.lz;
    mxu_synth_row<CC, FOLD, SPIN, BF16>(
        smem, xr, min(kMxuChunk, R - base), sg.m, sg.mp, sg.lz,
        sg.lz + sg.len, pmm_pk + srow, pms_pk + srow, base, R,
        [&](int l, int c) {
          return c % KM < nk
              ? a_pk[(pos0 + l) * K2 + channel<KM>(c, k0, K)] : 0.0f;
        },
        [&](int rr, const float (&v)[P][CC]) {
          const int r = base + rr;
#pragma unroll
          for (int k = 0; k < KM; ++k) {
            if (k >= nk) continue;
            float re[P], im[P];
#pragma unroll
            for (int p = 0; p < P; ++p) {
              re[p] = v[p][k];
              im[p] = v[p][KM + k];
            }
            if (FOLD && COMBINE) {
              const float er = re[0], ei = im[0];
              re[0] = er + re[P - 1];                // north
              im[0] = ei + im[P - 1];
              re[P - 1] = er - re[P - 1];            // south
              im[P - 1] = ei - im[P - 1];
            }
#pragma unroll
            for (int p = 0; p < P; ++p) {
              if (tab != nullptr)
                rotate(tab, tab_row(si, seg, p, P, R, r), R, &re[p], &im[p]);
              const size_t o =
                  (((static_cast<size_t>(si) * 2 + seg) * P + p) * R + r) *
                  K2;
              out[o + k0 + k] = re[p];
              out[o + K + k0 + k] = im[p];
            }
          }
        });
  }
}

// ---------------------------------------------------------------------------
// anal_fused_vpu partials: part[slot][chunk][g][c] = sum over the chunk's
// rings of Delta(r) P_lm(r) at stream position g, through the vpu analysis
// template's ring reduction (recurrence.cuh).  f_pk (n_slots, 2, P, 2K, R).
// grid (n_chunks, n_slots, ceil(K / KM)), block kVpuThreads, dynamic shared
// memory (AnalVpuShape).
// ---------------------------------------------------------------------------
template <int KM, bool FOLD, bool COMBINE, bool SPIN>
__global__ void __launch_bounds__(kVpuThreads)
anal_fused_vpu_kernel(const float* __restrict__ f_pk,
                      const SlotMaps sm,
                      const float* __restrict__ x,
                      const float* __restrict__ pmm_pk,
                      const int* __restrict__ pms_pk,
                      const float* __restrict__ tab, float* __restrict__ part,
                      int S, int K, int R, int l_max) {
  using Sh = AnalVpuShape<2 * KM>;
  constexpr int P = FOLD ? 2 : 1;
  constexpr int CC = Sh::CC, H = Sh::H;
  constexpr int RT = kVpuRings;
  extern __shared__ __align__(16) float smem[];
  float* red_s = smem;                                 // [O][kStride]
  float* t0 = red_s + Sh::O * Sh::kStride;             // [kLT] x 3
  float* t1 = t0 + kLT;
  float* t2 = t1 + kLT;
  const int si = blockIdx.y;
  const int chunk = blockIdx.x;
  const int base = chunk * RT * kVpuThreads;
  const int k0 = blockIdx.z * KM;
  const int nk = min(KM, K - k0);
  const int K2 = 2 * K;
  const int t = threadIdx.x;
  const int ntile = min(RT, (R - base + kVpuThreads - 1) / kVpuThreads);
  const size_t chunk_row = (static_cast<size_t>(si) * gridDim.x + chunk) * S;
  // the output this thread reduces at the end of a tile: (j, c) = o, h-th
  // of its H threads
  const int o = t / H, h = t % H;

  float xr[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int r = base + k * kVpuThreads + t;
    xr[k] = (k < ntile && r < R) ? x[r] : 0.0f;
  }
  for (int seg = 0; seg < 2; ++seg) {
    const Seg sg = segment<SPIN>(sm, si, seg, S, l_max);
    if (sg.len == 0) continue;                     // block-uniform
    const int l_end = sg.lz + sg.len;
    const size_t srow0 = (static_cast<size_t>(si) * 2 + seg) * R;
    float d[RT][P][CC];                            // rotated Delta, planes
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int r = base + k * kVpuThreads + t;
      const bool live = k < ntile && r < R;
      float re[P][KM], im[P][KM];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const size_t ofs = ((static_cast<size_t>(si) * 2 + seg) * P + p) * K2;
#pragma unroll
        for (int c = 0; c < KM; ++c) {
          const bool ok = live && c < nk;
          re[p][c] = ok ? f_pk[(ofs + k0 + c) * R + r] : 0.0f;
          im[p][c] = ok ? f_pk[(ofs + K + k0 + c) * R + r] : 0.0f;
          if (ok && tab != nullptr)
            rotate(tab, tab_row(si, seg, p, P, R, r), R, &re[p][c], &im[p][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < KM; ++c) {
        if (FOLD && COMBINE) {
          d[k][0][c] = re[0][c] + re[P - 1][c];     // even = N + S
          d[k][0][KM + c] = im[0][c] + im[P - 1][c];
          d[k][P - 1][c] = re[0][c] - re[P - 1][c]; // odd = N - S
          d[k][P - 1][KM + c] = im[0][c] - im[P - 1][c];
        } else {                                   // planes as given
#pragma unroll
          for (int p = 0; p < P; ++p) {
            d[k][p][c] = re[p][c];
            d[k][p][KM + c] = im[p][c];
          }
        }
      }
    }

    Rec s[RT];
    for (int l0 = sg.lz; l0 < l_end; l0 += kLT) {  // block-uniform
      const int n = min(kLT, l_end - l0);
      fill_coef<SPIN>(l0, sg.m, sg.mp, t0, t1, t2);
      __syncthreads();
      // the seed and (spin 0) P_{m+1,m} peeled off the first tile
      const int j = l0 == sg.lz
          ? vpu_anal_first<CC, P, SPIN>(s, xr, d, ntile, n, sg.m, base, R,
                                        pmm_pk + srow0, pms_pk + srow0,
                                        red_s)
          : 0;
      if (ntile == RT)                             // block-uniform
        vpu_anal_steps<CC, P, SPIN, true>(s, xr, d, ntile, j, n, t0, t1, t2,
                                          red_s);
      else
        vpu_anal_steps<CC, P, SPIN, false>(s, xr, d, ntile, j, n, t0, t1,
                                           t2, red_s);
      __syncthreads();
      // every output sums its kVpuThreads columns in one fixed order
      const float total = vpu_column_sum<CC>(red_s + o * Sh::kStride + h);
      const int jo = o / CC, c = o % CC;
      if (h == 0 && jo < n && c % KM < nk)
        part[(chunk_row + sg.g0 + l0 - sg.lz + jo) * K2 +
             channel<KM>(c, k0, K)] = total;
    }
  }
  zero_tail<KM, kVpuThreads>(part, chunk_row,
                             live_end<SPIN>(sm, si, S, l_max), S, k0, nk, K);
}

// ---------------------------------------------------------------------------
// anal_fused_mxu partials: per segment the block rotates the chunk's FFT
// rows into Delta once, combines the fold's planes, stores them
// channel-major in shared memory and runs the mxu analysis template
// (mxu_anal.cuh) on the segment's row.  f_pk (n_slots, 2, P, R, 2K).
// grid (n_chunks, n_slots, ceil(K / KM)), block kMxuThreads, dynamic
// shared memory (MxuAnalShape).  BF16: the template's tensor-core
// contraction.
// ---------------------------------------------------------------------------
template <int KM, bool FOLD, bool COMBINE, bool SPIN, bool BF16 = false>
__global__ void __launch_bounds__(kMxuThreads, kMxuBlocksPerSm)
anal_fused_mxu_kernel(const float* __restrict__ f_pk,
                      const SlotMaps sm,
                      const float* __restrict__ x,
                      const float* __restrict__ pmm_pk,
                      const int* __restrict__ pms_pk,
                      const float* __restrict__ tab, float* __restrict__ part,
                      int S, int K, int R, int l_max) {
  using Sh = MxuAnalShape<2 * KM, FOLD, BF16>;
  constexpr int P = Sh::P, CC = Sh::CC, DS = Sh::DS;
  extern __shared__ __align__(16) float smem[];   // d_s first
  const int si = blockIdx.y;
  const int chunk = blockIdx.x;
  const int base = chunk * kMxuChunk;
  const int k0 = blockIdx.z * KM;
  const int nk = min(KM, K - k0);
  const int K2 = 2 * K;
  const int t = threadIdx.x;
  const size_t chunk_row = (static_cast<size_t>(si) * gridDim.x + chunk) * S;

  float xr[kMxuRings];
#pragma unroll
  for (int k = 0; k < kMxuRings; ++k) {
    const int r = base + kMxuRings * t + k;
    xr[k] = r < R ? x[r] : 0.0f;
  }
  for (int seg = 0; seg < 2; ++seg) {
    const Seg sg = segment<SPIN>(sm, si, seg, S, l_max);
    if (sg.len == 0) continue;                     // block-uniform
    // rotate the chunk's FFT rows into Delta once, combine the planes (the
    // previous segment's last barrier let go of d_s)
    for (int rr = t; rr < kMxuChunk; rr += kMxuThreads) {
      const int r = base + rr;
      for (int c = 0; c < KM; ++c) {
        float re[P], im[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const bool ok = r < R && c < nk;
          const size_t o =
              (((static_cast<size_t>(si) * 2 + seg) * P + p) * R + r) * K2;
          re[p] = ok ? f_pk[o + k0 + c] : 0.0f;
          im[p] = ok ? f_pk[o + K + k0 + c] : 0.0f;
          if (ok && tab != nullptr)
            rotate(tab, tab_row(si, seg, p, P, R, r), R, &re[p], &im[p]);
        }
        float* d = smem + rr;
        if (FOLD && COMBINE) {
          d[c * DS] = re[0] + re[P - 1];                 // even = N + S
          d[(KM + c) * DS] = im[0] + im[P - 1];
          d[(CC + c) * DS] = re[0] - re[P - 1];          // odd = N - S
          d[(CC + KM + c) * DS] = im[0] - im[P - 1];
        } else {                                         // planes as given
#pragma unroll
          for (int p = 0; p < P; ++p) {
            d[(p * CC + c) * DS] = re[p];
            d[(p * CC + KM + c) * DS] = im[p];
          }
        }
      }
    }
    const size_t srow = (static_cast<size_t>(si) * 2 + seg) * R;
    // stream position of multipole l: l + pos0
    const long long pos0 =
        static_cast<long long>(chunk_row) + sg.g0 - sg.lz;
    mxu_anal_row<CC, FOLD, SPIN, BF16>(
        smem, xr, min(kMxuChunk, R - base), sg.m, sg.mp, sg.lz,
        sg.lz + sg.len, pmm_pk + srow, pms_pk + srow, base, R,
        [&](int l, int c, float v) {
          if (c % KM < nk)
            part[(pos0 + l) * K2 + channel<KM>(c, k0, K)] = v;
        });
  }
  zero_tail<KM, kMxuThreads>(part, chunk_row,
                             live_end<SPIN>(sm, si, S, l_max), S, k0, nk, K);
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------
struct FusedArgs {
  const float* in; SlotMaps sm; const float* x; const float* pmm;
  const int* pms; const float* tab; float* out; int n_slots; int S; int K;
  int R; int l_max; int n_chunks; cudaStream_t stream;
};

// The map-chunk template for km (a power of two up to kMax), the fold, the
// fused combine and the spin branch.  Without the fold the combine does
// nothing, so the packed kernels then run the fused instantiation itself;
// the spin branch runs with the fold off only.
template <template <int, bool, bool, bool> class Launch, int KM>
int dispatch_fold(int fold, int combine, const FusedArgs& g) {
  if (g.sm.mp0 != nullptr)
    return fold ? static_cast<int>(cudaErrorInvalidValue)
                : Launch<KM, false, true, true>::run(g);
  if (!fold) return Launch<KM, false, true, false>::run(g);
  return combine ? Launch<KM, true, true, false>::run(g)
                 : Launch<KM, true, false, false>::run(g);
}

template <template <int, bool, bool, bool> class Launch, int kMax>
int dispatch_maps(int km, int fold, int combine, const FusedArgs& g) {
  switch (km) {
    case 1: return dispatch_fold<Launch, 1>(fold, combine, g);
    case 2: return dispatch_fold<Launch, 2>(fold, combine, g);
    case 4:
      if constexpr (kMax >= 4)
        return dispatch_fold<Launch, 4>(fold, combine, g);
      break;
    case 8:
      if constexpr (kMax >= 8)
        return dispatch_fold<Launch, 8>(fold, combine, g);
      break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int KM, bool FOLD, bool COMBINE, bool SPIN>
struct LaunchSynthVpu {
  static int run(const FusedArgs& g) {
    constexpr int kRings = synth_rings(KM) * kTile;
    dim3 grid((g.R + kRings - 1) / kRings, g.n_slots, (g.K + KM - 1) / KM);
    synth_fused_vpu_kernel<KM, FOLD, COMBINE, SPIN>
        <<<grid, kTile, 0, g.stream>>>(g.in, g.sm, g.x, g.pmm, g.pms, g.tab,
                                       g.out, g.S, g.K, g.R, g.l_max);
    return static_cast<int>(cudaGetLastError());
  }
};

// Kernel 10 (6 with COMBINE = false) in float32 or bfloat16.
template <int KM, bool FOLD, bool COMBINE, bool SPIN, bool BF16>
int launch_synth_mxu(const FusedArgs& g) {
  using Sh = MxuSynthShape<2 * KM, FOLD, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      synth_fused_mxu_kernel<KM, FOLD, COMBINE, SPIN, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sh::smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((g.R + kMxuChunk - 1) / kMxuChunk, g.n_slots,
            (g.K + KM - 1) / KM);
  synth_fused_mxu_kernel<KM, FOLD, COMBINE, SPIN, BF16>
      <<<grid, kMxuThreads, Sh::smem_bytes, g.stream>>>(
          g.in, g.sm, g.x, g.pmm, g.pms, g.tab, g.out, g.S, g.K, g.R,
          g.l_max);
  return static_cast<int>(cudaGetLastError());
}

template <int KM, bool FOLD, bool COMBINE, bool SPIN>
struct LaunchSynthMxu {
  static int run(const FusedArgs& g) {
    return launch_synth_mxu<KM, FOLD, COMBINE, SPIN, false>(g);
  }
};

template <int KM, bool FOLD, bool COMBINE, bool SPIN>
struct LaunchSynthMxuBf16 {
  static int run(const FusedArgs& g) {
    return launch_synth_mxu<KM, FOLD, COMBINE, SPIN, true>(g);
  }
};

template <int KM, bool FOLD, bool COMBINE, bool SPIN>
struct LaunchAnalVpu {
  static int run(const FusedArgs& g) {
    using Sh = AnalVpuShape<2 * KM>;
    cudaError_t err = cudaFuncSetAttribute(
        anal_fused_vpu_kernel<KM, FOLD, COMBINE, SPIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Sh::smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(g.n_chunks, g.n_slots, (g.K + KM - 1) / KM);
    anal_fused_vpu_kernel<KM, FOLD, COMBINE, SPIN>
        <<<grid, kVpuThreads, Sh::smem_bytes, g.stream>>>(
            g.in, g.sm, g.x, g.pmm, g.pms, g.tab, g.out, g.S, g.K, g.R,
            g.l_max);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int KM, bool FOLD, bool COMBINE, bool SPIN>
struct LaunchAnalMxu {
  static int run(const FusedArgs& g) {
    using Sh = MxuAnalShape<2 * KM, FOLD, false>;
    cudaError_t err = cudaFuncSetAttribute(
        anal_fused_mxu_kernel<KM, FOLD, COMBINE, SPIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Sh::smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(g.n_chunks, g.n_slots, (g.K + KM - 1) / KM);
    anal_fused_mxu_kernel<KM, FOLD, COMBINE, SPIN>
        <<<grid, kMxuThreads, Sh::smem_bytes, g.stream>>>(
            g.in, g.sm, g.x, g.pmm, g.pms, g.tab, g.out, g.S, g.K, g.R,
            g.l_max);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int KM, bool FOLD, bool COMBINE, bool SPIN>
struct LaunchAnalMxuBf16 {
  static int run(const FusedArgs& g) {
    using Sh = MxuAnalShape<2 * KM, FOLD, true>;
    cudaError_t err = cudaFuncSetAttribute(
        anal_fused_mxu_kernel<KM, FOLD, COMBINE, SPIN, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Sh::smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(g.n_chunks, g.n_slots, (g.K + KM - 1) / KM);
    anal_fused_mxu_kernel<KM, FOLD, COMBINE, SPIN, true>
        <<<grid, kMxuThreads, Sh::smem_bytes, g.stream>>>(
            g.in, g.sm, g.x, g.pmm, g.pms, g.tab, g.out, g.S, g.K, g.R,
            g.l_max);
    return static_cast<int>(cudaGetLastError());
  }
};

// A bad operand set: tables on a packed kernel (combine = 0), or only one
// of mp0 / mp1 (both null: spin 0; both given: the spin branch).
inline bool bad_operands(const SlotMaps& sm, const float* tab, int combine) {
  return (!combine && tab != nullptr) ||
         ((sm.mp0 == nullptr) != (sm.mp1 == nullptr));
}

// One synthesis launch; combine = 0 is a packed kernel (no tables).
template <template <int, bool, bool, bool> class Launch>
int synth_entry(const float* a_pk, const SlotMaps& sm, const float* x,
                const float* pmm, const int* pms, const float* tab,
                float* out, int n_slots, int S, int K, int R, int l_max,
                int fold, int combine, void* stream) {
  if (bad_operands(sm, tab, combine))
    return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs g{a_pk, sm, x, pmm, pms, tab, out, n_slots, S, K, R, l_max, 0,
              static_cast<cudaStream_t>(stream)};
  return dispatch_maps<Launch, 8>(chunk_for(K, 8, 1), fold, combine, g);
}

// One analysis partials launch; kMax caps the map chunk, tiles sizes the
// ring chunk the caller's buffer must match.
template <template <int, bool, bool, bool> class Launch, int kMax, int tiles>
int anal_entry(const float* f_pk, const SlotMaps& sm, const float* x,
               const float* pmm, const int* pms, const float* tab,
               float* part, int n_slots, int S, int K, int R, int l_max,
               int n_chunks, int fold, int combine, void* stream) {
  if (n_chunks != chunks_of(R, tiles) || bad_operands(sm, tab, combine))
    return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs g{f_pk, sm, x, pmm, pms, tab, part, n_slots, S, K, R, l_max,
              n_chunks, static_cast<cudaStream_t>(stream)};
  return dispatch_maps<Launch, kMax>(chunk_for(K, kMax, 1), fold, combine, g);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface.  Pointers are device pointers of contiguous tensors
// (tab may be null: identity tables); every function launches on `stream`
// and returns cudaGetLastError().  m0/m1/mp0/mp1/seed are the per-slot maps;
// mp0 and mp1 are null for the scalar rows and given for the spin branch.
// ---------------------------------------------------------------------------
extern "C" {

int fused_synth_vpu(const float* a_pk, const int* m0, const int* m1,
                    const int* mp0, const int* mp1, const int* seed,
                    const float* x, const float* pmm, const int* pms,
                    const float* tab, float* out, int n_slots, int S, int K,
                    int R, int l_max, int fold, void* stream) {
  return synth_entry<LaunchSynthVpu>(a_pk, {m0, m1, mp0, mp1, seed}, x, pmm,
                                     pms, tab, out, n_slots, S, K, R, l_max,
                                     fold, 1, stream);
}

int fused_synth_mxu(const float* a_pk, const int* m0, const int* m1,
                    const int* mp0, const int* mp1, const int* seed,
                    const float* x, const float* pmm, const int* pms,
                    const float* tab, float* out, int n_slots, int S, int K,
                    int R, int l_max, int fold, void* stream) {
  return synth_entry<LaunchSynthMxu>(a_pk, {m0, m1, mp0, mp1, seed}, x, pmm,
                                     pms, tab, out, n_slots, S, K, R, l_max,
                                     fold, 1, stream);
}

int fused_anal_vpu(const float* f_pk, const int* m0, const int* m1,
                   const int* mp0, const int* mp1, const int* seed,
                   const float* x, const float* pmm, const int* pms,
                   const float* tab, float* part, int n_slots, int S, int K,
                   int R, int l_max, int n_chunks, int fold, void* stream) {
  return anal_entry<LaunchAnalVpu, 2, kVpuAnalTiles>(
      f_pk, {m0, m1, mp0, mp1, seed}, x, pmm, pms, tab, part, n_slots, S, K,
      R, l_max, n_chunks, fold, 1, stream);
}

int fused_anal_mxu(const float* f_pk, const int* m0, const int* m1,
                   const int* mp0, const int* mp1, const int* seed,
                   const float* x, const float* pmm, const int* pms,
                   const float* tab, float* part, int n_slots, int S, int K,
                   int R, int l_max, int n_chunks, int fold, void* stream) {
  return anal_entry<LaunchAnalMxu, 8, kMxuAnalTiles>(
      f_pk, {m0, m1, mp0, mp1, seed}, x, pmm, pms, tab, part, n_slots, S, K,
      R, l_max, n_chunks, fold, 1, stream);
}

// The bfloat16 branch of the fused mxu kernels (tensor-core contraction).
int fused_synth_mxu_bf16(const float* a_pk, const int* m0, const int* m1,
                         const int* mp0, const int* mp1, const int* seed,
                         const float* x, const float* pmm, const int* pms,
                         const float* tab, float* out, int n_slots, int S,
                         int K, int R, int l_max, int fold, void* stream) {
  return synth_entry<LaunchSynthMxuBf16>(a_pk, {m0, m1, mp0, mp1, seed}, x,
                                         pmm, pms, tab, out, n_slots, S, K, R,
                                         l_max, fold, 1, stream);
}

int fused_anal_mxu_bf16(const float* f_pk, const int* m0, const int* m1,
                        const int* mp0, const int* mp1, const int* seed,
                        const float* x, const float* pmm, const int* pms,
                        const float* tab, float* part, int n_slots, int S,
                        int K, int R, int l_max, int n_chunks, int fold,
                        void* stream) {
  return anal_entry<LaunchAnalMxuBf16, 8, kMxuAnalTiles>(
      f_pk, {m0, m1, mp0, mp1, seed}, x, pmm, pms, tab, part, n_slots, S, K,
      R, l_max, n_chunks, fold, 1, stream);
}

// The packed staged kernels: no tables, planes kept apart.
int packed_synth_vpu(const float* a_pk, const int* m0, const int* m1,
                     const int* mp0, const int* mp1, const int* seed,
                     const float* x, const float* pmm, const int* pms,
                     float* out, int n_slots, int S, int K, int R, int l_max,
                     int fold, void* stream) {
  return synth_entry<LaunchSynthVpu>(a_pk, {m0, m1, mp0, mp1, seed}, x, pmm,
                                     pms, nullptr, out, n_slots, S, K, R,
                                     l_max, fold, 0, stream);
}

int packed_synth_mxu(const float* a_pk, const int* m0, const int* m1,
                     const int* mp0, const int* mp1, const int* seed,
                     const float* x, const float* pmm, const int* pms,
                     float* out, int n_slots, int S, int K, int R, int l_max,
                     int fold, void* stream) {
  return synth_entry<LaunchSynthMxu>(a_pk, {m0, m1, mp0, mp1, seed}, x, pmm,
                                     pms, nullptr, out, n_slots, S, K, R,
                                     l_max, fold, 0, stream);
}

int packed_anal_vpu(const float* dw_pk, const int* m0, const int* m1,
                    const int* mp0, const int* mp1, const int* seed,
                    const float* x, const float* pmm, const int* pms,
                    float* part, int n_slots, int S, int K, int R, int l_max,
                    int n_chunks, int fold, void* stream) {
  return anal_entry<LaunchAnalVpu, 2, kVpuAnalTiles>(
      dw_pk, {m0, m1, mp0, mp1, seed}, x, pmm, pms, nullptr, part, n_slots, S,
      K, R, l_max, n_chunks, fold, 0, stream);
}

int packed_anal_mxu(const float* dw_pk, const int* m0, const int* m1,
                    const int* mp0, const int* mp1, const int* seed,
                    const float* x, const float* pmm, const int* pms,
                    float* part, int n_slots, int S, int K, int R, int l_max,
                    int n_chunks, int fold, void* stream) {
  return anal_entry<LaunchAnalMxu, 8, kMxuAnalTiles>(
      dw_pk, {m0, m1, mp0, mp1, seed}, x, pmm, pms, nullptr, part, n_slots, S,
      K, R, l_max, n_chunks, fold, 0, stream);
}

}  // extern "C"
