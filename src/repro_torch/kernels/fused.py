"""Fused Legendre+phase pipeline: host side of the fused kernels.

Counterpart of ``repro.kernels.fused``, uniform phase stage, spin 0 and
2.  The staged pipeline writes Delta_m(r) to device memory between the
Legendre kernel and the phase stage; the fused kernels keep it on chip:

* synthesis: per slot of a ``kernels.pack`` layout, the kernel sums the
  recurrence against the packed coefficient streams, combines the fold
  planes (north = even + odd, south = even - odd) and rotates each
  segment's rows by its per-(row, ring) phase table
  (``core.phase.uniform_rotation_tables``: e^{+i m phi0} with the
  conjugate-wrap and Nyquist handling baked in).  Its only output is the
  rotated spectrum rows, which the host scatters into the half spectrum
  and inverse-FFTs.
* analysis: the host FFTs the weighted maps and gathers each row's bin;
  the kernel rotates those rows into Delta once per (slot, ring chunk) and
  contracts them against the recurrence.  Only packed a_lm l-streams leave
  it.

On a CPU tensor the kernels' plain versions (``kernels.ref``) run, on a
CUDA tensor the CUDA kernels (``kernels.fused_cuda``).  ``fused_synth`` and
``fused_anal`` are differentiable through their adjoints, the chains of
the other direction (``core.autodiff.linear_pair``): the transpose of the
synthesis chain is fac_m times the analysis chain, and the reverse, as in
the reference.

Spin 2 (``mp_vals`` the stacked [m' = -2 | m' = +2] rows of
``ops.spin_rows``, fold off): the kernels run their spin branch on the 2M
lambda^{+-} rows; the synthesis epilogue unpacks Delta^{+-} into the Q|U
channels (``core.legendre.spin_unpack_delta``) before the bins, which come
from the first M rows (both halves share one m), and the analysis packs
the gathered Q|U bins into Delta^{+-} rows (``spin_pack_delta``).  The
pair packing adds a net 1/2 to the synthesis adjoint (``bsc``) and 2 to
the analysis adjoint.

Ragged grids (``fused_synth_bucket`` / ``fused_anal_bucket``): the tables
are one plane of ``core.phase.bucket_rotation_tables`` (e^{+-i m phi0}
only), and the bucket engine's alias-fold scatter and bin gather
(``core.phase.bucket_scatter`` / ``bucket_gather``, one FFT per bucket)
run around the kernels in place of the half-spectrum scatter and gather.

``bf16=True`` (the mxu variant only, as in the reference) rounds the
recurrence panel and the coefficient rows (synthesis) or the rotated Delta
rows (analysis) to bfloat16 and contracts them on the tensor cores with
float32 accumulation; the recurrence stays float32.  The vpu variant has
no bfloat16 contraction: the reference ignores ``bf16`` there, the port
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import legendre, phase
from repro_torch.core.autodiff import linear_pair
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = ["fused_synth", "fused_anal", "fused_synth_bucket",
           "fused_anal_bucket", "FUSED_LP_SIZE"]

#: the packed layout's panel length: the reference planner's choice at both
#: sht_cmb shapes, shared with the packed staged layout.  The CUDA kernels
#: walk each segment in 32-l tiles, so on the GPU a second value would only
#: round the stream length S up: the reference's panel-length autotune
#: (``_fused_lp_size``) is not ported (see ROADMAP.md).
FUSED_LP_SIZE = kops.PACK_LP_SIZE


def _tables_identity(tabs) -> bool:
    """True iff the (host-side) rotation tables are exactly the identity on
    every plane and ring -- any uniform grid with phi0 == 0 (the
    Gauss-Legendre default).  The kernels of both variants then skip the
    tables; ``1*re + 0*im == re`` exactly in float32, so the skip changes
    no bit.  Fold tables with an odd ring count never qualify: their south
    plane zeroes the equator row, which has no mirror, and that masking
    must stay."""
    t = np.asarray(tabs)
    return bool(np.all(t[:, :, 0] == 1.0) and np.all(t[:, :, 3] == 1.0)
                and np.all(t[:, :, 1] == 0.0) and np.all(t[:, :, 2] == 0.0))


def _rotation_tables(m_vals, direction, *, phase_kind, n, phi0, fold_rings,
                     n_half):
    """(M, n_pl, 4, R_kernel) f64 tables.

    Uniform unfolded: one plane of ``uniform_rotation_tables``.  Fold:
    north plane = rings [0, nh), south plane row i = full-grid ring R-1-i
    (the staged combine's reversal baked into the table order); rows past
    the southern count stay zero, since the odd-R equator has no mirror.
    Bucket: one plane of ``bucket_rotation_tables``; the alias fold is the
    host-side scatter and gather."""
    if phase_kind == "bucket":
        return phase.bucket_rotation_tables(m_vals, phi0, direction)[:, None]
    if phase_kind != "uniform":
        raise ValueError(f"unknown phase kind {phase_kind!r}")
    full = phase.uniform_rotation_tables(m_vals, phi0, n, direction)
    if fold_rings is None:
        return full[:, None]
    nh = n_half
    ns = fold_rings - nh
    north = full[:, :, :nh]
    south = np.zeros_like(north)
    south[:, :, :ns] = full[:, :, nh:][:, :, ::-1]
    return np.stack([north, south], axis=1)


def _pack_tables(tabs, lo, device, store=None):
    """(M, n_pl, 4, R) f64 tables -> (n_slots, 2, n_pl, 4, R) f32."""
    t = torch.as_tensor(np.asarray(tabs, np.float32), device=device)
    return kops._pack_rows(t, lo, cache=store).contiguous()


def _tables(store, direction, m_vals, lo, device, *, phase_kind, n, phi0,
            fold_rings, n_half):
    """Packed rotation tables for ``direction``, or None where they are the
    identity and the kernels skip them."""
    def build():
        tabs = _rotation_tables(m_vals, direction, phase_kind=phase_kind,
                                n=n, phi0=phi0, fold_rings=fold_rings,
                                n_half=n_half)
        if _tables_identity(tabs):
            return None
        return _pack_tables(tabs, lo, device, store)
    return kops._stored(store, ("tables", direction), build)


def _kernel_synth(a, tab_pk, prep, *, l_max, var, bf16, lo, fold, store):
    """Packed fused kernel leg: a (Mr, L1, 2K) -> rotated per-plane rows
    h (Mr, n_pl, R, 2K); the spin branch on a spin layout."""
    maps, x, pmm_pk, pms_pk = prep
    Mr, K2 = a.shape[0], a.shape[-1]
    R = x.shape[0]
    a_pk = kops._pack_a(a.to(torch.float32), lo, cache=store).contiguous()
    if kops._route(a.device) == "cpu":
        out = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, tab_pk,
                                   l_max=l_max, fold=fold, layout=var,
                                   spin=lo.spin, bf16=bf16)
    else:
        from repro_torch.kernels import fused_cuda
        kernel = getattr(fused_cuda, f"synth_fused_{var}")
        out = kernel(a_pk, maps, x, pmm_pk, pms_pk, tab_pk, l_max=l_max,
                     fold=fold, spin=lo.spin,
                     **({"bf16": bf16} if var == "mxu" else {}))
    if var == "vpu":
        out = out.movedim(3, -1)              # (n_slots, 2, n_pl, R, 2K)
    seg = out.reshape(lo.n_slots * 2, 2 if fold else 1, R, K2)
    return kops._unpack_rows(seg, lo, Mr, cache=store)


def _kernel_anal(fp, tab_pk, prep, *, l_max, var, bf16, lo, store):
    """Packed fused kernel leg: per-plane unrotated rows fp (Mr, n_pl, R,
    2K) -> a (Mr, l_max + 1, 2K)."""
    maps, x, pmm_pk, pms_pk = prep
    f_pk = kops._pack_rows(fp, lo, cache=store)   # (n_slots, 2, n_pl, R, 2K)
    if var == "vpu":
        f_pk = f_pk.movedim(-1, 3)            # (n_slots, 2, n_pl, 2K, R)
    f_pk = f_pk.contiguous()
    if kops._route(fp.device) == "cpu":
        out = kref.anal_fused_ref(f_pk, maps, x, pmm_pk, pms_pk, tab_pk,
                                  l_max=l_max, s_len=lo.S, layout=var,
                                  spin=lo.spin, bf16=bf16)
    else:
        from repro_torch.kernels import fused_cuda
        kernel = getattr(fused_cuda, f"anal_fused_{var}")
        out = kernel(f_pk, maps, x, pmm_pk, pms_pk, tab_pk, l_max=l_max,
                     s_len=lo.S, spin=lo.spin,
                     **({"bf16": bf16} if var == "mxu" else {}))
    return kops._unpack_alm(out, lo, cache=store)


def _synth_chain(a, m_vals, x, pmm, pms, *, l_max, var, bf16, lo, store,
                 phase_kind="uniform", n=None, phi0=None, fold_rings=None,
                 bucket=None):
    """Weight-free fused synthesis: a (Mr, L1, 2K) f32 -> maps (R, n, C)
    (uniform; (R, width, C) on a bucketed grid).  ``Mr`` is the kernel row
    count: M, or the 2M lambda^{+-} rows of a spin layout, whose Q|U maps
    come out as C = 2K channels (else C = K)."""
    prep = kops._prep(lo, x, pmm, pms, store)
    nh = prep[1].shape[0]
    tab = _tables(store, "synth", m_vals, lo, a.device, phase_kind=phase_kind,
                  n=n, phi0=phi0, fold_rings=fold_rings, n_half=nh)
    h = _kernel_synth(a, tab, prep, l_max=l_max, var=var, bf16=bf16, lo=lo,
                      fold=fold_rings is not None, store=store)
    if fold_rings is not None:
        # the kernel's combine produced (north | south) planes; the south
        # rows come out in fold order (equator-out): reverse and trim
        ns = fold_rings - nh
        flat = torch.cat([h[:, 0], h[:, 1, :ns].flip(1)], dim=1)
    else:
        flat = h[:, 0]                        # (Mr, R, 2K)
    K = flat.shape[-1] // 2
    mv = np.asarray(m_vals)
    if lo.spin:
        dq_re, dq_im, du_re, du_im = legendre.spin_unpack_delta(
            flat[..., :K], flat[..., K:])
        hc = torch.cat([torch.complex(dq_re, dq_im),
                        torch.complex(du_re, du_im)], dim=-1)  # (M, R, 2K)
        mv = mv[:mv.shape[0] // 2]
    else:
        hc = torch.complex(flat[..., :K], flat[..., K:])    # (M, R, K)
    if phase_kind == "bucket":
        return phase.bucket_scatter(hc, bucket)
    bins, _, _ = phase.uniform_bin_maps(mv, n)
    H = torch.zeros((n // 2 + 1,) + tuple(hc.shape[1:]), dtype=hc.dtype,
                    device=hc.device)
    H.index_add_(0, torch.as_tensor(bins, device=hc.device), hc)
    return torch.fft.irfft(H.movedim(0, 1), n=n, dim=1) * n


def _anal_rows(maps_w, m_vals, *, n, fold_rings, n_half, spin=False,
               bucket=None):
    """The analysis kernels' input: ring-weighted maps (R, n, C) f32 ->
    gathered, unrotated FFT rows (Mr, n_pl, R_kernel, 2K) f32, with the
    fold as north rings and reversed south rings (zero past the southern
    count).  With ``spin`` the C = 2K channels are Q|U and ``m_vals`` the
    2M spin rows: the bins of the first M rows are packed into the
    Delta^{+-} rows (Mr = 2M); else C = K and Mr = M.  With ``bucket`` (a
    ``core.phase.BucketIndex``) the bins come from the bucket FFTs."""
    dev = maps_w.device
    mv = np.asarray(m_vals)
    mv = mv[:mv.shape[0] // 2] if spin else mv
    if bucket is not None:
        Fm = phase.bucket_gather(maps_w, bucket)            # (M, R, C)
    else:
        F = torch.fft.rfft(maps_w, dim=1)                   # (R, half, C)
        bins, _, _ = phase.uniform_bin_maps(mv, n)
        Fm = F[:, torch.as_tensor(bins, device=dev)].movedim(1, 0)
    if spin:
        K = Fm.shape[-1] // 2
        f_re, f_im = legendre.spin_pack_delta(
            Fm[..., :K].real, Fm[..., :K].imag, Fm[..., K:].real,
            Fm[..., K:].imag)
        f = torch.cat([f_re, f_im], dim=-1)                 # (2M, R, 2K)
    else:
        f = torch.cat([Fm.real, Fm.imag], dim=-1)           # (M, R, 2K)
    if fold_rings is None:
        return f[:, None]                     # (M, 1, R, 2K)
    nh, ns = n_half, fold_rings - n_half
    f_n = f[:, :nh]
    f_s = torch.zeros_like(f_n)
    f_s[:, :ns] = f[:, nh:].flip(1)
    return torch.stack([f_n, f_s], dim=1)     # (M, 2, nh, 2K)


def _anal_chain(maps_w, m_vals, x, pmm, pms, *, l_max, var, bf16, lo,
                store, phase_kind="uniform", n=None, phi0=None,
                fold_rings=None, bucket=None):
    """Weight-free fused analysis core: ring-weighted maps (R, n, C) f32
    -> a (Mr, l_max + 1, 2K) f32 (rows and channels as
    :func:`_synth_chain`)."""
    prep = kops._prep(lo, x, pmm, pms, store)
    nh = prep[1].shape[0]
    fp = _anal_rows(maps_w, m_vals, n=n, fold_rings=fold_rings, n_half=nh,
                    spin=lo.spin, bucket=bucket)
    tab = _tables(store, "anal", m_vals, lo, maps_w.device,
                  phase_kind=phase_kind, n=n, phi0=phi0,
                  fold_rings=fold_rings, n_half=nh)
    return _kernel_anal(fp, tab, prep, l_max=l_max, var=var, bf16=bf16,
                        lo=lo, store=store)


def _resolve(m_vals, l_max, lo, mp_vals, bf16, fold_rings, variant="vpu"):
    """The slot layout of the rows (the spin layout with ``mp_vals``),
    checked against the request."""
    if bf16 and variant != "mxu":
        raise ValueError(
            f"the {variant} variant has no bfloat16 contraction: bf16=True "
            "applies to the mxu variant (panel contractions on the tensor "
            "cores) only")
    if mp_vals is not None and fold_rings is not None:
        raise ValueError("fold is not supported for spin transforms")
    if lo is None:
        lo = kops._resolve_layout(np.asarray(m_vals), "packed", l_max,
                                  mp_vals=mp_vals)
    if lo.spin != (mp_vals is not None):
        raise ValueError(f"layout spin={lo.spin} does not match mp_vals "
                         f"{'given' if mp_vals is not None else 'absent'}")
    return lo


def _fac(m_vals, device):
    """(M, 1, 1) f32 spectral factors, 1 for m == 0 else 2
    (``core.phase._fac_rows``)."""
    return torch.as_tensor(phase._fac_rows(m_vals, torch.float32),
                           device=device)


def fused_synth(a, m_vals, x, pmm, pms, *, l_max, n, phi0, variant="vpu",
                bf16=False, lo=None, mp_vals=None, fold_rings=None,
                store=None):
    """Fused synthesis on a uniform grid: a (M, L1, 2K) f32 -> maps (R, n,
    K) f32, on a's device.

    m_vals (M,) numpy rows; x (R_k,) f32 cos(theta) and pmm/pms (M, R_k)
    seeds on a's device.  Spin 2: ``m_vals``/``mp_vals`` the 2M rows of
    ``ops.spin_rows``, ``a`` the ``spin_pack_alm`` rows (re|im), seeds from
    ``ref.prepare_seeds_spin``; the maps are then (R, n, 2K), Q|U.  Equator
    fold (spin 0 only): pass ``fold_rings`` = the full ring count; x/pmm/pms
    then cover the northern half only and the north/south combine runs in
    the kernel.  ``store``: a dict the caller keeps, for one layout and
    device, to reuse the packed seeds, rotation tables and pack/unpack
    index tensors across calls (a plan passes its own).  Differentiable:
    the backward is fac_m (and 1/2 for spin) times the fused analysis
    chain of the cotangent.
    """
    lo = _resolve(m_vals, l_max, lo, mp_vals, bf16, fold_rings, variant)
    kw = dict(l_max=l_max, var=variant, bf16=bf16, lo=lo, n=n, phi0=phi0,
              fold_rings=fold_rings, store=store)
    return _synth_pair(a, m_vals, x, pmm, pms, lo, kw)


def _synth_pair(a, m_vals, x, pmm, pms, lo, kw):
    """The fused synthesis chain as a linear pair: backward = fac_m (and
    1/2 for spin) times the analysis chain of the cotangent."""
    fac = _fac(m_vals, a.device)
    bsc = 0.5 if lo.spin else 1.0

    def fwd(_, a_):
        return _synth_chain(a_, m_vals, x, pmm, pms, **kw)

    def bwd(_, t):
        return bsc * fac * _anal_chain(t.contiguous(), m_vals, x, pmm, pms,
                                       **kw)

    return linear_pair(fwd, bwd, {"x": x, "pmm": pmm, "pms": pms}, a)


def fused_anal(maps, weights, m_vals, x, pmm, pms, *, l_max, n, phi0,
               variant="vpu", bf16=False, lo=None, mp_vals=None,
               fold_rings=None, store=None):
    """Fused analysis on a uniform grid: maps (R, n, K) -> a (M, l_max + 1,
    2K) f32, on the maps' device (spin 2: Q|U maps (R, n, 2K) -> the 2M
    lambda^{+-} rows, for ``spin_unpack_alm``).

    The ring quadrature ``weights`` are applied to the maps outside the
    kernel chain (they commute with the phi-axis FFT), so the chain's
    adjoint is the weight-free fused synthesis of the cotangent / fac_m
    (and 2 for spin).  Other arguments as :func:`fused_synth`.
    """
    lo = _resolve(m_vals, l_max, lo, mp_vals, bf16, fold_rings, variant)
    kw = dict(l_max=l_max, var=variant, bf16=bf16, lo=lo, n=n, phi0=phi0,
              fold_rings=fold_rings, store=store)
    return _anal_pair(maps, weights, m_vals, x, pmm, pms, lo, kw)


def _anal_pair(maps, weights, m_vals, x, pmm, pms, lo, kw):
    """The fused analysis chain as a linear pair on the ring-weighted maps:
    backward = the synthesis chain of the cotangent / fac_m (and / 2 for
    spin)."""
    maps = torch.as_tensor(maps)
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                        device=maps.device)
    fac = _fac(m_vals, maps.device)
    bsc = 0.5 if lo.spin else 1.0

    def fwd(_, mw):
        return _anal_chain(mw, m_vals, x, pmm, pms, **kw)

    def bwd(_, g):
        return _synth_chain(g / (bsc * fac), m_vals, x, pmm, pms, **kw)

    return linear_pair(fwd, bwd, {"x": x, "pmm": pmm, "pms": pms},
                       maps.to(torch.float32) * w[:, None, None])


def _bucket_of(bucket, m_vals, spin):
    """Check that the bucket index serves the rows' m (the first half of a
    spin row set)."""
    mv = np.asarray(m_vals)
    mv = mv[:mv.shape[0] // 2] if spin else mv
    if not np.array_equal(bucket.m_vals, mv):
        raise ValueError("the bucket index was built for other m rows")
    return bucket


def fused_synth_bucket(a, m_vals, x, pmm, pms, *, l_max, bucket, phi0,
                       variant="vpu", bf16=False, lo=None, mp_vals=None,
                       store=None):
    """Fused synthesis on a ragged (bucketed) grid: a (Mr, L1, 2K) f32 ->
    maps (R, width, C) f32, zero past each ring's n_phi.

    ``bucket`` is the grid's ``core.phase.BucketIndex`` (the plan's
    ``phase.index``: bucket layout, bin maps and the order-fixed fold); the
    kernel rotates the rows by e^{+i m phi0(r)} (``phi0`` per ring) and the
    bucket scatter and inverse FFTs run after it.  Rows, spin and
    ``store`` as :func:`fused_synth`; no fold.  Differentiable: the
    backward is fac_m (and 1/2 for spin) times :func:`fused_anal_bucket`'s
    chain."""
    lo = _resolve(m_vals, l_max, lo, mp_vals, bf16, None, variant)
    kw = dict(l_max=l_max, var=variant, bf16=bf16, lo=lo, phi0=phi0,
              store=store, phase_kind="bucket",
              bucket=_bucket_of(bucket, m_vals, lo.spin))
    return _synth_pair(a, m_vals, x, pmm, pms, lo, kw)


def fused_anal_bucket(maps, weights, m_vals, x, pmm, pms, *, l_max, bucket,
                      phi0, variant="vpu", bf16=False, lo=None, mp_vals=None,
                      store=None):
    """Fused analysis on a ragged grid: maps (R, width, C) -> a (Mr,
    l_max + 1, 2K) f32.  The bucket FFTs and bin gather feed unrotated rows
    to the kernel, which rotates them by e^{-i m phi0(r)}; samples past
    each ring's n_phi are masked.  Other arguments as
    :func:`fused_synth_bucket` and :func:`fused_anal`."""
    lo = _resolve(m_vals, l_max, lo, mp_vals, bf16, None, variant)
    kw = dict(l_max=l_max, var=variant, bf16=bf16, lo=lo, phi0=phi0,
              store=store, phase_kind="bucket",
              bucket=_bucket_of(bucket, m_vals, lo.spin))
    return _anal_pair(maps, weights, m_vals, x, pmm, pms, lo, kw)
