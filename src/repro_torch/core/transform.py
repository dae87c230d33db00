"""Transform plans: one entry point for every SHT execution path.

Counterpart of ``repro.core.transform``::

    import repro_torch
    plan = repro_torch.make_plan("gl", l_max=2048, K=8, dtype="float32",
                                 mode="cuda_mxu")
    hp = repro_torch.make_plan("healpix", nside=1024, K=8, dtype="float32")
    maps = plan.alm2map(alm)       # inverse (synthesis)
    alm2 = plan.map2alm(maps)      # direct (analysis)
    print(plan.report())

Backends
--------
``torch``
    The serial engine (``core.sht.SHT``) in the plan dtype, float64 or
    float32: the oracle.
``cuda_vpu`` / ``cuda_mxu``
    The hand-written CUDA kernels for the recurrence stage, in float32, and
    ``torch.fft`` for the FFTs.  ``vpu`` is one ring per thread (small K),
    ``mxu`` contracts P panels (large K).  On a CPU plan they run the
    kernels' plain versions (``kernels.ref``).
``dist``
    The two-stage distributed transform (``core.dist_sht.DistSHT``) over
    the ranks of the initialised ``torch.distributed`` process group: the
    plan's m rows and rings dealt by ``core.plan.SHTPlan``, one all-to-all
    a direction (chunked and pipelined with ``comm_chunks``).  Its stage 1
    runs the ``torch`` engine in float64 and the plain-layout kernels in
    float32 (their plain versions on a CPU plan).  Every rank builds the
    plan and calls each transform with the same arguments.

Layouts of the kernel backends (``plan.layouts``): ``fused``, the default
where the plan is eligible (``Plan._fusion_eligibility``), runs the fused
Legendre+phase kernels on the packed slot layout (``kernels.fused``), as
the reference's planner does at the sht_cmb shapes; ``plain`` runs the
staged kernels (``kernels.legendre_cuda``) and the phase stage apart;
``packed`` runs the packed staged kernels (two m rows per slot,
``kernels.fused_cuda``'s ``*_packed_*``) and the phase stage apart.
Plans run on the CUDA device unless ``device="cpu"`` is passed.

Dispatch (``mode``): a backend name forces it; ``None`` takes the static
rule (``torch`` in float64, else ``2K >= 16 -> cuda_mxu``); ``"model"``
ranks every candidate backend and layout per direction by the analytic
cost model (``roofline.analysis``: the H100 model on a CUDA plan, the
host model on a CPU plan); ``"auto"`` times every candidate corner once
(a warm-up, then the median of up to 9 timed calls, kept per hardware in
``roofline.chardb``) and takes the fastest per direction, so synthesis
and analysis may run on different backends or layouts.  Its decision is cached (``cache=``: in
memory, or on disk under ``cache_dir`` / ``$REPRO_TORCH_CACHE_DIR``), so a
second build measures nothing.

Grids: ``gl`` and ``ecp`` take ``l_max``; ``healpix`` (ragged rings,
served by the ring-bucket phase stage) and ``healpix_ring`` (HEALPix
latitudes with a uniform 4 nside samples per ring) take ``nside`` and
default to ``l_max = 2 nside``.  Every backend and layout runs on every
grid; the fused layout is the default wherever the reference's two rules
allow it (:func:`_fusion_eligibility`).

``spin=2`` plans transform polarisation: (E, B) alm ``(2, M, L, K)`` to
(Q, U) maps ``(2, R, n_phi, K)`` and back, on every backend and layout.
Their Legendre stage runs the 2M Wigner-d rows [m' = -2 | m' = +2]
(the kernels' spin branch), their phase stage takes Q|U as 2K channels.

``alm2map`` and ``map2alm`` are differentiable on every backend and
layout (``plan.grad_ready``): each layer carries an adjoint pair
(``core.autodiff``), so a backward runs the opposite-direction transform
of the same layer, kernels included.  First order only.

Nothing is substituted silently: a request the plan cannot run raises.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import cache as plancache
from repro_torch.core import grids as gridlib
from repro_torch.core import legendre
from repro_torch.core.grids import RingGrid
from repro_torch.core.sht import SHT, alm_mask, random_alm, random_alm_spin

__all__ = ["Plan", "make_plan", "available_backends", "backend_eligibility",
           "clear_plan_cache", "drop_plan", "BACKENDS"]

BACKENDS = ("torch", "cuda_vpu", "cuda_mxu", "dist")
KERNEL_BACKENDS = ("cuda_vpu", "cuda_mxu")

_DTYPES = {"float64": torch.float64, "float32": torch.float32}
_CDTYPES = {"float64": torch.complex128, "float32": torch.complex64}

#: the seconds the timed calls of one autotune corner cover (at most 9
#: calls; a slower corner is timed once)
_MEASURE_S = 0.05

#: make_plan memoisation: signature key -> Plan
_PLANS: dict[str, "Plan"] = {}


def clear_plan_cache() -> None:
    """Drop memoised plans and the in-memory tier of the precompute cache
    and of the autotune decisions (disk entries and the characterization
    store stay)."""
    _PLANS.clear()
    plancache.clear_memory()


def drop_plan(plan: "Plan") -> bool:
    """Remove one memoised plan so it can be garbage-collected.

    ``clear_plan_cache`` is all-or-nothing; bounded plan holders (the
    serving engine's LRU pool, ``repro_torch.serve.PlanPool``) evict a
    single signature through this.  The shared precompute payloads
    (geometry, seed tables) stay cached; only the live Plan object (its
    device seeds, fused store and callables) is released.  Returns True
    when the plan was memoised.
    """
    return _PLANS.pop(plan._signature_key, None) is not None


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device, which must then be visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"plans run on 'cuda' or 'cpu', not {dev.type!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the plan, and the kernels' plain versions, "
                           "on the CPU")
    return dev


def _world_size() -> int:
    """Ranks of the initialised default process group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _slowest_rank(values, device) -> list:
    """Each value's maximum over the ranks of the default process group
    (one ``all_reduce(MAX)``, on the group's device kind), as floats; the
    values as they are without a group of >= 2 ranks."""
    if _world_size() < 2:
        return [float(v) for v in values]
    import torch.distributed as dist
    from repro_torch.core.dist_sht import _group_device
    dev = device if _group_device(None) == "cuda" else torch.device("cpu")
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def backend_eligibility(grid: RingGrid, dtype: str,
                        n_devices: Optional[int] = None
                        ) -> dict[str, Optional[str]]:
    """Why-or-why-not per backend: ``{backend: None | skip_reason}``.

    The kernels compute in float32, so a float64 signature restricts the
    default choice to the ``torch`` oracle; ``dist`` needs >= 2 devices,
    the ranks of an initialised process group (``n_devices``: that count;
    None: the default group's size, 1 without one).
    """
    out: dict[str, Optional[str]] = {b: None for b in BACKENDS}
    if dtype != "float32":
        reason = (f"kernels compute in float32 (plan dtype {dtype!r}); "
                  "force mode='cuda_*' to accept the precision drop")
        out["cuda_vpu"] = out["cuda_mxu"] = reason
    n_dev = _world_size() if n_devices is None else n_devices
    if n_dev < 2:
        out["dist"] = (f"needs >= 2 devices (visible: {n_dev}): the ranks of "
                       "an initialised torch.distributed process group")
    return out


def available_backends(grid: RingGrid, dtype: str,
                       n_devices: Optional[int] = None) -> list[str]:
    """Backends eligible for this signature."""
    elig = backend_eligibility(grid, dtype, n_devices)
    return [b for b in BACKENDS if elig[b] is None]


class Plan:
    """An executable SHT plan: precompute, layout and kernel choice.

    Construct through :func:`make_plan`, which memoises by signature.
    ``backends`` is ``{"synth": name, "anal": name}``; ``layouts`` names
    the Legendre layout per direction for the kernel backends.
    """

    def __init__(self, grid: RingGrid, l_max: int, m_max: int, K: int,
                 dtype: str, *, mode: str, fold: bool, device: torch.device,
                 signature_key: str, seeds_key: str, spin: int = 0,
                 cache_kind: str = "memory",
                 cache_dir: Optional[str] = None,
                 n_shards: Optional[int] = None,
                 comm_chunks: Union[int, str] = "auto"):
        self.grid = grid
        self.l_max = int(l_max)
        self.m_max = int(m_max)
        self.K = int(K)
        self.dtype = str(dtype)
        self.mode = mode
        self.fold = bool(fold)
        self.spin = int(spin)
        self.device = device
        self._signature_key = signature_key
        self._seeds_key = seeds_key
        self._cache_kind = cache_kind
        self._cache_dir = cache_dir
        self._sht = SHT(grid, l_max=self.l_max, m_max=self.m_max,
                        dtype=self.dtype, fold=self.fold)
        self._m_vals = np.arange(self.m_max + 1)
        self._seeds_cache: Optional[tuple] = None
        #: guards the lazily built members (seeds, callables): a pooled
        #: plan can be warmed on one thread while another runs it
        self._lock = threading.RLock()
        #: what the slot kernels of the fused and packed layouts reuse
        #: across calls: the packed layout, seeds, rotation tables and the
        #: pack/unpack index tensors (``kernels.fused``, ``kernels.ops``)
        self._fused_store: dict = {}
        self._fns: dict = {}
        self.backends: dict = {}
        self.layouts: dict = {}
        self.candidates: list[str] = []
        self.skipped: dict = {}
        self.cache_events: dict = {}
        #: cost-model seconds and measured seconds per candidate per
        #: direction (``mode="model"`` / ``"auto"``; see _predict_all)
        self.predicted_s: dict = {}
        self.measured_s: dict = {}
        self._n_shards = n_shards
        #: "auto" or a forced exchange chunk count (the dist backend)
        self._comm_spec = comm_chunks
        #: exchange chunk count per direction of the dist backend (None
        #: elsewhere), and its engines per chunk count
        self.comm_chunks: dict = {}
        self._dists: dict = {}
        self._dist_splan = None

    @property
    def phase(self):
        """The plan's FFT/phase stage, shared by every backend."""
        return self._sht.phase

    @property
    def _alm_shape(self) -> tuple:
        base = (self.m_max + 1, self.l_max + 1, self.K)
        return base if self.spin == 0 else (2,) + base

    @property
    def _maps_shape(self) -> tuple:
        base = (self.grid.n_rings, self.grid.max_n_phi, self.K)
        return base if self.spin == 0 else (2,) + base

    @property
    def _rows(self) -> tuple:
        """The kernel rows (m, m'): (m_vals, None) for spin 0, the 2M
        stacked [m' = -2 | m' = +2] rows for spin 2."""
        if self.spin == 0:
            return self._m_vals, None
        return legendre._spin_rows(self._m_vals)

    # -- precompute (shared by plans on one grid) ------------------------------

    def _seeds(self):
        """(m_vals i32, x f32, pmm f32, pms i32) kernel operands on the
        plan's device; fold plans seed the northern rings only.  The float64
        host build is keyed by (grid, m_max, fold), so plans differing only
        in K, mode, dtype or device share it."""
        with self._lock:
            if self._seeds_cache is None:
                self._seeds_cache = self._build_seeds()
            return self._seeds_cache

    def _build_seeds(self) -> tuple:
        from repro_torch.kernels import ref as kref
        g = self.grid
        nh = (g.n_rings + 1) // 2
        sin = g.sin_theta[:nh] if self.fold else g.sin_theta
        x = g.cos_theta[:nh] if self.fold else g.cos_theta

        def build():
            pmm, pms = kref.prepare_seeds(self._m_vals, sin,
                                          legendre.log_mu(self.m_max))
            return {"pmm": pmm, "pms": pms}

        payload = plancache.get_or_build(self._seeds_key, build,
                                         cache=self._cache_kind,
                                         directory=self._cache_dir)
        self.cache_events.setdefault("seeds", self._seeds_key)
        dev = self.device
        return (
            torch.as_tensor(self._m_vals, dtype=torch.int32, device=dev),
            torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(payload["pmm"], device=dev),
            torch.as_tensor(payload["pms"], device=dev))

    def _seeds_spin(self):
        """(m2 i32, x f32, pmm f32, pms i32, mp2 i32) kernel operands of the
        2M spin rows on the plan's device, the seeds from
        ``ref.prepare_seeds_spin``; keyed by (grid, m_max, spin) like
        :meth:`_seeds`."""
        with self._lock:
            if self._seeds_cache is None:
                self._seeds_cache = self._build_seeds_spin()
            return self._seeds_cache

    def _build_seeds_spin(self) -> tuple:
        from repro_torch.kernels import ref as kref
        g = self.grid
        m2, mp2 = self._rows

        def build():
            pmm, pms = kref.prepare_seeds_spin(m2, mp2, g.cos_theta,
                                               g.sin_theta, m_max=self.m_max)
            return {"pmm": pmm, "pms": pms}

        payload = plancache.get_or_build(self._seeds_key, build,
                                         cache=self._cache_kind,
                                         directory=self._cache_dir)
        self.cache_events.setdefault("seeds_spin", self._seeds_key)
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        return (
            torch.as_tensor(m2, **i32),
            torch.as_tensor(g.cos_theta, dtype=torch.float32, device=dev),
            torch.as_tensor(payload["pmm"], device=dev),
            torch.as_tensor(payload["pms"], device=dev),
            torch.as_tensor(mp2, **i32))

    def _row_seeds(self):
        """(m_rows, x, pmm, pms, mp_rows or None) of the plan's spin."""
        return self._seeds() + (None,) if self.spin == 0 \
            else self._seeds_spin()

    # -- per-backend execution ------------------------------------------------

    def _fn(self, direction: str, backend: str, layout):
        """The callable of one direction, backend and layout (for ``dist``
        the exchange chunk count C), built once."""
        if layout is None:
            layout = (self.comm_chunks.get(direction) or 1
                      if backend == "dist" else self.layouts.get(direction))
        key = (direction, backend, layout)
        fn = self._fns.get(key)
        if fn is None:
            with self._lock:
                fn = self._fns.get(key)
                if fn is None:
                    fn = self._fns[key] = self._build_fn(direction, backend,
                                                         layout)
        return fn

    def _build_fn(self, direction: str, backend: str, layout: Optional[str]):
        if backend == "torch":
            if self.spin:
                return (self._sht.alm2map_spin if direction == "synth"
                        else self._sht.map2alm_spin)
            return (self._sht.alm2map if direction == "synth"
                    else self._sht.map2alm)
        if backend == "dist":
            return self._make_dist(direction, int(layout))
        if backend not in ("cuda_vpu", "cuda_mxu"):
            raise ValueError(f"unknown backend {backend!r}")
        if layout == "fused":
            ok, reason = self._fusion_eligibility()
            if not ok:
                raise ValueError(f"fused layout unavailable: {reason}")
            return (self._make_fused_synth if direction == "synth"
                    else self._make_fused_anal)(backend[5:])
        if layout in ("plain", "packed"):
            return (self._make_kernel_synth if direction == "synth"
                    else self._make_kernel_anal)(backend[5:], layout)
        raise ValueError(f"unknown layout {layout!r}")

    def _synth_fn(self, backend: str, layout=None):
        """Synthesis callable alm -> maps for ``backend`` (cached);
        ``layout`` overrides the plan's (``"plain"`` | ``"packed"`` |
        ``"fused"``; for ``dist`` the exchange chunk count C)."""
        return self._fn("synth", backend, layout)

    def _anal_fn(self, backend: str, layout=None):
        """Analysis callable maps -> alm for ``backend`` (cached);
        ``layout`` as in :meth:`_synth_fn`."""
        return self._fn("anal", backend, layout)

    def _make_kernel_synth(self, variant: str, layout: str):
        if self.spin:
            return self._make_kernel_synth_spin(variant, layout)
        from repro_torch.kernels import ops as kops
        K, nh = self.K, (self.grid.n_rings + 1) // 2
        ns = nh - 1 if self.grid.n_rings % 2 == 1 else nh
        cdt, rdt = _CDTYPES[self.dtype], _DTYPES[self.dtype]
        m_t, x32, pmm, pms = self._seeds()

        def fn(alm):
            a32 = torch.cat([alm.real, alm.imag], dim=-1).to(torch.float32)
            out = kops.synth(a32, m_t, x32, pmm, pms, l_max=self.l_max,
                             fold=self.fold, variant=variant, layout=layout,
                             store=self._fused_store)
            if self.fold:
                e, o = out[:, 0], out[:, 1]              # (M, nh, 2K)
                north = e + o
                south = (e - o)[:, :ns].flip(1)
                flat = torch.cat([north, south], dim=1)
            else:
                flat = out[:, 0]                         # (M, R, 2K)
            delta = torch.complex(flat[..., :K], flat[..., K:]).to(cdt)
            return self._sht.phase.synth(delta).to(rdt)

        return fn

    def _make_kernel_anal(self, variant: str, layout: str):
        if self.spin:
            return self._make_kernel_anal_spin(variant, layout)
        from repro_torch.kernels import ops as kops
        K, R = self.K, self.grid.n_rings
        nh = (R + 1) // 2
        cdt = _CDTYPES[self.dtype]
        m_t, x32, pmm, pms = self._seeds()
        mask = torch.as_tensor(alm_mask(self.l_max, self.m_max),
                               device=self.device)[..., None]

        def fn(maps):
            dwc = self._sht.phase.anal(maps.to(_DTYPES[self.dtype]))
            dw = torch.cat([dwc.real, dwc.imag], dim=-1).to(torch.float32)
            if self.fold:
                n_part = dw[:, :nh]
                s_part = torch.zeros_like(n_part)
                s_part[:, :R - nh] = dw[:, nh:].flip(1)
                dwk = torch.stack([n_part + s_part, n_part - s_part], dim=1)
            else:
                dwk = dw[:, None]                        # (M, 1, R, 2K)
            out = kops.anal(dwk, m_t, x32, pmm, pms, l_max=self.l_max,
                            fold=self.fold, variant=variant, layout=layout,
                            store=self._fused_store)
            alm = torch.complex(out[..., :K], out[..., K:]).to(cdt)
            return torch.where(mask, alm, torch.zeros((), dtype=cdt,
                                                      device=alm.device))

        return fn

    def _spin_mask(self) -> torch.Tensor:
        """(1, M, L, 1) bool: the valid (m, l >= max(m, 2)) entries of an
        (E, B) alm pair."""
        return torch.as_tensor(alm_mask(self.l_max, self.m_max, spin=2),
                               device=self.device)[None, ..., None]

    @staticmethod
    def _eb_rows(alm_eb) -> torch.Tensor:
        """(E, B) alm (2, M, L, K) -> the stacked a^{+-} rows (2M, L, 2K)
        f32, re | im."""
        e, b = alm_eb[0], alm_eb[1]
        a2_re, a2_im = legendre.spin_pack_alm(e.real, e.imag, b.real, b.imag)
        return torch.cat([a2_re, a2_im], dim=-1).to(torch.float32)

    def _eb_alm(self, out) -> torch.Tensor:
        """The a^{+-} rows (2M, L, 2K) f32 -> masked (E, B) alm (2, M, L,
        K) in the plan's complex dtype."""
        K, cdt = self.K, _CDTYPES[self.dtype]
        e_re, e_im, b_re, b_im = legendre.spin_unpack_alm(out[..., :K],
                                                          out[..., K:])
        alm = torch.stack([torch.complex(e_re, e_im),
                           torch.complex(b_re, b_im)], dim=0).to(cdt)
        return torch.where(self._spin_mask(), alm,
                           torch.zeros((), dtype=cdt, device=alm.device))

    def _make_kernel_synth_spin(self, variant: str, layout: str):
        """Spin-2 staged synthesis: the a^{+-} rows through the kernels'
        spin branch, Delta^{+-} unpacked into Q|U channels, the phase
        stage on 2K channels."""
        from repro_torch.kernels import ops as kops
        K, cdt, rdt = self.K, _CDTYPES[self.dtype], _DTYPES[self.dtype]
        m_t, x32, pmm, pms, mp_t = self._seeds_spin()

        def fn(alm_eb):
            out = kops.synth(self._eb_rows(alm_eb), m_t, x32, pmm, pms,
                             l_max=self.l_max, variant=variant,
                             layout=layout, store=self._fused_store,
                             mp_vals=mp_t)
            flat = out[:, 0]                             # (2M, R, 2K)
            dq_re, dq_im, du_re, du_im = legendre.spin_unpack_delta(
                flat[..., :K], flat[..., K:])
            delta = torch.cat([torch.complex(dq_re, dq_im),
                               torch.complex(du_re, du_im)], dim=-1)
            s = self._sht.phase.synth(delta.to(cdt)).to(rdt)
            return torch.stack([s[..., :K], s[..., K:]], dim=0)

        return fn

    def _make_kernel_anal_spin(self, variant: str, layout: str):
        """Spin-2 staged analysis: the phase stage on the Q|U channels, the
        bins packed into Delta^{+-} rows, the kernels' spin branch, the
        a^{+-} rows unpacked into (E, B)."""
        from repro_torch.kernels import ops as kops
        K, rdt = self.K, _DTYPES[self.dtype]
        m_t, x32, pmm, pms, mp_t = self._seeds_spin()

        def fn(maps_qu):
            dwc = self._sht.phase.anal(
                torch.cat([maps_qu[0], maps_qu[1]], dim=-1).to(rdt))
            d2_re, d2_im = legendre.spin_pack_delta(
                dwc[..., :K].real, dwc[..., :K].imag, dwc[..., K:].real,
                dwc[..., K:].imag)
            dw = torch.cat([d2_re, d2_im], dim=-1).to(torch.float32)
            out = kops.anal(dw[:, None], m_t, x32, pmm, pms,
                            l_max=self.l_max, variant=variant,
                            layout=layout, store=self._fused_store,
                            mp_vals=mp_t)
            return self._eb_alm(out)

        return fn

    # -- the distributed transform (backend "dist") ---------------------------

    def _n_devices(self) -> int:
        """The dist backend's device count: ``n_shards``, else the default
        process group's size."""
        return self._n_shards or _world_size()

    def _dealing(self):
        """The dist backend's ``SHTPlan`` (built once)."""
        with self._lock:
            if self._dist_splan is None:
                from repro_torch.core.plan import SHTPlan
                self._dist_splan = SHTPlan(self.grid, self.l_max, self.m_max,
                                           self._n_devices())
            return self._dist_splan

    def _dist_engine(self, comm_chunks: int = 1):
        """The distributed engine of one exchange chunk count (cached per C;
        the dealing plan is shared).  Stage 1 runs the kernels in float32
        (their plain versions on a CPU plan) and the ``torch`` engine in
        float64."""
        C = max(1, int(comm_chunks))
        with self._lock:
            if C not in self._dists:
                from repro_torch.core.dist_sht import DistSHT
                stage1 = "torch" if self.dtype == "float64" else (
                    "cuda" if self.device.type == "cuda" else "plain")
                self._dists[C] = DistSHT(
                    self._dealing(), device=self.device, dtype=self.dtype,
                    stage1=stage1, comm_chunks=C, layout="plain")
            return self._dists[C]

    def _make_dist(self, direction: str, comm_chunks: int):
        """One direction of the dist backend on whole arrays: the plan's
        dense alm / grid maps packed into the dealing plan's order, the
        engine's collective transform, and back."""
        d = self._dist_engine(comm_chunks)
        sp = d.plan
        if direction == "synth":
            if self.spin:
                def fn(alm_eb):
                    qu = d.alm2map_spin(torch.stack(
                        [sp.pack_alm(alm_eb[0]), sp.pack_alm(alm_eb[1])]))
                    return torch.stack([sp.scatter_map(qu[0]),
                                        sp.scatter_map(qu[1])])
            else:
                def fn(alm):
                    return sp.scatter_map(d.alm2map(sp.pack_alm(alm)))
            return fn
        if self.spin:
            def fn(maps_qu):
                eb = d.map2alm_spin(torch.stack(
                    [sp.gather_map(maps_qu[0]), sp.gather_map(maps_qu[1])]))
                return torch.stack([sp.unpack_alm(eb[0]),
                                    sp.unpack_alm(eb[1])])
        else:
            def fn(maps):
                return sp.unpack_alm(d.map2alm(sp.gather_map(maps)))
        return fn

    # -- fused pipeline (layout "fused") --------------------------------------

    def _fusion_eligibility(self) -> tuple:
        """(eligible, reason) for the fused Legendre+phase pipeline.

        See :func:`_fusion_eligibility`.
        """
        return _fusion_eligibility(self.grid, self.spin, self.m_max,
                                   self.fold)

    def _fused_layout(self):
        """The packed slot layout shared by the fused and packed directions
        (of the 2M spin rows on a spin-2 plan):
        ``kernels.ops._resolve_layout``'s, kept in the plan's store under
        ``"layout"``."""
        from repro_torch.kernels import ops as kops
        rows, mp = self._rows
        return kops._resolve_layout(rows, "packed", self.l_max,
                                    self._fused_store, mp_vals=mp)

    def _fused_parts(self, variant: str, bf16: bool):
        """(seeds, keyword block, (synthesis chain, analysis chain)) of the
        fused kernels: the phase stage's flavour (the uniform FFT length and
        the fold's full ring count, or the bucket index), the ring offsets
        phi0, the rows' m' (spin 2), the bfloat16 option, and the plan's
        store of packed seeds, tables and indices."""
        from repro_torch.kernels import fused as kfused
        g, ph = self.grid, self.phase
        _, x32, pmm, pms, _ = self._row_seeds()
        kw = dict(l_max=self.l_max, variant=variant, bf16=bf16,
                  lo=self._fused_layout(), phi0=g.phi0,
                  mp_vals=self._rows[1], store=self._fused_store)
        if ph.kind == "uniform":
            kw.update(n=ph.n, fold_rings=g.n_rings if self.fold else None)
            pair = (kfused.fused_synth, kfused.fused_anal)
        else:
            kw.update(bucket=ph.index)
            pair = (kfused.fused_synth_bucket, kfused.fused_anal_bucket)
        return (x32, pmm, pms), kw, pair

    def _make_fused_synth(self, variant: str, bf16: bool = False):
        """The fused synthesis alm -> maps; ``bf16=True`` (variant ``mxu``
        only) runs the bfloat16 contraction of kernel 10, as the
        reference's ``_make_fused_synth(variant, bf16=True)``."""
        K, rdt = self.K, _DTYPES[self.dtype]
        (x32, pmm, pms), kw, (fsynth, _) = self._fused_parts(variant, bf16)
        rows = self._rows[0]

        def fn(alm):
            if self.spin:
                s = fsynth(self._eb_rows(alm), rows, x32, pmm, pms,
                           **kw).to(rdt)
                return torch.stack([s[..., :K], s[..., K:]], dim=0)
            a32 = torch.cat([alm.real, alm.imag], dim=-1).to(torch.float32)
            return fsynth(a32, rows, x32, pmm, pms, **kw).to(rdt)

        return fn

    def _make_fused_anal(self, variant: str, bf16: bool = False):
        """The fused analysis maps -> alm; ``bf16`` as in
        :meth:`_make_fused_synth` (kernel 12)."""
        K, cdt = self.K, _CDTYPES[self.dtype]
        (x32, pmm, pms), kw, (_, fanal) = self._fused_parts(variant, bf16)
        rows = self._rows[0]
        mask = torch.as_tensor(alm_mask(self.l_max, self.m_max),
                               device=self.device)[..., None]

        def fn(maps):
            # the quadrature weights are applied outside the kernel chain
            if self.spin:
                out = fanal(torch.cat([maps[0], maps[1]], dim=-1),
                            self.grid.weights, rows, x32, pmm, pms, **kw)
                return self._eb_alm(out)
            out = fanal(maps, self.grid.weights, rows, x32, pmm, pms, **kw)
            alm = torch.complex(out[..., :K], out[..., K:]).to(cdt)
            return torch.where(mask, alm, torch.zeros((), dtype=cdt,
                                                      device=alm.device))

        return fn

    # -- dispatch -------------------------------------------------------------

    def _kernel_layouts(self) -> tuple:
        """Candidate Legendre layouts of the kernel backends, in the
        reference's order (``_pallas_layouts``)."""
        lays = ("packed", "plain")
        if self._fusion_eligibility()[0]:
            lays = lays + ("fused",)
        return lays

    def _predict_all(self) -> dict:
        """Cost-model seconds per candidate per direction: ``out[b][d]``,
        for a kernel backend the best of its layouts, named by
        ``out[b][f"{d}_layout"]``, each layout's under ``f"{d}_{layout}"``
        (a fused layout is modelled as the packed grid with Delta kept on
        chip)."""
        from repro_torch.roofline import analysis as roofline
        g = self.grid
        hw = roofline.hardware_for(self.device)
        out = {}
        for b in self.candidates:
            out[b] = {}
            for d in ("synth", "anal"):
                kw = dict(l_max=self.l_max, m_max=self.m_max,
                          n_rings=g.n_rings, n_phi=g.max_n_phi, K=self.K,
                          direction=d, hw=hw,
                          n_devices=self._n_devices() if b == "dist" else 1,
                          fft_lengths=self._sht.phase.fft_lengths,
                          spin=self.spin)
                if b == "dist":
                    # the overlapped pipeline model: the chunk count C with
                    # the least modelled time
                    per = self._dist_times(d)
                    c_best = min(per, key=per.get)
                    out[b][d] = per[c_best]
                    out[b][f"{d}_chunks"] = c_best
                    out[b].update({f"{d}_{c}": v for c, v in per.items()})
                elif b in KERNEL_BACKENDS:
                    per = {lay: roofline.predict_sht_time(
                               b, layout="packed" if lay == "fused" else lay,
                               pipeline="fused" if lay == "fused"
                               else "staged", **kw)
                           for lay in self._kernel_layouts()}
                    lay = min(per, key=per.get)
                    out[b][d] = per[lay]
                    out[b][f"{d}_layout"] = lay
                    out[b].update({f"{d}_{k}": v for k, v in per.items()})
                else:
                    out[b][d] = roofline.predict_sht_time(b, **kw)
        return out

    def _dist_model_kw(self, direction: str) -> dict:
        """The cost model's arguments for the dist backend (the FFT lengths
        from the grid's buckets, which are the phase stage's, so that no
        phase stage is built for them)."""
        from repro_torch.roofline import analysis as roofline
        g = self.grid
        return dict(l_max=self.l_max, m_max=self.m_max, n_rings=g.n_rings,
                    n_phi=g.max_n_phi, K=self.K, direction=direction,
                    hw=roofline.hardware_for(self.device),
                    n_devices=self._n_devices(),
                    fft_lengths=g.bucket_lengths(), spin=self.spin)

    def _dist_chunk_variants(self, direction: str) -> tuple:
        """Candidate exchange chunk counts of the dist backend: C = 1 and
        the overlap model's pick (``roofline.predict_comm_chunks``), or the
        forced count alone."""
        if isinstance(self._comm_spec, (int, np.integer)):
            return (max(1, int(self._comm_spec)),)
        from repro_torch.roofline import analysis as roofline
        c = roofline.predict_comm_chunks(**self._dist_model_kw(direction))
        return tuple(sorted({1, int(c)}))

    def _dist_times(self, direction: str) -> dict:
        """The dist backend's modelled seconds per candidate chunk count
        (the overlapped pipeline)."""
        from repro_torch.roofline import analysis as roofline
        kw = self._dist_model_kw(direction)
        return {c: roofline.predict_sht_time("dist", overlap=True,
                                             comm_chunks=c, **kw)
                for c in self._dist_chunk_variants(direction)}

    def _corner_layouts(self, backend: str, direction: str) -> tuple:
        """What one backend's autotune corners vary: the kernel layouts, the
        dist chunk counts, or nothing (``(None,)``)."""
        if backend in KERNEL_BACKENDS:
            return self._kernel_layouts()
        if backend == "dist":
            return self._dist_chunk_variants(direction)
        return (None,)

    def _chardb(self):
        """The characterization store of this plan's hardware (on disk iff
        the plan's cache is)."""
        from repro_torch.roofline import chardb
        directory = None
        if self._cache_kind == "disk":
            directory = plancache.cache_dir(self._cache_dir)
        return chardb.get_db(directory, self.device)

    def _corner_fields(self, backend: str, direction: str, layout) -> dict:
        """Workload coordinates of one autotune corner, without the dispatch
        mode or the plan's signature key, so every plan running the same
        workload on the same hardware reuses the timing.  ``lp_size`` stays
        a coordinate (the panel length, one value in the port)."""
        from repro_torch.kernels.fused import FUSED_LP_SIZE
        fields = dict(
            grid=self.grid.name, n_rings=self.grid.n_rings,
            n_phi=self.grid.max_n_phi, l_max=self.l_max, m_max=self.m_max,
            K=self.K, dtype=self.dtype, spin=self.spin, fold=self.fold,
            backend=backend, direction=direction, layout=layout or "-",
            n_devices=self._n_devices() if backend == "dist" else 1,
            lp_size=FUSED_LP_SIZE)
        if backend == "dist":
            # the layout slot carries the exchange chunk count
            fields["layout"] = "-"
            fields["comm_chunks"] = max(1, int(layout or 1))
        return fields

    def _timed_us(self, fn, arg, collective: bool = False) -> float:
        """Microseconds of ``fn(arg)``: one warm-up call, then the median of
        the timed calls, one for a call of at least ``_MEASURE_S`` and
        otherwise enough to cover it, 3 to 9.  CUDA events on the card (the
        stream's span, host gaps included), the host clock on the CPU.  A
        ``collective`` corner (dist) counts its calls from the slowest
        rank's first time, so every rank makes as many calls."""
        cuda = self.device.type == "cuda"

        def once() -> float:
            if not cuda:
                t0 = time.perf_counter()
                fn(arg)
                return (time.perf_counter() - t0) * 1e6
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(arg)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e3

        fn(arg)
        if cuda:
            torch.cuda.synchronize(self.device)
        times = [once()]
        first = _slowest_rank([times[0]], self.device)[0] if collective \
            else times[0]
        if first < _MEASURE_S * 1e6:
            reps = math.ceil(_MEASURE_S * 1e6 / max(first, 1.0))
            times += [once() for _ in range(min(9, max(3, reps)) - 1)]
        return float(np.median(times))

    def _dist_corner(self, db, measure, fields) -> tuple:
        """``(us, status)`` of a collective corner: reused only when every
        rank holds a fresh record of it (else every rank measures it, so
        each runs the same collectives)."""
        from repro_torch.roofline import chardb
        if chardb.smoke_mode():
            return db.get_or_measure(measure, **fields)
        fresh = 1.0 if db.lookup(**fields) is not None else 0.0
        everyone = -_slowest_rank([-fresh], self.device)[0]
        return db.get_or_measure(measure, reuse=everyone > 0, **fields)

    def _measure_all(self) -> dict:
        """Measured seconds per candidate per direction, through the
        characterization store: a stored corner is reused without running
        anything, a missing or stale one gets a warm-up call and the median
        of a few timed ones (:meth:`_timed_us`), and with
        ``REPRO_TORCH_CHARDB_SMOKE=1`` it is skipped (inf).  The store is
        written once, after the sweep.  With the dist backend among the
        candidates the table then takes every corner's time on the slowest
        rank (one ``all_reduce(MAX)``), so every rank decides alike.  Keys
        as :meth:`_predict_all`'s.  A corner that raises (a build, launch
        or CUDA error) propagates: nothing is ranked last in its place."""
        db = self._chardb()
        gen = torch.Generator().manual_seed(0)
        cdt = _CDTYPES[self.dtype]
        draw = random_alm if self.spin == 0 else random_alm_spin
        alm = draw(gen, self.l_max, self.m_max, self.K,
                   device=self.device).to(cdt)
        maps = torch.zeros(self._maps_shape, dtype=_DTYPES[self.dtype],
                           device=self.device)
        times: dict = {}
        skipped: set = set()
        with db.batch():
            for b in self.candidates:
                for d, arg in (("synth", alm), ("anal", maps)):
                    for lay in self._corner_layouts(b, d):
                        fields = self._corner_fields(b, d, lay)

                        def measure(b=b, d=d, lay=lay, arg=arg):
                            fn = self._fn(d, b, lay)
                            if b == "dist":
                                return self._timed_us(fn, arg,
                                                      collective=True)
                            return self._timed_us(fn, arg)

                        us, status = (self._dist_corner(db, measure, fields)
                                      if b == "dist" else
                                      db.get_or_measure(measure, **fields))
                        times[(b, d, lay)] = float("inf") if us is None \
                            else us * 1e-6
                        if status == "skipped":
                            skipped.add((b, d))
        if "dist" in self.candidates:
            keys = list(times)
            times = dict(zip(keys, _slowest_rank([times[k] for k in keys],
                                                 self.device)))
        out: dict = {}
        for b in self.candidates:
            out[b] = {}
            slot = "chunks" if b == "dist" else "layout"
            for d in ("synth", "anal"):
                lays = self._corner_layouts(b, d)
                best, best_lay = float("inf"), None
                for lay in lays:
                    t = times[(b, d, lay)]
                    if lay is not None:
                        out[b][f"{d}_{lay}"] = t
                    if t < best:
                        best, best_lay = t, lay
                out[b][d] = best
                if (b, d) in skipped:
                    out[b][f"{d}_skipped"] = True
                if best_lay is not None:
                    out[b][f"{d}_{slot}"] = best_lay
        return out

    def _fill_layouts(self, source: dict) -> None:
        """``self.layouts`` per direction from a per-candidate table
        (``{backend: {"<dir>_layout": ...}}``), the model's choice filling a
        gap; the ``torch`` backend takes none."""
        self.layouts = {}
        for d in ("synth", "anal"):
            b = self.backends.get(d)
            if b not in KERNEL_BACKENDS:
                self.layouts[d] = None
                continue
            lay = source.get(b, {}).get(f"{d}_layout") \
                or self.predicted_s.get(b, {}).get(f"{d}_layout")
            self.layouts[d] = lay or "packed"

    def _fill_comm_chunks(self, source: dict) -> None:
        """``self.comm_chunks`` per direction of the dist backend: the
        forced count, else the winner in ``source`` (``{"dist":
        {"<dir>_chunks": C}}``), the overlap model's pick filling a gap;
        None on the other backends."""
        self.comm_chunks = {}
        for d in ("synth", "anal"):
            if self.backends.get(d) != "dist":
                self.comm_chunks[d] = None
            elif isinstance(self._comm_spec, (int, np.integer)):
                self.comm_chunks[d] = max(1, int(self._comm_spec))
            else:
                c = source.get("dist", {}).get(f"{d}_chunks")
                if c is None:
                    per = self._dist_times(d)
                    c = min(per, key=per.get)
                self.comm_chunks[d] = max(1, int(c))

    def _choose_backends(self, layout: Optional[str] = None) -> None:
        """``self.backends`` and ``self.layouts`` by ``self.mode``: a forced
        backend with ``layout`` (the static default), the cost model's
        minimum (``"model"``), or the measured minimum (``"auto"``), per
        direction.  A forced plan predicts nothing here (:meth:`describe`
        does, on demand), so it builds no phase stage before its first
        transform."""
        if self.mode in BACKENDS:
            self.backends = {"synth": self.mode, "anal": self.mode}
            self.layouts = {d: layout for d in ("synth", "anal")}
            self._fill_comm_chunks({})
            return
        self.predicted_s = self._predict_all()
        if self.mode == "model":
            self.backends = {
                d: min(self.candidates, key=lambda b: self.predicted_s[b][d])
                for d in ("synth", "anal")}
            self._fill_layouts(self.predicted_s)
            self._fill_comm_chunks(self.predicted_s)
            return
        # the decision holds for this hardware and timing method only, as
        # the corners it was taken from do
        from repro_torch.roofline import chardb
        dkey = plancache.signature_key(
            "decision", sig=self._signature_key, schema=chardb.SCHEMA,
            hardware=chardb.hardware_fingerprint(self.device)[0])
        cached = plancache.load_decision(dkey, cache=self._cache_kind,
                                         directory=self._cache_dir)
        hit = cached is not None and all(
            cached.get(d) in self.candidates for d in ("synth", "anal"))
        if "dist" in self.candidates:
            # the sweep runs collectives: every rank reads its decision,
            # or every rank measures
            hit = -_slowest_rank([-float(hit)], self.device)[0] > 0
        if hit:
            self.backends = {d: cached[d] for d in ("synth", "anal")}
            self.measured_s = cached.get("measured", {})
            self._fill_layouts(self.measured_s)
            self.layouts.update(cached.get("layouts") or {})
            self._fill_comm_chunks(self.measured_s)
            self.comm_chunks.update(cached.get("comm_chunks") or {})
            self.cache_events["decision"] = "hit"
            return
        self.measured_s = self._measure_all()
        self.backends, fell_back = {}, False
        for d in ("synth", "anal"):
            finite = [b for b in self.candidates
                      if np.isfinite(self.measured_s[b][d])]
            if finite:
                self.backends[d] = min(
                    finite, key=lambda b: self.measured_s[b][d])
            else:
                # every corner skipped (smoke mode): the cost model ranks
                self.backends[d] = min(
                    self.candidates, key=lambda b: self.predicted_s[b][d])
                fell_back = True
        self._fill_layouts(self.measured_s)
        self._fill_comm_chunks(self.measured_s)
        if fell_back:
            # a decision not measured must not shadow a later real one
            self.cache_events["decision"] = "model-fallback"
            return
        self.cache_events["decision"] = "autotuned"
        plancache.save_decision(
            dkey, {**self.backends, "measured": self.measured_s,
                   "layouts": dict(self.layouts),
                   "comm_chunks": dict(self.comm_chunks)},
            cache=self._cache_kind, directory=self._cache_dir)

    # -- public API -----------------------------------------------------------

    def _as_input(self, v, shape, what: str) -> torch.Tensor:
        t = torch.as_tensor(v, device=self.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} shape {tuple(t.shape)}: plan was built "
                             f"for {shape}")
        return t

    def alm2map(self, alm) -> torch.Tensor:
        """Inverse SHT: alm ``(m_max+1, l_max+1, K)`` complex -> maps
        ``(R, n_phi, K)`` real, on the plan's device; on a spin-2 plan
        (E, B) alm ``(2, M, L, K)`` -> (Q, U) maps ``(2, R, n_phi, K)``."""
        alm = self._as_input(alm, self._alm_shape, "alm")
        return self._synth_fn(self.backends["synth"])(alm)

    def map2alm(self, maps, iters: int = 0) -> torch.Tensor:
        """Direct SHT: maps -> alm (spin 2: (Q, U) maps -> (E, B) alm, the
        shapes of :meth:`alm2map`).  ``iters > 0`` adds Jacobi residual
        refinement passes (one synthesis and one analysis each)."""
        maps = self._as_input(maps, self._maps_shape, "maps")
        anal = self._anal_fn(self.backends["anal"])
        alm = anal(maps)
        for _ in range(iters):
            alm = alm + anal(maps - self.alm2map(alm))
        return alm

    def warmup(self, directions=("synth", "anal")) -> "Plan":
        """Run each direction once on zero inputs.

        The serving pool's warm-up hook: afterwards the plan's seeds, its
        callables and fused store, the kernel libraries and the cuFFT plans
        are built, so the first real request pays none of it.  On CUDA it
        then synchronises the current stream.  Safe to call from a
        background thread while another thread runs the plan.
        """
        for d in directions:
            if d == "synth":
                self._synth_fn(self.backends["synth"])(torch.zeros(
                    self._alm_shape, dtype=_CDTYPES[self.dtype],
                    device=self.device))
            else:
                self._anal_fn(self.backends["anal"])(torch.zeros(
                    self._maps_shape, dtype=_DTYPES[self.dtype],
                    device=self.device))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self

    @property
    def grad_ready(self) -> dict:
        """Per-direction differentiability of the chosen paths:
        ``{"synth": bool, "anal": bool}``, True when autograd flows through
        :meth:`alm2map` / :meth:`map2alm` by the adjoint rules (every
        backend and layout of the port).  First order only."""
        return {d: self.backends.get(d) in BACKENDS
                for d in ("synth", "anal")}

    def memory_footprint(self) -> dict:
        """Estimated working-set bytes per buffer class.  The reference's
        keys, plus ``partials_bytes``: the float32 per-ring-chunk partial
        sums the CUDA analysis kernels write before their chunk-order
        reduce (the TPU accumulates in place and has none)."""
        g = self.grid
        M, L1, K = self.m_max + 1, self.l_max + 1, self.K
        ncomp = 1 if self.spin == 0 else 2
        csize = 16 if self.dtype == "float64" else 8
        rsize = csize // 2
        out = {
            "alm_bytes": ncomp * M * L1 * K * csize,
            "maps_bytes": ncomp * g.n_rings * g.max_n_phi * K * rsize,
            "delta_bytes": ncomp * M * g.n_rings * K * csize,
            "seed_bytes": (ncomp * 2 * M * g.n_rings * 4
                           if any(b.startswith("cuda")
                                  for b in self.backends.values()) else 0),
            "partials_bytes": self._partials_bytes(),
        }
        out["total_bytes"] = sum(out.values())
        return out

    def _partials_bytes(self) -> int:
        """Bytes of the analysis partials buffer of the plan's analysis
        backend and layout: (rows, n_chunks, l_max + 1, 2K) on the plain
        layout, (n_slots, n_chunks, S, 2K) on the slot layouts, float32;
        0 on the ``torch`` backend.  On the dist backend in float32: the
        plain layout's buffer of one rank's rows over every plan ring
        slot."""
        backend = self.backends.get("anal", "torch")
        if backend == "torch" or (backend == "dist"
                                  and self.dtype == "float64"):
            return 0
        if backend == "dist":
            from repro_torch.kernels import legendre_cuda
            from repro_torch.kernels.ops import pick_variant
            sp = self._dealing()
            shape = legendre_cuda.partials_shape(
                pick_variant(2 * self.K), (1 + (self.spin != 0)) * sp.m_local,
                sp.r_pad, self.l_max, 2 * self.K)
            return 4 * int(np.prod(shape))
        variant = backend[5:]
        n_k = (self.grid.n_rings + 1) // 2 if self.fold else self.grid.n_rings
        if self.layouts.get("anal") == "plain":
            from repro_torch.kernels import legendre_cuda
            shape = legendre_cuda.partials_shape(
                variant, len(self._rows[0]), n_k, self.l_max, 2 * self.K)
        else:
            from repro_torch.kernels import fused_cuda
            lo = self._fused_layout()
            shape = fused_cuda.partials_shape(variant, lo.n_slots, n_k, lo.S,
                                              2 * self.K)
        return 4 * int(np.prod(shape))

    def describe(self) -> dict:
        """Structured report: signature, chosen kernels, layouts, fusion,
        predicted and measured seconds per candidate, memory footprint and
        cache counters (the precompute cache's, the autotune ``decision``
        event, and the characterization store's)."""
        from repro_torch.kernels import pack as kpack
        from repro_torch.kernels.fused import FUSED_LP_SIZE
        from repro_torch.roofline import chardb
        fusion_ok, fusion_reason = self._fusion_eligibility()
        layouts = dict(self.layouts)
        fused = any(v == "fused" for v in layouts.values())
        return {
            "signature": {
                "grid": self.grid.name, "n_rings": self.grid.n_rings,
                "n_phi": self.grid.max_n_phi, "l_max": self.l_max,
                "m_max": self.m_max, "K": self.K, "dtype": self.dtype,
                "fold": self.fold, "spin": self.spin,
                "key": self._signature_key,
            },
            "device": str(self.device),
            "mode": self.mode,
            "backends": dict(self.backends),
            "differentiable": {**self.grad_ready,
                               "rule": "adjoint (torch.autograd.Function)",
                               "higher_order": False},
            "layouts": layouts,
            "fusion": {
                "eligible": fusion_ok, "reason": fusion_reason,
                "skipped": fusion_reason,
                "lp_size": FUSED_LP_SIZE if fused else None,
                "active": {d: layouts.get(d) == "fused"
                           for d in ("synth", "anal")},
                "pipelines": {d: ("fused" if layouts.get(d) == "fused"
                                  else "staged")
                              for d in ("synth", "anal")},
            },
            "comm": {
                "spec": self._comm_spec,
                "chunks": dict(self.comm_chunks),
                "pipelined": {d: (self.comm_chunks.get(d) or 1) > 1
                              for d in ("synth", "anal")},
            },
            "candidates": list(self.candidates),
            "skipped": dict(self.skipped),
            # the packed-vs-plain grid accounting of the Legendre stage
            "legendre": {"layouts": layouts,
                         "panels": kpack.panel_counts(
                             self._rows[0], self.l_max,
                             mp_vals=self._rows[1])},
            "phase": self._sht.phase.describe(),
            "predicted_s": self.predicted_s or self._predict_all(),
            "measured_s": self.measured_s,
            "memory": self.memory_footprint(),
            "cache": {"events": dict(self.cache_events),
                      **plancache.stats().to_dict(),
                      "chardb": chardb.stats()},
        }

    def report(self) -> str:
        """Human-readable :meth:`describe`."""
        d = self.describe()
        s = d["signature"]
        lines = [
            f"Plan {s['grid']} l_max={s['l_max']} m_max={s['m_max']} "
            f"K={s['K']} {s['dtype']} fold={s['fold']} spin={s['spin']} "
            f"mode={d['mode']} device={d['device']}",
            f"  rings={s['n_rings']} n_phi={s['n_phi']} "
            f"memory ~{d['memory']['total_bytes'] / 1e6:.2f} MB",
        ]
        ph = d["phase"]
        if ph["kind"] != "uniform":
            lines.append(
                f"  phase: {ph['kind']} x{ph['n_buckets']} buckets "
                f"{ph['bucket_lengths']} (+{ph['padded_frac'] * 100:.1f}% "
                f"fft padding)")
        for direction in ("synth", "anal"):
            chosen = d["backends"].get(direction, "?")
            lay = d["layouts"].get(direction)
            pred = d["predicted_s"].get(chosen, {}).get(direction)
            meas = d["measured_s"].get(chosen, {}).get(direction)
            cc = d["comm"]["chunks"].get(direction)
            bits = [f"  {direction:5s} -> {chosen}"
                    + (f"[{lay}]" if lay else "")
                    + (f"[C={cc}]" if chosen == "dist" and cc else "")]
            if pred is not None:
                bits.append(f"predicted {pred * 1e6:.1f} us")
            if meas is not None and np.isfinite(meas):
                bits.append(f"measured {meas * 1e6:.1f} us")
            lines.append("  ".join(bits))
        for b, reason in d["skipped"].items():
            lines.append(f"  skipped {b}: {reason}")
        ev = d["cache"]["events"]
        lines.append(f"  cache: {ev if ev else 'cold'} "
                     f"(mem_hits={d['cache']['memory_hits']} "
                     f"disk_hits={d['cache']['disk_hits']} "
                     f"builds={d['cache']['builds']})")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Plan(grid={self.grid.name!r}, l_max={self.l_max}, "
                f"K={self.K}, dtype={self.dtype!r}, device={self.device}, "
                f"backends={self.backends})")


def _fusion_eligibility(grid: RingGrid, spin: int, m_max: int,
                        fold: bool = False) -> tuple:
    """(eligible, reason) for the fused Legendre+phase pipeline.

    The reference's two rules: the fused kernels cover spin 0 and 2,
    folded or not, on the uniform and the bucket phase stage, except (1)
    the equator fold on a bucket stage (the fold combine lives in the
    uniform rotation tables; there are no folded bucket tables), and (2)
    spin 2 at the uniform Nyquist alias point: the real-part doubling
    there is not complex-linear, so it cannot commute with the
    lambda^{+-} pair unpacking that follows the in-kernel rotation.
    """
    kind = "uniform" if grid.uniform else "bucket"
    if fold and kind != "uniform":
        return False, (f"equator fold on a {kind!r} phase stage is not fused "
                       "(staged path)")
    if spin != 0 and kind == "uniform" and grid.max_n_phi == 2 * m_max:
        return False, ("spin-2 at the Nyquist alias point "
                       "(n_phi == 2*m_max) is not fused (staged path)")
    return True, None


def _resolve_grid(grid, l_max, nside, cache_kind="memory", cache_dir=None):
    """Grid spec -> (RingGrid, signature fields); string specs go through
    the geometry cache, keyed on the fields their geometry depends on
    (``gl``/``ecp`` on l_max, the HEALPix family on nside)."""
    if isinstance(grid, RingGrid):
        return grid, {"grid_cos": grid.cos_theta, "grid_nphi": grid.n_phi,
                      "grid_w": grid.weights, "grid_name": grid.name,
                      "grid_phi0": grid.phi0, "grid_uniform": grid.uniform}
    kind = str(grid)
    by_lmax = kind in ("gl", "ecp")
    spec = {"grid_kind": kind, "grid_l_max": l_max if by_lmax else None,
            "grid_nside": None if by_lmax else nside}

    def build():
        g = gridlib.make_grid(kind, l_max=l_max, nside=nside)
        return {"cos_theta": g.cos_theta, "sin_theta": g.sin_theta,
                "weights": g.weights, "n_phi": g.n_phi, "phi0": g.phi0,
                "uniform": np.array(g.uniform),
                "nside": np.array(-1 if g.nside is None else g.nside)}

    p = plancache.get_or_build(plancache.signature_key("geometry", **spec),
                               build, cache=cache_kind, directory=cache_dir)
    g = RingGrid(name=kind, cos_theta=p["cos_theta"],
                 sin_theta=p["sin_theta"], weights=p["weights"],
                 n_phi=p["n_phi"], phi0=p["phi0"], uniform=bool(p["uniform"]),
                 nside=None if int(p["nside"]) < 0 else int(p["nside"]))
    return g, spec


def make_plan(grid: Union[str, RingGrid] = "gl", l_max: Optional[int] = None,
              *, nside: Optional[int] = None, m_max: Optional[int] = None,
              K: int = 1,
              dtype: str = "float64", mode: Optional[str] = None,
              fold: bool = False, spin: int = 0,
              layout: Optional[str] = None, cache: str = "auto",
              cache_dir: Optional[str] = None, device=None,
              n_shards: Optional[int] = None,
              comm_chunks: Union[int, str] = "auto") -> Plan:
    """Build (or fetch) the transform plan for a problem signature.

    grid : ``"gl"``, ``"ecp"``, ``"healpix"``, ``"healpix_ring"`` or a
        prebuilt :class:`RingGrid`.
    l_max, m_max : band limits (``m_max`` defaults to ``l_max``; ``l_max``
        to ``2 nside`` on the HEALPix family, else to ``n_rings - 1`` of a
        prebuilt grid).
    nside : HEALPix resolution (required for the HEALPix family).
    K : number of maps transformed together.
    dtype : ``"float64"`` or ``"float32"``.
    mode : a backend name (``"torch"``, ``"cuda_vpu"``, ``"cuda_mxu"``,
        ``"dist"``);
        ``None``: ``torch`` for float64, else the kernel variant of the
        static ``2K >= 16 -> mxu`` rule (the reference's default is
        ``"auto"``; the port keeps the static rule so that no first plan
        times every corner); ``"model"``: the cost model's fastest backend
        and layout per direction; ``"auto"``: the measured fastest, per
        direction (every candidate corner timed once per hardware, the
        decision cached), among them ``"dist"`` where it is eligible; every
        rank then decides alike (the cost model is pure arithmetic; the
        measured corners take the slowest rank's time).  ``"dist"`` runs
        the distributed transform over the default process group's ranks:
        every rank calls ``make_plan`` and each transform alike; it raises
        without a group of >= 2 ranks, as the reference does with fewer
        than 2 devices.
    fold : the equator fold (symmetric grids only, spin 0 only).
    spin : 0 (scalar) or 2 (polarisation): a spin-2 plan transforms (E, B)
        alm ``(2, M, L, K)`` to/from (Q, U) maps ``(2, R, n_phi, K)``;
        needs ``l_max >= 2``.
    layout : the Legendre layout of a forced ``cuda_*`` backend (or of the
        static default): ``None`` means ``"fused"`` where the plan is
        eligible, else ``"plain"``; ``"plain"`` and ``"packed"`` run the
        staged kernels on the rectangular and the packed slot grid, then
        the phase stage.  The ``torch`` backend takes none, and neither do
        ``"model"`` and ``"auto"``, which choose it.  Both spellings of the
        default give one plan.
    cache : ``"auto"`` (memory; disk when ``cache_dir`` or
        ``$REPRO_TORCH_CACHE_DIR`` is set), ``"memory"``, ``"disk"`` or
        ``"off"``: where the precompute and the autotune decision are kept.
    cache_dir : the disk tier's directory (see ``core.cache.cache_dir``).
    device : ``None`` (the CUDA device, which must be visible), ``"cuda"``,
        ``"cuda:N"`` or ``"cpu"``.  A dist plan's device is its rank's: the
        CPU for a gloo group, the rank's card for a NCCL one.
    n_shards : the dist backend's shard count (default: the process
        group's size, which it must equal to run).
    comm_chunks : the dist backend's exchange chunk count: ``"auto"`` (the
        overlap model's pick, measured against C = 1 under
        ``mode="auto"``) or an int >= 1, forced.

    Calling ``make_plan`` twice with one signature (cache kind and
    directory included) returns the same object.
    """
    if mode is not None and mode not in ("auto", "model") + BACKENDS:
        raise ValueError(f"unknown mode {mode!r}: expected None, 'auto', "
                         f"'model' or a backend name {BACKENDS}")
    if layout not in (None, "plain", "packed", "fused"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout is not None and mode in ("auto", "model"):
        raise ValueError(f"mode {mode!r} chooses the layout per direction; "
                         f"it takes no layout= (got {layout!r})")
    if spin not in (0, 2):
        raise ValueError(f"unsupported spin {spin!r}: expected 0 or 2")
    if spin and fold:
        raise ValueError("fold is not supported for spin transforms")
    if comm_chunks != "auto":
        if isinstance(comm_chunks, bool) or not isinstance(
                comm_chunks, (int, np.integer)) or comm_chunks < 1:
            raise ValueError(f"comm_chunks must be 'auto' or an int >= 1, "
                             f"got {comm_chunks!r}")
        comm_chunks = int(comm_chunks)
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be 'float64' or 'float32', got {dtype!r}")
    if cache == "auto":
        cache_kind = "disk" if (cache_dir or os.environ.get(
            "REPRO_TORCH_CACHE_DIR")) else "memory"
    elif cache in ("off", "memory", "disk"):
        cache_kind = cache
    else:
        raise ValueError(f"unknown cache {cache!r}: expected 'auto', "
                         "'memory', 'disk' or 'off'")
    if isinstance(grid, str):
        if grid in ("gl", "ecp") and l_max is None:
            raise ValueError(f"make_plan({grid!r}, ...) requires l_max")
        if grid in ("healpix", "healpix_ring") and nside is None:
            raise ValueError(f"make_plan({grid!r}, ...) requires nside")
    dev = resolve_device(device)
    g, grid_sig = _resolve_grid(grid, l_max, nside, cache_kind, cache_dir)
    if l_max is None:
        # the HEALPix rule of thumb, as the reference
        l_max = 2 * g.nside if g.nside else g.n_rings - 1
    m_max = l_max if m_max is None else m_max
    if m_max > l_max:
        raise ValueError(f"m_max {m_max} > l_max {l_max}")
    if l_max < spin:
        raise ValueError(f"a spin-{spin} plan needs l_max >= {spin}, got "
                         f"{l_max}")
    if fold and not g.equator_symmetric:
        raise ValueError("fold requires an equator-symmetric grid")
    if mode is None:
        from repro_torch.kernels.ops import pick_variant
        mode = "torch" if dtype == "float64" \
            else "cuda_" + pick_variant(2 * K)
    if mode == "torch":
        if layout is not None:
            raise ValueError(f"layout {layout!r} applies to the cuda_* "
                             "backends, not to 'torch'")
    elif mode in KERNEL_BACKENDS:
        fusion_ok, reason = _fusion_eligibility(g, spin, m_max, fold)
        if layout == "fused" and not fusion_ok:
            raise ValueError(f"fused layout unavailable: {reason}")
        layout = layout or ("fused" if fusion_ok else "plain")

    # the cache policy is part of the key: a plan built with cache="off"
    # must not stand in for a later request to keep its decision on disk
    sig_key = plancache.signature_key(
        "plan", l_max=l_max, m_max=m_max, K=K, dtype=dtype, mode=mode,
        fold=fold, spin=spin, layout=layout, device=str(dev),
        n_shards=n_shards, comm_chunks=comm_chunks,
        cache_kind=cache_kind, cache_dir=cache_dir, **grid_sig)
    if sig_key in _PLANS:
        plancache.stats().memory_hits += 1
        return _PLANS[sig_key]

    seeds_key = plancache.signature_key("seeds", m_max=m_max, fold=fold,
                                        spin=spin, **grid_sig)
    plan = Plan(g, l_max, m_max, K, dtype, mode=mode, fold=fold, spin=spin,
                device=dev, signature_key=sig_key, seeds_key=seeds_key,
                cache_kind=cache_kind, cache_dir=cache_dir,
                n_shards=n_shards, comm_chunks=comm_chunks)
    elig = backend_eligibility(g, dtype, n_shards)
    plan.candidates = [b for b in BACKENDS if elig[b] is None]
    if mode == "dist" and elig["dist"] is not None:
        raise ValueError(f"backend 'dist' unavailable for this signature: "
                         f"{elig['dist']} (candidates: {plan.candidates})")
    if mode in BACKENDS and mode not in plan.candidates:
        # an explicit kernel request under float64 runs in float32 inside
        plan.candidates.append(mode)
        elig[mode] = None
    plan.skipped = {b: r for b, r in elig.items() if r is not None}
    plan._choose_backends(layout)
    _PLANS[sig_key] = plan
    return plan
