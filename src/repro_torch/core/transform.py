"""Transform plans: one entry point for every SHT execution path.

Counterpart of ``repro.core.transform``::

    import repro_torch
    plan = repro_torch.make_plan("gl", l_max=2048, K=8, dtype="float32",
                                 mode="cuda_mxu")
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

Layouts of the kernel backends (``plan.layouts``): ``fused``, the default
where the plan is eligible (``Plan._fusion_eligibility``), runs the fused
Legendre+phase kernels on the packed slot layout (``kernels.fused``), as
the reference's planner does at the sht_cmb shapes; ``plain`` runs the
staged kernels (``kernels.legendre_cuda``) and the phase stage apart;
``packed`` runs the packed staged kernels (two m rows per slot,
``kernels.fused_cuda``'s ``*_packed_*``) and the phase stage apart.
Plans run on the CUDA device unless ``device="cpu"`` is passed.

``alm2map`` and ``map2alm`` are differentiable on every backend and
layout (``plan.grad_ready``): each layer carries an adjoint pair
(``core.autodiff``), so a backward runs the opposite-direction transform
of the same layer, kernels included.  First order only.

What the port does not have yet raises a ``ValueError`` that names the
ROADMAP.md item it waits on; nothing is substituted silently.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import cache as plancache
from repro_torch.core import grids as gridlib
from repro_torch.core import legendre
from repro_torch.core.grids import RingGrid
from repro_torch.core.sht import SHT, alm_mask

__all__ = ["Plan", "make_plan", "available_backends", "backend_eligibility",
           "clear_plan_cache", "BACKENDS"]

BACKENDS = ("torch", "cuda_vpu", "cuda_mxu")

_DTYPES = {"float64": torch.float64, "float32": torch.float32}
_CDTYPES = {"float64": torch.complex128, "float32": torch.complex64}

#: what the reference offers and the port does not yet, with the ROADMAP.md
#: Open items section 1 item each waits on
_WAITING = {
    "mode auto": 9, "mode model": 9, "mode dist": 11, "spin": 7,
}

#: make_plan memoisation: signature key -> Plan
_PLANS: dict[str, "Plan"] = {}


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not ported yet: it waits for ROADMAP.md "
                      f"Open items section 1, item {_WAITING[what]}")


def clear_plan_cache() -> None:
    """Drop memoised plans and the in-memory precompute tier."""
    _PLANS.clear()
    plancache.clear_memory()


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


def backend_eligibility(grid: RingGrid, dtype: str) -> dict[str, Optional[str]]:
    """Why-or-why-not per backend: ``{backend: None | skip_reason}``.

    The kernels compute in float32, so a float64 signature restricts the
    default choice to the ``torch`` oracle.
    """
    out: dict[str, Optional[str]] = {b: None for b in BACKENDS}
    if dtype != "float32":
        reason = (f"kernels compute in float32 (plan dtype {dtype!r}); "
                  "force mode='cuda_*' to accept the precision drop")
        out["cuda_vpu"] = out["cuda_mxu"] = reason
    return out


def available_backends(grid: RingGrid, dtype: str) -> list[str]:
    """Backends eligible for this signature."""
    elig = backend_eligibility(grid, dtype)
    return [b for b in BACKENDS if elig[b] is None]


class Plan:
    """An executable SHT plan: precompute, layout and kernel choice.

    Construct through :func:`make_plan`, which memoises by signature.
    ``backends`` is ``{"synth": name, "anal": name}``; ``layouts`` names
    the Legendre layout per direction for the kernel backends.
    """

    def __init__(self, grid: RingGrid, l_max: int, m_max: int, K: int,
                 dtype: str, *, mode: str, fold: bool, device: torch.device,
                 signature_key: str, seeds_key: str):
        self.grid = grid
        self.l_max = int(l_max)
        self.m_max = int(m_max)
        self.K = int(K)
        self.dtype = str(dtype)
        self.mode = mode
        self.fold = bool(fold)
        self.spin = 0
        self.device = device
        self._signature_key = signature_key
        self._seeds_key = seeds_key
        self._sht = SHT(grid, l_max=self.l_max, m_max=self.m_max,
                        dtype=self.dtype, fold=self.fold)
        self._m_vals = np.arange(self.m_max + 1)
        self._seeds_cache: Optional[tuple] = None
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

    @property
    def phase(self):
        """The plan's FFT/phase stage, shared by every backend."""
        return self._sht.phase

    @property
    def _alm_shape(self) -> tuple:
        return (self.m_max + 1, self.l_max + 1, self.K)

    @property
    def _maps_shape(self) -> tuple:
        return (self.grid.n_rings, self.grid.max_n_phi, self.K)

    # -- precompute (shared by plans on one grid) ------------------------------

    def _seeds(self):
        """(m_vals i32, x f32, pmm f32, pms i32) kernel operands on the
        plan's device; fold plans seed the northern rings only.  The float64
        host build is keyed by (grid, m_max, fold), so plans differing only
        in K, mode, dtype or device share it."""
        if self._seeds_cache is not None:
            return self._seeds_cache
        from repro_torch.kernels import ref as kref
        g = self.grid
        nh = (g.n_rings + 1) // 2
        sin = g.sin_theta[:nh] if self.fold else g.sin_theta
        x = g.cos_theta[:nh] if self.fold else g.cos_theta

        def build():
            pmm, pms = kref.prepare_seeds(self._m_vals, sin,
                                          legendre.log_mu(self.m_max))
            return {"pmm": pmm, "pms": pms}

        payload = plancache.get_or_build(self._seeds_key, build)
        self.cache_events.setdefault("seeds", self._seeds_key)
        dev = self.device
        self._seeds_cache = (
            torch.as_tensor(self._m_vals, dtype=torch.int32, device=dev),
            torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(payload["pmm"], device=dev),
            torch.as_tensor(payload["pms"], device=dev))
        return self._seeds_cache

    # -- per-backend execution ------------------------------------------------

    def _fn(self, direction: str, backend: str, layout: Optional[str]):
        if layout is None:
            layout = self.layouts.get(direction)
        key = (direction, backend, layout)
        if key not in self._fns:
            if backend == "torch":
                fn = (self._sht.alm2map if direction == "synth"
                      else self._sht.map2alm)
            elif backend not in ("cuda_vpu", "cuda_mxu"):
                raise ValueError(f"unknown backend {backend!r}")
            elif layout == "fused":
                ok, reason = self._fusion_eligibility()
                if not ok:
                    raise ValueError(f"fused layout unavailable: {reason}")
                fn = (self._make_fused_synth if direction == "synth"
                      else self._make_fused_anal)(backend[5:])
            elif layout in ("plain", "packed"):
                fn = (self._make_kernel_synth if direction == "synth"
                      else self._make_kernel_anal)(backend[5:], layout)
            else:
                raise ValueError(f"unknown layout {layout!r}")
            self._fns[key] = fn
        return self._fns[key]

    def _synth_fn(self, backend: str, layout: Optional[str] = None):
        """Synthesis callable alm -> maps for ``backend`` (cached);
        ``layout`` overrides the plan's (``"plain"`` | ``"packed"`` |
        ``"fused"``)."""
        return self._fn("synth", backend, layout)

    def _anal_fn(self, backend: str, layout: Optional[str] = None):
        """Analysis callable maps -> alm for ``backend`` (cached);
        ``layout`` as in :meth:`_synth_fn`."""
        return self._fn("anal", backend, layout)

    def _make_kernel_synth(self, variant: str, layout: str):
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

    # -- fused pipeline (layout "fused") --------------------------------------

    def _fusion_eligibility(self) -> tuple:
        """(eligible, reason) for the fused Legendre+phase pipeline.

        See :func:`_fusion_eligibility`.
        """
        return _fusion_eligibility(self.grid, self.spin)

    def _fused_layout(self):
        """The packed slot layout shared by the fused and packed directions:
        ``kernels.ops._resolve_layout``'s, kept in the plan's store under
        ``"layout"``."""
        from repro_torch.kernels import ops as kops
        return kops._resolve_layout(self._m_vals, "packed", self.l_max,
                                    self._fused_store)

    def _fused_parts(self, variant: str):
        """(seeds, keyword block) of the fused kernel chains: the uniform
        phase stage's FFT length and ring offsets, the fold's full ring
        count, and the plan's store of packed seeds, tables and indices."""
        g = self.grid
        m_t, x32, pmm, pms = self._seeds()
        kw = dict(l_max=self.l_max, variant=variant, lo=self._fused_layout(),
                  n=self.phase.n, phi0=g.phi0,
                  fold_rings=g.n_rings if self.fold else None,
                  store=self._fused_store)
        return (x32, pmm, pms), kw

    def _make_fused_synth(self, variant: str):
        from repro_torch.kernels import fused as kfused
        K, rdt = self.K, _DTYPES[self.dtype]
        (x32, pmm, pms), kw = self._fused_parts(variant)

        def fn(alm):
            a32 = torch.cat([alm.real, alm.imag], dim=-1).to(torch.float32)
            maps = kfused.fused_synth(a32, self._m_vals, x32, pmm, pms, **kw)
            return maps.to(rdt)

        return fn

    def _make_fused_anal(self, variant: str):
        from repro_torch.kernels import fused as kfused
        K, cdt = self.K, _CDTYPES[self.dtype]
        (x32, pmm, pms), kw = self._fused_parts(variant)
        mask = torch.as_tensor(alm_mask(self.l_max, self.m_max),
                               device=self.device)[..., None]

        def fn(maps):
            # the quadrature weights are applied outside the kernel chain
            out = kfused.fused_anal(maps, self.grid.weights, self._m_vals,
                                    x32, pmm, pms, **kw)
            alm = torch.complex(out[..., :K], out[..., K:]).to(cdt)
            return torch.where(mask, alm, torch.zeros((), dtype=cdt,
                                                      device=alm.device))

        return fn

    # -- public API -----------------------------------------------------------

    def _as_input(self, v, shape, what: str) -> torch.Tensor:
        t = torch.as_tensor(v, device=self.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} shape {tuple(t.shape)}: plan was built "
                             f"for {shape}")
        return t

    def alm2map(self, alm) -> torch.Tensor:
        """Inverse SHT: alm ``(m_max+1, l_max+1, K)`` complex -> maps
        ``(R, n_phi, K)`` real, on the plan's device."""
        alm = self._as_input(alm, self._alm_shape, "alm")
        return self._synth_fn(self.backends["synth"])(alm)

    def map2alm(self, maps, iters: int = 0) -> torch.Tensor:
        """Direct SHT: maps -> alm.  ``iters > 0`` adds Jacobi residual
        refinement passes (one synthesis and one analysis each)."""
        maps = self._as_input(maps, self._maps_shape, "maps")
        anal = self._anal_fn(self.backends["anal"])
        alm = anal(maps)
        for _ in range(iters):
            alm = alm + anal(maps - self.alm2map(alm))
        return alm

    @property
    def grad_ready(self) -> dict:
        """Per-direction differentiability of the chosen paths:
        ``{"synth": bool, "anal": bool}``, True when autograd flows through
        :meth:`alm2map` / :meth:`map2alm` by the adjoint rules (every
        backend and layout of the port).  First order only."""
        return {d: self.backends.get(d) in BACKENDS
                for d in ("synth", "anal")}

    def memory_footprint(self) -> dict:
        """Estimated working-set bytes per buffer class."""
        g = self.grid
        M, L1, K = self.m_max + 1, self.l_max + 1, self.K
        csize = 16 if self.dtype == "float64" else 8
        rsize = csize // 2
        out = {
            "alm_bytes": M * L1 * K * csize,
            "maps_bytes": g.n_rings * g.max_n_phi * K * rsize,
            "delta_bytes": M * g.n_rings * K * csize,
            "seed_bytes": (2 * M * g.n_rings * 4
                           if any(b.startswith("cuda")
                                  for b in self.backends.values()) else 0),
        }
        out["total_bytes"] = sum(out.values())
        return out

    def describe(self) -> dict:
        """Structured report: signature, chosen kernels, layouts, fusion,
        memory footprint and cache counters."""
        from repro_torch.kernels import pack as kpack
        from repro_torch.kernels.fused import FUSED_LP_SIZE
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
            "candidates": list(self.candidates),
            "skipped": dict(self.skipped),
            # the packed-vs-plain grid accounting of the Legendre stage
            "legendre": {"layouts": layouts,
                         "panels": kpack.panel_counts(self._m_vals,
                                                      self.l_max)},
            "phase": self._sht.phase.describe(),
            "memory": self.memory_footprint(),
            "cache": {"events": dict(self.cache_events),
                      **plancache.stats().to_dict()},
        }

    def report(self) -> str:
        """Human-readable :meth:`describe`."""
        d = self.describe()
        s = d["signature"]
        lines = [
            f"Plan {s['grid']} l_max={s['l_max']} m_max={s['m_max']} "
            f"K={s['K']} {s['dtype']} fold={s['fold']} mode={d['mode']} "
            f"device={d['device']}",
            f"  rings={s['n_rings']} n_phi={s['n_phi']} "
            f"memory ~{d['memory']['total_bytes'] / 1e6:.2f} MB",
        ]
        for direction in ("synth", "anal"):
            chosen = d["backends"].get(direction, "?")
            lay = d["layouts"].get(direction)
            lines.append(f"  {direction:5s} -> {chosen}"
                         + (f"[{lay}]" if lay else ""))
        for b, reason in d["skipped"].items():
            lines.append(f"  skipped {b}: {reason}")
        ev = d["cache"]["events"]
        lines.append(f"  cache: {ev if ev else 'cold'} "
                     f"(mem_hits={d['cache']['memory_hits']} "
                     f"builds={d['cache']['builds']})")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Plan(grid={self.grid.name!r}, l_max={self.l_max}, "
                f"K={self.K}, dtype={self.dtype!r}, device={self.device}, "
                f"backends={self.backends})")


def _fusion_eligibility(grid: RingGrid, spin: int) -> tuple:
    """(eligible, reason) for the fused Legendre+phase pipeline.

    The port's fused kernels cover spin 0 on a uniform phase stage,
    equator fold on or off.  The fused ring-bucket stage waits for
    ROADMAP.md Open items section 1, item 8, and the spin-2 row set for
    item 7.
    """
    if not grid.uniform:
        return False, ("the fused ring-bucket phase stage waits for "
                       "ROADMAP.md Open items section 1, item 8")
    if spin != 0:
        return False, ("the fused spin-2 kernels wait for ROADMAP.md "
                       "Open items section 1, item 7")
    return True, None


def _resolve_grid(grid, l_max):
    """Grid spec -> (RingGrid, signature fields); string specs go through
    the geometry cache."""
    if isinstance(grid, RingGrid):
        return grid, {"grid_cos": grid.cos_theta, "grid_nphi": grid.n_phi,
                      "grid_w": grid.weights, "grid_name": grid.name}
    kind = str(grid)
    spec = {"grid_kind": kind, "grid_l_max": l_max}

    def build():
        g = gridlib.make_grid(kind, l_max=l_max)
        return {"cos_theta": g.cos_theta, "sin_theta": g.sin_theta,
                "weights": g.weights, "n_phi": g.n_phi, "phi0": g.phi0}

    p = plancache.get_or_build(plancache.signature_key("geometry", **spec),
                               build)
    g = RingGrid(name=kind, cos_theta=p["cos_theta"],
                 sin_theta=p["sin_theta"], weights=p["weights"],
                 n_phi=p["n_phi"], phi0=p["phi0"], uniform=True)
    return g, spec


def make_plan(grid: Union[str, RingGrid] = "gl", l_max: Optional[int] = None,
              *, m_max: Optional[int] = None, K: int = 1,
              dtype: str = "float64", mode: Optional[str] = None,
              fold: bool = False, spin: int = 0,
              layout: Optional[str] = None, device=None) -> Plan:
    """Build (or fetch) the transform plan for a problem signature.

    grid : ``"gl"`` or a prebuilt :class:`RingGrid` (other grid families
        wait for ROADMAP.md Open items section 1, item 8).
    l_max, m_max : band limits (``m_max`` defaults to ``l_max``).
    K : number of maps transformed together.
    dtype : ``"float64"`` or ``"float32"``.
    mode : a backend name (``"torch"``, ``"cuda_vpu"``, ``"cuda_mxu"``), or
        ``None``: ``torch`` for float64, else the kernel variant of the
        static ``2K >= 16 -> mxu`` rule.  ``"auto"``/``"model"``/``"dist"``
        raise (not ported yet).
    fold : the equator fold (symmetric grids only).
    layout : the Legendre layout of the ``cuda_*`` backends: ``None`` (the
        default) means ``"fused"`` where the plan is eligible, else
        ``"plain"``; ``"plain"`` and ``"packed"`` run the staged kernels
        on the rectangular and the packed slot grid, then the phase stage.
        The ``torch`` backend takes none.  Both spellings of the default
        give one plan.
    device : ``None`` (the CUDA device, which must be visible), ``"cuda"``,
        ``"cuda:N"`` or ``"cpu"``.

    Calling ``make_plan`` twice with one signature returns the same object.
    """
    if f"mode {mode}" in _WAITING:
        raise _not_ported(f"mode {mode}")
    if mode is not None and mode not in BACKENDS:
        raise ValueError(f"unknown mode {mode!r}: expected None or a backend "
                         f"name {BACKENDS}")
    if layout not in (None, "plain", "packed", "fused"):
        raise ValueError(f"unknown layout {layout!r}")
    if spin != 0:
        raise _not_ported("spin")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be 'float64' or 'float32', got {dtype!r}")
    if isinstance(grid, str) and l_max is None:
        raise ValueError(f"make_plan({grid!r}, ...) requires l_max")
    dev = resolve_device(device)
    g, grid_sig = _resolve_grid(grid, l_max)
    if l_max is None:
        l_max = g.n_rings - 1
    m_max = l_max if m_max is None else m_max
    if m_max > l_max:
        raise ValueError(f"m_max {m_max} > l_max {l_max}")
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
    else:
        fusion_ok, reason = _fusion_eligibility(g, spin)
        if layout == "fused" and not fusion_ok:
            raise ValueError(f"fused layout unavailable: {reason}")
        layout = layout or ("fused" if fusion_ok else "plain")

    sig_key = plancache.signature_key(
        "plan", l_max=l_max, m_max=m_max, K=K, dtype=dtype, mode=mode,
        fold=fold, layout=layout, device=str(dev), **grid_sig)
    if sig_key in _PLANS:
        plancache.stats().memory_hits += 1
        return _PLANS[sig_key]

    seeds_key = plancache.signature_key("seeds", m_max=m_max, fold=fold,
                                        **grid_sig)
    plan = Plan(g, l_max, m_max, K, dtype, mode=mode, fold=fold, device=dev,
                signature_key=sig_key, seeds_key=seeds_key)
    elig = backend_eligibility(g, dtype)
    plan.candidates = [b for b in BACKENDS if elig[b] is None]
    if mode not in plan.candidates:
        # an explicit kernel request under float64 runs in float32 inside
        plan.candidates.append(mode)
        elig[mode] = None
    plan.skipped = {b: r for b, r in elig.items() if r is not None}
    plan.backends = {"synth": mode, "anal": mode}
    plan.layouts = {d: layout for d in ("synth", "anal")}
    _PLANS[sig_key] = plan
    return plan
