"""SHT serving engine: coalesce concurrent transform requests into the K
channel axis, double-buffered against a warm plan pool.

Counterpart of ``repro.serve.serve_loop``.  The batched transform is the
throughput lever (the static rule sends 2K >= 16 to the mxu kernels, which
contract a fat K axis), but production traffic arrives as independent
single-map requests of mixed signatures.  This engine closes that gap:

* requests are grouped by **plan signature** ``(grid, l_max/nside, m_max,
  spin, dtype)`` plus ``(direction, iters)`` -- only transforms that can
  share one device call are mixed;
* within a group, queued requests are **stacked along the K channel axis**
  into power-of-two K buckets so every device step has a dense,
  pre-compiled shape.  The bucket width is capped by ``max_k`` and -- when
  a ``p99_target_s`` is set -- by **roofline admission control**
  (`repro_torch.roofline.admission`): the largest K whose *predicted* batch
  time still fits the latency target, libsharp's performance-model idea
  applied to coalescing;
* across groups, batch formation runs **weighted deficit round-robin**
  (WDRR): every signature group with queued work gets a deficit top-up of
  ``quantum * weight`` K-units per scheduling round and spends it to send
  batches, so one hot tenant can be 10x the traffic of a minority
  signature without starving it (FIFO order is still strict *within* a
  group);
* execution goes through a **warm pool** of plans (`repro_torch.serve.PlanPool`,
  a bounded LRU over ``make_plan`` with compile warm-up), so a recurring
  signature never re-traces;
* each request resolves an :class:`ShtFuture` carrying per-request
  queue/form/compute/total timing; ``engine.stats()`` aggregates latency
  percentiles (p50/p95/p99), coalescing factor, plan-pool hit rate,
  admission caps, and roofline-vs-measured calibration.

Request lifecycle (the state machine ``stats()`` accounts for)::

    submit() --> QUEUED --(batch formation pops)--> IN-FLIGHT
                    |                                   |
                    +--(deadline expired)---------------+--> RETIRED
                                                  (resolved | failed
                                                   | timed out)

``pending`` counts QUEUED + IN-FLIGHT, so ``drain()`` cannot return while
a popped micro-batch is still executing, and ``max_queue`` bounds total
engine *occupancy*, not just the queue.

The engine runs in two modes.  Synchronous: pump ``step()`` / ``drain()``
inline (deterministic -- what most tests use).  Background
(``with engine:`` or ``start()``/``stop()``): **double-buffered
submit->execute** in the spirit of the paper's host/device overlap -- a
formation thread stages batch i+1 (pops requests, resolves the pooled
plan, stacks and uploads the host payload) while the execute thread runs
batch i on the device, with a capacity-one condition-variable handoff
slot between them (no polling sleeps anywhere on the serving path).

On a CUDA device the two halves run on two streams the engine owns: the
formation thread stacks the payload into pinned host memory (torch's
caching host allocator) and uploads it with ``non_blocking=True`` on the
staging stream, recording an event; the execute thread runs the whole
transform (kernels and ``torch.fft``) on the execute stream after waiting
on that event, times it on the host clock up to the stream's
synchronisation, and downloads the result.  On the CPU the payload is
wrapped with ``torch.from_numpy`` and no stream is involved.

Fault containment: the queue is bounded (`submit` raises
:class:`BackpressureError` instead of growing without bound), a request
whose signature cannot build a plan -- or whose payload does not match its
claimed signature -- fails *its own* future only, and a per-request
``timeout`` evicts stale work at batch-formation time so one wedged
client cannot stall the loop.

Results are per-channel equal to independent per-request ``Plan`` calls
of the same backend and layout: the K axis is a batch axis in every
backend (held by tests/test_torch_serve.py on the CPU and by
``chip_smoke.py`` on the card).  Payloads are numpy arrays in and out, as
in the reference.

Departures from the reference: the engine takes the ``device`` it serves
on (``None``: the CUDA device, which must be visible; it never serves on
the CPU unasked), its default ``mode`` is ``None`` (``make_plan``'s static
rule; the reference's is ``"auto"``), admission prices on
``admission.default_model(device)``, and a background warm-up that fails
is recorded in ``stats()["warm_failures"]`` instead of vanishing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import transform
from repro_torch.serve.metrics import Calibration, LatencyWindow
from repro_torch.serve.pool import PlanPool, PlanSig

__all__ = ["ShtEngine", "ShtRequest", "ShtFuture", "BackpressureError",
           "ShtTimeoutError", "InvalidStateError"]


class BackpressureError(RuntimeError):
    """submit() refused: queued + in-flight requests already fill
    ``max_queue``."""


class ShtTimeoutError(TimeoutError):
    """The request exceeded its timeout while queued and was evicted."""


class InvalidStateError(RuntimeError):
    """A future was resolved twice (engine invariant violation)."""


class ShtFuture:
    """Write-once result handle for one submitted transform request.

    ``result(timeout)`` blocks until the engine resolves it (re-raising
    the failure, if any); ``timing`` carries the per-request latency split
    (``queue_s`` / ``compute_s`` / ``total_s``) once done.
    """

    def __init__(self, rid: int):
        self.rid = rid
        self.timing: dict = {}
        self._event = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not resolved "
                               f"within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not resolved "
                               f"within {timeout}s")
        return self._exc

    # -- engine side (write-once) -------------------------------------------

    def _check_unresolved(self) -> None:
        if self._event.is_set():
            raise InvalidStateError(f"future {self.rid} already resolved")

    def _resolve(self, value) -> None:
        self._check_unresolved()
        self._value = value
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._check_unresolved()
        self._exc = exc
        self._event.set()


@dataclasses.dataclass
class ShtRequest:
    """One transform request: a payload plus the plan signature it claims.

    ``payload`` shapes (K axis optional -- a trailing channel axis is
    accepted and split back out; without it the result is unbatched):

    ==========  ======  ===============================
    direction   spin    payload
    ==========  ======  ===============================
    alm2map     0       ``(M, L[, K])`` complex
    alm2map     2       ``(2, M, L[, K])`` complex  (E, B)
    map2alm     0       ``(R, n_phi[, K])`` real
    map2alm     2       ``(2, R, n_phi[, K])`` real (Q, U)
    ==========  ======  ===============================
    """

    direction: str                    # "alm2map" | "map2alm"
    payload: np.ndarray
    grid: str = "gl"
    l_max: Optional[int] = None
    nside: Optional[int] = None
    m_max: Optional[int] = None
    spin: int = 0
    dtype: str = "float64"
    iters: int = 0                    # map2alm Jacobi refinement passes
    timeout: Optional[float] = None   # seconds in queue before eviction
    tag: Optional[str] = None         # caller-side label (not interpreted)

    def signature(self) -> PlanSig:
        return PlanSig(grid=self.grid, l_max=self.l_max, nside=self.nside,
                       m_max=self.m_max, spin=self.spin, dtype=self.dtype)


@dataclasses.dataclass
class _Pending:
    """Queue entry: a validated request plus its engine bookkeeping."""

    request: ShtRequest
    future: ShtFuture
    seq: int
    payload: np.ndarray               # K axis always explicit
    k: int
    squeeze: bool                     # drop the K axis from the result
    t_submit: float
    deadline: Optional[float]
    state: str = "queued"             # queued -> in_flight -> retired


@dataclasses.dataclass
class _Staged:
    """A formed micro-batch, host side done: the unit the formation
    thread hands to the execute thread through the double-buffer slot."""

    gkey: tuple                       # (PlanSig, direction, iters)
    plan: object
    good: list                        # _Pending entries riding this batch
    dev: torch.Tensor                 # stacked device payload (K = k_plan)
    k_total: int
    k_plan: int
    form_s: float                     # host-side staging wall time
    predicted_s: Optional[float]      # admission model's batch estimate
    ready: Optional[object] = None    # CUDA event: the upload has landed


class _HandoffSlot:
    """Capacity-one staging slot between formation and execution: the
    double buffer.  ``put`` blocks while the previous staged batch has
    not been taken; ``take`` blocks until a batch arrives (or the slot is
    closed *and* empty, returning None).  Pure condition-variable
    handoff -- no polling."""

    def __init__(self):
        self._cv = threading.Condition()
        self._item = None
        self._closed = False

    def put(self, item) -> bool:
        with self._cv:
            while self._item is not None and not self._closed:
                self._cv.wait()
            if self._closed:
                return False
            self._item = item
            self._cv.notify_all()
            return True

    def take(self):
        with self._cv:
            while self._item is None and not self._closed:
                self._cv.wait()
            item, self._item = self._item, None
            self._cv.notify_all()
            return item

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


def _pow2_floor(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def _normalize_payload(req: ShtRequest) -> tuple[np.ndarray, int, bool]:
    """Coerce the payload to an explicit trailing-K layout; returns
    ``(array, K, squeeze)``.  Raises ValueError on malformed requests --
    the cheap checks run at submit() so obviously-bad requests never
    occupy queue slots."""
    if req.direction not in ("alm2map", "map2alm"):
        raise ValueError(f"unknown direction {req.direction!r}")
    if req.spin not in (0, 2):
        raise ValueError(f"unsupported spin {req.spin!r}")
    if req.dtype not in ("float64", "float32"):
        raise ValueError(f"unsupported dtype {req.dtype!r}")
    if not isinstance(req.grid, str):
        raise ValueError("serving requests take string grid specs "
                         f"(got {type(req.grid).__name__})")
    if req.iters < 0:
        raise ValueError(f"iters must be >= 0 (got {req.iters})")
    arr = np.asarray(req.payload)
    base_ndim = 2 + (1 if req.spin else 0)
    if arr.ndim == base_ndim:
        arr, k, squeeze = arr[..., None], 1, True
    elif arr.ndim == base_ndim + 1:
        k, squeeze = int(arr.shape[-1]), False
        if k < 1:
            raise ValueError(f"empty K axis in payload shape {arr.shape}")
    else:
        raise ValueError(
            f"payload ndim {arr.ndim} does not match a spin-{req.spin} "
            f"{req.direction} request (expected {base_ndim} or "
            f"{base_ndim + 1} dims)")
    want_complex = req.direction == "alm2map"
    if want_complex != np.iscomplexobj(arr):
        kind = "complex alm" if want_complex else "real maps"
        raise ValueError(f"{req.direction} payload must be {kind} "
                         f"(got dtype {arr.dtype})")
    return arr, k, squeeze


class ShtEngine:
    """Many-map SHT serving engine (see module docstring).

    Parameters
    ----------
    max_k : maximum maps coalesced into one device micro-batch.  Clamped
        to the largest power of two <= the requested value (K buckets are
        power-of-two by contract -- a non-power-of-two cap would fragment
        the plan-pool key space); the raw value stays visible as
        ``requested_max_k``.
    max_queue : bounded engine occupancy (queued **plus** in-flight
        requests); ``submit`` raises :class:`BackpressureError` beyond it.
    pool_capacity : live plans kept warm (LRU; evictions release the plan
        through ``transform.drop_plan``).
    mode / cache / cache_dir : forwarded to ``make_plan`` for every pooled
        plan (``None``, the default: the static rule, ``torch`` in float64
        and the kernels in float32; ``"torch"`` gives deterministic f64
        serving; ``"auto"`` autotunes per signature, decision cached).
    device : where the pooled plans run: ``None`` (the CUDA device, which
        must be visible), ``"cuda"``, ``"cuda:N"`` or ``"cpu"``.
    default_timeout : per-request queue timeout (seconds) used when a
        request does not set its own; None = never evict.
    warm_after : after a signature has been submitted this many times,
        pre-compile its full-width plan in a background thread so the
        steady state never re-traces.  None disables auto warm-up.
    p99_target_s : tail-latency target driving roofline admission control
        (`repro_torch.roofline.admission`): per serving group, the coalesced K
        bucket is capped at the widest power-of-two K whose predicted
        batch time fits the target with ``admission_slack`` headroom.
        None (default) disables admission control (``max_k`` rules).
    admission_slack : pipeline slack factor for the admission test
        (default 2.0: a request waits behind at most one in-flight batch
        under double buffering).
    weights : optional ``{PlanSig.label(): weight}`` map for WDRR batch
        formation; unlisted signatures weigh 1.0.  A weight-w group earns
        ``w * quantum_k`` K-units of deficit per scheduling round.
    quantum_k : WDRR round quantum in K-units (default: the effective
        ``max_k``, so a weight-1 group can send one full batch per round).
    """

    #: WDRR weights below this are clamped (a zero weight would never
    #: accumulate deficit and starve the group forever)
    MIN_WEIGHT = 1.0 / 64.0

    def __init__(self, *, max_k: int = 8, max_queue: int = 128,
                 pool_capacity: int = 8, mode: Optional[str] = None,
                 cache: str = "auto", cache_dir: Optional[str] = None,
                 device=None,
                 default_timeout: Optional[float] = None,
                 warm_after: Optional[int] = None,
                 latency_window: int = 4096,
                 p99_target_s: Optional[float] = None,
                 admission_slack: float = 2.0,
                 weights: Optional[dict] = None,
                 quantum_k: Optional[float] = None):
        if max_k < 1 or max_queue < 1:
            raise ValueError(f"max_k and max_queue must be >= 1 (got "
                             f"{max_k}, {max_queue})")
        self.requested_max_k = int(max_k)
        self.max_k = _pow2_floor(int(max_k))
        self.max_queue = int(max_queue)
        self.default_timeout = default_timeout
        self.warm_after = warm_after
        self.p99_target_s = p99_target_s
        self.admission_slack = float(admission_slack)
        self.weights = {str(k): max(float(v), self.MIN_WEIGHT)
                        for k, v in (weights or {}).items()}
        self.quantum_k = float(quantum_k if quantum_k is not None
                               else self.max_k)
        if not self.quantum_k > 0.0:
            raise ValueError(f"quantum_k must be > 0, got {self.quantum_k}")
        self.pool = PlanPool(pool_capacity, mode=mode, cache=cache,
                             cache_dir=cache_dir, device=device)
        self.device = self.pool.device
        # the double buffer's two streams (CUDA only): uploads, transforms
        cuda = self.device.type == "cuda"
        self._stage_stream = torch.cuda.Stream(self.device) if cuda else None
        self._exec_stream = torch.cuda.Stream(self.device) if cuda else None

        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)   # new/expired work
        self._idle = threading.Condition(self._lock)   # a request retired
        self._groups: dict = {}             # group key -> deque[_Pending]
        self._rr: deque = deque()           # WDRR ring: non-empty groups
        self._deficit: dict = {}            # group key -> K-units earned
        self._admission: dict = {}          # group key -> admission dict
        self._n_queued = 0                  # O(1) occupancy counters --
        self._n_in_flight = 0               # consistent under self._lock
        self._seq = 0
        self._closed = False
        self._stop = False
        self._form_thread: Optional[threading.Thread] = None
        self._exec_thread: Optional[threading.Thread] = None
        self._slot: Optional[_HandoffSlot] = None

        # -- observability ----------------------------------------------------
        self._lat_queue = LatencyWindow(latency_window)
        self._lat_compute = LatencyWindow(latency_window)
        self._lat_total = LatencyWindow(latency_window)
        self._calib = Calibration()
        self.batch_log: list[dict] = []     # bounded, most recent first out
        self._batch_log_cap = latency_window
        self._n_submitted = 0
        self._n_completed = 0
        self._n_failed = 0
        self._n_timed_out = 0
        self._n_batches = 0
        self._sum_batch_requests = 0
        self._sum_batch_k = 0
        self._sum_batch_k_plan = 0
        self._sig_counts: dict[PlanSig, int] = {}
        self._warm_started: set[PlanSig] = set()
        self._warm_threads: list[threading.Thread] = []
        self._warm_failures: list[str] = []
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None

    # -- submission -----------------------------------------------------------

    def _k_bucket(self, k: int) -> int:
        """Smallest power-of-two channel width >= k, capped at the
        (power-of-two) ``max_k`` -- the set of K shapes plans are ever
        compiled for."""
        b = 1
        while b < min(k, self.max_k):
            b *= 2
        return min(b, self.max_k)

    @property
    def pending(self) -> int:
        """Requests the engine still owes an answer for: queued plus
        in-flight (popped into a micro-batch but not yet retired)."""
        with self._lock:
            return self._n_queued + self._n_in_flight

    @staticmethod
    def _group_label(gkey) -> str:
        sig, direction, iters = gkey
        lbl = f"{sig.label()}/{direction}"
        return lbl if not iters else f"{lbl}/iters{iters}"

    def _weight(self, gkey) -> float:
        return self.weights.get(gkey[0].label(), 1.0)

    def _admission_for(self, request: ShtRequest) -> Optional[dict]:
        """Roofline admission verdict for this request's serving group
        (None when the signature cannot even resolve a geometry -- the
        plan failure will surface on its own batch instead)."""
        from repro_torch.roofline import admission
        sig = request.signature()
        cache_kind = self.pool.cache
        if cache_kind == "auto":
            cache_kind = "disk" if (self.pool.cache_dir or os.environ.get(
                "REPRO_TORCH_CACHE_DIR")) else "memory"
        try:
            g, _ = transform._resolve_grid(sig.grid, sig.l_max, sig.nside,
                                           cache_kind, self.pool.cache_dir)
        except Exception:
            return None
        backend, hw = admission.default_model(self.device)
        l_max = sig.l_max if sig.l_max is not None else \
            (2 * g.nside if g.nside else g.n_rings - 1)
        return admission.k_caps_for_target(
            l_max=l_max, m_max=sig.m_max, n_rings=g.n_rings,
            n_phi=g.max_n_phi, max_k=self.max_k,
            p99_target_s=self.p99_target_s,
            direction="synth" if request.direction == "alm2map" else "anal",
            iters=request.iters, spin=sig.spin,
            fft_lengths=None if g.uniform else g.n_phi,
            backend=backend, hw=hw, slack=self.admission_slack)

    def submit(self, request: Optional[ShtRequest] = None,
               **kw) -> ShtFuture:
        """Enqueue one transform request; returns its :class:`ShtFuture`.

        Pass a prebuilt :class:`ShtRequest` or its fields as keywords
        (``engine.submit(direction="alm2map", payload=alm, grid="gl",
        l_max=64)``).  Raises ValueError on malformed requests and
        :class:`BackpressureError` when queued + in-flight requests
        already fill ``max_queue``.
        """
        if request is None:
            request = ShtRequest(**kw)
        elif kw:
            raise TypeError("pass either a request object or keywords")
        payload, k, squeeze = _normalize_payload(request)
        if k > self.max_k:
            raise ValueError(
                f"request K={k} exceeds the engine's max_k={self.max_k}"
                f" (requested_max_k={self.requested_max_k}, clamped to a "
                "power of two); split the batch or build a wider engine")
        timeout = request.timeout if request.timeout is not None \
            else self.default_timeout
        gkey = (request.signature(), request.direction, request.iters)
        adm = None
        if self.p99_target_s is not None and gkey not in self._admission:
            adm = self._admission_for(request)     # geometry work: no lock
        now = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            occupancy = self._n_queued + self._n_in_flight
            if occupancy >= self.max_queue:
                raise BackpressureError(
                    f"engine full ({occupancy}/{self.max_queue} queued + "
                    "in-flight); drain or raise max_queue")
            if adm is not None and gkey not in self._admission:
                self._admission[gkey] = adm
            fut = ShtFuture(rid=self._seq)
            p = _Pending(request=request, future=fut, seq=self._seq,
                         payload=payload, k=k, squeeze=squeeze,
                         t_submit=now,
                         deadline=None if timeout is None else now + timeout)
            self._seq += 1
            self._n_submitted += 1
            self._n_queued += 1
            if self._t_first_submit is None:
                self._t_first_submit = now
            q = self._groups.setdefault(gkey, deque())
            if not q:
                self._rr.append(gkey)              # group (re)enters WDRR
            q.append(p)
            sig = gkey[0]
            self._sig_counts[sig] = self._sig_counts.get(sig, 0) + 1
            warm = (self.warm_after is not None
                    and self._sig_counts[sig] == self.warm_after
                    and sig not in self._warm_started)
            if warm:
                self._warm_started.add(sig)
            self._work.notify_all()
        if warm:
            self._spawn_warm(sig, self.max_k)
        return fut

    def _spawn_warm(self, sig: PlanSig, k: int) -> threading.Thread:
        t = threading.Thread(target=self._warm_quietly, args=(sig, k),
                             name=f"sht-warm-{sig.label()}", daemon=True)
        with self._lock:
            self._warm_threads.append(t)
        t.start()
        return t

    def _join_warmups(self) -> None:
        """Wait out in-flight background warm-ups (a compile racing
        interpreter shutdown aborts the process)."""
        with self._lock:
            threads, self._warm_threads = self._warm_threads, []
        for t in threads:
            t.join()

    def _warm_quietly(self, sig: PlanSig, k: int) -> None:
        try:
            self.pool.warm(sig, self._k_bucket(k))
        except Exception as e:
            # a bad signature fails loudly on its own batch; the warm-up's
            # failure is kept for stats() (and pool warmups stays short)
            with self._lock:
                self._warm_failures.append(f"{sig.label()} K={k}: {e!r}")

    def prewarm(self, *, k: Optional[int] = None, background: bool = False,
                **sig_fields):
        """Warm the pool for a signature before traffic arrives.

        ``sig_fields`` are :class:`PlanSig` fields (grid, l_max, nside,
        m_max, spin, dtype); ``k`` defaults to the engine's full ``max_k``
        width.  ``background=True`` returns the started thread instead of
        blocking."""
        sig = PlanSig(**sig_fields)
        k_plan = self._k_bucket(k if k is not None else self.max_k)
        if background:
            return self._spawn_warm(sig, k_plan)
        return self.pool.warm(sig, k_plan)

    # -- batch formation -------------------------------------------------------

    def _take_locked(self, p: _Pending) -> None:
        """queued -> in-flight (caller holds the lock)."""
        assert p.state == "queued", p.state
        p.state = "in_flight"
        self._n_queued -= 1
        self._n_in_flight += 1

    def _drop_group_locked(self, gkey) -> None:
        if gkey in self._rr:
            self._rr.remove(gkey)
        self._deficit.pop(gkey, None)

    def _evict_expired_locked(self, now: float) -> list[_Pending]:
        out = []
        for gkey, q in list(self._groups.items()):
            if not any(p.deadline is not None and p.deadline < now
                       for p in q):
                continue
            keep: deque = deque()
            for p in q:
                if p.deadline is not None and p.deadline < now:
                    self._take_locked(p)
                    out.append(p)
                else:
                    keep.append(p)
            self._groups[gkey] = keep
            if not keep:
                self._drop_group_locked(gkey)
        return out

    def _k_cap_locked(self, gkey) -> int:
        adm = self._admission.get(gkey)
        if adm is None:
            return self.max_k
        return min(self.max_k, int(adm["k_cap"]))

    def _pop_batch_locked(self):
        """WDRR batch formation: visit signature groups round-robin; each
        visit tops the group's deficit up by ``quantum_k * weight`` and
        the group spends deficit, one K-unit per map, to send requests --
        in strict FIFO order within the group, up to the admission-
        controlled K cap per batch.  A hot tenant that exhausts its
        deficit hands the rest of the round to the others; an oversized
        single request (k > cap) still ships alone once its deficit
        covers it, so admission caps coalescing, never service."""
        passes = 0
        while self._rr:
            gkey = self._rr[0]
            q = self._groups.get(gkey)
            if not q:                              # lazily prune emptied
                self._rr.popleft()
                self._deficit.pop(gkey, None)
                continue
            self._deficit[gkey] = (self._deficit.get(gkey, 0.0)
                                   + self.quantum_k * self._weight(gkey))
            cap = self._k_cap_locked(gkey)
            force = passes > 64 * len(self._rr) + 1   # safety: never wedge
            batch, k_sum = [], 0
            while q:
                nk = q[0].k
                if batch and k_sum + nk > cap:
                    break                          # bucket full
                if k_sum + nk > self._deficit[gkey] and not force:
                    break                          # deficit spent
                p = q.popleft()
                self._take_locked(p)
                batch.append(p)
                k_sum += nk
            if batch:
                self._deficit[gkey] -= k_sum
                self._rr.rotate(-1)                # next round: next group
                if not q:
                    self._drop_group_locked(gkey)
                return gkey, batch
            self._rr.rotate(-1)
            passes += 1
        return None, []

    def _form_once(self):
        """Evict expired requests and stage one micro-batch (host side:
        pop, plan lookup, validation, payload stacking + upload).
        Returns ``(staged_or_None, n_retired_during_formation)``."""
        now = time.perf_counter()
        with self._lock:
            expired = self._evict_expired_locked(now)
            gkey, batch = self._pop_batch_locked()
        n = 0
        for p in expired:
            waited = now - p.t_submit
            self._retire(p, exc=ShtTimeoutError(
                f"request {p.future.rid} evicted after {waited:.3f}s in "
                f"queue (timeout)"), kind="timeout",
                timing={"queue_s": waited, "compute_s": 0.0,
                        "total_s": waited})
            n += 1
        if not batch:
            return None, n
        staged, n_failed = self._stage(gkey, batch)
        return staged, n + n_failed

    def _stage(self, gkey, batch: list[_Pending]):
        """Host-side half of a micro-batch: resolve the pooled plan,
        validate each payload against it, stack along K and upload.
        Returns ``(staged_or_None, n_retired)``."""
        sig, direction, iters = gkey
        t_form = time.perf_counter()
        k_claim = sum(p.k for p in batch)
        k_plan = self._k_bucket(k_claim)

        try:
            plan = self.pool.get(sig, k_plan)
        except Exception as e:
            for p in batch:
                self._retire(p, exc=e, kind="failed",
                             timing={"queue_s": t_form - p.t_submit})
            self._log_batch(sig, direction, batch, k_claim, k_plan, ok=False)
            return None, len(batch)

        # per-request shape validation against the *resolved* plan: a
        # payload that lied about its signature fails alone, not its batch
        base = (plan._alm_shape if direction == "alm2map"
                else plan._maps_shape)[:-1]
        good, k_total = [], 0
        for p in batch:
            if p.payload.shape[:-1] != base:
                self._retire(p, exc=ValueError(
                    f"payload shape {p.payload.shape} does not match plan "
                    f"{sig.label()} (expected {base} + (K,))"),
                    kind="failed",
                    timing={"queue_s": t_form - p.t_submit})
            else:
                good.append(p)
                k_total += p.k
        if not good:
            self._log_batch(sig, direction, batch, 0, k_plan, ok=False)
            return None, len(batch)

        cdtype = np.complex128 if sig.dtype == "float64" else np.complex64
        rdtype = np.dtype(sig.dtype)
        want = cdtype if direction == "alm2map" else rdtype
        parts = [np.ascontiguousarray(p.payload, dtype=want) for p in good]
        if k_total < plan.K:                       # dense K bucket: zero-pad
            parts.append(np.zeros(base + (plan.K - k_total,), dtype=want))
        dev, ready = self._upload(parts, base + (plan.K,), want)

        adm = self._admission.get(gkey)
        predicted = None
        if adm is not None:
            predicted = adm["predicted_s_by_k"].get(k_plan)
        staged = _Staged(gkey=gkey, plan=plan, good=good, dev=dev,
                         k_total=k_total, k_plan=k_plan,
                         form_s=time.perf_counter() - t_form,
                         predicted_s=predicted, ready=ready)
        return staged, len(batch) - len(good)

    def _upload(self, parts: list, shape: tuple, dtype) -> tuple:
        """Stack ``parts`` along K into one tensor on the engine's device:
        ``(tensor, None)`` on the CPU; on CUDA, stacked straight into a
        pinned buffer of torch's caching host allocator and copied without
        blocking on the staging stream, ``(tensor, event)`` with the
        event recorded after the copy."""
        if self._stage_stream is None:
            return torch.from_numpy(np.concatenate(parts, axis=-1)), None
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        pinned = torch.empty(shape, dtype=tdtype, pin_memory=True)
        np.concatenate(parts, axis=-1, out=pinned.numpy())
        with torch.cuda.stream(self._stage_stream):
            dev = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stage_stream)
        return dev, ready

    # -- execution ------------------------------------------------------------

    def _retire(self, p: _Pending, *, result=None, exc=None, kind: str,
                timing: Optional[dict] = None) -> None:
        p.future.timing = dict(timing or {})
        if exc is not None:
            p.future._fail(exc)
        else:
            p.future._resolve(result)
        with self._lock:
            if p.state == "queued":
                self._n_queued -= 1
            elif p.state == "in_flight":
                self._n_in_flight -= 1
            p.state = "retired"
            if kind == "ok":
                self._n_completed += 1
            elif kind == "timeout":
                self._n_timed_out += 1
            else:
                self._n_failed += 1
            t = timing or {}
            if "queue_s" in t:
                self._lat_queue.record(t["queue_s"])
            if kind == "ok":
                self._lat_compute.record(t.get("compute_s", 0.0))
                self._lat_total.record(t.get("total_s", 0.0))
            self._t_last_done = time.perf_counter()
            self._idle.notify_all()

    def _log_batch(self, sig: PlanSig, direction: str, batch, k_total: int,
                   k_plan: int, ok: bool) -> None:
        with self._lock:
            self._n_batches += 1
            self._sum_batch_requests += len(batch)
            self._sum_batch_k += k_total
            self._sum_batch_k_plan += k_plan
            self.batch_log.append({
                "signature": sig.label(), "direction": direction,
                "rids": [p.future.rid for p in batch],
                "n_requests": len(batch), "k_total": k_total,
                "k_plan": k_plan, "ok": ok,
            })
            if len(self.batch_log) > self._batch_log_cap:
                del self.batch_log[: len(self.batch_log)
                                   - self._batch_log_cap]

    def _execute_staged(self, staged: _Staged) -> int:
        """Device half of a micro-batch: run the transform, scatter the
        K slices back to their futures.  Returns requests retired.  On
        CUDA the transform runs on the execute stream, after the staged
        upload's event; ``compute_s`` ends at that stream's
        synchronisation."""
        sig, direction, iters = staged.gkey
        plan, good = staged.plan, staged.good
        stream = self._exec_stream
        t_start = time.perf_counter()
        with (contextlib.nullcontext() if stream is None
              else torch.cuda.stream(stream)):
            try:
                if staged.ready is not None:
                    stream.wait_event(staged.ready)
                    staged.dev.record_stream(stream)
                if direction == "alm2map":
                    out = plan.alm2map(staged.dev)
                else:
                    out = plan.map2alm(staged.dev, iters=iters)
                if stream is not None:
                    stream.synchronize()
            except Exception as e:
                for p in good:
                    self._retire(p, exc=e, kind="failed",
                                 timing={"queue_s": t_start - p.t_submit})
                self._log_batch(sig, direction, good, staged.k_total,
                                staged.k_plan, ok=False)
                return len(good)
            t_done = time.perf_counter()
            compute_s = t_done - t_start
            if staged.predicted_s is not None:
                with self._lock:
                    self._calib.record(staged.predicted_s, compute_s)
            out = out.cpu().numpy()
        off = 0
        for p in good:
            res = out[..., off:off + p.k]
            off += p.k
            if p.squeeze:
                res = res[..., 0]
            self._retire(p, result=res, kind="ok", timing={
                "queue_s": t_start - p.t_submit,
                "form_s": staged.form_s,
                "compute_s": compute_s,
                "total_s": t_done - p.t_submit,
                "k_plan": staged.k_plan,
                "coalesced_with": len(good) - 1,
            })
        self._log_batch(sig, direction, good, staged.k_total, staged.k_plan,
                        ok=True)
        return len(good)

    # -- synchronous serving ---------------------------------------------------

    def step(self) -> int:
        """Process one coalesced micro-batch inline (plus any timeout
        evictions).  Synchronous mode only -- with the background threads
        running, submit and ``drain()`` instead.

        Returns the number of requests retired (resolved, failed or
        evicted); 0 means the queue was empty.
        """
        staged, n = self._form_once()
        if staged is not None:
            n += self._execute_staged(staged)
        return n

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every pending request -- queued *and* in-flight --
        is retired.

        Synchronous mode pumps ``step()`` inline; with the background
        threads running it waits on the retirement condition variable (no
        polling).  Raises TimeoutError if requests are still pending
        after ``timeout`` seconds.
        """
        deadline = None if timeout is None else time.perf_counter() + timeout
        background = self._form_thread is not None
        while True:
            with self._lock:
                left = self._n_queued + self._n_in_flight
                if left == 0:
                    break
                if deadline is not None and time.perf_counter() > deadline:
                    raise TimeoutError(f"drain: {left} request(s) "
                                       f"still pending after {timeout}s")
                if background:
                    wait = 0.1 if deadline is None else \
                        max(0.0, min(0.1, deadline - time.perf_counter()))
                    self._idle.wait(wait)
                    continue
            self.step()
        self._join_warmups()

    # -- background serving: double-buffered formation -> execution -----------

    def start(self) -> "ShtEngine":
        """Start the double-buffered serving threads (idempotent): a
        formation thread stages batch i+1 while the execute thread runs
        batch i on the device."""
        with self._lock:
            if self._form_thread is not None:
                return self
            self._stop = False
            self._slot = _HandoffSlot()
            self._form_thread = threading.Thread(
                target=self._formation_loop, name="sht-serve-form",
                daemon=True)
            self._exec_thread = threading.Thread(
                target=self._execute_loop, name="sht-serve-exec",
                daemon=True)
        self._form_thread.start()
        self._exec_thread.start()
        return self

    def _formation_loop(self) -> None:
        while True:
            with self._work:
                while not self._stop and self._n_queued == 0:
                    self._work.wait(timeout=0.1)
                if self._stop:
                    return
            staged, _ = self._form_once()
            if staged is not None and not self._slot.put(staged):
                # slot closed mid-handoff (stop raced us): never strand
                # an in-flight batch -- run it here instead
                self._execute_staged(staged)

    def _execute_loop(self) -> None:
        while True:
            staged = self._slot.take()
            if staged is None:                     # closed and flushed
                return
            self._execute_staged(staged)

    def stop(self, drain: bool = True) -> None:
        """Stop the background threads; ``drain=True`` (default) retires
        the remaining queue synchronously first.  The in-flight staged
        batch (if any) always executes -- stopping never strands a popped
        request."""
        ft, et = self._form_thread, self._exec_thread
        if ft is not None:
            with self._work:
                self._stop = True
                self._work.notify_all()
            ft.join()
            self._slot.close()                     # executor flushes + exits
            et.join()
            self._form_thread = self._exec_thread = None
            self._slot = None
        if drain:
            while self.pending:
                self.step()
        self._join_warmups()

    def close(self) -> None:
        """Stop serving and refuse further submissions; queued requests
        fail with RuntimeError (in-flight batches still complete)."""
        self.stop(drain=False)
        with self._lock:
            self._closed = True
            leftovers = [p for q in self._groups.values() for p in q]
            self._groups.clear()
            self._rr.clear()
            self._deficit.clear()
        for p in leftovers:
            self._retire(p, exc=RuntimeError("engine closed"), kind="failed",
                         timing={})

    def __enter__(self) -> "ShtEngine":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop(drain=True)

    # -- observability ---------------------------------------------------------

    def describe(self) -> dict:
        """Structured engine configuration: coalescing caps, admission
        policy, fairness policy, pool settings, pipeline state.  The
        static complement of :meth:`stats`."""
        with self._lock:
            admission = {
                "p99_target_s": self.p99_target_s,
                "slack": self.admission_slack,
                "groups": {self._group_label(g): {
                    "k_cap": a["k_cap"], "feasible": a["feasible"],
                    "predicted_s": a["predicted_s"], "backend": a["backend"],
                } for g, a in self._admission.items()},
            }
            return {
                "max_k": self.max_k,
                "requested_max_k": self.requested_max_k,
                "max_queue": self.max_queue,
                "default_timeout": self.default_timeout,
                "warm_after": self.warm_after,
                "states": ("queued", "in_flight", "retired"),
                "admission": admission,
                "fairness": {"policy": "wdrr",
                             "quantum_k": self.quantum_k,
                             "weights": dict(self.weights)},
                "pipeline": {
                    "double_buffered": self._form_thread is not None,
                    "threads": [t.name for t in (self._form_thread,
                                                 self._exec_thread) if t],
                },
                "pool": {"capacity": self.pool.capacity,
                         "mode": self.pool.mode, "cache": self.pool.cache,
                         "cache_dir": self.pool.cache_dir,
                         "device": str(self.device)},
            }

    def stats(self) -> dict:
        """Structured serving metrics: request counters (queued /
        in-flight / retired states), latency percentiles (seconds),
        coalescing factors, admission caps + model calibration, WDRR
        deficits, plan-pool counters, background warm-up failures and
        sustained throughput."""
        with self._lock:
            nb = self._n_batches
            elapsed = None
            if self._t_first_submit is not None \
                    and self._t_last_done is not None:
                elapsed = self._t_last_done - self._t_first_submit
            return {
                "requests": {
                    "submitted": self._n_submitted,
                    "completed": self._n_completed,
                    "failed": self._n_failed,
                    "timed_out": self._n_timed_out,
                    "queued": self._n_queued,
                    "in_flight": self._n_in_flight,
                    "pending": self._n_queued + self._n_in_flight,
                },
                "latency": {
                    "queue": self._lat_queue.summary(),
                    "compute": self._lat_compute.summary(),
                    "total": self._lat_total.summary(),
                },
                "coalescing": {
                    "batches": nb,
                    "requests_per_batch":
                        (self._sum_batch_requests / nb) if nb
                        else float("nan"),
                    "k_per_batch":
                        (self._sum_batch_k / nb) if nb else float("nan"),
                    "k_occupancy":
                        (self._sum_batch_k / self._sum_batch_k_plan)
                        if self._sum_batch_k_plan else float("nan"),
                },
                "admission": {
                    "p99_target_s": self.p99_target_s,
                    "slack": self.admission_slack,
                    "groups": {self._group_label(g): {
                        "k_cap": a["k_cap"], "feasible": a["feasible"],
                        "predicted_s": a["predicted_s"],
                    } for g, a in self._admission.items()},
                    "calibration": self._calib.summary(),
                },
                "fairness": {
                    "policy": "wdrr",
                    "quantum_k": self.quantum_k,
                    "weights": dict(self.weights),
                    "deficits": {self._group_label(g): d
                                 for g, d in self._deficit.items()},
                },
                "pool": self.pool.stats(),
                "warm_failures": list(self._warm_failures),
                "signatures": {s.label(): c
                               for s, c in self._sig_counts.items()},
                "throughput_rps":
                    (self._n_completed / elapsed)
                    if elapsed and elapsed > 0 else float("nan"),
            }

    def report(self) -> str:
        """Human-readable ``stats()`` (the serving analogue of
        ``Plan.report()``)."""
        s = self.stats()
        r, lat, co, pool = (s["requests"], s["latency"], s["coalescing"],
                            s["pool"])

        def ms(x):
            return f"{x * 1e3:.2f}ms" if np.isfinite(x) else "n/a"

        lines = [
            f"ShtEngine max_k={self.max_k} queue={r['pending']}/"
            f"{self.max_queue} pool={pool['size']}/{pool['capacity']} "
            f"(hit_rate {pool['hit_rate']:.2f})"
            if np.isfinite(pool["hit_rate"]) else
            f"ShtEngine max_k={self.max_k} queue={r['pending']}/"
            f"{self.max_queue} pool={pool['size']}/{pool['capacity']}",
            f"  requests: {r['completed']} done / {r['failed']} failed / "
            f"{r['timed_out']} timed out "
            f"(throughput {s['throughput_rps']:.1f} req/s)"
            if np.isfinite(s["throughput_rps"]) else
            f"  requests: {r['completed']} done / {r['failed']} failed / "
            f"{r['timed_out']} timed out",
            f"  latency total p50={ms(lat['total']['p50_s'])} "
            f"p95={ms(lat['total']['p95_s'])} "
            f"p99={ms(lat['total']['p99_s'])} "
            f"(queue p50={ms(lat['queue']['p50_s'])}, "
            f"compute p50={ms(lat['compute']['p50_s'])})",
        ]
        if s["coalescing"]["batches"]:
            lines.append(
                f"  coalescing: x{co['requests_per_batch']:.2f} req/batch, "
                f"K {co['k_per_batch']:.2f} "
                f"(occupancy {co['k_occupancy']:.2f}) over "
                f"{co['batches']} batches")
        adm = s["admission"]
        if adm["p99_target_s"] is not None:
            cal = adm["calibration"]
            caps = ", ".join(f"{lbl}: K<={a['k_cap']}"
                             + ("" if a["feasible"] else " (infeasible)")
                             for lbl, a in sorted(adm["groups"].items()))
            lines.append(
                f"  admission: p99 target {ms(adm['p99_target_s'])} "
                f"(slack x{adm['slack']:.1f}) -> {caps or 'no groups yet'}")
            if cal["count"]:
                lines.append(
                    f"  roofline calibration: measured/predicted = "
                    f"{cal['ratio']:.2f} over {cal['count']} batches")
        for failure in s["warm_failures"]:
            lines.append(f"  warm-up failed: {failure}")
        for label, count in sorted(s["signatures"].items()):
            lines.append(f"    {label}: {count} request(s)")
        return "\n".join(lines)
