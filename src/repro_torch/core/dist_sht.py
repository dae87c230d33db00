"""The distributed spherical harmonic transform (paper §4.1, Algorithm 3).

Counterpart of ``repro.core.dist_sht``.  The two-stage structure:

  alm2map:  [m-dealt]    Delta_m(r) for the rank's m rows, ALL rings
            --- one all-to-all (the paper's MPI_Alltoallv) ---
            [ring-dealt] inverse FFTs of the rank's rings, all m

  map2alm:  [ring-dealt] forward FFTs of the rank's rings (weights applied)
            --- one all-to-all, reversed ---
            [m-dealt]    the a_lm projection of the rank's m rows over ALL
                         rings

Ranks, not a mesh: PyTorch runs one program per rank, so the reference's
shard_map program becomes a rank's own path.  :meth:`DistSHT.alm2map_local`
takes the rank's rows (m_local, L, K) of the packed alm and returns its
rings (r_local, n_phi, K), and :meth:`DistSHT.map2alm_local` the reverse:
the paper's distributed data layout, one exchange each.  :meth:`alm2map` /
:meth:`map2alm` (and the spin-2 pair) keep the reference's signatures on
the full packed arrays, (Mp, L, K) <-> (R_pad, n_phi, K): each rank takes
its block of the replicated input, runs the local path, and gathers the
output blocks (``all_gather_into_tensor``).  That gather is a second
collective, outside the paper's one exchange; it is there so that the
whole-array calls give every rank the whole result.

Design notes (the reference's, in torch terms):

* ``SHTPlan`` pads the m list and the ring-pair list so every rank has the
  same slot counts, so ``all_to_all_single`` with equal splits replaces
  ``Alltoallv``.  It splits dim 0 only, so the blocks are laid out
  rank-major: (m_local, R_pad, C) -> (n, m_local, r_local, C) -> exchange
  -> (n m_local, r_local, C), which is ``SHTPlan.m_flat`` order.
* re | im (and the K maps, and the Q | U pair) ride one trailing real
  channel axis, so a transform issues ONE exchange, as in the paper.
* ``fold=True`` runs the Legendre recurrence on each ring pair's northern
  slot (equatorial symmetry).
* ``comm_dtype="bfloat16"`` casts the Delta block before the exchange and
  back after it (lossy compressed communication, which the paper leaves
  to future work).
* ``stage1``: ``"torch"`` runs the recurrence engine of ``core.legendre``
  in ``dtype``; ``"cuda"`` launches the hand-written kernels through the
  ``kernels.ops`` adapters (CUDA tensors only); ``"plain"`` runs those
  kernels' plain versions (``kernels.ref``, CPU tensors only).  The kernel
  stages compute in float32, on ``layout`` (``"plain"`` by default, as
  the reference's distributed path runs, or ``"packed"``) and one
  ``variant`` for every chunk: the one the whole batch picks
  (``ops.pick_variant`` of the un-chunked channel count), so the chunk
  count changes no synthesis bit.
* ``comm_chunks = C > 1`` splits the exchange into C chunks along the K
  map axis, or the local m rows when K is too small
  (``SHTPlan.chunk_schedule``).  Each chunk's exchange is issued with
  ``async_op=True`` and waited on only where its output is used, so chunk
  i's collective overlaps chunk i+1's Legendre work (synthesis) or chunk
  i-1's projection (analysis).  Chunking reorders independent per-(m, k)
  work: synthesis bits do not move.
* Gradients: the exchange is a ``core.autodiff.linear_pair`` whose
  transpose is the reverse exchange, and stage 1 and the phase stage are
  pairs already, so the backward of :meth:`alm2map` / :meth:`map2alm` runs
  the opposite two-stage transform with the same single exchange (first
  order).  The whole-array calls treat their input and output as
  replicated: the backward of the gather takes the rank's block of the
  cotangent, and that of the block selection gathers the blocks, so a
  loss every rank computes alike gives every rank the whole gradient.

No hidden fallback: a NCCL group takes CUDA tensors and a gloo group CPU
tensors, a mismatch raises, and nothing is staged through the host.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import legendre
from repro_torch.core import phase as phaselib
from repro_torch.core.autodiff import linear_pair
from repro_torch.core.plan import SHTPlan

__all__ = ["DistSHT"]

_DTYPES = {"float64": torch.float64, "float32": torch.float32}
#: the exchange dtypes besides the engine's own
_COMM = {"bfloat16": torch.bfloat16}
#: the device type each process-group backend carries
_GROUP_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


#: ``all_gather_into_tensor`` under the name newer torch releases give it
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _group_device(group) -> str:
    backend = str(dist.get_backend(group)).lower()
    if backend not in _GROUP_DEVICE:
        raise ValueError(f"DistSHT runs on a 'nccl' (CUDA tensors) or "
                         f"'gloo' (CPU tensors) process group, not "
                         f"{backend!r}")
    return _GROUP_DEVICE[backend]


class DistSHT:
    """The distributed transform of one rank, bound to a plan and a process
    group.

    plan : the ``SHTPlan``; its ``n_shards`` must equal the group's size.
    group : a ``torch.distributed`` process group (None: the default one,
        which must be initialised).
    device : ``None`` means ``cuda:<LOCAL_RANK>`` (the rank's local card;
        raises without one), else ``"cpu"`` or a CUDA device; it must be
        the kind the group carries.
    dtype : ``"float64"`` or ``"float32"``, of the inputs and outputs and of
        the ``"torch"`` stage 1.
    fold, comm_dtype, stage1, comm_chunks, variant, layout : see the module
        notes (``comm_chunks=None``: the plan's).
    """

    def __init__(self, plan: SHTPlan, group=None, device=None,
                 dtype: str = "float64", fold: bool = False,
                 comm_dtype: Optional[str] = None, stage1: str = "torch",
                 comm_chunks: Optional[int] = None,
                 variant: Optional[str] = None, layout: str = "plain"):
        if not dist.is_initialized():
            raise RuntimeError("DistSHT needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        self.plan = plan
        self.group = group
        self.rank = dist.get_rank(group)
        self.n = dist.get_world_size(group)
        if self.n != plan.n_shards:
            raise ValueError(f"the plan deals {plan.n_shards} shards, the "
                             f"process group has {self.n} ranks")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be 'float64' or 'float32', got "
                             f"{dtype!r}")
        self.dtype = dtype
        self._rdt = _DTYPES[dtype]
        want = _group_device(group)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("DistSHT(device=None) runs on the rank's "
                                   "CUDA device, and none is visible")
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", self.rank))
                % torch.cuda.device_count())
        device = torch.device(device)
        if device.type != want:
            raise ValueError(f"a {dist.get_backend(group)!r} process group "
                             f"exchanges {want} tensors; the engine's device "
                             f"is {device}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        if stage1 not in ("torch", "cuda", "plain"):
            raise ValueError(f"unknown stage1 {stage1!r}: expected 'torch', "
                             "'cuda' or 'plain'")
        if stage1 == "cuda" and self.device.type != "cuda":
            raise ValueError("stage1='cuda' launches the CUDA kernels and "
                             f"takes CUDA tensors; the device is "
                             f"{self.device} (stage1='plain' runs their "
                             "plain versions on the CPU)")
        if stage1 == "plain" and self.device.type != "cpu":
            raise ValueError("stage1='plain' runs the kernels' plain "
                             "versions on CPU tensors; on a CUDA device "
                             "use stage1='cuda'")
        self.stage1 = stage1
        if fold and not plan.grid.equator_symmetric:
            raise ValueError("fold requires an equator-symmetric grid")
        self.fold = bool(fold)
        if comm_dtype is not None and str(comm_dtype) not in _COMM:
            raise ValueError(f"unknown comm_dtype {comm_dtype!r}")
        self.comm_dtype = None if comm_dtype is None else str(comm_dtype)
        C = plan.comm_chunks if comm_chunks is None else comm_chunks
        if int(C) < 1:
            raise ValueError(f"comm_chunks must be >= 1, got {comm_chunks!r}")
        self.comm_chunks = int(C)
        if variant not in (None, "vpu", "mxu"):
            raise ValueError(f"unknown Legendre variant {variant!r}")
        self.variant = variant
        if layout not in ("plain", "packed"):
            raise ValueError(f"the distributed stage 1 runs the 'plain' or "
                             f"'packed' layout, not {layout!r}")
        self.layout = layout
        #: kernel stores (seeds, packed layouts, indices) per (spin, m0, m1)
        self._stores: dict = {}

    # -- the rank's static geometry ------------------------------------------

    @functools.cached_property
    def _log_mu(self) -> np.ndarray:
        return legendre.log_mu(self.plan.m_max)

    @functools.cached_property
    def _geom(self) -> dict:
        return self.plan.ring_geometry

    @functools.cached_property
    def m_loc(self) -> np.ndarray:
        """(m_local,) the rank's global m per row; -1 = padding."""
        return self.plan.m_assignment[self.rank]

    @property
    def _rings(self) -> slice:
        r = self.plan.r_local
        return slice(self.rank * r, (self.rank + 1) * r)

    @functools.cached_property
    def _stage2(self) -> dict:
        """The rank's ring slots: phi0, weights, the valid-ring mask, and on
        a ragged grid the bucket index over its local slots."""
        g, sl = self._geom, self._rings
        out = {"phi0": g["phi0"][sl], "w": g["weights"][sl],
               "valid": g["valid"][sl].astype(np.float64)}
        p = self.plan
        if not p.grid.uniform:
            out["bucket"] = phaselib.bucket_index(
                p.m_flat, g["n_phi"][sl], p.local_fft_layout,
                p.grid.max_n_phi)
        return out

    def _store(self, spin: int, m0: int, m1: int) -> dict:
        return self._stores.setdefault((spin, m0, m1), {})

    def _variant(self, K: int) -> str:
        """The Legendre variant of every chunk: the whole batch's pick."""
        from repro_torch.kernels import ops as kops
        return kops.pick_variant(2 * K, self.variant)

    # -- stage 1: Legendre (m-dealt) ------------------------------------------

    def _stage1_synth(self, a_re, a_im, m0, m1, variant):
        """Rows [m0, m1) of the rank: (mc, L, K) -> Delta (mc, R_pad, K)
        (re, im) over every plan ring slot."""
        p, g, m = self.plan, self._geom, self.m_loc[m0:m1]
        if self.stage1 != "torch":
            from repro_torch.kernels import ops as kops
            return kops.delta_from_alm_auto(
                a_re, a_im, m, g, self._log_mu, l_max=p.l_max,
                fold=self.fold, dtype=self._rdt, variant=variant,
                layout=self.layout, store=self._store(0, m0, m1))
        if not self.fold:
            return legendre.delta_from_alm(
                a_re, a_im, m, g["cos_theta"], g["sin_theta"], self._log_mu,
                l_max=p.l_max)
        ere, eim, ore_, oim = legendre.delta_from_alm_folded(
            a_re, a_im, m, g["cos_theta"][0::2], g["sin_theta"][0::2],
            self._log_mu, l_max=p.l_max)
        # interleave (E + O, E - O) back into plan slot order
        d_re = torch.stack([ere + ore_, ere - ore_], dim=2)
        d_im = torch.stack([eim + oim, eim - oim], dim=2)
        mc, npair, _, K = d_re.shape
        return (d_re.reshape(mc, 2 * npair, K), d_im.reshape(mc, 2 * npair, K))

    def _stage1_anal(self, dw_re, dw_im, m0, m1, variant):
        """Rows [m0, m1): weighted Delta (mc, R_pad, K) -> alm (mc, L, K)."""
        p, g, m = self.plan, self._geom, self.m_loc[m0:m1]
        if self.stage1 != "torch":
            from repro_torch.kernels import ops as kops
            return kops.alm_from_delta_auto(
                dw_re, dw_im, m, g, self._log_mu, l_max=p.l_max,
                fold=self.fold, dtype=self._rdt, variant=variant,
                layout=self.layout, store=self._store(0, m0, m1))
        if not self.fold:
            return legendre.alm_from_delta(
                dw_re, dw_im, m, g["cos_theta"], g["sin_theta"],
                np.ones(p.r_pad), self._log_mu, l_max=p.l_max)
        n_re, s_re = dw_re[:, 0::2], dw_re[:, 1::2]
        n_im, s_im = dw_im[:, 0::2], dw_im[:, 1::2]
        return legendre.alm_from_delta_folded(
            n_re + s_re, n_im + s_im, n_re - s_re, n_im - s_im, m,
            g["cos_theta"][0::2], g["sin_theta"][0::2], self._log_mu,
            l_max=p.l_max)

    def _stage1_synth_spin(self, e_re, e_im, b_re, b_im, m0, m1, variant):
        """Spin-2 rows [m0, m1): (E, B) (mc, L, K) -> (dq_re, dq_im, du_re,
        du_im), each (mc, R_pad, K)."""
        p, g, m = self.plan, self._geom, self.m_loc[m0:m1]
        if self.stage1 != "torch":
            from repro_torch.kernels import ops as kops
            return kops.delta_from_alm_spin_auto(
                e_re, e_im, b_re, b_im, m, g, l_max=p.l_max, m_max=p.m_max,
                dtype=self._rdt, variant=variant, layout=self.layout,
                store=self._store(2, m0, m1))
        return legendre.delta_from_alm_spin(
            e_re, e_im, b_re, b_im, m, g["cos_theta"], g["sin_theta"],
            l_max=p.l_max, m_max=p.m_max)

    def _stage1_anal_spin(self, dq_re, dq_im, du_re, du_im, m0, m1,
                          variant):
        """Spin-2 rows [m0, m1): weighted (Delta_Q, Delta_U) (mc, R_pad, K)
        -> (e_re, e_im, b_re, b_im), each (mc, L, K)."""
        p, g, m = self.plan, self._geom, self.m_loc[m0:m1]
        if self.stage1 != "torch":
            from repro_torch.kernels import ops as kops
            return kops.alm_from_delta_spin_auto(
                dq_re, dq_im, du_re, du_im, m, g, l_max=p.l_max,
                m_max=p.m_max, dtype=self._rdt, variant=variant,
                layout=self.layout, store=self._store(2, m0, m1))
        return legendre.alm_from_delta_spin(
            dq_re, dq_im, du_re, du_im, m, g["cos_theta"], g["sin_theta"],
            l_max=p.l_max, m_max=p.m_max)

    # -- stage 2: FFTs (ring-dealt), plan-slot m order -------------------------

    def _synth_fft(self, d_re, d_im):
        """Delta (Mp, r_local, C) (re, im) -> (r_local, n_phi, C) samples;
        dummy rings give zeros."""
        p, s = self.plan, self._stage2
        delta = torch.complex(d_re, d_im)
        if p.grid.uniform:
            return phaselib.uniform_synth(delta, p.m_flat, p.grid.max_n_phi,
                                          s["phi0"], scale_rows=s["valid"])
        return phaselib.bucket_synth(delta, s["bucket"], s["phi0"],
                                     scale_rows=s["valid"])

    def _anal_fft(self, maps_loc):
        """(r_local, n_phi, C) samples -> weighted Delta (Mp, r_local, C)
        (re, im)."""
        p, s = self.plan, self._stage2
        if p.grid.uniform:
            dw = phaselib.uniform_anal(maps_loc, p.m_flat, p.grid.max_n_phi,
                                       s["phi0"], s["w"])
        else:
            dw = phaselib.bucket_anal(maps_loc, s["bucket"], s["phi0"],
                                      s["w"])
        return dw.real, dw.imag

    # -- the exchange ---------------------------------------------------------

    def _a2a(self, send, async_op: bool):
        """One ``all_to_all_single`` of a rank-major (n, ...) block: block j
        goes to rank j, and the output's block i comes from rank i.
        Returns (output, work handle or None)."""
        out = torch.empty_like(send)
        work = dist.all_to_all_single(out, send, group=self.group,
                                      async_op=async_op)
        return out, work

    def _exchange(self, x, *, to_rings: bool, pending: list):
        """The paper's global communication step (one a chunk), issued
        asynchronously: its work handle goes to ``pending``, and the
        returned rank-major block (n, m_rows, r_local, C), in the exchange
        dtype, may be read only through :meth:`_arrived` after
        :meth:`_wait`.  An all-to-all with equal splits is its own
        transpose, so the backward is the reverse exchange of the
        cotangent.

        to_rings:  x (m_rows, R_pad, C), this rank's rows over every ring
        else:      x (n m_rows, r_local, C), every rank's rows over this
                   rank's rings
        """
        n = self.n
        axis = 1 if to_rings else 0
        what = "dealt ring-pair slot" if to_rings else "dealt m-row slot"
        if x.shape[axis] % n != 0:
            raise ValueError(
                f"all_to_all_single with equal splits needs the {what} "
                f"count to be a multiple of the group size: axis {axis} "
                f"has {x.shape[axis]} slots but the process group spans "
                f"{n} ranks (shape {tuple(x.shape)})")
        if self.comm_dtype is not None:
            x = x.to(_COMM[self.comm_dtype])
        if to_rings:
            mr, R, C = x.shape
            send = x.reshape(mr, n, R // n, C).permute(1, 0, 2, 3)
        else:
            send = x.reshape(n, x.shape[0] // n, *x.shape[1:])

        def fwd(_, v):
            out, work = self._a2a(v, async_op=True)
            pending.append(work)
            return out

        def bwd(_, g):
            return self._a2a(g.contiguous(), async_op=False)[0]

        return linear_pair(fwd, bwd, {}, send.contiguous())

    def _arrived(self, raw, *, to_rings: bool):
        """An exchanged rank-major block (n, m_rows, r_local, C) in the
        engine's dtype: to_rings (n m_rows, r_local, C), plan slot order;
        else (m_rows, R_pad, C), the ring blocks in rank order."""
        n, mr, rl, C = raw.shape
        y = raw.reshape(n * mr, rl, C) if to_rings else \
            raw.permute(1, 0, 2, 3).reshape(mr, n * rl, C)
        return y if y.dtype == self._rdt else y.to(self._rdt)

    @staticmethod
    def _wait(pending: list) -> None:
        while pending:
            pending.pop(0).wait()

    # -- chunked pipeline helpers ---------------------------------------------

    def _schedule(self, K: int, ncomp: int = 1):
        return self.plan.chunk_schedule(K, ncomp=ncomp,
                                        chunks=self.comm_chunks)

    def _merge_m_chunks(self, parts):
        """Exchanged m chunks [(n mc_j, r_local, C)] -> (Mp, r_local, C) in
        plan slot order (shard-major over m_local)."""
        n = self.n
        segs = [q.reshape(n, q.shape[0] // n, *q.shape[1:]) for q in parts]
        cat = torch.cat(segs, dim=1)
        return cat.reshape(n * cat.shape[1], *cat.shape[2:])

    def _split_m_chunk(self, packed, m0: int, m1: int):
        """(Mp, r_local, C) -> the (n (m1 - m0), r_local, C) block of local
        rows [m0, m1) of every rank."""
        n = self.n
        g = packed.reshape(n, packed.shape[0] // n, *packed.shape[1:])
        return g[:, m0:m1].reshape(n * (m1 - m0), *packed.shape[1:])

    # -- the rank's local transforms ------------------------------------------

    def _check_local(self, t, shape, what):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} shape {tuple(t.shape)}: expected "
                             f"{tuple(shape)} on rank {self.rank}")
        if t.device != self.device:
            raise ValueError(f"{what} lies on {t.device}; the engine runs on "
                             f"{self.device}")

    def _synth_local(self, rows, K: int, ncomp: int, stage):
        """The pipelined synthesis of one rank: ``rows`` a tuple of real
        (m_local, L, K) parts, ``stage(parts, m0, m1, variant)`` stage 1,
        returning the (mc, R_pad, kc) channel blocks in exchange order
        [re parts | im parts].  Chunk i's exchange is in flight while chunk
        i+1's stage 1 runs; all are waited on at the end.  Returns the
        exchanged (Mp, r_local, 2 ncomp K) block in that channel order."""
        axis, bounds = self._schedule(K, ncomp)
        var = self._variant(K)
        m_loc = self.plan.m_local
        if axis == "k":
            jobs = [(tuple(r[..., k0:k1] for r in rows), 0, m_loc)
                    for k0, k1 in bounds]
        elif axis == "m":
            jobs = [(tuple(r[m0:m1] for r in rows), m0, m1)
                    for m0, m1 in bounds]
        else:
            jobs = [(rows, 0, m_loc)]
        pending: list = []
        raw = [self._exchange(torch.cat(stage(parts, m0, m1, var), dim=-1),
                              to_rings=True, pending=pending)
               for parts, m0, m1 in jobs]
        self._wait(pending)
        parts = [self._arrived(q, to_rings=True) for q in raw]
        if axis == "m":
            return self._merge_m_chunks(parts)
        nb = 2 * ncomp
        # each chunk holds nb channel groups of kc: regroup by group
        groups = [[q.reshape(*q.shape[:-1], nb, q.shape[-1] // nb)[..., c, :]
                   for q in parts] for c in range(nb)]
        return torch.cat([t for grp in groups for t in grp], dim=-1)

    def _anal_local(self, maps_loc, K: int, ncomp: int, stage):
        """The pipelined analysis of one rank: ``maps_loc`` (r_local, n_phi,
        ncomp K), ``stage(blocks, m0, m1, variant)`` stage 1 on the
        exchanged channel blocks [re parts | im parts] (each kc wide),
        returning a tuple of real (mc, L, kc) parts.  Chunk i's exchange is
        in flight while chunk i-1's projection and chunk i+1's FFTs run
        (k axis).  Returns the parts (m_local, L, K)."""
        axis, bounds = self._schedule(K, ncomp)
        var = self._variant(K)
        m_loc = self.plan.m_local
        nb = 2 * ncomp

        def ffts(maps):
            dw_re, dw_im = self._anal_fft(maps)
            return torch.cat([dw_re, dw_im], dim=-1)       # (Mp, r, nb kc)

        if axis == "k":
            jobs = [((lambda k0=k0, k1=k1: ffts(torch.cat(
                [maps_loc[..., c * K + k0:c * K + k1] for c in range(ncomp)],
                dim=-1))), 0, m_loc) for k0, k1 in bounds]
        else:
            full = ffts(maps_loc)
            if axis == "m":
                jobs = [((lambda m0=m0, m1=m1: self._split_m_chunk(
                    full, m0, m1)), m0, m1) for m0, m1 in bounds]
            else:
                jobs = [(lambda: full, 0, m_loc)]

        def project(job):
            raw, pending, m0, m1 = job
            self._wait(pending)
            blk = self._arrived(raw, to_rings=False)
            kc = blk.shape[-1] // nb
            return stage(tuple(blk[..., c * kc:(c + 1) * kc]
                               for c in range(nb)), m0, m1, var)

        res, prev = [], None
        for make, m0, m1 in jobs:
            pending: list = []
            cur = (self._exchange(make(), to_rings=False, pending=pending),
                   pending, m0, m1)
            if prev is not None:
                res.append(project(prev))
            prev = cur
        res.append(project(prev))
        dim = 0 if axis == "m" else -1
        return tuple(torch.cat([r[c] for r in res], dim=dim)
                     for c in range(len(res[0])))

    def delta_local(self, a_loc) -> torch.Tensor:
        """The synthesis up to its exchange: the rank's rows of the packed
        alm, (m_local, L, K) complex or an (E, B) pair (2, m_local, L, K),
        -> the exchanged Delta block (Mp, r_local, C) real, every m row over
        the rank's rings, channels [re | im] (spin 2: [Q re | U re | Q im |
        U im]), each K wide.  Collective."""
        p = self.plan
        K = a_loc.shape[-1]
        spin = a_loc.ndim == 4
        if spin and self.fold:
            raise ValueError("fold is not supported for spin transforms")
        self._check_local(a_loc, ((2,) if spin else ()) + (
            p.m_local, p.l_max + 1, K), "alm block")
        if spin:
            e, b = a_loc[0], a_loc[1]
            rows = tuple(t.to(self._rdt) for t in (e.real, e.imag, b.real,
                                                   b.imag))

            def stage(parts, m0, m1, var):
                dq_re, dq_im, du_re, du_im = self._stage1_synth_spin(
                    *parts, m0, m1, var)
                return dq_re, du_re, dq_im, du_im
        else:
            rows = (a_loc.real.to(self._rdt), a_loc.imag.to(self._rdt))

            def stage(parts, m0, m1, var):
                return self._stage1_synth(*parts, m0, m1, var)

        return self._synth_local(rows, K, 1 + spin, stage)

    def alm2map_local(self, a_loc) -> torch.Tensor:
        """The rank's rows of the packed alm (m_local, L, K) complex -> its
        rings (r_local, n_phi, K) real, in plan slot order.  Collective:
        every rank of the group calls it."""
        K = a_loc.shape[-1]
        packed = self.delta_local(a_loc)                  # (Mp, r, 2K)
        return self._synth_fft(packed[..., :K], packed[..., K:])

    def map2alm_local(self, maps_loc) -> torch.Tensor:
        """The rank's rings (r_local, n_phi, K) real -> its rows of the
        packed alm (m_local, L, K) complex.  Collective."""
        p = self.plan
        K = maps_loc.shape[-1]
        self._check_local(maps_loc, (p.r_local, p.grid.max_n_phi, K),
                          "map block")

        def stage(blocks, m0, m1, var):
            return self._stage1_anal(*blocks, m0, m1, var)

        a_re, a_im = self._anal_local(maps_loc.to(self._rdt), K, 1, stage)
        return torch.complex(a_re, a_im)

    def alm2map_spin_local(self, a_loc_eb) -> torch.Tensor:
        """Spin 2: the rank's (E, B) rows (2, m_local, L, K) complex -> its
        (Q, U) rings (2, r_local, n_phi, K) real.  Collective."""
        K = a_loc_eb.shape[-1]
        packed = self.delta_local(a_loc_eb)               # (Mp, r, 4K)
        s = self._synth_fft(packed[..., :2 * K], packed[..., 2 * K:])
        return torch.stack([s[..., :K], s[..., K:]], dim=0)

    def map2alm_spin_local(self, maps_loc_qu) -> torch.Tensor:
        """Spin 2: the rank's (Q, U) rings (2, r_local, n_phi, K) -> its
        (E, B) rows (2, m_local, L, K) complex.  Collective."""
        p = self.plan
        if self.fold:
            raise ValueError("fold is not supported for spin transforms")
        K = maps_loc_qu.shape[-1]
        self._check_local(maps_loc_qu, (2, p.r_local, p.grid.max_n_phi, K),
                          "(Q, U) map block")
        maps2 = torch.cat([maps_loc_qu[0], maps_loc_qu[1]],
                          dim=-1).to(self._rdt)

        def stage(blocks, m0, m1, var):
            dq_re, du_re, dq_im, du_im = blocks
            return self._stage1_anal_spin(dq_re, dq_im, du_re, du_im, m0, m1,
                                          var)

        e_re, e_im, b_re, b_im = self._anal_local(maps2, K, 2, stage)
        return torch.stack([torch.complex(e_re, e_im),
                            torch.complex(b_re, b_im)], dim=0)

    # -- whole arrays: the rank's block in, every block out ---------------------

    def _own(self, x, axis: int, size: int):
        """The rank's block of a replicated tensor along ``axis``; backward:
        the blocks of the cotangent gathered (every rank the whole
        gradient)."""
        sl = slice(self.rank * size, (self.rank + 1) * size)

        def fwd(_, v):
            return v.narrow(axis, sl.start, size)

        def bwd(_, g):
            return self._gather(g.contiguous(), axis, raw=True)

        return linear_pair(fwd, bwd, {}, x)

    def _gather(self, x, axis: int, raw: bool = False):
        """Every rank's block along ``axis`` (``all_gather_into_tensor``);
        backward: the rank's block of the (replicated) cotangent."""
        def gather(v):
            v = v.movedim(axis, 0).contiguous()
            out = v.new_empty((self.n * v.shape[0],) + tuple(v.shape[1:]))
            real = torch.view_as_real if out.is_complex() else (lambda t: t)
            _all_gather(real(out), real(v), group=self.group)
            return out.movedim(0, axis)

        if raw:
            return gather(x)
        size = x.shape[axis]

        def fwd(_, v):
            return gather(v)

        def bwd(_, g):
            return g.narrow(axis, self.rank * size, size).contiguous()

        return linear_pair(fwd, bwd, {}, x)

    def _input(self, t, shape, what):
        """A whole-array input: numpy goes to the engine's device, a tensor
        must lie there already."""
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.asarray(t), device=self.device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} shape {tuple(t.shape)}: expected "
                             f"{tuple(shape)}")
        if t.device != self.device:
            raise ValueError(f"{what} lies on {t.device}; the engine runs on "
                             f"{self.device}")
        return t

    def alm2map(self, alm_packed) -> torch.Tensor:
        """Packed alm (Mp, L, K) complex, the same on every rank -> maps
        (R_pad, n_phi, K) in plan ring order, on every rank.  Rows follow
        ``plan.m_flat`` (``plan.pack_alm``), rings ``plan.ring_order``
        (``plan.scatter_map``).  Collective: its one exchange, then the
        gather of the ring blocks."""
        p = self.plan
        K = alm_packed.shape[-1]
        alm_packed = self._input(alm_packed, (p.n_shards * p.m_local, p.l_max + 1, K), "packed alm")
        a_loc = self._own(alm_packed, 0, p.m_local)
        return self._gather(self.alm2map_local(a_loc), 0)

    def map2alm(self, maps_plan) -> torch.Tensor:
        """Maps (R_pad, n_phi, K) in plan ring order, the same on every
        rank -> packed alm (Mp, L, K) complex on every rank.  Collective."""
        p = self.plan
        K = maps_plan.shape[-1]
        maps_plan = self._input(maps_plan, (p.r_pad, p.grid.max_n_phi, K),
                                "maps")
        m_loc = self._own(maps_plan, 0, p.r_local)
        return self._gather(self.map2alm_local(m_loc), 0)

    def alm2map_spin(self, alm_packed_eb) -> torch.Tensor:
        """Spin 2: packed (E, B) alm (2, Mp, L, K) -> (Q, U) maps (2, R_pad,
        n_phi, K) in plan ring order, on every rank.  Collective."""
        p = self.plan
        K = alm_packed_eb.shape[-1]
        alm_packed_eb = self._input(
            alm_packed_eb, (2, p.n_shards * p.m_local, p.l_max + 1, K),
            "packed (E, B) alm")
        a_loc = self._own(alm_packed_eb, 1, p.m_local)
        return self._gather(self.alm2map_spin_local(a_loc), 1)

    def map2alm_spin(self, maps_plan_qu) -> torch.Tensor:
        """Spin 2: (Q, U) maps (2, R_pad, n_phi, K) in plan ring order ->
        packed (E, B) alm (2, Mp, L, K), on every rank.  Collective."""
        p = self.plan
        K = maps_plan_qu.shape[-1]
        maps_plan_qu = self._input(
            maps_plan_qu, (2, p.r_pad, p.grid.max_n_phi, K), "(Q, U) maps")
        m_loc = self._own(maps_plan_qu, 1, p.r_local)
        return self._gather(self.map2alm_spin_local(m_loc), 1)
