"""Model bundles: config -> init / loss / prefill / decode + specs.

Counterpart of ``repro.models.model``: the one surface that serving (and,
later, training) code calls.  ``make_bundle(cfg)`` gives a
:class:`ModelBundle` on the CUDA device (``device="cpu"`` for the CPU);
``init(seed)`` draws an ``LM`` module there, and ``loss_fn``,
``prefill_fn`` and ``decode_fn`` take that module where the reference
takes its parameter tree.  ``input_specs`` gives a cell's inputs as
tensors on the ``meta`` device, the port's counterpart of
``ShapeDtypeStruct``.

Only the dense decoder family is ported (qwen2-0.5b, qwen3-8b,
qwen1.5-32b, h2o-danube-3-4b, internvl2-1b with its vision stub); the
MoE, MLA, SSM/hybrid and encoder-decoder architectures raise
``NotImplementedError`` (ROADMAP item 12c).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.transform import resolve_device
from repro_torch.models import transformer as T

__all__ = ["ModelBundle", "make_bundle", "input_specs", "check_ported"]


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for an architecture the port does not
    run yet."""
    why = None
    if cfg.is_encoder_decoder:
        why = "the encoder-decoder family (whisper)"
    elif cfg.attention != "gqa":
        why = f"{cfg.attention!r} attention"
    else:
        odd = sorted(set(T.block_kinds(cfg)) - set(T.BLOCKS))
        if odd:
            why = f"the {', '.join(odd)} block kind(s)"
    if why:
        raise NotImplementedError(f"{cfg.name}: {why} {T.NOT_PORTED}")


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: Any
    rt: T.Runtime

    @property
    def device(self) -> torch.device:
        return self.rt.device

    # -- params ----------------------------------------------------------------

    def init(self, seed) -> T.LM:
        """A fresh model on the bundle's device, drawn from ``seed`` (an
        int, or a ``torch.Generator`` on that device)."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        return T.init_lm(self.cfg, gen, self.device)

    def from_state(self, state: dict) -> T.LM:
        """A model on the bundle's device holding ``state`` (a
        ``state_dict``, e.g. ``interop.lm_state_from_reference``'s or
        another model's), copied there; nothing is drawn.  The skeleton
        is built from uninitialised host tensors that the state replaces
        (never touched, so never paged in)."""
        model = T.LM(self.cfg, self.rt.pdt, device="cpu")
        model.load_state_dict({k: v.to(self.device, copy=True)
                               for k, v in state.items()},
                              strict=True, assign=True)
        return model

    def param_specs(self) -> dict:
        return T.lm_specs(self.cfg, self.rt.rules)

    # -- train -----------------------------------------------------------------

    def loss_fn(self, model: T.LM, batch: dict):
        extra = {k: v for k, v in batch.items() if k != "tokens"} or None
        return T.forward_train(model, batch["tokens"], self.rt, extra=extra)

    # -- serve -----------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int) -> list:
        return T.init_caches(self.cfg, batch, max_len, self.rt.cdt,
                             self.device)

    def cache_specs(self) -> list:
        return T.caches_specs(self.cfg, self.rt.rules)

    def prefill_fn(self, model: T.LM, batch: dict, caches: list):
        return T.prefill(model, batch["tokens"], caches, self.rt)

    def decode_fn(self, model: T.LM, token, pos, caches: list):
        return T.decode_step(model, token, pos, caches, self.rt)


def make_bundle(cfg, device=None, mesh=None) -> ModelBundle:
    """The bundle of ``cfg`` on ``device`` (``None``: the CUDA device,
    which must be visible).  ``mesh`` only sets the sharding rules the
    spec trees resolve (``transformer.mesh_axes``); every tensor lives on
    ``device``."""
    check_ported(cfg)
    dev = resolve_device(device)
    rules = T.make_rules(cfg, mesh)
    return ModelBundle(cfg=cfg, rt=T.Runtime(cfg=cfg, mesh=mesh, rules=rules,
                                             device=dev))


def input_specs(cfg, shape) -> dict:
    """A cell's inputs as ``meta`` tensors (shape and dtype, no storage).

    train/prefill: {"tokens": (B, S)} (+ the vision stub's
    "patch_embeds" (B, n_vis, d), the tokens then S - n_vis);
    decode: {"token": (B, 1), "pos": (), "caches": S-deep caches}.
    """
    check_ported(cfg)
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    i32 = torch.int32
    cdt = getattr(torch, cfg.compute_dtype)
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision_stub":
            nv = cfg.n_vision_tokens
            return {"tokens": torch.empty((B, S - nv), dtype=i32,
                                          device=meta),
                    "patch_embeds": torch.empty((B, nv, cfg.d_model),
                                                dtype=cdt, device=meta)}
        return {"tokens": torch.empty((B, S), dtype=i32, device=meta)}
    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    return {"token": torch.empty((B, 1), dtype=i32, device=meta),
            "pos": torch.empty((), dtype=i32, device=meta),
            "caches": T.init_caches(cfg, B, S, cdt, meta)}
