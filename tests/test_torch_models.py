"""The port's dense decoders against the reference's, on the CPU.

For qwen2-0.5b, qwen3-8b, qwen1.5-32b (untied ``lm_head``),
h2o-danube-3-4b (sliding window) and internvl2-1b (vision stub) at
``reduced(...)`` widths, the reference draws its parameters and
``interop.lm_state_from_reference`` carries them into the port's ``LM``;
the same numpy tokens then go through both ``make_bundle``s.

Tolerances:
  * float32: 1e-4 x max|ref| for the loss, the prefill logits and every
    decode step's logits.  Both compute the same float32 products and
    sums in other orders (XLA's CPU dots against PyTorch's); the measured
    gap is ~1e-6.
  * bfloat16 (qwen3-8b): 3e-2 x max|ref| for the logits and 1e-3
    relative for the loss.  The reference's XLA CPU build runs chains of
    bfloat16 elementwise operations in float32 and rounds once, while
    PyTorch rounds each operation's output to bfloat16; the logits then
    differ by a few bfloat16 ulps (2^-8 relative each).  Measured: up to
    1.25e-2 for the logits over three seeds, 1e-4 for the loss.
  * the port's prefill against its own token-by-token decode: atol 2e-4,
    the reference's own test (tests/test_models.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import base as rbase
from repro.configs import registry as rregistry
from repro.models import attention as rA
from repro.models import layers as rL
from repro.models import model as rmodel
from repro.models import transformer as rT
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tregistry
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M

DENSE = ["qwen2-0.5b", "qwen3-8b", "qwen1.5-32b", "h2o-danube-3-4b",
         "internvl2-1b"]
NOT_PORTED = sorted(set(rregistry.ARCHS) - set(DENSE))
TOL = 1e-4
BF16_TOL = 3e-2
BF16_LOSS_TOL = 1e-3


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def pair(name, seed=0, **over):
    """(reference bundle, its params, port bundle, port model with the
    reference's weights), at ``reduced(..., **over)``."""
    rcfg = rbase.reduced(rregistry.ARCHS[name], **over)
    tcfg = tbase.reduced(tregistry.ARCHS[name], **over)
    rb = rmodel.make_bundle(rcfg)
    params = rb.init(jax.random.PRNGKey(seed))
    tb = M.make_bundle(tcfg, device="cpu")
    model = tb.from_state(interop.lm_state_from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    return rb, params, tb, model


def batches(cfg, rng, B=2, S=32):
    """The same batch for both packages: tokens, and the vision stub's
    patch embeddings (8 of the S positions)."""
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.frontend != "vision_stub":
        return {"tokens": jnp.asarray(toks)}, \
            {"tokens": torch.from_numpy(toks)}
    pe = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks[:, 8:]),
             "patch_embeds": jnp.asarray(pe)},
            {"tokens": torch.from_numpy(toks[:, 8:]),
             "patch_embeds": torch.from_numpy(pe)})


def serve_both(rb, params, tb, model, rng, B=2, prompt=16, steps=4,
               max_len=128):
    """Prefill ``prompt`` tokens, then ``steps`` decode steps, through both;
    returns each step's (reference logits, port logits)."""
    cfg = tb.cfg
    toks = rng.integers(0, cfg.vocab, (B, prompt + steps)).astype(np.int32)
    rc, tc = rb.init_caches(B, max_len), tb.init_caches(B, max_len)
    rlog, rc = jax.jit(rb.prefill_fn)(
        params, {"tokens": jnp.asarray(toks[:, :prompt])}, rc)
    tlog, tc = tb.prefill_fn(
        model, {"tokens": torch.from_numpy(toks[:, :prompt])}, tc)
    out = [(np.asarray(rlog), tlog.numpy())]
    dec = jax.jit(rb.decode_fn)
    for t in range(prompt, prompt + steps):
        tok = toks[:, t:t + 1]
        rlog, rc = dec(params, jnp.asarray(tok), jnp.int32(t), rc)
        tlog, tc = tb.decode_fn(model, torch.from_numpy(tok), t, tc)
        out.append((np.asarray(rlog), tlog.numpy()))
    return out, rc, tc


@pytest.mark.parametrize("name", DENSE)
def test_loss_matches_the_reference(name):
    rb, params, tb, model = pair(name)
    rbatch, tbatch = batches(tb.cfg, np.random.default_rng(1))
    want = float(jax.jit(rb.loss_fn)(params, rbatch))
    with torch.no_grad():
        got = tb.loss_fn(model, tbatch)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= TOL * abs(want)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_the_reference(name):
    """A 16-token prompt (96 on the sliding-window model, past its window
    of 64), then 4 decode steps: every step's logits."""
    rb, params, tb, model = pair(name)
    prompt = 96 if tb.cfg.sliding_window else 16
    steps, _, _ = serve_both(rb, params, tb, model,
                             np.random.default_rng(2), prompt=prompt)
    for i, (want, got) in enumerate(steps):
        assert got.shape == (2, tb.cfg.vocab) and got.dtype == np.float32
        assert rel(got, want) < TOL, i


def test_bf16_matches_the_reference_within_bf16_rounding():
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    rb, params, tb, model = pair("qwen3-8b", **kw)
    assert model.layers[0].attn.wq.w.dtype == torch.bfloat16
    assert model.layers[0].attn.q_norm.scale.dtype == torch.float32
    rbatch, tbatch = batches(tb.cfg, np.random.default_rng(3))
    want = float(jax.jit(rb.loss_fn)(params, rbatch))
    with torch.no_grad():
        got = float(tb.loss_fn(model, tbatch))
    assert abs(got - want) <= BF16_LOSS_TOL * abs(want)
    steps, _, _ = serve_both(rb, params, tb, model, np.random.default_rng(4))
    for i, (want, got) in enumerate(steps):
        assert rel(got, want) < BF16_TOL, i


@pytest.mark.parametrize("name", DENSE)
def test_prefill_matches_stepwise_decode(name):
    """Prefill-then-decode == token-by-token decode (the port's caches)."""
    tb = M.make_bundle(tbase.reduced(tregistry.ARCHS[name]), device="cpu")
    model = tb.init(5)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tb.cfg.vocab, (1, 8)).astype(np.int32))
    logits_p, _ = tb.prefill_fn(model, {"tokens": toks},
                                tb.init_caches(1, 32))
    c = tb.init_caches(1, 32)
    for t in range(8):
        logits_d, c = tb.decode_fn(model, toks[:, t:t + 1],
                                   torch.tensor(t), c)
    np.testing.assert_allclose(logits_p.numpy(), logits_d.numpy(), rtol=0,
                               atol=2e-4)


def test_sliding_window_cache_bounded():
    cfg = tbase.reduced(tregistry.ARCHS["h2o-danube-3-4b"])
    assert cfg.sliding_window == 64
    caches = M.input_specs(cfg, tbase.ShapeConfig("d", 4096, 2, "decode"))[
        "caches"]
    assert caches[0]["k"].shape == (2, 64, cfg.n_kv_heads, cfg.hd)
    assert caches[0]["pos"].shape == (64,)       # ring buffer, not 4096


def test_long_prompt_ring_buffer_keeps_the_last_window():
    """A 96-token prompt into the 64-slot ring: the port writes only the
    last 64 positions, which is what the reference's scatter of all 96
    (duplicate slots, last write wins on XLA's CPU build) leaves; both
    caches, slot for slot, and the decode logits after them."""
    rb, params, tb, model = pair("h2o-danube-3-4b", seed=7)
    steps, rc, tc = serve_both(rb, params, tb, model,
                               np.random.default_rng(7), prompt=96,
                               steps=3)
    for want, got in steps:
        assert rel(got, want) < TOL
    for layer in range(tb.cfg.n_layers):
        pos = tc[layer]["pos"].numpy()
        assert np.array_equal(pos, np.asarray(rc[0][0]["pos"][layer]))
        assert sorted(pos) == list(range(35, 99))
        for k in ("k", "v"):
            assert rel(tc[layer][k].numpy(),
                       np.asarray(rc[0][0][k][layer])) < TOL


def test_mea_past_the_window_stays_finite():
    """A sliding window more than a kv block behind its queries: the
    reference's ``mea`` gives NaN rows there (exp(-inf - -inf) on a kv
    block that masks a row whole before any key was seen); the port's
    equals the reference's ``dense_attention`` and, where the reference's
    ``mea`` is finite, that too."""
    rng = np.random.default_rng(8)
    B, S, H, KvH, D = 1, 2048, 4, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KvH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KvH, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    got = A.mea(*map(torch.from_numpy, (q, k, v, pos, pos)), window=64)
    assert torch.isfinite(got).all()
    jq = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    want = np.asarray(rA.dense_attention(*jq, window=64))
    assert rel(got.numpy(), want) < TOL
    ref_mea = np.asarray(rA.mea(*jq, window=64))
    ok = np.isfinite(ref_mea)
    assert np.abs(got.numpy()[ok] - ref_mea[ok]).max() < TOL * \
        np.abs(ref_mea[ok]).max()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_cores_match_the_reference(causal, window):
    """``mea`` (several q and kv blocks) and ``dense_attention`` on GQA
    inputs with invalid (-1) key slots."""
    rng = np.random.default_rng(9)
    B, S, H, KvH, D = 2, 24, 6, 2, 8
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KvH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KvH, D)).astype(np.float32)
    qpos = np.arange(S, dtype=np.int32)
    kpos = qpos.copy()
    kpos[3] = kpos[17] = -1
    t = list(map(torch.from_numpy, (q, k, v, qpos, kpos)))
    j = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    kw = dict(window=window, causal=causal)
    got = A.mea(*t, q_block=8, kv_block=4, **kw).numpy()
    want = np.asarray(rA.dense_attention(*j, **kw))
    assert rel(A.dense_attention(*t, **kw).numpy(), want) < TOL
    assert rel(got, want) < TOL
    # the reference's mea: NaN on the rows a causal window of 5 leaves
    # without a key in their first kv block (see
    # test_mea_past_the_window_stays_finite)
    ref_mea = np.asarray(rA.mea(*j, q_block=8, kv_block=4, **kw))
    ok = np.isfinite(ref_mea)
    assert ok.all() == (window is None or not causal)
    assert np.abs(got[ok] - ref_mea[ok]).max() < TOL * np.abs(want).max()


def test_layer_functions_match_the_reference():
    """Norms, RoPE (split halves, float64 frequencies), both MLPs and the
    chunked loss with -1 targets."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32) * 7
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                       theta=1e6)
    want = rL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6)
    assert rel(got.numpy(), want) < TOL
    assert np.array_equal(L.rope_freqs(16, 1e6), rL.rope_freqs(16, 1e6))
    norm = L.Norm(16, kind="layernorm")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(rng.standard_normal(16)))
        norm.bias.copy_(torch.from_numpy(rng.standard_normal(16)))
    p = {"scale": jnp.asarray(norm.scale.detach().numpy()),
         "bias": jnp.asarray(norm.bias.detach().numpy())}
    xt = torch.from_numpy(x)
    assert rel(L.layer_norm(norm, xt).detach().numpy(),
               rL.layer_norm(p, jnp.asarray(x))) < TOL
    assert rel(L.rms_norm(norm, xt).detach().numpy(),
               rL.rms_norm(p, jnp.asarray(x))) < TOL
    for act in ("swiglu", "gelu"):
        mlp = L.MLP(16, 40, act=act, dtype=torch.float32,
                    gen=torch.Generator().manual_seed(1))
        rp = {k: {"w": jnp.asarray(getattr(mlp, k).w.detach().numpy())}
              for k in ("gate", "up", "down") if getattr(mlp, k) is not None}
        got = L.apply_mlp(mlp, xt, act, torch.float32).detach().numpy()
        want = rL.apply_mlp(rp, jnp.asarray(x), act, jnp.float32)
        assert rel(got, want) < TOL, act
    table = rng.standard_normal((50, 16)).astype(np.float32)
    h = rng.standard_normal((2, 12, 16)).astype(np.float32)
    tg = rng.integers(0, 50, (2, 12)).astype(np.int32)
    tg[:, -3:] = -1
    want = float(rL.cross_entropy_loss(jnp.asarray(table), jnp.asarray(h),
                                       jnp.asarray(tg), n_chunks=4,
                                       compute_dtype=jnp.float32))
    for chunks in (1, 4, 5):
        got = float(L.cross_entropy_loss(
            torch.from_numpy(table), torch.from_numpy(h),
            torch.from_numpy(tg), n_chunks=chunks,
            compute_dtype=torch.float32))
        assert abs(got - want) < 1e-6 * abs(want), chunks


def _flatten(tree, prefix=""):
    """Nested dicts and lists -> {dotted key: leaf}."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def canon(spec: tuple) -> tuple:
    """A spec as ``PartitionSpec`` stores it: a one-axis group is the
    axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


class _FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = [None, ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


@pytest.mark.parametrize("mesh", MESHES, ids=["none", "pod", "two_pods"])
@pytest.mark.parametrize("name", DENSE)
def test_param_specs_match_the_tree_and_the_reference(name, mesh):
    """Keys equal the state_dict's, one axis entry per tensor axis, and
    each entry the reference's spec with its stacked-layer axis dropped."""
    fake = None if mesh is None else _FakeMesh(*mesh)
    tcfg = tbase.reduced(tregistry.ARCHS[name])
    tb = M.make_bundle(tcfg, device="cpu", mesh=fake)
    model = tb.init(0)
    specs = _flatten(tb.param_specs())
    state = model.state_dict()
    assert set(specs) == set(state)
    for k, s in specs.items():
        assert isinstance(s, tuple) and len(s) == state[k].ndim, k
    rcfg = rbase.reduced(rregistry.ARCHS[name])
    rspecs = rT.lm_specs(rcfg, rT.make_rules(rcfg, fake))
    for k, s in specs.items():
        parts = k.split(".")
        if parts[0] == "layers":
            node = rspecs["groups"][0][0]
            for p in parts[2:]:
                node = node[p]
            assert tuple(node)[1:] == canon(s), k
        else:
            node = rspecs
            for p in parts:
                node = node[p]
            assert tuple(node) == canon(s), k


@pytest.mark.parametrize("name", DENSE)
def test_cache_specs_match_the_cache_tree(name):
    fake = _FakeMesh((16, 16), ("data", "model"))
    cfg = tbase.reduced(tregistry.ARCHS[name])
    tb = M.make_bundle(cfg, device="cpu", mesh=fake)
    caches, specs = tb.init_caches(2, 32), tb.cache_specs()
    assert len(caches) == len(specs) == cfg.n_layers
    flat_c, flat_s = _flatten(caches), _flatten(specs)
    assert set(flat_c) == set(flat_s)
    for k in flat_c:
        assert len(flat_s[k]) == flat_c[k].ndim, k
    rcfg = rbase.reduced(rregistry.ARCHS[name])
    rspec = rT.caches_specs(rcfg, rT.make_rules(rcfg, fake))[0][0]
    for k, s in specs[0].items():
        assert tuple(rspec[k])[1:] == canon(s), k


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", DENSE)
def test_input_specs_match_the_reference(name, kind):
    """meta tensors of the reference's shapes and dtypes (the decode caches
    per layer, the reference's stacked over its layers)."""
    for over in ({}, dict(compute_dtype="float32")):
        cfg = dataclasses.replace(tregistry.ARCHS[name], **over)
        rcfg = dataclasses.replace(rregistry.ARCHS[name], **over)
        shape = tbase.SHAPES[kind]
        got = M.input_specs(cfg, shape)
        want = rmodel.input_specs(rcfg, rbase.SHAPES[kind])
        if kind != "decode_32k":
            assert set(got) == set(want)
            for k in got:
                assert got[k].is_meta
                assert tuple(got[k].shape) == want[k].shape
                assert str(got[k].dtype).split(".")[1] == \
                    want[k].dtype.name
            continue
        assert tuple(got["token"].shape) == want["token"].shape
        assert got["pos"].shape == () and got["pos"].dtype == torch.int32
        assert len(got["caches"]) == cfg.n_layers
        for k, t in got["caches"][0].items():
            w = want["caches"][0][0][k]
            assert t.is_meta and (cfg.n_layers,) + tuple(t.shape) == w.shape
            assert str(t.dtype).split(".")[1] == w.dtype.name


@pytest.mark.parametrize("name", NOT_PORTED)
def test_other_families_raise_not_implemented(name):
    cfg = tbase.reduced(tregistry.ARCHS[name])
    with pytest.raises(NotImplementedError, match="12c"):
        M.make_bundle(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="12c"):
        M.input_specs(cfg, tbase.SHAPES["train_4k"])


def test_bundle_defaults_to_the_card():
    """No ``device``: the CUDA device, or an error naming device='cpu'
    when no card is visible; never a quiet CPU run."""
    cfg = tbase.reduced(tregistry.ARCHS["qwen3-8b"])
    if torch.cuda.is_available():
        assert M.make_bundle(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.make_bundle(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.lm_state_from_reference(cfg, {"groups": []})


def test_init_draws_the_reference_distributions():
    """N(0, 1/d_in) dense weights, N(0, 0.02^2) embedding, unit norm scales,
    zero biases; the same seed gives the same weights, another seed
    other ones; an explicit generator is used as given."""
    cfg = tbase.reduced(tregistry.ARCHS["qwen2-0.5b"], vocab=4096)
    tb = M.make_bundle(cfg, device="cpu")
    a, b, c = tb.init(1), tb.init(1), tb.init(2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed.table"], sc["embed.table"])
    assert abs(float(sa["embed.table"].std()) - 0.02) < 1e-3
    w = sa["layers.0.mlp.down.w"]
    assert abs(float(w.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    assert torch.equal(sa["layers.1.ln2.scale"], torch.ones(cfg.d_model))
    assert not sa["layers.0.attn.wq.b"].any()
    g = torch.Generator().manual_seed(1)
    assert torch.equal(tb.init(g).state_dict()["embed.table"],
                       sa["embed.table"])


def test_interop_carries_bfloat16_bits():
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    rcfg = rbase.reduced(rregistry.ARCHS["qwen1.5-32b"], **kw)
    tcfg = tbase.reduced(tregistry.ARCHS["qwen1.5-32b"], **kw)
    params = jax.tree.map(np.asarray,
                          rmodel.make_bundle(rcfg).init(jax.random.PRNGKey(3)))
    state = interop.lm_state_from_reference(tcfg, params, device="cpu")
    w = params["groups"][0][0]["attn"]["wq"]["w"][1]
    got = state["layers.1.attn.wq.w"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), w.astype(np.float32))
    assert state["lm_head.w"].shape == (tcfg.d_model, tcfg.vocab)
    assert state["final_norm.scale"].dtype == torch.float32


@pytest.mark.parametrize("form", ["int", "0d", "1d", "int64"])
def test_decode_position_forms_agree(form):
    """A decode step's position as a Python int or as an integer tensor
    gives the same logits and caches: it becomes one (1,) int32 tensor on
    the model's device a step (``attention.decode_positions``)."""
    rb, params, tb, model = pair("h2o-danube-3-4b", seed=5)
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(0, tb.cfg.vocab, (2, 20))
                            .astype(np.int32))
    runs = []
    for f in ("int", form):
        _, c = tb.prefill_fn(model, {"tokens": toks[:, :16]},
                             tb.init_caches(2, 32))
        outs = []
        for t in range(16, 20):
            pos = {"int": t, "0d": torch.tensor(t, dtype=torch.int32),
                   "1d": torch.tensor([t], dtype=torch.int32),
                   "int64": torch.tensor(t)}[f]
            got = A.decode_positions(pos, torch.device("cpu"))
            assert got.shape == (1,) and got.dtype == torch.int32
            assert int(got) == t
            logits, c = tb.decode_fn(model, toks[:, t:t + 1], pos, c)
            outs.append(logits)
        runs.append((outs, c))
    (a, ca), (b, cb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(ca, cb) for k in x)


def test_rope_frequencies_are_cached_per_device():
    """``apply_rope`` reads its float32 frequencies from a cache keyed by
    (head_dim, theta, device), made once from the float64 numpy values,
    so a step copies nothing from the host."""
    x = torch.randn(1, 3, 2, 8, generator=torch.Generator().manual_seed(0))
    L.apply_rope(x, torch.arange(3), theta=5e5)
    key = (8, 5e5, torch.device("cpu"))
    cached = L._ROPE_FREQS[key]
    assert torch.equal(cached, torch.from_numpy(
        L.rope_freqs(8, 5e5).astype(np.float32)))
    L.apply_rope(x, torch.arange(3), theta=5e5)
    assert L._ROPE_FREQS[key] is cached
