"""The distributed transform on gloo ranks against the reference's serial
transform.

One ``torch.multiprocessing`` spawn per world size (3 ranks deal the m
pairs unevenly; 3 and 4 both pad m slots and ring pairs), with a gloo
group over a file store (no ports).  Every case runs inside the ranks on
numpy inputs made from a seed; the parent holds the returned arrays against
``repro.core.sht.SHT`` (the reference's own distributed checks fail on its
JAX version, ROADMAP.md section 3) and checks that every rank returned the
same thing.

Bands: float64 (``stage1="torch"``) 1e-12 of max|reference| (the same
math, rounded by two frameworks); float32 through the kernels' plain
versions 5e-5 of max|reference| (the port's ground rule at l_max <= 64);
the bfloat16 exchange below the reference's 2e-2; chunked synthesis bit
for bit against one exchange (chunks reorder independent per-(m, k) work)
and chunked analysis 1e-12; gradients 1e-10 of ``jax.grad`` of the serial
reference loss (conjugated: PyTorch's complex gradient is the conjugate of
JAX's).
"""
import functools
import queue

import numpy as np
import pytest
import torch

#: the reference helper's shapes (tests/helpers/dist_sht_check.py): GL
#: l_max 40 K 2, HEALPix nside 8 l_max 16
GL = ("gl", dict(l_max=40), 40)
HP = ("healpix", dict(nside=8), 16)
K = 2
WORLDS = (3, 4)


def _alm(rng, l_max, K, spin=0):
    """Random alm (M, L, K) complex, zero where l < max(m, spin), m = 0
    real; spin 2 an (E, B) pair."""
    shape = ((2,) if spin else ()) + (l_max + 1, l_max + 1, K)
    a = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    m, l = np.arange(l_max + 1)[:, None], np.arange(l_max + 1)[None, :]
    a = a * ((l >= m) & (l >= spin))[..., None]
    a[..., 0, :, :] = a[..., 0, :, :].real
    return a


def _maps(rng, grid, K, spin=0):
    shape = ((2,) if spin else ()) + (grid.n_rings, grid.max_n_phi, K)
    return rng.normal(size=shape)


@functools.lru_cache(maxsize=None)
def inputs():
    """The numpy inputs every rank and the parent share."""
    from repro_torch.core import grids
    rng = np.random.default_rng(25)
    out = {}
    for name, kw, l_max in (GL, HP):
        g = grids.make_grid(name, **kw)
        out[name] = {"alm": _alm(rng, l_max, K),
                     "alm2": _alm(rng, l_max, K, spin=2),
                     "maps": _maps(rng, g, K),
                     "maps2": _maps(rng, g, K, spin=2)}
    out["gl"]["alm4"] = _alm(rng, 40, 4)
    out["gl"]["alm1"] = _alm(rng, 40, 1)
    out["gl"]["maps4"] = _maps(rng, grids.make_grid("gl", l_max=40), 4)
    out["gl"]["maps1"] = _maps(rng, grids.make_grid("gl", l_max=40), 1)
    out["gl"]["t"] = _maps(rng, grids.make_grid("gl", l_max=40), K)
    return out


def _pair(d, sp, alm, maps, spin):
    """(synthesis in grid order, analysis in dense alm) of one engine."""
    if spin:
        qu = d.alm2map_spin(torch.stack([sp.pack_alm(alm[0]),
                                         sp.pack_alm(alm[1])]))
        syn = torch.stack([sp.scatter_map(qu[0]), sp.scatter_map(qu[1])])
        eb = d.map2alm_spin(torch.stack([sp.gather_map(maps[0]),
                                         sp.gather_map(maps[1])]))
        ana = torch.stack([sp.unpack_alm(eb[0]), sp.unpack_alm(eb[1])])
    else:
        syn = sp.scatter_map(d.alm2map(sp.pack_alm(alm)))
        ana = sp.unpack_alm(d.map2alm(sp.gather_map(maps)))
    return syn.numpy(), ana.numpy()


def _cases(n):
    """Every case of one rank; returns {name: numpy array or value}."""
    import torch.distributed as dist

    import repro_torch
    from repro_torch.core import grids, transform
    from repro_torch.core.dist_sht import DistSHT
    from repro_torch.core.plan import SHTPlan

    data = inputs()
    out = {}
    sps = {}
    for name, kw, l_max in (GL, HP):
        sps[name] = SHTPlan(grids.make_grid(name, **kw), l_max, l_max, n)

    def run(tag, name, spin=0, alm_key=None, maps_key=None, **kw):
        sp = sps[name]
        d = DistSHT(sp, device="cpu", **kw)
        dt = torch.float64 if d.dtype == "float64" else torch.float32
        ct = torch.complex128 if dt == torch.float64 else torch.complex64
        alm = torch.as_tensor(data[name][alm_key or ("alm2" if spin
                                                     else "alm")]).to(ct)
        maps = torch.as_tensor(data[name][maps_key or ("maps2" if spin
                                                       else "maps")]).to(dt)
        out[f"{tag} synth"], out[f"{tag} anal"] = _pair(d, sp, alm, maps,
                                                        spin)

    # float64, the torch stage 1: spin 0 and 2 on GL and HEALPix, fold on GL
    for name in ("gl", "healpix"):
        for spin in (0, 2):
            run(f"f64 {name} spin {spin}", name, spin, stage1="torch")
    run("f64 gl fold", "gl", fold=True)
    # float32 through the kernels' plain versions, both layouts on GL
    for spin in (0, 2):
        run(f"f32 gl spin {spin}", "gl", spin, dtype="float32",
            stage1="plain")
    run("f32 gl packed", "gl", dtype="float32", stage1="plain",
        layout="packed")
    run("f32 gl fold", "gl", dtype="float32", stage1="plain", fold=True)
    run("f32 healpix", "healpix", dtype="float32", stage1="plain")
    # the bfloat16 exchange
    run("bf16 gl", "gl", comm_dtype="bfloat16")
    # chunks on the k axis (K 4) and the m axis (K 1), spin 0 and 2
    for C in (1, 2, 4):
        for Kc in (4, 1):
            run(f"chunks K{Kc} C{C}", "gl", alm_key=f"alm{Kc}",
                maps_key=f"maps{Kc}", comm_chunks=C)
        run(f"chunks spin C{C}", "gl", 2, comm_chunks=C)
        run(f"chunks f32 C{C}", "gl", alm_key="alm4", maps_key="maps4",
            dtype="float32", stage1="plain", comm_chunks=C)
    # gradients through make_plan(mode="dist"), the whole-array path
    for C in (1, 2):
        plan = repro_torch.make_plan("gl", 40, K=K, dtype="float64",
                                     mode="dist", comm_chunks=C,
                                     device="cpu")
        a = torch.as_tensor(data["gl"]["alm"]).requires_grad_(True)
        (plan.alm2map(a) * torch.as_tensor(data["gl"]["t"])).sum().backward()
        out[f"grad synth C{C}"] = a.grad.numpy()
        m = torch.as_tensor(data["gl"]["maps"]).requires_grad_(True)
        plan.map2alm(m).abs().pow(2).sum().backward()
        out[f"grad anal C{C}"] = m.grad.numpy()
    # the plan surface: a forced dist plan, the model, the measured autotune
    plan = repro_torch.make_plan("gl", 16, K=K, dtype="float64",
                                 mode="dist", comm_chunks=2, device="cpu")
    out["comm"] = plan.describe()["comm"]
    out["report"] = plan.report()
    for mode in ("model", "auto"):
        p = repro_torch.make_plan("gl", 16, K=4, dtype="float32", mode=mode,
                                  device="cpu")
        out[f"{mode} decision"] = (p.backends, p.layouts, p.comm_chunks)
        out[f"{mode} candidates"] = list(p.candidates)
    out["auto measured"] = p.measured_s
    # the errors: fail fast before any collective, wrong devices
    d = DistSHT(sps["gl"], device="cpu")
    bad = torch.zeros((sps["gl"].m_local, sps["gl"].r_pad + 1, 2))
    errors = {}
    for what, fn in (
            ("exchange", lambda: d._exchange(bad, to_rings=True,
                                             pending=[])),
            ("device", lambda: DistSHT(sps["gl"], device="meta")),
            ("cuda stage", lambda: DistSHT(sps["gl"], device="cpu",
                                           stage1="cuda")),
            ("shards", lambda: DistSHT(sps["healpix"].__class__(
                sps["gl"].grid, 40, 40, n + 1), device="cpu")),
            ("block device", lambda: d.alm2map_local(torch.zeros(
                (sps["gl"].m_local, 41, 1), dtype=torch.complex128,
                device="meta")))):
        try:
            fn()
            errors[what] = None
        except (ValueError, RuntimeError) as e:
            errors[what] = f"{type(e).__name__}: {e}"
    out["errors"] = errors
    out["eligible"] = transform.backend_eligibility(
        sps["gl"].grid, "float32")["dist"]
    out["world"] = dist.get_world_size()
    return out


def _rank_main(rank, n, path, results):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=n)
    try:
        results.put((rank, _cases(n)))
    except BaseException as e:          # the parent reports it
        results.put((rank, e))
        raise
    finally:
        dist.destroy_process_group()


_RUNS: dict = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(n)``: every rank's results of a world of n ranks (one spawn
    per n, cached for the module)."""
    import torch.multiprocessing as mp

    def get(n):
        if n not in _RUNS:
            path = tmp_path_factory.mktemp(f"gloo{n}") / "store"
            ctx = mp.get_context("spawn")
            results = ctx.Queue()
            procs = [ctx.Process(target=_rank_main,
                                 args=(r, n, str(path), results))
                     for r in range(n)]
            for p in procs:
                p.start()
            got = {}
            try:
                for _ in range(n):
                    rank, res = results.get(timeout=240)
                    if isinstance(res, BaseException):
                        raise AssertionError(f"rank {rank} failed: {res!r}")
                    got[rank] = res
            except queue.Empty:
                raise AssertionError("a rank did not report within 240 s")
            finally:
                for p in procs:
                    p.join(timeout=60)
                    if p.is_alive():
                        p.kill()
            _RUNS[n] = got
        return _RUNS[n]

    return get


def _reference(name):
    """The reference's serial float64 transform of a grid."""
    from repro.core import grids as rgrids
    from repro.core import sht as rsht
    kind, kw, l_max = {"gl": GL, "healpix": HP}[name]
    return rsht.SHT(rgrids.make_grid(kind, **kw), l_max, l_max,
                    dtype="float64")


@functools.lru_cache(maxsize=None)
def _want(name, spin, key, fold=False):
    """(synthesis, analysis) of the reference on the shared inputs."""
    import jax
    import jax.numpy as jnp
    from repro.core import grids as rgrids
    from repro.core import sht as rsht
    data = inputs()[name]
    kind, kw, l_max = {"gl": GL, "healpix": HP}[name]
    ref = rsht.SHT(rgrids.make_grid(kind, **kw), l_max, l_max,
                   dtype="float64", fold=fold)
    alm = data[key[0]]
    maps = data[key[1]]
    # jitted: one compile is cheaper than the op-by-op dispatch
    synth, anal = ((ref.alm2map_spin, ref.map2alm_spin) if spin
                   else (ref.alm2map, ref.map2alm))
    return (np.asarray(jax.jit(synth)(jnp.asarray(alm))),
            np.asarray(jax.jit(anal)(jnp.asarray(maps))))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _same_on_every_rank(res, key):
    first = res[0][key]
    for r in res:
        if isinstance(first, np.ndarray):
            assert np.array_equal(res[r][key], first), (key, r)
        else:
            assert res[r][key] == first, (key, r)
    return first


CASES = [  # (tag, grid, spin, input keys, fold, band)
    ("f64 gl spin 0", "gl", 0, ("alm", "maps"), False, 1e-12),
    ("f64 gl spin 2", "gl", 2, ("alm2", "maps2"), False, 1e-12),
    ("f64 healpix spin 0", "healpix", 0, ("alm", "maps"), False, 1e-12),
    ("f64 healpix spin 2", "healpix", 2, ("alm2", "maps2"), False, 1e-12),
    ("f64 gl fold", "gl", 0, ("alm", "maps"), True, 1e-12),
    ("f32 gl spin 0", "gl", 0, ("alm", "maps"), False, 5e-5),
    ("f32 gl spin 2", "gl", 2, ("alm2", "maps2"), False, 5e-5),
    ("f32 gl packed", "gl", 0, ("alm", "maps"), False, 5e-5),
    ("f32 gl fold", "gl", 0, ("alm", "maps"), True, 5e-5),
    ("f32 healpix", "healpix", 0, ("alm", "maps"), False, 5e-5),
]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag,name,spin,keys,fold,band", CASES)
def test_dist_matches_the_serial_reference(ranks, world, tag, name, spin,
                                           keys, fold, band):
    """Both directions on every rank against the reference's serial SHT:
    float64 within 1e-12, float32 (plain versions) within 5e-5."""
    res = ranks(world)
    want_s, want_a = _want(name, spin, keys, fold)
    got_s = _same_on_every_rank(res, f"{tag} synth")
    got_a = _same_on_every_rank(res, f"{tag} anal")
    assert got_s.shape == want_s.shape and got_a.shape == want_a.shape
    assert _rel(got_s, want_s) < band
    assert _rel(got_a, want_a) < band


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_exchange_within_the_reference_band(ranks, world):
    res = ranks(world)
    for d in ("synth", "anal"):
        got, f64 = res[0][f"bf16 gl {d}"], res[0][f"f64 gl spin 0 {d}"]
        err = _rel(got, f64)
        assert 0 < err < 2e-2, (d, err)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["K4", "K1", "spin", "f32"])
def test_chunked_exchange_matches_one_exchange(ranks, world, case):
    """C 2 and 4 against C 1 (K 4: the k axis; K 1: the m axis; spin 2 at
    K 2: the k axis and the m axis; float32 plain versions at K 4):
    synthesis bit for bit, analysis within 1e-12."""
    res = ranks(world)
    base = f"chunks {case} C1"
    for C in (2, 4):
        tag = f"chunks {case} C{C}"
        assert np.array_equal(res[0][f"{tag} synth"], res[0][f"{base} synth"])
        assert _rel(res[0][f"{tag} anal"], res[0][f"{base} anal"]) <= 1e-12


@pytest.mark.parametrize("world", WORLDS)
def test_gradients_match_jax_grad(ranks, world):
    """Gradients through make_plan(mode="dist") (C 1 and 2) against
    jax.grad of the serial reference loss, conjugated; C 2 against C 1."""
    import jax
    import jax.numpy as jnp
    res = ranks(world)
    data = inputs()["gl"]
    ref = _reference("gl")
    t = jnp.asarray(data["t"])
    want_s = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum(ref.alm2map(a) * t)))(jnp.asarray(data["alm"])))
    want_a = np.asarray(jax.jit(jax.grad(
        lambda m: jnp.sum(jnp.abs(ref.map2alm(m)) ** 2)))(
            jnp.asarray(data["maps"])))
    for C in (1, 2):
        got_s = _same_on_every_rank(res, f"grad synth C{C}").conj()
        got_a = _same_on_every_rank(res, f"grad anal C{C}")
        assert _rel(got_s, want_s) < 1e-10
        assert _rel(got_a, want_a) < 1e-10
    assert _rel(res[0]["grad synth C2"], res[0]["grad synth C1"]) <= 1e-12
    assert _rel(res[0]["grad anal C2"], res[0]["grad anal C1"]) <= 1e-12


@pytest.mark.parametrize("world", WORLDS)
def test_plan_surface_and_decisions_agree_on_every_rank(ranks, world):
    """make_plan(mode="dist"): describe()["comm"] and report() name the
    forced chunk count; mode="model" and mode="auto" count dist among the
    candidates and take one decision on every rank."""
    res = ranks(world)
    assert _same_on_every_rank(res, "world") == world
    assert _same_on_every_rank(res, "eligible") is None
    comm = _same_on_every_rank(res, "comm")
    assert comm == {"spec": 2, "chunks": {"synth": 2, "anal": 2},
                    "pipelined": {"synth": True, "anal": True}}
    report = res[0]["report"]
    assert "synth -> dist[C=2]" in report and "anal  -> dist[C=2]" in report
    for mode in ("model", "auto"):
        assert "dist" in _same_on_every_rank(res, f"{mode} candidates")
        backends, layouts, chunks = _same_on_every_rank(
            res, f"{mode} decision")
        for d in ("synth", "anal"):
            assert (chunks[d] is None) == (backends[d] != "dist")
    _same_on_every_rank(res, "auto measured")


@pytest.mark.parametrize("world", WORLDS)
def test_errors_raise_before_any_collective(ranks, world):
    errors = ranks(world)[0]["errors"]
    assert errors["exchange"].startswith("ValueError")
    assert "multiple of the group size" in errors["exchange"]
    assert f"spans {world} ranks" in errors["exchange"]
    assert "exchanges cpu tensors" in errors["device"]
    assert "stage1='cuda'" in errors["cuda stage"]
    assert f"process group has {world} ranks" in errors["shards"]
    assert "the engine runs on cpu" in errors["block device"]


def test_dist_needs_a_group_of_two_ranks():
    """Without a process group of >= 2 ranks make_plan(mode="dist") raises
    with the reference's reason, and the engine needs a group."""
    import repro
    import repro_torch
    from repro.core import grids as rgrids
    from repro_torch.core import grids
    from repro_torch.core.dist_sht import DistSHT
    from repro_torch.core.plan import SHTPlan
    with pytest.raises(ValueError, match=r"needs >= 2 devices \(visible: 1"):
        repro_torch.make_plan("gl", 8, mode="dist", device="cpu")
    want = repro.backend_eligibility(rgrids.make_grid("gl", l_max=8),
                                     "float32", n_devices=1)["dist"]
    got = repro_torch.backend_eligibility(grids.make_grid("gl", l_max=8),
                                          "float32")["dist"]
    assert got.startswith(want)
    with pytest.raises(RuntimeError, match="initialised process group"):
        DistSHT(SHTPlan(grids.make_grid("gl", l_max=8), 8, 8, 1),
                device="cpu")
