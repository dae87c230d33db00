"""The port's spin-2 (E/B <-> Q/U) host side and float64 oracle on the CPU.

Host tables (log factorials, the stacked spin rows, the spin slot layout,
the rotation tables on the 2M rows, the spin-2 alm mask) are array-equal
to the reference's, and the component packing helpers give the
reference's bits.  The float64 ``SHT.alm2map_spin`` / ``map2alm_spin``
hold the reference ``SHT`` to 1e-12 relative, the GL spin round trip to
1e-12, the pure-E null test to the reference's own bands
(tests/test_spin.py), and the closed-form spin-2 goldens of
tests/test_golden.py to atol 1e-13.  The Wigner-general recurrence is also
held to the textbook Wigner-d sum (tests/test_spin.py's oracle) to 1e-11.

Seeds: ``spin_seeds_scaled`` evaluates exp/log in float64 with torch, the
reference with XLA.  Their scales are array-equal, and so are the float32
mantissas the kernels use.  The float64 mantissas differ on about 14% of
the entries: torch's and XLA's log round apart in the last bit, and exp
amplifies an ulp of its argument log p by |log p| (up to 3.7e-15 relative
at l_max 31, 2.8e-14 at l_max 200), so they are held to 1e-13 relative,
a tenth of the oracle's band.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import grids as rgrids
from repro.core import legendre as rleg
from repro.core import phase as rphase
from repro.core import sht as rsht
from repro.core import spectra as rspectra
from repro.kernels import pack as rpack

import repro_torch
from repro_torch import interop
from repro_torch.core import grids, legendre, phase, sht, spectra
from repro_torch.kernels import ops, pack

ORACLE_TOL = 1e-12


def rel(got, want) -> float:
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def eb_alm(l_max, K, seed=0):
    """Seeded (E, B) alm (2, M, L, K) complex: m = 0 real, l < max(m, 2)
    zero."""
    rng = np.random.default_rng(seed)
    shape = (2, l_max + 1, l_max + 1, K)
    a = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    a[:, 0] = a[:, 0].real
    return a * rsht.alm_mask(l_max, l_max, spin=2)[None, ..., None]


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l_max", [8, 64, 511])
def test_host_tables_match_reference(l_max):
    m = np.arange(l_max + 1)
    assert np.array_equal(legendre.log_factorials(2 * l_max + 1),
                          rleg.log_factorials(2 * l_max + 1))
    m2, mp2 = legendre._spin_rows(m)
    rm2, rmp2 = rleg._spin_rows(m)
    for got, want in ((m2, rm2), (mp2, rmp2)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(ops.spin_rows(m)[1], rmp2)
    assert np.array_equal(sht.alm_mask(l_max, l_max, spin=2),
                          rsht.alm_mask(l_max, l_max, spin=2))


@pytest.mark.parametrize("l_max", [8, 24, 140])
def test_spin_slot_layout_matches_reference(l_max):
    """The spin slot layout: segments start at max(m, |m'|)."""
    m2, mp2 = legendre._spin_rows(np.arange(l_max + 1))
    lo = pack.build_layout(m2, l_max, mp_vals=mp2)
    rlo = rpack.build_layout(m2, l_max, mp_vals=mp2)
    assert lo.spin and rlo.spin and lo.S == rlo.S and lo.n_slots == rlo.n_slots
    for name in ("slot_m", "slot_mp", "slot_seed", "slot_row", "a_row",
                 "a_l", "alm_src", "row_dst"):
        assert np.array_equal(getattr(lo, name), getattr(rlo, name)), name
    l0 = np.maximum(lo.slot_m, np.abs(lo.slot_mp))
    assert np.array_equal(lo.a_l[:, 0], np.where(lo.slot_row[:, 0] >= 0,
                                                 l0[:, 0], -1))
    assert pack.panel_counts(m2, l_max, mp_vals=mp2) == \
        rpack.panel_counts(m2, l_max, mp_vals=mp2)


@pytest.mark.parametrize("direction", ["synth", "anal"])
def test_rotation_tables_on_spin_rows_match_reference(direction):
    l_max = 12
    m2, _ = legendre._spin_rows(np.arange(l_max + 1))
    phi0 = np.random.default_rng(1).uniform(0, 6, 13)
    for n in (2 * l_max, 2 * l_max + 2, l_max + 3):
        got = phase.uniform_rotation_tables(m2, phi0, n, direction)
        want = rphase.uniform_rotation_tables(m2, phi0, n, direction)
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_spin_packing_helpers_give_reference_bits():
    rng = np.random.default_rng(2)
    parts = [rng.normal(size=(5, 7, 3)) for _ in range(4)]
    t = [torch.as_tensor(p) for p in parts]
    j = [jnp.asarray(p) for p in parts]
    pairs = (
        (legendre.spin_pack_alm(*t), rleg.spin_pack_alm(*j)),
        (legendre.spin_pack_delta(*t), rleg.spin_pack_delta(*j)),
        (legendre.spin_unpack_delta(torch.cat(t[:2]), torch.cat(t[2:])),
         rleg.spin_unpack_delta(jnp.concatenate(j[:2]),
                                jnp.concatenate(j[2:]))),
        (legendre.spin_unpack_alm(torch.cat(t[:2]), torch.cat(t[2:])),
         rleg.spin_unpack_alm(jnp.concatenate(j[:2]),
                              jnp.concatenate(j[2:]))))
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    # the pack/unpack pairs are inverses (to rounding) and transposes up to 2
    e_re, e_im, b_re, b_im = legendre.spin_unpack_alm(
        *legendre.spin_pack_alm(*t))
    for g, w in zip((e_re, e_im, b_re, b_im), t):
        assert torch.allclose(g, w, rtol=0, atol=1e-15)


@pytest.mark.parametrize("l_max", [8, 31, 64])
def test_spin_seeds_match_reference(l_max):
    """Scales and float32 mantissas array-equal; float64 mantissas within
    1e-13 relative (see the module notes)."""
    g = grids.make_grid("gl", l_max=l_max)
    m2, mp2 = legendre._spin_rows(np.arange(l_max + 1))
    m2 = np.insert(m2, 3, -1)                       # a padding row
    mp2 = np.insert(mp2, 3, 2)
    lf = legendre.log_factorials(2 * l_max + 1)
    for dt, jdt, sb in ((torch.float32, jnp.float32, 64),
                        (torch.float64, jnp.float64, 512)):
        mant, scale = legendre.spin_seeds_scaled(
            m2, mp2, g.cos_theta, g.sin_theta, lf, dtype=dt, scale_bits=sb)
        rmant, rscale = rleg.spin_seeds_scaled(
            m2, mp2, g.cos_theta, g.sin_theta, lf, dtype=jdt, scale_bits=sb)
        assert np.array_equal(scale.numpy(), np.asarray(rscale))
        if dt == torch.float32:
            assert np.array_equal(mant.numpy(), np.asarray(rmant))
        else:
            want = np.asarray(rmant)
            assert np.all(np.abs(mant.numpy() - want)
                          <= 1e-13 * np.abs(want))
        assert bool((mant[3] == 0).all()) and bool((scale[3] == 0).all())


# ---------------------------------------------------------------------------
# the float64 oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("l_max", [8, 31, 64])
def test_spin_oracle_matches_reference(l_max, K):
    rg = rgrids.make_grid("gl", l_max=l_max)
    ref = rsht.SHT(rg, l_max, l_max)
    port = sht.SHT(grids.make_grid("gl", l_max=l_max), l_max, l_max)
    a = eb_alm(l_max, K, seed=l_max + K)
    maps = np.random.default_rng(K).normal(
        size=(2, rg.n_rings, rg.max_n_phi, K))
    got = port.alm2map_spin(torch.as_tensor(a))
    assert got.shape == (2, rg.n_rings, rg.max_n_phi, K)
    assert rel(got, ref.alm2map_spin(jnp.asarray(a))) <= ORACLE_TOL
    got_a = port.map2alm_spin(torch.as_tensor(maps))
    assert got_a.shape == a.shape
    assert rel(got_a, ref.map2alm_spin(jnp.asarray(maps))) <= ORACLE_TOL


def test_spin_gl_round_trip_machine_precision():
    l_max, K = 32, 2
    port = sht.SHT(grids.make_grid("gl", l_max=l_max), l_max, l_max)
    a = sht.random_alm_spin(torch.Generator().manual_seed(0), l_max, l_max,
                            K, device="cpu")
    assert a.shape == (2, l_max + 1, l_max + 1, K)
    assert bool((a[:, :, :2] == 0).all()) and bool((a[:, 0].imag == 0).all())
    out = port.map2alm_spin(port.alm2map_spin(a))
    assert spectra.d_err(a, out) < 1e-12
    # Jacobi passes keep an exact grid exact
    out1 = port.map2alm_spin(port.alm2map_spin(a), iters=1)
    assert spectra.d_err(a, out1) < 1e-12


def test_pure_e_zero_b_null():
    """Pure-E alm synthesise Q/U that analyse back with zero B leakage
    (mirrors tests/test_spin.py)."""
    l_max = 24
    port = sht.SHT(grids.make_grid("gl", l_max=l_max), l_max, l_max)
    alm = sht.random_alm_spin(torch.Generator().manual_seed(11), l_max,
                              l_max, device="cpu")
    alm[1] = 0.0
    back = port.map2alm_spin(port.alm2map_spin(alm))
    e_scale = float(alm[0].abs().max())
    assert float(back[1].abs().max()) < 1e-13 * e_scale
    assert spectra.d_err(alm[0], back[0]) < 1e-12


def test_spin_fold_and_bad_shapes_raise():
    g = grids.make_grid("gl", l_max=8)
    with pytest.raises(ValueError, match="fold"):
        sht.SHT(g, 8, 8, fold=True).alm2map_spin(
            torch.zeros((2, 9, 9, 1), dtype=torch.complex128))
    with pytest.raises(ValueError):
        sht.SHT(g, 8, 8).alm2map_spin(
            torch.zeros((9, 9, 1), dtype=torch.complex128))
    with pytest.raises(ValueError):
        legendre.HarmonicCore(np.arange(9), g.cos_theta, g.sin_theta,
                              legendre.log_mu(8), 8, spin=1)


def wigner_d(j, m, mp, beta):
    """The textbook Wigner d^j_{m,mp}(beta) sum (tests/test_spin.py)."""
    f = math.factorial
    m, mp = mp, m
    pref = math.sqrt(f(j + m) * f(j - m) * f(j + mp) * f(j - mp))
    c, s = math.cos(beta / 2.0), math.sin(beta / 2.0)
    tot = 0.0
    for k in range(max(0, m - mp), min(j + m, j - mp) + 1):
        denom = f(j + m - k) * f(k) * f(j - k - mp) * f(k - m + mp)
        tot += ((-1) ** (k - m + mp) / denom
                * c ** (2 * j - 2 * k + m - mp) * s ** (2 * k - m + mp))
    return pref * tot


@pytest.mark.parametrize("m", [0, 1, 2, 3, 6])
@pytest.mark.parametrize("mp", [-2, 2])
def test_lambda_recurrence_matches_wigner_oracle(m, mp):
    """lam^{(m')}_lm = (-1)^m sqrt((2l+1)/4pi) d^l_{m,m'} for every l and
    ring, rows below l0 = max(m, |m'|) exactly zero."""
    l_max = 8
    g = grids.make_grid("gl", l_max=l_max)
    a_re = torch.zeros((1, l_max + 1, l_max + 1), dtype=torch.float64)
    for l in range(l_max + 1):
        a_re[0, l, l] = 1.0                    # one impulse per l channel
    d_re, _ = legendre.delta_from_alm_general(
        a_re, torch.zeros_like(a_re), [m], [mp], g.cos_theta, g.sin_theta,
        l_max=l_max)
    got = d_re[0].numpy()                      # (R, l): lam_{l,m}(theta_r)
    for l in range(l_max + 1):
        for r, th in enumerate(np.arccos(g.cos_theta)):
            if l < max(m, abs(mp)):
                assert got[r, l] == 0.0
                continue
            want = ((-1) ** m * math.sqrt((2 * l + 1) / (4 * math.pi))
                    * wigner_d(l, m, mp, th))
            assert abs(got[r, l] - want) < 1e-11 * max(1.0, abs(want))


# ---------------------------------------------------------------------------
# closed-form spin-2 goldens (tests/test_golden.py)
# ---------------------------------------------------------------------------

GOLDEN_L_MAX = 6


def _lam2(mprime, m, x):
    """lam^{(m')}_{2,m}(theta) closed forms, m' = +-2, m = 0, 1, 2."""
    s = np.sqrt(1.0 - x * x)
    c5 = math.sqrt(5.0 / (4.0 * math.pi))
    if m == 0:
        return c5 * (math.sqrt(6.0) / 4.0) * s * s
    if m == 1:
        return c5 * 0.5 * s * (1.0 - x) if mprime == -2 \
            else -c5 * 0.5 * s * (1.0 + x)
    return c5 * (((1.0 + x) / 2.0) ** 2 if mprime == 2
                 else ((1.0 - x) / 2.0) ** 2)


@pytest.fixture(scope="module")
def plan_spin():
    return repro_torch.make_plan("gl", GOLDEN_L_MAX, dtype="float64",
                                 mode="torch", spin=2, device="cpu")


@pytest.mark.parametrize("m", [0, 1, 2])
@pytest.mark.parametrize("comp", ["E", "B"])
def test_spin2_single_coefficient_golden(plan_spin, m, comp):
    """A unit E_2m (or B_2m) gives Q = -fac (lam^- + lam^+)/2 cos(m phi),
    U = -fac (lam^- - lam^+)/2 sin(m phi) (E), or Q = -fac (lam^+ -
    lam^-)/2 sin(m phi), U = -fac (lam^+ + lam^-)/2 cos(m phi) (B)."""
    L = GOLDEN_L_MAX
    g = plan_spin.grid
    alm = torch.zeros((2, L + 1, L + 1, 1), dtype=torch.complex128)
    alm[0 if comp == "E" else 1, m, 2, 0] = 1.0
    qu = plan_spin.alm2map(alm)[..., 0].numpy()
    x = g.cos_theta
    lam_m, lam_p = _lam2(-2, m, x)[:, None], _lam2(+2, m, x)[:, None]
    phi = 2.0 * np.pi * np.arange(g.max_n_phi) / g.max_n_phi
    fac = 1.0 if m == 0 else 2.0
    cos, sin = np.cos(m * phi)[None, :], np.sin(m * phi)[None, :]
    if comp == "E":
        q = -fac * (lam_m + lam_p) / 2.0 * cos
        u = -fac * (lam_m - lam_p) / 2.0 * sin
    else:
        q = -fac * (lam_p - lam_m) / 2.0 * sin
        u = -fac * (lam_p + lam_m) / 2.0 * cos
    np.testing.assert_allclose(qu[0], q, atol=1e-13)
    np.testing.assert_allclose(qu[1], u, atol=1e-13)


def test_spin2_unit_coefficient_round_trip_beyond_seed_row(plan_spin):
    L = GOLDEN_L_MAX
    alm = torch.zeros((2, L + 1, L + 1, 1), dtype=torch.complex128)
    alm[0, 3, 4, 0] = 1.0
    back = plan_spin.map2alm(plan_spin.alm2map(alm))
    np.testing.assert_allclose(back.numpy(), alm.numpy(), atol=1e-12)


# ---------------------------------------------------------------------------
# polarisation helpers and interop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l_max", [10, 300])
def test_polarisation_spectra_match_reference(l_max):
    got, want = spectra.cmb_like_cl_pol(l_max), rspectra.cmb_like_cl_pol(l_max)
    assert set(got) == set(want) == {"tt", "ee", "bb", "te"}
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(spectra.cmb_like_cl(l_max),
                          rspectra.cmb_like_cl(l_max))
    # |TE| < sqrt(TT EE): a positive definite (T, E) covariance
    assert np.all(np.abs(got["te"]) <= np.sqrt(got["tt"] * got["ee"]))


def test_cl_cross_from_alm_matches_reference():
    rng = np.random.default_rng(5)
    shape = (9, 12, 2)
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    y = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    got = spectra.cl_cross_from_alm(torch.as_tensor(x), torch.as_tensor(y))
    want = rspectra.cl_cross_from_alm(jnp.asarray(x), jnp.asarray(y))
    assert rel(got, want) < 1e-14
    # the auto spectrum is cl_from_alm
    assert torch.allclose(spectra.cl_cross_from_alm(torch.as_tensor(x),
                                                    torch.as_tensor(x)),
                          spectra.cl_from_alm(torch.as_tensor(x)))


def test_alm_from_cl_pol_has_its_spectra():
    """Drawn (T, E, B) alm: masks as the reference's, and the pseudo
    spectra of many draws recover TT/EE/BB/TE (the Cholesky split)."""
    l_max, K = 64, 300
    cls = spectra.cmb_like_cl_pol(l_max)
    alm = spectra.alm_from_cl_pol(torch.Generator().manual_seed(3), cls,
                                  K=K, device="cpu")
    assert alm.shape == (3, l_max + 1, l_max + 1, K)
    assert bool((alm[1:, :, :2] == 0).all())
    assert bool((alm[:, 0].imag == 0).all())
    mask0 = torch.as_tensor(sht.alm_mask(l_max, l_max))[..., None]
    assert bool((alm[0][~mask0.expand_as(alm[0])] == 0).all())
    t, e, b = alm
    ls = slice(20, l_max + 1)
    for got, key in ((spectra.cl_cross_from_alm(t, t), "tt"),
                     (spectra.cl_cross_from_alm(e, e), "ee"),
                     (spectra.cl_cross_from_alm(b, b), "bb")):
        ratio = got.mean(dim=1)[ls].numpy() / cls[key][ls]
        assert np.all(np.abs(ratio - 1.0) < 0.05), key
    te = spectra.cl_cross_from_alm(t, e).mean(dim=1)[ls].numpy()
    scale = np.sqrt(cls["tt"][ls] * cls["ee"][ls])
    assert np.all(np.abs(te - cls["te"][ls]) < 0.05 * scale)


def test_interop_takes_the_spin_fields():
    l_max, K = 8, 2
    a = eb_alm(l_max, K, seed=4)
    rg = rgrids.make_grid("gl", l_max=l_max)
    maps = np.asarray(rsht.SHT(rg, l_max, l_max).alm2map_spin(jnp.asarray(a)))
    m2, mp2 = rleg._spin_rows(np.arange(l_max + 1))
    from repro.kernels import ref as rref
    pmm, pms = rref.prepare_seeds_spin(m2, mp2, rg.cos_theta, rg.sin_theta)
    t = interop.from_reference({"alm": a, "maps": maps, "pmm": pmm,
                                "pms": pms}, device="cpu")
    assert t["alm"].shape == a.shape and t["alm"].dtype == torch.complex128
    assert t["maps"].shape == maps.shape and t["pmm"].shape == (2 * (l_max + 1),
                                                                rg.n_rings)
    plan = repro_torch.make_plan("gl", l_max, K=K, mode="torch", spin=2,
                                 device="cpu")
    assert rel(plan.alm2map(t["alm"]), maps) < ORACLE_TOL
    with pytest.raises(ValueError, match="2 components"):
        interop.from_reference({"alm": np.zeros((3, 9, 9, 1), complex)},
                               device="cpu")
