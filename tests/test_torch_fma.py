"""The port's fused multiply-add (``kernels.ref.fma_f32``) and the spin
update it contracts.

XLA's CPU build contracts the reference's Wigner-d update
``(a x + b) pc - c pp`` into ``fma(fma(a, x, b), pc, -(c pp))``; the port's
plain versions and CUDA kernels (``fmaf``) now round it so too.  torch has
no fused multiply-add, so ``fma_f32`` emulates one: it is held here to the
correctly rounded result of exact rational arithmetic.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import ref as kref
from test_torch_spin_kernels import TOL, rel, spin_case


def exact_f32(a, b, c) -> np.float32:
    """a b + c in rational arithmetic, rounded to the nearest float32 (ties
    to even); an exact zero takes IEEE's sign (-0 only from -0 + -0), which
    float64 arithmetic gives exactly there."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    if v == 0:
        return np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    f = np.float32(float(v))
    near = (np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf)))
    return min(near, key=lambda q: (abs(Fraction(float(q)) - v),
                                    int(np.array(q).view(np.int32)) & 1))


def midpoint_triples(rng, n):
    """(a, b, c) whose product a b sits exactly on a float32 rounding
    midpoint (25 significant bits, the last one set), with c zero (a tie),
    far below the product's last bit (only the sticky side decides), or of
    the product's size: the double-rounding cases of a float64 emulation."""
    i = 2 * rng.integers(0, 1 << 10, n) + 1
    j = 2 * rng.integers(0, 1 << 10, n) + 1
    a = ((1 << 12) + i) / float(1 << 12)
    b = ((1 << 12) + j) / float(1 << 12)
    keep = (a * b) < 2.0                      # 25 bits: below 2^25 / 2^24
    a, b = a[keep], b[keep]
    scale = np.exp2(rng.integers(-30, 30, a.size))
    sign = rng.choice([-1.0, 1.0], a.size)
    kind = rng.integers(0, 3, a.size)
    tiny = sign * np.exp2(-rng.integers(30, 120, a.size))
    big = sign * rng.uniform(0.5, 4.0, a.size)
    c = np.where(kind == 0, 0.0, np.where(kind == 1, tiny, big)) * scale
    return ((a * scale).astype(np.float32), b.astype(np.float32),
            c.astype(np.float32))


def test_fma_f32_is_correctly_rounded():
    """Against exact arithmetic: random triples over a wide exponent range,
    the midpoint triples above, products near float32's least normal (the
    subnormal results), the case a float64 emulation rounds twice,
    (1 + 2^-12)^2 + 2^-70 -> 0x1.002002p+0, and exact zeros of both
    signs."""
    rng = np.random.default_rng(0)
    n = 3000
    a = (rng.standard_normal(n)
         * np.exp2(rng.integers(-40, 40, n))).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n)
         * np.exp2(rng.integers(-80, 40, n))).astype(np.float32)
    ma, mb, mc = midpoint_triples(rng, n)
    sa = (rng.standard_normal(500) * 2.0 ** -70).astype(np.float32)
    sb = (rng.standard_normal(500) * 2.0 ** -62).astype(np.float32)
    sc = (rng.standard_normal(500) * 2.0 ** -140).astype(np.float32)
    one = np.float32(1 + 2 ** -12)
    ea = np.array([one, 0.0, -1.0, 2.0], np.float32)
    eb = np.array([one, -3.0, 0.0, -0.5], np.float32)
    ec = np.array([2 ** -70, -0.0, -0.0, 1.0], np.float32)
    A, B, C = (np.concatenate(v) for v in ((a, ma, sa, ea), (b, mb, sb, eb),
                                           (c, mc, sc, ec)))
    got = kref.fma_f32(torch.as_tensor(A), torch.as_tensor(B),
                       torch.as_tensor(C)).numpy()
    want = np.array([exact_f32(*t) for t in zip(A, B, C)], np.float32)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert float(got[-4]).hex() == "0x1.0020020000000p+0"
    # the float64 emulation that rounds twice gets the crafted case wrong
    twice = np.float32(np.float64(one) * np.float64(one) + 2.0 ** -70)
    assert float(twice).hex() == "0x1.0020000000000p+0"


def test_fma_f32_broadcasts_like_the_spin_step():
    """The shapes of the spin update: (Mp, 1) coefficients against (1, R)
    ring cosines, then (Mp, R) carries; every element as the flat call."""
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.standard_normal((5, 1)).astype(np.float32))
    x = torch.as_tensor(rng.uniform(-1, 1, (1, 7)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((5, 1)).astype(np.float32))
    got = kref.fma_f32(a, x, b)
    ae, xe, be = (v.expand(5, 7).reshape(-1) for v in (a, x, b))
    want = np.array([exact_f32(*t) for t in zip(ae.numpy(), xe.numpy(),
                                                be.numpy())], np.float32)
    assert got.shape == (5, 7)
    assert np.array_equal(got.reshape(-1).numpy(), want)


@pytest.mark.parametrize("l_max", [24, 64])
def test_contracted_spin_plain_versions_near_the_reference(l_max):
    """The spin plain versions with the contracted update against the
    reference's oracles (whose update XLA contracts alike): within TOL =
    5e-5 x max|ref|.  Measured over l_max 24, 40, 64 and K 1, 2, 8 (numpy
    inputs of ``spin_case``): at most 7.9e-6 (synthesis) and 4.6e-6
    (analysis), against 1.19e-5 and 4.3e-6 with the update rounded
    operation by operation; the remaining gap is the coefficients'
    1/sqrt against XLA's rsqrt."""
    c = spin_case(l_max, 2, seed=l_max + 2)
    t, j = torch.as_tensor, jnp.asarray
    want_s = rref.synth_ref(j(c["a"]), c["m"], j(c["x"]), j(c["pmm"]),
                            j(c["pms"]), l_max=l_max, mp_vals=c["mp"])
    want_a = rref.anal_ref(j(c["dw"]), c["m"], j(c["x"]), j(c["pmm"]),
                           j(c["pms"]), l_max=l_max, l1p=l_max + 1,
                           mp_vals=c["mp"])
    got_s = kref.synth_ref(t(c["a"]), t(c["m"]), t(c["x"]), t(c["pmm"]),
                           t(c["pms"]), l_max=l_max, mp_vals=t(c["mp"]))
    got_a = kref.anal_ref(t(c["dw"]), t(c["m"]), t(c["x"]), t(c["pmm"]),
                          t(c["pms"]), l_max=l_max, mp_vals=t(c["mp"]))
    assert rel(got_s, want_s) < TOL
    assert rel(got_a, want_a) < TOL
