"""The float32 scheme's own error on the CPU: the float64 anchor, the
round trip, and a bisect of the spin-2 round trip's gap, the port's plain
versions beside the reference's jnp plan.

    PYTHONPATH=src python scripts/f32_anchor_cpu.py [anchor] [roundtrip] [bisect]

``anchor``: for GL l_max 512 and HEALPix nside 256 (l_max 512), spin 0
and 2, K 2, a uniform alm draw (numpy, seed 0): max|float32 maps -
float64 maps| / max|float64 maps| of the port's float32 kernel schedule
(its plain versions, ``layout="plain"``) and of the reference's float32
``jnp`` plan, both against the port's float64 ``torch`` plan, and the
ring of the port's largest error.  About a minute.

``roundtrip``: for GL l_max 512, 1024 and 2048, K 1, spin 0 and 2, the
same kind of draw: d_err(alm, map2alm(alm2map(alm))) (paper eq. 19) of
the port's float32 plain plan (``device="cpu"``) and of the reference's
float32 ``jnp`` plan, and for each side the spin-2 over spin-0 ratio at
each l_max: the same ratio on both sides says the spin gap is the float32
scheme's, a different one points at the port.  About 18 minutes, 16 of
them at l_max 2048.

``bisect``: the float32 Wigner-d (spin 2) and Legendre (spin 0) values of
a few rows on every ring of GL l_max 2048 against the same recurrence in
float64, through the port's step and the reference's, each from its own
seeds and from the other's, and through variants of the port's step
(rsqrt, coefficients rounded from float64, the update contracted into
fused multiply-adds as XLA's CPU build contracts the reference's, which
the port's spin step now does itself); then the spin-2 round trip of
``roundtrip`` with the contracted update.  About 27 minutes, 25 of them in
that round trip.

No argument runs ``anchor`` and ``roundtrip``.
"""
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import spectra  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402


def uniform_alm(shape, l_max: int, m_max: int, spin: int) -> np.ndarray:
    """Real and imaginary parts uniform in (-1, 1) (numpy, seed 0), zero
    below max(m, spin), real at m = 0; ``shape`` (..., M, L, K)."""
    rng = np.random.default_rng(0)
    keep = np.arange(l_max + 1)[None, :] >= np.maximum(
        np.arange(m_max + 1), spin)[:, None]
    a = (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)) \
        * keep[..., None]
    a[..., 0, :, :] = a[..., 0, :, :].real
    return a


def anchor() -> None:
    for kind, kw in (("healpix", dict(nside=256)), ("gl", dict(l_max=512))):
        for spin in (0, 2):
            t = time.time()
            p64 = repro_torch.make_plan(kind, **kw, K=2, spin=spin,
                                        device="cpu")
            a = uniform_alm(p64._alm_shape, p64.l_max, p64.m_max, spin)
            m64 = p64.alm2map(torch.as_tensor(a))
            p32 = repro_torch.make_plan(kind, **kw, K=2, spin=spin,
                                        dtype="float32", mode="cuda_vpu",
                                        layout="plain", device="cpu")
            m32 = p32.alm2map(torch.as_tensor(a.astype(np.complex64)))
            err = (m32 - m64).abs()
            e_port = float(err.max() / m64.abs().max())
            rp = repro.make_plan(kind, **kw, K=2, spin=spin, dtype="float32",
                                 mode="jnp")
            rm = np.asarray(rp.alm2map(jnp.asarray(a.astype(np.complex64))))
            e_ref = float(np.abs(rm - m64.numpy()).max() / m64.abs().max())
            ring = np.unravel_index(int(err.argmax()), err.shape)[-3]
            print(f"{kind} {kw} spin {spin}: port float32 schedule "
                  f"{e_port:.3e}, reference float32 jnp plan {e_ref:.3e}; "
                  f"the port's largest error on ring {ring} of "
                  f"{p64.grid.n_rings} ({time.time() - t:.1f} s)", flush=True)


def roundtrip() -> None:
    for l_max in (512, 1024, 2048):
        errs = {}
        for spin in (0, 2):
            t = time.time()
            p32 = repro_torch.make_plan("gl", l_max, K=1, spin=spin,
                                        dtype="float32", mode="cuda_vpu",
                                        layout="plain", device="cpu")
            a = uniform_alm(p32._alm_shape, l_max, l_max, spin).astype(
                np.complex64)
            at = torch.as_tensor(a)
            port = spectra.d_err(at, p32.map2alm(p32.alm2map(at)))
            t_port = time.time() - t
            t = time.time()
            rp = repro.make_plan("gl", l_max=l_max, K=1, spin=spin,
                                 dtype="float32", mode="jnp")
            aj = jnp.asarray(a)
            ref = spectra.d_err(a, np.asarray(rp.map2alm(rp.alm2map(aj))))
            errs[spin] = (port, ref)
            print(f"GL l_max {l_max} K 1 spin {spin}: round-trip d_err port "
                  f"float32 plain plan {port:.4e} ({t_port:.1f} s), "
                  f"reference float32 jnp plan {ref:.4e} "
                  f"({time.time() - t:.1f} s)", flush=True)
        (p0, r0), (p2, r2) = errs[0], errs[2]
        print(f"GL l_max {l_max}: spin 2 / spin 0, port {p2 / p0:.3f}, "
              f"reference {r2 / r0:.3f}", flush=True)


def _fma(a, b, c):
    """a b + c of float32 tensors rounded once, as a fused multiply-add
    (``kernels.ref.fma_f32``)."""
    return kref.fma_f32(a, b, c)


def _variant_step(spin, *, inv_sqrt=None, coef_dtype=torch.float32,
                  contract=False):
    """The port's step (``kernels.ref._f32_step_spin``, spin 0
    ``_f32_step``) with, for spin, 1/sqrt(d2) taken by ``inv_sqrt`` and the
    coefficients computed in ``coef_dtype`` and rounded to float32; with
    ``contract`` the update contracted into fused multiply-adds as XLA's
    CPU build contracts the reference's: fma(fma(a, x, b), pc, -(c pp))
    (spin 0: fma(beta x, pc, -(ratio pp)))."""
    def step(lf, m_f, mp_f, x, pp, pc, sc, pmm, pms, coefs=None):
        # the row coefficients are computed here, whatever ``coefs`` holds
        if not torch.is_tensor(lf):
            lf = torch.tensor(float(lf), dtype=torch.float32)
        if not spin:
            lb = torch.maximum(lf, m_f + 2.0)
            bl = 1.0 / torch.sqrt((lb * lb - m_f * m_f) / (4.0 * lb * lb - 1.0))
            lb1 = torch.maximum(lf - 1.0, m_f + 1.0)
            bl1 = 1.0 / torch.sqrt((lb1 * lb1 - m_f * m_f)
                                   / (4.0 * lb1 * lb1 - 1.0))
            ratio = bl / bl1
            p_rec = (_fma(bl * x, pc, -(ratio * pp)) if contract
                     else bl * x * pc - ratio * pp)
            p_first = torch.sqrt(torch.clamp(2.0 * m_f + 3.0, min=0.0)) * x * pc
            p_new = torch.where(lf == m_f + 1.0, p_first, p_rec)
            return kref._rescale(lf, m_f, p_new, pp, pc, sc, pmm, pms)
        lf2, m2, mp2 = (v.to(coef_dtype) for v in (lf, m_f, mp_f))
        l0 = torch.maximum(m2, mp2.abs())
        ls = torch.maximum(lf2, l0 + 1.0)
        d2 = torch.clamp((ls * ls - m2 * m2) * (ls * ls - mp2 * mp2),
                         min=1e-30)
        lm1 = ls - 1.0
        d2m1 = torch.clamp((lm1 * lm1 - m2 * m2) * (lm1 * lm1 - mp2 * mp2),
                           min=0.0)
        s2l = torch.sqrt(4.0 * ls * ls - 1.0)
        inv_d = (inv_sqrt or (lambda d: 1.0 / torch.sqrt(d)))(d2)
        inv_lm1 = 1.0 / torch.clamp(lm1, min=1.0)
        a = (ls * s2l * inv_d).float()
        b = (-(m2 * mp2) * s2l * inv_d * inv_lm1).float()
        c = (torch.sqrt((2.0 * ls + 1.0) / torch.clamp(2.0 * ls - 3.0,
                                                       min=1.0))
             * ls * torch.sqrt(d2m1) * inv_d * inv_lm1).float()
        p_rec = (_fma(_fma(a, x, b), pc, -(c * pp)) if contract
                 else (a * x + b) * pc - c * pp)
        return kref._rescale(lf, l0.float(), p_rec, pp, pc, sc, pmm, pms)
    return step


def bisect(l_max: int = 2048) -> None:
    """The spin-2 Wigner-d values lambda_lm(x_r) of a few rows (m in
    M_ROWS, m' = -2 and +2) on every ring of GL l_max, in float32 through
    the port's step and the reference's, each from its own seeds and from
    the other's, and through variants of the port's step, against the same
    recurrence in float64 from float64 seeds; the spin-0 P_lm of the same
    m beside them.  Prints the relative RMS error of each chain over
    l < l_max / 2 and over l >= l_max / 2."""
    import jax
    from repro.core import legendre as rleg
    from repro.kernels import legendre_pallas as rlp
    from repro.kernels import ref as rref
    from repro_torch.core import grids, legendre
    from repro_torch.kernels import ops

    g = grids.make_grid("gl", l_max=l_max)
    x64 = torch.as_tensor(g.cos_theta)[None, :]
    m_rows = np.array([m for m in M_ROWS if m < l_max])
    half = (l_max + 1) // 2
    for spin in (0, 2):
        t = time.time()
        if spin:
            m, mp = ops.spin_rows(m_rows)
            lf_seed = legendre.log_factorials(2 * l_max + 1)
            seeds64 = legendre.spin_seeds_scaled(
                m, mp, g.cos_theta, g.sin_theta, lf_seed,
                dtype=torch.float64, scale_bits=64)
            port_seeds = kref.prepare_seeds_spin(m, mp, g.cos_theta,
                                                 g.sin_theta, m_max=l_max)
            ref_seeds = tuple(np.asarray(v) for v in rref.prepare_seeds_spin(
                m, mp, g.cos_theta, g.sin_theta, m_max=l_max))
            port_step = kref._f32_step_spin
            ref_step = jax.jit(rlp._f32_step_spin)
        else:
            m, mp = m_rows, np.zeros_like(m_rows)
            log_mu = legendre.log_mu(l_max)
            mant, scale = kref.prepare_seeds(m, g.sin_theta, log_mu)
            # the float64 seeds of the same formula, before the cast
            msafe = np.maximum(m, 0)
            log_p = (np.asarray(log_mu, np.float64)[msafe][:, None]
                     + msafe[:, None] * np.log(g.sin_theta)[None, :])
            den = 64 * np.log(2.0)
            sc64 = np.minimum(np.round(log_p / den), 0.0)
            seeds64 = (torch.as_tensor(np.exp(log_p - sc64 * den)),
                       torch.as_tensor(sc64.astype(np.int32)))
            port_seeds = (mant, scale)
            ref_seeds = tuple(np.asarray(v) for v in rref.prepare_seeds(
                m, g.sin_theta, rleg.log_mu(l_max)))
            port_step = lambda lf, m_f, mp_f, *a: kref._f32_step(  # noqa
                lf, m_f, *a)
            ref_step = jax.jit(lambda lf, m_f, mp_f, *a: rlp._f32_step(
                lf, m_f, *a))
        f32 = torch.float32
        m_f = torch.as_tensor(m, dtype=torch.float64)[:, None]
        mp_f = torch.as_tensor(mp, dtype=torch.float64)[:, None]

        def torch_chain(step, seeds, dtype):
            pmm = torch.as_tensor(np.asarray(seeds[0])).to(dtype)
            pms = torch.as_tensor(np.asarray(seeds[1])).to(torch.int32)
            z = torch.zeros(pmm.shape, dtype=dtype)
            st = [z, z.clone(), torch.zeros(pmm.shape, dtype=torch.int32)]
            xb, mf, mpf = x64.to(dtype), m_f.to(dtype), mp_f.to(dtype)

            def adv(l):
                *st[:], v = step(torch.tensor(float(l), dtype=dtype), mf,
                                 mpf, xb, *st, pmm, pms)
                return v.double()
            return adv

        def jax_chain(step, seeds):
            pmm = jnp.asarray(np.asarray(seeds[0]), jnp.float32)
            pms = jnp.asarray(np.asarray(seeds[1]), jnp.int32)
            st = [jnp.zeros(pmm.shape, jnp.float32),
                  jnp.zeros(pmm.shape, jnp.float32),
                  jnp.zeros(pmm.shape, jnp.int32)]
            xb = jnp.asarray(x64.numpy(), jnp.float32)
            mf = jnp.asarray(m_f.numpy(), jnp.float32)
            mpf = jnp.asarray(mp_f.numpy(), jnp.float32)

            def adv(l):
                *st[:], v = step(jnp.float32(l), mf, mpf, xb, *st, pmm, pms)
                return torch.as_tensor(np.asarray(v)).double()
            return adv

        truth = torch_chain(port_step, seeds64, torch.float64)
        chains = {
            "port step, port seeds": torch_chain(port_step, port_seeds, f32),
            "reference step, reference seeds": jax_chain(ref_step, ref_seeds),
            "port step, reference seeds": torch_chain(port_step, ref_seeds,
                                                      f32),
            "reference step, port seeds": jax_chain(ref_step, port_seeds),
        }
        if spin:
            chains["port step, 1/sqrt(d2) as torch.rsqrt"] = torch_chain(
                _variant_step(spin, inv_sqrt=torch.rsqrt), port_seeds, f32)
            chains["port step, a b c in float64, rounded"] = torch_chain(
                _variant_step(spin, coef_dtype=torch.float64), port_seeds,
                f32)
        chains["port step, update contracted as XLA's CPU build"] = \
            torch_chain(_variant_step(spin, contract=True), port_seeds, f32)
        err = {k: np.zeros(2) for k in chains}
        ref2 = np.zeros(2)
        for l in range(l_max + 1):
            tv = truth(l)
            band = int(l >= half)
            ref2[band] += float((tv ** 2).sum())
            for k, adv in chains.items():
                err[k][band] += float(((adv(l) - tv) ** 2).sum())
        print(f"GL l_max {l_max} spin {spin}, rows m {m_rows.tolist()}"
              + (" x m' -2, +2" if spin else "")
              + f", {g.n_rings} rings ({time.time() - t:.1f} s): relative "
              f"RMS error against float64, l < {half} | l >= {half}",
              flush=True)
        for k, e in err.items():
            r = np.sqrt(e / ref2)
            print(f"  {k}: {r[0]:.3e} | {r[1]:.3e}", flush=True)
    # the spin-2 round trip of roundtrip() with the update contracted
    t = time.time()
    p32 = repro_torch.make_plan("gl", l_max, K=1, spin=2, dtype="float32",
                                mode="cuda_vpu", layout="plain", device="cpu")
    a = torch.as_tensor(uniform_alm(p32._alm_shape, l_max, l_max, 2).astype(
        np.complex64))
    plain_step = kref._f32_step_spin
    kref._f32_step_spin = _variant_step(2, contract=True)
    try:
        err = spectra.d_err(a, p32.map2alm(p32.alm2map(a)))
    finally:
        kref._f32_step_spin = plain_step
    print(f"GL l_max {l_max} K 1 spin 2: round-trip d_err of the port's "
          f"float32 plain plan with the update contracted {err:.4e} "
          f"({time.time() - t:.1f} s)", flush=True)


#: the rows of :func:`bisect`
M_ROWS = (0, 1, 2, 3, 16, 64, 256, 512, 1024, 1536)


if __name__ == "__main__":
    parts = sys.argv[1:] or ["anchor", "roundtrip"]
    if "anchor" in parts:
        anchor()
    if "roundtrip" in parts:
        roundtrip()
    if "bisect" in parts:
        bisect()
