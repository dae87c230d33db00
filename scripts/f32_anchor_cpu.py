"""The float32 scheme's own error at the float64 anchor's shape, on the CPU.

    PYTHONPATH=src python scripts/f32_anchor_cpu.py

For GL l_max 512 and HEALPix nside 256 (l_max 512), spin 0 and 2, K 2, a
uniform alm draw (numpy, seed 0): max|float32 maps - float64 maps| /
max|float64 maps| of the port's float32 kernel schedule (its plain
versions, ``layout="plain"``) and of the reference's float32 ``jnp`` plan,
both against the port's float64 ``torch`` plan, and the ring of the
port's largest error.  About a minute.
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

for kind, kw in (("healpix", dict(nside=256)), ("gl", dict(l_max=512))):
    for spin in (0, 2):
        t = time.time()
        p64 = repro_torch.make_plan(kind, **kw, K=2, spin=spin, device="cpu")
        rng = np.random.default_rng(0)
        shp = p64._alm_shape
        keep = np.arange(p64.l_max + 1)[None, :] >= np.maximum(
            np.arange(p64.m_max + 1), spin)[:, None]
        a = (rng.uniform(-1, 1, shp) + 1j * rng.uniform(-1, 1, shp)) \
            * keep[..., None]
        a[..., 0, :, :] = a[..., 0, :, :].real
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
        print(f"{kind} {kw} spin {spin}: port float32 schedule {e_port:.3e}, "
              f"reference float32 jnp plan {e_ref:.3e}; the port's largest "
              f"error on ring {ring} of {p64.grid.n_rings} "
              f"({time.time() - t:.1f} s)", flush=True)
