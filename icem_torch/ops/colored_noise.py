"""Colored (1/f^beta) Gaussian noise, shaped in the rFFT domain.

Counterpart of ``icem_tpu/ops/colored_noise.py`` (the Timmer & Koenig
power-law PSD algorithm of the ``colorednoise`` package the reference uses):
white spectral draws are scaled by ``f^(-beta/2)``, the DC (and, for even n,
the Nyquist) bin is made real with its magnitude fixed by sqrt(2), and the
inverse rFFT, a dense DFT-synthesis matmul, is normalised by the theoretical
output std.

The matmuls run in full float32: TF32 (``torch.backends.cuda.matmul.
allow_tf32``) keeps about three decimal digits and would break the parity
with the package at 2e-4.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from icem_torch.device import on_device

@lru_cache(maxsize=None)
def _irfft_synthesis_matrices(n: int):
    """Real matrices (C, D) with irfft(S, n) = Re(S) @ C + Im(S) @ D, built
    in float64 numpy and rounded to float32 once."""
    nf = n // 2 + 1
    k = np.arange(nf)[:, None]
    t = np.arange(n)[None, :]
    ang = 2.0 * np.pi * k * t / n
    coef = np.full((nf, 1), 2.0)
    coef[0] = 1.0
    if n % 2 == 0 and n > 1:
        coef[-1] = 1.0
    C = (coef * np.cos(ang) / n).astype(np.float32)
    D = (-coef * np.sin(ang) / n).astype(np.float32)
    return C, D


@lru_cache(maxsize=None)
def _synthesis_on(n: int, device: torch.device):
    return on_device(_irfft_synthesis_matrices(n), device)


def powerlaw_spectrum_scale(n: int, beta: float, fmin: float = 0.0,
                            dtype=torch.float32):
    """Per-rFFT-bin std scale ``s_scale`` [n//2 + 1] and the normalisation
    ``sigma`` (a 0-d tensor), on the CPU."""
    if n < 1:
        raise ValueError("need at least one sample")
    nf = n // 2 + 1
    f = torch.arange(nf, dtype=dtype) / n   # rfftfreq in f32
    fmin = max(float(fmin), 1.0 / n)
    # bins below the cutoff take the scale of the first kept bin
    ix = min(int(torch.sum(f < torch.tensor(fmin, dtype=dtype))), nf - 1)
    f_eff = torch.where(torch.arange(nf) < ix, f[ix], f)
    # avoid 0^negative at DC when every bin is kept (n == 1)
    f_eff = torch.clamp(f_eff, min=torch.finfo(dtype).tiny)
    s_scale = f_eff ** (-beta / 2.0)

    # theoretical output std of the unnormalised series
    w = s_scale[1:].clone() if n > 1 else s_scale.clone()
    if n > 1:
        w[-1] = w[-1] * ((1.0 + (n % 2)) / 2.0)  # halve Nyquist for even n
    sigma = 2.0 * torch.sqrt(torch.sum(w**2)) / n
    return s_scale, sigma


@lru_cache(maxsize=None)
def _spectrum_on(n: int, beta: float, fmin: float, dtype, device: torch.device):
    """(s_scale, sigma, imag_keep, real_fix) for one shape, built once on the
    host and kept on the device, so a draw costs no host round trip.

    DC must be real, and Nyquist for even n: ``imag_keep`` zeroes their
    imaginary parts and ``real_fix`` multiplies their real parts by sqrt(2),
    to carry the power of the dropped halves (the package's "Fix magnitude").
    """
    s_scale, sigma = powerlaw_spectrum_scale(n, beta, fmin, dtype)
    real_only = torch.zeros(n // 2 + 1, dtype=torch.bool)
    real_only[0] = True
    if n % 2 == 0 and n > 1:
        real_only[-1] = True
    imag_keep = (~real_only).to(dtype)
    real_fix = torch.where(real_only, math.sqrt(2.0), 1.0).to(dtype)
    return on_device((s_scale, sigma, imag_keep, real_fix), device, dtype)


def shape_white_spectrum(white_real, white_imag, beta: float, n: int,
                         fmin: float = 0.0):
    """Shape unit-Gaussian spectral draws [..., n//2 + 1] into unit-variance
    1/f^beta noise [..., n]."""
    dtype, device = white_real.dtype, white_real.device
    s_scale, sigma, imag_keep, real_fix = _spectrum_on(
        n, float(beta), float(fmin), dtype, device)
    sr = white_real * s_scale * real_fix
    si = white_imag * s_scale * imag_keep
    C, D = _synthesis_on(n, device)
    y = sr.float() @ C + si.float() @ D
    return y.to(dtype) / sigma


def powerlaw_psd_gaussian(generator: torch.Generator, beta: float, shape,
                          fmin: float = 0.0, dtype=torch.float32):
    """Gaussian 1/f^beta noise with unit variance on the generator's device;
    the LAST axis of ``shape`` is the correlated (time) axis."""
    n = shape[-1]
    spec_shape = tuple(shape[:-1]) + (n // 2 + 1,)
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    white_real = torch.randn(spec_shape, **kw)
    white_imag = torch.randn(spec_shape, **kw)
    return shape_white_spectrum(white_real, white_imag, beta, n, fmin)


def sample_colored_action_noise(generator: torch.Generator, beta: float,
                                num_traj: int, horizon: int, dim: int,
                                dtype=torch.float32):
    """[num_traj, horizon, dim] noise, correlated along the horizon and
    independent per action dimension: drawn as (p, d, h), swapped to
    (p, h, d) as the reference does."""
    noise = powerlaw_psd_gaussian(generator, beta, (num_traj, dim, horizon),
                                  dtype=dtype)
    return noise.transpose(-1, -2)
