"""icem_torch colored noise against the JAX package and the colorednoise package.

Identical white spectral draws, made with numpy from a seed, go through
``shape_white_spectrum`` of both packages. Tolerance 1e-5: the two compute
the same float32 operations and differ only in the matmul's summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_tpu.ops import colored_noise as jcn
from icem_torch.ops import colored_noise as tcn

NS = [1, 2, 7, 30, 31]
BETAS = [0.25, 1.0, 2.5]


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("n", NS)
def test_shape_white_spectrum_matches_jax(n, beta):
    rng = np.random.default_rng(n * 100 + int(beta * 4))
    shape = (16, 3, n // 2 + 1)
    wr = rng.standard_normal(shape).astype(np.float32)
    wi = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jcn.shape_white_spectrum(jnp.asarray(wr), jnp.asarray(wi), beta, n))
    got = tcn.shape_white_spectrum(torch.from_numpy(wr), torch.from_numpy(wi), beta, n)
    assert tuple(got.shape) == (16, 3, n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("n", NS)
def test_powerlaw_spectrum_scale_matches_jax(n, beta):
    js, jsig = jcn.powerlaw_spectrum_scale(n, beta)
    ts, tsig = tcn.powerlaw_spectrum_scale(n, beta)
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (n // 2 + 1,)
    # n = 1 keeps only the DC bin, floored at float32's tiny: its scale is
    # huge (inf at beta 2.5) in both packages, hence the relative tolerance
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tsig), float(jsig), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("beta", [0.25, 1.0, 2.5])
@pytest.mark.parametrize("n", [12, 30, 31])
def test_matches_vendored_colorednoise_package(n, beta):
    """The package draws its spectrum with ``Generator.normal(scale=...)``,
    which consumes the same standard normals as an unscaled draw, so a
    same-seeded generator recovers its white draws. Tolerance as the JAX
    package's own test of the same property."""
    from tests.vendor import colorednoise_vendored as cn

    seed = 1234
    y_pkg = cn.powerlaw_psd_gaussian(beta, (8, 3, n), random_state=np.random.default_rng(seed))
    rng = np.random.default_rng(seed)
    spec_shape = (8, 3, n // 2 + 1)
    wr = rng.normal(size=spec_shape)
    wi = rng.normal(size=spec_shape)
    got = tcn.shape_white_spectrum(torch.tensor(wr, dtype=torch.float32),
                                   torch.tensor(wi, dtype=torch.float32), beta, n)
    np.testing.assert_allclose(got.numpy(), y_pkg, rtol=3e-4, atol=3e-4)


def test_synthesis_matrices_match_jax():
    for n in NS:
        for ours, theirs in zip(tcn._irfft_synthesis_matrices(n),
                                jcn._irfft_synthesis_matrices(n)):
            assert ours.dtype == np.float32
            np.testing.assert_array_equal(ours, theirs)


def test_sample_colored_action_noise_is_seeded_and_time_major():
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tcn.sample_colored_action_noise(gen, 0.25, 4096, 30, 6)

    a, b, c = draw(0), draw(0), draw(1)
    assert tuple(a.shape) == (4096, 30, 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the package's normalisation gives the part that varies along the
    # horizon unit std (tests/test_colored_noise.py::test_unit_variance)
    ac = a - a.mean(dim=1, keepdim=True)
    assert abs(float(ac.std()) - 1.0) < 0.03
    assert abs(float(a.std()) - 1.0) < 0.05


def test_powerlaw_psd_gaussian_uses_last_axis_as_time():
    gen = torch.Generator().manual_seed(3)
    y = tcn.powerlaw_psd_gaussian(gen, 2.0, (2048, 64))
    assert tuple(y.shape) == (2048, 64)
    # strongly colored noise: neighbouring samples are correlated in time
    lag1 = float(torch.mean(y[:, 1:] * y[:, :-1]) / torch.mean(y * y))
    assert lag1 > 0.5
