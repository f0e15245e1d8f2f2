"""The port's degradation toolkit and device bicubic against the JAX
package's on the same numpy inputs, f32 on both sides
(``tests/conftest.py`` turns on x64, so every JAX input is cast).

  * kernel generators, noise levels and the PCA fit: the port's numpy
    copies draw the same values from the same ``np.random.Generator``
    (equal);
  * ``pca_encode``, ``batch_blur`` (replicate edges), ``matlab_imresize``
    on a tensor, and ``SRMDPreprocessing`` with the noise off: within 1e-5
    (f32 sums in another order);
  * the noise path: the noise's std is sigma per example, the output is
    clipped, and one generator seed gives one output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.ops import degradation as jd
from realvsr_tpu.ops.resize import matlab_imresize as jax_imresize
from realvsr_tpu.ops.resize import matlab_imresize_np as jax_imresize_np
from realvsr_tpu_torch.ops import degradation as td
from realvsr_tpu_torch.ops.resize import matlab_imresize, matlab_imresize_np


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rngs(seed=0):
    return np.random.default_rng(seed), np.random.default_rng(seed)


@pytest.mark.parametrize("rate_iso", [1.0, 0.0, 0.5])
def test_kernel_generators_draw_as_jax(rate_iso):
    a, b = _rngs(3)
    np.testing.assert_array_equal(
        td.random_batch_kernel(a, 6, l=15, rate_iso=rate_iso),
        jd.random_batch_kernel(b, 6, l=15, rate_iso=rate_iso))
    np.testing.assert_array_equal(td.stable_batch_kernel(3, 21, 2.6),
                                  jd.stable_batch_kernel(3, 21, 2.6))
    np.testing.assert_array_equal(td.random_batch_noise(a, 8, 0.08, 0.2),
                                  jd.random_batch_noise(b, 8, 0.08, 0.2))
    k = td.random_batch_kernel(a, 1, l=21, rate_iso=rate_iso)[0]
    assert k.shape == (21, 21) and abs(float(k.sum()) - 1) < 1e-5


def test_pca_fit_and_encode_match_jax():
    rng = np.random.default_rng(1)
    data = td.random_batch_kernel(rng, 64, l=21, rate_iso=0.5).reshape(64, -1)
    basis = td.pca_fit(data, k=10)
    np.testing.assert_array_equal(basis, jd.pca_fit(data, k=10))
    kernels = data[:5].reshape(5, 21, 21).astype(np.float32)
    ours = td.pca_encode(torch.from_numpy(kernels), torch.from_numpy(basis))
    ref = jd.pca_encode(jnp.asarray(kernels), jnp.asarray(basis))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_batch_blur_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.random((3, 24, 20, 3)).astype(np.float32)
    kernels = td.random_batch_kernel(rng, 3, l=21, rate_iso=0.5)
    ours = td.batch_blur(torch.from_numpy(x), torch.from_numpy(kernels))
    ref = jd.batch_blur(jnp.asarray(x), jnp.asarray(kernels))
    assert ours.shape == (3, 24, 20, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("scale", [0.5, 0.25, 1 / 3, 2.0])
def test_matlab_imresize_on_a_tensor(scale):
    rng = np.random.default_rng(4)
    x = rng.random((2, 36, 30, 3)).astype(np.float32)
    ours = matlab_imresize(torch.from_numpy(x), scale)
    ref = np.asarray(jax_imresize(jnp.asarray(x), scale))
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
    for i in range(2):
        np.testing.assert_allclose(ours[i].numpy(),
                                   matlab_imresize_np(x[i], scale),
                                   atol=1e-5)
        np.testing.assert_allclose(matlab_imresize_np(x[i], scale),
                                   jax_imresize_np(x[i], scale), atol=1e-6)


@pytest.mark.parametrize("random_kernel", [True, False])
def test_srmd_without_noise_matches_jax(random_kernel):
    rng = np.random.default_rng(5)
    basis = td.pca_fit(td.random_batch_kernel(rng, 64, l=21).reshape(64, -1),
                       k=10)
    hr = rng.random((4, 32, 32, 3)).astype(np.float32)
    kw = dict(ksize=21, random_kernel=random_kernel, noise=False)
    a, b = _rngs(6)
    lr, codes, kernels = td.SRMDPreprocessing(2, basis, **kw)(
        a, torch.Generator(), torch.from_numpy(hr))
    jlr, jcodes, jkernels = jd.SRMDPreprocessing(2, basis, **kw)(
        b, None, jnp.asarray(hr))
    assert lr.shape == (4, 16, 16, 3) and codes.shape == (4, 10)
    np.testing.assert_array_equal(kernels.numpy(), np.asarray(jkernels))
    np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), atol=1e-5)
    np.testing.assert_allclose(codes.numpy(), np.asarray(jcodes), atol=1e-5)


def test_noise_path_sigma_clip_and_determinism():
    x = torch.full((3, 64, 64, 3), 0.5)
    sigma = torch.tensor([0.0, 0.02, 0.08])
    noisy = td.gaussian_noising(torch.Generator().manual_seed(0), x, sigma,
                                -10.0, 10.0)
    std = (noisy - x).reshape(3, -1).std(1)
    assert std[0] == 0
    np.testing.assert_allclose(std[1:].numpy(), sigma[1:].numpy(), rtol=0.05)
    clipped = td.gaussian_noising(torch.Generator().manual_seed(0),
                                  x + 0.45, sigma)
    assert clipped.max() <= 1.0 and clipped.min() >= 0.0
    assert (clipped == 1.0).any()

    basis = td.pca_fit(td.random_batch_kernel(np.random.default_rng(7), 32,
                                              l=21).reshape(32, -1), k=10)
    srmd = td.SRMDPreprocessing(2, basis, noise=True, rate_cln=0.0)
    hr = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    runs = [srmd(np.random.default_rng(8),
                 torch.Generator().manual_seed(9), hr) for _ in range(2)]
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=0, rtol=0)
    lr, codes, _ = runs[0]
    levels = td.random_batch_noise(
        _skip_kernels(np.random.default_rng(8), 4), 4, 0.08, 0.0)
    np.testing.assert_allclose(codes[:, 10].numpy(), levels * 10, rtol=1e-6)
    assert lr.min() >= 0 and lr.max() <= 1
    other = srmd(np.random.default_rng(8), torch.Generator().manual_seed(10),
                 hr)[0]
    assert not torch.equal(other, lr)


def _skip_kernels(rng, b):
    """``rng`` after SRMDPreprocessing's kernel draws of a batch of b."""
    td.random_batch_kernel(rng, b, 21)
    return rng
