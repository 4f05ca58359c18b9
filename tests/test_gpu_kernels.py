"""The GPU kernels as compiled for the card (ops/pallas_svf.py,
ops/pallas_fm.py), against their interpret-mode runs and the plain XLA
paths. They need a GPU: on the CPU they skip, and `python chip_smoke.py`
runs them on the card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the Triton kernels have no CPU build "
                    "(python chip_smoke.py runs these on the card)")


@pytest.mark.parametrize("shape", [(1, 1), (5, 37), (17, 65536),
                                   (3, 4, 1000), (300, 4096)])
def test_svf_compiled_matches_affine(gpu, shape):
    from zang_tpu.ops.filters import FILTER_MULS, svf_filter_affine
    from zang_tpu.ops.pallas_svf import svf_filter_pallas

    rng = np.random.default_rng(sum(shape))
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.3)
    cut = jnp.asarray(rng.uniform(0.05, 0.6, shape).astype(np.float32))
    act = jnp.asarray(rng.uniform(size=shape) > 0.1)
    z = jnp.zeros(shape[:-1], jnp.float32)
    muls = FILTER_MULS["notch"]
    got = jax.jit(lambda *a: svf_filter_pallas(*a[:3], muls, *a[3:]))(
        z, z, x, cut, 0.3, act)
    want = svf_filter_affine(z, z, x, muls, cut, 0.3, act)
    # f32 rounding through block seams and FMA contraction
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5)


def test_svf_compiled_under_vmap(gpu):
    """The live fleet vmaps the block step over lanes: the kernel's
    batching rule adds a grid axis."""
    from zang_tpu.ops.filters import FILTER_MULS, svf_filter_affine
    from zang_tpu.ops.pallas_svf import svf_filter_pallas

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((6, 4, 1024)).astype(np.float32))
    z = jnp.zeros((6, 4), jnp.float32)
    muls = FILTER_MULS["low_pass"]
    got = jax.jit(jax.vmap(
        lambda l, b, x: svf_filter_pallas(l, b, x, muls, 0.4, 0.7)))(z, z, x)
    want = svf_filter_affine(z, z, x, muls, 0.4, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("shape,waveform", [((1, 1), 0), ((8, 4097), 3),
                                            ((100, 2048), 1)])
def test_fm_compiled_matches_scan(gpu, shape, waveform):
    from zang_tpu.ops.fm import fm_feedback_scan
    from zang_tpu.ops.pallas_fm import fm_feedback_pallas

    rng = np.random.default_rng(sum(shape))
    base = jnp.asarray(rng.uniform(0, 50, shape).astype(np.float32))
    f0 = jnp.zeros(shape[:-1], jnp.float32)
    got = jax.jit(lambda b, f: fm_feedback_pallas(b, 0.7, waveform, f, f))(
        base, f0)
    want = fm_feedback_scan(base, jnp.float32(0.7), waveform, f0, f0)
    # both sides use the GPU's sin; contractive feedback keeps ulps bounded
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4)
