"""Path choice (ops/backend.py): GPU kernels on a GPU, the plain XLA paths
on the CPU, an error elsewhere; the semantic splits that stay on the
affine scan; and the compile-cache location rule (zang_tpu/platform.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from zang_tpu.ops import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,mix,per_sample_res,want", [
    ("cpu", False, False, False),
    ("cpu", True, False, False),
    ("gpu", False, False, True),
    ("gpu", True, False, False),
    ("gpu", False, True, False),
])
def test_use_kernel(platform, mix, per_sample_res, want):
    assert backend.use_kernel(platform, mix=mix,
                              per_sample_res=per_sample_res) is want


def test_unknown_platform_raises():
    with pytest.raises(RuntimeError, match="no implementation"):
        backend.use_kernel("rocm")


def test_cpu_default_takes_plain_path():
    assert backend.use_kernel() is False


def _force_gpu_path(monkeypatch):
    monkeypatch.setattr(
        backend, "use_kernel",
        lambda platform=None, *, mix=False, per_sample_res=False:
        not (mix or per_sample_res))


@pytest.mark.parametrize("ftype,res_per_sample,kernel", [
    ("low_pass", False, True),
    ("mix", False, False),
    ("notch", True, False),
])
def test_svf_routing(monkeypatch, ftype, res_per_sample, kernel):
    """With the GPU's path choice, svf_filter hands scalar-res fixed-type
    filters to the kernel and keeps "mix" and per-sample res on the affine
    scan; both paths agree."""
    from zang_tpu.ops import filters, pallas_svf

    calls = []
    orig = pallas_svf.svf_filter_pallas

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k, interpret=True)

    monkeypatch.setattr(pallas_svf, "svf_filter_pallas", spy)
    _force_gpu_path(monkeypatch)
    rng = np.random.default_rng(2)
    V, n = 3, 200
    x = jnp.asarray(rng.standard_normal((V, n)).astype(np.float32) * 0.3)
    cut = jnp.asarray(rng.uniform(0.1, 0.5, (V, n)).astype(np.float32))
    res = (jnp.asarray(rng.uniform(0.1, 0.5, (V, n)).astype(np.float32))
           if res_per_sample else 0.3)
    muls = (jnp.float32(0.5), jnp.float32(0.25), jnp.float32(1.0))
    z = jnp.zeros((V,), jnp.float32)
    got = filters.svf_filter(z, z, x, ftype, cut, res,
                             muls=muls if ftype == "mix" else None)
    assert bool(calls) is kernel
    want = filters.svf_filter_affine(
        z, z, x, muls if ftype == "mix" else filters.FILTER_MULS[ftype],
        cut, res)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=2e-6)


def test_fm_routing(monkeypatch):
    """With the GPU's path choice, fm_osc's feedback loop runs the FM
    kernel, and it equals the lax.scan path it replaces."""
    from zang_tpu.ops import fm, pallas_fm

    cnt0 = jnp.zeros((2,), jnp.uint32)
    freq = jnp.full((2, 300), 330.0, jnp.float32)
    fb0 = (jnp.zeros(2), jnp.zeros(2))
    want = fm.fm_osc(cnt0, freq, 0.0, 0, 0.8, fb0, 48000.0)

    calls = []
    orig = pallas_fm.fm_feedback_pallas

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k, interpret=True)

    monkeypatch.setattr(pallas_fm, "fm_feedback_pallas", spy)
    _force_gpu_path(monkeypatch)
    got = fm.fm_osc(cnt0, freq, 0.0, 0, 0.8, fb0, 48000.0)
    assert calls
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(np.asarray(got[1][0]),
                                  np.asarray(want[1][0]))


def _cache_dir_in_fresh_process(env):
    code = ("import jax\n"
            "from zang_tpu.platform import enable_compile_cache\n"
            "path = enable_compile_cache()\n"
            "print(path)\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return out.stdout.split()


def test_compile_cache_honors_env(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert _cache_dir_in_fresh_process(env) == [str(tmp_path)] * 2


def test_compile_cache_defaults_to_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    want = os.path.join(REPO, ".jax_cache")
    assert _cache_dir_in_fresh_process(env) == [want, want]
