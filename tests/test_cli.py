"""CLI entry points (render_wav, examples) end-to-end on tiny renders."""

import os
import subprocess
import sys

import numpy as np

from zang_tpu.core.wav import read_wav


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_initializes_no_backend():
    """Importing the framework (even the jax-heavy subpackages) must not
    initialize a JAX backend: platform selection (JAX_PLATFORMS, user
    jax.config calls) has to still be possible afterwards. Regression
    guard for module-scope jnp scalars (a jnp.float32 constant creates a
    device array at import)."""
    code = (
        "import zang_tpu.serve.server, zang_tpu.graph.render, "
        "zang_tpu.host.examples, zang_tpu.ops.filters, zang_tpu.ops.fm\n"
        "import jax._src.xla_bridge as xb\n"
        "assert not xb._backends, f'backend initialized: {list(xb._backends)}'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=600,
                   cwd=REPO)


def test_zang_platform_env_selects_backend():
    """JAX_PLATFORMS=cpu selects the CPU backend for the package and its
    CLIs; nothing in zang_tpu overrides the platform JAX picks."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = (
        "import zang_tpu\n"
        "from zang_tpu.platform import enable_compile_cache\n"
        "enable_compile_cache()\n"
        "import jax\n"
        "assert jax.default_backend() == 'cpu', jax.default_backend()\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=600,
                   cwd=REPO, env=env)


def test_render_wav_cli_song(tmp_path, capsys):
    from zang_tpu.host.render_wav import main

    out = tmp_path / "song.wav"
    main(["song", str(out), "--seconds", "1", "--chunk", "8192"])
    msg = capsys.readouterr().out
    assert "engine=device" in msg
    w = read_wav(str(out))
    pcm = np.frombuffer(w.data, dtype="<i2")
    assert w.sample_rate == 48000 and len(pcm) == 48000
    assert np.abs(pcm).max() > 100


def test_render_wav_cli_oracle_engine(tmp_path):
    from zang_tpu.host.render_wav import main

    out = tmp_path / "song_oracle.wav"
    main(["song", str(out), "--seconds", "1", "--engine", "oracle"])
    w = read_wav(str(out))
    assert len(np.frombuffer(w.data, dtype="<i2")) == 48000


def test_examples_cli(tmp_path, capsys):
    from zang_tpu.host.examples import main

    out = tmp_path / "vib.wav"
    main(["vibrato", str(out), "--seconds", "1"])
    assert "wrote" in capsys.readouterr().out
    w = read_wav(str(out))
    pcm = np.frombuffer(w.data, dtype="<i2")
    assert len(pcm) == 48000 and np.abs(pcm).max() > 50
