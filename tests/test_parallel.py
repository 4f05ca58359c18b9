"""Multi-chip sharding: voice-sharded render must equal the single-device
render, on an 8-virtual-device CPU mesh (conftest forces the device count)."""

import numpy as np
import pytest

import jax

from zang_tpu.core.timeline import compile_timelines
from zang_tpu.graph.fidelity import deviation_dbfs
from zang_tpu.graph.render import Performance, render_performance
from zang_tpu.host import instruments as ti
from zang_tpu.host import song as sm
from zang_tpu.parallel.mesh import make_mesh, pad_timelines, render_performance_sharded


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestVoiceSharding:
    def test_sharded_equals_unsharded(self):
        sr = sm.SAMPLE_RATE
        total = int(2.0 * sr)
        song = sm.load_song()
        mesh = make_mesh(8)

        def build(padded):
            tls = [
                compile_timelines(song[i], sm.POLYPHONY[i], sr, total)
                for i in range(3)
            ]
            if padded:
                tls = [pad_timelines(t, 8) for t in tls]
            return Performance(
                [
                    (ti.PMOscInstrument(0.4, freq_fn=sm.pedal_freq), tls[0]),
                    (ti.NiceInstrument(0.25), tls[1]),
                    (ti.NiceInstrument(0.1), tls[2]),
                ],
                sr,
            )

        base = render_performance(build(False), total, chunk_size=16384)
        sharded = render_performance_sharded(
            build(True), total, mesh, chunk_size=16384)
        dev = deviation_dbfs(base, sharded)
        # silent padded voices contribute exact zeros; remaining deviation is
        # reduction-order ulps in the cross-device mix sum
        assert dev[0] < -120.0, dev

    def test_dryrun_entrypoint(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)

    def test_entry_compiles(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert np.isfinite(np.asarray(out)).all()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestShardedPallasKernels:
    """Voice sharding over the GPU kernel path.

    On the CPU the filter takes the affine scan, so the plain sharding
    tests never reach the kernels. Here the path choice is set to the
    GPU's and the SVF kernel runs in interpret mode: the voice-sharded
    render must go through ops/backend.voice_parallel's shard_map (a
    kernel call is opaque to GSPMD) and still equal the one-device render.
    """

    def test_sharded_pallas_interpret_equals_unsharded(self, monkeypatch):
        from zang_tpu.ops import backend, pallas_svf

        calls = {"kernel": 0, "sharded": 0}
        orig_kernel = pallas_svf.svf_filter_pallas
        orig_vp = backend.voice_parallel

        def spy_kernel(*a, **k):
            calls["kernel"] += 1
            return orig_kernel(*a, **k, interpret=True)

        def spy_vp(fn, voice_args, shared_args=()):
            if backend._auto_axes():
                calls["sharded"] += 1
            return orig_vp(fn, voice_args, shared_args)

        monkeypatch.setattr(pallas_svf, "svf_filter_pallas", spy_kernel)
        monkeypatch.setattr(backend, "voice_parallel", spy_vp)
        monkeypatch.setattr(
            backend, "use_kernel",
            lambda platform=None, *, mix=False, per_sample_res=False:
            not (mix or per_sample_res))

        sr = sm.SAMPLE_RATE
        total = int(1.0 * sr)
        song = sm.load_song()
        mesh = make_mesh(8)

        def build(padded):
            tls = [
                compile_timelines(song[i], sm.POLYPHONY[i], sr, total)
                for i in range(3)
            ]
            if padded:
                tls = [pad_timelines(t, 8) for t in tls]
            return Performance(
                [
                    (ti.PMOscInstrument(0.4, freq_fn=sm.pedal_freq), tls[0]),
                    (ti.NiceInstrument(0.25), tls[1]),
                    (ti.NiceInstrument(0.1), tls[2]),
                ],
                sr,
            )

        base = render_performance(build(False), total, chunk_size=16384)
        assert calls["kernel"] > 0, "kernel path was not taken"
        assert calls["sharded"] == 0
        sharded = render_performance_sharded(
            build(True), total, mesh, chunk_size=16384)
        assert calls["sharded"] > 0, "kernel was not split over the mesh"
        dev = deviation_dbfs(base, sharded)
        # identical kernel arithmetic on both sides; only the cross-device
        # mix reduction order differs
        assert dev[0] < -120.0, dev

    def test_voice_parallel_pads_and_crops(self):
        """A voice count that does not divide the mesh is padded for the
        shard_map and cropped after; the FM kernel (interpret) under a
        mesh equals the unsharded call."""
        import jax.numpy as jnp

        from zang_tpu.ops.pallas_fm import fm_feedback_pallas

        rng = np.random.default_rng(3)
        V, n = 13, 96
        base = jnp.asarray(rng.uniform(0, 30, (V, n)).astype(np.float32))
        f1 = jnp.zeros((V,), jnp.float32)
        run = jax.jit(lambda b, f: fm_feedback_pallas(b, 0.5, 1, f, f,
                                                       interpret=True))
        want = run(base, f1)
        with jax.set_mesh(make_mesh(8)):
            got = jax.jit(lambda b, f: fm_feedback_pallas(
                b, 0.5, 1, f, f, interpret=True))(base, f1)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


class TestShardedPostFx:
    def test_poly_echo_sharded_equals_unsharded(self):
        # stereo-echoes post chain: per-part states shard on voices, the
        # post-fx delay lines replicate (their leading axis is time and
        # 15000 % 8 == 0 would otherwise shard it by accident)
        from zang_tpu.host import configs
        from zang_tpu.parallel.mesh import make_mesh, render_performance_sharded
        from zang_tpu.graph.render import render_performance

        perf, total = configs.build_poly_echo_performance(
            num_voices=16, seconds=1.5, sample_rate=44100.0, main_delay=15000)
        ref = render_performance(perf, total, chunk_size=8192)
        mesh = make_mesh(8)
        got = render_performance_sharded(perf, total, mesh, chunk_size=8192)
        assert got.shape == ref.shape
        d = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
        rms_db = 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)
        assert rms_db < -120.0, rms_db
