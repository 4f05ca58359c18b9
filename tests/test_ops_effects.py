"""Parity tests for noise/distortion/decimator/delay/sampler kernels."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zang_tpu.core.span import Span
from zang_tpu.graph.fidelity import deviation_dbfs
from zang_tpu.ops import delay as d_ops
from zang_tpu.ops import effects, noise, sampler
from zang_tpu.oracle import modules as om
from zang_tpu.oracle import instruments as oi


class TestDistortion:
    def test_overdrive_matches_oracle(self):
        x = (np.random.default_rng(0).standard_normal(4096) * 0.5).astype(np.float32)
        a = np.zeros(4096, dtype=np.float32)
        om.Distortion().paint(Span(0, 4096), [a], [], True, {
            "input": x, "type": "overdrive", "ingain": 0.25, "outgain": 0.8, "offset": 0.1,
        })
        b = np.asarray(effects.distortion(jnp.asarray(x), "overdrive", 0.25, 0.8, 0.1))
        dev = deviation_dbfs(a, b)
        assert dev[1] < -120.0, dev

    def test_clip_matches_oracle(self):
        x = np.linspace(-2, 2, 1000, dtype=np.float32)
        a = np.zeros(1000, dtype=np.float32)
        om.Distortion().paint(Span(0, 1000), [a], [], True, {
            "input": x, "type": "clip", "ingain": 0.3, "outgain": 1.0, "offset": -0.2,
        })
        b = np.asarray(effects.distortion(jnp.asarray(x), "clip", 0.3, 1.0, -0.2))
        dev = deviation_dbfs(a, b)
        assert dev[1] < -120.0, dev


class TestDecimator:
    def test_parity_with_oracle(self):
        n = 8192
        x = (np.random.default_rng(1).standard_normal(n)).astype(np.float32)
        orc = om.Decimator(mode="parity")
        a = np.zeros(n, dtype=np.float32)
        for s in range(0, n, 1024):
            orc.paint(Span(s, s + 1024), [a], [], False, {
                "sample_rate": 44100.0, "input": x, "fake_sample_rate": 5512.0,
            })
        cnt0 = jnp.full((1,), 0xFFFFFFFF, jnp.uint32)
        dval0 = jnp.zeros((1,), jnp.float32)
        _, _, out = effects.decimator(cnt0, dval0, jnp.asarray(x)[None], 5512.0, 44100.0)
        np.testing.assert_array_equal(a, np.asarray(out[0]))

    def test_np_scalar_fake_takes_host_division(self):
        """np.float32 fake_sample_rate must take the correctly rounded
        HOST division like a python float — falling through to XLA's
        reciprocal-based device division drifts the u32 latch grid
        (1858/44100 is a 1-ulp-off case on XLA:CPU)."""
        n = 4096
        x = (np.random.default_rng(3).standard_normal(n)).astype(np.float32)
        cnt0 = jnp.full((1,), 0xFFFFFFFF, jnp.uint32)
        dval0 = jnp.zeros((1,), jnp.float32)
        _, _, ref = effects.decimator(
            cnt0, dval0, jnp.asarray(x)[None], 1858.0, 44100.0)
        _, _, got = effects.decimator(
            cnt0, dval0, jnp.asarray(x)[None], np.float32(1858.0), 44100.0)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))

    def test_passthrough_when_fake_geq_sr(self):
        x = np.arange(16, dtype=np.float32)
        cnt0 = jnp.full((1,), 123, jnp.uint32)
        dval0 = jnp.full((1,), 9.0, jnp.float32)
        cnt, dval, out = effects.decimator(cnt0, dval0, jnp.asarray(x)[None], 48000.0, 44100.0)
        np.testing.assert_array_equal(np.asarray(out[0]), x)
        assert int(cnt[0]) == 0xFFFFFFFF and float(dval[0]) == 0.0


class TestPinkNoise:
    def test_tape_parity_with_oracle(self):
        n = 4096
        rng = np.random.default_rng(2)
        tape = rng.random(n, dtype=np.float32)
        # oracle: one paint call per block of 1024, pink state resets each call
        orc = om.Noise(tape_fn=None)
        pos = [0]

        def tape_fn(k):
            out = tape[pos[0] : pos[0] + k]
            pos[0] += k
            return out

        orc.tape_fn = tape_fn
        a = np.zeros(n, dtype=np.float32)
        for s in range(0, n, 1024):
            orc.paint(Span(s, s + 1024), [a], [], False, {"color": "pink"})
        # device: reset mask at block starts (the reference's per-call quirk)
        reset = np.zeros(n, dtype=bool)
        reset[::1024] = True
        out, _ = noise.pink_from_tape(jnp.asarray(tape)[None], reset_mask=jnp.asarray(reset)[None])
        dev = deviation_dbfs(a, np.asarray(out[0]))
        # one-pole scans reorder f32 adds vs the sequential loop: ulp-level
        assert dev[0] < -100.0, dev

    def test_white_range(self):
        w, tape = noise.white_noise(jax.random.PRNGKey(0), (2, 1024))
        w = np.asarray(w)
        assert w.min() >= -1.0 and w.max() < 1.0
        assert abs(w.mean()) < 0.1


class TestSimpleDelayEchoes:
    def test_simple_delay_parity(self):
        D, n = 700, 4096
        x = (np.random.default_rng(3).standard_normal(n)).astype(np.float32)
        sd = oi.SimpleDelay(D)
        a = np.zeros(n, dtype=np.float32)
        for s in range(0, n, 1024):
            sd.paint(Span(s, s + 1024), [a], [], False, {"input": x})
        state = jnp.zeros((D,), jnp.float32)
        _, out = d_ops.simple_delay(state, jnp.asarray(x))
        np.testing.assert_array_equal(a, np.asarray(out))

    def test_filtered_echoes_parity(self):
        D, n = 2048, 8192
        x = np.zeros(n, dtype=np.float32)
        x[0:100] = 1.0  # impulse burst
        fe = oi.FilteredEchoes(D)
        a = np.zeros(n, dtype=np.float32)
        temps = [np.zeros(n, dtype=np.float32) for _ in range(2)]
        for s in range(0, n, 1024):
            fe.paint(Span(s, s + 1024), [a], temps, False, {
                "input": x, "feedback_volume": 0.6, "cutoff": 0.5,
            })
        state = {"buf": jnp.zeros((D,)), "l": jnp.zeros(()), "b": jnp.zeros(())}
        _, out = d_ops.filtered_echoes(state, jnp.asarray(x), 0.6, 0.5, D)
        dev = deviation_dbfs(a, np.asarray(out))
        assert dev[0] < -110.0, dev

    def test_stereo_echoes_parity(self):
        D, n = 3000, 8192
        x = np.zeros(n, dtype=np.float32)
        x[100:200] = 0.5
        se = oi.StereoEchoes(D)
        a = np.zeros((2, n), dtype=np.float32)
        temps = [np.zeros(n, dtype=np.float32) for _ in range(4)]
        for s in range(0, n, 1024):
            se.paint(Span(s, s + 1024), [a[0], a[1]], temps, False, {
                "input": x, "feedback_volume": 0.5, "cutoff": 0.6,
            })
        state = d_ops.stereo_echoes_init(D)
        _, out = d_ops.stereo_echoes(state, jnp.asarray(x), 0.5, 0.6)
        dev = deviation_dbfs(a, np.asarray(out))
        assert dev[0] < -110.0, dev


class TestSampler:
    def _mk_wav(self, sr, n, bits=16, channels=1):
        from zang_tpu.core.wav import WavData

        rng = np.random.default_rng(5)
        pcm = (rng.standard_normal(n * channels) * 8000).astype(np.int16)
        return WavData(num_channels=channels, sample_rate=sr, bits_per_sample=bits,
                       data=pcm.tobytes())

    def test_resample_parity(self):
        from zang_tpu.core.timeline import SubvoiceTimeline
        from zang_tpu.oracle.modules import Sample, Sampler as OSampler

        w = self._mk_wav(22050, 3000)
        table = sampler.decode_wav_channel(w, 0)
        n = 8192
        tl = SubvoiceTimeline(
            starts=np.array([0]), resets=np.array([True]),
            params=[{"note_on": True}], total=n,
        )
        prog = sampler.plan_sampler(tl, table, 44100.0, loop=True)
        from zang_tpu.ops.segprog import eval_chunk

        chunk_prog = {"starts": jnp.asarray(prog.starts.astype(np.int32)),
                      **{k: jnp.asarray(v) for k, v in prog.values.items()}}
        t_idx = jnp.arange(n, dtype=jnp.int32)
        vals = eval_chunk(chunk_prog, t_idx)
        ratio = np.float32(np.float32(22050.0) / np.float32(44100.0))
        out = sampler.eval_sampler(vals, t_idx, jnp.asarray(table.data_f32),
                                   table.num_samples, float(ratio), loop=True)

        orc = OSampler(mode="parity")
        a = np.zeros(n, dtype=np.float32)
        osample = Sample(1, 22050, "signed16_lsb", w.data)
        for s in range(0, n, 1024):
            orc.paint(Span(s, s + 1024), [a], [], s == 0, {
                "sample_rate": 44100.0, "sample": osample, "channel": 0, "loop": True,
            })
        np.testing.assert_array_equal(a, np.asarray(out[0]))


class TestPallasFM:
    def test_interpret_matches_scan(self):
        """ops/pallas_fm.py (interpret mode) vs a sequential numpy loop."""
        import jax.numpy as jnp
        from zang_tpu.ops.pallas_fm import fm_feedback_pallas

        V, n = 4, 2048
        rng = np.random.default_rng(9)
        t = np.cumsum(np.full((V, n), 440.0 / 48000.0, np.float32), axis=1,
                      dtype=np.float32)
        base = (t * np.float32(2 * np.pi)).astype(np.float32)
        fb1 = rng.standard_normal(V).astype(np.float32) * 0.1
        fb2 = rng.standard_normal(V).astype(np.float32) * 0.1
        feedback = np.float32(np.pi / 4)

        # sequential numpy reference
        ref = np.empty_like(base)
        f1, f2 = fb1.copy(), fb2.copy()
        for i in range(n):
            p = base[:, i] + (f1 + f2) * feedback
            s = np.sin(p, dtype=np.float32)
            ref[:, i] = s
            f2, f1 = f1, s

        out, nf1, nf2 = fm_feedback_pallas(
            jnp.asarray(base), feedback, 0, jnp.asarray(fb1), jnp.asarray(fb2),
            interpret=True)
        # feedback recurrences amplify sin ulp differences (numpy's sin vs
        # XLA's); at this contractive feedback they stay at 2e-4
        np.testing.assert_allclose(np.asarray(out), ref, atol=2e-4)
        np.testing.assert_allclose(np.asarray(nf1), f1, atol=2e-4)
        np.testing.assert_allclose(np.asarray(nf2), f2, atol=2e-4)

    @pytest.mark.parametrize("shape,waveform", [
        ((1, 1), 0), ((3, 37), 1), ((40, 100), 3), ((2, 3, 65), 2)])
    def test_padding_matches_scan(self, shape, waveform):
        """Odd voice counts, sample counts off the tile size and extra
        leading axes pad and crop to exactly the lax.scan path (the same
        XLA sin on both sides in interpret mode)."""
        from zang_tpu.ops.fm import fm_feedback_scan
        from zang_tpu.ops.pallas_fm import fm_feedback_pallas

        rng = np.random.default_rng(sum(shape))
        base = jnp.asarray(rng.uniform(0, 50, shape).astype(np.float32))
        f1 = jnp.asarray(rng.standard_normal(shape[:-1]).astype(np.float32))
        f2 = jnp.asarray(rng.standard_normal(shape[:-1]).astype(np.float32))
        got = fm_feedback_pallas(base, 0.6, waveform, f1 * 0.1, f2 * 0.1,
                                 interpret=True)
        want = fm_feedback_scan(base, jnp.float32(0.6), waveform, f1 * 0.1,
                                f2 * 0.1)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


class TestPallasSVF:
    """ops/pallas_svf.py vs the exact sequential recurrence and the affine
    scan (interpret mode; chip_smoke.py runs the compiled kernel)."""

    def _seq(self, l0, b0, x, cut, res, act, muls):
        from zang_tpu.ops.filters import _svf_step

        l, b = l0.copy(), b0.copy()
        out = np.zeros_like(x)
        r = np.float32(1.0 - res)
        for i in range(x.shape[1]):
            la, ba, h = [
                np.asarray(v)
                for v in _svf_step(
                    jnp.asarray(l), jnp.asarray(b), jnp.asarray(x[:, i]),
                    jnp.asarray(cut[:, i]), jnp.float32(r))
            ]
            m = act[:, i]
            out[:, i] = np.where(m, la * muls[0] + ba * muls[1] + h * muls[2], 0.0)
            l = np.where(m, la, l)
            b = np.where(m, ba, b)
        return l, b, out

    def test_matches_sequential_reference(self):
        from zang_tpu.ops.filters import FILTER_MULS
        from zang_tpu.ops.pallas_svf import svf_filter_pallas

        rng = np.random.default_rng(7)
        V, n = 3, 2048
        x = rng.standard_normal((V, n)).astype(np.float32) * 0.3
        cut = rng.uniform(0.05, 0.6, (V, n)).astype(np.float32)
        act = rng.uniform(size=(V, n)) > 0.1
        l0 = rng.standard_normal(V).astype(np.float32) * 0.1
        b0 = rng.standard_normal(V).astype(np.float32) * 0.1
        for ftype in ("low_pass", "band_pass", "high_pass", "notch", "all_pass"):
            ls, bs, outs = self._seq(l0, b0, x, cut, 0.3, act, FILTER_MULS[ftype])
            lp, bp, outp = svf_filter_pallas(
                jnp.asarray(l0), jnp.asarray(b0), jnp.asarray(x),
                FILTER_MULS[ftype], jnp.asarray(cut), 0.3, jnp.asarray(act),
                interpret=True)
            d = np.asarray(outp, np.float64) - outs
            rms_db = 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)
            assert rms_db < -120.0, (ftype, rms_db)
            assert np.abs(np.asarray(lp) - ls).max() < 1e-5
            assert np.abs(np.asarray(bp) - bs).max() < 1e-5

    def test_state_chains_across_calls(self):
        from zang_tpu.ops.filters import FILTER_MULS
        from zang_tpu.ops.pallas_svf import svf_filter_pallas

        rng = np.random.default_rng(8)
        V, n = 2, 1024
        x = rng.standard_normal((V, 2 * n)).astype(np.float32) * 0.3
        cut = np.full((V, 2 * n), 0.3, np.float32)
        act = np.ones((V, 2 * n), bool)
        l0 = np.zeros(V, np.float32)
        b0 = np.zeros(V, np.float32)
        _, _, full = self._seq(l0, b0, x, cut, 0.3, act, FILTER_MULS["low_pass"])
        l, b = jnp.asarray(l0), jnp.asarray(b0)
        halves = []
        for k in range(2):
            sl = slice(k * n, (k + 1) * n)
            l, b, out = svf_filter_pallas(
                l, b, jnp.asarray(x[:, sl]), FILTER_MULS["low_pass"],
                jnp.asarray(cut[:, sl]), 0.3, jnp.asarray(act[:, sl]),
                interpret=True)
            halves.append(np.asarray(out))
        d = np.concatenate(halves, axis=1).astype(np.float64) - full
        rms_db = 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)
        assert rms_db < -120.0, rms_db


class TestFMFeedbackOracle:
    """The FM feedback oscillator vs its C++ sequential twin (closes the
    one module without an oracle counterpart)."""

    def _oracle(self, base, feedback, waveform, fb1, fb2):
        import ctypes

        from zang_tpu.oracle import native

        L = native.lib()
        out = np.empty_like(base)
        f1 = np.array([fb1], np.float32)
        f2 = np.array([fb2], np.float32)
        fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        L.zo_fm_feedback(fp(out), fp(base), base.size,
                         ctypes.c_float(feedback), int(waveform),
                         fp(f1), fp(f2))
        return out, float(f1[0]), float(f2[0])

    @pytest.mark.parametrize("waveform", [0, 1, 2, 3])
    def test_scan_matches_oracle(self, waveform):
        from zang_tpu.ops import fm
        from zang_tpu.ops.scan import exclusive_cumsum_u32, freq_to_ifreq, utof23

        # contractive regime: with |feedback| < 1 perturbations decay, so
        # libm-sinf-vs-XLA-sin ulps stay bounded. At feedback >= 1 the loop
        # is chaotic and sample-wise parity across different sin
        # implementations is impossible by construction (the pallas-vs-scan
        # test above covers that regime bit-exactly, same sin on both sides).
        sr = 48000.0
        n = 2048
        freq = np.full((1, n), 220.0, np.float32)
        cnt0 = jnp.zeros((1,), jnp.uint32)
        fb = 0.7
        cnt, (f1, f2), out = fm.fm_osc(
            cnt0, jnp.asarray(freq), 0.0, waveform, fb,
            (jnp.zeros(1), jnp.zeros(1)), sr)
        # oracle twin consumes the same base angles
        ifreq = freq_to_ifreq(jnp.asarray(freq), sr)
        base = np.asarray(
            (utof23(exclusive_cumsum_u32(ifreq)) + np.float32(0.0))
            * np.float32(np.pi) * np.float32(2.0))[0]
        ref, rf1, rf2 = self._oracle(base, fb, waveform, 0.0, 0.0)
        d = np.asarray(out)[0].astype(np.float64) - ref
        rms_db = 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)
        assert rms_db < -100.0, (waveform, rms_db)  # sinf vs XLA sin ulps
        assert abs(float(f1[0]) - rf1) < 1e-4 and abs(float(f2[0]) - rf2) < 1e-4


class TestPallasSVFGated:
    def test_large_v_gated_path_matches_affine(self):
        # the activity gate rides in cut's sign (-1 = inactive); at a voice
        # count that needs voice padding, padded voices must not leak
        from zang_tpu.ops.filters import FILTER_MULS, svf_filter
        from zang_tpu.ops.pallas_svf import svf_filter_pallas

        rng = np.random.default_rng(5)
        V, n = 250, 1024
        x = jnp.asarray(rng.standard_normal((V, n)).astype(np.float32) * 0.3)
        cut = jnp.asarray(rng.uniform(0.05, 0.6, (V, n)).astype(np.float32))
        act = jnp.asarray(rng.uniform(size=(V, n)) > 0.15)
        l0 = jnp.zeros(V)
        b0 = jnp.zeros(V)
        la, ba, outa = svf_filter(l0, b0, x, "low_pass", cut, 0.3, act)
        lp, bp, outp = svf_filter_pallas(l0, b0, x, FILTER_MULS["low_pass"],
                                         cut, 0.3, act, interpret=True)
        d = np.asarray(outa, np.float64) - np.asarray(outp, np.float64)
        rms_db = 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)
        assert rms_db < -120.0, rms_db
        assert np.abs(np.asarray(lp) - np.asarray(la)).max() < 1e-5

    @pytest.mark.parametrize("shape", [
        (1, 1), (5, 37), (7, 1000), (3, 4, 100), (130, 64)])
    def test_padding_matches_affine(self, shape):
        """Odd voice counts, sample counts off the tile and block sizes,
        and extra leading axes: the wrapper pads (voices with cut=-1,
        samples after the end) and crops back to the affine scan's
        results, scalar cutoff and no gate included."""
        from zang_tpu.ops.filters import FILTER_MULS, svf_filter
        from zang_tpu.ops.pallas_svf import svf_filter_pallas

        rng = np.random.default_rng(sum(shape))
        x = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.3)
        l0 = jnp.asarray(rng.standard_normal(shape[:-1]).astype(np.float32)
                         * 0.1)
        b0 = jnp.zeros(shape[:-1], jnp.float32)
        la, ba, outa = svf_filter(l0, b0, x, "band_pass", 0.35, 0.2)
        lp, bp, outp = svf_filter_pallas(l0, b0, x, FILTER_MULS["band_pass"],
                                         0.35, 0.2, interpret=True)
        assert outp.shape == x.shape and lp.shape == shape[:-1]
        np.testing.assert_allclose(np.asarray(outp), np.asarray(outa),
                                   atol=2e-6)
        np.testing.assert_allclose(np.asarray(lp), np.asarray(la), atol=1e-6)
        np.testing.assert_allclose(np.asarray(bp), np.asarray(ba), atol=1e-6)


class TestPallasSVFTable:
    """ops.filters.svf_filter_table: cutoff + activity gate from per-tile
    boundary tables (ops.segprog tiled format) instead of [V, n] arrays."""

    def _tables(self, rng, V, LANES, T, S, t0):
        tb = np.zeros((V, LANES, S), np.int64)
        cutv = np.zeros((V, LANES, S), np.float32)
        for v in range(V):
            for j in range(LANES):
                bs = np.sort(rng.integers(0, T, S - 1)) + t0 + j * T
                tb[v, j] = [-(2**31)] + list(bs)
                cutv[v, j] = rng.uniform(0.05, 0.9, S).astype(np.float32)
        return tb, cutv

    def test_fallback_matches_direct(self):
        """ops.filters.svf_filter_table == evaluating the table and calling
        svf_filter directly."""
        from zang_tpu.ops.filters import svf_filter, svf_filter_table
        from zang_tpu.ops.segprog import eval_tiled_chunk

        rng = np.random.default_rng(1)
        V, LANES, T, S, t0 = 3, 128, 8, 2, 1024
        n = LANES * T
        tb, cutv = self._tables(rng, V, LANES, T, S, t0)
        af = rng.integers(t0, t0 + n // 3, V).astype(np.int64)
        x = rng.standard_normal((V, n)).astype(np.float32) * 0.3
        l0 = np.zeros(V, np.float32)
        b0 = np.zeros(V, np.float32)

        lt, bt, outt = svf_filter_table(
            jnp.asarray(l0), jnp.asarray(b0), jnp.asarray(x), "low_pass",
            jnp.asarray(tb.astype(np.int32)), jnp.asarray(cutv), 0.4,
            t0, jnp.asarray(af.astype(np.int32)))
        t_idx = np.arange(t0, t0 + n, dtype=np.int32)
        cut_full = np.asarray(eval_tiled_chunk(
            {"tb": jnp.asarray(tb.astype(np.int32)),
             "cut": jnp.asarray(cutv)}, jnp.asarray(t_idx))["cut"])
        act = t_idx[None, :] >= af[:, None]
        la, ba, outa = svf_filter(
            jnp.asarray(l0), jnp.asarray(b0), jnp.asarray(x), "low_pass",
            jnp.asarray(cut_full), 0.4, jnp.asarray(act))
        np.testing.assert_array_equal(np.asarray(outa), np.asarray(outt))


class TestSamplerPallasTaps:
    """The sampler's gather taps (ops/sampler.eval_sampler) vs the oracle
    sampler on looped, reverse, one-shot and dense-retrigger playback.

    Speeds give f32-exact resampling ratios: the reference's inverted
    interpolation weights (Sampler.zig:119-125) jump at integer positions,
    so with an inexact ratio a one-ulp difference between the engine's
    closed-form position and the oracle's flips single samples."""

    def _run(self, loop, speed, seconds=1.5, sr=44100.0, note_gap=0.8):
        from zang_tpu.core.notes import SongEvent
        from zang_tpu.graph.render import Performance, render_performance
        from zang_tpu.core.timeline import compile_timelines
        from zang_tpu.host.configs import SamplerInstrument
        from zang_tpu.oracle.modules import Sample, Sampler as OSampler

        inst = SamplerInstrument(loop=loop, speed=speed, distort=False,
                                 fake_sample_rate=None)
        total = int(seconds * sr)
        song = []
        t, nid = 0.0, 1
        while t < seconds - 0.2:
            song.append(SongEvent({"note_on": True}, t=t, note_id=nid))
            t += note_gap
            nid += 1
        tls = compile_timelines(song, 1, sr, total)
        got = np.asarray(render_performance(
            Performance([(inst, tls)], sr), total, chunk_size=8192))[0]

        # oracle: the reference's per-paint-call playback, retriggered at
        # the same note-on frames (one 1024-sample paint call per block,
        # split at note boundaries)
        w = inst.wav
        fmt = {8: "unsigned8", 16: "signed16_lsb", 24: "signed24_lsb",
               32: "signed32_lsb"}[w.bits_per_sample]
        osample = Sample(w.num_channels, inst.effective_sample_rate(), fmt,
                         w.data)
        orc = OSampler(mode="parity")
        want = np.zeros(total, np.float32)
        resets = {int(s): bool(r)
                  for s, r in zip(tls[0].starts, tls[0].resets)}
        bounds = sorted(set([0, total] + list(resets)
                            + list(range(0, total, 1024))))
        for s0, s1 in zip(bounds[:-1], bounds[1:]):
            orc.paint(Span(s0, s1), [want], [], resets.get(s0, False), {
                "sample_rate": sr, "sample": osample, "channel": 0,
                "loop": loop})
        want *= np.float32(2.5)  # example_sampler.zig:106
        dev = deviation_dbfs(want, got)
        assert dev[0] < -90.0, dev
        assert np.abs(got).max() > 0

    def test_looped_forward(self):
        self._run(loop=True, speed=1.25)

    def test_looped_reverse(self):
        self._run(loop=True, speed=-1.0)

    def test_one_shot_runs_out(self):
        self._run(loop=False, speed=2.0, seconds=2.5)

    def test_dense_retriggers(self):
        # retriggers every ~18 ms: many program spans per chunk
        self._run(loop=True, speed=0.75, note_gap=0.018)
