"""Smoke run of zang_tpu's render and serving paths on an NVIDIA GPU.

Run from the root of a checkout on a machine with a GPU:

    python chip_smoke.py                  # one card, every phase below
    python chip_smoke.py --four-cards     # the multi-device paths only
    python chip_smoke.py --phase kernels  # one phase (repeatable)

Phases (one process drives the card throughout):
  song      the full Bach Toccata (385 s, 48 kHz, 17 voices, chunk 65536)
            through render_performance, vs the oracle (< -90 dBFS RMS)
  sampler   the 60 s sampler chain vs the oracle (< -90 dBFS)
  fm        the fmsynth example (feedback on) vs the oracle (< -90 dBFS)
  poly      poly_echo at 16384 voices for 8 s, once
  kernels   each GPU kernel vs its plain XLA path and the sequential
            recurrence, with both timings; the sampler's gather taps
  serve     BatchRenderer, LiveFleet and RenderHTTPServer as users call them
  gpu_tests the tests marked `gpu` (tests/test_gpu_kernels.py)

--four-cards runs only the multi-device checks of
__graft_entry__.dryrun_multichip on four real devices.

Each phase prints its walls, compile seconds, memory analysis and
deviations. A failing phase raises: the script then exits non-zero and
prints no result. It also exits non-zero when JAX finds no GPU. The last
line of a passing run is one JSON object naming the device.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

ORACLE_BUDGET_DBFS = -90.0
REPS = 10


def _rms_dbfs(a, b):
    from zang_tpu.graph.fidelity import deviation_dbfs

    return float(deviation_dbfs(a, b)[0])


def _timed(fn, *args, reps=REPS):
    """(output, first-call seconds, median, min, max, count of the warm
    calls); every call ends in block_until_ready on the real output."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return (out, first, statistics.median(walls), min(walls), max(walls),
            reps)


def _fmt_walls(label, first, med, lo, hi, n):
    return (f"{label}: first {first:.4f} s, median {med:.6f} s "
            f"(min {lo:.6f}, max {hi:.6f}, n={n})")


def _compile(label, fn, args):
    """jit + lower + compile, printing compile seconds and the memory
    analysis of the executable."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    print(f"{label}: compile {time.perf_counter() - t0:.2f} s")
    print(f"{label}: memory_analysis {compiled.memory_analysis()}")
    return compiled


def _render_checked(label, perf, total, chunk, audio_seconds, reps=2):
    """Compile the render step, time it, then render through the user
    entry point (render_performance) and check both agree."""
    import numpy as np

    from zang_tpu.graph.render import make_render_fn, render_performance

    run, args = make_render_fn(perf, total, chunk)
    compiled = _compile(label, run, args)
    out, first, med, lo, hi, n = _timed(compiled, *args, reps=reps)
    print(_fmt_walls(label, first, med, lo, hi, n)
          + f"; {audio_seconds / med:.1f}x realtime")
    t0 = time.perf_counter()
    audio = render_performance(perf, total, chunk_size=chunk)
    print(f"{label}: render_performance wall {time.perf_counter() - t0:.2f} s"
          f" (compile cache warm)")
    step = np.asarray(out)[:, :total]
    assert audio.shape == step.shape, (audio.shape, step.shape)
    assert np.isfinite(audio).all(), f"{label}: non-finite audio"
    assert np.array_equal(audio, step), f"{label}: entry point != step"
    return audio


def _vs_oracle(label, audio, ref):
    from zang_tpu.graph.fidelity import deviation_dbfs

    rms, peak = deviation_dbfs(audio, ref)
    print(f"{label}: deviation vs oracle rms {rms:.2f} dBFS, "
          f"peak {peak:.2f} dBFS (budget rms < {ORACLE_BUDGET_DBFS})")
    assert rms < ORACLE_BUDGET_DBFS, (label, rms)


def phase_song():
    from zang_tpu.host import song as sm

    seconds = sm.NUM_SECONDS
    total = int(seconds * sm.SAMPLE_RATE)
    perf = sm.build_performance(total)
    audio = _render_checked("song", perf, total, 65536, seconds)
    t0 = time.perf_counter()
    ref = sm.render_song_oracle(seconds)
    print(f"song: oracle {time.perf_counter() - t0:.1f} s")
    _vs_oracle("song", audio[0], ref)


def phase_sampler():
    from zang_tpu.host.configs import build_sampler_performance
    from zang_tpu.oracle import examples as oex

    seconds = 60.0
    perf, total = build_sampler_performance(seconds=seconds)
    audio = _render_checked("sampler", perf, total, 65536, seconds, reps=5)
    _vs_oracle("sampler", audio[0], oex.render_sampler_chain(seconds))


def phase_fm():
    import numpy as np

    from zang_tpu.host.examples import EXAMPLES, FMSynthInstrument

    assert FMSynthInstrument().mod["feedback"] != 0.0
    seconds = 4.0
    t0 = time.perf_counter()
    audio, _sr = EXAMPLES["fmsynth"](seconds=seconds)
    print(f"fm: ex_fmsynth wall {time.perf_counter() - t0:.2f} s "
          f"(includes compile)")
    ref, _ = EXAMPLES["fmsynth"](seconds=seconds, backend="oracle")
    audio = np.asarray(audio)
    assert np.isfinite(audio).all()
    _vs_oracle("fm", audio[0], np.asarray(ref)[0])


def phase_poly():
    import numpy as np

    from zang_tpu.host.configs import build_poly_echo_performance

    voices, seconds = 16384, 8.0
    t0 = time.perf_counter()
    perf, total = build_poly_echo_performance(num_voices=voices,
                                              seconds=seconds)
    print(f"poly: host plan {time.perf_counter() - t0:.1f} s")
    audio = _render_checked("poly", perf, total, 65536, seconds, reps=1)
    assert audio.shape == (2, total), audio.shape
    assert np.abs(audio).max() > 1e-3, "poly: silent"


def _svf_case(label, V, n, reps=REPS):
    """SVF kernel vs the affine scan vs a sequential lax.scan, on device."""
    import jax
    import jax.numpy as jnp

    from zang_tpu.ops.filters import FILTER_MULS, _svf_step, svf_filter_affine
    from zang_tpu.ops.pallas_svf import svf_filter_pallas

    k = jax.random.split(jax.random.PRNGKey(V * 7 + n), 3)
    x = jax.random.normal(k[0], (V, n), jnp.float32) * 0.3
    cut = jax.random.uniform(k[1], (V, n), jnp.float32, 0.05, 0.6)
    act = jax.random.uniform(k[2], (V, n)) > 0.1
    l0 = jnp.zeros((V,), jnp.float32)
    b0 = jnp.zeros((V,), jnp.float32)
    muls = FILTER_MULS["low_pass"]

    kern = jax.jit(lambda *a: svf_filter_pallas(*a[:3], muls, *a[3:]))
    plain = jax.jit(lambda *a: svf_filter_affine(*a[:3], muls, *a[3:]))

    @jax.jit
    def seq(l0, b0, x, cut, res, act):
        r = jnp.float32(1.0) - jnp.float32(res)

        def step(c, xs):
            l, b = c
            xi, ci, ai = xs
            nl, nb, h = _svf_step(l, b, xi, ci, r)
            out = jnp.where(ai, nl * muls[0] + nb * muls[1] + h * muls[2], 0.0)
            return (jnp.where(ai, nl, l), jnp.where(ai, nb, b)), out

        (l, b), out = jax.lax.scan(step, (l0, b0), (x.T, cut.T, act.T))
        return l, b, out.T

    args = (l0, b0, x, cut, 0.3, act)
    (lk, bk, ok), *tk = _timed(kern, *args, reps=reps)
    (la, ba, oa), *ta = _timed(plain, *args, reps=reps)
    (ls, bs, os_), *ts = _timed(seq, *args, reps=2)
    print(_fmt_walls(f"kernels: svf {label} [{V}, {n}] pallas", *tk))
    print(_fmt_walls(f"kernels: svf {label} [{V}, {n}] affine-scan", *ta))
    print(_fmt_walls(f"kernels: svf {label} [{V}, {n}] lax.scan", *ts))
    # tolerance: f32 rounding through the kernel's block seams and the
    # scan's association order, FMA contraction on both sides; 30 dB
    # inside the oracle budget
    for name, o, l in (("pallas", ok, lk), ("affine", oa, la)):
        dev = _rms_dbfs(o, os_)
        dl = float(jnp.max(jnp.abs(l - ls)))
        print(f"kernels: svf {label} {name} vs sequential rms {dev:.2f} dBFS,"
              f" end-state max |dl| {dl:.3g} (tolerance -120 dBFS, 1e-5)")
        assert dev < -120.0 and dl < 1e-5, (label, name, dev, dl)
    print(f"kernels: svf {label} speedup pallas vs affine "
          f"{ta[1] / tk[1]:.2f}x (median)")


def _fm_case(label, V, n, feedback, reps=REPS):
    import jax
    import jax.numpy as jnp

    from zang_tpu.ops.fm import fm_feedback_scan
    from zang_tpu.ops.pallas_fm import fm_feedback_pallas

    freqs = 110.0 + 3.0 * jnp.arange(V, dtype=jnp.float32)
    base = (jnp.cumsum(jnp.broadcast_to(freqs[:, None] / 48000.0, (V, n)),
                       axis=1) * jnp.float32(2 * 3.141592653589793)
            ).astype(jnp.float32)
    fb0 = jnp.zeros((V,), jnp.float32)
    kern = jax.jit(lambda b, f1, f2: fm_feedback_pallas(b, feedback, 0,
                                                        f1, f2))
    plain = jax.jit(lambda b, f1, f2: fm_feedback_scan(
        b, jnp.float32(feedback), 0, f1, f2))
    (ok, _, _), *tk = _timed(kern, base, fb0, fb0, reps=reps)
    (os_, _, _), *ts = _timed(plain, base, fb0, fb0, reps=min(reps, 3))
    print(_fmt_walls(f"kernels: fm {label} [{V}, {n}] pallas", *tk))
    print(_fmt_walls(f"kernels: fm {label} [{V}, {n}] lax.scan", *ts))
    d = float(jnp.max(jnp.abs(ok - os_)))
    # tolerance: both sides use the GPU's sin; at |feedback| < 1 the loop
    # is contractive, so operand-order ulps stay bounded
    print(f"kernels: fm {label} max |pallas - scan| {d:.3g} "
          f"(feedback {feedback}, tolerance 1e-4)")
    assert d < 1e-4, (label, d)
    print(f"kernels: fm {label} speedup pallas vs lax.scan "
          f"{ts[1] / tk[1]:.1f}x (median)")


def _sampler_gather():
    """The sampler cell's taps, one 65536-sample chunk, plain XLA gather."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from zang_tpu.host.configs import SamplerInstrument
    from zang_tpu.ops import sampler as so

    inst = SamplerInstrument()
    n = 65536
    t_idx = jnp.arange(n, dtype=jnp.int32)
    vals = {"seg_start": jnp.zeros((1, 1), jnp.int32),
            "mode": jnp.ones((1, 1), jnp.int32),
            "t0": jnp.zeros((1, 1), jnp.float32)}
    table = jnp.asarray(inst.table.data_f32)
    fn = jax.jit(lambda v, t, tab: so.eval_sampler(
        v, t, tab, inst.table.num_samples, 1.37, True))
    out, *t = _timed(fn, vals, t_idx, table)
    assert np.isfinite(np.asarray(out)).all()
    print(_fmt_walls(f"kernels: sampler gather taps [1, {n}] "
                     f"table {inst.table.num_samples}", *t))


def phase_kernels():
    _svf_case("song width", 10, 65536)
    _svf_case("poly width", 16384, 16384, reps=5)
    _fm_case("fmsynth width", 8, 65536, 0.7)
    _fm_case("4096 voices", 4096, 65536, 0.7, reps=5)
    _sampler_gather()


def _wav_ok(data: bytes, label: str):
    import struct

    import numpy as np

    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE", (label, data[:12])
    n = struct.unpack_from("<I", data, 40)[0]
    pcm = np.frombuffer(data[44:44 + n], dtype=np.int16)
    assert pcm.size > 0 and np.abs(pcm).max() > 0, f"{label}: silent WAV"
    print(f"serve: http {label}: {len(data)} bytes, peak {np.abs(pcm).max()}")


def phase_serve():
    import urllib.request

    import numpy as np

    from zang_tpu.graph.render import render_performance
    from zang_tpu.host import instruments as ti
    from zang_tpu.host import song as sm
    from zang_tpu.serve.batch import BatchRenderer, RenderJob
    from zang_tpu.serve.http import RenderHTTPServer
    from zang_tpu.serve.live import LiveFleet

    # batch: three 60 s Bach-slice jobs, each within 2e-6 of a solo render
    total = int(60.0 * sm.SAMPLE_RATE)
    jobs = [RenderJob(name=f"bach_{i}",
                      build=lambda: (sm.build_performance(total), total))
            for i in range(3)]
    br = BatchRenderer(out_dir=None, chunk_size=65536)
    t0 = time.perf_counter()
    results = br.run(jobs)
    print(f"serve: batch 3 x 60 s wall {time.perf_counter() - t0:.2f} s "
          f"(includes compile)")
    solo = render_performance(sm.build_performance(total), total)
    for r in results:
        assert r.status == "ok", (r.name, r.error)
        d = float(np.abs(np.asarray(r.audio, np.float64) - solo).max())
        print(f"serve: batch {r.name} max |job - solo| {d:.3g} (<= 2e-6)")
        assert d <= 2e-6, (r.name, d)

    # live fleet: 64 lanes of 1024-sample blocks at 48 kHz
    lanes, block, sr = 64, 1024, 48000.0
    fleet = LiveFleet(lambda: [(ti.NiceInstrument(0.3), 4)], lanes, sr,
                      block_size=block)
    rng = np.random.default_rng(0)
    blocks, walls = [], []
    try:
        for b in range(12):
            if b % 4 == 0:
                for lane in range(lanes):
                    f = float(np.float32(
                        220.0 * 2 ** (rng.integers(0, 13) / 12.0)))
                    fleet.push_event(lane, 0, {"freq": f, "note_on": True})
            t0 = time.perf_counter()
            blocks.append(fleet.render_block())
            walls.append(time.perf_counter() - t0)
    finally:
        fleet.close()
    out = np.concatenate(blocks, axis=2)
    assert out.shape == (lanes, 1, 12 * block), out.shape
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-4
    print(f"serve: fleet {lanes} lanes x {block}: first block "
          f"{walls[0]:.3f} s (compile), median of the rest "
          f"{statistics.median(walls[1:]) * 1e3:.3f} ms "
          f"(budget {block / sr * 1e3:.1f} ms), peak {np.abs(out).max():.4f}")

    # http: example render, uploaded zangscript, batch
    script = ("Synth = defmodule freq: cob, note_on: boolean, begin\n"
              "    e = Envelope(attack=.cubed(0.01), decay=.cubed(0.05), "
              "release=.cubed(0.1), sustain_volume=0.8, note_on)\n"
              "    out SineOsc(freq, phase=0) * e * 0.5\nend\n")
    with RenderHTTPServer(max_seconds=10.0) as srv:
        url = f"http://{srv.host}:{srv.port}"

        def get(path):
            with urllib.request.urlopen(url + path, timeout=600) as r:
                return r.read()

        def post(path, body):
            req = urllib.request.Request(
                url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.read()

        t0 = time.perf_counter()
        _wav_ok(get("/v1/render?example=play&seconds=2"), "example play")
        _wav_ok(post("/v1/render/script", {"script": script, "seconds": 2}),
                "script upload")
        resp = json.loads(post("/v1/render/batch", {"jobs": [
            {"name": "a", "config": "song", "seconds": 4},
            {"name": "b", "script": script, "seconds": 2}]}))
        for entry in resp["results"]:
            assert entry["status"] == "ok", entry
            _wav_ok(get(entry["url"]), f"batch job {entry['name']}")
        print(f"serve: http wall {time.perf_counter() - t0:.2f} s, "
              f"stats {srv.stats()}")


def phase_gpu_tests():
    import pytest

    class Count:
        passed = skipped = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.skipped:
                self.skipped += 1
            elif report.failed:
                self.failed += 1

    c = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu_kernels.py")],
                     plugins=[c])
    print(f"gpu_tests: passed {c.passed}, skipped {c.skipped}, "
          f"failed {c.failed}")
    assert rc == 0 and c.passed > 0 and not c.skipped, rc


PHASES = {
    "song": phase_song,
    "sampler": phase_sampler,
    "fm": phase_fm,
    "poly": phase_poly,
    "kernels": phase_kernels,
    "serve": phase_serve,
    "gpu_tests": phase_gpu_tests,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device checks on 4 devices")
    ap.add_argument("--phase", action="append", choices=sorted(PHASES),
                    help="run only this phase (repeatable)")
    args = ap.parse_args(argv)

    from zang_tpu.platform import enable_compile_cache, require_gpu

    print(f"# compile cache: {enable_compile_cache()}")
    device = require_gpu("chip_smoke")
    if args.four_cards:
        if device["count"] < 4:
            sys.exit(f"chip_smoke: --four-cards needs 4 GPUs, "
                     f"found {device['count']}")
        import __graft_entry__

        t0 = time.perf_counter()
        __graft_entry__.dryrun_multichip(4, seconds=60.0)
        print(f"== four-cards ok {time.perf_counter() - t0:.1f} s")
    else:
        for name in args.phase or list(PHASES):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            PHASES[name]()
            print(f"== {name} ok {time.perf_counter() - t0:.1f} s",
                  flush=True)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
