"""Headline benchmarks on one chip, driver-readable.

Prints one JSON line per metric, each of the form
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}
The headline metric (full Bach Toccata render realtime factor) is printed
LAST. Metrics, in print order:

  sampler_chain_rtf_44k        drumloop sampler -> distortion -> decimator
                               chain RTF (BASELINE.md "sampler" config);
                               vs_baseline = value / 1000
  poly_echo_voices_per_chip    concurrent NiceInstrument voices through
                               StereoEchoes sustainable at RTF=1 on one chip
                               (measured at 16384 voices, scaled by RTF);
                               vs_baseline = value / 1024
  batch_serve_rtf_aggregate    tier-3 serving: N Bach-slice WAV jobs through
                               BatchRenderer (shared compile, i16 mixdown,
                               streamed WAVs to disk), aggregate audio
                               seconds per wall second on one chip;
                               vs_baseline = value (baseline: 1x realtime
                               delivery — the reference has no serving tier)
  live_fleet_sessions_per_chip tier-4 serving: 64 concurrent live sessions
                               vmapped into one device step; value =
                               lanes * block_budget / block_time (realtime-
                               session equivalents); vs_baseline = value
                               (baseline: the reference's single SDL host =
                               1 interactive session per machine)
  bach_render_fidelity_rms_dbfs  full-render deviation vs the parity oracle
                               (budget < -90); vs_baseline = value / -90
                               (>1 means within budget)
  bach_toccata_render_rtf_48k  full 385 s song render RTF;
                               vs_baseline = value / 1000

value = steady-state realtime factor (render seconds of audio per wall
second, compile excluded — jitted once, then timed best-of-3, each run
ending in block_until_ready on the rendered audio).

Runs on a GPU only: without one it exits non-zero. The line before the
metrics names the device (JAX's device kind, nvidia-smi's name and power
limit).

Env:
  ZANG_BENCH_SECONDS   song render length (default 385, the write_wav
                       golden duration); also the fidelity compare length
  ZANG_BENCH_CHUNK     chunk size (default 65536)
  ZANG_BENCH_METRICS   comma list to subset:
                       sampler,poly,serve,fleet,fidelity,song
  ZANG_BENCH_POLY_VOICES / ZANG_BENCH_POLY_SECONDS  capacity config
                       (default 16384 voices, 8 s)
  ZANG_BENCH_SAMPLER_SECONDS  sampler config length (default 60 s)
  ZANG_BENCH_SERVE_SONGS / ZANG_BENCH_SERVE_SECONDS  tier-3 config
                       (default 6 jobs x 60 s)
  ZANG_BENCH_FLEET_LANES / ZANG_BENCH_FLEET_BLOCK  tier-4 config
                       (default 64 lanes x 4096-sample blocks)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _timed(jrun, args):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(jrun(*args))
    return time.perf_counter() - t0


def emit(metric, value, unit, vs_baseline):
    print(
        json.dumps(
            {
                "metric": metric,
                "value": value,
                "unit": unit,
                "vs_baseline": vs_baseline,
            }
        ),
        flush=True,
    )


def _spread_note(label, walls):
    spread = (max(walls) - min(walls)) / min(walls) if min(walls) else 0.0
    print(f"# {label} walls={['%.2f' % w for w in walls]} "
          f"spread={spread:.0%}", file=sys.stderr)


def _steady_rtf(run, args, seconds, label=""):
    import jax

    jrun = jax.jit(run)
    _timed(jrun, args)  # compile + first run
    dts = [_timed(jrun, args) for _ in range(3)]
    if label:
        _spread_note(label, dts)
    return seconds / min(dts)


def bench_sampler(chunk):
    from zang_tpu.graph.render import make_render_fn
    from zang_tpu.host.configs import build_sampler_performance

    seconds = float(os.environ.get("ZANG_BENCH_SAMPLER_SECONDS", 60.0))
    perf, total = build_sampler_performance(seconds=seconds)
    run, args = make_render_fn(perf, total, chunk_size=min(chunk, total))
    rtf = _steady_rtf(run, args, seconds, label="bench_sampler")
    emit("sampler_chain_rtf_44k", round(rtf, 1), "x_realtime", round(rtf / 1000.0, 3))


def bench_poly(chunk):
    from zang_tpu.graph.render import make_render_fn
    from zang_tpu.host.configs import build_poly_echo_performance

    voices = int(os.environ.get("ZANG_BENCH_POLY_VOICES", 16384))
    seconds = float(os.environ.get("ZANG_BENCH_POLY_SECONDS", 8.0))
    chunk = int(os.environ.get("ZANG_BENCH_POLY_CHUNK", chunk))
    perf, total = build_poly_echo_performance(num_voices=voices, seconds=seconds)
    run, args = make_render_fn(perf, total, chunk_size=min(chunk, total))
    rtf = _steady_rtf(run, args, seconds, label="bench_poly")
    capacity = int(voices * rtf)
    emit(
        "poly_echo_voices_per_chip",
        capacity,
        "voices_at_rtf1",
        round(capacity / 1024.0, 2),
    )


def bench_serve(chunk):
    """Tier-3 aggregate WAV throughput: compile is warmed by one short job,
    then N jobs are timed end-to-end (host prep, render, i16 mixdown,
    download, disk) through the shared-graph BatchRenderer."""
    import tempfile

    from zang_tpu.host import song as sm
    from zang_tpu.serve.batch import BatchRenderer, RenderJob

    songs = int(os.environ.get("ZANG_BENCH_SERVE_SONGS", 6))
    seconds = float(os.environ.get("ZANG_BENCH_SERVE_SECONDS", 60.0))

    def mk(secs):
        total = int(secs * sm.SAMPLE_RATE)
        return lambda: (sm.build_performance(total), total)

    with tempfile.TemporaryDirectory() as out:
        br = BatchRenderer(out_dir=out, chunk_size=chunk)
        warm = br.run([RenderJob(name="warm", build=mk(8.0), volume=0.25)])
        assert warm[0].status == "ok", warm[0].error
        jobs = [
            RenderJob(name=f"job_{i:02d}", build=mk(seconds), volume=0.25)
            for i in range(songs)
        ]
        # best-of-N like the song/fleet metrics
        passes = int(os.environ.get("ZANG_BENCH_SERVE_PASSES", 3))
        walls = []
        for _ in range(passes):
            t0 = time.time()
            results = br.run(jobs)
            walls.append(time.time() - t0)
            assert all(r.status == "ok" for r in results), \
                [r.error for r in results]
    audio = sum(r.seconds for r in results if r.status == "ok")
    rtf = audio / min(walls)
    _spread_note("bench_serve", walls)
    return rtf


def bench_fleet():
    """Tier-4 live serving: lanes concurrent sessions, one vmapped step per
    block; value = lanes * block_budget / median block time."""
    import numpy as np

    from zang_tpu.host import instruments as ti
    from zang_tpu.serve.live import LiveFleet

    lanes = int(os.environ.get("ZANG_BENCH_FLEET_LANES", 64))
    block = int(os.environ.get("ZANG_BENCH_FLEET_BLOCK", 4096))
    sr = 48000.0
    rng = np.random.default_rng(0)
    fleet = LiveFleet(lambda: [(ti.NiceInstrument(0.3), 4)], lanes, sr,
                      block_size=block)

    def push_all(release):
        for lane in range(lanes):
            f = float(np.float32(220.0 * 2 ** (rng.integers(0, 13) / 12.0)))
            nid = fleet.push_event(lane, 0, {"freq": f, "note_on": True})
            if release:
                fleet.push_event(lane, 0, {"freq": f, "note_on": False},
                                 note_id=nid)

    push_all(False)
    fleet.render_block()  # compile
    times = []
    for _ in range(8):
        push_all(True)
        t0 = time.time()
        fleet.render_block()  # np.asarray inside waits for the device
        times.append(time.time() - t0)
    _spread_note("bench_fleet", times)
    bt = float(np.min(times))
    return lanes * (block / sr) / bt


def bench_fidelity(seconds, chunk):
    import numpy as np

    from zang_tpu.graph.fidelity import deviation_dbfs
    from zang_tpu.graph.render import render_performance
    from zang_tpu.host import song as sm

    total = int(seconds * sm.SAMPLE_RATE)
    perf = sm.build_performance(total)
    dev = render_performance(perf, total, chunk_size=min(chunk, total))
    ref = sm.render_song_oracle(seconds)
    rms, _peak = deviation_dbfs(np.asarray(dev)[0], ref)
    emit(
        "bach_render_fidelity_rms_dbfs",
        round(float(rms), 1),
        "dbfs_rms_vs_oracle",
        round(float(rms) / -90.0, 3),
    )


def bench_song(seconds, chunk):
    from zang_tpu.graph.render import make_render_fn
    from zang_tpu.host import song as sm

    total = int(seconds * sm.SAMPLE_RATE)
    perf = sm.build_performance(total)
    run, args = make_render_fn(perf, total, chunk_size=min(chunk, total))
    rtf = _steady_rtf(run, args, seconds, label="bench_song")
    emit(
        "bach_toccata_render_rtf_48k",
        round(rtf, 1),
        "x_realtime",
        round(rtf / 1000.0, 3),
    )


def main():
    from zang_tpu.host import song as sm
    from zang_tpu.platform import enable_compile_cache, require_gpu

    enable_compile_cache()
    require_gpu("bench")

    seconds = float(os.environ.get("ZANG_BENCH_SECONDS", sm.NUM_SECONDS))
    chunk = int(os.environ.get("ZANG_BENCH_CHUNK", 65536))
    which = os.environ.get(
        "ZANG_BENCH_METRICS", "sampler,poly,serve,fleet,fidelity,song")
    which = {w.strip() for w in which.split(",") if w.strip()}

    if "sampler" in which:
        bench_sampler(chunk)
    if "poly" in which:
        bench_poly(chunk)
    if "serve" in which:
        rtf = bench_serve(chunk)
        emit("batch_serve_rtf_aggregate", round(rtf, 1),
             "x_realtime_wav_delivery", round(rtf, 1))
    if "fleet" in which:
        sessions = bench_fleet()
        emit("live_fleet_sessions_per_chip", round(sessions, 1),
             "realtime_sessions", round(sessions, 1))
    if "fidelity" in which:
        bench_fidelity(seconds, chunk)
    if "song" in which:  # headline — keep last so it's the final JSON line
        bench_song(seconds, chunk)


if __name__ == "__main__":
    main()
