"""Ports of the reference's example programs as offline render configs.

Each reference example (examples/example_*.zig) becomes a function
`ex_<name>(seconds) -> (audio f32 [C, total], sample_rate)`; keyboard/mouse
interaction is replaced by scripted event sequences (the SDL host's
keyEvent/mouseEvent paths feed the same ImpulseQueue machinery, so a
scripted impulse stream exercises the identical pipeline).

Several examples are expressed in zangscript (our DSL) — the graphs the
reference builds in Zig are written as scripts and compiled through the
JAX backend — the rest compose the ops library directly.

Run: python -m zang_tpu.host.examples <name> out.wav [--seconds N]
"""

import os
from typing import Dict, List, Tuple

import numpy as np

import jax.numpy as jnp

from ..core import twelve_tet as tt
from ..core.curves import PaintCurve
from ..core.notes import SongEvent
from ..core.timeline import SubvoiceTimeline, active_from, compile_timelines
from ..graph.render import Performance, RenderCtx, render_performance
from ..ops import control, effects, filters, fm, noise as noise_ops, oscillators
from ..ops.scan import exclusive_cumsum_u32, freq_to_ifreq
from ..ops.segprog import SegProgram, eval_chunk
from ..script import compile_script
from ..script.jax_backend import ScriptInstrument
from . import instruments as ti

F32 = np.float32
A4 = 440.0


def _note(params, t, nid):
    return SongEvent(params, t=t, note_id=nid)


def _simple_song(notes: List[Tuple[float, float, float]], extra=None):
    """notes: (t_on, duration, freq). Returns chronological SongEvents."""
    song = []
    for i, (t0, dur, freq) in enumerate(notes):
        p = {"freq": float(F32(freq)), "note_on": True}
        q = {"freq": float(F32(freq)), "note_on": False}
        if extra:
            p.update(extra)
            q.update(extra)
        song.append(_note(p, t0, i + 1))
        song.append(_note(q, t0 + dur, i + 1))
    song.sort(key=lambda e: (e.t, e.note_id))
    return song


# Render chunk for every example config. Module-level so tests can override
# it and prove chunk-invariance of the engine's cross-chunk state carry
# (tests/test_examples_golden.py long-horizon sweep). NOTE: white noise is
# chunk-keyed BY DESIGN (jax_backend "noise" folds in the chunk start frame),
# so noise-bearing configs re-derive rather than stay invariant.
DEFAULT_CHUNK = 16384


def _render_script(src, name, song, seconds, sr=44100.0, polyphony=1,
                   chunk=None, param_map=None, backend="device"):
    total = int(seconds * sr)
    if chunk is None:
        chunk = DEFAULT_CHUNK
    cs = compile_script(src)
    if backend == "oracle":
        from ..oracle.script import render_script_oracle

        return render_script_oracle(cs, name, song, total, sr,
                                    polyphony=polyphony,
                                    param_map=param_map), sr
    inst = ScriptInstrument(cs, name, param_map)
    tls = compile_timelines(song, polyphony, sr, total)
    return render_performance(Performance([(inst, tls)], sr), total,
                              chunk_size=chunk), sr


def _oracle_twin_part(inst, tls):
    """(make_module(v), make_params, num_temps, tls) twin for the standard
    examples/modules.zig instruments (oracle/instruments.py)."""
    from ..oracle import examples as oex
    from ..oracle import instruments as oi

    if isinstance(inst, ti.PMOscInstrument):
        rd = inst.release_duration
        return (lambda v: oi.PMOscInstrument(rd, mode="parity"),
                oex.std_params, 3, tls)
    if isinstance(inst, ti.FilteredSawtoothInstrument):
        return (lambda v: oi.FilteredSawtoothInstrument(mode="parity"),
                oex.std_params, 3, tls)
    if isinstance(inst, ti.NiceInstrument):
        color = float(inst.color)
        return (lambda v: oi.NiceInstrument(color, mode="parity"),
                oex.std_params, 2, tls)
    if isinstance(inst, ti.HardSquareInstrument):
        return (lambda v: oi.HardSquareInstrument(mode="parity"),
                oex.std_params, 2, tls)
    raise NotImplementedError(type(inst).__name__)


def _render_parts(parts, seconds, sr, num_channels=1, post_fn=None,
                  post_init=None, chunk=None, backend="device",
                  oracle_parts=None, oracle_post=None):
    total = int(seconds * sr)
    if chunk is None:
        chunk = DEFAULT_CHUNK
    if backend == "oracle":
        from ..oracle import examples as oex

        oparts = (oracle_parts() if oracle_parts is not None
                  else [_oracle_twin_part(inst, tls) for inst, tls in parts])
        post = oracle_post() if oracle_post is not None else None
        return oex.render_parts(oparts, total, sr, num_channels, post), sr
    perf = Performance(parts, sr, num_channels=num_channels, post_fn=post_fn,
                       post_init_state=post_init)
    return render_performance(perf, total, chunk_size=chunk), sr


# ---------------------------------------------------------------------------
# example_play: PMOsc keyboard voice + filtered-sawtooth drone on space
# (examples/example_play.zig: PMOscInstrument(1.0) / FilteredSawtooth).


def ex_play(seconds=6.0, backend="device"):
    sr = 48000.0
    melody = _simple_song([
        (0.2 + i * 0.45, 0.35, A4 * tt.rel_freq(n))
        for i, n in enumerate([-9, -5, -2, 0, -2, -5, -9, -5, 3, 0, -2, 0])
    ])
    drone = _simple_song([(0.0, seconds - 1.0, A4 * tt.c4 / 4.0)])
    total = int(seconds * sr)
    tls0 = compile_timelines(melody, 1, sr, total)
    tls1 = compile_timelines(drone, 1, sr, total)
    return _render_parts(
        [(ti.PMOscInstrument(1.0), tls0), (ti.FilteredSawtoothInstrument(), tls1)],
        seconds, sr, backend=backend)


# ---------------------------------------------------------------------------
# example_envelope: very slow ADSR made audible (examples/example_envelope.zig:
# pulse(0.5) * env(cubed 1.0 x3, sustain 0.5) * 5.0, c2 note).

ENVELOPE_SCRIPT = """
EnvDemo = defmodule freq: cob, note_on: boolean, begin
    e = Envelope(attack=.cubed(1.0), decay=.cubed(1.0), release=.cubed(1.0),
                 sustain_volume=0.5, note_on) * 5.0
    out PulseOsc(freq, color=0.5) * e
end
"""


def ex_envelope(seconds=8.0, backend="device"):
    song = _simple_song([(0.1, 4.0, A4 * tt.c2)])
    return _render_script(ENVELOPE_SCRIPT, "EnvDemo", song, seconds,
                          sr=48000.0, backend=backend)


# ---------------------------------------------------------------------------
# example_vibrato (examples/example_vibrato.zig): pulse at freq*(1+0.02*sin(4Hz)).

VIBRATO_SCRIPT = """
Vib = defmodule freq: cob, note_on: boolean, begin
    f = freq * (1 + 0.02 * SineOsc(freq=4, phase=0))
    out PulseOsc(freq=f, color=0.3) * Gate(note_on)
end
"""


def ex_vibrato(seconds=4.0, backend="device"):
    song = _simple_song([(0.1, 1.5, A4 * tt.a3), (2.0, 1.5, A4 * tt.d4)])
    return _render_script(VIBRATO_SCRIPT, "Vib", song, seconds, sr=48000.0,
                          backend=backend)


# ---------------------------------------------------------------------------
# example_curve / example_laser: curve-driven FM (examples/example_curve.zig,
# example_laser.zig:22-42 curves; laser adds random freq_mul per shot).

LASER_SCRIPT = """
Laser = defmodule freq_mul: constant, carrier_mul: constant,
                  modulator_mul: constant, modulator_rad: constant,
                  note_on: boolean, begin
    mod_freq = freq_mul * modulator_mul * Curve(function=.smoothstep, curve=defcurve
        0.0 1000.0
        0.1 200.0
        0.2 100.0
    end)
    car_freq = freq_mul * carrier_mul * Curve(function=.smoothstep, curve=defcurve
        0.0 1000.0
        0.1 200.0
        0.2 100.0
    end)
    m = SineOsc(freq=mod_freq, phase=0) * modulator_rad
    c = SineOsc(freq=car_freq, phase=m)
    vol = Curve(function=.smoothstep, curve=defcurve
        0.0 0.0
        0.004 1.0
        0.2 0.0
    end)
    out c * vol
end
"""


def ex_laser(seconds=3.0, seed=0, backend="device"):
    rng = np.random.default_rng(seed)
    song = []
    t = 0.1
    nid = 1
    while t < seconds - 0.3:
        freq_mul = 1.0 + float(rng.random()) * 0.1 - 0.05
        song.append(_note({"freq_mul": freq_mul, "carrier_mul": 2.0,
                           "modulator_mul": 0.5, "modulator_rad": 1.0,
                           "note_on": True}, t, nid))
        song.append(_note({"freq_mul": freq_mul, "carrier_mul": 2.0,
                           "modulator_mul": 0.5, "modulator_rad": 1.0,
                           "note_on": False}, t + 0.25, nid))
        nid += 1
        t += 0.3
    return _render_script(LASER_SCRIPT, "Laser", song, seconds,
                          backend=backend)


def ex_curve(seconds=4.5, backend="device"):
    src = """
CurvePlayer = defmodule freq_mul: constant, note_on: boolean, begin
    out SineOsc(
        freq = freq_mul * Curve(curve=defcurve
            0.0  440.0
            0.5  880.0
            1.0  110.0
            1.5  660.0
            2.0  330.0
            3.9   20.0
        end, function=.linear),
        phase = SineOsc(
            freq = freq_mul * Curve(curve=defcurve
                0.0 110.0
                1.5  55.0
                3.0 220.0
            end, function=.smoothstep),
            phase = 0
        )
    )
end
"""
    song = _simple_song([(0.0, 4.0, 0.0)])
    for e in song:
        e.params["freq_mul"] = 1.0
    return _render_script(src, "CurvePlayer", song, seconds, backend=backend)


# ---------------------------------------------------------------------------
# example_subsong (examples/example_subsong.zig): notes within notes — each
# outer key triggers a 5-note inner melody, transposed by the outer freq.

SUBSONG_SCRIPT = f"""
SubtrackPlayer = defmodule freq: cob, note_on: boolean, begin
    base_freq = freq
    out from deftrack f: constant, gate: boolean, begin
        0.0 (f={A4 * tt.c4}, gate=true)
        1.0 (f={A4 * tt.ab3}, gate=true)
        2.0 (f={A4 * tt.g3}, gate=true)
        3.0 (f={A4 * tt.eb3}, gate=true)
        4.0 (f={A4 * tt.c3}, gate=true)
        5.0 (f={A4 * tt.c3}, gate=false)
    end, 1 begin
        e = Envelope(attack=.cubed(0.025), decay=.cubed(0.1),
                     release=.cubed(1.0), sustain_volume=0.5, note_on=gate)
        out SineOsc(freq = f * base_freq / {A4 * tt.c4}, phase=0) * e
    end
end
"""


def ex_subsong(seconds=8.0, backend="device"):
    song = _simple_song([(0.0, 5.5, A4 * tt.c4), (6.0, 1.8, A4 * tt.e4)])
    return _render_script(SUBSONG_SCRIPT, "SubtrackPlayer", song, seconds,
                          backend=backend)


# ---------------------------------------------------------------------------
# example_two (examples/example_two.zig): a note plays only while BOTH
# impulse streams are active — host-side span intersection feeding one voice.


def ex_two(seconds=4.0, backend="device"):
    sr = 48000.0
    # stream 0: keys (freq); stream 1: color changes; intersect note_on
    s0 = [(0.2, 1.2, A4 * tt.a3), (1.8, 1.8, A4 * tt.c4)]
    s1_on = [(0.5, 2.8)]
    song = []
    nid = 1
    for t0, dur, freq in s0:
        for t1, dur1 in s1_on:
            lo = max(t0, t1)
            hi = min(t0 + dur, t1 + dur1)
            if lo < hi:
                song.append(_note({"freq": freq, "note_on": True}, lo, nid))
                song.append(_note({"freq": freq, "note_on": False}, hi, nid))
                nid += 1
    song.sort(key=lambda e: (e.t, e.note_id))
    src = """
Two = defmodule freq: cob, note_on: boolean, begin
    e = Envelope(attack=.instantaneous, decay=.instantaneous,
                 release=.linear(0.3), sustain_volume=1, note_on)
    out SineOsc(freq, phase=0) * e * 0.5
end
"""
    return _render_script(src, "Two", song, seconds, sr=sr, backend=backend)


# ---------------------------------------------------------------------------
# example_arpeggiator (examples/example_arpeggiator.zig): held keys cycled at
# 30ms per step — the Arpeggiator is an impulse-generating module; here the
# host generates its impulse stream and HardSquare plays it.


def ex_arpeggiator(seconds=4.0, backend="device"):
    sr = 48000.0
    step = 0.03
    chords = [
        (0.0, 2.0, [0, 4, 7]),        # major triad held
        (2.0, 1.9, [0, 3, 7, 10]),    # minor 7th held
    ]
    song = []
    nid = 1
    t = 0.0
    while t < seconds - step:
        for t0, dur, degs in chords:
            if t0 <= t < t0 + dur:
                deg = degs[int(round(t / step)) % len(degs)]
                f = A4 * tt.rel_freq(deg - 9)
                song.append(_note({"freq": f, "note_on": True}, t, nid))
                song.append(_note({"freq": f, "note_on": False}, t + step, nid))
                nid += 1
                break
        t += step
    song.sort(key=lambda e: (e.t, e.note_id))
    total = int(seconds * sr)
    tls = compile_timelines(song, 1, sr, total)
    return _render_parts([(ti.HardSquareInstrument(), tls)], seconds, sr,
                         backend=backend)


# ---------------------------------------------------------------------------
# example_polyphony (examples/example_polyphony.zig): 39 brute-force voices
# (one per key) + Decimator bitcrush on the mix.


def ex_polyphony(seconds=5.0, dec_fake_rate=6000.0, backend="device"):
    sr = 48000.0
    total = int(seconds * sr)
    keys = [(i, 0.15 + 0.11 * i) for i in range(12)]  # staggered chord roll
    tlss = []
    for i, t0 in keys:
        f = A4 * tt.rel_freq(i - 9)
        song = _simple_song([(t0, seconds - t0 - 1.0, f)])
        tlss.extend(compile_timelines(song, 1, sr, total))
    # pad to 39 voices like the reference's one-voice-per-key array
    while len(tlss) < 39:
        tlss.append(SubvoiceTimeline(
            starts=np.zeros((0,), np.int64), resets=np.zeros((0,), bool),
            params=[], total=total))

    class DecimatedNice(ti.NiceInstrument):
        def __init__(self):
            super().__init__(0.3)

        def plan(self, timelines, sample_rate):
            prog = super().plan(timelines, sample_rate)
            return prog

    inst = DecimatedNice()

    def post_fn(state, mix, ctx):
        cnt, val, out = effects.decimator(
            state["cnt"], state["val"], mix[None, :], dec_fake_rate, ctx.sample_rate)
        return {"cnt": cnt, "val": val}, out

    def post_init():
        return {"cnt": jnp.full((1,), 0xFFFFFFFF, jnp.uint32),
                "val": jnp.zeros((1,), jnp.float32)}

    def oracle_post():
        from ..oracle import examples as oex

        return oex.DecimatorPost(dec_fake_rate)

    return _render_parts([(inst, tlss)], seconds, sr, post_fn=post_fn,
                         post_init=post_init, backend=backend,
                         oracle_post=oracle_post)


# ---------------------------------------------------------------------------
# example_stereo (examples/example_stereo.zig): two filtered noise voices
# panned by a 0.1 Hz sine; continuous (no notes).


class _StereoNoise:
    """Custom instrument: outputs stereo [2, n] directly."""

    output_channels = 2

    def plan(self, timelines, sample_rate):
        return {"active_from": active_from(timelines)}

    def init_state(self, num_voices):
        return {
            "pan_cnt": jnp.zeros((), jnp.uint32),
            "l0": jnp.zeros((2,), jnp.float32), "b0": jnp.zeros((2,), jnp.float32),
        }

    def render(self, state, prog, ctx):
        import jax

        sr = ctx.sample_rate
        pan_cnt, pan = oscillators.sine_osc(
            state["pan_cnt"], jnp.full((ctx.n,), jnp.float32(0.1)), 0.0, sr)
        key = jax.random.fold_in(jax.random.PRNGKey(0xA0D10), ctx.t_idx[0])
        white, _ = noise_ops.white_noise(key, (2, ctx.n))
        cut0 = filters.cutoff_from_frequency(jnp.float32(320.0), jnp.float32(sr))
        cut1 = filters.cutoff_from_frequency(jnp.float32(380.0), jnp.float32(sr))
        cut = jnp.stack([cut0, cut1])[:, None]
        l, b, filtered = filters.svf_filter(
            state["l0"], state["b0"], white, "low_pass", cut, 0.4)
        filtered = filtered * jnp.float32(4.0)
        # voice 0 pans 0..0.5, voice 1 pans 0.5..1 (scaleWave)
        pan01_a = pan[None, :] * jnp.float32(0.25) + jnp.float32(0.25)
        pan01_b = pan[None, :] * jnp.float32(0.25) + jnp.float32(0.75)
        panv = jnp.concatenate([pan01_a, pan01_b], axis=0)
        left = jnp.sum(filtered * panv, axis=0)
        right = jnp.sum(filtered * (jnp.float32(1.0) - panv), axis=0)
        out = jnp.stack([left, right])
        return {"pan_cnt": pan_cnt, "l0": l, "b0": b}, out


def ex_stereo(seconds=6.0, backend="device"):
    sr = 48000.0
    total = int(seconds * sr)
    if backend == "oracle":
        from ..oracle import examples as oex

        return oex.render_stereo_noise(total, sr, chunk=DEFAULT_CHUNK), sr
    song = _simple_song([(0.0, seconds, 1.0)])
    tls = compile_timelines(song, 1, sr, total)
    return _render_parts([(_StereoNoise(), tls)], seconds, sr, num_channels=2)


# ---------------------------------------------------------------------------
# example_detuned (examples/example_detuned.zig): slow-filtered noise warble
# modulating a trisaw's frequency; env + lowpass; through StereoEchoes.


class _DetunedInstrument:
    def plan(self, timelines, sample_rate):
        prog = {"active_from": active_from(timelines),
                "phase": oscillators.plan_phase_segments(
                    timelines, lambda p: F32(p["freq"]), sample_rate,
                    guard_div8=True)}
        env_const = {
            "attack": PaintCurve.cubed(0.025), "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(1.0), "sustain_volume": 0.5,
        }
        segs = [control.compile_envelope(
            tl, sample_rate,
            lambda k, p: {**env_const, "note_on": bool(p["note_on"])})
            for tl in timelines]
        prog["env"] = control.painter_program(segs, timelines[0].total)
        # per-note freq as a column for the warble multiply
        freq = np.zeros_like(prog["phase"].values["valid"])
        for v, tl in enumerate(timelines):
            k = len(tl.starts)
            if k:
                freq[v, :k] = tl.param_f32(lambda p: F32(p["freq"]))
                freq[v, k:] = freq[v, k - 1]
        prog["phase"].values["freq"] = freq
        return prog

    def init_state(self, num_voices):
        z = lambda: jnp.zeros((num_voices,), jnp.float32)
        return {"cnt": jnp.zeros((num_voices,), jnp.uint32),
                "nl": z(), "nb": z(), "l": z(), "b": z()}

    def render(self, state, prog, ctx):
        import jax

        act = ctx.t_idx[None, :] >= jnp.asarray(prog["active_from"])[:, None]
        V = act.shape[0]
        key = jax.random.fold_in(jax.random.PRNGKey(0xDE7), ctx.t_idx[0])
        white, _ = noise_ops.white_noise(key, (V, ctx.n))
        cut = filters.cutoff_from_frequency(jnp.float32(4.0), jnp.float32(ctx.sample_rate))
        nl, nb, warble = filters.svf_filter(
            state["nl"], state["nb"], white, "low_pass", cut, 0.0)
        warble = warble * jnp.float32(4.0)  # examples: zang.multiplyWithScalar 4
        vals = eval_chunk(prog["phase"], ctx.t_idx)
        freq = vals["freq"] * jnp.exp2(warble)
        cnt, osc = oscillators.trisaw_naive(
            state["cnt"], freq, 0.0, ctx.sample_rate, act)
        env = control.eval_painter(eval_chunk(prog["env"], ctx.t_idx), ctx.t_idx)
        pre = osc * env
        cutm = filters.cutoff_from_frequency(
            jnp.float32(880.0 * 8.0), jnp.float32(ctx.sample_rate))
        l, b, out = filters.svf_filter(
            state["l"], state["b"], pre, "low_pass", cutm, 0.7, act)
        return {"cnt": cnt, "nl": nl, "nb": nb, "l": l, "b": b}, out


def ex_detuned(seconds=5.0, backend="device"):
    from ..ops import delay as d_ops

    sr = 48000.0
    song = _simple_song([
        (0.2, 0.8, A4 * tt.c3), (1.2, 0.8, A4 * tt.eb3),
        (2.2, 0.8, A4 * tt.g3), (3.2, 1.2, A4 * tt.c4),
    ])
    total = int(seconds * sr)
    tls = compile_timelines(song, 2, sr, total)

    def post_fn(state, mix, ctx):
        state, stereo = d_ops.stereo_echoes(state, mix, 0.6, 0.7)
        return state, stereo

    def oracle_parts():
        from ..oracle import examples as oex

        warble = oex.detuned_warble(len(tls), total, sr, chunk=DEFAULT_CHUNK)
        return [(lambda v: oex.DetunedTwin(warble[v], sr),
                 oex.std_params, 2, tls)]

    def oracle_post():
        from ..oracle import examples as oex

        return oex.StereoEchoesPost(15000, 0.6, 0.7)

    return _render_parts([(_DetunedInstrument(), tls)], seconds, sr,
                         num_channels=2, post_fn=post_fn,
                         post_init=lambda: d_ops.stereo_echoes_init(15000),
                         backend=backend, oracle_parts=oracle_parts,
                         oracle_post=oracle_post)


# ---------------------------------------------------------------------------
# example_portamento (examples/example_portamento.zig): monophonic synth,
# frequency glides (cubed 0.5) to the highest held key; envelope resets only
# when all keys were released.


def ex_portamento(seconds=4.0, backend="device"):
    sr = 48000.0
    total = int(seconds * sr)
    # scripted mono keyboard: (time, freq or None=all released)
    moves = [(0.2, A4 * tt.c3), (0.8, A4 * tt.g3), (1.4, A4 * tt.e3),
             (2.0, None), (2.4, A4 * tt.a3), (3.2, None)]
    song = []
    nid = 0
    prev_on = False
    for t, f in moves:
        if f is not None:
            nid += 1
            song.append(_note({"freq": float(F32(f)), "note_on": True,
                               "prev_note_on": prev_on}, t, nid))
            prev_on = True
        else:
            song.append(_note({"freq": song[-1].params["freq"],
                               "note_on": False, "prev_note_on": prev_on},
                              t, nid))
            prev_on = False
    tls = compile_timelines(song, 1, sr, total)

    class PortaInstrument:
        def plan(self, timelines, sample_rate):
            prog = {"active_from": active_from(timelines)}
            porta_segs = [control.compile_portamento(
                tl, sample_rate,
                lambda k, p: {"curve": PaintCurve.cubed(0.5),
                              "goal": F32(p["freq"]),
                              "note_on": bool(p["note_on"]),
                              "prev_note_on": bool(p["prev_note_on"])})
                for tl in timelines]
            prog["porta"] = control.painter_program(porta_segs, timelines[0].total)
            # envelope resets only when a note starts with all keys released
            env_tls = [
                SubvoiceTimeline(
                    starts=tl.starts,
                    resets=np.array([
                        bool(p["note_on"]) and not bool(p["prev_note_on"])
                        for p in tl.params], dtype=bool),
                    params=tl.params, total=tl.total)
                for tl in timelines
            ]
            env_const = {"attack": PaintCurve.cubed(0.025),
                         "decay": PaintCurve.cubed(0.1),
                         "release": PaintCurve.cubed(1.0),
                         "sustain_volume": 0.5}
            segs = [control.compile_envelope(
                tl, sample_rate,
                lambda k, p: {**env_const, "note_on": bool(p["note_on"])})
                for tl in env_tls]
            prog["env"] = control.painter_program(segs, timelines[0].total)
            return prog

        def init_state(self, num_voices):
            return {"cnt": jnp.zeros((num_voices,), jnp.uint32)}

        def render(self, state, prog, ctx):
            act = ctx.t_idx[None, :] >= jnp.asarray(prog["active_from"])[:, None]
            freq = control.eval_painter(eval_chunk(prog["porta"], ctx.t_idx), ctx.t_idx)
            cnt, osc = oscillators.sine_osc(state["cnt"], freq, 0.0,
                                            ctx.sample_rate, act)
            env = control.eval_painter(eval_chunk(prog["env"], ctx.t_idx), ctx.t_idx)
            return {"cnt": cnt}, env * osc

    def oracle_parts():
        from ..oracle import examples as oex

        def porta_params(sr_, p):
            return {"sample_rate": sr_, "freq": p["freq"],
                    "note_on": p["note_on"],
                    "prev_note_on": p["prev_note_on"]}

        return [(lambda v: oex.PortaTwin(), porta_params, 2, tls)]

    return _render_parts([(PortaInstrument(), tls)], seconds, sr,
                         backend=backend, oracle_parts=oracle_parts)


# ---------------------------------------------------------------------------
# example_mouse (examples/example_mouse.zig): PM osc whose ratio/multiplier
# follow portamento-smoothed pointer coordinates (linear 0.1 glides).


def ex_mouse(seconds=4.0, backend="device"):
    sr = 48000.0
    total = int(seconds * sr)
    # scripted pointer path: (t, x, y) in [0,1]^2, sampled as events with
    # the same f32 frame quantization the live mouseEvent path would get
    path = [(0.0, 0.3, 0.5), (0.5, 0.5, 0.6), (1.0, 0.8, 0.3),
            (1.5, 0.4, 0.8), (2.0, 0.6, 0.2), (2.5, 0.9, 0.9),
            (3.0, 0.2, 0.4)]
    ctl_song = [_note({"v": i, "note_on": True}, t, i + 1)
                for i, (t, x, y) in enumerate(path)]
    ctl_tl = compile_timelines(ctl_song, 1, sr, total)[0]
    controllers = {
        "x": [(int(f), path[k][1]) for k, f in enumerate(ctl_tl.starts)],
        "y": [(int(f), path[k][2]) for k, f in enumerate(ctl_tl.starts)],
    }
    key_song = _simple_song([(0.1, seconds - 0.8, A4 * tt.a3)])
    tls = compile_timelines(key_song, 1, sr, total)
    # the instrument (with live controller + mode-parameter support) lives
    # in host/instruments.py; the offline config bakes the scripted
    # trajectory in as its default controller stream
    from .instruments import MousePMInstrument

    def oracle_parts():
        from ..oracle import examples as oex

        ratio = oex.controller_buffer(controllers["x"], total, sr,
                                      lambda v: F32(v * 4.0))
        mult = oex.controller_buffer(controllers["y"], total, sr,
                                     lambda v: F32(v * 2.0))
        return [(lambda v: oex.MousePMTwin(ratio, mult),
                 oex.std_params, 2, tls)]

    return _render_parts([(MousePMInstrument(controllers=controllers), tls)],
                         seconds, sr, backend=backend,
                         oracle_parts=oracle_parts)


# ---------------------------------------------------------------------------
# example_fmsynth (examples/example_fmsynth.zig): OPL-style 2-operator FM,
# 8-voice polyphony. The instrument (with the reference's full 22-parameter
# live surface) lives in host/instruments.py; re-exported here because the
# offline config and its tests address it as an example.

from .instruments import FMSynthInstrument  # noqa: E402


def ex_fmsynth(seconds=4.0, backend="device"):
    sr = 48000.0
    total = int(seconds * sr)
    song = _simple_song([
        (0.1 + 0.4 * i, 0.3, A4 * tt.rel_freq(n))
        for i, n in enumerate([-9, -5, -2, 0, 3, 0, -2, -5])
    ])
    tls = compile_timelines(song, 8, sr, total)
    inst = FMSynthInstrument()

    def oracle_parts():
        from ..oracle import examples as oex

        return [(lambda v: oex.FMSynthTwin(inst.mod, inst.car, inst.algorithm),
                 oex.std_params, 1, tls)]

    return _render_parts([(inst, tls)], seconds, sr,
                         backend=backend, oracle_parts=oracle_parts)


# ---------------------------------------------------------------------------
# example_sampler (examples/example_sampler.zig): looped drumloop playback
# through overdrive + decimator. The r/speed keyboard controls become config
# arguments of the shared SamplerInstrument (host/configs.py).


def ex_sampler(seconds=6.0, backend="device"):
    from .configs import build_sampler_performance

    if backend == "oracle":
        from ..oracle import examples as oex

        return oex.render_sampler_chain(seconds)[None, :], 44100.0
    perf, total = build_sampler_performance(seconds=seconds)
    return render_performance(perf, total,
                              chunk_size=DEFAULT_CHUNK), perf.sample_rate


# ---------------------------------------------------------------------------
# example_polyphony2 (examples/example_polyphony2.zig): NiceInstrument(0.3)
# behind a 3-slot PolyphonyDispatcher. The scripted song holds 5-note
# overlap so slot recycling + voice stealing (notes.zig:246-306) is
# exercised, not just round-robin.


def ex_polyphony2(seconds=6.0, backend="device"):
    sr = 48000.0
    a4 = 220.0
    total = int(seconds * sr)
    song = _simple_song([
        (0.2 + 0.25 * i, 1.2, a4 * tt.rel_freq(n))
        for i, n in enumerate([0, 4, 7, 12, 16, 12, 7, 4, 0, -5, -1, 2, 7])
    ])
    tls = compile_timelines(song, 3, sr, total)
    return _render_parts([(ti.NiceInstrument(0.3), tls)], seconds, sr,
                         backend=backend)


# ---------------------------------------------------------------------------
# example_delay (examples/example_delay.zig): HardSquareInstrument keyboard
# voice through StereoEchoes(15000) (examples/modules.zig:464-525).


def ex_delay(seconds=8.0, backend="device"):
    from ..ops import delay as d_ops

    sr = 48000.0
    total = int(seconds * sr)
    song = _simple_song([
        (0.2 + 0.5 * i, 0.25, A4 * tt.rel_freq(n))
        for i, n in enumerate([-12, -5, 0, 3, 7, 3, 0, -5])
    ])
    tls = compile_timelines(song, 1, sr, total)

    def post_fn(state, mix, ctx):
        return d_ops.stereo_echoes(state, mix, 0.6, 0.7)

    def post_init():
        return d_ops.stereo_echoes_init(15000)

    def oracle_post():
        from ..oracle import examples as oex

        return oex.StereoEchoesPost(15000, 0.6, 0.7)

    return _render_parts([(ti.HardSquareInstrument(), tls)], seconds, sr,
                         num_channels=2, post_fn=post_fn, post_init=post_init,
                         backend=backend, oracle_post=oracle_post)


# ---------------------------------------------------------------------------
# example_script (examples/example_script.zig): play a scripted module. The
# reference pre-compiles script.txt to scriptgen.zig with zangc; here the
# DSL compiles straight to the device graph. The demo script exercises the
# same feature set as the reference fixture (defcurve argument, delay +
# feedback block, Filter in the feedback path, builtin fns).

DEMO_SCRIPT = """
// curve-swept FM blip (the CurvePlayer pattern, examples/script.txt shape)
SweepVoice = defmodule freq_mul: constant, begin
    out SineOsc(freq = freq_mul * Curve(function=.smoothstep, curve=defcurve
        0.0 440.0
        0.6 880.0
        1.2 220.0
        1.8 550.0
        2.4 110.0
    end), phase=0) * 0.5
end

DemoSynth = defmodule freq: cob, note_on: boolean, begin
    e = Envelope(attack=.cubed(0.02), decay=.cubed(0.1), release=.cubed(0.6),
                 sustain_volume=0.7, note_on)
    s = PulseOsc(freq, color=0.3) * e
    out delay 11025 begin
        result = s + feedback * 0.5
        out result
        feedback Filter(input=result, type=.low_pass, cutoff=0.2, res=0)
    end
end
"""


def ex_script(seconds=6.0, backend="device"):
    sr = 44100.0
    song = _simple_song([
        (0.2 + 0.45 * i, 0.3, A4 * tt.rel_freq(n))
        for i, n in enumerate([-9, -2, 0, 3, 0, -2, -9, -14])
    ])
    return _render_script(DEMO_SCRIPT, "DemoSynth", song, seconds, sr=sr,
                          backend=backend)


# ---------------------------------------------------------------------------
# example_script_runtime_mono/poly (examples/example_script_runtime_*.zig):
# live reload. The script is rendered, edited on disk, reloaded through
# LiveScript (re-jit replaces the reference's bytecode interpreter), and
# rendered again — the two halves are concatenated.


def ex_script_runtime(seconds=6.0, backend="device"):
    import tempfile

    from ..script.runtime import LiveScript

    sr = 44100.0
    half = seconds / 2.0
    total = int(half * sr)
    song = _simple_song([
        (0.15 + 0.4 * i, 0.3, A4 * tt.rel_freq(n))
        for i, n in enumerate([0, 3, 7, 3, 0, -5])
    ])
    if backend == "oracle":
        edited = (DEMO_SCRIPT.replace("color=0.3", "color=0.5")
                  .replace(".cubed(0.6)", ".cubed(0.2)"))
        first = _render_script(DEMO_SCRIPT, "DemoSynth", song, half, sr=sr,
                               polyphony=2, backend="oracle")[0]
        second = _render_script(edited, "DemoSynth", song, half, sr=sr,
                                polyphony=2, backend="oracle")[0]
        return np.concatenate([first, second], axis=-1), sr
    tls = compile_timelines(song, 2, sr, total)
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(DEMO_SCRIPT)
        path = f.name
    try:
        live = LiveScript(path, "DemoSynth")
        assert live.ok, live.error
        first = render_performance(
            Performance([(live.instrument, tls)], sr), total,
            chunk_size=DEFAULT_CHUNK)
        # edit: brighter pulse + faster release, then hot-reload
        with open(path, "w") as f:
            f.write(DEMO_SCRIPT.replace("color=0.3", "color=0.5")
                    .replace(".cubed(0.6)", ".cubed(0.2)"))
        assert live.maybe_reload() and live.ok, live.error
        second = render_performance(
            Performance([(live.instrument, tls)], sr), total,
            chunk_size=DEFAULT_CHUNK)
    finally:
        os.unlink(path)
    return np.concatenate([first, second], axis=-1), sr


# ---------------------------------------------------------------------------
# example_song / write_wav (examples/example_song.zig, write_wav.zig): the
# Bach Toccata. Full 385 s render is the bench; this entry renders a slice.


# the song's measured-optimal render chunk (CLAUDE.md perf journal);
# module-level like DEFAULT_CHUNK so the chunk-invariance sweep can vary it
SONG_CHUNK = 65536


def ex_song(seconds=20.0, backend="device"):
    from ..graph.render import render_performance as rp
    from . import song as sm

    if backend == "oracle":
        return np.atleast_2d(sm.render_song_oracle(seconds)), float(sm.SAMPLE_RATE)
    total = int(seconds * sm.SAMPLE_RATE)
    perf = sm.build_performance(total)
    return rp(perf, total, chunk_size=SONG_CHUNK), float(sm.SAMPLE_RATE)


# ---------------------------------------------------------------------------
# registry + CLI


EXAMPLES = {
    "play": ex_play,
    "envelope": ex_envelope,
    "vibrato": ex_vibrato,
    "curve": ex_curve,
    "laser": ex_laser,
    "subsong": ex_subsong,
    "two": ex_two,
    "arpeggiator": ex_arpeggiator,
    "polyphony": ex_polyphony,
    "stereo": ex_stereo,
    "detuned": ex_detuned,
    "portamento": ex_portamento,
    "mouse": ex_mouse,
    "fmsynth": ex_fmsynth,
    "sampler": ex_sampler,
    "polyphony2": ex_polyphony2,
    "delay": ex_delay,
    "script": ex_script,
    "script_runtime": ex_script_runtime,
    "song": ex_song,
}


def main(argv=None):
    import argparse

    from ..platform import enable_compile_cache

    enable_compile_cache()

    from ..core.mixdown import mixdown_s16_np
    from ..core.wav import write_wav_s16

    ap = argparse.ArgumentParser(
        prog="zang-examples",
        description="Render a ported reference example to WAV.")
    ap.add_argument("name", choices=sorted(EXAMPLES))
    ap.add_argument("output")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    fn = EXAMPLES[args.name]
    audio, sr = fn(**({"seconds": args.seconds} if args.seconds else {}))
    pcm = mixdown_s16_np(np.asarray(audio), 0.25)
    ch = pcm.shape[0]
    write_wav_s16(args.output, pcm if ch > 1 else pcm[0], int(sr), num_channels=ch)
    print(f"{args.name}: wrote {args.output} ({audio.shape[-1]/sr:.1f}s, {ch}ch)")


if __name__ == "__main__":
    main()
