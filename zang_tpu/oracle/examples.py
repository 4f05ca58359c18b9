"""Oracle twins for the example configs (host/examples.py).

Each twin renders the same audio as its device config through the sequential
oracle modules (reference semantics, parity formulations), so every example
gets an end-to-end golden comparison (tests/test_examples_golden.py) — the
reference treats its examples as the acceptance suite (SURVEY.md §4).

The driver here consumes the SAME compiled timelines as the engine
(compile_timelines output) and paints per block(1024) ∩ segment spans —
exactly the span structure the reference host produces (NoteTracker/
Trigger parity is separately proven by tests/test_notes.py and
tests/test_parity.py's Voice-driven renders). Noise examples draw their
uniform tapes from the same counter-based threefry streams as the engine
(ops/noise.py): noise has no reference golden, so the tape is shared and
the DSP around it is what's under test.
"""

from typing import Callable, List, Optional

import numpy as np

from ..core.curves import PaintCurve
from ..core.span import Span
from . import instruments as oi
from . import modules as m
from . import native

F32 = np.float32
BLOCK = 1024


def std_params(sr, p):
    return {"sample_rate": sr, "freq": p["freq"], "note_on": p["note_on"]}


# ---------------------------------------------------------------------------
# timeline walker: paint per block(1024) ∩ segment with absolute spans


def walk_timeline(module, tl, sr, outputs, temps, make_params,
                  block: int = BLOCK) -> None:
    """Paint one subvoice timeline through a stateful oracle module."""
    starts = np.asarray(tl.starts, dtype=np.int64)
    K = len(starts)
    total = tl.total
    for k in range(K):
        s = int(starts[k])
        e = int(starts[k + 1]) if k + 1 < K else total
        if s >= total:
            break
        e = min(e, total)
        params = make_params(sr, tl.params[k])
        first = True
        pos = s
        while pos < e:
            span_end = min(e, (pos // block + 1) * block)
            nic = bool(tl.resets[k]) and first
            module.paint(Span(pos, span_end), outputs, temps, nic, params)
            first = False
            pos = span_end


def render_part(make_module, tls, sr, total, make_params=std_params,
                num_outputs=1, num_temps=0) -> np.ndarray:
    """All subvoices of one part, summed: f32 [num_outputs, total].

    make_module(v) receives the subvoice index (twins that precompute
    per-voice trajectories slice by it)."""
    out = np.zeros((num_outputs, total), dtype=np.float32)
    temps = [np.zeros(total, dtype=np.float32) for _ in range(num_temps)]
    for v, tl in enumerate(tls):
        walk_timeline(make_module(v), tl, sr, list(out), temps, make_params)
    return out


# ---------------------------------------------------------------------------
# posts (graph.render Performance.post_fn twins)


class DecimatorPost:
    """example_polyphony's bitcrush on the mix (parity counter form)."""

    def __init__(self, fake_sample_rate: float) -> None:
        self.dec = m.Decimator(mode="parity")
        self.fake = float(fake_sample_rate)

    def __call__(self, mix: np.ndarray, sr: float) -> np.ndarray:
        out = np.zeros_like(mix)
        n = mix.shape[-1]
        for s in range(0, n, BLOCK):
            e = min(n, s + BLOCK)
            self.dec.paint(Span(s, e), [out[0]], [], False, {
                "sample_rate": sr, "input": mix[0],
                "fake_sample_rate": self.fake,
            })
        return out


class StereoEchoesPost:
    """StereoEchoes(main_delay) on the mono mix (examples/modules.zig:464)."""

    def __init__(self, main_delay: int, feedback_volume: float,
                 cutoff: float) -> None:
        self.echo = oi.StereoEchoes(main_delay, mode="parity")
        self.fv = float(feedback_volume)
        self.cutoff = float(cutoff)

    def __call__(self, mix: np.ndarray, sr: float) -> np.ndarray:
        n = mix.shape[-1]
        out = np.zeros((2, n), dtype=np.float32)
        temps = [np.zeros(n, dtype=np.float32) for _ in range(4)]
        for s in range(0, n, BLOCK):
            e = min(n, s + BLOCK)
            self.echo.paint(Span(s, e), list(out), temps, False, {
                "input": mix[0], "feedback_volume": self.fv,
                "cutoff": self.cutoff,
            })
        return out


def render_parts(parts, total, sr, num_channels=1, post=None) -> np.ndarray:
    """Oracle twin of render_performance for walker-driven parts.

    parts: list of (make_module, make_params, num_temps, timelines).
    post: optional callable(mix [1, total], sr) -> [C, total].
    """
    mix = np.zeros((1, total), dtype=np.float32)
    for make_module, make_params, num_temps, tls in parts:
        mix += render_part(make_module, tls, sr, total, make_params,
                           num_outputs=1, num_temps=num_temps)
    if post is not None:
        return post(mix, sr)
    if num_channels == 1:
        return mix
    return np.repeat(mix, num_channels, axis=0)


# ---------------------------------------------------------------------------
# engine-shared noise tapes: the device renderer draws uniform tapes from
# counter-based threefry keyed per chunk (script/jax_backend.py exec_op
# "noise"; _StereoNoise/_DetunedInstrument in host/examples.py). threefry
# is backend-invariant, so the oracle re-derives the identical stream.


def engine_white(seed_key: int, V: int, total: int, chunk: int) -> np.ndarray:
    """white noise [V, total] as the engine generates it: per chunk c0,
    uniform(fold_in(PRNGKey(seed_key), c0), (V, chunk)) * 2 - 1."""
    import jax

    cols = []
    for c0 in range(0, total, chunk):
        key = jax.random.fold_in(jax.random.PRNGKey(seed_key), c0)
        tape = np.asarray(jax.random.uniform(key, (V, chunk),
                                             dtype=np.float32))
        cols.append(tape[:, : min(chunk, total - c0)])
    w = np.concatenate(cols, axis=1)
    return w * np.float32(2.0) - np.float32(1.0)


# ---------------------------------------------------------------------------
# custom-instrument twins


class PortaTwin:
    """example_portamento's Instrument (example_portamento.zig:20-88):
    Portamento(cubed 0.5) -> freq, Envelope reset only when all keys were
    released, SineOsc on the glided frequency."""

    num_outputs = 1
    num_temps = 2

    def __init__(self) -> None:
        self.porta = m.Portamento(mode="parity")
        self.env = m.Envelope(mode="parity")
        self.osc = m.SineOsc(mode="parity")

    def paint(self, span, outputs, temps, nic, params):
        sl = slice(span.start, span.end)
        temps[0][sl] = 0.0
        self.porta.paint(span, [temps[0]], [], nic, {
            "sample_rate": params["sample_rate"],
            "curve": PaintCurve.cubed(0.5),
            "goal": params["freq"],
            "note_on": params["note_on"],
            "prev_note_on": params["prev_note_on"],
        })
        new_note = bool(params["note_on"]) and not bool(params["prev_note_on"])
        temps[1][sl] = 0.0
        self.env.paint(span, [temps[1]], [], new_note and nic, {
            "sample_rate": params["sample_rate"],
            "attack": PaintCurve.cubed(0.025),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(1.0),
            "sustain_volume": 0.5,
            "note_on": params["note_on"],
        })
        env = temps[1][sl].copy()
        temps[1][sl] = 0.0
        self.osc.paint(span, [temps[1]], [], False, {
            "sample_rate": params["sample_rate"],
            "freq": temps[0], "phase": 0.0,
        })
        outputs[0][sl] += env * temps[1][sl]


def controller_buffer(events, total: int, sr: float, goal_fn) -> np.ndarray:
    """Portamento-smoothed controller trajectory [total] — the oracle twin
    of MousePMInstrument._controller_program (linear 0.1 re-targeting
    glides, example_mouse.zig:152-190)."""
    porta = m.Portamento(mode="parity")
    buf = np.zeros(total, dtype=np.float32)
    # stable frame-only sort, matching _controller_program: same-frame
    # moves keep push order so the last push wins in every path
    evs = sorted(events, key=lambda ev: ev[0])
    for i, (s, v) in enumerate(evs):
        e = evs[i + 1][0] if i + 1 < len(evs) else max(total, int(s) + 1)
        s, e = int(s), min(int(e), total)
        if s >= e:
            continue
        pos = s
        first = True
        while pos < e:
            span_end = min(e, (pos // BLOCK + 1) * BLOCK)
            porta.paint(Span(pos, span_end), [buf], [], first, {
                "sample_rate": sr,
                "curve": PaintCurve.linear(0.1),
                "goal": F32(goal_fn(v)),
                "note_on": True, "prev_note_on": True,
            })
            first = False
            pos = span_end
    return buf


class MousePMTwin:
    """example_mouse's PM voice: mod SineOsc at freq*ratio, carrier SineOsc
    phase-modulated by mod*mult, ADSR (example_mouse.zig:44-110).

    ratio/mult are the precomputed controller trajectories (relative mode:
    goal = x*4 / y*2, example_mouse.zig:160-166)."""

    num_outputs = 1
    num_temps = 2

    def __init__(self, ratio: np.ndarray, mult: np.ndarray) -> None:
        self.ratio = ratio
        self.mult = mult
        self.mod = m.SineOsc(mode="parity")
        self.car = m.SineOsc(mode="parity")
        self.env = m.Envelope(mode="parity")

    def paint(self, span, outputs, temps, nic, params):
        sl = slice(span.start, span.end)
        freq = F32(params["freq"])
        temps[0][sl] = 0.0
        self.mod.paint(span, [temps[0]], [], nic, {
            "sample_rate": params["sample_rate"],
            "freq": self.ratio * freq, "phase": 0.0,
        })
        temps[0][sl] *= self.mult[sl]
        temps[1][sl] = 0.0
        self.car.paint(span, [temps[1]], [], nic, {
            "sample_rate": params["sample_rate"],
            "freq": float(freq), "phase": temps[0],
        })
        car = temps[1][sl].copy()
        temps[1][sl] = 0.0
        self.env.paint(span, [temps[1]], [], nic, {
            "sample_rate": params["sample_rate"],
            "attack": PaintCurve.cubed(0.025),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(1.0),
            "sustain_volume": 0.5,
            "note_on": params["note_on"],
        })
        outputs[0][sl] += car * temps[1][sl]


def _np_ifreq(freq, sr: float) -> np.uint32:
    """freq_to_ifreq twin (ops/scan.py:62-71), scalar."""
    srbase = F32(F32(4294967296.0) / F32(sr))
    scaled = F32(srbase * F32(freq))
    mag = np.uint32(np.abs(scaled))
    if scaled >= 0:
        return mag
    with np.errstate(over="ignore"):
        return np.uint32(np.uint32(0) - mag)


def _np_utof23(cnt: np.ndarray) -> np.ndarray:
    bits = (cnt >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


_PI = np.float32(3.14159265358979323846)


class FMOpState:
    """One OPL operator's phase/feedback state (ops/fm.py parity)."""

    def __init__(self) -> None:
        self.cnt = np.uint32(0)
        self.fb = np.array([0.0, 0.0], dtype=np.float32)

    def advance(self, n: int, ifreq: np.uint32) -> np.ndarray:
        """u32 phase counters for n samples; advances the stored counter."""
        with np.errstate(over="ignore"):
            steps = np.full(n, ifreq, dtype=np.uint32)
            cnt = self.cnt + np.concatenate(
                [[np.uint32(0)], np.cumsum(steps[:-1], dtype=np.uint32)])
            self.cnt = np.uint32(self.cnt + np.uint32(np.uint32(n) * ifreq))
        return cnt


def _fm_feedback(base: np.ndarray, feedback: float, waveform: int,
                 fb: np.ndarray) -> np.ndarray:
    """zo_fm_feedback (sequential sin recurrence, example_fmsynth.zig:26-88)."""
    import ctypes

    out = np.empty_like(base)
    base = np.ascontiguousarray(base, dtype=np.float32)
    f1 = np.array([fb[0]], np.float32)
    f2 = np.array([fb[1]], np.float32)
    native.lib().zo_fm_feedback(
        native.fptr(out), native.fptr(base), out.size,
        ctypes.c_float(float(feedback)), int(waveform),
        native.fptr(f1), native.fptr(f2))
    fb[0], fb[1] = f1[0], f2[0]
    return out


class FMSynthTwin:
    """example_fmsynth's 2-op FM voice (host/instruments.py FMSynthInstrument
    twin; example_fmsynth.zig:206-360). Supports the non-LFO configs the
    offline example uses (tremolo/vibrato amounts 0)."""

    num_outputs = 1
    num_temps = 1

    def __init__(self, mod: dict, car: dict, algorithm: int) -> None:
        assert all(op["tremolo"] == 0.0 and op["vibrato"] == 0.0
                   for op in (mod, car)), "LFO configs need the lfo twin"
        self.p_mod, self.p_car = mod, car
        self.algorithm = algorithm
        self.s_mod, self.s_car = FMOpState(), FMOpState()
        self.env_mod = m.Envelope(mode="parity")
        self.env_car = m.Envelope(mode="parity")

    def _env(self, env, op, span, temps, nic, params):
        sl = slice(span.start, span.end)
        temps[0][sl] = 0.0
        env.paint(span, [temps[0]], [], nic, {
            "sample_rate": params["sample_rate"],
            "attack": PaintCurve.cubed(op["attack"]),
            "decay": PaintCurve.cubed(op["decay"]),
            "release": PaintCurve.cubed(op["release"]),
            "sustain_volume": op["sustain"],
            "note_on": params["note_on"],
        })
        return temps[0][sl].copy()

    def paint(self, span, outputs, temps, nic, params):
        sl = slice(span.start, span.end)
        n = span.end - span.start
        sr = params["sample_rate"]
        freq = F32(params["freq"])

        # modulator: base angles from the u32 phase, then the sequential
        # feedback recurrence (fb state persists across notes, ops/fm.py)
        ifreq_m = _np_ifreq(F32(freq * F32(self.p_mod["freq_mul"])), sr)
        cnt_m = self.s_mod.advance(n, ifreq_m)
        base_m = (_np_utof23(cnt_m) + np.float32(0.0)) * _PI * np.float32(2.0)
        mod_out = _fm_feedback(base_m, self.p_mod["feedback"],
                               self.p_mod["waveform"], self.s_mod.fb)
        env_m = self._env(self.env_mod, self.p_mod, span, temps, nic, params)
        mod_sig = mod_out * np.float32(self.p_mod["volume"]) * env_m

        # carrier: feedback always 0 (example_fmsynth.zig:345)
        ifreq_c = _np_ifreq(F32(freq * F32(self.p_car["freq_mul"])), sr)
        cnt_c = self.s_car.advance(n, ifreq_c)
        phase = mod_sig if self.algorithm == 1 else np.float32(0.0)
        base_c = (_np_utof23(cnt_c) + phase) * _PI * np.float32(2.0)
        car_out = _fm_feedback(base_c, 0.0, self.p_car["waveform"],
                               self.s_car.fb)
        env_c = self._env(self.env_car, self.p_car, span, temps, nic, params)
        out = car_out * np.float32(self.p_car["volume"]) * env_c
        if self.algorithm == 0:
            out = out + mod_sig
        outputs[0][sl] += out


class DetunedTwin:
    """example_detuned's voice: noise-warbled naive trisaw -> ADSR ->
    lowpass (host/examples.py _DetunedInstrument twin). `warble` is the
    precomputed exp2(4 * lowpass(white, 4 Hz)) multiplier row for this
    voice."""

    num_outputs = 1
    num_temps = 2

    def __init__(self, warble_mul: np.ndarray, sr: float) -> None:
        self.warble_mul = warble_mul
        self.osc = m.TriSawOsc(mode="parity")
        self.env = m.Envelope(mode="parity")
        self.flt = m.Filter(mode="parity")
        self.cut = m.cutoff_from_frequency(F32(F32(880.0) * F32(8.0)), F32(sr))

    def paint(self, span, outputs, temps, nic, params):
        sl = slice(span.start, span.end)
        freq = F32(params["freq"]) * self.warble_mul
        temps[0][sl] = 0.0
        self.osc.paint(span, [temps[0]], [], nic, {
            "sample_rate": params["sample_rate"],
            "freq": freq, "color": 0.0,
        })
        osc = temps[0][sl].copy()
        temps[0][sl] = 0.0
        self.env.paint(span, [temps[0]], [], nic, {
            "sample_rate": params["sample_rate"],
            "attack": PaintCurve.cubed(0.025),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(1.0),
            "sustain_volume": 0.5,
            "note_on": params["note_on"],
        })
        temps[1][sl] = osc * temps[0][sl]
        self.flt.paint(span, [outputs[0]], [], nic, {
            "input": temps[1], "type": "low_pass",
            "cutoff": float(self.cut), "res": 0.7,
        })


def detuned_warble(V: int, total: int, sr: float, chunk: int) -> np.ndarray:
    """exp2(4 * lowpass(white, 4 Hz)) rows [V, total] — the engine's warble
    trajectory (host/examples.py _DetunedInstrument.render), reproduced with
    the engine's own chunked ops.

    Like the threefry noise tape, this is a shared *input trajectory*, not
    DSP under test: the multiplier feeds the oscillator's per-sample u32
    phase step, so any ulp-level formulation difference (the affine-scan
    SVF vs the sequential loop, exp2 polynomials) phase-ACCUMULATES into
    tens of dB over seconds. The trisaw/envelope/final-filter cascade that
    consumes it is what this twin goldens; the 4 Hz SVF itself is covered
    by the direct filter parity tests (tests/test_ops_effects.py)."""
    import jax
    import jax.numpy as jnp

    from ..ops import filters, noise as noise_ops

    nl = jnp.zeros((V,), jnp.float32)
    nb = jnp.zeros((V,), jnp.float32)
    cut = filters.cutoff_from_frequency(jnp.float32(4.0), jnp.float32(sr))
    cols = []
    for c0 in range(0, total, chunk):
        key = jax.random.fold_in(jax.random.PRNGKey(0xDE7), c0)
        white, _ = noise_ops.white_noise(key, (V, chunk))
        nl, nb, w = filters.svf_filter(nl, nb, white, "low_pass", cut, 0.0)
        mul = jnp.exp2(w * jnp.float32(4.0))
        cols.append(np.asarray(mul)[:, : min(chunk, total - c0)])
    return np.concatenate(cols, axis=1)


def render_sampler_chain(seconds: float, sample_rate: float = 44100.0,
                         speed: float = 1.0, distort: bool = True,
                         fake_sample_rate: Optional[float] = 6000.0
                         ) -> np.ndarray:
    """example_sampler twin: looped drumloop * 2.5 -> overdrive ->
    decimator (host/configs.py SamplerInstrument defaults). Returns [total].
    """
    from ..core.wav import read_wav
    from ..host import configs

    w = read_wav(configs.DRUMLOOP)
    total = int(seconds * sample_rate)
    eff = float(F32(F32(w.sample_rate) * F32(speed)))
    sample = m.Sample(w.num_channels, eff, "signed16_lsb", w.data)
    sam = m.Sampler(mode="parity")
    a = np.zeros(total, dtype=np.float32)
    for s in range(0, total, BLOCK):
        e = min(total, s + BLOCK)
        sam.paint(Span(s, e), [a], [], s == 0, {
            "sample_rate": sample_rate, "sample": sample,
            "channel": 0, "loop": True,
        })
    a *= np.float32(2.5)  # example_sampler.zig:106
    if distort:
        b = np.zeros(total, dtype=np.float32)
        m.Distortion().paint(Span(0, total), [b], [], False, {
            "input": a, "type": "overdrive",
            "ingain": 0.9, "outgain": 0.5, "offset": 0.0,
        })
        a = b
    if fake_sample_rate is not None:
        c = np.zeros(total, dtype=np.float32)
        m.Decimator(mode="parity").paint(Span(0, total), [c], [], False, {
            "sample_rate": sample_rate, "input": a,
            "fake_sample_rate": float(fake_sample_rate),
        })
        a = c
    return a


def render_stereo_noise(total: int, sr: float, chunk: int) -> np.ndarray:
    """example_stereo twin (host/examples.py _StereoNoise): two filtered
    noise channels panned by a 0.1 Hz sine."""
    white = engine_white(0xA0D10, 2, total, chunk)
    pan = np.zeros(total, dtype=np.float32)
    m.SineOsc(mode="parity").paint(Span(0, total), [pan], [], False, {
        "sample_rate": sr, "freq": 0.1, "phase": 0.0,
    })
    cuts = [m.cutoff_from_frequency(F32(320.0), F32(sr)),
            m.cutoff_from_frequency(F32(380.0), F32(sr))]
    filtered = np.zeros((2, total), dtype=np.float32)
    for v in range(2):
        m.Filter(mode="parity").paint(Span(0, total), [filtered[v]], [], False, {
            "input": white[v], "type": "low_pass",
            "cutoff": float(cuts[v]), "res": 0.4,
        })
    filtered *= np.float32(4.0)
    pan_a = pan * np.float32(0.25) + np.float32(0.25)
    pan_b = pan * np.float32(0.25) + np.float32(0.75)
    left = filtered[0] * pan_a + filtered[1] * pan_b
    right = (filtered[0] * (np.float32(1.0) - pan_a)
             + filtered[1] * (np.float32(1.0) - pan_b))
    return np.stack([left, right])
