"""Device-side instruments: JAX counterparts of examples/modules.zig.

Each instrument implements the graph.render Instrument protocol:
plan() compiles note timelines into segment programs (host): exact u32
phase-counter coefficients for oscillators, closed-form painter programs
for envelopes/gates, piecewise cutoff tables for filters. render()
evaluates a whole chunk for all subvoices in parallel (device) — the
oscillators are *stateless* (phase = A + t*ifreq mod 2^32, bit-identical
to per-sample accumulation); only filter state carries across chunks.

Audio math follows the reference composites' expression order so outputs
match the oracle bit-tightly.
"""

from typing import Dict, List

import numpy as np

import jax.numpy as jnp

from ..core.curves import PaintCurve
from ..core.timeline import SubvoiceTimeline, active_from
from ..core import twelve_tet
from ..ops import control, filters, fm, oscillators
from ..ops.segprog import SegProgram, eval_chunk
from .params import ParamSpec

F32 = np.float32


def default_freq(p):
    """Default note-frequency accessor (params["freq"], f32)."""
    return F32(p["freq"])


def _plan_envelope(timelines, sample_rate, env_const, prog):
    segs = [
        control.compile_envelope(
            tl, sample_rate,
            lambda k, p: {**env_const, "note_on": bool(p["note_on"])},
        )
        for tl in timelines
    ]
    prog["env"] = control.painter_program(segs, timelines[0].total)
    return prog


def _active(prog, ctx):
    return ctx.t_idx[None, :] >= jnp.asarray(prog["active_from"])[:, None]


def _env(prog, ctx):
    return control.eval_painter(eval_chunk(prog["env"], ctx.t_idx), ctx.t_idx)


def _phase(prog, ctx):
    return oscillators.phase_from_chunk(eval_chunk(prog["phase"], ctx.t_idx), ctx.t_idx)


def _live_env_kit(polyphony, sample_rate, freq_fn, env_const,
                  guard_div8=False, extra_fns=None, static=None):
    """LivePlanKit matching the {phase, active_from, env} plan structure
    (host/liveplan.py): O(1) host work per event instead of a full re-plan."""
    from . import liveplan as lp

    def env_fn(k, p, _c=env_const):
        return {**_c, "note_on": bool(p["note_on"])}

    return lp.LivePlanKit(
        {
            "phase": lp.IncPhase(polyphony, sample_rate, freq_fn,
                                 guard_div8=guard_div8, extra_fns=extra_fns),
            "active_from": lp.IncActiveFrom(polyphony),
            "env": lp.IncEnvelope(polyphony, sample_rate, env_fn),
        },
        static=static,
    )


class PMOscInstrument:
    """Two-operator phase-mod instrument + ADSR (examples/modules.zig:80-128).

    Modulator and carrier run at the same note frequency (ratio=1,
    multiplier=1 — examples/modules.zig:110-115), so they share one phase
    counter: carrier = sin(t + sin(t)).
    """

    def __init__(self, release_duration: float, freq_fn=None) -> None:
        self.release_duration = release_duration
        self.freq_fn = freq_fn or default_freq

    def _env_const(self):
        return {
            "attack": PaintCurve.cubed(0.025),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(self.release_duration),
            "sustain_volume": 0.5,
        }

    def plan(self, timelines: List[SubvoiceTimeline], sample_rate: float):
        prog = {
            "phase": oscillators.plan_phase_segments(timelines, self.freq_fn, sample_rate),
            "active_from": active_from(timelines),
        }
        return _plan_envelope(timelines, sample_rate, self._env_const(), prog)

    def live_planner(self, polyphony: int, sample_rate: float):
        return _live_env_kit(polyphony, sample_rate, self.freq_fn,
                             self._env_const())

    def init_state(self, num_voices: int):
        return ()

    def render(self, state, prog, ctx):
        cnt, _, _ = _phase(prog, ctx)
        mod = oscillators.sine_wave(cnt, 0.0)
        car = oscillators.sine_wave(cnt, mod)
        env = _env(prog, ctx)  # 0 outside notes -> masks junk phase
        return state, car * env


class NiceInstrument:
    """Pulse -> lowpass -> ADSR (examples/modules.zig:189-248).

    color may be a scalar or a per-voice [V] array — per-voice colors let
    several same-topology parts (e.g. the song's two organs) merge into one
    part, halving kernel invocations per chunk."""

    def __init__(self, color, freq_fn=None) -> None:
        self.color = color
        self.freq_fn = freq_fn or default_freq

    def plan(self, timelines, sample_rate):
        phase = oscillators.plan_phase_segments(
            timelines, self.freq_fn, sample_rate, guard_div8=True
        )

        # per-note cutoff = cutoffFromFrequency(freq * 8, sr), f32 on host;
        # vectorized over segments (scalar np math per segment dominated
        # plan() time at high voice counts)
        f = F32
        cut = np.zeros_like(phase.values["valid"])
        for v, tl in enumerate(timelines):
            k = len(tl.starts)
            if k:
                freqs = tl.param_f32(self.freq_fn)
                x = f(2.0) * (f(1.0) - np.cos(
                    f(np.pi) * (freqs * f(8.0)) / f(sample_rate), dtype=F32))
                cut[v, :k] = np.sqrt(np.clip(x, f(0.0), f(1.0)), dtype=F32)
                cut[v, k:] = cut[v, k - 1]
        phase.values["cut"] = cut

        prog = {"phase": phase, "active_from": active_from(timelines)}
        return _plan_envelope(timelines, sample_rate, self._env_const(), prog)

    def _env_const(self):
        return {
            "attack": PaintCurve.cubed(0.01),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(0.5),
            "sustain_volume": 0.8,
        }

    def live_planner(self, polyphony: int, sample_rate: float):
        f = F32

        def cut_fn(p):  # scalar twin of plan()'s vectorized cutoff math
            fr = f(self.freq_fn(p))
            x = f(2.0) * (f(1.0) - np.cos(f(np.pi) * (fr * f(8.0)) / f(sample_rate)))
            return np.sqrt(np.clip(x, f(0.0), f(1.0)))

        return _live_env_kit(polyphony, sample_rate, self.freq_fn,
                             self._env_const(), guard_div8=True,
                             extra_fns={"cut": cut_fn})

    def init_state(self, num_voices: int):
        return {
            "l": jnp.zeros((num_voices,), jnp.float32),
            "b": jnp.zeros((num_voices,), jnp.float32),
        }

    def render(self, state, prog, ctx):
        act = _active(prog, ctx)
        phase = prog["phase"]
        # tiled chunk format: the filter evaluates the piecewise cutoff
        # from its boundary tables (ops.filters.svf_filter_table)
        table = isinstance(phase, dict) and "tb" in phase
        if table:
            vals = eval_chunk(
                {k: v for k, v in phase.items() if k != "cut"}, ctx.t_idx)
        else:
            vals = eval_chunk(phase, ctx.t_idx)
        cnt, ifreq, valid = oscillators.phase_from_chunk(vals, ctx.t_idx)
        color = self.color
        if np.ndim(color) == 1:  # per-voice -> broadcast over samples
            color = jnp.asarray(color, jnp.float32)[:, None]
        osc = oscillators.pulse_wave(cnt, ifreq, color, valid & act)
        osc = osc * jnp.float32(0.5)
        if table:
            l, b, filtered = filters.svf_filter_table(
                state["l"], state["b"], osc, "low_pass",
                phase["tb"], phase["cut"], 0.7, ctx.t_idx[0],
                jnp.asarray(prog["active_from"]),
            )
        else:
            l, b, filtered = filters.svf_filter(
                state["l"], state["b"], osc, "low_pass", vals["cut"], 0.7, act
            )
        env = _env(prog, ctx)
        return {"l": l, "b": b}, env * filtered


class HardSquareInstrument:
    """Pulse gated hard on/off (examples/modules.zig:250-289)."""

    def __init__(self, freq_fn=None) -> None:
        self.freq_fn = freq_fn or default_freq

    def plan(self, timelines, sample_rate):
        gate_segs = [control.compile_gate(tl) for tl in timelines]
        return {
            "phase": oscillators.plan_phase_segments(
                timelines, self.freq_fn, sample_rate, guard_div8=True
            ),
            "active_from": active_from(timelines),
            "gate": control.painter_program(gate_segs, timelines[0].total),
        }

    def live_planner(self, polyphony: int, sample_rate: float):
        from . import liveplan as lp

        return lp.LivePlanKit({
            "phase": lp.IncPhase(polyphony, sample_rate, self.freq_fn,
                                 guard_div8=True),
            "active_from": lp.IncActiveFrom(polyphony),
            "gate": lp.IncGate(polyphony),
        })

    def init_state(self, num_voices: int):
        return ()

    def render(self, state, prog, ctx):
        act = _active(prog, ctx)
        cnt, ifreq, valid = _phase(prog, ctx)
        osc = oscillators.pulse_wave(cnt, ifreq, 0.5, valid & act)
        gate = control.eval_painter(eval_chunk(prog["gate"], ctx.t_idx), ctx.t_idx)
        return state, osc * gate


class FilteredSawtoothInstrument:
    """TriSaw*1.5 -> ADSR multiply -> lowpass (examples/modules.zig:130-187)."""

    def __init__(self, freq_fn=None) -> None:
        self.freq_fn = freq_fn or default_freq

    def plan(self, timelines, sample_rate):
        prog = {
            "phase": oscillators.plan_phase_segments(
                timelines, self.freq_fn, sample_rate, guard_div8=True
            ),
            "active_from": active_from(timelines),
        }
        _plan_envelope(timelines, sample_rate, self._env_const(), prog)
        prog["cutoff"] = self._cutoff(sample_rate)
        return prog

    def _env_const(self):
        return {
            "attack": PaintCurve.cubed(0.025),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(1.0),
            "sustain_volume": 0.5,
        }

    def _cutoff(self, sample_rate):
        f = F32
        return np.float32(filters.cutoff_from_frequency(
            f(f(440.0) * f(twelve_tet.c5)), f(sample_rate)
        ))

    def live_planner(self, polyphony: int, sample_rate: float):
        return _live_env_kit(polyphony, sample_rate, self.freq_fn,
                             self._env_const(), guard_div8=True,
                             static={"cutoff": self._cutoff(sample_rate)})

    def init_state(self, num_voices: int):
        return {
            "l": jnp.zeros((num_voices,), jnp.float32),
            "b": jnp.zeros((num_voices,), jnp.float32),
        }

    def render(self, state, prog, ctx):
        act = _active(prog, ctx)
        cnt, ifreq, valid = _phase(prog, ctx)
        osc = oscillators.trisaw_wave(cnt, ifreq, 0.0, valid & act)
        osc = osc * jnp.float32(1.5)
        env = _env(prog, ctx)
        pre = osc * env
        l, b, out = filters.svf_filter(
            state["l"], state["b"], pre, "low_pass",
            jnp.float32(prog["cutoff"]), 0.7, act,
        )
        return {"l": l, "b": b}, out


class SquareWithEnvelope:
    """Pulse x ADSR (examples/modules.zig:291-337).

    Dead code in the reference: no example imports it and its Params use a
    pre-PaintCurve Envelope API (plain durations), so it does not compile
    there. Implemented here against the current Envelope semantics with
    linear curves as the natural reading of bare durations. `weird` picks
    pulse color 0.3 instead of 0.5 (modules.zig:324)."""

    def __init__(self, weird: bool = False, freq_fn=None) -> None:
        self.weird = weird
        self.freq_fn = freq_fn or default_freq

    def plan(self, timelines, sample_rate):
        prog = {
            "phase": oscillators.plan_phase_segments(
                timelines, self.freq_fn, sample_rate, guard_div8=True
            ),
            "active_from": active_from(timelines),
        }
        env_const = {
            "attack": PaintCurve.linear(0.01),
            "decay": PaintCurve.linear(0.1),
            "release": PaintCurve.linear(0.5),
            "sustain_volume": 0.5,
        }
        return _plan_envelope(timelines, sample_rate, env_const, prog)

    def init_state(self, num_voices: int):
        return ()

    def render(self, state, prog, ctx):
        act = _active(prog, ctx)
        cnt, ifreq, valid = _phase(prog, ctx)
        osc = oscillators.pulse_wave(
            cnt, ifreq, 0.3 if self.weird else 0.5, valid & act
        )
        return state, osc * _env(prog, ctx)


# ---------------------------------------------------------------------------
# example_mouse (examples/example_mouse.zig): phase-mod instrument whose
# ratio/multiplier are driven by a continuous controller (the mouse) through
# Portamento glides; spacebar toggles relative/absolute modulator frequency.


class MousePMInstrument:
    """Keyboard notes + mouse-driven PM parameters (example_mouse.zig).

    Continuous controllers (LiveSession.push_controller / the offline
    `controllers` plan argument): "x" -> modulator ratio, "y" ->
    multiplier. Every move re-targets a Portamento glide (linear 0.1 s,
    note_on/prev_note_on both true — example_mouse.zig:152-190) toward
    goal = x*4 / y*2 in relative mode or x*880 Hz in absolute mode
    (example_mouse.zig:160-166). Envelope: attack .025/decay .1/release
    1.0 cubed, sustain 0.5 (example_mouse.zig:60-68).

    `mode` is the spacebar toggle (example_mouse.zig:218-224), exposed as
    a live parameter of kind "both": the render-side relative/absolute
    select rides the per-block device vector (no re-jit), while the goal
    mapping applies to subsequent controller paints host-side. Deviation
    from the reference, documented: on the full-replan path a mode flip
    remaps the whole controller history; the reference (and the
    incremental planner's committed walk) only remaps from the flip on.
    """

    def __init__(self, mode: int = 0, controllers=None) -> None:
        self.cfg = {"mode": int(mode)}
        # offline default controller stream ({name: [(frame, value)]}) for
        # plan() calls that pass none — e.g. the scripted ex_mouse config
        self._controllers = controllers

    # -- live parameter protocol (host/params.py) ---------------------------

    def param_specs(self) -> List[ParamSpec]:
        return [ParamSpec("mode", 2, self.cfg["mode"],
                          "Modulator frequency: 0 relative / 1 absolute",
                          kind="both")]

    def device_params(self, values: Dict[str, int]) -> np.ndarray:
        return np.asarray([float(values["mode"])], np.float32)

    def apply_plan_params(self, values: Dict[str, int]) -> None:
        self.cfg["mode"] = int(values.get("mode", self.cfg["mode"]))

    # -- continuous controllers ----------------------------------------------

    def controller_specs(self) -> Dict[str, float]:
        """Pointer position in [0,1]^2; centered before the first move."""
        return {"x": 0.5, "y": 0.5}

    def _ratio_params(self, p: dict) -> dict:
        v = float(p["value"])
        goal = F32(v * 4.0) if self.cfg["mode"] == 0 else F32(v * 880.0)
        return {"curve": PaintCurve.linear(0.1), "goal": goal,
                "note_on": True, "prev_note_on": True}

    def _mult_params(self, p: dict) -> dict:
        return {"curve": PaintCurve.linear(0.1),
                "goal": F32(float(p["value"]) * 2.0),
                "note_on": True, "prev_note_on": True}

    def _env_const(self):
        return {"attack": PaintCurve.cubed(0.025),
                "decay": PaintCurve.cubed(0.1),
                "release": PaintCurve.cubed(1.0),
                "sustain_volume": 0.5}

    # -- planning ------------------------------------------------------------

    def _controller_program(self, events, fn, sample_rate, total):
        st = control.PortamentoWalkStream(sample_rate,
                                          lambda k, p: fn(p))
        # stable sort by FRAME only: a bare sorted() on (frame, value)
        # tuples re-orders same-frame moves by value, but the live
        # incremental walk honors push order (last push wins) — the two
        # paths must agree bit-for-bit
        evs = sorted(events, key=lambda ev: ev[0])
        for i, (s, v) in enumerate(evs):
            e = evs[i + 1][0] if i + 1 < len(evs) else max(total, int(s) + 1)
            st.feed(int(s), int(e), True, {"value": float(v)})
        return control.painter_program([st.segs], total)

    def plan(self, timelines, sample_rate, controllers=None):
        total = timelines[0].total
        if controllers is None:
            controllers = self._controllers or {
                n: [(0, v)] for n, v in self.controller_specs().items()}
        prog = {"active_from": active_from(timelines)}
        prog["ratio"] = self._controller_program(
            controllers["x"], self._ratio_params, sample_rate, total)
        prog["mult"] = self._controller_program(
            controllers["y"], self._mult_params, sample_rate, total)
        freq = np.zeros(
            (len(timelines), max(1, max(len(t.starts) for t in timelines))),
            dtype=np.float32)
        starts = np.full_like(freq, total, dtype=np.int64)
        for v, tl in enumerate(timelines):
            k = len(tl.starts)
            if k:
                freq[v, :k] = tl.param_f32(default_freq)
                freq[v, k:] = freq[v, k - 1]
                starts[v, :k] = tl.starts
        prog["freqs"] = SegProgram(starts=starts.astype(np.int64),
                                   values={"freq": freq})
        return _plan_envelope(timelines, sample_rate, self._env_const(),
                              prog)

    def live_planner(self, polyphony: int, sample_rate: float):
        from . import liveplan as lp

        env_const = self._env_const()
        return lp.LivePlanKit(
            {
                "active_from": lp.IncActiveFrom(polyphony),
                "env": lp.IncEnvelope(
                    polyphony, sample_rate,
                    lambda k, p: {**env_const,
                                  "note_on": bool(p["note_on"])}),
                "freqs": lp.IncValues(polyphony, {"freq": default_freq}),
            },
            controllers={
                "x": {"ratio": lp.IncPortamento(
                    1, sample_rate, lambda k, p: self._ratio_params(p))},
                "y": {"mult": lp.IncPortamento(
                    1, sample_rate, lambda k, p: self._mult_params(p))},
            },
        )

    def init_state(self, num_voices: int):
        return {"mod_cnt": jnp.zeros((num_voices,), jnp.uint32),
                "car_cnt": jnp.zeros((num_voices,), jnp.uint32)}

    # -- rendering -----------------------------------------------------------

    def render(self, state, prog, ctx):
        act = _active(prog, ctx)
        ratio = control.eval_painter(
            eval_chunk(prog["ratio"], ctx.t_idx), ctx.t_idx)  # [1, n]
        mult = control.eval_painter(
            eval_chunk(prog["mult"], ctx.t_idx), ctx.t_idx)
        freq = eval_chunk(prog["freqs"], ctx.t_idx)["freq"]  # [V, n]
        if "__params__" in prog:
            mode = prog["__params__"][0]
            # relative: mod freq = note freq * ratio; absolute: ratio IS
            # the frequency (goal mapping already scaled it by 880)
            base = jnp.where(mode > jnp.float32(0.5),
                             jnp.ones_like(freq), freq)
        else:
            base = jnp.ones_like(freq) if self.cfg["mode"] else freq
        mod_cnt, mod_sig = oscillators.sine_osc(
            state["mod_cnt"], base * ratio, 0.0, ctx.sample_rate, act)
        car_cnt, car = oscillators.sine_osc(
            state["car_cnt"], freq, mod_sig * mult, ctx.sample_rate, act)
        return ({"mod_cnt": mod_cnt, "car_cnt": car_cnt},
                car * _env(prog, ctx))


# ---------------------------------------------------------------------------
# example_fmsynth (examples/example_fmsynth.zig): OPL-style 2-operator FM,
# feedback on the modulator, tremolo/vibrato LFOs, and the reference host's
# 22 live parameters (example_fmsynth.zig:375-398) exposed through the
# ParamSpec protocol (host/params.py) so a running LiveSession can change
# any of them without recompiling the device step.


def _opl_volume(v):
    """OPL volume bits -> linear gain (example_fmsynth.zig:146-156;
    decibels() here is 2^(db/6), the framework's long-standing mapping)."""
    db = 0.0
    for bit, d in ((32, -24.0), (16, -12.0), (8, -6.0), (4, -3.0),
                   (2, -1.5), (1, -0.75)):
        if v & bit:
            db += d
    return float(F32(np.exp2(F32(db / 6.0))))


def _opl_adr(v):
    """Attack/decay/release index -> seconds (example_fmsynth.zig:160-171)."""
    return float(F32(0.002 + 4.0 * (1.0 - v / 15.0) ** 3))


def _opl_sustain(v):
    """Sustain bits -> level (example_fmsynth.zig:163-169)."""
    db = 0.0
    for bit, d in ((8, -24.0), (4, -12.0), (2, -6.0), (1, -3.0)):
        if v & bit:
            db += d
    return float(F32(np.exp2(F32(db / 6.0))))


def _tremolo_amount(flag, depth):
    """Tremolo flag+depth -> modulation amount (example_fmsynth.zig:173-181;
    decibels(db) = 10^(db/20) as in the reference)."""
    if not flag:
        return 0.0
    db = -1.0 if depth == 0 else -4.8
    return float(F32(1.0 - 10.0 ** (db / 20.0)))


def _vibrato_amount(flag, depth):
    """Vibrato flag+depth -> relative frequency swing
    (example_fmsynth.zig:183-191: 2^(cents/1200) - 1)."""
    if not flag:
        return 0.0
    cents = 7.0 if depth == 0 else 14.0
    return float(F32(2.0 ** (cents / 1200.0) - 1.0))


# freq_mul index -> multiplier (example_fmsynth.zig:134-144)
_FREQ_MUL = [0.5] + [float(x) for x in range(1, 11)] + [10.0, 12.0, 12.0, 15.0, 15.0]

# modulator feedback index -> phase offset gain (example_fmsynth.zig:193-203)
_FEEDBACK = [0.0, np.pi / 16, np.pi / 8, np.pi / 4,
             np.pi / 2, np.pi, 2 * np.pi, 4 * np.pi]

# the two MainModule-level LFOs (example_fmsynth.zig:437-451)
_TREMOLO_HZ = 3.7
_VIBRATO_HZ = 6.4

# device param vector layout (render() reads prog["__params__"] by index)
_FM_DEV = ("mod_freq_mul", "mod_waveform", "mod_volume", "mod_feedback",
           "mod_tremolo", "mod_vibrato", "car_freq_mul", "car_waveform",
           "car_volume", "car_tremolo", "car_vibrato", "algorithm")


class FMSynthInstrument:
    """2-op FM with the reference example's full parameter surface.

    Constructor args are the RAW integer parameter values (the same
    encoding as the reference's Parameter list); mod_adr/car_adr pack
    (attack, decay, sustain, release). algorithm 1 = phase modulation,
    0 = additive (example_fmsynth.zig:295-311).

    Live control: param_specs() exposes all 22 parameters. The 14
    device-kind values reach render() as a per-block f32 vector (waveform/
    algorithm selects are traced jnp.where chains, feedback flows into the
    Pallas FM kernel as a runtime operand), so changes land on the next
    block without re-jit. The 8 envelope values are plan-kind: the
    incremental planners re-read self.mod/self.car when painting the open
    segment, so they also land on the next block.
    """

    def __init__(self, mod_freq_mul=2, mod_waveform=0, mod_volume=12,
                 mod_adr=(8, 8, 8, 8), mod_feedback=3, car_freq_mul=1,
                 car_waveform=0, car_volume=0, car_adr=(8, 8, 8, 8),
                 algorithm=1, mod_tremolo=0, mod_vibrato=0,
                 car_tremolo=0, car_vibrato=0,
                 tremolo_depth=1, vibrato_depth=1):
        self.cfg = dict(
            mod_freq_mul=mod_freq_mul, mod_waveform=mod_waveform,
            mod_volume=mod_volume, mod_attack=mod_adr[0],
            mod_decay=mod_adr[1], mod_sustain=mod_adr[2],
            mod_release=mod_adr[3], mod_tremolo=mod_tremolo,
            mod_vibrato=mod_vibrato, mod_feedback=mod_feedback,
            car_freq_mul=car_freq_mul, car_waveform=car_waveform,
            car_volume=car_volume, car_attack=car_adr[0],
            car_decay=car_adr[1], car_sustain=car_adr[2],
            car_release=car_adr[3], car_tremolo=car_tremolo,
            car_vibrato=car_vibrato, tremolo_depth=tremolo_depth,
            vibrato_depth=vibrato_depth, algorithm=algorithm,
        )
        self._apply_cfg()

    def _apply_cfg(self):
        c = self.cfg
        self.mod = dict(
            freq_mul=_FREQ_MUL[c["mod_freq_mul"]], waveform=c["mod_waveform"],
            volume=_opl_volume(c["mod_volume"]),
            attack=_opl_adr(c["mod_attack"]), decay=_opl_adr(c["mod_decay"]),
            sustain=_opl_sustain(c["mod_sustain"]),
            release=_opl_adr(c["mod_release"]),
            feedback=_FEEDBACK[c["mod_feedback"]],
            tremolo=_tremolo_amount(c["mod_tremolo"], c["tremolo_depth"]),
            vibrato=_vibrato_amount(c["mod_vibrato"], c["vibrato_depth"]),
        )
        self.car = dict(
            freq_mul=_FREQ_MUL[c["car_freq_mul"]], waveform=c["car_waveform"],
            volume=_opl_volume(c["car_volume"]),
            attack=_opl_adr(c["car_attack"]), decay=_opl_adr(c["car_decay"]),
            sustain=_opl_sustain(c["car_sustain"]),
            release=_opl_adr(c["car_release"]), feedback=0.0,
            tremolo=_tremolo_amount(c["car_tremolo"], c["tremolo_depth"]),
            vibrato=_vibrato_amount(c["car_vibrato"], c["vibrato_depth"]),
        )
        self.algorithm = c["algorithm"]

    # -- live parameter protocol (host/params.py) ---------------------------

    def param_specs(self) -> List[ParamSpec]:
        """The reference's 22 parameters, in its panel order
        (example_fmsynth.zig:375-398), defaults from this instance's
        constructor values."""
        c = self.cfg

        def p(name, desc, n, fav=False, kind="device"):
            return ParamSpec(name, n, c[name], desc, fav, kind)

        return [
            p("mod_freq_mul", "Modulator frequency multiplier:", 16, True),
            p("mod_waveform", "Modulator waveform:", 4),
            p("mod_volume", "Modulator volume:  ", 64, True),
            p("mod_attack", "Modulator attack:  ", 16, kind="plan"),
            p("mod_decay", "Modulator decay:   ", 16, kind="plan"),
            p("mod_sustain", "Modulator sustain: ", 16, True, kind="plan"),
            p("mod_release", "Modulator release: ", 16, kind="plan"),
            p("mod_tremolo", "Modulator tremolo: ", 2),
            p("mod_vibrato", "Modulator vibrato: ", 2),
            p("mod_feedback", "Modulator feedback:", 8, True),
            p("car_freq_mul", "Carrier frequency multiplier:", 16, True),
            p("car_waveform", "Carrier waveform:", 4),
            p("car_volume", "Carrier volume:  ", 64, True),
            p("car_attack", "Carrier attack:  ", 16, kind="plan"),
            p("car_decay", "Carrier decay:   ", 16, kind="plan"),
            p("car_sustain", "Carrier sustain: ", 16, True, kind="plan"),
            p("car_release", "Carrier release: ", 16, kind="plan"),
            p("car_tremolo", "Carrier tremolo: ", 2),
            p("car_vibrato", "Carrier vibrato: ", 2),
            p("tremolo_depth", "Tremolo depth: ", 2),
            p("vibrato_depth", "Vibrato depth: ", 2),
            p("algorithm", "Algorithm: ", 2),
        ]

    def device_params(self, values: Dict[str, int]) -> np.ndarray:
        """Integer values -> the f32 vector render() unpacks (_FM_DEV
        layout). All index->value tables are applied here on host, so the
        traced graph only sees final floats."""
        td, vd = values["tremolo_depth"], values["vibrato_depth"]
        out = {
            "mod_freq_mul": _FREQ_MUL[values["mod_freq_mul"]],
            "mod_waveform": float(values["mod_waveform"]),
            "mod_volume": _opl_volume(values["mod_volume"]),
            "mod_feedback": _FEEDBACK[values["mod_feedback"]],
            "mod_tremolo": _tremolo_amount(values["mod_tremolo"], td),
            "mod_vibrato": _vibrato_amount(values["mod_vibrato"], vd),
            "car_freq_mul": _FREQ_MUL[values["car_freq_mul"]],
            "car_waveform": float(values["car_waveform"]),
            "car_volume": _opl_volume(values["car_volume"]),
            "car_tremolo": _tremolo_amount(values["car_tremolo"], td),
            "car_vibrato": _vibrato_amount(values["car_vibrato"], vd),
            "algorithm": float(values["algorithm"]),
        }
        return np.asarray([out[k] for k in _FM_DEV], np.float32)

    def apply_plan_params(self, values: Dict[str, int]) -> None:
        """Adopt the plan-kind values (envelope ADSR) into the config the
        planners read. Device-kind values are also mirrored so offline
        plan()/render() of this instance match the live values."""
        self.cfg.update({k: int(v) for k, v in values.items()
                         if k in self.cfg})
        self._apply_cfg()

    # -- planning ------------------------------------------------------------

    def _env(self, timelines, sample_rate, op):
        segs = [control.compile_envelope(
            tl, sample_rate,
            lambda k, p: self._env_params(op, p))
            for tl in timelines]
        return control.painter_program(segs, timelines[0].total)

    @staticmethod
    def _env_params(op, p):
        # reads `op` (self.mod / self.car) at call time: the incremental
        # planners re-invoke this when painting the open segment, which is
        # what makes plan-kind parameter changes land on the next block
        return {"attack": PaintCurve.cubed(op["attack"]),
                "decay": PaintCurve.cubed(op["decay"]),
                "release": PaintCurve.cubed(op["release"]),
                "sustain_volume": op["sustain"],
                "note_on": bool(p["note_on"])}

    def plan(self, timelines, sample_rate):
        prog = {"active_from": active_from(timelines)}
        prog["mod_env"] = self._env(timelines, sample_rate, self.mod)
        prog["car_env"] = self._env(timelines, sample_rate, self.car)
        freq = np.zeros(
            (len(timelines), max(1, max(len(t.starts) for t in timelines))),
            dtype=np.float32)
        starts = np.full_like(freq, timelines[0].total, dtype=np.int64)
        for v, tl in enumerate(timelines):
            k = len(tl.starts)
            if k:
                freq[v, :k] = tl.param_f32(lambda p: F32(p["freq"]))
                freq[v, k:] = freq[v, k - 1]
                starts[v, :k] = tl.starts
        prog["freqs"] = SegProgram(starts=starts.astype(np.int64),
                                   values={"freq": freq})
        return prog

    def live_planner(self, polyphony: int, sample_rate: float):
        from . import liveplan as lp

        return lp.LivePlanKit({
            "active_from": lp.IncActiveFrom(polyphony),
            "mod_env": lp.IncEnvelope(
                polyphony, sample_rate,
                lambda k, p: self._env_params(self.mod, p)),
            "car_env": lp.IncEnvelope(
                polyphony, sample_rate,
                lambda k, p: self._env_params(self.car, p)),
            "freqs": lp.IncValues(
                polyphony, {"freq": lambda p: F32(p["freq"])}),
        })

    def init_state(self, num_voices):
        z = lambda: jnp.zeros((num_voices,), jnp.float32)
        return {"mod_cnt": jnp.zeros((num_voices,), jnp.uint32),
                "car_cnt": jnp.zeros((num_voices,), jnp.uint32),
                "mod_fb1": z(), "mod_fb2": z()}

    # -- rendering -----------------------------------------------------------

    @staticmethod
    def _lfo(hz, ctx):
        """MainModule-level LFO, phase-continuous from session start
        (example_fmsynth.zig:437-451): closed-form u32 phase from the
        absolute frame index, the engine's standard oscillator convention."""
        from ..ops.scan import freq_to_ifreq

        ifreq = freq_to_ifreq(jnp.float32(hz), ctx.sample_rate)
        cnt = jnp.uint32(ifreq) * ctx.t_idx.astype(jnp.uint32)
        return oscillators.sine_wave(cnt, 0.0)  # [n]

    def render(self, state, prog, ctx):
        act = ctx.t_idx[None, :] >= jnp.asarray(prog["active_from"])[:, None]
        freq = eval_chunk(prog["freqs"], ctx.t_idx)["freq"]
        live = "__params__" in prog
        if live:
            pv = prog["__params__"]  # f32 [12], _FM_DEV layout
            P = {name: pv[i] for i, name in enumerate(_FM_DEV)}
        else:
            P = None

        need_lfo = live or any(
            op["tremolo"] != 0.0 or op["vibrato"] != 0.0
            for op in (self.mod, self.car))
        if need_lfo:
            trem_lfo = self._lfo(_TREMOLO_HZ, ctx)[None, :]
            vib_lfo = self._lfo(_VIBRATO_HZ, ctx)[None, :]

        def op_freq(base, freq_mul, vibrato):
            f = base * freq_mul
            if live:
                return f * (vib_lfo * vibrato + jnp.float32(1.0))
            if float(vibrato) != 0.0:
                f = f * (vib_lfo * jnp.float32(vibrato) + jnp.float32(1.0))
            return f

        def op_gain(sig, volume, tremolo):
            sig = sig * volume
            if live:
                return sig * (trem_lfo * tremolo + jnp.float32(1.0))
            if float(tremolo) != 0.0:
                sig = sig * (trem_lfo * jnp.float32(tremolo) + jnp.float32(1.0))
            return sig

        # modulator
        if live:
            m_fm, m_wave, m_vol = P["mod_freq_mul"], P["mod_waveform"], P["mod_volume"]
            m_fb, m_trem, m_vib = P["mod_feedback"], P["mod_tremolo"], P["mod_vibrato"]
        else:
            m_fm = jnp.float32(self.mod["freq_mul"])
            m_wave, m_vol = self.mod["waveform"], jnp.float32(self.mod["volume"])
            m_fb, m_trem, m_vib = self.mod["feedback"], self.mod["tremolo"], self.mod["vibrato"]
        mod_cnt, (fb1, fb2), mod_out = fm.fm_osc(
            state["mod_cnt"], op_freq(freq, m_fm, m_vib), 0.0,
            m_wave, m_fb,
            (state["mod_fb1"], state["mod_fb2"]), ctx.sample_rate, act)
        mod_env = control.eval_painter(
            eval_chunk(prog["mod_env"], ctx.t_idx), ctx.t_idx)
        mod_sig = op_gain(mod_out, m_vol, m_trem) * mod_env

        # carrier (feedback is always 0 in the reference,
        # example_fmsynth.zig:345)
        if live:
            c_fm, c_wave, c_vol = P["car_freq_mul"], P["car_waveform"], P["car_volume"]
            c_trem, c_vib, algo = P["car_tremolo"], P["car_vibrato"], P["algorithm"]
            car_phase = mod_sig * algo  # algorithm 1 = phase modulation
        else:
            c_fm = jnp.float32(self.car["freq_mul"])
            c_wave, c_vol = self.car["waveform"], jnp.float32(self.car["volume"])
            c_trem, c_vib = self.car["tremolo"], self.car["vibrato"]
            car_phase = mod_sig if self.algorithm == 1 else 0.0
        car_cnt, _, car_out = fm.fm_osc(
            state["car_cnt"], op_freq(freq, c_fm, c_vib), car_phase,
            c_wave, 0.0,
            (jnp.zeros_like(fb1), jnp.zeros_like(fb2)), ctx.sample_rate, act)
        car_env = control.eval_painter(
            eval_chunk(prog["car_env"], ctx.t_idx), ctx.t_idx)
        out = op_gain(car_out, c_vol, c_trem) * car_env
        if live:
            # algorithm 0 = additive: the (already enveloped) modulator
            # signal adds into the output (example_fmsynth.zig:299-303)
            out = out + mod_sig * (jnp.float32(1.0) - algo)
        elif self.algorithm == 0:
            out = out + mod_sig
        return {"mod_cnt": mod_cnt, "car_cnt": car_cnt,
                "mod_fb1": fb1, "mod_fb2": fb2}, out
