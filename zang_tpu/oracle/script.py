"""Oracle interpreter for compiled zangscript bytecode.

Executes ``CodeGenModuleResult`` instructions with the reference runtime's
sequential paint semantics — the script analog of ``oracle/engine.py``.
Semantics sources:

- src/zangscript/runtime.zig:445-721 (instruction dispatch, value
  resolution, delay loop);
- src/zangscript/codegen_zig.zig:87-460 for the parts the runtime left
  unimplemented or buggy: output-index dests accumulate while temp dests
  assign (codegen_zig.zig:124-166; runtime.zig:443 FIXME), and the
  track_call protocol (codegen_zig.zig:363-394: reset tracker/trigger on
  (note_on and) note_id_changed, consume at sample_rate/speed, trigger
  splits the span, inner note_id_changed = outer reset or inner change).

Like the engine (script/jax_backend.py), and unlike the reference runtime,
delay lines honor the declared ``num_samples`` (the reference hardcodes
Delay(11025), runtime.zig:292) and a track_call's unpainted gaps read as
silence in a temp dest.

This is the golden twin of the JAX script backend: any script the device
engine can render renders through this interpreter for parity testing
(tests/test_examples_golden.py, tests/test_script_fuzz.py).
"""

from typing import Dict, List, Optional

import numpy as np

from ..core.curves import CurveNode, PaintCurve
from ..core.notes import NoteTracker
from ..core.span import Span
from ..core.trigger import Trigger
from ..script.codegen import ExprResult, Instr
from . import engine as oracle_engine
from . import modules as m

F32 = np.float32

_BUILTIN_CLASSES = {
    "Curve": m.Curve,
    "Cycle": m.Cycle,
    "Decimator": m.Decimator,
    "Distortion": m.Distortion,
    "Envelope": m.Envelope,
    "Filter": m.Filter,
    "Gate": m.Gate,
    "Noise": m.Noise,
    "Portamento": m.Portamento,
    "PulseOsc": m.PulseOsc,
    "SineOsc": m.SineOsc,
    "TriSawOsc": m.TriSawOsc,
}

_PAINT_CURVE_LABELS = {"instantaneous", "linear", "squared", "cubed"}


def _paint_curve(label: str, payload: Optional[float]) -> PaintCurve:
    if label == "instantaneous":
        return PaintCurve.instantaneous()
    return PaintCurve(label, float(payload))


def _enum_to_param(enum_name: str, label: str, payload: Optional[float]):
    """Enum (label, payload) -> the oracle modules' param convention."""
    if enum_name == "PaintCurve":
        return _paint_curve(label, payload)
    return label  # FilterType/DistortionType/NoiseColor/InterpolationFunction


class NoiseTapeFactory:
    """Per-site positional tape hooks: each Noise field constructed in the
    module tree draws the NEXT hook, in construction order — matching the
    engine's per-call-site threefry streams (jax_backend exec_op "noise"
    keys each site separately). Used by the multi-site differential fuzz;
    a plain callable noise_tape still means one shared tape."""

    def __init__(self, make_fn) -> None:
        self.make_fn = make_fn  # site ordinal -> tape_span_fn
        self.count = 0

    def next_fn(self):
        fn = self.make_fn(self.count)
        self.count += 1
        return fn


class OracleScriptModule:
    """A compiled script module as an oracle paint-protocol module.

    ``params`` for :meth:`paint` is a dict keyed by the module's declared
    param names; values follow oracle/modules.py conventions (float or
    full-length f32 array for cob, bool, PaintCurve / label string for
    enums, list[CurveNode] for curves).
    """

    def __init__(self, compiled, module_index: int, mode: str = "parity",
                 noise_tape=None) -> None:
        self.c = compiled
        self.module_index = module_index
        self.mode = mode
        # noise_tape(span, n): positional white-noise tape hook threaded to
        # every Noise field in this module tree (differential fuzz injects
        # the engine's threefry tape; see oracle/modules.py Noise)
        self.noise_tape = noise_tape
        self.mr = compiled.codegen_result.module_results[module_index]
        self.module = compiled.modules[module_index]
        self.num_outputs = self.mr.num_outputs
        self.num_temps = self.mr.num_temps
        self.param_names = [p.name for p in self.module.params]

        self.fields = []
        for f in self.mr.fields:
            sub = compiled.modules[f.module_index]
            subr = compiled.codegen_result.module_results[f.module_index]
            if subr.is_builtin:
                cls = _BUILTIN_CLASSES.get(sub.builtin_name)
                if cls is None:
                    raise NotImplementedError(
                        f"oracle interpreter has no builtin "
                        f"{sub.builtin_name!r} (user-registered builtins "
                        "render only through the JAX backend)")
                if cls is m.Noise and noise_tape is not None:
                    fn = (noise_tape.next_fn()
                          if isinstance(noise_tape, NoiseTapeFactory)
                          else noise_tape)
                    self.fields.append(cls(mode, tape_span_fn=fn))
                else:
                    self.fields.append(cls(mode))
            else:
                self.fields.append(OracleScriptModule(
                    compiled, f.module_index, mode, noise_tape=noise_tape))
        self.delays = [m.Delay(n) for n in self.mr.delays]
        # track_call sites: tracker per note_tracker_index, trigger per
        # trigger_index (codegen allocates them pairwise)
        from ..script.jax_backend import track_note_events

        self.trackers = []
        for ti in self.mr.note_trackers:
            song = track_note_events(
                compiled.tracks[ti],
                compiled.codegen_result.track_results[ti].note_values)
            self.trackers.append(NoteTracker(song))
        self.triggers = [Trigger() for _ in self.mr.triggers]
        self.temp_floats = [F32(0.0)] * self.mr.num_temp_floats
        self._track_ctx: Optional[dict] = None  # {"track_index", "params"}

    # -- value resolution (runtime.zig:730-825) -----------------------------

    def _track_param(self, r: ExprResult):
        assert self._track_ctx is not None
        track = self.c.tracks[r.track_index]
        name = track.params[r.param_index].name
        return self._track_ctx["params"].get(name)

    def _as_float(self, r: ExprResult, params) -> np.float32:
        if r.kind == "literal_number":
            return F32(r.literal_number.value)
        if r.kind == "temp_float":
            return self.temp_floats[r.temp.index]
        if r.kind == "self_param":
            return F32(params[self.param_names[r.index]])
        if r.kind == "track_param":
            return F32(self._track_param(r) or 0.0)
        raise AssertionError(r.kind)

    def _as_buffer(self, r: ExprResult, temps, params) -> np.ndarray:
        if r.kind == "temp_buffer":
            return temps[r.temp.index]
        if r.kind == "self_param":
            return params[self.param_names[r.index]]
        raise AssertionError(r.kind)

    def _as_cob(self, r: ExprResult, temps, params):
        if r.kind == "temp_buffer":
            return temps[r.temp.index]
        if r.kind in ("temp_float", "literal_number", "track_param"):
            return self._as_float(r, params)
        if r.kind == "self_param":
            return params[self.param_names[r.index]]
        raise AssertionError(r.kind)

    def _as_bool(self, r: ExprResult, params) -> bool:
        if r.kind == "literal_boolean":
            return bool(r.literal_boolean)
        if r.kind == "self_param":
            return bool(params[self.param_names[r.index]])
        if r.kind == "track_param":
            return bool(self._track_param(r))
        raise AssertionError(r.kind)

    def _as_curve(self, r: ExprResult, params) -> List[CurveNode]:
        if r.kind == "literal_curve":
            pts = self.c.curves[r.index].points
            return [CurveNode(value=float(F32(p.value.value)), t=float(F32(p.t.value)))
                    for p in pts]
        if r.kind == "self_param":
            return params[self.param_names[r.index]]
        raise AssertionError(r.kind)

    def _as_enum(self, r: ExprResult, enum, params):
        if r.kind == "literal_enum_value":
            payload = None
            if r.enum_payload is not None:
                payload = float(self._as_float(r.enum_payload, params))
            return _enum_to_param(enum.name, r.enum_label, payload)
        if r.kind == "self_param":
            v = params[self.param_names[r.index]]
        elif r.kind == "track_param":
            v = self._track_param(r)
        else:
            raise AssertionError(r.kind)
        # already converted, or a (label, payload) tuple / bare label from
        # note params (the engine's note-driven enum convention)
        if isinstance(v, tuple):
            return _enum_to_param(enum.name, v[0], v[1])
        if isinstance(v, str):
            return _enum_to_param(enum.name, v, None)
        return v

    def _resolve_param(self, r: ExprResult, param_type, temps, params):
        k = param_type.kind
        if k == "boolean":
            return self._as_bool(r, params)
        if k == "buffer":
            return self._as_buffer(r, temps, params)
        if k == "constant":
            return self._as_float(r, params)
        if k == "constant_or_buffer":
            return self._as_cob(r, temps, params)
        if k == "curve":
            return self._as_curve(r, params)
        if k == "one_of":
            return self._as_enum(r, param_type.enum, params)
        raise AssertionError(k)

    # -- dests (codegen_zig.zig:87-166: outputs accumulate, temps assign) ---

    @staticmethod
    def _dest(out, outputs, temps):
        if out.kind == "output_index":
            return outputs[out.index], True
        return temps[out.index], False

    # -- paint ---------------------------------------------------------------

    def paint(self, span, outputs, temps, note_id_changed, params):
        self._exec(self.mr.instructions, span, outputs, temps,
                   note_id_changed, params)

    def _exec(self, instructions, span, outputs, temps, nic, params):
        for instr in instructions:
            self._exec_one(instr, span, outputs, temps, nic, params)

    def _write(self, instr, span, outputs, temps, value):
        buf, acc = self._dest(instr.out, outputs, temps)
        sl = slice(span.start, span.end)
        if acc:
            buf[sl] += value
        else:
            buf[sl] = value

    def _exec_one(self, instr: Instr, span, outputs, temps, nic, params):
        op = instr.op
        sl = slice(span.start, span.end)
        if op == "copy_buffer":
            src = self._as_buffer(instr.in_result, temps, params)
            self._write(instr, span, outputs, temps, src[sl])
        elif op == "float_to_buffer":
            self._write(instr, span, outputs, temps,
                        self._as_float(instr.in_result, params))
        elif op == "cob_to_buffer":
            v = params[self.param_names[instr.in_self_param]]
            self._write(instr, span, outputs, temps,
                        v[sl] if isinstance(v, np.ndarray) else F32(v))
        elif op == "arith_float":
            a = self._as_float(instr.a, params)
            self.temp_floats[instr.out_float] = _float_arith1(instr.arith_op, a)
        elif op == "arith_float_float":
            a = self._as_float(instr.a, params)
            b = self._as_float(instr.b, params)
            self.temp_floats[instr.out_float] = _float_arith2(instr.arith_op, a, b)
        elif op == "arith_buffer":
            a = self._as_buffer(instr.a, temps, params)
            self._write(instr, span, outputs, temps,
                        _float_arith1(instr.arith_op, a[sl]))
        elif op == "arith_float_buffer":
            a = self._as_float(instr.a, params)
            b = self._as_buffer(instr.b, temps, params)
            self._write(instr, span, outputs, temps,
                        _float_arith2(instr.arith_op, a, b[sl]))
        elif op == "arith_buffer_float":
            a = self._as_buffer(instr.a, temps, params)
            b = self._as_float(instr.b, params)
            self._write(instr, span, outputs, temps,
                        _float_arith2(instr.arith_op, a[sl], b))
        elif op == "arith_buffer_buffer":
            a = self._as_buffer(instr.a, temps, params)
            b = self._as_buffer(instr.b, temps, params)
            self._write(instr, span, outputs, temps,
                        _float_arith2(instr.arith_op, a[sl], b[sl]))
        elif op == "call":
            self._exec_call(instr, span, outputs, temps, nic, params)
        elif op == "track_call":
            self._exec_track_call(instr, span, outputs, temps, nic, params)
        elif op == "delay":
            self._exec_delay(instr, span, outputs, temps, nic, params)
        else:
            raise AssertionError(op)

    def _exec_call(self, instr, span, outputs, temps, nic, params):
        callee = self.fields[instr.field_index]
        callee_module_index = self.mr.fields[instr.field_index].module_index
        callee_params_decl = self.c.modules[callee_module_index].params
        callee_params: Dict[str, object] = {}
        for j, arg in enumerate(instr.args):
            decl = callee_params_decl[j]
            callee_params[decl.name] = self._resolve_param(
                arg, decl.param_type, temps, params)
        callee_temps = [temps[t] for t in instr.temps]
        buf, acc = self._dest(instr.out, outputs, temps)
        if not acc:
            buf[span.start:span.end] = 0.0  # codegen_zig.zig:303-306
        callee.paint(span, [buf], callee_temps, nic, callee_params)

    def _exec_track_call(self, instr, span, outputs, temps, nic, params):
        # codegen_zig.zig:363-394
        tracker = self.trackers[instr.note_tracker_index]
        trigger = self.triggers[instr.trigger_index]
        reset = nic
        if "note_on" in params:
            reset = bool(params["note_on"]) and nic
        if reset:
            tracker.reset()
            trigger.reset()
        speed = self._as_float(instr.speed, params)
        eff_sr = F32(F32(params["sample_rate"]) / F32(speed))
        buf, acc = self._dest(instr.out, outputs, temps)
        if not acc:
            # engine contract: track gaps read as silence (jax_backend
            # exec_op "track": out masked by _track_active)
            buf[span.start:span.end] = 0.0
        iap = tracker.consume(float(eff_sr), span)
        saved = self._track_ctx
        for r in trigger.iterate(span, iap):
            new_note = reset or r.note_id_changed
            self._track_ctx = {"track_index": instr.track_index,
                               "params": r.params}
            self._exec(instr.instructions, r.span, outputs, temps,
                       new_note, params)
        self._track_ctx = saved

    def _exec_delay(self, instr, span, outputs, temps, nic, params):
        # codegen_zig.zig:396-456 (declared num_samples, like the engine)
        delay = self.delays[instr.delay_index]
        fb = temps[instr.feedback_temp_buffer_index]
        fb_out = temps[instr.feedback_out_temp_buffer_index]
        buf, acc = self._dest(instr.out, outputs, temps)
        if not acc:
            buf[span.start:span.end] = 0.0
        start, end = span.start, span.end
        while start < end:
            fb_out[start:end] = 0.0
            fb[start:end] = 0.0
            n = delay.read(fb[start:end])
            inner_span = Span(start, start + n)
            self._exec(instr.instructions, inner_span, outputs, temps,
                       nic, params)
            delay.write(fb_out[start:start + n])
            start += n


# ---------------------------------------------------------------------------
# host-side driver: the oracle twin of ScriptInstrument + render_performance


def make_root_params(compiled, module_index: int, param_map=None):
    """Note-params -> exported-module params fn, mirroring
    ScriptInstrument.root_bindings (script/jax_backend.py:192-224)."""
    module = compiled.modules[module_index]
    param_map = param_map or {}

    def make_params(sample_rate: float, p: dict) -> dict:
        out = {}
        for param in module.params:
            if param.name == "sample_rate":
                out["sample_rate"] = sample_rate
                continue
            key = param_map.get(param.name, param.name)
            pt = param.param_type.kind
            if pt == "boolean":
                out[param.name] = bool(p[key])
            elif pt in ("constant", "constant_or_buffer"):
                out[param.name] = F32(p[key])
            elif pt == "one_of":
                v = p.get(key)
                if isinstance(v, tuple):
                    out[param.name] = _enum_to_param(
                        param.param_type.enum.name, v[0], v[1])
                elif isinstance(v, str):
                    out[param.name] = _enum_to_param(
                        param.param_type.enum.name, v, None)
                else:
                    out[param.name] = v
            else:
                raise AssertionError(pt)
        return out

    return make_params


def render_script_oracle(compiled, module_name: str, song, total: int,
                         sample_rate: float, polyphony: int = 1,
                         mode: str = "parity", param_map=None,
                         block_size: int = 1024,
                         noise_tapes=None) -> np.ndarray:
    """Render a compiled script through the oracle interpreter.

    Mirrors ScriptInstrument + render_performance: a NoteTracker/
    PolyphonyDispatcher voice stack drives one OracleScriptModule per
    subvoice. Returns f32 [num_outputs, total].

    noise_tapes: optional positional uniform-[0,1) tapes (frame f reads
    tape[f]), matching the engine's chunk-keyed threefry draw so Noise
    joins differential parity (the engine generates noise positionally
    over the whole chunk; a sequential per-paint stream would misalign
    across active-span gaps). Two shapes:
      - [polyphony][>= total]: ONE tape per subvoice, shared by every
        Noise site in that voice's module tree (single-site scripts);
      - [polyphony][n_sites][>= total]: one tape per site per subvoice,
        assigned to Noise fields in construction order (multi-site
        scripts — each engine call site keys its own threefry stream).
    """
    mi = compiled.find_module(module_name)
    mr = compiled.codegen_result.module_results[mi]
    make_params = make_root_params(compiled, mi, param_map)

    if noise_tapes is None:
        make_module = lambda: OracleScriptModule(compiled, mi, mode)  # noqa: E731
    else:
        vctr = [0]
        off = [0]  # absolute frame of the current block's start
        multi_site = isinstance(noise_tapes[0], (list, tuple))

        def make_module():
            v = vctr[0]
            vctr[0] += 1

            if multi_site:
                def make_fn(ordinal, v=v):
                    def tape_span(span, n):
                        s = off[0] + span.start
                        return noise_tapes[v][ordinal][s:s + n]
                    return tape_span

                return OracleScriptModule(
                    compiled, mi, mode,
                    noise_tape=NoiseTapeFactory(make_fn))

            def tape_span(span, n, v=v):
                s = off[0] + span.start
                return noise_tapes[v][s:s + n]

            return OracleScriptModule(compiled, mi, mode,
                                      noise_tape=tape_span)

    voice = oracle_engine.Voice(song, polyphony, make_module, make_params)

    def paint(span, o, t):
        voice.paint(span, sample_rate, o, t)
        if noise_tapes is not None:
            off[0] += span.end - span.start

    return oracle_engine.render_blocks(
        paint,
        total_frames=total,
        num_outputs=mr.num_outputs,
        num_temps=mr.num_temps,
        block_size=block_size)


def _float_arith1(op: str, a):
    a = np.asarray(a, dtype=np.float32) if isinstance(a, np.ndarray) else F32(a)
    if op == "neg":
        return -a
    if op == "abs":
        return np.abs(a)
    if op == "sin":
        return np.sin(a, dtype=np.float32)
    if op == "cos":
        return np.cos(a, dtype=np.float32)
    if op == "sqrt":
        return np.sqrt(a, dtype=np.float32)
    raise AssertionError(op)


def _float_arith2(op: str, a, b):
    a = np.asarray(a, dtype=np.float32) if isinstance(a, np.ndarray) else F32(a)
    b = np.asarray(b, dtype=np.float32) if isinstance(b, np.ndarray) else F32(b)
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        return a / b
    if op == "min":
        return np.minimum(a, b)
    if op == "max":
        return np.maximum(a, b)
    if op == "pow":
        return np.power(a, b, dtype=np.float32)
    raise AssertionError(op)
