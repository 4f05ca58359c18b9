"""Control-rate compiler: envelopes, portamento, gates as segment programs.

The reference's Envelope/Portamento are per-sample state machines driven by a
goal-seeking Painter (src/zang/painter.zig:67-120, src/modules/Envelope.zig:38-108,
src/modules/Portamento.zig:24-48). Their control flow depends only on note
events and note-constant params — never on audio — so we compile them
host-side into segment programs where, per segment,

    value[t] = a + b * shape(min(t0 + (dt + 1) * t_step, 1)),  dt = t - start

with shape in {1 (const), t (linear), 1-(1-t)^2 (squared), 1-(1-t)^3 (cubed)}.

Stage *lengths* (segment boundaries) come from f32-exact simulation of the
painter's `t += t_step` accumulation (paint tables, float32 cumsum), so
transitions land on exactly the reference's samples. Stage *values* use the
closed form above on device — within ~1 ulp * sqrt(len) of the accumulated
sequence (measured < -100 dBFS) and fully parallel with no gathers.
"""

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, List, Tuple

import numpy as np

import jax.numpy as jnp

from ..core.curves import PaintCurve
from ..core.timeline import SubvoiceTimeline
from .segprog import SegProgram

F32 = np.float32

SHAPE_CONST, SHAPE_LINEAR, SHAPE_SQUARED, SHAPE_CUBED, SHAPE_SMOOTHSTEP = 0, 1, 2, 3, 4
_SHAPE_ID = {"linear": SHAPE_LINEAR, "squared": SHAPE_SQUARED, "cubed": SHAPE_CUBED}

# cap on a single paint table (samples); the reference's envelopes are <= a
# few seconds. Guards against absurd durations exploding host memory.
MAX_TABLE = 1 << 24


@lru_cache(maxsize=None)
def _paint_table_cached(kind: str, dur_bits: int, sr_bits: int, t0_bits: int):
    duration = np.uint32(dur_bits).view(np.float32)
    sr = np.uint32(sr_bits).view(np.float32)
    t0 = np.uint32(t0_bits).view(np.float32)
    t_step = F32(F32(1.0) / F32(duration * sr))
    # f32-exact sequential accumulation: t_k = fl(t_{k-1} + t_step), starting
    # from t0, painted while t < 1 (the crossing sample paints with t = 1).
    # generous margin: f32 accumulation can run slightly slow of the exact
    # rational count (rounding bias), so the crossing may land past the
    # nominal duration*sr step count
    est = int(np.ceil((1.0 - float(t0)) / max(float(t_step), 1e-30)) * 1.02) + 16
    if est > MAX_TABLE:
        raise ValueError(f"paint table too long ({est} samples)")
    steps = np.full(est + 1, t_step, dtype=np.float32)
    steps[0] = t0
    t = np.cumsum(steps, dtype=np.float32)[1:]  # t after each += t_step
    crossing = int(np.argmax(t >= 1.0))
    if not t[crossing] >= 1.0:
        raise ValueError("paint table estimate too short (bug)")
    t = t[: crossing + 1].copy()
    t[-1] = 1.0  # clamp (painter.zig:102-105)
    it = F32(1.0) - t
    if kind == "linear":
        tp = t
    elif kind == "squared":
        tp = F32(1.0) - it * it
    elif kind == "cubed":
        tp = F32(1.0) - it * it * it
    else:
        raise ValueError(kind)
    return np.asarray(t, dtype=np.float32), np.asarray(tp, dtype=np.float32), t_step


def paint_table(kind: str, duration: float, sample_rate: float, t0: float = 0.0):
    """(t sequence, tp sequence, t_step) for one painter stage."""
    return _paint_table_cached(
        kind,
        int(F32(duration).view(np.uint32)),
        int(F32(sample_rate).view(np.uint32)),
        int(F32(t0).view(np.uint32)),
    )


# program segment tuple: (start, a, b, t_step, t0, shape_id)
Seg = Tuple[int, float, float, float, float, int]


def painter_program(segs_per_voice, total: int) -> SegProgram:
    """Pack per-voice painter segments into a SegProgram (padded).

    Each voice's segments are either a list of Seg tuples (the Python
    walkers) or a dict of arrays {"start","a","b","t_step","t0","shape"}
    (the native compiler)."""
    def seg_len(sv):
        return len(sv["start"]) if isinstance(sv, dict) else len(sv)

    S = max(1, max(seg_len(sv) for sv in segs_per_voice))
    V = len(segs_per_voice)
    starts = np.full((V, S), total, dtype=np.int64)
    a = np.zeros((V, S), dtype=np.float32)
    b = np.zeros((V, S), dtype=np.float32)
    t_step = np.zeros((V, S), dtype=np.float32)
    t0 = np.zeros((V, S), dtype=np.float32)
    shape = np.zeros((V, S), dtype=np.int32)
    for v, segs in enumerate(segs_per_voice):
        if isinstance(segs, dict):
            k = len(segs["start"])
            starts[v, :k] = segs["start"]
            a[v, :k] = segs["a"]
            b[v, :k] = segs["b"]
            t_step[v, :k] = segs["t_step"]
            t0[v, :k] = segs["t0"]
            shape[v, :k] = segs["shape"]
        else:
            k = len(segs)
            for i, (s, av, bv, ts, tz, sh) in enumerate(segs):
                starts[v, i] = s
                a[v, i] = av
                b[v, i] = bv
                t_step[v, i] = ts
                t0[v, i] = tz
                shape[v, i] = sh
        # repeat the last segment's values into padding (zero deltas)
        if k:
            a[v, k:] = a[v, k - 1]
            b[v, k:] = b[v, k - 1]
            t_step[v, k:] = t_step[v, k - 1]
            t0[v, k:] = t0[v, k - 1]
            shape[v, k:] = shape[v, k - 1]
    return SegProgram(
        starts=starts,
        values={
            "a": a, "b": b, "t_step": t_step, "t0": t0,
            "shape": shape, "seg_start": starts.astype(np.int32),
        },
    )


def eval_painter(vals: dict, t_idx: jnp.ndarray) -> jnp.ndarray:
    """Device: painter program values -> [V, n].

    vals: the pconst-evaluated per-sample dict (a, b, t_step, t0, shape,
    seg_start), e.g. from segprog.eval_chunk.
    """
    dt = (t_idx[None, :] - vals["seg_start"]).astype(jnp.float32)
    t = jnp.minimum(vals["t0"] + (dt + jnp.float32(1.0)) * vals["t_step"], jnp.float32(1.0))
    it = jnp.float32(1.0) - t
    shape = vals["shape"]
    tp = jnp.where(
        shape == SHAPE_LINEAR,
        t,
        jnp.where(
            shape == SHAPE_SQUARED,
            jnp.float32(1.0) - it * it,
            jnp.where(
                shape == SHAPE_CUBED,
                jnp.float32(1.0) - it * it * it,
                jnp.where(
                    shape == SHAPE_SMOOTHSTEP,
                    t * t * (jnp.float32(3.0) - jnp.float32(2.0) * t),
                    jnp.float32(1.0),
                ),
            ),
        ),
    )
    return vals["a"] + vals["b"] * tp


# ---------------------------------------------------------------------------
# Painter walk: shared by the envelope and portamento compilers.


class _PainterWalk:
    """Host-side mirror of the Painter state (t position, last/start values),
    emitting program segments instead of painting samples."""

    def __init__(self, sample_rate: float) -> None:
        self.sr = sample_rate
        self.t_value = F32(0.0)  # painter.t
        self.finished = False  # painter.t >= 1.0
        self.last = F32(0.0)  # painter.last_value
        self.start = F32(0.0)  # painter.start
        self.table_pos = 0  # samples consumed of current stage table
        self.table_key = None
        self.table = None  # (t_arr, tp_arr, t_step)
        self.table_t0 = F32(0.0)
        self.segs: List[Seg] = []

    def new_curve(self) -> None:
        self.start = self.last
        self.t_value = F32(0.0)
        self.finished = False
        self.table_pos = 0
        self.table_key = None
        self.table = None

    def emit(self, seg: Seg) -> None:
        # merge consecutive constant segments with equal value
        if seg[2] == 0.0 and self.segs:
            prev = self.segs[-1]
            if prev[2] == 0.0 and prev[1] == seg[1]:
                return
        self.segs.append(seg)

    def emit_const(self, s: int, value: float) -> None:
        self.emit((s, float(F32(value)), 0.0, 0.0, 0.0, SHAPE_CONST))

    def paint_flat(self, s: int, e: int, value: float) -> None:
        if e > s:
            self.emit_const(s, value)

    def snapshot(self) -> tuple:
        """Copyable walk state (tables are immutable and shared by ref).
        Lets the live planner paint an open-ended segment provisionally and
        rewind (host/liveplan.py)."""
        return (self.t_value, self.finished, self.last, self.start,
                self.table_pos, self.table_key, self.table, self.table_t0,
                len(self.segs))

    def restore(self, snap: tuple) -> None:
        (self.t_value, self.finished, self.last, self.start,
         self.table_pos, self.table_key, self.table, self.table_t0,
         nsegs) = snap
        del self.segs[nsegs:]

    def paint_toward(self, s: int, e: int, curve: PaintCurve, goal: float) -> Tuple[int, bool]:
        """Mirror of painter.zig:67-120. Returns (pos, finished)."""
        goal = F32(goal)
        if self.finished:
            return s, True
        if curve.kind == "instantaneous":
            self.finished = True
            self.t_value = F32(1.0)
            self.last = goal
            return s, True
        key = (curve.kind, F32(curve.duration).tobytes())
        if self.table_key != key:
            # stage (re)parameterized mid-flight: continue from current t
            self.table_t0 = F32(self.t_value)
            self.table = paint_table(curve.kind, curve.duration, self.sr, float(self.t_value))
            self.table_key = key
            self.table_pos = 0
        t_arr, tp_arr, t_step = self.table
        length = len(t_arr)
        if self.table_pos >= length:
            self.finished = True
            return s, True
        n = min(length - self.table_pos, e - s)
        if n > 0:
            b = F32(goal - self.start)
            # t value before the first emitted sample of this program segment
            t_base = t_arr[self.table_pos - 1] if self.table_pos > 0 else self.table_t0
            self.emit((s, float(self.start), float(b), float(t_step),
                       float(t_base), _SHAPE_ID[curve.kind]))
            self.last = F32(self.start + F32(tp_arr[self.table_pos + n - 1] * b))
            self.t_value = F32(t_arr[self.table_pos + n - 1])
            self.table_pos += n
        if self.table_pos >= length:
            self.finished = True
            return s + n, True
        return s + n, False


# ---------------------------------------------------------------------------
# Envelope compiler (src/modules/Envelope.zig state machine).

IDLE, ATTACK, DECAY, SUSTAIN, RELEASE = range(5)


def compile_envelope(
    tl: SubvoiceTimeline,
    sample_rate: float,
    env_params_fn: Callable[[int, dict], dict],
) -> List[Seg]:
    """Compile one subvoice's envelope into program segments.

    env_params_fn(segment_index, note_params) -> dict with keys attack, decay,
    release (PaintCurve), sustain_volume (float), note_on (bool).

    Dispatches to the C++ twin (core/native.py, bit-identical segments)
    when available; ZANG_NATIVE=0 forces this Python path.
    """
    from ..core import native as _native

    if _native.available():
        return _native.compile_envelope_native(tl, sample_rate, env_params_fn)

    st = EnvelopeWalkStream(sample_rate, env_params_fn)
    for k in range(len(tl.starts)):
        s = int(tl.starts[k])
        e = int(tl.starts[k + 1]) if k + 1 < len(tl.starts) else tl.total
        st.feed(s, e, bool(tl.resets[k]), tl.params[k])
    return st.segs


class EnvelopeWalkStream:
    """Streaming form of the envelope compiler: feed one timeline segment
    [s, e) at a time; carries (ADSR state, painter walk) across calls.

    Identical segment output to compile_envelope's batch walk (it IS the
    batch walk's body) — the incremental live planner feeds segments as
    events arrive instead of re-walking the whole session."""

    def __init__(self, sample_rate: float, env_params_fn) -> None:
        self.w = _PainterWalk(sample_rate)
        self.state = IDLE
        self.fn = env_params_fn
        self.k = 0  # segment index passed through to env_params_fn
        self.w.emit_const(0, 0.0)  # idle before the first note

    @property
    def segs(self) -> List[Seg]:
        return self.w.segs

    def snapshot(self) -> tuple:
        return (self.state, self.k, self.w.snapshot())

    def restore(self, snap: tuple) -> None:
        self.state, self.k, wsnap = snap
        self.w.restore(wsnap)

    def feed(self, s: int, e: int, reset: bool, params: dict) -> None:
        k = self.k
        self.k += 1
        if e <= s:
            return
        p = self.fn(k, params)
        w = self.w

        def change(new_state):
            self.state = new_state
            w.new_curve()

        pos = s
        if p["note_on"]:
            if reset:
                change(ATTACK)
            if self.state == IDLE:
                change(ATTACK)
            if self.state == RELEASE:
                raise ValueError(
                    "note_on while in release without a new note id "
                    "(the reference asserts here — Envelope.zig:45)"
                )
            if self.state == ATTACK:
                pos, fin = w.paint_toward(pos, e, p["attack"], 1.0)
                if fin:
                    change(DECAY if p["sustain_volume"] < 1.0 else SUSTAIN)
            if self.state == DECAY:
                pos, fin = w.paint_toward(pos, e, p["decay"], p["sustain_volume"])
                if fin:
                    change(SUSTAIN)
            if self.state == SUSTAIN:
                w.paint_flat(pos, e, p["sustain_volume"])
                pos = e
        else:
            if self.state == IDLE:
                w.paint_flat(pos, e, 0.0)
            else:
                if self.state != RELEASE:
                    change(RELEASE)
                pos, fin = w.paint_toward(pos, e, p["release"], 0.0)
                if fin:
                    change(IDLE)
                w.paint_flat(pos, e, 0.0)


class PortamentoWalkStream:
    """Streaming form of the portamento compiler (one segment at a time,
    carried painter walk) — feeds the incremental live planner."""

    def __init__(self, sample_rate: float, porta_params_fn) -> None:
        self.w = _PainterWalk(sample_rate)
        self.fn = porta_params_fn
        self.k = 0
        self.w.emit_const(0, 0.0)

    @property
    def segs(self) -> List[Seg]:
        return self.w.segs

    def snapshot(self) -> tuple:
        return (self.k, self.w.snapshot())

    def restore(self, snap: tuple) -> None:
        self.k, wsnap = snap
        self.w.restore(wsnap)

    def feed(self, s: int, e: int, reset: bool, params: dict) -> None:
        k = self.k
        self.k += 1
        if e <= s:
            return
        p = self.fn(k, params)
        w = self.w
        if p["note_on"] and p.get("prev_note_on", False):
            curve = p["curve"]
        else:
            curve = PaintCurve.instantaneous()
        if p["note_on"] and reset:
            w.new_curve()
        pos, fin = w.paint_toward(s, e, curve, p["goal"])
        if fin:
            w.paint_flat(pos, e, p["goal"])


class GateWalkStream:
    """Streaming gate compiler: per-segment constant, no painter state."""

    def __init__(self, gate_fn=None) -> None:
        self.gate_fn = gate_fn or (lambda p: bool(p["note_on"]))
        self.segs: List[Seg] = [(0, 0.0, 0.0, 0.0, 0.0, SHAPE_CONST)]

    def snapshot(self) -> int:
        return len(self.segs)

    def restore(self, snap: int) -> None:
        del self.segs[snap:]

    def feed(self, s: int, e: int, reset: bool, params: dict) -> None:
        val = 1.0 if self.gate_fn(params) else 0.0
        if self.segs[-1][1] != val:
            self.segs.append((int(s), val, 0.0, 0.0, 0.0, SHAPE_CONST))


# ---------------------------------------------------------------------------
# Portamento compiler (src/modules/Portamento.zig).


def compile_portamento(
    tl: SubvoiceTimeline,
    sample_rate: float,
    porta_params_fn: Callable[[int, dict], dict],
) -> List[Seg]:
    """porta_params_fn(segment_index, note_params) -> dict with curve
    (PaintCurve), goal, note_on, prev_note_on."""
    st = PortamentoWalkStream(sample_rate, porta_params_fn)
    for k in range(len(tl.starts)):
        s = int(tl.starts[k])
        e = int(tl.starts[k + 1]) if k + 1 < len(tl.starts) else tl.total
        st.feed(s, e, bool(tl.resets[k]), tl.params[k])
    return st.segs


# ---------------------------------------------------------------------------
# Gate compiler (src/modules/Gate.zig): 1.0 while note_on else 0.


def compile_gate(tl: SubvoiceTimeline, gate_fn=None) -> List[Seg]:
    gate_fn = gate_fn or (lambda p: bool(p["note_on"]))
    segs: List[Seg] = [(0, 0.0, 0.0, 0.0, 0.0, SHAPE_CONST)]
    for k in range(len(tl.starts)):
        s = int(tl.starts[k])
        v = 1.0 if gate_fn(tl.params[k]) else 0.0
        if segs[-1][1] == v:
            continue
        segs.append((s, v, 0.0, 0.0, 0.0, SHAPE_CONST))
    return segs


# ---------------------------------------------------------------------------
# Curve compiler (src/modules/Curve.zig): interpolated curve playback.


def compile_curve(
    tl: SubvoiceTimeline,
    points,
    function: str,
    sample_rate: float,
    block_size: int = 1024,
) -> List[Seg]:
    """Compile one subvoice's Curve playback into painter segments.

    points: [(t_seconds, value)]. function: 'linear' | 'smoothstep'.
    Replicates the reference's per-block node placement (f32 clock, relative
    frames — Curve.zig:126-176) and resets on note_id_changed; interpolation
    maps onto painter segments (linear -> SHAPE_LINEAR with t = x, smoothstep
    -> SHAPE_SMOOTHSTEP), within ~1 ulp of the reference's accumulation.
    """
    st = CurveWalkStream(points, function, sample_rate, block_size)
    K = len(tl.starts)
    for k in range(K):
        s = int(tl.starts[k])
        e = int(tl.starts[k + 1]) if k + 1 < K else tl.total
        st.feed_partial(s, e, bool(tl.resets[k]))
    return st.segs


class CurveWalkStream:
    """Streaming curve compiler: the reference's per-block node walk
    (Curve.zig:126-238) with the module state (t clock + song-note cursors)
    carried, fed one timeline-segment range at a time.

    Span structure is identical to the batch walk: [first_active, ...) is
    partitioned at block boundaries and segment starts (every segment start
    is a feed boundary); before the first feed nothing advances (the batch
    walk's pre-first_active spans emit merged zeros).

    feed_partial(s, e, reset) may be called repeatedly for the SAME segment
    with a growing e — the live planner commits a held note's prefix block
    by block (advance_open) and paints the rest provisionally; `pos` tracks
    how far the segment has been consumed, and the reset applies only on
    first contact."""

    def __init__(self, points, function: str, sample_rate: float,
                 block_size: int = 1024) -> None:
        self.points = points
        self.shape_id = SHAPE_LINEAR if function == "linear" else SHAPE_SMOOTHSTEP
        self.sr = sample_rate
        self.block = block_size
        self.segs: List[Seg] = [(0, 0.0, 0.0, 0.0, 0.0, SHAPE_CONST)]
        self.t = F32(0.0)
        self.csn = 0  # current_song_note
        self.csn_off = 0  # current_song_note_offset
        self.nsn = 0  # next_song_note
        self.pos: Optional[int] = None  # processed up to (None = pre-active)

    def snapshot(self) -> tuple:
        return (len(self.segs), self.t, self.csn, self.csn_off, self.nsn,
                self.pos)

    def restore(self, snap: tuple) -> None:
        nsegs, self.t, self.csn, self.csn_off, self.nsn, self.pos = snap
        del self.segs[nsegs:]

    def _emit_const(self, s, v):
        segs = self.segs
        if not segs or segs[-1][1] != v or segs[-1][2] != 0.0:
            segs.append((s, float(v), 0.0, 0.0, 0.0, SHAPE_CONST))

    def feed_partial(self, s: int, e: int, reset: bool) -> None:
        if self.pos is None:
            self.pos = s
        start = max(self.pos, s)
        if e <= start:
            return
        if reset and start == s:
            self.t = F32(0.0)
            self.csn = 0
            self.csn_off = 0
            self.nsn = 0
        pos = start
        while pos < e:
            span_end = min(e, (pos // self.block + 1) * self.block)
            self._span(pos, span_end)
            pos = span_end
        self.pos = e

    def _span(self, s0: int, s1: int) -> None:
        points, sample_rate, segs = self.points, self.sr, self.segs
        t, current_song_note = self.t, self.csn
        current_song_note_offset, next_song_note = self.csn_off, self.nsn
        out_len_span = s1 - s0
        # getCurveSpanNodes (Curve.zig:126-176)
        nodes = []
        buf_time = F32(F32(out_len_span) / F32(sample_rate))
        end_t = F32(t + buf_time)
        if current_song_note < next_song_note:
            nodes.append((current_song_note_offset, points[current_song_note][1]))
        one_past = False
        for idx in range(next_song_note, len(points)):
            note_t = F32(points[idx][0])
            if note_t >= end_t:
                if not one_past:
                    one_past = True
                else:
                    break
            f = F32(F32(note_t - t) / buf_time)
            rel = int(F32(f * F32(out_len_span)))
            if nodes and nodes[-1][0] == rel:
                nodes.pop()
            nodes.append((rel, points[idx][1]))
            if not one_past:
                current_song_note = next_song_note
                current_song_note_offset = 0
                next_song_note += 1
        t = F32(t + buf_time)
        current_song_note_offset -= out_len_span

        # getNextCurveSpan (Curve.zig:180-238) -> painter segments
        start = 0
        while start < out_len_span:
            cs = _next_curve_span(nodes, start, out_len_span)
            cs_start, cs_end, values = cs
            if values is None:
                self._emit_const(s0 + cs_start, 0.0)
            else:
                (f0, v0), (f1, v1) = values
                start_x = F32(F32(cs_start - f0) / F32(f1 - f0))
                delta = F32(F32(v1) - F32(v0))
                x_step = F32(F32(1.0) / F32(f1 - f0))
                segs.append((
                    s0 + cs_start, float(F32(v0)), float(delta),
                    float(x_step), float(F32(start_x - x_step)), self.shape_id,
                ))
            start = cs_end
        self.t, self.csn = t, current_song_note
        self.csn_off, self.nsn = current_song_note_offset, next_song_note


def _next_curve_span(nodes, dest_start, dest_end):
    """Curve.zig:180-238."""
    for i, (start_pos, value) in enumerate(nodes):
        if start_pos >= dest_end:
            break
        end_pos = min(dest_end, nodes[i + 1][0]) if i < len(nodes) - 1 else dest_end
        if end_pos <= dest_start:
            continue
        note_start_clipped = start_pos if start_pos > dest_start else dest_start
        if note_start_clipped > dest_start:
            return dest_start, note_start_clipped, None
        note_end_clipped = min(end_pos, dest_end)
        values = (nodes[i], nodes[i + 1]) if i < len(nodes) - 1 else None
        return note_start_clipped, note_end_clipped, values
    return dest_start, dest_end, None
