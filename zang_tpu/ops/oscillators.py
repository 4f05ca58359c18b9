"""Oscillator kernels: sine, pulse, tri/saw, cycle.

All phase accumulation is u32 fixed point (the parity contract; the
reference's PulseOsc/TriSawOsc already work this way — PulseOsc.zig:90-95).
Phase counters are order-independent modular sums, so the whole time axis is
a parallel prefix sum: no sequential loop, no drift, and bit-identical
results under any chunking.

Conventions:
- freq/speed arrive as f32 [..., n] (per-sample; the render layer expands
  note-constant params via segment gather).
- state (phase counter) is u32 [...]; returned alongside the fresh output.
- `active`: bool [..., n]; where False, the module "was never painted"
  (no phase advance, zero output) — this encodes the reference's behavior
  before the first note (Trigger yields nothing until the first impulse).
"""

from typing import Optional, Tuple, Union

import jax.numpy as jnp
import numpy as np

from .scan import exclusive_cumsum_u32, freq_to_ifreq, ftou32, utof23

Array = jnp.ndarray
# np scalars, not jnp: same (non-weak) f32 dtype in traces, but creating a
# jnp scalar at import would initialize the JAX backend before the
# caller's platform selection (JAX_PLATFORMS, jax.config) runs
PI = np.float32(3.14159265358979323846)
GAIN = np.float32(0.7)


def _advance(cnt0: Array, ifreq: Array) -> Tuple[Array, Array]:
    """Per-sample phase counters (exclusive) + end counter."""
    cnt = cnt0[..., None] + exclusive_cumsum_u32(ifreq)
    cnt_end = cnt[..., -1] + ifreq[..., -1]
    return cnt, cnt_end


# ---------------------------------------------------------------------------
# Segment-programmed phase: for note-constant frequencies the entire phase
# trajectory is known at plan time. The host precomputes, per note segment,
# the u32 increment and the exact phase counter at segment start (modular
# arithmetic, so closed-form (t - seg_start) * ifreq is bit-identical to
# per-sample accumulation). The device then needs NO cumsum and NO carried
# state — oscillators become pure gathers + elementwise math.


def plan_phase_segments(timelines, freq_fn, sample_rate: float, guard_div8: bool = False,
                        freqs_override=None):
    """Host: compile note-constant frequencies into a phase SegProgram.

    Values per segment: ifreq (u32 increment), A = cnt0 - start*ifreq (u32,
    so cnt(t) = A + t*ifreq mod 2^32 — bit-identical to per-sample
    accumulation), valid (f32 0/1). freq_fn(note_params) -> frequency.
    guard_div8 applies the pulse/trisaw validity rule (silent + no phase
    advance outside [0, sr/8] — PulseOsc.zig:82-84).
    """
    import numpy as np

    from .segprog import SegProgram

    V = len(timelines)
    total = timelines[0].total if timelines else 0
    K = max(1, max(len(tl.starts) for tl in timelines))
    starts = np.full((V, K), total, dtype=np.int64)
    ifreq = np.zeros((V, K), dtype=np.uint32)
    A = np.zeros((V, K), dtype=np.uint32)
    valid = np.zeros((V, K), dtype=np.float32)
    srbase = np.float32(np.float32(4294967296.0) / np.float32(sample_rate))
    with np.errstate(over="ignore"):
        for v, tl in enumerate(timelines):
            k = len(tl.starts)
            if k == 0:
                continue
            starts[v, :k] = tl.starts
            if freqs_override is not None:
                freqs = np.asarray(freqs_override[v, :k], dtype=np.float32)
            else:
                freqs = tl.param_f32(freq_fn)
            scaled = srbase * freqs
            mag = np.abs(scaled).astype(np.uint32)
            inc = np.where(scaled >= 0, mag, np.uint32(0) - mag)
            ok = np.ones(k, dtype=bool)
            if guard_div8:
                ok = (freqs >= 0) & (freqs <= np.float32(sample_rate) / np.float32(8.0))
                inc = np.where(ok, inc, np.uint32(0))
            valid[v, :k] = ok.astype(np.float32)
            valid[v, k:] = valid[v, k - 1]
            ifreq[v, :k] = inc
            ifreq[v, k:] = inc[-1]
            # exact u32 phase at each segment start
            ends = np.append(tl.starts[1:], total)
            lens = (ends - tl.starts).astype(np.uint32)
            c = np.uint32(0)
            for i in range(k):
                A[v, i] = np.uint32(c - np.uint32(tl.starts[i]) * inc[i])
                c = np.uint32(c + lens[i] * inc[i])
            A[v, k:] = A[v, k - 1]
    return SegProgram(starts=starts, values={"ifreq": ifreq, "A": A, "valid": valid})


def phase_from_chunk(vals: dict, t_idx: Array) -> Tuple[Array, Array, Array]:
    """Device: (cnt, ifreq, valid) per sample from pconst-evaluated phase
    program values (ifreq, A, valid)."""
    ifreq = vals["ifreq"]
    cnt = vals["A"] + t_idx.astype(jnp.uint32)[None, :] * ifreq
    return cnt, ifreq, vals["valid"] > jnp.float32(0.5)


def sine_wave(cnt: Array, phase: Union[Array, float]) -> Array:
    """out = sin((t + phase) * pi * 2), t = utof23(cnt) (SineOsc.zig:4-6)."""
    t = utof23(cnt)
    return jnp.sin((t + jnp.asarray(phase, jnp.float32)) * PI * jnp.float32(2.0))


def sine_osc(
    cnt0: Array,
    freq: Array,
    phase: Union[Array, float],
    sample_rate: float,
    active: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Sine oscillator (parity contract for src/modules/SineOsc.zig:23-87).

    General per-sample-frequency path (cumsum). For note-constant freq use
    plan_phase_segments + seg_counters + sine_wave (stateless, faster).
    """
    ifreq = freq_to_ifreq(jnp.asarray(freq, jnp.float32), sample_rate)
    if active is not None:
        ifreq = jnp.where(active, ifreq, jnp.uint32(0))
    cnt, cnt_end = _advance(cnt0, ifreq)
    out = sine_wave(cnt, phase)
    if active is not None:
        out = jnp.where(active, out, jnp.float32(0.0))
    return cnt_end, out


def pulse_osc(
    cnt0: Array,
    freq: Array,
    color: Union[Array, float],
    sample_rate: float,
    active: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Anti-aliased pulse/square (src/modules/PulseOsc.zig:77-157).

    Bit-identical to the reference for segment-constant frequency: the
    3-bit transition state machine reduces to pure functions of consecutive
    phase counters (prev bit = (cnt - ifreq) < brpt, cur bit = cnt < brpt,
    wrap bit = cnt < ifreq). Out-of-range samples (freq < 0 or > sr/8) are
    silent and do not advance phase (PulseOsc.zig:82-84,121-123).
    """
    freq = jnp.asarray(freq, jnp.float32)
    valid = (freq >= 0) & (freq <= jnp.float32(sample_rate) / jnp.float32(8.0))
    if active is not None:
        valid = valid & active
    srbase = jnp.float32(4294967296.0) / jnp.float32(sample_rate)
    ifreq = jnp.where(valid, (srbase * freq).astype(jnp.uint32), jnp.uint32(0))
    cnt, cnt_end = _advance(cnt0, ifreq)
    return cnt_end, pulse_wave(cnt, ifreq, color, valid)


def pulse_wave(cnt: Array, ifreq: Array, color: Union[Array, float],
               valid: Optional[Array] = None) -> Array:
    """Anti-aliased pulse values from phase counters (PulseOsc.zig:96-113).

    The 3-bit transition state machine reduces to per-sample pure functions:
    prev bit = (cnt - ifreq) < brpt, cur bit = cnt < brpt, wrap = cnt < ifreq.
    """
    brpt = ftou32(jnp.clip(jnp.asarray(color, jnp.float32), 0.0, 1.0))
    col = utof23(brpt)
    # gdf only matters on transition samples, where ifreq >= 1; clamp to
    # avoid inf/NaN in unselected lanes.
    gdf = GAIN / utof23(jnp.maximum(ifreq, jnp.uint32(1)))
    cc121 = gdf * jnp.float32(2.0) * (col - jnp.float32(1.0)) + GAIN
    cc212 = gdf * jnp.float32(2.0) * col - GAIN
    p = utof23(cnt)
    prev = (cnt - ifreq) < brpt
    cur = cnt < brpt
    wrapped = cnt < ifreq
    up = GAIN  # 0b011
    down = -GAIN  # 0b000
    updown = gdf * jnp.float32(2.0) * (col - p) + GAIN  # 0b010
    downup = gdf * jnp.float32(2.0) * p - GAIN  # 0b101
    v_nowrap = jnp.where(prev, jnp.where(cur, up, updown), down)
    v_wrap = jnp.where(prev, cc121, jnp.where(cur, downup, cc212))
    out = jnp.where(wrapped, v_wrap, v_nowrap)
    if valid is not None:
        out = jnp.where(valid, out, jnp.float32(0.0))
    return out


def trisaw_osc(
    cnt0: Array,
    freq: Array,
    color: Union[Array, float],
    sample_rate: float,
    active: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Anti-aliased tri/saw morph (src/modules/TriSawOsc.zig:77-118).

    Integrated-polynomial form; bit-identical to the reference's
    constant-frequency path. (For controlled frequency the reference falls
    back to a naive non-antialiased wave with a TODO — TriSawOsc.zig:127-131;
    use trisaw_naive for that parity, or this for strictly better quality.)
    """
    freq = jnp.asarray(freq, jnp.float32)
    valid = (freq >= 0) & (freq <= jnp.float32(sample_rate) / jnp.float32(8.0))
    if active is not None:
        valid = valid & active
    srbase = jnp.float32(4294967296.0) / jnp.float32(sample_rate)
    ifreq = jnp.where(valid, (srbase * freq).astype(jnp.uint32), jnp.uint32(0))
    cnt, cnt_end = _advance(cnt0, ifreq)
    return cnt_end, trisaw_wave(cnt, ifreq, color, valid)


def trisaw_wave(cnt: Array, ifreq: Array, color: Union[Array, float],
                valid: Optional[Array] = None) -> Array:
    """Anti-aliased tri/saw values from phase counters (TriSawOsc.zig:92-117)."""
    brpt = ftou32(jnp.clip(jnp.asarray(color, jnp.float32), 0.0, 1.0))
    col = utof23(brpt)
    ifreq_safe = jnp.maximum(ifreq, jnp.uint32(1))
    f = utof23(ifreq_safe)
    omf = jnp.float32(1.0) - f
    rcpf = jnp.float32(1.0) / f
    c1 = GAIN / col
    c2 = -GAIN / (jnp.float32(1.0) - col)
    p = utof23(cnt) - col
    prev = (cnt - ifreq) < brpt
    cur = cnt < brpt
    wrapped = cnt < ifreq
    up = c1 * (p + p - f)
    down = c2 * (p + p - f)
    updown = rcpf * (c2 * (p * p) - c1 * ((p - f) * (p - f)))
    downup = -rcpf * (GAIN + c2 * ((p + omf) * (p + omf)) - c1 * (p * p))
    ududu = -rcpf * (GAIN + c1 * omf * (p + p + omf))
    dudud = -rcpf * (GAIN + c2 * omf * (p + p + omf))
    v_nowrap = jnp.where(prev, jnp.where(cur, up, updown), down)
    v_wrap = jnp.where(prev, ududu, jnp.where(cur, downup, dudud))
    out = GAIN + jnp.where(wrapped, v_wrap, v_nowrap)
    if valid is not None:
        out = jnp.where(valid, out, jnp.float32(0.0))
    return out


def trisaw_naive_wave(cnt: Array, color: Union[Array, float],
                      active: Optional[Array] = None) -> Array:
    """Naive tri/saw values from u32 phase counters (TriSawOsc.zig:137-151):
    saw when color < 0.25 or > 0.75, fixed triangle otherwise (the
    reference's controlled path implements color crudely — its TODO at
    TriSawOsc.zig:127)."""
    t = utof23(cnt)
    color_f = jnp.asarray(color, jnp.float32)
    saw = t * jnp.float32(2.0) - jnp.float32(1.0)
    tri = jnp.where(
        t < 0.25,
        t * jnp.float32(4.0),
        jnp.where(
            t < 0.75,
            jnp.float32(1.0) - (t - jnp.float32(0.25)) * jnp.float32(4.0),
            (t - jnp.float32(0.75)) * jnp.float32(4.0) - jnp.float32(1.0),
        ),
    )
    frac = jnp.where((color_f < 0.25) | (color_f > 0.75), saw, tri)
    out = GAIN * frac
    if active is not None:
        out = jnp.where(active, out, jnp.float32(0.0))
    return out


def trisaw_naive(
    cnt0: Array,
    freq: Array,
    color: Union[Array, float],
    sample_rate: float,
    active: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Naive tri/saw on a u32 phase — parity twin of the reference's
    controlled-frequency fallback (TriSawOsc.zig:120-156)."""
    ifreq = freq_to_ifreq(jnp.asarray(freq, jnp.float32), sample_rate)
    if active is not None:
        ifreq = jnp.where(active, ifreq, jnp.uint32(0))
    cnt, cnt_end = _advance(cnt0, ifreq)
    return cnt_end, trisaw_naive_wave(cnt, color, active)


def cycle(
    cnt0: Array,
    speed: Array,
    sample_rate: float,
    active: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Phasor 0->~1 wrapping (src/modules/Cycle.zig), u32 parity form."""
    ifreq = freq_to_ifreq(jnp.asarray(speed, jnp.float32), sample_rate)
    if active is not None:
        ifreq = jnp.where(active, ifreq, jnp.uint32(0))
    cnt, cnt_end = _advance(cnt0, ifreq)
    out = utof23(cnt)
    if active is not None:
        out = jnp.where(active, out, jnp.float32(0.0))
    return cnt_end, out
