"""OPL-style FM oscillator with output feedback (examples/example_fmsynth.zig:26-88).

The oscillator is sin((t + phase)*2pi + (prev1 + prev2) * feedback) with four
waveform shapes — the one true per-sample *nonlinear* recurrence in the
reference (SURVEY.md §7 hard part #1): when feedback != 0 the output feeds
back through sin(), so no associative-scan trick applies.

- feedback == 0: fully parallel (phase prefix sum + elementwise shaping).
- feedback != 0: a sequential loop over samples with the (prev1, prev2)
  carry, batched over voices: the Pallas kernel of ops/pallas_fm.py on a
  GPU, a lax.scan on the CPU.
"""

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import backend
from .scan import exclusive_cumsum_u32, freq_to_ifreq, utof23

Array = jnp.ndarray
# np not jnp: a module-scope jnp scalar would initialize the backend at
# import time (see ops/oscillators.py)
PI = np.float32(3.14159265358979323846)


def _shape_wave(p: Array, waveform) -> Array:
    """waveform 0: sin, 1: half-rectified, 2: |sin|, 3: alternating |sin|
    (example_fmsynth.zig:74-79)."""
    s = jnp.sin(p)
    w = jnp.asarray(waveform)
    return jnp.where(
        w == 0, s,
        jnp.where(
            w == 1, jnp.maximum(s, 0.0),
            jnp.where(
                w == 2, jnp.abs(s),
                jnp.where(jnp.sin(p * jnp.float32(2.0)) >= 0, jnp.abs(s), 0.0),
            ),
        ),
    )


def fm_osc(
    cnt0: Array,
    freq: Array,
    phase: Union[Array, float],
    waveform,
    feedback,
    fb_state: Tuple[Array, Array],
    sample_rate: float,
    active: Optional[Array] = None,
) -> Tuple[Array, Tuple[Array, Array], Array]:
    """Returns (cnt_end, (fb1, fb2), out [..., n]).

    freq: f32 [..., n]; phase: broadcastable; waveform: int (scalar or
    [..., 1]); feedback: f32 scalar or [..., 1]; fb_state: previous two
    output samples [...].
    """
    ifreq = freq_to_ifreq(jnp.asarray(freq, jnp.float32), sample_rate)
    if active is not None:
        ifreq = jnp.where(active, ifreq, jnp.uint32(0))
    cnt = cnt0[..., None] + exclusive_cumsum_u32(ifreq)
    cnt_end = cnt[..., -1] + ifreq[..., -1]
    t = utof23(cnt)
    base = (t + jnp.asarray(phase, jnp.float32)) * PI * jnp.float32(2.0)

    fb = jnp.asarray(feedback, jnp.float32)
    fb1, fb2 = fb_state

    def no_feedback():
        out = _shape_wave(base, waveform)
        return out

    if isinstance(feedback, (int, float)) and float(feedback) == 0.0:
        out = no_feedback()
        if active is not None:
            out = jnp.where(active, out, 0.0)
        new_fb1 = out[..., -1]
        new_fb2 = out[..., -2] if out.shape[-1] >= 2 else fb1
        return cnt_end, (new_fb1, new_fb2), out

    # sequential feedback path: on a GPU the Pallas kernel keeps the
    # whole loop inside one program (voices across threads); lax.scan on
    # the CPU. waveform may be a static int OR a traced scalar (live
    # parameter control feeds it from the per-block param vector) — the
    # kernel takes it as a per-voice runtime operand either way
    if backend.use_kernel():
        from .pallas_fm import fm_feedback_pallas

        out, f1, f2 = fm_feedback_pallas(base, fb, waveform, fb1, fb2)
    else:
        out, f1, f2 = fm_feedback_scan(base, fb, waveform, fb1, fb2)
    if active is not None:
        out = jnp.where(active, out, 0.0)
    return cnt_end, (f1, f2), out


def fm_feedback_scan(base, feedback, waveform, fb1, fb2):
    """The plain XLA path of the feedback oscillator: a lax.scan over
    samples, batched over voices. base: [..., n] phase angles. Returns
    (out [..., n], new_fb1, new_fb2)."""

    def step(carry, b):
        c1, c2 = carry
        sample = _shape_wave(b + (c1 + c2) * feedback, waveform)
        return (sample, c1), sample

    (f1, f2), out_t = jax.lax.scan(step, (fb1, fb2), jnp.moveaxis(base, -1, 0))
    return jnp.moveaxis(out_t, 0, -1), f1, f2
