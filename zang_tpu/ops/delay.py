"""Delay lines and echo effects.

The reference's Delay is a ring buffer with a two-phase chunked read/write
API whose chunk length is anything <= the delay length (src/zang/delay.zig:
28-89). That protocol is chunking-invariant: any read-n/write-n sequence
with n <= D produces identical "delay by D samples" behavior. We
exploit that freedom:

- SimpleDelay (no feedback, examples/modules.zig:341-384): a pure shift —
  fully parallel, state = last D input samples.
- FilteredEchoes (feedback through a lowpass, examples/modules.zig:388-462):
  inherently sequential at delay-length granularity; an inner lax.scan over
  sub-chunks of s <= D samples, with the ring buffer held "rolled" (read is
  always the buffer head) so no index arithmetic survives.
- StereoEchoes (examples/modules.zig:464-525): composition of the above.
"""

from typing import Tuple

import jax
import jax.numpy as jnp

from . import filters

Array = jnp.ndarray


def simple_delay(state: Array, x: Array) -> Tuple[Array, Array]:
    """Delay x by D = state.shape[-1] samples. state: last D inputs.

    Returns (new_state, out [..., n]). Works for any n.
    """
    D = state.shape[-1]
    n = x.shape[-1]
    full = jnp.concatenate([state, x], axis=-1)
    out = full[..., :n]
    new_state = full[..., n:]
    return new_state, out


def _sub_chunk(n: int, delay: int) -> int:
    """Largest divisor of n that is <= delay (feedback granularity)."""
    s = n
    while s > delay:
        if s % 2:
            raise ValueError(
                f"chunk {n} not divisible into sub-chunks <= delay {delay}"
            )
        s //= 2
    return s


def filtered_echoes(
    state: dict,
    x: Array,
    feedback_volume,
    cutoff,
    delay: int,
) -> Tuple[dict, Array]:
    """Feedback echo: out = lowpass(x + feedback_volume * delayed(out)).

    state: {"buf": [..., D], "l": [...], "b": [...]}. x: [..., n].
    Mirrors the reference loop (examples/modules.zig:420-458): read feedback,
    scale, add input, lowpass (res=0), emit, write back into the delay.
    """
    n = x.shape[-1]
    D = state["buf"].shape[-1]
    s = _sub_chunk(n, D)
    steps = n // s

    def body(carry, xs):
        buf, l, b = carry
        xi = xs
        fb = buf[..., :s]
        mixed = fb * jnp.float32(feedback_volume) + xi
        l, b, filtered = filters.svf_filter(l, b, mixed, "low_pass", cutoff, 0.0)
        buf = jnp.concatenate([buf[..., s:], filtered], axis=-1)
        return (buf, l, b), filtered

    xs = jnp.moveaxis(x.reshape(*x.shape[:-1], steps, s), -2, 0)
    (buf, l, b), outs = jax.lax.scan(body, (state["buf"], state["l"], state["b"]), xs)
    out = jnp.moveaxis(outs, 0, -2).reshape(*x.shape[:-1], n)
    return {"buf": buf, "l": l, "b": b}, out


def stereo_echoes_init(main_delay: int, lead_shape=()) -> dict:
    half = main_delay // 2
    z = lambda d: jnp.zeros((*lead_shape, d), jnp.float32)
    s = lambda: jnp.zeros(lead_shape, jnp.float32)
    return {
        "delay0": z(half),
        "delay1": z(half),
        "echo": {"buf": z(main_delay), "l": s(), "b": s()},
    }


def stereo_echoes(
    state: dict,
    x: Array,
    feedback_volume,
    cutoff,
) -> Tuple[dict, Array]:
    """Dry center + mirrored L/R filtered echoes. x: [..., n] mono.

    Returns (state, stereo [..., 2, n]).
    """
    d0, pre = simple_delay(state["delay0"], x)
    echo_state, echoed = filtered_echoes(
        state["echo"], pre, feedback_volume, cutoff, state["echo"]["buf"].shape[-1]
    )
    d1, mirrored = simple_delay(state["delay1"], echoed)
    left = x + echoed
    right = x + mirrored
    out = jnp.stack([left, right], axis=-2)
    return {"delay0": d0, "delay1": d1, "echo": echo_state}, out
