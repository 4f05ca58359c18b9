"""Pallas (Triton) kernel for the FM feedback oscillator.

The feedback path of examples/example_fmsynth.zig:70-88 is a nonlinear
per-sample recurrence (the output feeds back through sin), so no scan can
parallelize its time axis. A lax.scan runs it as one device loop step per
sample. This kernel keeps the whole loop inside one program instead:
voices run across threads (VOICE_TILE per program, carries in registers)
and each thread walks its voice's samples in a fori_loop, loading and
storing K_TILE samples at a time (ops/pallas_svf.py's tile helpers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

from . import backend
from .fm import _shape_wave
from .pallas_svf import K_TILE, join_columns, tile_columns

VOICE_TILE = 32  # one warp per program: the loop is latency-bound, so
# spreading voices over more SMs beats packing them into fewer


def _fm_kernel(base_ref, fb_ref, wave_ref, fb0_ref, out_ref):
    """base_ref/out_ref [C, n]; fb_ref/wave_ref [C]; fb0_ref [2, C]."""
    feedback = fb_ref[:]
    waveform = wave_ref[:]

    def body(i, fbs):
        fb1, fb2 = fbs
        outs = []
        for base in tile_columns(base_ref, i * K_TILE):
            fb1, fb2 = _shape_wave(base + (fb1 + fb2) * feedback,
                                   waveform), fb1
            outs.append(fb1)
        out_ref[:, pl.ds(i * K_TILE, K_TILE)] = join_columns(outs)
        return fb1, fb2

    jax.lax.fori_loop(0, base_ref.shape[1] // K_TILE, body,
                      (fb0_ref[0, :], fb0_ref[1, :]))


@functools.partial(jax.jit, static_argnames=("interpret",))
def _fm_voices(base, feedback, waveform, fb0, interpret=False):
    Vp, n = base.shape
    rows = pl.BlockSpec((VOICE_TILE, n), lambda i: (i, 0))
    return pl.pallas_call(
        _fm_kernel,
        grid=(Vp // VOICE_TILE,),
        in_specs=[rows,
                  pl.BlockSpec((VOICE_TILE,), lambda i: (i,)),
                  pl.BlockSpec((VOICE_TILE,), lambda i: (i,)),
                  pl.BlockSpec((2, VOICE_TILE), lambda i: (0, i))],
        out_specs=rows,
        out_shape=jax.ShapeDtypeStruct((Vp, n), jnp.float32),
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(num_warps=1,
                                                    num_stages=1),
        interpret=interpret,
        name="fm_feedback",
    )(base, feedback, waveform, fb0)


def _fm_local(base, feedback, waveform, fb1, fb2, *, interpret):
    """Pad voices to VOICE_TILE and samples to K_TILE, run, and crop:
    padded samples come after the last real one, so they change nothing."""
    V, n = base.shape
    Vp = -(-V // VOICE_TILE) * VOICE_TILE
    pad = lambda a: jnp.pad(a, [(0, Vp - V)] + [(0, 0)] * (a.ndim - 1))
    base = jnp.pad(base, ((0, Vp - V), (0, -n % K_TILE)))
    out = _fm_voices(base, pad(feedback), pad(waveform),
                     jnp.stack([pad(fb1), pad(fb2)]), interpret=interpret)
    return out[:V, :n]


def fm_feedback_pallas(base, feedback, waveform, fb1, fb2, interpret=False):
    """Feedback FM over base angles [..., n]. feedback/waveform: scalars or
    [...] (static or traced); fb1/fb2: [...] the previous two outputs.
    Returns (out [..., n], new_fb1, new_fb2)."""
    lead, n = base.shape[:-1], base.shape[-1]
    V = int(np.prod(lead, dtype=np.int64))

    def per_voice(a, dtype):  # scalar, [...] or [..., 1] -> [V]
        a = jnp.asarray(a, dtype)
        if a.ndim > len(lead):
            a = a[..., 0]
        return jnp.broadcast_to(a, lead).reshape(V)

    out = backend.voice_parallel(
        functools.partial(_fm_local, interpret=interpret),
        (jnp.asarray(base, jnp.float32).reshape(V, n),
         per_voice(feedback, jnp.float32), per_voice(waveform, jnp.int32),
         per_voice(fb1, jnp.float32), per_voice(fb2, jnp.float32)))
    out = out.reshape(base.shape)
    new_fb2 = out[..., -2] if n >= 2 else jnp.asarray(fb1, jnp.float32)
    return out, out[..., -1], new_fb2
