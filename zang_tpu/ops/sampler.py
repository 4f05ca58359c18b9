"""Sampler: WAV playback with resampling and looping (src/modules/Sampler.zig).

Host side decodes the raw PCM once into a float32 table (same per-format
conversion rules as the reference's getSample: u8 -> (x-127.5)/127.5,
s16/s24/s32 -> x / 2^(bits-1)) and compiles the playback-position state
machine into a span-granular segment program: the sampler's `t` advances
per paint call (per span) with f32 closed-form arithmetic and wraps at the
*byte* length when looping (the reference's quirk, Sampler.zig:132-134), so
per-span start positions are fully precomputable. The device then evaluates
positions t_i = t0_span + i*ratio and gathers two taps with the reference's
inverted interpolation weights (Sampler.zig:119-125).
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

import jax.numpy as jnp

from ..core.timeline import SubvoiceTimeline
from ..core.wav import WavData
from .segprog import SegProgram

F32 = np.float32


@dataclass
class SampleTable:
    """Decoded sample: one channel, float32, plus the reference's metadata."""

    data_f32: np.ndarray  # [num_samples]
    num_samples: int
    byte_len: int  # raw data byte length (loop-wrap uses this, quirk)
    sample_rate: float


def decode_wav_channel(w: WavData, channel: int) -> SampleTable:
    raw = np.frombuffer(w.data, dtype=np.uint8)
    bits = w.bits_per_sample
    ch = w.num_channels
    if channel >= ch:
        data = np.zeros(0, dtype=np.float32)
    elif bits == 8:
        data = (raw.astype(np.float32) - F32(127.5)) / F32(127.5)
        data = data[channel::ch]
    elif bits == 16:
        v = np.frombuffer(w.data, dtype="<i2")[channel::ch]
        data = v.astype(np.float32) / F32(32768.0)
    elif bits == 24:
        b = raw.reshape(-1, 3)
        v = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        v = np.where(v >= 1 << 23, v - (1 << 24), v)[channel::ch]
        data = v.astype(np.float32) / F32(8388608.0)
    elif bits == 32:
        v = np.frombuffer(w.data, dtype="<i4")[channel::ch]
        data = v.astype(np.float32) / F32(2147483648.0)
    else:
        raise ValueError(f"unsupported bits {bits}")
    return SampleTable(
        data_f32=np.ascontiguousarray(data),
        num_samples=len(data),
        byte_len=len(w.data),
        sample_rate=float(w.sample_rate),
    )


def plan_sampler(
    tl: SubvoiceTimeline,
    sample: SampleTable,
    sample_rate: float,
    loop: bool,
    block_size: int = 1024,
) -> SegProgram:
    """Compile one subvoice's playback positions into a segment program.

    Values per span segment: t0 (f32 position at span start), mode
    (0 silent, 1 resample, 2 copy fast path).
    """
    ratio = F32(F32(sample.sample_rate) / F32(sample_rate))
    fast = 0.9999 < float(ratio) < 1.0001
    backwards_no_loop = float(ratio) < 0.0 and not loop

    seg_starts: List[int] = [0]
    t0s: List[float] = [0.0]
    modes: List[int] = [0]

    t = F32(0.0)
    total = tl.total
    K = len(tl.starts)
    for k in range(K):
        s = int(tl.starts[k])
        e = int(tl.starts[k + 1]) if k + 1 < K else total
        if bool(tl.resets[k]):
            t = F32(0.0)
        # walk block-aligned spans inside the segment (paint-call granularity)
        pos = s
        while pos < e:
            span_end = min(e, (pos // block_size + 1) * block_size)
            n = span_end - pos
            if backwards_no_loop:
                seg_starts.append(pos)
                t0s.append(float(t))
                modes.append(0)
            elif fast:
                seg_starts.append(pos)
                # Zig std.math.round: half away from zero (not banker's)
                t0s.append(float(np.sign(t) * np.floor(np.abs(t) + F32(0.5))))
                modes.append(2)
                t = F32(t + F32(n))
            else:
                seg_starts.append(pos)
                t0s.append(float(t))
                modes.append(1)
                t = F32(t + F32(F32(n) * ratio))
            if t >= F32(sample.byte_len) and loop:
                t = F32(t - F32(sample.byte_len))
            pos = span_end

    starts = np.array(seg_starts, dtype=np.int64)[None, :]
    values = {
        "t0": np.array(t0s, dtype=np.float32)[None, :],
        "mode": np.array(modes, dtype=np.int32)[None, :],
        "seg_start": np.array(seg_starts, dtype=np.int32)[None, :],
    }
    return SegProgram(starts=starts, values=values)


def eval_sampler(
    vals: dict,
    t_idx: jnp.ndarray,
    table: jnp.ndarray,
    num_samples: int,
    ratio: float,
    loop: bool,
) -> jnp.ndarray:
    """Device: per-sample playback from pconst-evaluated program values.
    The taps are plain XLA gathers from the decoded table."""
    dt = (t_idx[None, :] - vals["seg_start"]).astype(jnp.float32)
    mode = vals["mode"]
    ratio_f = jnp.float32(ratio)

    # resample path (Sampler.zig:115-130): t = t0 + i*ratio, 2-tap inverted lerp
    t = vals["t0"] + dt * ratio_f
    it0 = jnp.floor(t).astype(jnp.int32)
    tfrac = (it0 + 1).astype(jnp.float32) - t
    ifast = vals["t0"].astype(jnp.int32) + dt.astype(jnp.int32)

    def tap(index: jnp.ndarray) -> jnp.ndarray:
        if loop:
            index = jnp.remainder(index, num_samples)
        ok = (index >= 0) & (index < num_samples)
        return jnp.where(ok, table[jnp.clip(index, 0, max(num_samples - 1, 0))], 0.0)

    s_re = tap(it0) * (jnp.float32(1.0) - tfrac) + tap(it0 + 1) * tfrac
    # fast copy path (Sampler.zig:105-114)
    s_fast = tap(ifast)
    return jnp.where(mode == 1, s_re, jnp.where(mode == 2, s_fast, jnp.float32(0.0)))
