"""Mixdown: f32 mix buffers -> integer PCM with volume, clamping, NaN->0.

Reference: src/zang/mixdown.zig:3-86. Exact conversion rules preserved:
  signed16: v = x * vol * 32767; clamp to [-32767, 32766]; NaN -> 0;
            truncate toward zero.
  signed8:  v = x * vol * 127; clamp to [-127, 126]; NaN -> 0; truncate.

Both a NumPy implementation (host/golden path) and a jittable JAX one
(device path) are provided; they are bit-identical for f32 inputs.
"""

import numpy as np

import jax.numpy as jnp


def mixdown_s16_np(mix: np.ndarray, vol: float) -> np.ndarray:
    """f32 [..., n] -> int16 [..., n] with reference clamp/NaN/trunc rules."""
    mul = np.float32(vol) * np.float32(32767.0)
    v = mix.astype(np.float32) * mul
    out = np.trunc(v)
    out = np.where(np.isnan(v), np.float32(0.0), out)
    out = np.clip(out, -32767.0, 32766.0)
    return out.astype(np.int16)


def mixdown_s8_np(mix: np.ndarray, vol: float) -> np.ndarray:
    mul = np.float32(vol) * np.float32(127.0)
    v = mix.astype(np.float32) * mul
    out = np.trunc(v)
    out = np.where(np.isnan(v), np.float32(0.0), out)
    out = np.clip(out, -127.0, 126.0)
    return out.astype(np.int8)


def mixdown_s16(mix: jnp.ndarray, vol: float) -> jnp.ndarray:
    """JAX version of mixdown_s16_np (jit friendly, runs on device)."""
    mul = jnp.float32(vol) * jnp.float32(32767.0)
    v = mix.astype(jnp.float32) * mul
    out = jnp.trunc(v)
    out = jnp.where(jnp.isnan(v), jnp.float32(0.0), out)
    out = jnp.clip(out, -32767.0, 32766.0)
    return out.astype(jnp.int16)


def mixdown_s8(mix: jnp.ndarray, vol: float) -> jnp.ndarray:
    mul = jnp.float32(vol) * jnp.float32(127.0)
    v = mix.astype(jnp.float32) * mul
    out = jnp.trunc(v)
    out = jnp.where(jnp.isnan(v), jnp.float32(0.0), out)
    out = jnp.clip(out, -127.0, 126.0)
    return out.astype(jnp.int8)


def interleave(channels: np.ndarray) -> np.ndarray:
    """[num_channels, n] -> [n * num_channels] interleaved frames."""
    return np.ascontiguousarray(channels.T).reshape(-1)
