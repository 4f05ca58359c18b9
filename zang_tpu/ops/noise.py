"""Noise kernels: white and pink (src/modules/Noise.zig).

White noise uses JAX's counter-based threefry PRNG (parallel, reproducible
from a key — the parallel analog of the reference's per-instance xoshiro
stream; noise has no golden-WAV comparison). Pink noise is Paul Kellett's
7-tap filter (Noise.zig:54-69): six one-pole recurrences (parallelized with
affine1_scan) plus one pure delay tap.

The reference never writes the pink filter state back (`b = self.b` instead
of `self.b = b`, Noise.zig:68), so the state restarts at zero on every paint
call. We preserve the quirk via `reset_mask` (True at positions where a new
paint call would have begun — typically block starts); pass None for the
"fixed" continuous behavior.
"""

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .scan import affine1_scan

Array = jnp.ndarray

# Kellett tap coefficients (Noise.zig:56-66)
_PINK_A = (0.99886, 0.99332, 0.96900, 0.86650, 0.55000, -0.7616)
_PINK_C = (0.0555179, 0.0750759, 0.1538520, 0.3104856, 0.5329522, -0.0168980)
_PINK_DIRECT = 0.5362
_PINK_DELAYED = 0.115926


def white_noise(key, shape) -> Array:
    """Uniform [0,1) tape -> white noise in [-1, 1) (Noise.zig:48-51)."""
    tape = jax.random.uniform(key, shape, dtype=jnp.float32)
    return tape * jnp.float32(2.0) - jnp.float32(1.0), tape


def pink_from_tape(
    tape: Array,
    b0: Optional[Array] = None,
    reset_mask: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Pink noise from a uniform [0,1) tape [..., n].

    b0: [..., 7] initial tap states (zeros by default). reset_mask [..., n]:
    True where the tap states restart at zero (the reference quirk).
    Returns (out [..., n], final tap states [..., 7]).
    """
    white = tape * jnp.float32(2.0) - jnp.float32(1.0)
    n = tape.shape[-1]
    if b0 is None:
        b0 = jnp.zeros((*tape.shape[:-1], 7), jnp.float32)
    outs = []
    finals = []
    for k in range(6):
        a = jnp.full_like(white, jnp.float32(_PINK_A[k]))
        u = white * jnp.float32(_PINK_C[k])
        if reset_mask is not None:
            a = jnp.where(reset_mask, jnp.float32(0.0), a)
            u = jnp.where(reset_mask, white * jnp.float32(_PINK_C[k]), u)
        bk = affine1_scan(a, u, b0[..., k])
        outs.append(bk)
        finals.append(bk[..., -1])
    # b6: previous sample's white * 0.115926 (applied before update)
    b6_prev = jnp.concatenate(
        [b0[..., 6:7], (white * jnp.float32(_PINK_DELAYED))[..., :-1]], axis=-1
    )
    if reset_mask is not None:
        b6_prev = jnp.where(reset_mask, jnp.float32(0.0), b6_prev)
    out = (
        outs[0] + outs[1] + outs[2] + outs[3] + outs[4] + outs[5]
        + b6_prev + white * jnp.float32(_PINK_DIRECT)
    )
    finals.append((white * jnp.float32(_PINK_DELAYED))[..., -1])
    return out, jnp.stack(finals, axis=-1)
