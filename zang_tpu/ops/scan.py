"""Parallel scan utilities: the device replacement for per-sample loops.

The reference carries tiny state across per-sample loops (oscillator phases,
filter l/b, envelope timers — SURVEY.md §2b). Here those recurrences become:

- u32 prefix sums (exact under any association order: modular arithmetic),
- affine scans: x_{i+1} = A_i x_i + c_i composed associatively,
  ((A2,c2)∘(A1,c1) = (A2 A1, A2 c1 + c2)).
"""

import jax
import jax.numpy as jnp


def pconst_multi(starts: jnp.ndarray, values: dict, t_idx: jnp.ndarray) -> dict:
    """Evaluate piecewise-constant segment tables at samples, gather-free.

    starts: [V, K] int32, sorted per voice; values: dict of [V, K] arrays
    (f32 / i32 / u32); t_idx: [n] int32. Returns {name: [V, n]}.

    value(t) = sum_k [t >= starts_k] * (v_k - v_{k-1})  — a masked delta sum,
    unrolled over K: elementwise work with no gather or searchsorted.
    Segments must satisfy starts[:, 0] <= t_idx[0] wherever the value
    matters; padding entries need start > t_idx[-1] or zero delta.
    """
    K = starts.shape[-1]
    out = {}
    deltas = {}
    for name, v in values.items():
        deltas[name] = jnp.concatenate([v[:, :1], v[:, 1:] - v[:, :-1]], axis=1)
        out[name] = jnp.zeros((starts.shape[0], t_idx.shape[0]), dtype=v.dtype)
    for k in range(K):
        mask = t_idx[None, :] >= starts[:, k : k + 1]
        for name in values:
            d = deltas[name][:, k : k + 1]
            out[name] = out[name] + jnp.where(mask, d, jnp.zeros_like(d))
    return out


def exclusive_cumsum_u32(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Exclusive prefix sum in uint32 (wrapping, order-independent)."""
    inc = jnp.cumsum(x, axis=axis, dtype=jnp.uint32)
    return inc - x  # wrap-safe: inclusive minus element = exclusive


def utof23(cnt: jnp.ndarray) -> jnp.ndarray:
    """u32 phase -> float in [0,1) with 23-bit precision.

    The reference's bit trick (PulseOsc.zig:19-21): stuff the top 23 bits
    into a float mantissa with exponent 0 and subtract 1.
    """
    bits = (cnt >> jnp.uint32(9)) | jnp.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(bits, jnp.float32) - jnp.float32(1.0)


def ftou32(v: jnp.ndarray) -> jnp.ndarray:
    """float [0,1) -> 0.32 unsigned fixed point (PulseOsc.zig:23-25)."""
    return ((v * jnp.float32(4294967296.0)) * jnp.float32(0.99995)).astype(jnp.uint32)


def freq_to_ifreq(freq: jnp.ndarray, sample_rate: float) -> jnp.ndarray:
    """Frequency (Hz, f32, may be negative) -> u32 phase increment.

    ifreq = u32(f32(2^32 / sr) * freq); negatives map to two's complement
    (backward phase motion), matching the oracle's (u32)(i64) conversion.
    """
    srbase = jnp.float32(4294967296.0) / jnp.float32(sample_rate)
    scaled = srbase * freq
    mag = jnp.abs(scaled).astype(jnp.uint32)
    return jnp.where(scaled >= 0, mag, jnp.uint32(0) - mag)


def affine1_scan(a: jnp.ndarray, u: jnp.ndarray, s0: jnp.ndarray, block: int = 512):
    """Parallel scan of x_i = a_i * x_{i-1} + u_i (first-order recurrences).

    a, u: [..., n]; s0: [...]. Returns post-states [..., n]. Used for the
    pink-noise taps, the decimator latch, and other one-pole recurrences.
    Same two-level decomposition as affine2_scan.
    """

    def combine(x, y):
        a1, u1 = x
        a2, u2 = y
        return a2 * a1, a2 * u1 + u2

    n = a.shape[-1]
    if n % block != 0 or n <= block:
        ai, ui = jax.lax.associative_scan(combine, (a, u), axis=a.ndim - 1)
        return ai * s0[..., None] + ui
    nb = n // block
    ab = a.reshape(*a.shape[:-1], nb, block)
    ub = u.reshape(*u.shape[:-1], nb, block)
    ai, ui = jax.lax.associative_scan(combine, (ab, ub), axis=ab.ndim - 1)
    sa, su = jax.lax.associative_scan(
        combine, (ai[..., -1], ui[..., -1]), axis=ai.ndim - 2
    )
    bl = sa * s0[..., None] + su  # state at each block END
    start = jnp.concatenate(
        [jnp.broadcast_to(s0[..., None], (*bl.shape[:-1], 1)), bl[..., :-1]], axis=-1
    )
    post = ai * start[..., :, None] + ui
    return post.reshape(*post.shape[:-2], n)


def _affine2_combine(x, y):
    """Compose two affine maps s -> M s + v on 2-state systems.

    Elements are (a, b, c, d, e, f) for M = [[a, b], [c, d]], v = [e, f].
    Written as explicit elementwise arithmetic: an einsum/matmul may run
    below f32 at default precision (TF32 on the GPU's tensor cores), which
    would destroy the filter's precision. Elementwise mul/add stays f32.
    """
    (a1, b1, c1, d1, e1, f1) = x
    (a2, b2, c2, d2, e2, f2) = y
    return (
        a2 * a1 + b2 * c1,
        a2 * b1 + b2 * d1,
        c2 * a1 + d2 * c1,
        c2 * b1 + d2 * d1,
        a2 * e1 + b2 * f1 + e2,
        c2 * e1 + d2 * f1 + f2,
    )


def _affine2_apply(m, lx, ly):
    a, b, c, d, e, f = m
    return a * lx + b * ly + e, c * lx + d * ly + f


def affine2_scan(elems, s0_l, s0_b, block: int = 512):
    """Parallel scan of x_i = M_i x_{i-1} + v_i for 2-state recurrences.

    elems: tuple (a, b, c, d, e, f), each [..., n] — the per-sample affine
    maps. s0_l/s0_b: [...] initial state components. Returns
    (pre_l, pre_b, post_l, post_b): [..., n] states before/after each step.

    Two-level decomposition keeps compile time and memory bounded: an
    associative scan *within* fixed-size blocks (depth log2(block)), then a
    second associative scan over the per-block summaries, then a broadcast
    apply. A flat scan over e.g. 1M samples unrolls ~20 slice levels and
    compiles for minutes; this stays at 9 + log2(n/block).
    """
    n = elems[0].shape[-1]
    if n % block != 0 or n <= block:
        # flat scan for small/odd sizes
        inc = jax.lax.associative_scan(_affine2_combine, elems, axis=elems[0].ndim - 1)
        post_l, post_b = _affine2_apply(inc, s0_l[..., None], s0_b[..., None])
    else:
        nb = n // block
        blocked = tuple(e.reshape(*e.shape[:-1], nb, block) for e in elems)
        inc = jax.lax.associative_scan(
            _affine2_combine, blocked, axis=blocked[0].ndim - 1
        )  # within-block inclusive prefixes [..., nb, block]
        summaries = tuple(e[..., -1] for e in inc)  # [..., nb]
        sum_scan = jax.lax.associative_scan(
            _affine2_combine, summaries, axis=summaries[0].ndim - 1
        )
        # block-start states: s0 for block 0, scanned summaries before j
        bl, bb = _affine2_apply(sum_scan, s0_l[..., None], s0_b[..., None])
        start_l = jnp.concatenate(
            [jnp.broadcast_to(s0_l[..., None], (*bl.shape[:-1], 1)), bl[..., :-1]],
            axis=-1,
        )
        start_b = jnp.concatenate(
            [jnp.broadcast_to(s0_b[..., None], (*bb.shape[:-1], 1)), bb[..., :-1]],
            axis=-1,
        )
        post_l, post_b = _affine2_apply(
            inc, start_l[..., :, None], start_b[..., :, None]
        )
        post_l = post_l.reshape(*post_l.shape[:-2], n)
        post_b = post_b.reshape(*post_b.shape[:-2], n)
    pre_l = jnp.concatenate(
        [jnp.broadcast_to(s0_l[..., None], (*post_l.shape[:-1], 1)), post_l[..., :-1]],
        axis=-1,
    )
    pre_b = jnp.concatenate(
        [jnp.broadcast_to(s0_b[..., None], (*post_b.shape[:-1], 1)), post_b[..., :-1]],
        axis=-1,
    )
    return pre_l, pre_b, post_l, post_b
