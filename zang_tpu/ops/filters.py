"""SVF state-variable filter as a parallel affine scan.

The reference's filter (src/modules/Filter.zig:96-151) is a per-sample
2-state recurrence — but a *linear time-varying* one: both oversampling
steps update (l, b) affinely given (cutoff, res, input). So the whole time
axis parallelizes: build the per-sample affine map (A_i, c_i) by probing the
step function on basis states (exactly captures the f32-evaluated
coefficients), compose with an associative scan, and evaluate outputs from
the prefix states. Rounding differs from the sequential loop only through
the scan's association order; the filter is contractive, so deviations stay
at the 1e-6 level (measured in tests) instead of accumulating.
"""

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import backend
from .scan import affine2_scan

Array = jnp.ndarray

# np not jnp: a module-scope jnp scalar would initialize the backend at
# import time (see ops/oscillators.py)
FCDCOFFSET = np.float32(3.814697265625e-6)  # 2^-18, Filter.zig:8

FILTER_MULS = {
    "bypass": None,
    "low_pass": (1.0, 0.0, 0.0),
    "band_pass": (0.0, 1.0, 0.0),
    "high_pass": (0.0, 0.0, 1.0),
    "notch": (1.0, 0.0, 1.0),
    "all_pass": (1.0, 1.0, 1.0),
}


def cutoff_from_frequency(frequency, sample_rate):
    """src/modules/Filter.zig:20-23. Works on scalars or arrays (f32)."""
    f32 = jnp.float32
    v = f32(2.0) * (f32(1.0) - jnp.cos(f32(jnp.pi) * frequency / f32(sample_rate)))
    return jnp.sqrt(jnp.clip(v, 0.0, 1.0))


def _svf_step(l, b, inp, cut, res, off=FCDCOFFSET):
    """One output sample: the 2x oversampled update (Filter.zig:123-147).

    Returns (l', b', h) — post-step state and the pre-step high-pass part.
    All ops f32 in the reference's expression order. The GPU kernel gates
    inactive samples with cut = off = 0.0, an exact identity on (l, b).
    """
    inv = inp + FCDCOFFSET
    l = l + cut * b - off
    b = b + cut * (inv - b * res - l)
    l = l + cut * b
    h = inv - b * res - l
    b = b + cut * h
    return l, b, h


def svf_filter_table(
    l0: Array,
    b0: Array,
    x: Array,
    filter_type: str,
    tb: Array,
    cutv: Array,
    res: Union[Array, float],
    t0,
    active_from: Optional[Array] = None,
) -> Tuple[Array, Array, Array]:
    """SVF with a piecewise-constant cutoff given as per-tile boundary
    tables (ops.segprog tiled format) instead of a [V, n] array.

    tb/cutv: [V, nt, S] absolute boundary frames / raw cutoff per slot;
    t0: absolute frame of x[:, 0]; active_from: [V] first-active frame.
    Evaluates the tables in XLA and calls svf_filter (same semantics)."""
    from .segprog import eval_tiled_chunk

    n = x.shape[1]
    t_idx = jnp.int32(t0) + jnp.arange(n, dtype=jnp.int32)
    cut = eval_tiled_chunk({"tb": tb, "cut": cutv}, t_idx)["cut"]
    act = None
    if active_from is not None:
        act = t_idx[None, :] >= jnp.asarray(active_from, jnp.int32)[:, None]
    return svf_filter(l0, b0, x, filter_type, cut, res, act)


def svf_filter(
    l0: Array,
    b0: Array,
    x: Array,
    filter_type: str,
    cutoff: Union[Array, float],
    res: Union[Array, float],
    active: Optional[Array] = None,
    muls: Optional[Tuple[Array, Array, Array]] = None,
) -> Tuple[Array, Array, Array]:
    """Run the SVF over x [..., n]. Returns (l_end, b_end, out [..., n]).

    cutoff/res: raw 0-1 params (clamped like the reference); broadcastable
    to x. active: bool [..., n] — inactive samples leave state untouched and
    output 0 (module not painted). filter_type "mix" takes per-sample
    (l, b, h) output weights via muls (broadcastable to x) — the recurrence
    itself is type-independent (Filter.zig:120-147), so a time-varying type
    is just a varying output mix; bypass must be handled by the caller
    (mask active + select input).
    """
    if filter_type == "bypass":
        out = x if active is None else jnp.where(active, x, 0.0)
        return l0, b0, out

    # GPU: the two-phase block kernel (ops/pallas_svf.py), ~3 passes over
    # memory instead of the affine scan's ~log2(n) levels
    if backend.use_kernel(mix=filter_type == "mix",
                          per_sample_res=jnp.ndim(res) != 0):
        from .pallas_svf import svf_filter_pallas

        return svf_filter_pallas(l0, b0, x, FILTER_MULS[filter_type], cutoff,
                                 res, active)

    if filter_type != "mix":
        muls = FILTER_MULS[filter_type]
    return svf_filter_affine(l0, b0, x, muls, cutoff, res, active)


def svf_filter_affine(l0, b0, x, muls, cutoff, res, active=None):
    """The plain XLA path of svf_filter: an affine scan over time. muls:
    the (l, b, h) output weights, static or broadcastable to x."""
    l_mul, b_mul, h_mul = muls
    cut = jnp.clip(jnp.asarray(cutoff, jnp.float32), 0.0, 1.0)
    r = jnp.float32(1.0) - jnp.clip(jnp.asarray(res, jnp.float32), 0.0, 1.0)
    cut = jnp.broadcast_to(cut, x.shape)
    r = jnp.broadcast_to(r, x.shape)

    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)

    # probe the affine step on basis states to extract A_i and c_i exactly as
    # f32-evaluated: state' = A s + c, h = Ah s + ch.
    l_00, b_00, h_00 = _svf_step(zero, zero, x, cut, r)  # c, ch
    l_10, b_10, h_10 = _svf_step(one, zero, x, cut, r)
    l_01, b_01, h_01 = _svf_step(zero, one, x, cut, r)

    # affine map elements (a, b, c, d, e, f): M = [[a,b],[c,d]], v = [e,f]
    ea = l_10 - l_00
    eb = l_01 - l_00
    ec = b_10 - b_00
    ed = b_01 - b_00
    ee = l_00
    ef = b_00
    if active is not None:
        one = jnp.float32(1.0)
        zero = jnp.float32(0.0)
        ea = jnp.where(active, ea, one)
        eb = jnp.where(active, eb, zero)
        ec = jnp.where(active, ec, zero)
        ed = jnp.where(active, ed, one)
        ee = jnp.where(active, ee, zero)
        ef = jnp.where(active, ef, zero)

    pre_l, pre_b, post_l, post_b = affine2_scan((ea, eb, ec, ed, ee, ef), l0, b0)

    # output uses post-step l and b plus h computed from the pre-step state
    h_out = h_00 + (h_10 - h_00) * pre_l + (h_01 - h_00) * pre_b
    as_f32 = lambda m: jnp.asarray(m, jnp.float32)
    out = (
        post_l * as_f32(l_mul)
        + post_b * as_f32(b_mul)
        + h_out * as_f32(h_mul)
    )
    if active is not None:
        out = jnp.where(active, out, 0.0)
    return post_l[..., -1], post_b[..., -1], out
