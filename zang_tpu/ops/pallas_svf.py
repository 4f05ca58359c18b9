"""Pallas (Triton) kernel for the SVF filter (src/modules/Filter.zig:96-151).

The affine-scan formulation (ops/filters.py) is correct but log-depth: XLA
materializes ~log2(n) levels of 6-component intermediates in device
memory. This kernel replaces it with a block-parallel two-phase evaluation
whose memory traffic is ~3 passes over the data:

  layout    the time axis n = nb blocks x T samples. Chain c = v*nb + j is
            voice v's block j, so x.reshape(V*nb, T) is free. Each program
            owns CHAIN_TILE chains (one per thread), walks their T samples
            in a fori_loop over [C, K_TILE] tiles and carries the state in
            registers. nb follows from the shape: enough chains to fill the
            card's SMs.
  phase A   propagate the zero-state trajectory and the two homogeneous
            basis columns through each block. The recurrence is linear
            time-varying, so these give the block's end-to-end affine map.
  glue      an associative scan over the nb block maps (plain XLA, tiny:
            [V, nb] elements) gives every block's start state.
  phase B   re-run the exact sequential recurrence from each block's start
            state and write the filter output (post-step l, b + pre-step h,
            Filter.zig:140-146) plus the final (l, b) carry.

When the voices alone fill the card (nb == 1), phase A and the glue drop
out and the kernel is the plain sequential loop.

The activity gate rides in cut's sign (ce = cut >= 0 on active samples, -1
on inactive), so inactive samples are exact identity steps. That is also
how the wrapper pads time and voices: padded samples carry ce = -1.

Within a block the arithmetic is the reference's sequential loop; only the
nb-1 block seams go through the composed-map path, so the deviation from
the oracle stays in the affine scan's class.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

from . import backend
from .filters import FCDCOFFSET, _svf_step
from .scan import _affine2_combine

CHAIN_TILE = 128  # chains per program: one per thread of 4 warps
TARGET_CHAINS = 1 << 17  # ~1k chains per SM on a 132-SM card
K_TILE = 32  # samples per tile load: one 128-byte line of each chain

_PARAMS = plgpu_triton.CompilerParams(num_warps=CHAIN_TILE // 32, num_stages=1)


def _decode_gate(ce):
    """ce = cut (>= 0 after the clip) on active samples, -1 on inactive."""
    m = ce >= np.float32(0.0)
    cutm = jnp.where(m, ce, np.float32(0.0))
    offm = jnp.where(m, FCDCOFFSET, np.float32(0.0))
    return m, cutm, offm


def tile_columns(ref, t0):
    """The K_TILE sample columns [C] of ref[:, t0:t0+K_TILE]: one [C, K]
    tile load, split in registers. Each chain's samples are contiguous, so
    the load reads whole cache lines; one [C] column per step would touch
    C lines for 4 bytes each (at [16384, 65536] on an H100: 110.6 ms
    against 12.1 ms with 32-sample tiles)."""
    tile = ref[:, pl.ds(t0, K_TILE)]
    return [c.reshape(c.shape[0]) for c in jnp.split(tile, K_TILE, axis=1)]


def join_columns(cols):
    """Inverse of tile_columns' split: K columns [C] -> one [C, K] tile."""
    if len(cols) == 1:
        return cols[0][:, None]
    evens, odds = join_columns(cols[0::2]), join_columns(cols[1::2])
    return jnp.stack([evens, odds], axis=-1).reshape(cols[0].shape[0],
                                                     len(cols))


def _summary_kernel(x_ref, ce_ref, res_ref, out_ref):
    """Phase A: x_ref/ce_ref [C, T]; out_ref [6, C] = (l00, b00) zero-state
    end plus the two homogeneous basis columns (l10, b10), (l01, b01)."""
    res = res_ref[0]
    z = jnp.zeros((x_ref.shape[0],), jnp.float32)
    one = z + np.float32(1.0)

    def body(i, carry):
        t0 = i * K_TILE
        for x, ce in zip(tile_columns(x_ref, t0), tile_columns(ce_ref, t0)):
            l00, b00, l10, b10, l01, b01 = carry
            _, cut, off = _decode_gate(ce)
            nl00, nb00, _ = _svf_step(l00, b00, x, cut, res, off)
            # homogeneous (linear-part) dynamics of the two basis columns:
            # 12 ops each instead of a 16-op full step
            dl1 = l10 + cut * b10
            db1 = b10 - cut * (b10 * res + dl1)
            dl1 = dl1 + cut * db1
            db1 = db1 - cut * (db1 * res + dl1)
            dl2 = l01 + cut * b01
            db2 = b01 - cut * (b01 * res + dl2)
            dl2 = dl2 + cut * db2
            db2 = db2 - cut * (db2 * res + dl2)
            carry = nl00, nb00, dl1, db1, dl2, db2
        return carry

    carry = jax.lax.fori_loop(0, x_ref.shape[1] // K_TILE, body,
                              (z, z, one, z, z, one))
    for k in range(6):
        out_ref[k, :] = carry[k]


def _apply_kernel(x_ref, ce_ref, start_ref, res_ref, out_ref, end_ref, *,
                  muls):
    """Phase B: start_ref/end_ref [2, C] block start/end (l, b);
    out_ref [C, T] the filter output."""
    res = res_ref[0]
    lm, bm, hm = (np.float32(m) for m in muls)

    def body(i, carry):
        t0 = i * K_TILE
        l, b = carry
        outs = []
        for x, ce in zip(tile_columns(x_ref, t0), tile_columns(ce_ref, t0)):
            m, cut, off = _decode_gate(ce)
            l, b, h = _svf_step(l, b, x, cut, res, off)
            outs.append(jnp.where(m, l * lm + b * bm + h * hm,
                                  np.float32(0.0)))
        out_ref[:, pl.ds(t0, K_TILE)] = join_columns(outs)
        return l, b

    l, b = jax.lax.fori_loop(0, x_ref.shape[1] // K_TILE, body,
                             (start_ref[0, :], start_ref[1, :]))
    end_ref[0, :] = l
    end_ref[1, :] = b


def _geometry(V: int, n: int):
    """(nb, T, Vp): time blocks per voice, samples per block (a K_TILE
    multiple), padded voice count. nb is the power of two that brings V*nb
    chains to TARGET_CHAINS without blocks shorter than one tile; Vp*nb is
    a CHAIN_TILE multiple."""
    nb = 1
    while V * nb < TARGET_CHAINS and n >= 2 * nb * K_TILE:
        nb *= 2
    T = -(-n // (nb * K_TILE)) * K_TILE
    step = max(CHAIN_TILE // nb, 1)
    Vp = -(-V // step) * step
    return nb, T, Vp


@functools.partial(jax.jit, static_argnames=("muls", "nb", "interpret"))
def _svf_chains(x2, ce2, res, l0, b0, muls, nb, interpret=False):
    """x2/ce2: [Vp*nb, T] chain-major; res: [1]; l0/b0: [Vp].
    Returns (out2 [Vp*nb, T], l_end [Vp], b_end [Vp])."""
    chains, T = x2.shape
    Vp = chains // nb
    grid = (chains // CHAIN_TILE,)
    rows = pl.BlockSpec((CHAIN_TILE, T), lambda i: (i, 0))
    scalar = pl.BlockSpec((1,), lambda i: (0,))

    def per_chain(k):
        return pl.BlockSpec((k, CHAIN_TILE), lambda i: (0, i))

    if nb == 1:
        start = jnp.stack([l0, b0])
    else:
        summ = pl.pallas_call(
            _summary_kernel,
            grid=grid,
            in_specs=[rows, rows, scalar],
            out_specs=per_chain(6),
            out_shape=jax.ShapeDtypeStruct((6, chains), jnp.float32),
            backend="triton",
            compiler_params=_PARAMS,
            interpret=interpret,
            name="svf_block_summary",
        )(x2, ce2, res)
        # block maps M = [[a, b], [c, d]], v = [e, f]: the homogeneous
        # basis columns ARE the map, the zero-state end is v
        l00, b00, l10, b10, l01, b01 = (
            summ[k].reshape(Vp, nb) for k in range(6))
        inc = jax.lax.associative_scan(
            _affine2_combine, (l10, l01, b10, b01, l00, b00), axis=1)
        ident = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
        a, bm, c, d, e, f = (
            jnp.concatenate([jnp.full((Vp, 1), iv, jnp.float32), m[:, :-1]],
                            axis=1)
            for m, iv in zip(inc, ident))
        start_l = a * l0[:, None] + bm * b0[:, None] + e
        start_b = c * l0[:, None] + d * b0[:, None] + f
        start = jnp.stack([start_l.reshape(chains), start_b.reshape(chains)])

    out2, end = pl.pallas_call(
        functools.partial(_apply_kernel, muls=muls),
        grid=grid,
        in_specs=[rows, rows, per_chain(2), scalar],
        out_specs=[rows, per_chain(2)],
        out_shape=[jax.ShapeDtypeStruct((chains, T), jnp.float32),
                   jax.ShapeDtypeStruct((2, chains), jnp.float32)],
        backend="triton",
        compiler_params=_PARAMS,
        interpret=interpret,
        name="svf_block_apply",
    )(x2, ce2, start, res)
    # the signal's end state is each voice's LAST block's end
    end = end.reshape(2, Vp, nb)[:, :, -1]
    return out2, end[0], end[1]


def _svf_local(l0, b0, x, ce, res, *, muls, interpret):
    """Pad [V, n] to the kernel geometry, run, and crop."""
    V, n = x.shape
    nb, T, Vp = _geometry(V, n)
    pad_t = nb * T - n
    if Vp != V or pad_t:
        x = jnp.pad(x, ((0, Vp - V), (0, pad_t)))
        ce = jnp.pad(ce, ((0, Vp - V), (0, pad_t)),
                     constant_values=np.float32(-1.0))
        l0 = jnp.pad(l0, (0, Vp - V))
        b0 = jnp.pad(b0, (0, Vp - V))
    out2, l_end, b_end = _svf_chains(
        x.reshape(Vp * nb, T), ce.reshape(Vp * nb, T), res, l0, b0,
        muls=muls, nb=nb, interpret=interpret)
    out = out2.reshape(Vp, nb * T)[:V, :n]
    return l_end[:V], b_end[:V], out


def svf_filter_pallas(l0, b0, x, muls, cutoff, res, active=None,
                      interpret=False):
    """The SVF on [..., n] f32 inputs of any shape. muls: the static
    (l, b, h) output weights of the filter type; res must be a scalar.
    Returns (l_end [...], b_end [...], out [..., n])."""
    lead, n = x.shape[:-1], x.shape[-1]
    V = int(np.prod(lead, dtype=np.int64))
    cut = jnp.clip(jnp.asarray(cutoff, jnp.float32), 0.0, 1.0)
    ce = jnp.broadcast_to(cut, x.shape)
    if active is not None:
        ce = jnp.where(active, ce, np.float32(-1.0))
    r = (np.float32(1.0)
         - jnp.clip(jnp.asarray(res, jnp.float32), 0.0, 1.0)).reshape(1)
    run = functools.partial(_svf_local, muls=tuple(float(m) for m in muls),
                            interpret=interpret)
    l_end, b_end, out = backend.voice_parallel(
        run,
        (jnp.broadcast_to(jnp.asarray(l0, jnp.float32), lead).reshape(V),
         jnp.broadcast_to(jnp.asarray(b0, jnp.float32), lead).reshape(V),
         x.astype(jnp.float32).reshape(V, n), ce.reshape(V, n)),
        (r,))
    return l_end.reshape(lead), b_end.reshape(lead), out.reshape(x.shape)
