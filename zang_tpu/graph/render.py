"""Chunked offline renderer: one jitted lax.scan over the whole piece.

The reference renders 1024-sample blocks in a host loop
(examples/write_wav.zig:56-93). Here the *entire* render is a single XLA
program: a lax.scan over chunks (default 65536 samples); within a chunk all
voices and samples are parallel, and only tiny per-voice states (filter
l/b, delay lines) carry across chunks.

Segment programs (ops.segprog.SegProgram) in instrument plans are sliced
per chunk on the host and fed to the scan as xs, so the device evaluates
piecewise tables with O(K_chunk) masked delta sums — no gathers, no
searchsorted (ROADMAP Design 5 measures whether a plain lookup would do
on the GPU).

An Instrument provides:
  plan(timelines, sample_rate) -> program dict; SegProgram leaves get
      chunkified automatically, other leaves are captured as constants
  init_state(num_voices) -> state pytree
  render(state, prog, ctx) -> (state', audio)
      prog has SegProgram leaves replaced by {"starts": [V,Kc], name: [V,Kc]}
      device slices. audio: [V, n] per voice (summed by the renderer —
      mixdown is a sum, src/zang/mixdown.zig) or [C, n] pre-mixed.
"""

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..core.timeline import SubvoiceTimeline
from ..ops.segprog import ChunkedSegProgram, SegProgram, chunkify, chunkify_tiled


@dataclass(frozen=True)
class RenderCtx:
    sample_rate: float  # static
    t_idx: jnp.ndarray  # int32 [n] absolute frame indices for this chunk
    n: int  # static chunk length


def _map_segprograms(prog, fn):
    """Recursively replace SegProgram leaves in a nested dict/list/tuple."""
    if isinstance(prog, SegProgram):
        return fn(prog)
    if isinstance(prog, dict):
        return {k: _map_segprograms(v, fn) for k, v in prog.items()}
    if isinstance(prog, (list, tuple)):
        return type(prog)(_map_segprograms(v, fn) for v in prog)
    return prog


class Performance:
    """A set of (instrument, timelines) rendered into one mix.

    post_fn, if given, maps (state, mix [n], ctx) -> (state, audio [C, n])
    and owns any effect state (delays, filters); post_init_state() supplies
    its initial state.
    """

    def __init__(
        self,
        parts: Sequence[Tuple[object, List[SubvoiceTimeline]]],
        sample_rate: float,
        num_channels: int = 1,
        post_fn: Optional[Callable] = None,
        post_init_state: Optional[Callable] = None,
    ) -> None:
        self.parts = list(parts)
        self.sample_rate = float(sample_rate)
        self.num_channels = num_channels
        self.post_fn = post_fn
        self.post_init_state = post_init_state
        self.programs = [
            inst.plan(tls, self.sample_rate) for inst, tls in self.parts
        ]

    def init_state(self):
        states = [inst.init_state(len(tls)) for inst, tls in self.parts]
        post_state = self.post_init_state() if self.post_init_state else ()
        return (states, post_state)

    def chunk_xs(self, total_frames: int, chunk_size: int, tile: int = 512):
        """Host: per-chunk slices of every SegProgram, stacked for lax.scan.

        Programs are sliced at tile granularity (ops.segprog.chunkify_tiled):
        the device then does O(boundaries-per-tile) selects per sample
        instead of O(K_chunk) masked sums. Non-SegProgram leaves become ()
        (no scan xs); render merges them back from the captured programs.
        """
        n_chunks = -(-total_frames // chunk_size)

        def conv(sp: SegProgram):
            if chunk_size % tile == 0 and chunk_size >= tile:
                return chunkify_tiled(sp, chunk_size, n_chunks, total_frames, tile)
            ch = chunkify(sp, chunk_size, n_chunks, total_frames)
            return {"starts": ch.starts, **ch.values}

        def walk(prog):
            if isinstance(prog, SegProgram):
                return conv(prog)
            if isinstance(prog, dict):
                return {k: walk(v) for k, v in prog.items()}
            if isinstance(prog, (list, tuple)):
                return type(prog)(walk(v) for v in prog)
            return ()  # static leaf: captured, not scanned

        return [walk(p) for p in self.programs], n_chunks

    def merge_chunk(self, prog, xs_chunk):
        """Merge chunk-local seg slices into the static program structure."""
        if isinstance(prog, SegProgram):
            return xs_chunk
        if isinstance(prog, dict):
            return {k: self.merge_chunk(v, xs_chunk[k]) for k, v in prog.items()}
        if isinstance(prog, (list, tuple)):
            return type(prog)(
                self.merge_chunk(v, x) for v, x in zip(prog, xs_chunk)
            )
        return prog

    def render_chunk(self, state, chunk_progs, ctx: RenderCtx, programs=None):
        """chunk_progs: per-part program dicts with chunk-local seg slices.

        Instruments normally return [V, n] (voices summed into the mono mix).
        An instrument with `output_channels = C` returns [C, n] pre-mixed
        multichannel audio instead (e.g. a stereo panner).

        programs, if given, substitutes self.programs as the static program
        structure merged with the chunk slices — the batch server passes the
        per-song program constants as traced arguments this way, so songs
        share one compiled graph (serve/batch.py).
        """
        states, post_state = state
        mix = jnp.zeros((ctx.n,), jnp.float32)
        multi = jnp.zeros((self.num_channels, ctx.n), jnp.float32)
        new_states = []
        for (inst, _), static_prog, xs_chunk, st in zip(
            self.parts, programs if programs is not None else self.programs,
            chunk_progs, states
        ):
            prog = self.merge_chunk(static_prog, xs_chunk)
            st2, audio = inst.render(st, prog, ctx)
            channels = getattr(inst, "output_channels", None)
            if channels is not None:
                multi = multi + audio
            elif audio.ndim == 2:  # [V, n] -> sum voices
                mix = mix + jnp.sum(audio, axis=0)
            else:
                mix = mix + audio
            new_states.append(st2)
        if self.post_fn is not None:
            post_state, out = self.post_fn(post_state, mix, ctx)
            out = out + multi if out.shape == multi.shape else out
        elif self.num_channels == 1:
            out = mix[None, :] + multi
        else:
            # mono contributions go to every channel (center)
            out = multi + mix[None, :]
        return (new_states, post_state), out


def make_render_fn(perf: Performance, total_frames: int, chunk_size: int = 65536):
    """Build (fn, args): fn(state0, starts, xs) renders the whole piece.

    The returned fn is pure/jittable; args are ready to pass. Audio out is
    [C, n_chunks*chunk] (trim to total_frames)."""
    xs_np, n_chunks = perf.chunk_xs(total_frames, chunk_size)

    def step(state, inputs):
        c0, chunk_progs = inputs
        ctx = RenderCtx(
            sample_rate=perf.sample_rate,
            t_idx=c0 + jnp.arange(chunk_size, dtype=jnp.int32),
            n=chunk_size,
        )
        state, out = perf.render_chunk(state, chunk_progs, ctx)
        return state, out

    def run(state0, starts, xs):
        _, chunks = jax.lax.scan(step, state0, (starts, xs))
        return jnp.moveaxis(chunks, 0, 1).reshape(chunks.shape[1], -1)

    starts = jnp.arange(n_chunks, dtype=jnp.int32) * chunk_size
    xs = jax.tree_util.tree_map(jnp.asarray, xs_np)
    return run, (perf.init_state(), starts, xs)


def make_stream_step(perf: Performance, chunk_size: int = 65536,
                     jit: bool = True):
    """Jitted one-chunk step for streaming renders of `perf`.

    Reusable across stream_blocks calls (and therefore across repeated
    requests for the same piece) — jax.jit caches on this function object,
    so holding it avoids re-tracing per request (serve/http.py keeps a
    small LRU of these)."""

    def step(state, c0, xs_chunk):
        ctx = RenderCtx(
            sample_rate=perf.sample_rate,
            t_idx=c0 + jnp.arange(chunk_size, dtype=jnp.int32),
            n=chunk_size,
        )
        return perf.render_chunk(state, xs_chunk, ctx)

    return jax.jit(step) if jit else step


def stream_blocks(perf: Performance, total_frames: int, step,
                  chunk_size: int = 65536):
    """Drive a make_stream_step fn over the piece, yielding f32
    [C, <=chunk_size] blocks in order (state carried across chunks).
    `step` must have been built from the SAME perf object."""
    import numpy as np

    xs_np, n_chunks = perf.chunk_xs(total_frames, chunk_size)
    state = perf.init_state()
    for i in range(n_chunks):
        xs_chunk = jax.tree_util.tree_map(lambda a, i=i: a[i], xs_np)
        state, out = step(state, jnp.int32(i * chunk_size), xs_chunk)
        n = min(chunk_size, total_frames - i * chunk_size)
        yield np.asarray(out)[:, :n]


def stream_performance(
    perf: Performance,
    total_frames: int,
    chunk_size: int = 65536,
    jit: bool = True,
):
    """Incremental render: yields f32 [C, <=chunk_size] blocks in order.

    Same per-chunk computation as make_render_fn (state carried across
    chunks, one jitted step reused), but each chunk is fetched and yielded
    as soon as it is rendered — the HTTP tier streams long WAVs from this
    instead of buffering the whole piece (serve/http.py /v1/render/stream).
    """
    step = make_stream_step(perf, chunk_size, jit=jit)
    yield from stream_blocks(perf, total_frames, step, chunk_size)


def render_performance(
    perf: Performance,
    total_frames: int,
    chunk_size: int = 65536,
    jit: bool = True,
    aot_cache: Optional[str] = None,
) -> np.ndarray:
    """Render the full piece; returns f32 [num_channels, total_frames].

    aot_cache (or ZANG_AOT_CACHE in the environment) names a directory of
    serialized executables: a warm entry skips tracing+lowering+compiling
    entirely (graph/aotcache.py — bit-identical output, verified)."""
    run, args = make_render_fn(perf, total_frames, chunk_size)
    fn = run
    if jit:
        from . import aotcache

        cache_dir = aot_cache or aotcache.default_cache_dir()
        if cache_dir:
            try:
                tag = "render:" + aotcache.performance_tag(perf, chunk_size)
            except aotcache.Uncacheable:
                fn = jax.jit(run)  # unfingerprintable config: never risk
            else:  # a colliding disk key (stale-executable-as-hit)
                fn, _status = aotcache.aot_compile(run, args, tag, cache_dir)
        else:
            fn = jax.jit(run)
    audio = fn(*args)
    return np.asarray(audio[:, :total_frames])
