"""Multi-chip rendering: shard the voice axis over a device mesh.

The reference is single-process (SURVEY.md §2f); its natural scaling axis is
polyphony. Here voices are a leading tensor axis everywhere, and mixdown is
a sum (src/zang/mixdown.zig — associative), so scaling across chips is:
shard every per-voice array (programs, states) along a 'voices' mesh axis,
render locally, and psum partial mixes over the device links. XLA/GSPMD
inserts the collective from sharding annotations — no hand-written comms.
The GPU kernels, which GSPMD cannot partition, run per shard under a
shard_map over the same voice axis (ops/backend.py).

Voice counts are padded to a multiple of the mesh size with silent voices
(empty timelines render exact zeros and carry no state transitions).
"""

from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.timeline import SubvoiceTimeline
from ..graph.render import Performance, make_render_fn


def make_mesh(n_devices: Optional[int] = None, axis: str = "voices") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def pad_timelines(
    timelines: List[SubvoiceTimeline], multiple: int
) -> List[SubvoiceTimeline]:
    """Pad a part's subvoice list with silent voices to a multiple."""
    total = timelines[0].total
    out = list(timelines)
    while len(out) % multiple:
        out.append(
            SubvoiceTimeline(
                starts=np.zeros((0,), dtype=np.int64),
                resets=np.zeros((0,), dtype=bool),
                params=[],
                total=total,
            )
        )
    return out


def _voice_sharding(mesh: Mesh, axis: str):
    """Sharding rules: arrays with a leading voice axis shard on it."""

    def spec_for(x):
        if hasattr(x, "ndim") and x.ndim >= 1:
            return NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
        return NamedSharding(mesh, P())

    return spec_for


def render_performance_sharded(
    perf: Performance,
    total_frames: int,
    mesh: Mesh,
    chunk_size: int = 65536,
    axis: str = "voices",
    aot_cache: Optional[str] = None,
    _aot_status: Optional[list] = None,
) -> np.ndarray:
    """Render with per-part voice axes sharded across the mesh.

    Each part's voice count must be a multiple of the mesh size (use
    pad_timelines when building the Performance). Returns f32 [C, total].

    aot_cache (or ZANG_AOT_CACHE) persists the mesh-sharded executable to
    disk: a warm entry skips tracing+lowering+compiling, the multi-chip
    analog of render_performance's cache (graph/aotcache.py — the key
    carries the mesh axes/shape on top of the instrument tag).
    _aot_status, if a list, receives the cache status ("hit"/"miss"/"off").
    """
    run, (state0, starts, xs) = make_render_fn(perf, total_frames, chunk_size)

    n_dev = mesh.devices.size

    def shard_voice_state(x):
        x = jnp.asarray(x)
        if x.ndim >= 1 and x.shape[0] % n_dev == 0:
            return jax.device_put(x, NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1)))))
        return jax.device_put(x, NamedSharding(mesh, P()))

    def replicate(x):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P()))

    def shard_xs(x):
        # xs arrays are [n_chunks, V, K]: shard the voice axis (dim 1)
        x = jnp.asarray(x)
        if x.ndim >= 2 and x.shape[1] % n_dev == 0:
            return jax.device_put(
                x, NamedSharding(mesh, P(None, axis, *([None] * (x.ndim - 2))))
            )
        return jax.device_put(x, NamedSharding(mesh, P()))

    # state0 = (per-part states with leading voice axes, post-chain state).
    # Only the former shards on voices; post-fx state (delay lines etc.)
    # replicates — its leading axis is time/feature, and a length that
    # happens to divide the mesh must not get sharded by accident.
    part_states, post_state = state0
    state0 = (
        jax.tree_util.tree_map(shard_voice_state, part_states),
        jax.tree_util.tree_map(replicate, post_state),
    )
    xs = jax.tree_util.tree_map(shard_xs, xs)
    starts = jax.device_put(starts, NamedSharding(mesh, P()))

    out_sharding = NamedSharding(mesh, P())  # mixed audio replicated
    from ..graph import aotcache

    cache_dir = aot_cache or aotcache.default_cache_dir()
    args = (state0, starts, xs)
    # jax.set_mesh (not the legacy `with mesh:`) makes the mesh visible
    # while tracing, so the GPU kernels split the voice axis with a
    # shard_map (ops/backend.voice_parallel) instead of leaving an opaque
    # kernel call for GSPMD to gather
    with jax.set_mesh(mesh):
        if cache_dir:
            try:
                tag = ("mesh:" + aotcache.performance_tag(perf, chunk_size)
                       + f":{mesh.axis_names}{tuple(mesh.devices.shape)}"
                       + f":{axis}")
            except aotcache.Uncacheable:
                fn, status = jax.jit(run, out_shardings=out_sharding), "off"
            else:
                fn, status = aotcache.aot_compile(
                    run, args, tag, cache_dir, out_shardings=out_sharding)
        else:
            fn, status = jax.jit(run, out_shardings=out_sharding), "off"
        if _aot_status is not None:
            _aot_status.append(status)
        audio = fn(*args)
    return np.asarray(audio[:, :total_frames])
