"""Tier-3 batch serving: render fleets of independent songs (SCALING.md).

Production workloads ("render these 10k songs") need no cross-song
communication: songs are scheduled round-robin onto devices, each device
streams per-song data through a **shared compiled graph**, and WAVs stream
to disk segment by segment. The design decisions (SCALING.md tier 3):

- No cross-song collectives; one job = one device.
- The compile cache is the per-device instrument graph, keyed on
  (instrument set + config, voice counts, chunking, baked scalars) — NOT on
  the song. Per-song variation flows in as traced arguments: segment
  programs as scan xs, program array leaves as a `consts` pytree. Songs of
  any length share one compile because rendering is segmented
  (`segment_chunks` chunks per device call, final segment edge-padded).
- Failures re-queue the song on another attempt (renders are stateless
  between songs); `max_attempts` bounds retries.

The reference is single-process and has no serving layer (SURVEY.md §2f);
this subsystem is the device-side scale-out story above it.
"""

import hashlib
import math
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..core.mixdown import mixdown_s16
from ..core.wav import StreamingWavWriter
from ..graph.render import Performance, RenderCtx
from ..ops.segprog import SegProgram


# -- program splitting: per-song arrays become traced arguments -------------


class _ConstSlot:
    """Marker replacing an array leaf in the program skeleton."""

    __slots__ = ("i",)

    def __init__(self, i: int) -> None:
        self.i = i


def _split_programs(programs):
    """-> (skeleton, consts): array leaves pulled into a flat list and
    replaced by _ConstSlot markers. SegProgram leaves stay (they become scan
    xs and are replaced wholesale by merge_chunk); scalars stay baked (they
    are part of the graph key)."""
    consts = []

    def walk(p):
        if isinstance(p, SegProgram):
            return p
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v) for v in p)
        if isinstance(p, (np.ndarray, jax.Array)):
            consts.append(np.asarray(p))
            return _ConstSlot(len(consts) - 1)
        return p

    return [walk(p) for p in programs], consts


def _restore_programs(skeleton, consts):
    def walk(p):
        if isinstance(p, _ConstSlot):
            return consts[p.i]
        if isinstance(p, SegProgram):
            return p
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v) for v in p)
        return p

    return [walk(p) for p in skeleton]


# -- graph keys --------------------------------------------------------------


def _leaf_key(v):
    if isinstance(v, np.generic):
        return ("s", v.dtype.str, v.item())
    if isinstance(v, (bool, int, float, str, bytes, type(None))):
        return ("s", type(v).__name__, v)
    if isinstance(v, (np.ndarray, jax.Array)):
        a = np.asarray(v)
        return ("a", a.shape, str(a.dtype),
                hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest())
    if isinstance(v, (list, tuple)):
        return ("l", tuple(_leaf_key(x) for x in v))
    if isinstance(v, dict):
        return ("d", tuple(sorted((k, _leaf_key(x)) for k, x in v.items())))
    # callables / opaque objects: identity — conservative (same object
    # shares, distinct objects recompile); the cache pins a reference so
    # ids stay unique for its lifetime
    return ("o", id(v))


def _instrument_key(inst):
    cls = type(inst)
    # private attrs are derived caches (e.g. ScriptInstrument._ir, rebuilt
    # from `compiled` on every plan) — identity comes from public config
    cfg = tuple(sorted(
        (k, _leaf_key(v)) for k, v in vars(inst).items()
        if not k.startswith("_")
    ))
    return (cls.__module__, cls.__qualname__, cfg)


def _skeleton_key(p):
    if isinstance(p, _ConstSlot):
        return ("c",)  # shapes/dtypes are jit-cache concerns, not key ones
    if isinstance(p, SegProgram):
        return ("seg", tuple(sorted(
            (k, str(a.dtype)) for k, a in p.values.items())), p.num_voices)
    if isinstance(p, dict):
        return ("d", tuple(sorted((k, _skeleton_key(v)) for k, v in p.items())))
    if isinstance(p, (list, tuple)):
        return ("l", tuple(_skeleton_key(v) for v in p))
    return _leaf_key(p)


def graph_key(perf: Performance, skeleton, chunk_size: int,
              segment_chunks: int):
    return (
        tuple((_instrument_key(inst), len(tls)) for inst, tls in perf.parts),
        tuple(_skeleton_key(s) for s in skeleton),
        _leaf_key(perf.post_fn),
        _leaf_key(perf.post_init_state),
        perf.sample_rate,
        perf.num_channels,
        chunk_size,
        segment_chunks,
    )


# -- shape padding so songs share compiles -----------------------------------


def _pad_bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _pad_slot_axes(xs, minimum: int = 4):
    """Edge-pad the slot axis (last) of every chunkified program dict to a
    power-of-two bucket, so songs with slightly different boundary densities
    hit the same compiled shapes. Edge padding is semantics-free in both
    formats: a duplicated boundary re-selects the same value (tiled) /
    contributes a zero delta (pconst)."""

    def walk(p):
        if isinstance(p, dict) and ("tb" in p or "starts" in p):
            kkey = "tb" if "tb" in p else "starts"
            if isinstance(p[kkey], np.ndarray):
                S = p[kkey].shape[-1]
                B = _pad_bucket(S, minimum)
                if B == S:
                    return p
                return {
                    name: np.pad(
                        a, [(0, 0)] * (a.ndim - 1) + [(0, B - S)], mode="edge"
                    )
                    for name, a in p.items()
                }
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v) for v in p)
        return p

    return walk(xs)


def _pad_chunk_axis(xs, n_chunks: int, padded: int):
    """Repeat the final chunk's slices to fill the last segment. The padded
    chunks render audio past `total` (trimmed) and only pollute state after
    the last real chunk (discarded)."""
    if padded == n_chunks:
        return xs

    def pad(a):
        return np.concatenate(
            [a, np.repeat(a[-1:], padded - n_chunks, axis=0)], axis=0
        )

    return jax.tree_util.tree_map(pad, xs)


# -- the shared-graph cache ---------------------------------------------------


class SharedGraphCache:
    """jit cache for segment render functions, keyed on the instrument
    graph — not the song. `traces` counts actual retraces (a trace-time
    side effect in the function body): one per (graph key, device,
    argument-shape signature), so N songs on one device trace once, and a
    fleet traces once per device — never once per song."""

    def __init__(self, max_entries: int = 64) -> None:
        self._lock = threading.Lock()
        self._fns = {}  # insertion-ordered: oldest evicted first
        # keep each entry's keyed Performance alive so its id()-based key
        # components stay unique among LIVE entries; evicting an entry and
        # its pin together means a recycled id() can only match a key that
        # no longer exists (miss -> rebuild), never a stale hit
        self._pinned = {}
        self.max_entries = max_entries
        self.traces = 0

    def has(self, perf: Performance, skeleton, chunk_size: int,
            segment_chunks: int, emit: str = "f32") -> bool:
        key = graph_key(perf, skeleton, chunk_size, segment_chunks) + (emit,)
        with self._lock:
            return key in self._fns

    def get(self, perf: Performance, skeleton, chunk_size: int,
            segment_chunks: int, emit: str = "f32"):
        key = graph_key(perf, skeleton, chunk_size, segment_chunks) + (emit,)
        with self._lock:
            hit = key in self._fns
            if not hit:
                while len(self._fns) >= self.max_entries:
                    oldest = next(iter(self._fns))
                    del self._fns[oldest]
                    self._pinned.pop(oldest, None)
                self._pinned[key] = perf
                self._fns[key] = self._build(
                    perf, skeleton, chunk_size, segment_chunks, emit
                )
            return self._fns[key], hit

    def _build(self, perf, skeleton, chunk_size, segment_chunks, emit):
        cache = self

        def seg_fn(state, starts_seg, xs_seg, consts, vol):
            cache.traces += 1  # runs at trace time only
            programs = _restore_programs(skeleton, consts)

            def step(st, inputs):
                c0, chunk_progs = inputs
                ctx = RenderCtx(
                    sample_rate=perf.sample_rate,
                    t_idx=c0 + jnp.arange(chunk_size, dtype=jnp.int32),
                    n=chunk_size,
                )
                return perf.render_chunk(st, chunk_progs, ctx,
                                         programs=programs)

            state, chunks = jax.lax.scan(step, state, (starts_seg, xs_seg))
            audio = jnp.moveaxis(chunks, 0, 1).reshape(chunks.shape[1], -1)
            if emit == "s16":
                # mixdown on device: the serving fleet downloads i16 PCM,
                # not f32 mix buffers (half the download bytes, and the
                # clamp/NaN/trunc rules run on device)
                audio = mixdown_s16(audio, vol)
            return state, audio

        from ..graph import aotcache

        if aotcache.default_cache_dir():
            # ZANG_AOT_CACHE: persist compiled segment graphs, so a server
            # restart (same instruments) skips the cold compile entirely.
            # NOTE: cache hits skip tracing, so `traces` stays 0 for them.
            try:
                tag = ("serve:" + aotcache.performance_tag(perf, chunk_size)
                       + f":{segment_chunks}:{emit}")
            except aotcache.Uncacheable:
                return jax.jit(seg_fn)
            return aotcache.AotDispatch(seg_fn, tag)
        return jax.jit(seg_fn)


def render_song_shared(
    cache: SharedGraphCache,
    perf: Performance,
    total_frames: int,
    chunk_size: int = 65536,
    segment_chunks: int = 16,
    slot_minimum: int = 4,
    on_segment: Optional[Callable[[np.ndarray], None]] = None,
    s16_volume: Optional[float] = None,
    inflight: int = 4,
) -> Optional[np.ndarray]:
    """Render one song through the shared graph, segment by segment.

    on_segment, if given, receives each trimmed [C, n] segment as it lands
    (streaming) and the function returns None; otherwise the full
    [C, total_frames] array is returned. Segments are f32 mix, or i16 PCM
    mixed down on device when s16_volume is set. Bit-identical to
    graph.render.render_performance (+ host mixdown) at the same chunk size.

    Dispatch is pipelined: up to `inflight` segments are in flight on the
    device before the host blocks fetching the oldest — segment s+1's
    dispatch needs only s's *device-side* state, so downloads overlap
    compute instead of serializing with it."""
    xs_np, n_chunks = perf.chunk_xs(total_frames, chunk_size)
    xs_np = _pad_slot_axes(xs_np, slot_minimum)
    n_seg = max(1, math.ceil(n_chunks / segment_chunks))
    padded = n_seg * segment_chunks
    xs_np = _pad_chunk_axis(xs_np, n_chunks, padded)

    emit = "s16" if s16_volume is not None else "f32"
    skeleton, consts = _split_programs(perf.programs)
    fn, _ = cache.get(perf, skeleton, chunk_size, segment_chunks, emit)
    consts_dev = [jnp.asarray(c) for c in consts]
    vol = jnp.float32(1.0 if s16_volume is None else s16_volume)

    starts = np.arange(padded, dtype=np.int32) * chunk_size
    state = perf.init_state()
    out = [] if on_segment is None else None
    done = 0
    pending = deque()

    def flush_one():
        nonlocal done
        audio = pending.popleft()
        seg = np.asarray(audio)[:, : max(0, min(total_frames - done,
                                                audio.shape[1]))]
        done += seg.shape[1]
        if on_segment is not None:
            if seg.shape[1]:
                on_segment(seg)
        else:
            out.append(seg)

    for s in range(n_seg):
        sl = slice(s * segment_chunks, (s + 1) * segment_chunks)
        xs_seg = jax.tree_util.tree_map(lambda a: jnp.asarray(a[sl]), xs_np)
        state, audio = fn(state, jnp.asarray(starts[sl]), xs_seg,
                          consts_dev, vol)
        pending.append(audio)
        while len(pending) >= max(1, inflight):
            flush_one()
    while pending:
        flush_one()
    if on_segment is not None:
        return None
    return np.concatenate(out, axis=1)


# -- the batch scheduler -------------------------------------------------------


@dataclass
class RenderJob:
    """One song: build() -> (Performance, total_frames). build runs on the
    worker thread (plan compilation is part of the job)."""

    name: str
    build: Callable[[], tuple]
    volume: float = 1.0


@dataclass
class JobResult:
    name: str
    status: str  # "ok" | "failed"
    device: str = ""
    attempts: int = 0
    wav_path: Optional[str] = None
    seconds: float = 0.0
    wall_s: float = 0.0
    rtf: float = 0.0
    shared_compile: bool = False
    error: str = ""
    audio: Optional[np.ndarray] = None  # only when out_dir is None


def _no_retry(e: BaseException) -> bool:
    """Validation-class failures are deterministic: retrying a bad script
    or a malformed request body max_attempts times just burns workers.
    Retries are for transient device errors only."""
    if getattr(e, "no_retry", False):
        return True
    try:
        from ..script.errors import ScriptError
    except Exception:  # pragma: no cover — script package always present
        return False
    return isinstance(e, ScriptError)


def _format_error(e: BaseException) -> str:
    """Client-facing failure text: an exception that declares public_error
    (e.g. the HTTP tier's request-validation error) supplies its own
    message; internal class names must not leak into API responses."""
    pub = getattr(e, "public_error", None)
    if pub:
        return str(pub)
    return f"{type(e).__name__}: {e}"


class BatchRenderer:
    """Round-robin scheduler: one worker thread per device, jobs from a
    shared queue, failed jobs re-queued up to max_attempts (renders are
    stateless between songs — SCALING.md tier 3 elasticity)."""

    def __init__(
        self,
        out_dir: Optional[str] = None,
        devices: Optional[Sequence] = None,
        chunk_size: int = 65536,
        segment_chunks: int = 16,
        slot_minimum: int = 4,
        max_attempts: int = 3,
        workers_per_device: Optional[int] = None,
    ) -> None:
        self.out_dir = out_dir
        self.devices = list(devices) if devices is not None else None
        self.chunk_size = chunk_size
        self.segment_chunks = segment_chunks
        self.slot_minimum = slot_minimum
        self.max_attempts = max_attempts
        # >1 worker thread per device overlaps one job's host prep (plan
        # compilation, ~0.3 s/song) with another's device renders — at
        # >1000x render RTF the host side is the aggregate bottleneck.
        # But the prep is pure-Python/numpy (GIL-bound): workers beyond the
        # host core count only add contention (measured on a 1-core box:
        # 4 workers 82x aggregate vs 2 workers 111x), so the default
        # scales with the host.
        if workers_per_device is None:
            workers_per_device = min(4, (os.cpu_count() or 1) + 1)
        self.workers_per_device = max(1, workers_per_device)
        self.cache = SharedGraphCache()

    def run(self, jobs: Sequence[RenderJob]) -> List[JobResult]:
        names = [j.name for j in jobs]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(
                f"duplicate job names {dupes}: results are keyed (and WAVs "
                "written) by name — give each job a unique name")
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
        devices = self.devices if self.devices is not None else jax.devices()
        devices = devices[: max(1, min(len(devices), len(jobs)))]
        q: "queue.Queue" = queue.Queue()
        for job in jobs:
            q.put((job, 1))
        results = {}
        lock = threading.Lock()

        def worker(dev):
            while True:
                try:
                    job, attempt = q.get_nowait()
                except queue.Empty:
                    return
                t0 = time.time()
                try:
                    with jax.default_device(dev):
                        res = self._render_one(job, dev)
                    res.attempts = attempt
                    res.wall_s = time.time() - t0
                    res.rtf = res.seconds / res.wall_s if res.wall_s else 0.0
                    with lock:
                        results[job.name] = res
                except Exception as e:  # noqa: BLE001 — jobs must not kill workers
                    if attempt < self.max_attempts and not _no_retry(e):
                        q.put((job, attempt + 1))
                    else:
                        with lock:
                            results[job.name] = JobResult(
                                name=job.name, status="failed",
                                device=str(dev), attempts=attempt,
                                error=_format_error(e),
                            )
                finally:
                    q.task_done()

        threads = [
            threading.Thread(target=worker, args=(d,), daemon=True)
            for d in devices
            for _ in range(self.workers_per_device)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return [
            results.get(j.name, JobResult(name=j.name, status="failed",
                                          error="not scheduled"))
            for j in jobs
        ]

    def _render_one(self, job: RenderJob, dev) -> JobResult:
        perf, total_frames = job.build()
        emit = "s16" if self.out_dir else "f32"
        hit = self.cache.has(
            perf, _split_programs(perf.programs)[0],
            self.chunk_size, self.segment_chunks, emit,
        )
        res = JobResult(
            name=job.name, status="ok", device=str(dev),
            seconds=total_frames / perf.sample_rate, shared_compile=hit,
        )
        if self.out_dir:
            path = os.path.join(self.out_dir, f"{job.name}.wav")
            with StreamingWavWriter(
                path, int(perf.sample_rate), perf.num_channels
            ) as w:
                render_song_shared(
                    self.cache, perf, total_frames, self.chunk_size,
                    self.segment_chunks, self.slot_minimum,
                    on_segment=w.append, s16_volume=job.volume,
                )
            res.wav_path = path
        else:
            res.audio = render_song_shared(
                self.cache, perf, total_frames, self.chunk_size,
                self.segment_chunks, self.slot_minimum,
            )
        return res


def main(argv=None):
    """Demo CLI: batch-render slices of the Bach song across all devices.

    python -m zang_tpu.serve.batch --out /tmp/wavs --songs 4 --seconds 20
    """
    import argparse
    import json

    from ..platform import enable_compile_cache

    enable_compile_cache()

    from ..host import song as sm

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--songs", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--segment-chunks", type=int, default=16)
    args = ap.parse_args(argv)

    def mk(i):
        total = int(args.seconds * sm.SAMPLE_RATE)
        return lambda: (sm.build_performance(total), total)

    jobs = [
        RenderJob(name=f"toccata_{i:03d}", build=mk(i), volume=0.25)
        for i in range(args.songs)
    ]
    br = BatchRenderer(out_dir=args.out, chunk_size=args.chunk,
                       segment_chunks=args.segment_chunks)
    t0 = time.time()
    results = br.run(jobs)
    wall = time.time() - t0
    total_audio = sum(r.seconds for r in results if r.status == "ok")
    print(json.dumps({
        "jobs": len(jobs),
        "ok": sum(r.status == "ok" for r in results),
        "devices": len(jax.devices()),
        "traces": br.cache.traces,
        "audio_seconds": total_audio,
        "wall_s": round(wall, 2),
        "fleet_rtf": round(total_audio / wall, 1) if wall else 0.0,
    }))
    for r in results:
        print(f"  {r.name}: {r.status} dev={r.device} attempts={r.attempts} "
              f"rtf={r.rtf:.0f} shared={r.shared_compile} {r.error}")


if __name__ == "__main__":
    main()
