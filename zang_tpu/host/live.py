"""Live (interactive) host: the device analog of the SDL audio-callback loop.

The reference host (examples/example.zig:35-83,423-440) runs a real-time
loop: the main thread pushes key events into an ImpulseQueue under a lock;
the audio callback drains the queue, splits the block at impulse frames
with a Trigger, and paints 1024-sample blocks. Here the same event
machinery runs block-by-block on the host, and one jitted device step —
compiled once, with static shapes — renders each block from the carried
state pytree:

  push_event/key_event -> ImpulseQueue            (core/notes.py)
  render_block():
    queue -> PolyphonyDispatcher -> Trigger       (exact reference routing)
    new note segments extend per-voice timelines
    instrument.plan(timelines-so-far)             (same planners as offline)
    window-slice to [frame, frame+block) with K padded to a fixed slot
    count -> jitted step(state, t_idx, programs) -> (state', audio block)

Events pushed with impulse_frame=0 take effect at the next block start —
matching the reference host, whose getImpulseFrame() always returns 0
(examples/example.zig:576-583).

Latency is one block: a 1024-sample block at 48 kHz has a 21.3 ms budget
(block times on the GPU: not measured yet).
"""

import copy
import os
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..core.notes import (
    IdGenerator,
    ImpulseQueue,
    ImpulsesAndParamses,
    PolyphonyDispatcher,
)
from ..core.span import Span
from ..core.timeline import SubvoiceTimeline
from ..core.trigger import Trigger
from ..graph.render import RenderCtx
from ..ops.segprog import SegProgram
from . import keyboard, liveplan


@dataclass
class _PartState:
    instrument: object
    polyphony: int
    queue: ImpulseQueue
    dispatcher: PolyphonyDispatcher
    triggers: List[Trigger]
    segs: List[List[tuple]]  # per voice: (abs_start, reset, params)
    dev_state: object
    plan_cache: Optional[tuple] = None  # (key, plan)
    planner: Optional[object] = None  # incremental live planner (liveplan.py)
    params: Optional[object] = None  # ParamStore (host/params.py)
    param_vec: Optional[np.ndarray] = None  # f32 [P] device-kind values
    plan_nonce: int = 0  # bumped on plan-kind changes (re-plan cache key)
    controllers: Optional[dict] = None  # {name: [(frame, value)]} streams


class LiveSession:
    """Block-by-block interactive renderer over device instruments.

    parts: [(instrument, polyphony)] — instruments follow the offline
    Instrument protocol (plan / init_state / render), so the same
    instruments serve offline renders and live sessions.
    """

    def __init__(
        self,
        parts: Sequence[Tuple[object, int]],
        sample_rate: float,
        block_size: int = 1024,
        num_channels: int = 1,
        post_fn: Optional[Callable] = None,
        post_init_state: Optional[Callable] = None,
        slot_capacity: int = 8,
        max_slot_capacity: int = 1024,
    ) -> None:
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.num_channels = num_channels
        self.post_fn = post_fn
        self.post_state = post_init_state() if post_init_state else ()
        self.frame = 0  # absolute session frame of the next block
        self.idgen = IdGenerator()
        # the reference host locks the audio device around every main-thread
        # mutation of shared state (examples/example.zig:425,448); here one
        # lock serializes event pushes against block rendering
        self._lock = threading.Lock()
        self.slot_capacity = slot_capacity
        self.max_slot_capacity = max(slot_capacity, max_slot_capacity)
        self._step = None  # jitted per-block device step
        self.parts = [
            _PartState(
                instrument=inst,
                polyphony=poly,
                queue=ImpulseQueue(),
                dispatcher=PolyphonyDispatcher(poly),
                triggers=[Trigger() for _ in range(poly)],
                segs=[[] for _ in range(poly)],
                dev_state=None,  # created after the first plan() — some
                # instruments (ScriptInstrument) size state from the plan
                # incremental planner: O(events) host cost per block instead
                # of a full-session re-plan (ZANG_LIVE_INC=0 forces the
                # re-plan path, used by the equivalence tests)
                planner=(
                    inst.live_planner(poly, float(sample_rate))
                    if hasattr(inst, "live_planner")
                    and os.environ.get("ZANG_LIVE_INC", "1") != "0"
                    else None
                ),
            )
            for inst, poly in parts
        ]
        for part in self.parts:
            self._init_params(part)
            self._init_controllers(part)
        self._horizon = 1 << 20  # plan horizon (frames); grows by doubling
        self._held_keys = {}  # part -> {key: note_id} (default key pairing)
        # construction-time spec identity for snapshot/restore matching:
        # live-parameter edits mutate instrument cfg (apply_plan_params
        # mirrors values), so the CURRENT fingerprint drifts with play —
        # two sessions built from the same parts spec must match no matter
        # which side's knobs moved (the values themselves travel in the
        # snapshot and are re-applied after validation)
        self._pristine_spec = self._spec_fingerprint()

    @staticmethod
    def _init_params(part: _PartState) -> None:
        """Build the part's live-parameter store (host/params.py) when its
        instrument declares ParamSpecs (the reference host's Parameter
        panel, example.zig:324-392)."""
        from .params import ParamStore

        inst = part.instrument
        if not hasattr(inst, "param_specs"):
            return
        specs = inst.param_specs()
        if not specs:
            return
        part.params = ParamStore(specs)
        if any(s.kind in ("device", "both") for s in specs):
            part.param_vec = np.asarray(
                inst.device_params(part.params.values), np.float32)

    @staticmethod
    def _init_controllers(part: _PartState) -> None:
        """Seed continuous-controller streams for instruments that declare
        them (controller_specs() -> {name: default}; the reference's
        mouseEvent path, examples/example_mouse.zig): each starts with one
        event at frame 0 carrying the default value."""
        inst = part.instrument
        if not hasattr(inst, "controller_specs"):
            return
        specs = dict(inst.controller_specs())
        if not specs:
            return
        part.controllers = {name: [(0, float(v))]
                            for name, v in specs.items()}
        if part.planner is not None:
            for name, v in specs.items():
                part.planner.extend_controller(name, 0, float(v))

    # -- event input ------------------------------------------------------

    def push_event(self, part: int, params: dict, note_id: Optional[int] = None,
                   impulse_frame: int = 0) -> int:
        """Push a note event for the next block (reference keyEvent path).
        Returns the note id used."""
        with self._lock:
            nid = self.idgen.next() if note_id is None else note_id
            self.parts[part].queue.push(impulse_frame, nid, params)
        return nid

    def key_event(self, part: int, key: str, down: bool, a4: float = 440.0,
                  extra: Optional[dict] = None,
                  note_ids: Optional[dict] = None) -> Optional[int]:
        """Keyboard-map helper (examples/common.zig:24-66 two-row map).

        note_ids, if given, tracks held keys so note-offs reuse the note id
        of the matching note-on (the example hosts' note_ids arrays,
        example_play.zig:84-103). When omitted, the session keeps its own
        per-part tracker — required for polyphonic parts, where the
        dispatcher drops a note-off whose id matches no held note
        (core/notes.py _choose_slot; notes.zig:246-258), so an unpaired
        key-up would otherwise leave the note stuck (e.g. over the TCP
        serving protocol, which has no client-side id state)."""
        rel = keyboard.get_key_rel_freq(key)
        if rel is None:
            return None
        if note_ids is None:
            note_ids = self._held_keys.setdefault(part, {})
        params = {"freq": float(np.float32(a4 * rel)), "note_on": down}
        if extra:
            params.update(extra)
        nid = None
        if note_ids is not None:
            if down:
                # re-press of a held key (OS auto-repeat, missed key-up):
                # release the old note first or its dispatcher slot would
                # stay note_on forever once the tracked id is overwritten
                old = note_ids.pop(key, None)
                if old is not None:
                    self.push_event(
                        part, {**params, "note_on": False}, note_id=old)
                nid = None  # fresh id below
            else:
                nid = note_ids.pop(key, None)
                if nid is None:
                    return None
        nid = self.push_event(part, params, note_id=nid)
        if note_ids is not None and down:
            note_ids[key] = nid
        return nid

    def push_controller(self, part: int, name: str, value: float,
                        frame: Optional[int] = None) -> None:
        """One continuous-controller move (the reference host's mouseEvent,
        examples/example_mouse.zig): re-targets every plan channel bound to
        `name` on the next block — the portamento glides toward the new
        value from wherever it is now. frame defaults to the next block
        start (the reference's getImpulseFrame() is always 0).

        Explicit frames are clamped monotonic (>= the session clock and
        >= the previous move of the same controller): the incremental
        planner commits walks in order, while the full-replan path sorts —
        a frame in the past would silently drop the prior move from one
        path but not the other, breaking their bit-exactness. A live host
        cannot honor a past frame anyway."""
        p = self.parts[part]
        if p.controllers is None or name not in p.controllers:
            have = [] if p.controllers is None else sorted(p.controllers)
            raise ValueError(
                f"part {part} has no controller {name!r}; available: {have}")
        with self._lock:
            f = self.frame if frame is None else int(frame)
            f = max(f, self.frame)
            moves = p.controllers[name]
            if moves:
                f = max(f, moves[-1][0])
            p.controllers[name].append((f, float(value)))
            if p.planner is not None:
                p.planner.extend_controller(name, f, float(value))

    # -- live parameters (reference Parameter panel, example.zig:324-392) ---

    def param_specs(self, part: int) -> list:
        """The part's ParamSpecs ([] when the instrument exposes none)."""
        store = self.parts[part].params
        return [] if store is None else list(store.specs)

    def get_params(self, part: int) -> dict:
        store = self.parts[part].params
        return {} if store is None else dict(store.values)

    def _param_store(self, part: int):
        store = self.parts[part].params
        if store is None:
            raise ValueError(
                f"part {part}'s instrument exposes no live parameters")
        return store

    def _apply_params(self, part: _PartState, names) -> None:
        """Propagate changed values: device-kind rebuilds the per-block f32
        vector (swapped atomically — the next block uploads it); plan-kind
        updates the instrument config the planners re-read (next block's
        open-segment paint / next plan)."""
        kinds = {part.params.by_name[n].kind for n in names}
        if kinds & {"device", "both"}:
            part.param_vec = np.asarray(
                part.instrument.device_params(part.params.values),
                np.float32)
        # mirror EVERY change into the instrument config (apply_plan_params
        # documents that device-kind values are mirrored too, so an offline
        # plan()/render() of this instance matches the live values) — but
        # only plan-affecting kinds invalidate the re-plan cache. The method
        # is optional for instruments whose params are all device-kind.
        apply = getattr(part.instrument, "apply_plan_params", None)
        if apply is not None:
            apply(part.params.values)
        if kinds & {"plan", "both"}:
            part.plan_nonce += 1  # invalidates the full re-plan cache

    def set_param(self, part: int, name: str, value: int) -> int:
        """Set one parameter (clamped to its range); the change is audible
        on the next rendered block. Returns the stored value."""
        p = self.parts[part]
        store = self._param_store(part)
        with self._lock:
            v = store.set(name, value)
            self._apply_params(p, (name,))
        return v

    def step_param(self, part: int, name: str, delta: int) -> int:
        """Arrow-key stepping (example.zig:324-372)."""
        p = self.parts[part]
        store = self._param_store(part)
        with self._lock:
            v = store.step(name, delta)
            self._apply_params(p, (name,))
        return v

    def randomize_params(self, part: int, rng=None) -> dict:
        """Backspace-randomize every parameter (example.zig:373-391)."""
        import random

        p = self.parts[part]
        store = self._param_store(part)
        with self._lock:
            vals = store.randomize(rng or random.Random())
            self._apply_params(p, set(vals))
        return vals

    # -- block rendering ---------------------------------------------------

    def _extend_segments(self, part: _PartState) -> None:
        span = Span(0, self.block_size)
        iap = getattr(part, "_pending", None)
        if iap is None:
            iap = part.queue.consume()
        part._pending = None
        per_voice = part.dispatcher.dispatch(iap)
        for v in range(part.polyphony):
            for r in part.triggers[v].iterate(span, per_voice[v]):
                abs_start = self.frame + r.span.start
                prev = part.segs[v][-1] if part.segs[v] else None
                if prev is not None and not r.note_id_changed and prev[2] == r.params:
                    continue
                part.segs[v].append((abs_start, r.note_id_changed, r.params))
                if part.planner is not None:
                    part.planner.extend(v, abs_start, r.note_id_changed,
                                        r.params)

    def _timelines(self, part: _PartState, total: int) -> List[SubvoiceTimeline]:
        out = []
        for v in range(part.polyphony):
            segs = part.segs[v]
            out.append(
                SubvoiceTimeline(
                    starts=np.array([s for s, _, _ in segs], dtype=np.int64),
                    resets=np.array([r for _, r, _ in segs], dtype=bool),
                    params=[p for _, _, p in segs],
                    total=total,
                )
            )
        return out

    def _window_slice(self, prog, f0: int, f1: int, total: int):
        """SegProgram leaves -> {starts [V,KP] i32, name [V,KP]} covering
        [f0, f1), padded to slot_capacity with zero-delta rows."""
        if isinstance(prog, SegProgram):
            V, K = prog.starts.shape
            KP = self.slot_capacity
            firsts = np.empty(V, np.int64)
            lasts = np.empty(V, np.int64)
            for v in range(V):
                s = prog.starts[v]
                firsts[v] = max(np.searchsorted(s, f0, side="right") - 1, 0)
                lasts[v] = max(
                    min(np.searchsorted(s, f1, side="left"),
                        np.searchsorted(s, total, side="left")),
                    firsts[v] + 1,
                )
            count = int((lasts - firsts).max())
            if count > KP:
                if not liveplan.TRUNCATE_OVERFLOW:
                    raise RuntimeError(
                        f"live block needs {count} slots > slot_capacity={KP}; "
                        "raise slot_capacity (events per block are <= 32)"
                    )
                # degrade: drop the oldest overflow segments of this window
                firsts = np.maximum(firsts, lasts - KP)
            idx = firsts[:, None] + np.arange(KP)[None, :]
            in_w = idx < lasts[:, None]
            idx_v = np.minimum(np.maximum(np.minimum(idx, lasts[:, None] - 1), 0), K - 1)
            vix = np.arange(V)[:, None]
            out = {
                "starts": np.where(
                    in_w, prog.starts[vix, np.minimum(idx, K - 1)], np.int64(f1)
                ).astype(np.int32)
            }
            for name, arr in prog.values.items():
                out[name] = arr[vix, idx_v]
            return out
        if isinstance(prog, dict):
            return {k: self._window_slice(v, f0, f1, total) for k, v in prog.items()}
        if isinstance(prog, (list, tuple)):
            return type(prog)(self._window_slice(v, f0, f1, total) for v in prog)
        return prog

    def _part_progs(self, part: _PartState, f0: int, f1: int):
        if part.planner is not None:
            # incremental path: planners carry the walk state, so the
            # window costs O(slot_capacity), independent of session age
            return part.planner.window(f0, f1, self.slot_capacity)
        # plans are deterministic in (segments, horizon, controllers), so
        # blocks with no new events reuse the cached plan — steady-state
        # host cost is just the window slice, not O(session) re-planning
        key = (tuple(len(sv) for sv in part.segs), self._horizon,
               part.plan_nonce,
               None if part.controllers is None else
               tuple(sorted((n, len(evs))
                            for n, evs in part.controllers.items())))
        if part.plan_cache is not None and part.plan_cache[0] == key:
            plan = part.plan_cache[1]
        else:
            tls = self._timelines(part, self._horizon)
            if part.controllers is not None:
                plan = part.instrument.plan(
                    tls, self.sample_rate,
                    controllers={n: list(evs)
                                 for n, evs in part.controllers.items()})
            else:
                plan = part.instrument.plan(tls, self.sample_rate)
            part.plan_cache = (key, plan)
        return self._window_slice(plan, f0, f1, self._horizon)

    def _make_step(self):
        from ..graph import aotcache

        if aotcache.default_cache_dir():
            # ZANG_AOT_CACHE: a session restart (same instrument spec and
            # slot capacity) loads the block step's executable from disk
            # instead of compiling on the interactive path.
            try:
                tag = "live:" + aotcache.stable_tag(
                    ([(p.instrument, p.polyphony) for p in self.parts],
                     self.post_fn, self.num_channels, self.block_size))
            except aotcache.Uncacheable:
                return jax.jit(self._step_body())
            return aotcache.AotDispatch(self._step_body(), tag)
        return jax.jit(self._step_body())

    def _step_body(self):
        """The pure per-block step (unjitted — LiveFleet vmaps it over a
        lane axis before jitting)."""
        instruments = [p.instrument for p in self.parts]
        num_channels = self.num_channels
        post_fn = self.post_fn
        n = self.block_size

        def step(states, post_state, t_idx, progs):
            ctx = RenderCtx(sample_rate=self.sample_rate, t_idx=t_idx, n=n)
            mix = jnp.zeros((n,), jnp.float32)
            multi = jnp.zeros((num_channels, n), jnp.float32)
            new_states = []
            for inst, prog, st in zip(instruments, progs, states):
                st2, audio = inst.render(st, prog, ctx)
                if getattr(inst, "output_channels", None) is not None:
                    multi = multi + audio
                elif audio.ndim == 2:
                    mix = mix + jnp.sum(audio, axis=0)
                else:
                    mix = mix + audio
                new_states.append(st2)
            if post_fn is not None:
                post_state, out = post_fn(post_state, mix, ctx)
                out = out + multi if out.shape == multi.shape else out
            else:
                out = multi + mix[None, :]
            return new_states, post_state, out

        return step

    def _host_block(self) -> Tuple[int, int]:
        """Host half 1: drain queues, extend segments, grow the horizon.
        Returns the block's (f0, f1)."""
        f0, f1 = self.frame, self.frame + self.block_size
        with self._lock:
            drained = [part.queue.consume() for part in self.parts]
        for part, iap in zip(self.parts, drained):
            part._pending = iap
        while self._horizon < f1:
            self._horizon *= 2
        for part in self.parts:
            self._extend_segments(part)
        return f0, f1

    def _window_progs(self, f0: int, f1: int):
        """Host half 2: per-part program windows at the current
        slot_capacity. Raises RuntimeError('...slot_capacity...') on
        overflow — callers own the grow/degrade policy. Parts with live
        device parameters get their current f32 vector attached — it rides
        the same per-block upload as the program window (and LiveFleet's
        single packed transfer), so a set_param needs no re-jit."""
        out = []
        for part in self.parts:
            prog = self._part_progs(part, f0, f1)
            if part.param_vec is not None:
                prog = dict(prog)
                prog["__params__"] = part.param_vec
            out.append(prog)
        return out

    def _degraded_window_progs(self, f0: int, f1: int):
        """Windows with the oldest overflow segments dropped (the
        reference drops events past its 32-impulse cap, notes.zig:108-118;
        transient mis-render, stream survives)."""
        import warnings

        warnings.warn(
            f"live block overflows max_slot_capacity="
            f"{self.max_slot_capacity}; dropping oldest segments "
            "for this block", RuntimeWarning)
        liveplan.TRUNCATE_OVERFLOW = True
        try:
            return self._window_progs(f0, f1)
        finally:
            liveplan.TRUNCATE_OVERFLOW = False

    def _ensure_states(self) -> None:
        for part in self.parts:
            if part.dev_state is None:
                part.dev_state = part.instrument.init_state(part.polyphony)

    def render_block(self) -> np.ndarray:
        """Render the next block; returns f32 [num_channels, block_size]."""
        f0, f1 = self._host_block()
        while True:
            try:
                progs = self._window_progs(f0, f1)
                break
            except RuntimeError as e:
                if "slot_capacity" not in str(e):
                    raise
                if self.slot_capacity < self.max_slot_capacity:
                    # a dense block overflowed the program window — grow and
                    # retry (the jitted step re-specializes on the new
                    # shapes). We keep every event and pay one re-jit.
                    self.slot_capacity = min(
                        self.slot_capacity * 2, self.max_slot_capacity)
                    continue
                progs = self._degraded_window_progs(f0, f1)
                break
        self._ensure_states()
        if self._step is None:
            self._step = self._make_step()
        t_idx = jnp.asarray(np.arange(f0, f1, dtype=np.int32))
        states = [p.dev_state for p in self.parts]
        progs_dev = jax.tree_util.tree_map(jnp.asarray, progs)
        new_states, self.post_state, out = self._step(
            states, self.post_state, t_idx, progs_dev
        )
        for p, st in zip(self.parts, new_states):
            p.dev_state = st
        self.frame = f1
        return np.asarray(out)

    def render_blocks(self, count: int) -> np.ndarray:
        return np.concatenate([self.render_block() for _ in range(count)], axis=1)

    # -- snapshot / restore (session migration) -----------------------------

    def _spec_fingerprint(self) -> tuple:
        # the instrument tag hashes CONFIG (public attrs, callables by
        # bytecode — graph/aotcache.stable_tag), not just the class name:
        # restoring onto NiceInstrument(0.7) state saved from
        # NiceInstrument(0.3), or onto a different script, must be refused,
        # not silently continued with the wrong sound
        from ..graph import aotcache

        return (
            self.sample_rate, self.block_size, self.num_channels,
            # strict=False: a fingerprint that refuses to compute would
            # block ALL snapshots of that spec; the degraded repr only
            # weakens cross-config refusal for unfingerprintable configs
            tuple((aotcache.stable_tag(p.instrument, strict=False),
                   p.polyphony, p.planner is not None) for p in self.parts),
            self.post_fn is not None,
        )

    def snapshot(self, dev_override=None) -> bytes:
        """Serialize the session's complete state — clock, note ids, queued
        events, dispatcher/trigger state, planner walks, device arrays — as
        a self-contained blob restorable on a fresh session with the same
        parts spec (host/snapshot.py; the continuation is bit-exact).

        dev_override: (per_part_dev_states, post_state) replacing the
        session's own device state — LiveFleet passes the lane's slice of
        its stacked state, which is where a fleet lane's live state
        actually is."""
        from . import snapshot as snap

        np_tree = lambda t: jax.tree_util.tree_map(
            lambda x: np.asarray(x), t)
        with self._lock:
            if dev_override is not None:
                dev_states, post = dev_override
                dev_states = [np_tree(d) for d in dev_states]
                post = np_tree(post)
            else:
                dev_states = [
                    None if p.dev_state is None else np_tree(p.dev_state)
                    for p in self.parts
                ]
                post = np_tree(self.post_state)
            parts = [
                {
                    "queue": snap.extract_state(p.queue),
                    "dispatcher": snap.extract_state(p.dispatcher),
                    "triggers": snap.extract_state(p.triggers),
                    "segs": copy.deepcopy(p.segs),
                    "planner": (None if p.planner is None
                                else snap.extract_state(p.planner)),
                    "dev_state": dev,
                    "params": (None if p.params is None
                               else dict(p.params.values)),
                    "controllers": copy.deepcopy(p.controllers),
                }
                for p, dev in zip(self.parts, dev_states)
            ]
            state = {
                "version": 1,
                "spec": self._pristine_spec,
                "frame": self.frame,
                "horizon": self._horizon,
                "slot_capacity": self.slot_capacity,
                "next_id": self.idgen.next_id,
                "held_keys": copy.deepcopy(self._held_keys),
                "post_state": post,
                "parts": parts,
            }
        return snap.dumps(state)

    def restore(self, blob: bytes) -> None:
        """Load a snapshot into this FRESH session (same parts spec; no
        events pushed, no blocks rendered). The next render_block continues
        the captured stream bit-exactly."""
        from . import snapshot as snap

        state = snap.loads(blob)
        if state.get("version") != 1:
            raise ValueError(f"unknown snapshot version {state.get('version')}")
        # validate EVERYTHING before mutating: a refused restore must leave
        # the target session untouched (a server lane rejecting a wire
        # restore keeps serving with its own parameters). Specs compare by
        # construction-time fingerprint — live edits on either side don't
        # change identity, the values travel in the snapshot below.
        if state["spec"] != self._pristine_spec:
            raise ValueError(
                f"snapshot spec mismatch: saved {state['spec']} vs this "
                f"session {self._pristine_spec}")
        for p, ps in zip(self.parts, state["parts"]):
            vals = ps.get("params")
            if vals is None:
                continue
            if p.params is None:
                raise ValueError(
                    "snapshot spec mismatch: saved session had live "
                    "parameters, this instrument exposes none")
            unknown = set(vals) - set(p.params.by_name)
            if unknown:
                raise ValueError(
                    f"snapshot spec mismatch: unknown parameter(s) "
                    f"{sorted(unknown)}")
        with self._lock:
            if self.frame != 0 or any(p.segs[v] for p in self.parts
                                      for v in range(p.polyphony)):
                raise ValueError("restore target must be a fresh session")
            for p, ps in zip(self.parts, state["parts"]):
                vals = ps.get("params")
                if vals is not None:
                    for k, v in vals.items():
                        p.params.set(k, v)
                    self._apply_params(p, set(vals))
            self.frame = state["frame"]
            self._horizon = state["horizon"]
            self.slot_capacity = max(self.slot_capacity,
                                     state["slot_capacity"])
            self.idgen.next_id = state["next_id"]
            self._held_keys = state["held_keys"]
            self.post_state = state["post_state"]
            for p, ps in zip(self.parts, state["parts"]):
                snap.graft_state(p.queue, ps["queue"])
                snap.graft_state(p.dispatcher, ps["dispatcher"])
                p.triggers = snap.graft_state(p.triggers, ps["triggers"])
                p.segs = ps["segs"]
                if ps["planner"] is not None:
                    snap.graft_state(p.planner, ps["planner"])
                p.dev_state = ps["dev_state"]
                if ps.get("controllers") is not None:
                    p.controllers = ps["controllers"]
                p.plan_cache = None
