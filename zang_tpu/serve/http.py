"""HTTP render API (serving tier 5): stateless request/response WAV rendering.

The reference's offline path is a local CLI (examples/write_wav.zig) and a
local example picker (build.zig run steps); the serving analog is one HTTP
endpoint any client can hit to render an example config or an uploaded
zangscript to a WAV, with response caching so repeated requests skip both
the XLA compile and the render. Stdlib-only (http.server), same protocol
family as the TCP live tier (serve/server.py) but request/response:

  GET  /v1/examples                        JSON menu of example configs
  GET  /v1/render?example=play&seconds=4   audio/wav (s16), rendered now
  POST /v1/render/midi                     audio/wav; JSON body:
        {"midi_base64": str,               a Standard MIDI File, base64
         "instrument": str,                stock instrument name or comma
                                           list cycled over parts
         "seconds": float,                 cap the render length
         "transpose": int, "velocity": bool, "group": "channel"|"track",
         "with_drums": bool, "volume": float}
  POST /v1/render/script                   audio/wav; JSON body:
        {"script": str,                    zangscript source (required)
         "module": str,                    exported module (default: last)
         "seconds": float,                 render length (default 4.0)
         "sample_rate": float,             default 44100
         "polyphony": int,                 voice slots (default 2)
         "volume": float,                  mixdown volume (default 0.25)
         "notes": [[t_on, dur, freq], ...] event list (default: a melody)
         "params": {name: value}}          extra note params (enum labels,
                                           booleans, floats) for exported
                                           params beyond freq/note_on
  GET  /v1/render/stream?config=song&seconds=385
        audio/wav streamed incrementally (fixed Content-Length, body
        written chunk by chunk as the piece renders — curl plays the
        full 385 s Bach render without the server buffering it).
        config: song | sampler | poly_echo; own budget max_stream_seconds
  POST /v1/render/batch                    JSON statuses; body:
        {"jobs": [{"name": str,            job label (default job_N)
                   "config": str,          song|sampler|poly_echo ...
                   "script": str, ...}],   ... OR a /v1/render/script body
         "volume": float}
        Jobs run through the tier-3 BatchRenderer (serve/batch.py —
        same-structure songs share one compiled graph); each result
        carries a "url" to fetch the WAV from the response cache.
  GET  /v1/result/<id>                     audio/wav from a batch job
        (LRU-cached; 404 after eviction — re-POST the batch)
  GET  /v1/stats                           JSON serving counters

Script compile failures return HTTP 400 with the compiler's caret
diagnostics (script/errors.py) in the body — the reference's in-window
error display (example.zig:144-168), re-homed to an HTTP error payload.

Renders run on the handler thread, bounded by a semaphore; identical
in-flight requests coalesce onto one render (single-flight) and completed
responses are LRU-cached by request key, so a menu of examples behind a
web page costs one compile per (config, length) no matter how many
listeners. Long or abusive requests are rejected up front (max_seconds,
script size cap) — this tier is for interactive auditioning; bulk offline
work belongs to serve/batch.py (tier 3) and sustained interaction to the
live TCP tier (serve/server.py, tier 4).
"""

import hashlib
import json
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

__all__ = ["RenderHTTPServer", "main"]

# the ex_script melody shape (host/examples.py) as a plain note list
DEFAULT_NOTES = [
    (0.2 + 0.45 * i, 0.3, 440.0 * 2.0 ** (n / 12.0))
    for i, n in enumerate([-9, -2, 0, 3, 0, -2, -9, -14])
]


class _BadRequest(Exception):
    # BatchRenderer markers: a validation error is deterministic (never
    # retried) and its message is already client-facing (the internal
    # class name must not leak into the API response)
    no_retry = True

    def __init__(self, status: int, message: str):
        self.status = status
        self.message = message
        super().__init__(message)

    @property
    def public_error(self) -> str:
        return self.message


def _render_example(name: str, seconds: Optional[float], volume: float):
    from ..core.mixdown import mixdown_s16_np
    from ..core.wav import encode_wav_s16
    from ..host.examples import EXAMPLES

    fn = EXAMPLES[name]
    audio, sr = fn(**({"seconds": seconds} if seconds is not None else {}))
    audio = np.asarray(audio)
    pcm = mixdown_s16_np(audio, volume)
    ch = pcm.shape[0] if pcm.ndim == 2 else 1
    return encode_wav_s16(pcm if ch > 1 else pcm.reshape(-1), int(sr), ch)


def _render_script(body: dict, volume: float):
    from ..core.mixdown import mixdown_s16_np
    from ..core.wav import encode_wav_s16
    from ..graph.render import render_performance

    sr = float(body.get("sample_rate", 44100.0))
    assert 1.0 <= sr <= 192000.0, sr  # bounded in _handle_script
    body = dict(body)
    body.setdefault("seconds", 4.0)
    # ONE builder shared with the batch tier (_build_script_job): the note
    # convention / module selection / param coercion must not fork between
    # POST /v1/render/script and batch script jobs
    perf, total = _build_script_job(body)
    audio = render_performance(
        perf, total, chunk_size=min(16384, max(256, total)))
    pcm = mixdown_s16_np(np.asarray(audio), volume)
    return encode_wav_s16(pcm.reshape(-1), int(sr), 1)


def _render_midi(body: dict, volume: float):
    from ..core.mixdown import mixdown_s16_np
    from ..core.wav import encode_wav_s16
    from ..host.midi import _instrument_maker, render_midi

    # stock names only: the script fallback reads server-local files,
    # which an HTTP client must not be able to name
    makers = [_instrument_maker(n.strip(), allow_script=False)
              for n in str(body.get("instrument", "nice")).split(",")]
    sr = 48000.0
    audio = render_midi(
        body["_midi_bytes"],
        lambda pi, label: makers[pi % len(makers)](),
        sample_rate=sr,
        seconds=body.get("seconds"),
        group=str(body.get("group", "channel")),
        include_velocity=bool(body.get("velocity", False)),
        transpose=int(body.get("transpose", 0)),
        # group='track' is otherwise uncapped: a tiny SMF of minimal
        # tracks would instantiate thousands of instruments and unroll
        # them all into one traced graph — bound parts like MIDI's 16
        # channels and events like the script tier's note budget
        max_parts=body["_max_parts"],
        max_events=body["_max_events"],
        skip_channels=() if body.get("with_drums") else (9,))
    pcm = mixdown_s16_np(np.asarray(audio), volume)
    return encode_wav_s16(pcm.reshape(-1), int(sr), 1)


def _build_config(name: str, seconds: float):
    """(Performance, total) builder for the offline render configs —
    the write_wav.zig pieces (host/render_wav.py), used by the stream
    and batch endpoints."""
    if name == "song":
        from ..host import song as sm

        total = int(seconds * sm.SAMPLE_RATE)
        return sm.build_performance(total), total
    if name == "sampler":
        from ..host.configs import build_sampler_performance

        return build_sampler_performance(seconds=seconds)
    if name == "poly_echo":
        from ..host.configs import build_poly_echo_performance

        return build_poly_echo_performance(seconds=seconds)
    raise _BadRequest(
        404, f"unknown config {name!r}: song | sampler | poly_echo")


def _build_script_job(body: dict):
    """(Performance, total) for a validated /v1/render/script-style job."""
    from ..core.notes import SongEvent
    from ..core.timeline import compile_timelines
    from ..graph.render import Performance
    from ..script import compile_script
    from ..script.jax_backend import ScriptInstrument

    sr = float(body.get("sample_rate", 44100.0))
    seconds = float(body["seconds"])
    polyphony = int(body.get("polyphony", 2))
    notes = body.get("notes", DEFAULT_NOTES)
    extra = {k: (tuple(v) if isinstance(v, list) else v)
             for k, v in dict(body.get("params", {})).items()}
    cs = compile_script(body["script"])
    module = body.get("module")
    if module is None:
        if not cs.exported_modules:
            raise _BadRequest(400, "script exports no modules")
        module = cs.exported_modules[-1].name
    inst = ScriptInstrument(cs, str(module))
    song = []
    for i, note in enumerate(notes):
        t_on, dur, freq = (float(x) for x in note)
        song.append(SongEvent({"freq": np.float32(freq), "note_on": True,
                               **extra}, t=t_on, note_id=i + 1))
        song.append(SongEvent({"freq": np.float32(freq), "note_on": False,
                               **extra}, t=t_on + dur, note_id=i + 1))
    song.sort(key=lambda e: (e.t, e.note_id))
    total = int(seconds * sr)
    tls = compile_timelines(song, polyphony, sr, total)
    return Performance([(inst, tls)], sr), total


class RenderHTTPServer:
    """One-port HTTP render service over the example registry + the
    zangscript compiler. See module docstring for the endpoint table."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        max_seconds: float = 60.0,
        max_script_bytes: int = 65536,
        max_polyphony: int = 64,
        max_notes: int = 512,
        max_concurrent_renders: int = 2,
        cache_entries: int = 32,
        cache_bytes: int = 256 << 20,
        max_stream_seconds: float = 400.0,
        max_batch_jobs: int = 16,
    ) -> None:
        self.max_seconds = float(max_seconds)
        self.max_script_bytes = int(max_script_bytes)
        self.max_polyphony = int(max_polyphony)
        self.max_notes = int(max_notes)
        self.max_stream_seconds = float(max_stream_seconds)
        self.max_batch_jobs = int(max_batch_jobs)
        self._render_sem = threading.Semaphore(max(1, max_concurrent_renders))
        self._cache_entries = int(cache_entries)
        self._cache_bytes = int(cache_bytes)
        self._cache: "OrderedDict[str, bytes]" = OrderedDict()
        self._cache_total = 0
        self._stream_fns: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._inflight = {}  # key -> threading.Event (single-flight)
        self._lock = threading.Lock()
        self.stats_counts = {
            "requests": 0, "renders": 0, "cache_hits": 0,
            "coalesced": 0, "failures": 0,
        }
        self._audio_seconds = 0.0

        srv = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def do_GET(self):
                srv._handle(self, "GET")

            def do_POST(self):
                srv._handle(self, "POST")

        self._tcp = ThreadingHTTPServer((host, port), _Handler)
        self._tcp.daemon_threads = True
        self.host, self.port = self._tcp.server_address[:2]

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        threading.Thread(target=self._tcp.serve_forever, daemon=True).start()

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatch ------------------------------------------------------------

    def _handle(self, h: BaseHTTPRequestHandler, method: str) -> None:
        with self._lock:
            self.stats_counts["requests"] += 1
        url = urlparse(h.path)
        try:
            if method == "GET" and url.path == "/v1/examples":
                self._send_json(h, 200, self._menu())
            elif method == "GET" and url.path == "/v1/stats":
                self._send_json(h, 200, self.stats())
            elif method == "GET" and url.path == "/v1/render":
                self._handle_example(h, parse_qs(url.query))
            elif method == "GET" and url.path == "/v1/render/stream":
                self._handle_stream(h, parse_qs(url.query))
            elif method == "GET" and url.path.startswith("/v1/result/"):
                self._handle_result(h, url.path[len("/v1/result/"):])
            elif method == "POST" and url.path == "/v1/render/script":
                self._handle_script(h)
            elif method == "POST" and url.path == "/v1/render/midi":
                self._handle_midi(h)
            elif method == "POST" and url.path == "/v1/render/batch":
                self._handle_batch(h)
            else:
                raise _BadRequest(404, f"no such endpoint: {method} {url.path}")
        except _BadRequest as e:
            self._send_json(h, e.status, {"error": e.message})
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up mid-response; not a server failure
        except Exception as e:  # noqa: BLE001 — a request must not kill the server
            with self._lock:
                self.stats_counts["failures"] += 1
            self._send_json(h, 500, {"error": f"{type(e).__name__}: {e}"})

    def _menu(self) -> dict:
        from ..host.examples import EXAMPLES
        from ..host.midi import stock_instruments as stock_names

        return {
            "examples": sorted(EXAMPLES),
            "max_seconds": self.max_seconds,
            "endpoints": ["/v1/examples", "/v1/render", "/v1/render/batch",
                          "/v1/render/midi", "/v1/render/script",
                          "/v1/render/stream", "/v1/result/<id>",
                          "/v1/stats"],
            "stream_configs": ["song", "sampler", "poly_echo"],
            "max_stream_seconds": self.max_stream_seconds,
            "midi_instruments": sorted(stock_names()),
        }

    def _handle_example(self, h, q: dict) -> None:
        from ..host.examples import EXAMPLES

        name = q.get("example", [None])[0]
        if not name:
            raise _BadRequest(400, "missing ?example=<name>")
        if name not in EXAMPLES:
            raise _BadRequest(
                404, f"unknown example {name!r}; GET /v1/examples for the menu")
        seconds = self._seconds(q.get("seconds", [None])[0])
        volume = self._volume(q.get("volume", [None])[0])
        key = f"ex:{name}:{seconds}:{volume}"
        wav = self._render_cached(
            key, lambda: _render_example(name, seconds, volume))
        self._send_wav(h, wav)

    def _read_json_body(self, h, slack: int = 65536) -> dict:
        try:
            n = int(h.headers.get("Content-Length", "0"))
        except ValueError:
            raise _BadRequest(400, "bad Content-Length")
        if n <= 0:
            raise _BadRequest(400, "missing request body")
        if n > self.max_script_bytes * 6 + slack:
            raise _BadRequest(413, "request body too large")
        try:
            body = json.loads(h.rfile.read(n))
        except ValueError:
            raise _BadRequest(400, "body must be JSON")
        if not isinstance(body, dict):
            raise _BadRequest(400, "body must be a JSON object")
        return body

    def _handle_script(self, h) -> None:
        from ..script.errors import ScriptError

        body = self._read_json_body(h)
        self._validate_script_body(body)
        volume = self._volume(body.get("volume"))
        key = "script:" + hashlib.sha256(json.dumps(
            {k: body.get(k) for k in ("script", "module", "seconds",
                                      "sample_rate", "polyphony", "notes",
                                      "params")},
            sort_keys=True, default=str).encode()).hexdigest() + f":{volume}"
        try:
            wav = self._render_cached(key, lambda: _render_script(body, volume))
        except ScriptError as e:
            raise _BadRequest(400, str(e))
        self._send_wav(h, wav)

    def _handle_midi(self, h) -> None:
        from ..host.midi import MidiError

        body = self._read_json_body(h)
        raw = body.get("midi_base64")
        if not isinstance(raw, str):
            raise _BadRequest(
                400, 'body must be {"midi_base64": "<base64 SMF>", ...}')
        import base64

        try:
            data = base64.b64decode(raw, validate=True)
        except Exception:  # noqa: BLE001 — binascii.Error subclasses vary
            raise _BadRequest(400, "midi_base64 is not valid base64")
        if len(data) > self.max_script_bytes * 4:
            raise _BadRequest(413, "MIDI file too large")
        # a long file (or one with huge delta ticks) must not exceed the
        # service's render budget even without an explicit seconds field
        body["seconds"] = self._seconds(body.get("seconds")) or self.max_seconds
        if body.get("group", "channel") not in ("channel", "track"):
            raise _BadRequest(400, "group must be 'channel' or 'track'")
        try:
            body["transpose"] = int(body.get("transpose", 0))
        except (TypeError, ValueError):
            raise _BadRequest(400, "transpose must be an integer")
        if not -96 <= body["transpose"] <= 96:
            raise _BadRequest(400, "transpose must be in [-96, 96]")
        volume = self._volume(body.get("volume"))
        body["_midi_bytes"] = data
        body["_max_parts"] = 16  # mirror MIDI's channel count
        body["_max_events"] = max(self.max_notes * 8, 4096)
        key = "midi:" + hashlib.sha256(json.dumps(
            {k: body.get(k) for k in ("midi_base64", "instrument", "seconds",
                                      "group", "velocity", "transpose",
                                      "with_drums")},
            sort_keys=True, default=str).encode()).hexdigest() + f":{volume}"
        try:
            wav = self._render_cached(key, lambda: _render_midi(body, volume))
        except MidiError as e:
            raise _BadRequest(400, str(e))
        self._send_wav(h, wav)

    def _handle_stream(self, h, q: dict) -> None:
        """Streamed long render: the WAV's exact byte length is known up
        front (fixed total frames), so the response carries a normal
        Content-Length while the body is written chunk by chunk as the
        piece renders — a curl of the 385 s Bach render starts playing
        within the first chunk instead of after the full render."""
        from ..core.mixdown import mixdown_s16_np
        from ..core.wav import wav_header_s16

        name = q.get("config", [None])[0]
        if not name:
            raise _BadRequest(400, "missing ?config=<song|sampler|poly_echo>")
        raw = q.get("seconds", [None])[0]
        try:
            seconds = float(raw) if raw is not None else self.max_stream_seconds
        except (TypeError, ValueError):
            raise _BadRequest(400, "seconds must be a number")
        if not 0.0 < seconds <= self.max_stream_seconds:
            raise _BadRequest(
                400, f"seconds must be in (0, {self.max_stream_seconds}]")
        volume = self._volume(q.get("volume", [None])[0])
        # Build + compile + render the FIRST chunk before sending headers.
        # jax.jit compiles lazily on the first call, so only a completed
        # first step proves the graph compiles and the device answers —
        # failures here still produce a clean JSON error response through
        # _handle's handler instead of a truncated 200 WAV.
        perf, total, stream = self._stream_cached(name, seconds)
        with self._render_sem:
            block = next(stream, None)
        channels = perf.num_channels
        sr = int(perf.sample_rate)
        data_bytes = total * channels * 2
        h.send_response(200)
        h.send_header("Content-Type", "audio/wav")
        h.send_header("Content-Length", str(44 + data_bytes))
        h.end_headers()
        h.wfile.write(wav_header_s16(sr, channels, total))
        sent = 0
        try:
            while block is not None:
                pcm = mixdown_s16_np(block, volume)
                # WAV interleaves channels per frame
                h.wfile.write(
                    np.ascontiguousarray(pcm.T).tobytes())
                h.wfile.flush()
                sent += block.shape[1]
                # hold a render slot only while the device works: the body
                # write above is paced by the client's TCP window, and a
                # slow consumer (curl | aplay at 1x realtime) must not pin
                # one of the few slots for the whole piece
                with self._render_sem:
                    block = next(stream, None)
        except (BrokenPipeError, ConnectionResetError):
            h.close_connection = True
            return  # client hung up: stop rendering
        except Exception:  # noqa: BLE001 — headers are already out:
            # writing a JSON error now would inject a second response
            # into the fixed-length WAV body; abort the connection so
            # the client sees a short read instead of garbage audio
            h.close_connection = True
            with self._lock:
                self.stats_counts["failures"] += 1
            return
        with self._lock:
            self.stats_counts["renders"] += 1
            self._audio_seconds += sent / float(sr)

    # tiny LRU of (perf, total, jitted step) per (config, seconds): a
    # repeated stream request reuses the compiled step instead of paying
    # the trace+compile again while holding a render slot
    _STREAM_CACHE_ENTRIES = 4

    def _stream_cached(self, name: str, seconds: float):
        from ..graph.render import make_stream_step, stream_blocks

        key = (name, float(seconds))
        ikey = ("stream", key)
        # single-flight on the miss: concurrent first requests must share
        # ONE jitted step object — jax.jit then serializes the compile
        # internally, so the compile is paid once, not per
        # request (same mechanism as _render_cached's _inflight)
        counted_coalesced = False
        while True:
            with self._lock:
                hit = self._stream_fns.get(key)
                if hit is not None:
                    self._stream_fns.move_to_end(key)
                    perf, total, step = hit
                    return perf, total, stream_blocks(
                        perf, total, step, chunk_size=65536)
                ev = self._inflight.get(ikey)
                if ev is None:
                    self._inflight[ikey] = threading.Event()
                    break
                if not counted_coalesced:
                    # once per REQUEST: a wait timeout loops back here
                    # (a long compile can exceed one 600 s wait) and must
                    # not re-count
                    self.stats_counts["coalesced"] += 1
                    counted_coalesced = True
            ev.wait(timeout=600.0)
        try:
            perf, total = _build_config(name, seconds)
            step = make_stream_step(perf, chunk_size=65536)
            with self._lock:
                self._stream_fns[key] = (perf, total, step)
                while len(self._stream_fns) > self._STREAM_CACHE_ENTRIES:
                    self._stream_fns.popitem(last=False)
        finally:
            with self._lock:
                self._inflight.pop(ikey).set()
        return perf, total, stream_blocks(perf, total, step,
                                          chunk_size=65536)

    def _handle_batch(self, h) -> None:
        """Tier-3 over HTTP: run N jobs through the BatchRenderer (shared
        compiled graphs for same-structure songs), answer per-job statuses
        with result URLs into the response cache."""
        import tempfile

        from .batch import BatchRenderer, RenderJob

        body = self._read_json_body(h)
        jobs_in = body.get("jobs")
        if not isinstance(jobs_in, list) or not jobs_in:
            raise _BadRequest(400, 'body must be {"jobs": [...]}')
        if len(jobs_in) > self.max_batch_jobs:
            raise _BadRequest(413, f"at most {self.max_batch_jobs} jobs")
        volume = self._volume(body.get("volume"))
        jobs = []
        for i, job in enumerate(jobs_in):
            if not isinstance(job, dict):
                raise _BadRequest(400, f"job {i} must be an object")
            name = str(job.get("name") or f"job_{i:02d}")
            if "config" in job:
                raw = job.get("seconds")
                try:
                    seconds = (float(raw) if raw is not None
                               else self.max_seconds)
                except (TypeError, ValueError):
                    raise _BadRequest(400, f"job {i}: seconds must be a number")
                if not 0.0 < seconds <= self.max_stream_seconds:
                    raise _BadRequest(
                        400, f"job {i}: seconds must be in "
                             f"(0, {self.max_stream_seconds}]")
                cfg = str(job["config"])
                if cfg not in ("song", "sampler", "poly_echo"):
                    raise _BadRequest(
                        400, f"job {i}: unknown config {cfg!r}")
                jobs.append(RenderJob(
                    name=name,
                    build=(lambda c=cfg, s=seconds: _build_config(c, s)),
                    volume=volume))
            elif "script" in job:
                jb = dict(job)
                self._validate_script_body(jb, job_label=f"job {i}: ")
                jobs.append(RenderJob(
                    name=name,
                    build=(lambda b=jb: _build_script_job(b)),
                    volume=volume))
            else:
                raise _BadRequest(
                    400, f"job {i} needs a \"config\" or \"script\" field")
        with self._render_sem, tempfile.TemporaryDirectory() as out:
            br = BatchRenderer(out_dir=out, chunk_size=65536)
            # per-job failures (incl. ScriptError from a bad script body)
            # come back as status="failed" results — the batch contract is
            # per-job statuses, never a whole-batch 400
            results = br.run(jobs)
            wavs = {}
            for r in results:
                if r.status == "ok" and r.wav_path:
                    with open(r.wav_path, "rb") as f:
                        wavs[r.name] = f.read()
        resp = []
        protected = set()  # this response's keys: evicting a result whose
        # URL the client hasn't even received yet would make the response
        # a lie (one oversized batch can exceed cache_bytes on its own;
        # the transient overshoot is bounded by one batch and becomes
        # evictable as soon as later insertions arrive)
        for r in results:
            entry = {"name": r.name, "status": r.status,
                     "seconds": round(r.seconds, 3),
                     "rtf": round(r.rtf, 2), "error": r.error}
            if r.name in wavs:
                wav = wavs[r.name]
                rid = hashlib.sha256(wav).hexdigest()[:24]
                with self._lock:
                    key = "result:" + rid
                    protected.add(key)
                    if key not in self._cache:
                        self._cache[key] = wav
                        self._cache_total += len(wav)
                    evictable = [k for k in self._cache
                                 if k not in protected]
                    while evictable and (
                            len(self._cache) > self._cache_entries
                            or self._cache_total > self._cache_bytes):
                        old = self._cache.pop(evictable.pop(0))
                        self._cache_total -= len(old)
                    self.stats_counts["renders"] += 1
                    self._audio_seconds += r.seconds
                entry["url"] = f"/v1/result/{rid}"
            resp.append(entry)
        self._send_json(h, 200, {"results": resp})

    def _validate_script_body(self, body: dict, job_label: str = "") -> None:
        """Shared bounds for /v1/render/script bodies and batch script
        jobs (mutates body: normalized seconds)."""
        if not isinstance(body.get("script"), str):
            raise _BadRequest(
                400, job_label + 'needs {"script": "<zangscript>", ...}')
        if len(body["script"].encode()) > self.max_script_bytes:
            raise _BadRequest(413, job_label + "script too large")
        body["seconds"] = self._seconds(body.get("seconds")) or 4.0
        poly = int(body.get("polyphony", 2))
        if not 1 <= poly <= self.max_polyphony:
            raise _BadRequest(
                400, job_label
                + f"polyphony must be in 1..{self.max_polyphony}")
        try:
            sr = float(body.get("sample_rate", 44100.0))
        except (TypeError, ValueError):
            raise _BadRequest(400, job_label + "sample_rate must be a number")
        if not 1.0 <= sr <= 192000.0:
            raise _BadRequest(
                400, job_label + "sample_rate must be in [1, 192000]")
        notes = body.get("notes", DEFAULT_NOTES)
        if not isinstance(notes, (list, tuple)) or len(notes) > self.max_notes:
            raise _BadRequest(
                400, job_label + f"notes must be a list of <= {self.max_notes}")
        for note in notes:
            if (not isinstance(note, (list, tuple)) or len(note) != 3
                    or not all(isinstance(x, (int, float)) for x in note)):
                raise _BadRequest(
                    400, job_label
                    + "each note must be [t_on, duration, freq] numbers")

    def _handle_result(self, h, rid: str) -> None:
        with self._lock:
            wav = self._cache.get("result:" + rid)
            if wav is not None:
                self._cache.move_to_end("result:" + rid)
                self.stats_counts["cache_hits"] += 1
        if wav is None:
            raise _BadRequest(
                404, "no such result (evicted? re-POST the batch)")
        self._send_wav(h, wav)

    # -- rendering + cache -----------------------------------------------------

    def _render_cached(self, key: str, render) -> bytes:
        while True:
            with self._lock:
                wav = self._cache.get(key)
                if wav is not None:
                    self._cache.move_to_end(key)
                    self.stats_counts["cache_hits"] += 1
                    return wav
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    break
                self.stats_counts["coalesced"] += 1
            ev.wait(timeout=600.0)  # single-flight: wait for the renderer
        try:
            with self._render_sem:
                wav = render()
            with self._lock:
                self.stats_counts["renders"] += 1
                self._audio_seconds += self._wav_seconds(wav)
                self._cache[key] = wav
                self._cache_total += len(wav)
                while (len(self._cache) > self._cache_entries
                       or self._cache_total > self._cache_bytes):
                    _, old = self._cache.popitem(last=False)
                    self._cache_total -= len(old)
            return wav
        # failed renders are counted once, by _handle's generic handler
        # (ScriptError becomes a 400 client error, deliberately not counted)
        finally:
            with self._lock:
                self._inflight.pop(key).set()

    @staticmethod
    def _wav_seconds(wav: bytes) -> float:
        import struct

        if len(wav) < 44:
            return 0.0
        byte_rate = struct.unpack_from("<I", wav, 28)[0]
        return (len(wav) - 44) / byte_rate if byte_rate else 0.0

    def _seconds(self, raw) -> Optional[float]:
        if raw is None:
            return None
        try:
            s = float(raw)
        except (TypeError, ValueError):
            raise _BadRequest(400, "seconds must be a number")
        if not 0.0 < s <= self.max_seconds:
            raise _BadRequest(
                400, f"seconds must be in (0, {self.max_seconds}]")
        return s

    @staticmethod
    def _volume(raw) -> float:
        if raw is None:
            return 0.25
        try:
            v = float(raw)
        except (TypeError, ValueError):
            raise _BadRequest(400, "volume must be a number")
        if not 0.0 <= v <= 1.0:
            raise _BadRequest(400, "volume must be in [0, 1]")
        return v

    # -- responses -------------------------------------------------------------

    @staticmethod
    def _send_wav(h, wav: bytes) -> None:
        h.send_response(200)
        h.send_header("Content-Type", "audio/wav")
        h.send_header("Content-Length", str(len(wav)))
        h.end_headers()
        h.wfile.write(wav)

    @staticmethod
    def _send_json(h, status: int, obj: dict) -> None:
        data = json.dumps(obj).encode()
        try:
            h.send_response(status)
            h.send_header("Content-Type", "application/json")
            h.send_header("Content-Length", str(len(data)))
            if status >= 400:
                # an error may leave a POST body unread on a keep-alive
                # connection; close so the leftover bytes can't be parsed
                # as the next request line
                h.send_header("Connection", "close")
                h.close_connection = True
            h.end_headers()
            h.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def stats(self) -> dict:
        with self._lock:
            return {
                **self.stats_counts,
                "cached_entries": len(self._cache),
                "cached_bytes": self._cache_total,
                "audio_seconds_rendered": round(self._audio_seconds, 3),
            }


def main(argv=None) -> int:
    """CLI: python -m zang_tpu.serve.http --port 9801"""
    import argparse

    from ..platform import enable_compile_cache

    enable_compile_cache()

    ap = argparse.ArgumentParser(
        prog="zang-http",
        description="HTTP WAV render service (examples + zangscript).")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9801)
    ap.add_argument("--max-seconds", type=float, default=60.0)
    ap.add_argument("--renders", type=int, default=2,
                    help="max concurrent renders")
    args = ap.parse_args(argv)
    srv = RenderHTTPServer(host=args.host, port=args.port,
                           max_seconds=args.max_seconds,
                           max_concurrent_renders=args.renders)
    srv.start()
    print(f"zang-http serving on http://{srv.host}:{srv.port} "
          f"(GET /v1/examples for the menu)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
