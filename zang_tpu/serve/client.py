"""Interactive terminal client for LiveServer: play the synth from stdin.

The reference's interactive host is an SDL event loop — key-downs/ups
push impulses, the audio callback streams blocks out, backquote toggles
the note recorder (examples/example.zig:393-400,423-440). This is that
loop as a network client of the serving tier: raw-mode terminal keys
map through the same two-row keyboard layout (host/keyboard.py,
examples/common.zig:24-66), audio blocks stream back over TCP, and an
optional WAV capture plays the write_wav role on the client side.

Terminals deliver no key-release events (SDL did), so note-offs are
emulated with a gate timer: each press schedules its release --gate
seconds later, and re-pressing a held key retriggers it (off + on), the
same impulse sequence the SDL host produced for a physical re-press.

Keys: two-row musical layout plays notes; "`" cycles the keypress
recorder — record a performance, loop it back into the lane, off
(examples/recorder.zig semantics, including held-key drains at mode
changes and loop seams); "~" toggles a server-side WAV take (an
addition beyond the reference); "1" prints serving stats;
"2" cycles the live visual (VU bar -> one-line waveform/spectrum/scope
sparklines -> the full panels); F1-F6 jump straight to the reference's
visualizer screens (examples/visual.zig:943-1231): F1 help, F2 main
(waveform + spectrum), F3 synced oscilloscope, F4 full FFT, F5 params
overlay, F6 back to the VU bar — re-pressing a panel's key toggles it
off, as the reference does. Up/Down select a live parameter, Left/Right
step it, Backspace randomizes them all (the reference's Parameter
panel, examples/example.zig:324-392); Esc / Ctrl-C / Ctrl-D quit. Pipe
mode accepts UP/DOWN/LEFT/RIGHT/BS/F1..F6 tokens.

Run a server first (python -m zang_tpu.serve.server), then:
    python -m zang_tpu.serve.client --port 9800 --wav take.wav
"""

import sys
import threading
import time
from typing import Optional

import numpy as np

from ..core.wav import StreamingWavWriter
from ..host.interaction import Recorder
from ..host.keyboard import get_key_rel_freq
from .server import LiveClient, _send_json


class TerminalPlayer:
    """Drives one LiveServer lane: presses in, audio/VU/WAV out.

    Owns the socket reader (one thread demuxes block + control frames —
    LiveClient's pull-style readers assume a single consumer). press() is
    called from any thread (the stdin loop in main(), tests directly).
    """

    def __init__(
        self,
        client: LiveClient,
        part: int = 0,
        gate: float = 0.3,
        wav_path: Optional[str] = None,
        quiet: bool = False,
        auto_resume: Optional[tuple] = None,
        sink_cmd: Optional[str] = None,
    ) -> None:
        self.client = client
        self.part = int(part)
        self.gate = float(gate)
        self.quiet = quiet
        # (host, port): on a dropped connection, reconnect and resume the
        # session with the welcome frame's token (servers retain blipped
        # sessions for resume_ttl seconds)
        self.auto_resume = auto_resume
        self.resumes = 0
        self.blocks_received = 0
        self.level = 0.0  # peak of the last block, 0..1
        self.recording_file: Optional[str] = None
        self.last_stats: Optional[dict] = None
        # live visual mode (the reference's F1-F6 visualizer modes,
        # examples/visual.zig:943-1231, on one terminal line): None = VU
        # bar, else "wave" | "spec" | "scope" sparklines of each block
        self.visual_mode: Optional[str] = None
        self._panel_height = 0  # lines of the last multi-line panel drawn
        # live parameter panel state (filled by the "params" ack)
        self.param_specs: Optional[list] = None
        self.param_values: Optional[dict] = None
        self.param_sel = 0
        self._timers = {}  # key -> threading.Timer
        self._rec_pending = False  # record toggle awaiting its ack
        self._lock = threading.Lock()  # timers + wav writer + recorder
        self._stop = threading.Event()
        # the reference's backquote keypress recorder (recorder.zig +
        # example.zig:393-400): record a performance, loop it back into
        # the lane. Pumped by a dedicated thread (the SDL host pumped it
        # from its event loop, example.zig:486-526).
        self.recorder = Recorder()
        self._rec_thread = threading.Thread(
            target=self._recorder_pump, daemon=True)
        self._rec_thread.start()
        self._full_scale = (
            32767.0 if client.welcome["dtype"] == "int16" else 1.0)
        self._wav = None
        if wav_path:
            self._wav = StreamingWavWriter(
                wav_path, int(client.welcome["sample_rate"]),
                num_channels=int(client.welcome["num_channels"]))
        # local audio sink (the reference host plays through an SDL audio
        # device, example.zig:197-222; here: pipe interleaved s16 frames
        # into any player command, e.g. --sink 'aplay -f S16_LE -c 1
        # -r 48000'). Non-blocking with bounded buffering: a stalled sink
        # drops audio instead of stalling the reader (the serving tier's
        # at-cap degrade rule).
        self._sink = None
        self._sink_pending = bytearray()
        self._sink_frame_bytes = 2 * int(client.welcome["num_channels"])
        self._sink_cap = (int(client.welcome["block_size"])
                          * self._sink_frame_bytes * 8)
        self.sink_dropped_bytes = 0
        if sink_cmd:
            import subprocess
            self._sink = subprocess.Popen(
                sink_cmd, shell=True, stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            import os as _os
            _os.set_blocking(self._sink.stdin.fileno(), False)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # -- input --------------------------------------------------------------

    def press(self, key: str) -> None:
        """Key-down now, auto-release after the gate (retrigger if held).
        Events during a connection outage are dropped (MIDI discipline) —
        the reader thread handles reconnection."""
        with self._lock:
            try:
                t = self._timers.pop(key, None)
                if t is not None:
                    t.cancel()
                    self.client.send_key(self.part, key, False)
                    self._note_event(key, False)
                self.client.send_key(self.part, key, True)
                self._note_event(key, True)
            except OSError:
                return
            timer = threading.Timer(self.gate, self._auto_release, (key,))
            timer.daemon = True
            self._timers[key] = timer
            timer.start()

    def release(self, key: str) -> None:
        with self._lock:
            t = self._timers.pop(key, None)
            if t is not None:
                t.cancel()
                try:
                    self.client.send_key(self.part, key, False)
                    self._note_event(key, False)
                except OSError:
                    pass

    def _auto_release(self, key: str) -> None:
        with self._lock:
            if self._timers.pop(key, None) is not None:
                try:
                    self.client.send_key(self.part, key, False)
                    self._note_event(key, False)
                except OSError:
                    pass

    # -- keypress recorder (recorder.zig, the reference's backquote) ---------

    def _note_event(self, key: str, down: bool) -> None:
        """Feed a live key event to the recorder (example.zig:434-435:
        only events the instrument accepted — here: layout-mapped keys —
        are recorded and held-tracked). Caller holds _lock."""
        if get_key_rel_freq(key) is None:
            return
        self.recorder.record_event(time.monotonic(), key, down)
        self.recorder.track_event(key, down)

    def cycle_recorder(self) -> None:
        """The backquote press (example.zig:393-400): cycle the keypress
        recorder idle -> recording -> loop-playback -> off. The state
        transition (and the held-key drain that precedes it) runs on the
        pump thread's next poll."""
        with self._lock:
            self.recorder.cycle_mode()

    def _recorder_pump(self) -> None:
        """The reference host's recorderPlayback pump (example.zig:
        486-526): due playback events feed the lane exactly like live
        keypresses; every event that lands is held-tracked so loop seams
        and mode changes can drain it."""
        last_state = "idle"
        while not self._stop.is_set():
            time.sleep(0.01)
            with self._lock:
                rec = self.recorder
                for key, down in rec.poll(time.monotonic()):
                    try:
                        self.client.send_key(self.part, key, down)
                    except OSError:
                        break  # outage: reader reconnects; events drop
                    rec.track_event(key, down)
                state, n, loop_s = (rec.state, len(rec.events),
                                    rec.loop_seconds)
            if state != last_state:
                last_state = state
                if state == "recording":
                    self._note("recorder: recording (` again to loop)")
                elif state == "playing":
                    self._note(f"recorder: looping {n} events / "
                               f"{loop_s:.2f}s (` to stop)")
                else:
                    self._note("recorder: off")

    def toggle_recording(self) -> None:
        """Backquote behavior: start a server-side take, or stop it.
        Toggles while an ack is in flight are dropped (a duplicate
        record_start is a protocol error that would close the lane)."""
        with self._lock:  # the lock also serializes socket writes — an
            # interleaved send from a gate Timer thread would corrupt the
            # JSON framing
            if self._rec_pending:
                return
            op = "record_stop" if self.recording_file else "record_start"
            try:
                _send_json(self.client.sock, {"op": op})
            except OSError:  # outage: drop the toggle, reader reconnects
                return
            self._rec_pending = True
        # the ack arrives on the reader thread (_read_loop prints it)

    def request_stats(self) -> None:
        with self._lock:
            try:
                _send_json(self.client.sock, {"op": "stats"})
            except OSError:
                pass

    # -- live parameters (reference panel, examples/example.zig:324-392:
    # Up/Down select, Left/Right step, Backspace randomizes) ----------------

    def _ensure_params(self) -> bool:
        """Fetch the part's specs once; False if the instrument has none.
        The ack lands on the reader thread; wait briefly for it."""
        if self.param_specs is not None:
            return len(self.param_specs) > 0
        with self._lock:
            try:
                _send_json(self.client.sock,
                           {"op": "params", "part": self.part})
            except OSError:
                return False
        deadline = time.monotonic() + 5.0
        while self.param_specs is None and time.monotonic() < deadline:
            time.sleep(0.02)
        if self.param_specs is None:
            return False
        if not self.param_specs:
            self._note("instrument has no live parameters")
            return False
        return True

    def param_select(self, delta: int) -> None:
        """Up/Down: move the selection through the panel."""
        if not self._ensure_params():
            return
        self.param_sel = (self.param_sel + delta) % len(self.param_specs)
        self._print_param()

    def param_step(self, delta: int) -> None:
        """Left/Right: step the selected parameter (server clamps)."""
        if not self._ensure_params():
            return
        name = self.param_specs[self.param_sel]["name"]
        with self._lock:
            try:
                _send_json(self.client.sock,
                           {"op": "step_param", "part": self.part,
                            "name": name, "delta": int(delta)})
            except OSError:
                pass
        # the ack updates param_values and reprints on the reader thread

    def param_randomize(self) -> None:
        """Backspace: randomize every parameter (example.zig:373-391)."""
        if not self._ensure_params():
            return
        with self._lock:
            try:
                _send_json(self.client.sock,
                           {"op": "randomize_params", "part": self.part})
            except OSError:
                pass

    def _print_param(self) -> None:
        if not self.param_specs or self.param_values is None:
            return
        if self.visual_mode == "params":
            return  # the params panel redraws with every block
        s = self.param_specs[self.param_sel]
        val = self.param_values.get(s["name"], 0)
        desc = (s.get("desc") or s["name"]).strip()
        self._note(f"[{self.param_sel + 1}/{len(self.param_specs)}] "
                   f"{desc} {val} (0..{s['num_values'] - 1})")

    # -- output -------------------------------------------------------------

    def _read_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._read_frames()
                return
            except (EOFError, OSError, RuntimeError) as e:
                if self._stop.is_set():
                    return
                if self.auto_resume is not None and self._reconnect():
                    continue  # keep reading on the new connection
                self._note(f"server closed: {e}")
                self._stop.set()
                return

    def _read_frames(self) -> None:
        last_vu = 0.0
        while not self._stop.is_set():
            # frames can queue INSIDE the LiveClient while resume()/
            # read_control() scans for an ack (blocks start streaming right
            # after the welcome) — drain those first or they'd be silently
            # dropped (gaps in the WAV capture) after a reconnect
            c = self.client
            if c._pending_blocks:
                kind, v = "block", c._pending_blocks.pop(0)
            elif c._pending_ctrl:
                v = c._pending_ctrl.pop(0)
                kind = v.get("op")
            else:
                kind, v = c._next_frame()
            if kind == "block":
                self.blocks_received += 1
                self.level = float(np.abs(v).max()) / self._full_scale
                if self._wav is not None:
                    with self._lock:
                        if self._wav is not None:
                            self._wav.append(self._to_i16(v))
                if self._sink is not None:
                    self._sink_write(self._to_i16(v))
                now = time.monotonic()
                if not self.quiet and now - last_vu > 0.1:
                    last_vu = now
                    if self.visual_mode is None:
                        self._print_vu()
                    elif self.visual_mode in self._PANEL_MODES:
                        self._print_panel(v)
                    else:
                        self._print_visual(v)
            elif kind == "record_started":
                with self._lock:
                    self.recording_file = v["file"]
                    self._rec_pending = False
                self._note(f"recording -> {v['file']}")
            elif kind == "record_stopped":
                with self._lock:
                    self.recording_file = None
                    self._rec_pending = False
                self._note(
                    f"take saved: {v['file']} ({v['seconds']:.2f}s)")
            elif kind == "params":
                if v.get("specs") is not None:
                    self.param_specs = v["specs"]
                if self.param_values is None:
                    self.param_values = dict(v.get("values") or {})
                else:  # randomize ack: every value changed
                    self.param_values.update(v.get("values") or {})
                    self._print_param()
            elif kind == "param":
                if self.param_values is not None:
                    self.param_values[v["name"]] = v["value"]
                self._print_param()
            elif kind == "stats":
                self.last_stats = v
                self._note(
                    f"lanes {v['lanes']} clients {v['clients']} "
                    f"block {v['block_time_ms']}ms / "
                    f"budget {v['block_budget_ms']}ms "
                    f"(headroom {v['realtime_headroom']}x)")

    def _reconnect(self) -> bool:
        """Reconnect and resume the session after a dropped connection.
        Returns True on success.

        The backoff must outlast the SERVER's blip detection: on an
        asymmetric drop the server only retains the session once its block
        send fails (socket buffer fill + send_timeout — seconds), so early
        attempts legitimately see 'unknown token' and must keep trying."""
        host, port = self.auto_resume
        token = self.client.welcome.get("resume_token")
        if not token:
            return False
        for attempt in range(6):  # ~0.25..8 s, ~16 s total
            time.sleep(min(0.25 * 2 ** attempt, 8.0))
            if self._stop.is_set():
                return False
            fresh = None
            try:
                # same instrument: resume tokens are per-fleet on a
                # multi-instrument server
                fresh = LiveClient(host, port, timeout=10.0,
                                   instrument=self.client.instrument)
                fresh.sock.settimeout(300.0)  # normal read timeout
                frame = fresh.resume(token)
            except (OSError, EOFError, RuntimeError, AssertionError):
                if fresh is not None:
                    try:
                        fresh.sock.close()
                    except OSError:
                        pass
                continue
            with self._lock:
                if self._stop.is_set():  # stop() won while we reconnected
                    try:
                        fresh.close()
                    except OSError:
                        pass
                    return False
                try:
                    self.client.sock.close()
                except OSError:
                    pass
                self.client = fresh
                self.resumes += 1
            self._note(f"connection dropped — resumed at frame {frame}")
            return True
        return False

    def _sink_write(self, block_i16: np.ndarray) -> None:
        """Feed [channels, n] s16 to the sink as interleaved frames.
        Writes are non-blocking; when the sink falls behind, the OLDEST
        buffered audio is dropped (frame-aligned) so live play stays
        current — the same degrade-not-stall rule the serving fleet uses.
        Only the reader thread calls this."""
        import os as _os

        sink = self._sink
        if sink is None:
            return
        pend = self._sink_pending
        pend += block_i16.T.tobytes()  # [n, C] -> interleaved
        if len(pend) > self._sink_cap:
            drop = len(pend) - self._sink_cap
            drop -= drop % self._sink_frame_bytes
            self.sink_dropped_bytes += drop
            del pend[:drop]
        try:
            while pend:
                n = _os.write(sink.stdin.fileno(), pend)
                del pend[:n]
        except BlockingIOError:
            pass  # sink busy: keep the (bounded) remainder for next block
        except (BrokenPipeError, OSError, ValueError):
            self._note("audio sink exited — disabling --sink")
            self._sink = None
            try:
                sink.stdin.close()
            except OSError:
                pass

    def _to_i16(self, block: np.ndarray) -> np.ndarray:
        if block.dtype == np.int16:
            return block
        from ..core.mixdown import mixdown_s16_np

        return mixdown_s16_np(block, 1.0)

    # one-line sparkline modes, then the reference's full panels
    # (examples/visual.zig:943-1231: F1 help, F2 main, F3 oscilloscope,
    # F4 full FFT, F5 params)
    _VISUAL_MODES = (None, "wave", "spec", "scope",
                     "help", "main", "oscope", "fft", "params")
    _PANEL_MODES = ("help", "main", "oscope", "fft", "params")
    _SPARK = " ▁▂▃▄▅▆▇█"
    PANEL_WIDTH = 64
    PANEL_ROWS = 6  # raster height of the wave/spectrum/scope grids

    def cycle_visual(self) -> None:
        """Step through every visual mode on one key (terminals that
        swallow F-keys still reach the panels this way)."""
        modes = self._VISUAL_MODES
        self.set_visual(modes[(modes.index(self.visual_mode) + 1)
                              % len(modes)])

    def set_visual(self, mode) -> None:
        """Select a visual mode directly (F1-F6 analog: "help", "main",
        "oscope", "fft", "params"; None = VU bar)."""
        if mode == self.visual_mode:
            mode = None  # reference toggles a panel off on its own key
        prev_panel = self._panel_height
        self.visual_mode = mode
        self._panel_height = 0
        if prev_panel and not self.quiet:
            sys.stderr.write("\n")
            sys.stderr.flush()
        if mode == "params":
            self._ensure_params()
        self._note(f"visual: {mode or 'vu'}")

    @classmethod
    def _spark(cls, vals) -> str:
        """0..1 values -> block-character sparkline."""
        q = np.clip((np.asarray(vals) * 8.999).astype(int), 0, 8)
        return "".join(cls._SPARK[i] for i in q)

    @classmethod
    def _raster(cls, vals, rows: int) -> list:
        """0..1 values -> `rows` terminal lines of a column bar raster
        (top row = 1.0). Each column fills from the bottom with a partial
        block character at the boundary row."""
        v = np.clip(np.asarray(vals, np.float64), 0.0, 1.0) * rows
        lines = []
        for r in range(rows - 1, -1, -1):  # top row first
            frac = np.clip(v - r, 0.0, 1.0)
            q = np.clip((frac * 8.999).astype(int), 0, 8)
            lines.append("".join(cls._SPARK[i] for i in q))
        return lines

    @classmethod
    def _raster_bipolar(cls, vals, rows: int) -> list:
        """-1..1 waveform -> `rows` lines drawn around a center line."""
        return cls._raster(np.asarray(vals) * 0.5 + 0.5, rows)

    def _sync_freq(self, x: np.ndarray, sr: float):
        """Estimate the playing frequency from upward zero crossings (the
        reference syncs its oscilloscope to the synth's sync channel,
        visual.zig DrawOscilloscope; the wire carries audio only)."""
        sign = np.signbit(x)
        ups = np.nonzero(sign[:-1] & ~sign[1:])[0]
        if len(ups) < 3:
            return None
        period = float(np.median(np.diff(ups)))
        if period < 2.0:
            return None
        return sr / period

    # -- full panels (reference F1-F6 screens, visual.zig:943-1231) ---------

    def render_panel(self, block) -> list:
        """The current panel as a list of terminal lines (pure compute —
        tests assert on this; _print_panel does the ANSI redraw)."""
        from ..host import visual as vz

        mode = self.visual_mode
        W = self.PANEL_WIDTH
        R = self.PANEL_ROWS
        if mode == "help":
            return [
                "── help ─ keys ────────────────────────────────",
                " two-row layout plays notes   1 stats",
                " ` record/loop-playback   ~ WAV take",
                " 2 cycle visuals   F1 help  F2 main  F3 scope",
                " F4 full FFT  F5 params (Up/Down select,",
                " Left/Right step, Backspace randomize)   Esc quit",
            ]
        if mode == "params":
            lines = ["── params ─────────────────────────────────────"]
            if not self.param_specs:
                lines.append(" (instrument has no live parameters)")
                return lines
            vals = self.param_values or {}
            for i, s in enumerate(self.param_specs):
                mark = ">" if i == self.param_sel else " "
                desc = (s.get("desc") or s["name"]).strip()
                lines.append(f"{mark} {desc:<38.38s} "
                             f"{vals.get(s['name'], 0):>4} "
                             f"(0..{s['num_values'] - 1})")
            return lines
        x = np.asarray(block[0], np.float32) / self._full_scale
        sr = float(self.client.welcome["sample_rate"])
        if mode == "main":
            # waveform envelope + spectrum, the reference's main screen
            cols = vz.waveform_frame(x, width=W)
            env = np.abs(cols).max(axis=1)
            mag = vz.spectrum_frame(x)
            edges = (np.arange(W + 1) * len(mag)) // W
            bins = np.array([mag[a:b].max() if b > a else 0.0
                             for a, b in zip(edges[:-1], edges[1:])])
            spec = np.clip(bins / np.log1p(len(mag)), 0.0, 1.0)
            lines = ["── main ─ waveform ────────────────────────────"]
            lines += self._raster(env, max(2, R // 2))
            lines.append("── spectrum ───────────────────────────────────")
            lines += self._raster(spec, max(2, R // 2))
            lines.append(self._status_line())
            return lines
        if mode == "oscope":
            win = vz.oscilloscope_frame(x, self._sync_freq(x, sr), sr,
                                        width=W)
            lines = ["── oscilloscope (synced) ──────────────────────"]
            lines += self._raster_bipolar(win, R)
            lines.append(self._status_line())
            return lines
        # full FFT: log-frequency bins over the whole spectrum
        mag = vz.spectrum_frame(x, fft_size=1024)
        nb = len(mag)
        # logarithmic bin edges (the reference's full-FFT view is log-x)
        edges = np.unique(np.clip(
            np.round(np.exp(np.linspace(0, np.log(nb), W + 1))).astype(int),
            1, nb))
        bins = np.zeros(W)
        for c in range(min(W, len(edges) - 1)):
            a, b = edges[c], edges[c + 1]
            bins[c] = mag[a:b].max() if b > a else (mag[a - 1] if a <= nb else 0)
        vals = np.clip(bins / np.log1p(nb), 0.0, 1.0)
        lines = ["── full FFT (log f) ───────────────────────────"]
        lines += self._raster(vals, R)
        lines.append(self._status_line())
        return lines

    def _status_line(self) -> str:
        rec = " REC" if self.recording_file else ""
        if self.recorder.state == "recording":
            rec += " `rec"
        elif self.recorder.state == "playing":
            rec += " `loop"
        return ("level %5.1f%%  blocks %d%s"
                % (min(self.level, 1.0) * 100, self.blocks_received, rec))

    def _print_panel(self, block) -> None:
        lines = self.render_panel(block)
        out = []
        if self._panel_height:
            out.append("\x1b[%dA" % self._panel_height)  # cursor up
        for ln in lines:
            out.append("\r\x1b[K" + ln + "\n")
        sys.stderr.write("".join(out))
        sys.stderr.flush()
        self._panel_height = len(lines)

    def _print_visual(self, block: np.ndarray) -> None:
        """One-line live visualization of the newest block (channel 0),
        built on the same frame computations as the offline renderer
        (host/visual.py; examples/visual.zig:205-791's widgets)."""
        from ..host import visual as vz

        x = np.asarray(block[0], np.float32) / self._full_scale
        width = 48
        mode = self.visual_mode
        if mode == "wave":
            cols = vz.waveform_frame(x, width=width)
            vals = np.abs(cols).max(axis=1)  # envelope magnitude per column
            label = "wav"
        elif mode == "spec":
            mag = vz.spectrum_frame(x)  # log1p |FFT|, fft_size/2 bins
            edges = (np.arange(width + 1) * len(mag)) // width
            bins = np.array([mag[a:b].max() if b > a else 0.0
                             for a, b in zip(edges[:-1], edges[1:])])
            # fixed scale: a full-scale sine peaks at |FFT| = fft_size/2
            vals = np.clip(bins / np.log1p(len(mag)), 0.0, 1.0)
            label = "fft"
        else:  # scope
            sr = float(self.client.welcome["sample_rate"])
            win = vz.oscilloscope_frame(x, None, sr, width=width)
            vals = np.clip(win * 0.5 + 0.5, 0.0, 1.0)  # -1..1 -> 0..1
            label = "osc"
        rec = " REC" if self.recording_file else ""
        sys.stderr.write("\r%s[%s]%s " % (label, self._spark(vals), rec))
        sys.stderr.flush()

    def _print_vu(self) -> None:
        bar = int(min(self.level, 1.0) * 40)
        rec = " REC" if self.recording_file else ""
        sys.stderr.write(
            "\r[%-40s] %5.1f%%%s " % ("#" * bar, self.level * 100, rec))
        sys.stderr.flush()

    def _note(self, msg: str) -> None:
        if not self.quiet:
            sys.stderr.write("\r\x1b[K" + msg + "\n")
            sys.stderr.flush()

    # -- lifecycle ------------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            for t in self._timers.values():
                t.cancel()
            self._timers.clear()
        try:
            self.client.close()
        except OSError:
            pass
        self._reader.join(timeout=5.0)
        with self._lock:
            if self._wav is not None:
                self._wav.close()
                self._wav = None
        sink, self._sink = self._sink, None
        if sink is not None:
            try:
                sink.stdin.close()
            except OSError:
                pass
            try:
                sink.wait(timeout=2.0)
            except Exception:
                sink.terminate()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


# F-key -> visualizer screen (reference visual.zig:943-1231); F6 returns
# to the VU bar
_FKEY_PANELS = {"F1": "help", "F2": "main", "F3": "oscope", "F4": "fft",
                "F5": "params", "F6": None}


def _stdin_keys():
    """Yield key tokens from a raw-mode terminal (cbreak: no echo, no line
    buffering — the SDL keydown analog). Arrow keys arrive as CSI escape
    sequences and are decoded to "UP"/"DOWN"/"LEFT"/"RIGHT"; a bare Esc
    (no bytes follow within 50 ms) is yielded as "\\x1b" itself."""
    import select
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    arrows = {"A": "UP", "B": "DOWN", "C": "RIGHT", "D": "LEFT"}
    ss3_fkeys = {"P": "F1", "Q": "F2", "R": "F3", "S": "F4"}  # xterm SS3
    csi_fkeys = {"11": "F1", "12": "F2", "13": "F3", "14": "F4",
                 "15": "F5", "17": "F6"}  # vt220-style CSI n ~
    pending = ""  # one-byte pushback: a CSI scan that hits a control byte
    # (aborted/interleaved sequence) re-processes that byte as a fresh key
    try:
        tty.setcbreak(fd)
        while True:
            if pending:
                ch, pending = pending, ""
            else:
                ch = sys.stdin.read(1)
            if not ch:
                return
            if ch == "\x1b":
                r, _, _ = select.select([fd], [], [], 0.05)
                if not r:
                    yield ch  # bare Esc
                    continue
                seq = sys.stdin.read(1)
                if seq == "O":  # SS3: F1-F4 on most terminals
                    fin = sys.stdin.read(1)
                    tok = ss3_fkeys.get(fin)
                    if tok:
                        yield tok
                    continue
                if seq == "[":
                    # CSI: consume parameter/intermediate bytes (0x20-0x3F:
                    # digits, ';' separators, ...) until the FINAL byte in
                    # 0x40-0x7E — a modified arrow like Ctrl-Right
                    # (\x1b[1;5C) must not leak its tail into the key
                    # stream as note presses
                    params = ""
                    while True:
                        fin = sys.stdin.read(1)
                        if not fin or "\x40" <= fin <= "\x7e":
                            break
                        if not "\x20" <= fin <= "\x3f":
                            # outside the ECMA-48 parameter/intermediate
                            # range: an aborted/interleaved sequence (e.g.
                            # the ESC of the NEXT sequence). Abort this one
                            # and re-process the byte as a fresh key so it
                            # is not swallowed into params.
                            pending = fin
                            fin = ""
                            break
                        params += fin
                    if fin == "~":
                        tok = csi_fkeys.get(params.split(";")[0])
                        if tok:
                            yield tok
                        continue
                    # plain OR modified arrows both map (params ignored)
                    tok = arrows.get(fin)
                    if tok:
                        yield tok
                    continue  # other CSI: swallow
                continue  # Alt-<key>: swallow
            yield ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="zang-play",
        description="Play a zang-tpu live server from the terminal "
                    "(two-row musical keyboard; ` record/loop-playback, "
                    "~ WAV take, 1 = stats, Esc quits)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9800)
    ap.add_argument("--part", type=int, default=0)
    ap.add_argument("--gate", type=float, default=0.3,
                    help="seconds a pressed key stays held (terminals have "
                         "no key-up events)")
    ap.add_argument("--wav", help="also capture the stream to a WAV file")
    ap.add_argument("--sink", metavar="CMD",
                    help="pipe interleaved s16 audio into a player "
                         "command's stdin (e.g. 'aplay -f S16_LE -c 1 "
                         "-r 48000'); a stalled sink drops audio rather "
                         "than stalling the stream")
    ap.add_argument("--resume", metavar="TOKEN",
                    help="continue a session dropped by a network blip "
                         "(the token printed at connect time)")
    ap.add_argument("--instrument", metavar="NAME",
                    help="instrument to play on a multi-instrument server "
                         "(--list-instruments shows the names; default: "
                         "the server's default instrument)")
    ap.add_argument("--list-instruments", action="store_true",
                    help="print the server's instrument menu and exit")
    args = ap.parse_args(argv)

    if args.list_instruments:
        from .server import list_instruments

        menu = list_instruments(args.host, args.port)
        if menu.get("op") == "instruments":
            for name in menu["available"]:
                star = " (default)" if name == menu["default"] else ""
                print(f"{name}{star}")
        else:  # plain single-instrument LiveServer answered with welcome
            print("(single-instrument server)")
        return 0

    client = LiveClient(args.host, args.port, instrument=args.instrument)
    w = client.welcome
    inst = f" [{w['instrument']}]" if "instrument" in w else ""
    print(f"lane {w['lane']}{inst} @ {args.host}:{args.port}  "
          f"block {w['block_size']} / {w['sample_rate']:.0f} Hz "
          f"{w['dtype']}", file=sys.stderr)
    if w.get("resume_token"):
        print(f"resume token (reconnect with --resume): "
              f"{w['resume_token']}", file=sys.stderr)
    if args.resume:
        frame = client.resume(args.resume)
        print(f"resumed session at frame {frame}", file=sys.stderr)
    if not sys.stdin.isatty():
        print("stdin is not a tty — pipe mode: one key per line "
              "(blank line = quit)", file=sys.stderr)
    with TerminalPlayer(client, part=args.part, gate=args.gate,
                        wav_path=args.wav, sink_cmd=args.sink,
                        auto_resume=(args.host, args.port)) as player:
        try:
            if sys.stdin.isatty():
                for ch in _stdin_keys():
                    if ch in ("\x1b", "\x03", "\x04"):  # Esc / ^C / ^D
                        break
                    elif ch == "`":  # the reference's recorder key
                        player.cycle_recorder()
                    elif ch == "~":  # shift-backquote: server-side take
                        player.toggle_recording()
                    elif ch == "1":
                        player.request_stats()
                    elif ch == "2":
                        player.cycle_visual()
                    # reference visualizer screens (visual.zig:943-1231)
                    elif ch in _FKEY_PANELS:
                        player.set_visual(_FKEY_PANELS[ch])
                    # live parameter panel (example.zig:324-392)
                    elif ch == "UP":
                        player.param_select(-1)
                    elif ch == "DOWN":
                        player.param_select(1)
                    elif ch == "LEFT":
                        player.param_step(-1)
                    elif ch == "RIGHT":
                        player.param_step(1)
                    elif ch in ("\x7f", "\x08"):  # Backspace
                        player.param_randomize()
                    elif ch.strip():
                        player.press(ch)
            else:  # scripted/pipe mode, for tests and automation
                # wait for the stream to start (first-block jit compile can
                # take tens of seconds on a cold server) so scripted presses
                # land in flowing audio, as the SDL host's keys did once the
                # audio device was running
                deadline = time.monotonic() + 300
                while (player.blocks_received == 0
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                for line in sys.stdin:
                    key = line.strip()
                    if not key:
                        break
                    if key in ("UP", "DOWN"):
                        player.param_select(-1 if key == "UP" else 1)
                    elif key in ("LEFT", "RIGHT"):
                        player.param_step(-1 if key == "LEFT" else 1)
                    elif key == "BS":
                        player.param_randomize()
                    elif key in _FKEY_PANELS:
                        player.set_visual(_FKEY_PANELS[key])
                    elif key == "`":  # recorder cycle, as in tty mode
                        player.cycle_recorder()
                    elif key == "~":  # server-side WAV take toggle
                        player.toggle_recording()
                    else:
                        player.press(key)
                    time.sleep(args.gate)
                time.sleep(args.gate + 0.1)  # let the last release land
        except KeyboardInterrupt:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
