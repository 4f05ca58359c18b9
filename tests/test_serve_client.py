"""Terminal player client (serve/client.py): the reference host's
keyboard-play loop as a TCP client — presses in, audio/VU/WAV out.
Non-realtime server; waits are on delivered-block counts, not wall time."""

import io
import sys
import time

import numpy as np
import pytest

from zang_tpu.core.wav import read_wav_f32
from zang_tpu.host import instruments as ti
from zang_tpu.serve.client import TerminalPlayer, main
from zang_tpu.serve.server import LiveClient, LiveServer

SR = 48000.0
BLOCK = 1024


def make_server(**kw):
    kw.setdefault("initial_lanes", 1)
    kw.setdefault("realtime", False)
    kw.setdefault("block_size", BLOCK)
    return LiveServer(lambda: [(ti.NiceInstrument(0.3), 2)], SR,
                      port=0, **kw)


def wait_blocks(player, n, timeout=60.0):
    """Block until the player has received n more blocks."""
    target = player.blocks_received + n
    deadline = time.monotonic() + timeout
    while player.blocks_received < target:
        assert time.monotonic() < deadline, "no blocks flowing"
        time.sleep(0.01)


class TestTerminalPlayer:
    def test_press_streams_audio_and_wav(self, tmp_path):
        wav = tmp_path / "take.wav"
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            with TerminalPlayer(c, gate=0.25, wav_path=str(wav),
                                quiet=True) as player:
                # stream flowing first: the gate is wall-clock, and a
                # first-block compile longer than it would swallow the note
                wait_blocks(player, 2)
                player.press("q")
                wait_blocks(player, 12)
                assert player.level > 0.01  # VU sees the note
                player.release("q")
                wait_blocks(player, 40)  # release tail decays
        audio, sr = read_wav_f32(str(wav))
        assert sr == int(SR)
        peak = np.abs(audio).max()
        assert peak > 0.05, peak
        tail = np.abs(audio[0, -BLOCK:]).max()
        assert tail < peak / 4, (tail, peak)

    def test_retrigger_and_auto_release(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            with TerminalPlayer(c, gate=0.1, quiet=True) as player:
                player.press("z")
                player.press("z")  # retrigger while held: off + on
                time.sleep(0.3)  # gate timer fires the auto-release
                assert "z" not in player._timers
                wait_blocks(player, 5)

    def test_record_toggle_roundtrip(self, tmp_path):
        with make_server(record_dir=str(tmp_path)) as srv:
            c = LiveClient(srv.host, srv.port)
            # gate far longer than the test: the default 0.3 s WALL-clock
            # gate expires during the first-block jit compile, so whether
            # the recorded window holds attack or release tail depended on
            # compile speed (warm-cache runs recorded a quieter tail and
            # flaked the >0.05 peak assert). Held key = sustained audio,
            # deterministic at any compile speed.
            with TerminalPlayer(c, gate=30.0, quiet=True) as player:
                player.press("q")
                wait_blocks(player, 2)  # past the first-block jit compile
                player.toggle_recording()
                deadline = time.monotonic() + 60
                while player.recording_file is None:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                fname = player.recording_file
                wait_blocks(player, 10)
                player.toggle_recording()
                deadline = time.monotonic() + 60
                while player.recording_file is not None:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                audio, _sr = read_wav_f32(str(tmp_path / fname))
                assert np.abs(audio).max() > 0.05

    def test_stats_request(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            with TerminalPlayer(c, quiet=True) as player:
                wait_blocks(player, 3)
                player.request_stats()
                deadline = time.monotonic() + 30
                while player.last_stats is None:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                assert player.last_stats["clients"] == 1
                assert player.last_stats["block_time_ms"] > 0


class TestKeypressRecorder:
    """The reference's backquote recorder wired into the client
    (examples/recorder.zig + example.zig:393-400,486-526): record a
    keypress performance, then loop it back into the running lane."""

    @staticmethod
    def wait_state(player, state, timeout=10.0):
        deadline = time.monotonic() + timeout
        while player.recorder.state != state:
            assert time.monotonic() < deadline, (
                f"recorder never reached {state!r} "
                f"(at {player.recorder.state!r})")
            time.sleep(0.01)

    def test_record_then_loop_playback(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            with TerminalPlayer(c, gate=0.1, quiet=True) as player:
                wait_blocks(player, 2)  # stream flowing
                player.cycle_recorder()  # idle -> recording
                self.wait_state(player, "recording")
                player.press("q")
                time.sleep(0.2)  # gate auto-release lands and is recorded
                player.cycle_recorder()  # recording -> loop playback
                self.wait_state(player, "playing")
                assert [(k, d) for _, k, d in player.recorder.events] == \
                    [("q", True), ("q", False)]
                assert player.recorder.loop_seconds > 0.15
                # spy on the wire: loop playback must keep feeding key
                # events into the lane with NO further live input
                sent = []
                orig = player.client.send_key

                def spy(part, key, down):
                    sent.append((key, down))
                    return orig(part, key, down)

                player.client.send_key = spy
                deadline = time.monotonic() + 15
                while sent.count(("q", True)) < 2:
                    assert time.monotonic() < deadline, sent
                    time.sleep(0.02)
                assert ("q", False) in sent  # ups replay too (no stuck notes)
                player.cycle_recorder()  # playing -> off
                self.wait_state(player, "idle")
                time.sleep(0.3)
                n = len(sent)
                time.sleep(0.5)
                assert len(sent) == n  # off means off
                wait_blocks(player, 5)  # stream still healthy


class TestAutoResume:
    def test_stream_continues_after_blip(self):
        """Killing the socket mid-stream triggers reconnect+resume on the
        reader thread; the block stream continues on the new connection."""
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            with TerminalPlayer(c, quiet=True,
                                auto_resume=(srv.host, srv.port)) as player:
                player.press("q")
                wait_blocks(player, 6)
                player.client.sock.close()  # simulated network blip
                deadline = time.monotonic() + 60
                while player.resumes == 0:
                    assert time.monotonic() < deadline, "never resumed"
                    assert not player._stop.is_set(), "player gave up"
                    time.sleep(0.05)
                wait_blocks(player, 10)  # flowing again
                player.press("z")  # input path works on the new connection
                wait_blocks(player, 5)


class TestAudioSink:
    """--sink CMD: the local-playback analog of the reference's SDL audio
    device (example.zig:197-222) — interleaved s16 piped into any player
    command, with degrade-not-stall backpressure."""

    def test_sink_receives_interleaved_s16(self, tmp_path):
        out = tmp_path / "sink.raw"
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            with TerminalPlayer(c, gate=0.2, quiet=True,
                                sink_cmd=f"cat > {out}") as player:
                wait_blocks(player, 2)  # compile done before the gate runs
                player.press("q")
                wait_blocks(player, 12)
        data = np.fromfile(str(out), np.int16)
        assert data.size >= 10 * BLOCK, data.size
        assert np.abs(data).max() > 1000  # the note is audible in the feed

    def test_stalled_sink_drops_not_stalls(self):
        # a sink that never reads: once the OS pipe and the bounded
        # pending buffer fill, audio is dropped and the stream keeps
        # flowing (at-cap degrade, not a stall)
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            with TerminalPlayer(c, quiet=True,
                                sink_cmd="sleep 600") as player:
                wait_blocks(player, 80, timeout=90.0)
                assert player.sink_dropped_bytes > 0

    def test_dead_sink_disables_cleanly(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            with TerminalPlayer(c, quiet=True,
                                sink_cmd="head -c 4096 > /dev/null"
                                ) as player:
                wait_blocks(player, 30)
                deadline = time.monotonic() + 30
                while player._sink is not None:
                    assert time.monotonic() < deadline, "sink not disabled"
                    time.sleep(0.02)
                wait_blocks(player, 10)  # stream unaffected


class TestPipeModeCLI:
    def test_main_pipe_mode(self, tmp_path, monkeypatch):
        """main() with non-tty stdin: one key per line, then quit; the
        captured WAV is audible."""
        wav = tmp_path / "pipe.wav"
        with make_server() as srv:
            # F4 switches to the full-FFT panel mid-stream (the reference's
            # visualizer screens reachable from pipe mode)
            monkeypatch.setattr(sys, "stdin",
                                io.StringIO("q\nF4\nz\nF6\n\n"))
            rc = main(["--host", srv.host, "--port", str(srv.port),
                       "--gate", "0.15", "--wav", str(wav)])
        assert rc == 0
        audio, _sr = read_wav_f32(str(wav))
        assert np.abs(audio).max() > 0.05


class TestLiveVisual:
    """The one-line live visual modes (reference F1-F6 visualizer,
    examples/visual.zig:943-1231): pure rendering, no server needed."""

    @staticmethod
    def _stub(mode):
        from types import SimpleNamespace

        return SimpleNamespace(
            visual_mode=mode,
            _full_scale=32767.0,
            recording_file=None,
            client=SimpleNamespace(welcome={"sample_rate": 48000.0}),
            _spark=TerminalPlayer._spark,
            _VISUAL_MODES=TerminalPlayer._VISUAL_MODES,
        )

    @staticmethod
    def _render(mode, block):
        import contextlib

        stub = TestLiveVisual._stub(mode)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            TerminalPlayer._print_visual(stub, block)
        return err.getvalue()

    def test_spark_quantization(self):
        s = TerminalPlayer._spark(np.array([0.0, 0.5, 1.0]))
        assert len(s) == 3
        assert s[0] == " " and s[2] == "█"

    def test_modes_render_one_line(self):
        t = np.arange(1024, dtype=np.float32) / 48000.0
        sine = (np.sin(2 * np.pi * 440.0 * t) * 20000).astype(np.int16)
        block = sine[None, :]
        for mode, label in (("wave", "wav"), ("spec", "fft"),
                            ("scope", "osc")):
            out = TestLiveVisual._render(mode, block)
            assert out.startswith("\r" + label + "["), (mode, out[:20])
            assert "\n" not in out
            # a loud sine must light up the display
            assert any(c in out for c in "▅▆▇█"), (mode, out)

    def test_silence_stays_dark(self):
        block = np.zeros((1, 1024), np.int16)
        for mode in ("wave", "spec"):
            out = TestLiveVisual._render(mode, block)
            assert not any(c in out for c in "▁▂▃▄▅▆▇█"), (mode, out)

    def test_cycle_visual_order(self):
        stub = TestLiveVisual._stub(None)
        stub._note = lambda *a, **k: None
        stub._ensure_params = lambda: False
        stub._panel_height = 0
        stub.quiet = True
        stub.set_visual = lambda m: TerminalPlayer.set_visual(stub, m)
        seen = []
        for _ in range(10):
            TerminalPlayer.cycle_visual(stub)
            seen.append(stub.visual_mode)
        assert seen == ["wave", "spec", "scope", "help", "main", "oscope",
                        "fft", "params", None, "wave"]


class TestVisualPanels:
    """The reference's full visualizer screens (F1-F5: help, main,
    oscilloscope, full FFT, params — visual.zig:943-1231) as multi-line
    terminal panels."""

    @staticmethod
    def _stub(mode, specs=None, values=None):
        from types import SimpleNamespace

        stub = SimpleNamespace(
            visual_mode=mode,
            quiet=True,
            _full_scale=32767.0,
            _panel_height=0,
            recording_file=None,
            level=0.5,
            blocks_received=7,
            param_specs=specs,
            param_values=values,
            param_sel=1 if specs else 0,
            client=SimpleNamespace(welcome={"sample_rate": 48000.0}),
            _spark=TerminalPlayer._spark,
            _raster=TerminalPlayer._raster,
            _raster_bipolar=TerminalPlayer._raster_bipolar,
            _VISUAL_MODES=TerminalPlayer._VISUAL_MODES,
            _PANEL_MODES=TerminalPlayer._PANEL_MODES,
            PANEL_WIDTH=TerminalPlayer.PANEL_WIDTH,
            PANEL_ROWS=TerminalPlayer.PANEL_ROWS,
        )
        stub.recorder = SimpleNamespace(state="idle")
        stub._sync_freq = lambda x, sr: TerminalPlayer._sync_freq(stub, x, sr)
        stub._status_line = lambda: TerminalPlayer._status_line(stub)
        return stub

    @staticmethod
    def _sine_block():
        # near-full-scale so the raster's top row lights
        t = np.arange(4096, dtype=np.float32) / 48000.0
        return (np.sin(2 * np.pi * 440.0 * t) * 32000).astype(np.int16)[None, :]

    def test_raster_fills_bottom_up(self):
        lines = TerminalPlayer._raster(np.array([0.0, 0.5, 1.0]), 4)
        assert len(lines) == 4
        assert lines[0][0] == " " and lines[-1][0] == " "  # zero column dark
        assert lines[0][2] == "█" and lines[-1][2] == "█"  # full column lit
        assert lines[-1][1] == "█" and lines[0][1] == " "  # half: bottom only

    def test_panels_render(self):
        block = self._sine_block()
        for mode in ("main", "oscope", "fft"):
            stub = self._stub(mode)
            lines = TerminalPlayer.render_panel(stub, block)
            assert len(lines) >= 4, mode
            assert any("█" in ln or "▇" in ln for ln in lines), mode
            assert "level" in lines[-1]

    def test_oscope_is_synced(self):
        # a 440 Hz sine across a 4096-sample block shows ~one cycle when
        # synced: the bipolar raster's top row lights near the first
        # quarter, not periodically across the width
        stub = self._stub("oscope")
        lines = TerminalPlayer.render_panel(stub, self._sine_block())
        top = lines[1]
        lit = [i for i, c in enumerate(top) if c != " "]
        assert lit, top
        span = max(lit) - min(lit)
        assert span < TerminalPlayer.PANEL_WIDTH // 2, (span, top)

    def test_help_and_params_panels(self):
        stub = self._stub("help")
        lines = TerminalPlayer.render_panel(stub, self._sine_block())
        assert any("F4" in ln for ln in lines)
        specs = [{"name": "a", "desc": "alpha", "num_values": 10},
                 {"name": "b", "desc": "beta", "num_values": 4}]
        stub = self._stub("params", specs=specs, values={"a": 3, "b": 1})
        lines = TerminalPlayer.render_panel(stub, self._sine_block())
        assert any(ln.startswith("> beta") for ln in lines), lines
        assert any("alpha" in ln and "(0..9)" in ln for ln in lines)

    def test_set_visual_toggles_off(self):
        stub = self._stub("fft")
        stub._note = lambda *a, **k: None
        stub._ensure_params = lambda: False
        TerminalPlayer.set_visual(stub, "fft")
        assert stub.visual_mode is None
        TerminalPlayer.set_visual(stub, "main")
        assert stub.visual_mode == "main"

    def test_print_panel_redraws_in_place(self):
        import contextlib
        import io as _io

        stub = self._stub("fft")
        stub.render_panel = lambda b: TerminalPlayer.render_panel(stub, b)
        err = _io.StringIO()
        with contextlib.redirect_stderr(err):
            TerminalPlayer._print_panel(stub, self._sine_block())
            first = err.getvalue()
            h1 = stub._panel_height
            TerminalPlayer._print_panel(stub, self._sine_block())
        second = err.getvalue()[len(first):]
        assert h1 > 0 and "\x1b[K" in first
        # first draw writes lines in place; the redraw starts by moving the
        # cursor back up over the previous panel
        assert not first.startswith("\x1b[%dA" % h1)
        assert second.startswith("\x1b[%dA" % h1)

