"""TCP live server (serve/server.py): clients drive fleet lanes over a
socket and get their own lane's PCM back. Non-realtime mode so the tests
pace the stream by reading."""

import numpy as np
import pytest

from zang_tpu.host import instruments as ti
from zang_tpu.serve.server import LiveClient, LiveServer

SR = 48000.0
BLOCK = 1024


def make_server(**kw):
    kw.setdefault("initial_lanes", 2)
    kw.setdefault("realtime", False)
    kw.setdefault("block_size", BLOCK)
    return LiveServer(lambda: [(ti.NiceInstrument(0.3), 2)], SR,
                      port=0, **kw)


def read_until_audible(c, max_blocks=200):
    """Peak of the first audible block. In non-realtime mode the free-
    running server may render many silent blocks before a just-sent event
    lands (warm jit races ahead of the client's sends), so a fixed small
    read count is flaky — scan forward instead."""
    for _ in range(max_blocks):
        p = float(np.abs(c.read_block()).max())
        if p > 100:
            return p
    raise AssertionError(f"no audible block within {max_blocks}")


def read_until_quiet(c, threshold, max_blocks=400):
    """Scan until the stream decays below threshold (a release landing is
    itself subject to the free-run race, so fixed read counts flake)."""
    last = None
    for _ in range(max_blocks):
        last = float(np.abs(c.read_block()).max())
        if last < threshold:
            return last
    raise AssertionError(f"never decayed below {threshold}: last {last}")


class TestProtocol:
    def test_welcome_and_audio_flow(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            try:
                assert c.welcome["sample_rate"] == SR
                assert c.welcome["block_size"] == BLOCK
                assert c.welcome["dtype"] == "int16"
                c.send_event(0, {"freq": 440.0, "note_on": True})
                assert read_until_audible(c) > 100
            finally:
                c.close()

    def test_two_clients_isolated_lanes(self):
        """Each client hears only its own lane: client A plays, client B
        stays silent."""
        with make_server() as srv:
            a = LiveClient(srv.host, srv.port)
            b = LiveClient(srv.host, srv.port)
            try:
                assert a.welcome["lane"] != b.welcome["lane"]
                a.send_event(0, {"freq": 330.0, "note_on": True})
                # scan A forward to its note, counting blocks; B's stream
                # over the same span must be pure silence
                n = 0
                while float(np.abs(a.read_block()).max()) <= 100:
                    n += 1
                    assert n < 200, "A never became audible"
                peaks_b = [float(np.abs(b.read_block()).max())
                           for _ in range(n + 4)]
                assert max(peaks_b) == 0, peaks_b
            finally:
                a.close()
                b.close()

    def test_f32_stream_matches_direct_fleet_block(self):
        """An f32 server (pcm16_volume=None) streams finite float blocks."""
        with make_server(pcm16_volume=None) as srv:
            c = LiveClient(srv.host, srv.port)
            try:
                assert c.welcome["dtype"] == "float32"
                c.send_event(0, {"freq": 220.0, "note_on": True})
                blocks = [c.read_block() for _ in range(3)]
                cat = np.concatenate(blocks, axis=1)
                assert cat.dtype == np.float32
                assert np.isfinite(cat).all()
                assert np.abs(cat).max() > 1e-4
            finally:
                c.close()

    def test_key_events_play_notes(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            try:
                c.send_key(0, "q", True)
                assert read_until_audible(c) > 100
            finally:
                c.close()

    def test_key_up_releases_note_over_wire(self):
        """The server pairs key-downs/ups per lane (LiveSession's internal
        tracker), so a wire key-up actually releases the note through the
        polyphony dispatcher instead of being dropped for lack of a
        matching note id (stuck note)."""
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            try:
                c.send_key(0, "q", True)
                held_peak = read_until_audible(c)
                c.send_key(0, "q", False)
                read_until_quiet(c, held_peak / 4)
            finally:
                c.close()

    def test_recoverable_error_keeps_lane_alive(self):
        """A bad part index (or any recoverable _ClientError) answers an
        error frame and KEEPS serving: a typo'd frame must not tear down
        a live audio stream (the lane used to be detached)."""
        import json

        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            try:
                c.sock.sendall(json.dumps(
                    {"op": "key", "part": 99, "key": "q", "down": True}
                ).encode() + b"\n")
                with pytest.raises(RuntimeError, match="out of range"):
                    for _ in range(200):
                        c.read_block()
                # the SAME connection still takes events and plays
                c.send_key(0, "q", True)
                assert read_until_audible(c) > 100
            finally:
                c.close()

    def test_restore_disabled_discards_blob_and_keeps_serving(self):
        """A restore attempt against a server without allow_migration
        consumes the (bounded) payload so the line parser stays in sync —
        the blob may contain newlines — acks the error, and keeps the
        client attached."""
        import json

        with make_server() as srv:  # allow_migration defaults off
            c = LiveClient(srv.host, srv.port)
            try:
                blob = b"\x00" * 1000 + b"\n" * 24
                c.sock.sendall(json.dumps(
                    {"op": "restore", "nbytes": len(blob)}
                ).encode() + b"\n" + blob)
                with pytest.raises(RuntimeError,
                                   match="migration disabled"):
                    for _ in range(200):
                        c.read_block()
                c.send_event(0, {"freq": 440.0, "note_on": True})
                assert read_until_audible(c) > 100
            finally:
                c.close()

    def test_unknown_op_gets_error(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            import json

            c.sock.sendall(json.dumps({"op": "nonsense"}).encode() + b"\n")
            with pytest.raises((RuntimeError, EOFError)):
                for _ in range(50):  # queued block frames may arrive first
                    c.read_block()
            c.sock.close()


class TestStatsAndDsl:
    def test_stats_frame(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            try:
                c.send_event(0, {"freq": 440.0, "note_on": True})
                for _ in range(3):
                    c.read_block()
                st = c.stats()
                assert st["clients"] == 1
                assert st["lanes"] >= 1
                assert st["blocks_served"] >= 3
                assert st["block_time_ms"] > 0
                assert st["realtime_headroom"] is not None
                assert st["dtype"] == "int16"
            finally:
                c.close()

    def test_dsl_instrument_lanes_over_tcp(self):
        """A zangscript instrument serves over the wire like a native one
        (the DSL path through fleet + server end to end)."""
        from zang_tpu.script import compile_script
        from zang_tpu.script.jax_backend import ScriptInstrument

        src = """
V = defmodule freq: cob, note_on: boolean, begin
    e = Envelope(attack=.cubed(0.02), decay=.cubed(0.1),
                 release=.linear(0.3), sustain_volume=0.8, note_on)
    out e * PulseOsc(freq, color=0.4) * 0.5
end
"""
        cs = compile_script(src)
        srv = LiveServer(lambda: [(ScriptInstrument(cs, "V"), 2)], 44100.0,
                         port=0, initial_lanes=1, realtime=False,
                         block_size=BLOCK)
        with srv:
            c = LiveClient(srv.host, srv.port)
            try:
                c.send_event(0, {"freq": 440.0, "note_on": True})
                assert read_until_audible(c) > 100
            finally:
                c.close()


class TestMigration:
    def test_session_migrates_between_servers(self):
        """Play on server A, snapshot the lane over the wire, restore it on
        server B: the held note keeps sounding there and its key-up still
        releases it (the held-key tracker migrated too)."""
        with make_server(allow_migration=True) as a_srv, \
                make_server(allow_migration=True) as b_srv:
            ca = LiveClient(a_srv.host, a_srv.port)
            try:
                ca.send_key(0, "q", True)
                held = read_until_audible(ca)
                blob = ca.snapshot()
                assert len(blob) > 100
            finally:
                ca.close()

            cb = LiveClient(b_srv.host, b_srv.port)
            try:
                frame = cb.restore(blob)
                assert frame > 0
                # the note survived the move — audible with no new events.
                # Scan, don't count: the restore ack round-trip queues
                # however many PRE-restore silent blocks the free-running
                # server rendered meanwhile (read_control buffers them for
                # read_block), and on a loaded box that exceeds any fixed
                # read count.
                peak = read_until_audible(cb)
                # and releases through the migrated key tracker
                cb.send_key(0, "q", False)
                read_until_quiet(cb, peak / 4)
            finally:
                cb.close()

    def test_migration_disabled_by_default(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            import json

            c.sock.sendall(json.dumps({"op": "snapshot"}).encode() + b"\n")
            with pytest.raises((RuntimeError, EOFError)):
                for _ in range(50):
                    c.read_block()
            c.sock.close()


def wait_detached(srv, timeout=60.0):
    import time

    deadline = time.monotonic() + timeout
    while srv.num_clients:
        assert time.monotonic() < deadline, "server never noticed disconnect"
        time.sleep(0.05)


class TestResume:
    def test_unplanned_disconnect_resumes(self):
        """A network blip (socket dies without a bye) retains the session
        under the welcome's resume token; reconnecting with it continues
        the stream — held note still sounding, key tracker intact."""
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            token = c.welcome["resume_token"]
            c.send_key(0, "q", True)
            held = read_until_audible(c)
            c.sock.close()  # blip: no bye frame
            wait_detached(srv)

            c2 = LiveClient(srv.host, srv.port)
            try:
                frame = c2.resume(token)
                assert frame > 0
                peaks = [float(np.abs(c2.read_block()).max())
                         for _ in range(8)]
                assert max(peaks) > 100, peaks
                c2.send_key(0, "q", False)
                read_until_quiet(c2, max(peaks) / 4)
            finally:
                c2.close()

    def test_orderly_bye_not_resumable(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            token = c.welcome["resume_token"]
            c.read_block()
            c.close()  # orderly bye — session ends, nothing retained
            wait_detached(srv)
            c2 = LiveClient(srv.host, srv.port)
            import json

            _ = c2.read_block()
            c2.sock.sendall(
                json.dumps({"op": "resume", "token": token}).encode() + b"\n")
            with pytest.raises((RuntimeError, EOFError),
                               match="(?i)token|closed"):
                for _ in range(100):
                    c2.read_block()
            c2.sock.close()

    def test_sessions_survive_server_restart(self, tmp_path):
        """With a retain_dir, closing the server drains connected sessions
        to disk; a restarted server (same spec + dir) resumes them by
        token — mid-phrase, held note intact."""
        srv1 = make_server(retain_dir=str(tmp_path))
        srv1.start()
        c = LiveClient(srv1.host, srv1.port)
        token = c.welcome["resume_token"]
        c.send_key(0, "q", True)
        held = read_until_audible(c)
        srv1.close()  # restart begins: drain to disk
        c.sock.close()
        assert list(tmp_path.glob("*.session"))

        with make_server(retain_dir=str(tmp_path)) as srv2:
            c2 = LiveClient(srv2.host, srv2.port)
            try:
                frame = c2.resume(token)
                assert frame > 0
                peaks = [float(np.abs(c2.read_block()).max())
                         for _ in range(8)]
                assert max(peaks) > 100, peaks
            finally:
                c2.close()
        assert not list(tmp_path.glob(f"{token}.session"))  # single-use

    def test_probe_connections_not_retained(self):
        """Connections that never play (health checks, scanners, protocol
        errors) must not occupy the bounded retention store — junk
        retention would evict real blipped sessions."""
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            c.sock.close()  # abrupt, eventless disconnect
            wait_detached(srv)
            import json

            c2 = LiveClient(srv.host, srv.port)
            c2.sock.sendall(b"this is not json\n")  # protocol error path
            with pytest.raises((RuntimeError, EOFError)):
                for _ in range(100):
                    c2.read_block()
            c2.sock.close()
            wait_detached(srv)
            assert not srv._retained

    def test_token_single_use(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            token = c.welcome["resume_token"]
            c.send_event(0, {"freq": 440.0, "note_on": True})
            c.read_block()
            c.sock.close()
            wait_detached(srv)
            c2 = LiveClient(srv.host, srv.port)
            c2.resume(token)
            c2.sock.close()  # blip again — retained under C2's OWN token
            wait_detached(srv)
            c3 = LiveClient(srv.host, srv.port)
            import json

            c3.sock.sendall(
                json.dumps({"op": "resume", "token": token}).encode() + b"\n")
            with pytest.raises((RuntimeError, EOFError)):
                for _ in range(100):
                    c3.read_block()
            c3.sock.close()


class TestResilience:
    def test_transient_render_failure_recovers(self):
        """Sporadic device errors must not kill the render thread — the
        stream rides them out."""
        with make_server() as srv:
            fails = {"n": 2}
            orig = srv.fleet.render_block

            def flaky():
                if fails["n"] > 0:
                    fails["n"] -= 1
                    raise RuntimeError("transient device error")
                return orig()

            srv.fleet.render_block = flaky
            c = LiveClient(srv.host, srv.port)
            try:
                c.send_event(0, {"freq": 440.0, "note_on": True})
                assert read_until_audible(c) > 100
                assert fails["n"] == 0  # the failures actually happened
            finally:
                c.close()

    def test_poisoned_render_closes_connections(self):
        """A persistently-failing fleet closes client connections (EOF) so
        clients can reconnect elsewhere, instead of starving them until
        their socket timeouts."""
        with make_server() as srv:
            def dead():
                raise RuntimeError("device gone")

            srv.fleet.render_block = dead
            c = LiveClient(srv.host, srv.port, timeout=60.0)
            with pytest.raises(EOFError):
                for _ in range(100):
                    c.read_block()
            c.sock.close()


class TestRecording:
    def test_take_is_playing_audio(self, tmp_path):
        """A take captures whole rendered blocks of the lane's stream
        while the note is sounding."""
        from zang_tpu.core.wav import read_wav

        with make_server(record_dir=str(tmp_path)) as srv:
            c = LiveClient(srv.host, srv.port)
            try:
                c.send_event(0, {"freq": 440.0, "note_on": True})
                c.read_block()  # let the note land
                start = c.record_start()
                # read past blocks that predate the take (socket-buffered
                # in non-realtime mode) until >= 3 in-take blocks streamed
                while c.last_block_seq < start["seq"] + 3:
                    c.read_block()
                ack = c.record_stop()
                assert ack["file"] == start["file"]
                wav = read_wav(str(tmp_path / start["file"]))
                assert wav.sample_rate == int(SR)
                assert wav.num_channels == 1 and wav.bits_per_sample == 16
                data = np.frombuffer(wav.data, np.int16)
                assert len(data) == round(ack["seconds"] * SR)
                assert len(data) % BLOCK == 0 and len(data) >= BLOCK
                assert np.abs(data).max() > 100  # the held note is audible
            finally:
                c.close()

    def test_disconnect_flushes_take(self, tmp_path):
        with make_server(record_dir=str(tmp_path)) as srv:
            c = LiveClient(srv.host, srv.port)
            c.send_event(0, {"freq": 330.0, "note_on": True})
            c.record_start()
            c.read_block()
            c.close()  # bye without record_stop
            import time

            deadline = 100
            while not list(tmp_path.glob("*.wav")) and deadline:
                time.sleep(0.1)
                deadline -= 1
            assert list(tmp_path.glob("*.wav"))

    def test_recording_disabled_without_dir(self):
        with make_server() as srv:
            c = LiveClient(srv.host, srv.port)
            import json

            c.sock.sendall(json.dumps({"op": "record_start"}).encode()
                           + b"\n")
            with pytest.raises((RuntimeError, EOFError)):
                for _ in range(50):
                    c.read_control()
            c.sock.close()


class TestLifecycle:
    def test_disconnect_frees_lane_for_next_client(self):
        with make_server(initial_lanes=1, max_lanes=1) as srv:
            a = LiveClient(srv.host, srv.port)
            lane_a = a.welcome["lane"]
            a.read_block()
            a.close()
            # server notices the goodbye and detaches; the next client
            # reuses the slot
            deadline = 300  # generous: the 1-core CI box schedules slowly
            while srv.num_clients and deadline:
                import time

                time.sleep(0.1)
                deadline -= 1
            assert srv.num_clients == 0
            b = LiveClient(srv.host, srv.port)
            try:
                assert b.welcome["lane"] == lane_a
                b.read_block()
            finally:
                b.close()

    def test_stale_detach_cannot_kill_reused_lane(self):
        """The render loop's targets snapshot can hit a dead socket AFTER
        its lane was detached and re-claimed by a new client; the stale
        OSError detach must not release the new client's lane (it would
        starve until its read timeout — the intermittent lifecycle flake)."""
        with make_server(initial_lanes=1, max_lanes=1) as srv:
            a = LiveClient(srv.host, srv.port)
            lane = a.welcome["lane"]
            a.read_block()
            with srv._lock:
                stale_sock = srv._clients[lane][0]
            a.close()
            wait_detached(srv)
            b = LiveClient(srv.host, srv.port)
            try:
                assert b.welcome["lane"] == lane  # slot reused
                # replay the race: a stale detach with A's old socket
                srv._detach(lane, orderly=False, expected_sock=stale_sock)
                assert srv.num_clients == 1  # B untouched
                b.read_block()  # still streaming
            finally:
                b.close()

    def test_server_full_refused(self):
        with make_server(initial_lanes=1, max_lanes=1) as srv:
            a = LiveClient(srv.host, srv.port)
            try:
                with pytest.raises(RuntimeError, match="full"):
                    LiveClient(srv.host, srv.port)
                # the first client keeps streaming fine
                a.send_event(0, {"freq": 440.0, "note_on": True})
                assert read_until_audible(a) > 100
            finally:
                a.close()

    def test_growth_beyond_initial_lanes(self):
        """A third client on a 2-lane fleet grows it (one re-trace) without
        disturbing connected clients."""
        with make_server(initial_lanes=2, max_lanes=8) as srv:
            clients = [LiveClient(srv.host, srv.port) for _ in range(3)]
            try:
                lanes = {c.welcome["lane"] for c in clients}
                assert len(lanes) == 3
                clients[2].send_event(0, {"freq": 550.0, "note_on": True})
                assert read_until_audible(clients[2]) > 100
                for c in clients[:2]:  # others keep streaming fine
                    for _ in range(4):
                        c.read_block()
            finally:
                for c in clients:
                    c.close()
