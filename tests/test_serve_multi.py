"""Multi-instrument serving (serve/server.py MultiInstrumentServer): one
TCP port, one fleet per instrument spec, clients routed by their hello
frame. The reference's 19 example programs are 19 instruments picked at
launch (build.zig run steps); here one endpoint hosts them concurrently.

Non-realtime mode so the tests pace the stream by reading (same
convention as tests/test_serve_server.py)."""

import json
import socket

import numpy as np
import pytest

from zang_tpu.host import instruments as ti
from zang_tpu.serve.server import LiveClient, MultiInstrumentServer

SR = 48000.0
BLOCK = 1024


def make_multi(**kw):
    specs = {
        "nice": {"make_parts": lambda: [(ti.NiceInstrument(0.3), 2)],
                 "sample_rate": SR},
        "hard": {"make_parts": lambda: [(ti.HardSquareInstrument(), 2)],
                 "sample_rate": SR},
    }
    kw.setdefault("initial_lanes", 1)
    kw.setdefault("realtime", False)
    kw.setdefault("block_size", BLOCK)
    kw.setdefault("hello_timeout", 2.0)
    return MultiInstrumentServer(specs, port=0, **kw)


def read_until_audible(c, max_blocks=200):
    for _ in range(max_blocks):
        p = float(np.abs(c.read_block()).max())
        if p > 100:
            return p
    raise AssertionError(f"no audible block within {max_blocks}")


class TestRouting:
    def test_hello_picks_instrument(self):
        with make_multi() as srv:
            c = LiveClient(srv.host, srv.port, instrument="hard")
            try:
                assert c.welcome["instrument"] == "hard"
                c.send_event(0, {"freq": 440.0, "note_on": True})
                assert read_until_audible(c) > 100
            finally:
                c.close()
            # only the requested backend was instantiated (lazy fleets)
            assert set(srv._backends) == {"hard"}

    def test_default_instrument_without_name(self):
        with make_multi(default_instrument="nice") as srv:
            c = LiveClient(srv.host, srv.port)  # bare hello
            try:
                assert c.welcome["instrument"] == "nice"
            finally:
                c.close()

    def test_unknown_instrument_refused(self):
        with make_multi() as srv:
            with pytest.raises(RuntimeError, match="unknown instrument"):
                LiveClient(srv.host, srv.port, instrument="nope")

    def test_non_hello_first_frame_routes_default(self):
        """A client whose first frame is an event (no hello) lands on the
        default instrument and the frame is processed, not dropped."""
        with make_multi(default_instrument="nice") as srv:
            sock = socket.create_connection((srv.host, srv.port),
                                            timeout=60.0)
            try:
                sock.sendall(json.dumps(
                    {"op": "event", "part": 0,
                     "params": {"freq": 330.0, "note_on": True}}
                ).encode() + b"\n")
                # welcome arrives after routing
                buf = b""
                while b"\n" not in buf:
                    buf += sock.recv(65536)
                line, buf = buf.split(b"\n", 1)
                w = json.loads(line)
                assert w["op"] == "welcome"
                assert w["instrument"] == "nice"
                # the event made it into the lane: scan for audio
                peak = 0.0
                for _ in range(200):
                    while b"\n" not in buf:
                        buf += sock.recv(65536)
                    line, buf = buf.split(b"\n", 1)
                    hdr = json.loads(line)
                    assert hdr["op"] == "block", hdr
                    while len(buf) < hdr["nbytes"]:
                        buf += sock.recv(65536)
                    raw, buf = buf[:hdr["nbytes"]], buf[hdr["nbytes"]:]
                    peak = float(np.abs(
                        np.frombuffer(raw, np.dtype("<i2"))).max())
                    if peak > 100:
                        break
                assert peak > 100
            finally:
                sock.close()

    def test_two_instruments_concurrently(self):
        """Two clients on different instruments stream simultaneously,
        each from its own fleet."""
        with make_multi() as srv:
            a = LiveClient(srv.host, srv.port, instrument="nice")
            b = LiveClient(srv.host, srv.port, instrument="hard")
            try:
                # both welcomes arrived, so both lanes are attached; check
                # BEFORE draining (a one-sided drain lets the unread
                # socket back up past the server's send timeout)
                assert set(srv._backends) == {"nice", "hard"}
                assert srv.num_clients == 2
                a.send_event(0, {"freq": 440.0, "note_on": True})
                b.send_event(0, {"freq": 220.0, "note_on": True})
                # interleave reads so neither fleet's stream backs up. In
                # non-realtime mode a fleet renders ahead into its socket
                # buffers (megabytes: thousands of blocks); while the other
                # fleet compiles, hundreds of silent blocks can precede the
                # note-on
                peak_a = peak_b = 0.0
                for _ in range(5000):
                    peak_a = max(peak_a, float(np.abs(a.read_block()).max()))
                    peak_b = max(peak_b, float(np.abs(b.read_block()).max()))
                    if peak_a > 100 and peak_b > 100:
                        break
                assert peak_a > 100 and peak_b > 100
            finally:
                a.close()
                b.close()


class TestDiscovery:
    def test_instruments_op_returns_menu_without_a_lane(self):
        from zang_tpu.serve.server import list_instruments

        with make_multi(default_instrument="hard") as srv:
            menu = list_instruments(srv.host, srv.port)
            assert menu["op"] == "instruments"
            assert set(menu["available"]) == {"nice", "hard"}
            assert menu["default"] == "hard"
            assert srv.num_clients == 0
            assert srv._backends == {}  # discovery never builds a fleet


class TestObservability:
    def test_per_connection_stats_name_the_fleet(self):
        with make_multi() as srv:
            c = LiveClient(srv.host, srv.port, instrument="hard")
            try:
                c.send_event(0, {"freq": 440.0, "note_on": True})
                read_until_audible(c)  # stats after blocks flow
                st = c.stats()
                assert st["instrument"] == "hard"
                assert st["clients"] == 1
            finally:
                c.close()

    def test_aggregate_stats(self):
        with make_multi() as srv:
            c = LiveClient(srv.host, srv.port, instrument="nice")
            try:
                st = srv.stats()
                assert st["clients"] == 1
                assert set(st["available"]) == {"nice", "hard"}
                assert set(st["instruments"]) == {"nice"}
                assert st["instruments"]["nice"]["instrument"] == "nice"
            finally:
                c.close()


class TestResume:
    def test_resume_lands_on_same_instrument_fleet(self):
        """A blipped session resumes on the fleet the token belongs to:
        the note keeps ringing after reconnect+resume (same flow as the
        single-instrument server, through the routing layer)."""
        with make_multi(resume_ttl=60.0, send_timeout=0.5) as srv:
            c = LiveClient(srv.host, srv.port, instrument="nice")
            token = c.welcome["resume_token"]
            c.send_event(0, {"freq": 440.0, "note_on": True})
            read_until_audible(c)
            # unplanned drop: reset, no bye — server retains on its next
            # failed block send
            c.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                              b"\x01\x00\x00\x00\x00\x00\x00\x00")
            c.sock.close()
            import time
            blob = None
            for _ in range(100):  # wait for the server to notice + retain
                time.sleep(0.1)
                be = srv.backend("nice")
                with be._lock:
                    if token in be._retained:
                        blob = True
                        break
            assert blob, "server never retained the blipped session"
            c2 = LiveClient(srv.host, srv.port, instrument="nice")
            try:
                frame = c2.resume(token)
                assert frame > 0
                # the held note is still sounding in the restored lane
                assert read_until_audible(c2) > 100
            finally:
                c2.close()


class TestRouterResilience:
    def test_garbage_first_frame_gets_error_and_server_survives(self):
        with make_multi() as srv:
            sock = socket.create_connection((srv.host, srv.port),
                                            timeout=30.0)
            try:
                sock.sendall(b"\x00\xff not json at all\n")
                buf = b""
                while b"\n" not in buf:
                    chunk = sock.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
                if buf:
                    msg = json.loads(buf.split(b"\n", 1)[0])
                    assert msg["op"] == "error"
            finally:
                sock.close()
            # no lane leaked, and the port still serves
            assert srv.num_clients == 0
            c = LiveClient(srv.host, srv.port, instrument="nice")
            try:
                assert c.welcome["op"] == "welcome"
            finally:
                c.close()

    def test_broken_instrument_reports_instead_of_hanging(self):
        """A spec whose fleet fails to construct sends the client an
        error frame (not a silent hang until timeout), and the other
        instruments keep serving."""
        def boom():
            raise RuntimeError("synth exploded")

        specs = {
            "ok": {"make_parts": lambda: [(ti.NiceInstrument(0.3), 2)],
                   "sample_rate": SR},
            "broken": {"make_parts": boom, "sample_rate": SR},
        }
        with MultiInstrumentServer(specs, port=0, initial_lanes=1,
                                   realtime=False, block_size=BLOCK) as srv:
            with pytest.raises(RuntimeError, match="failed to start"):
                LiveClient(srv.host, srv.port, instrument="broken")
            c = LiveClient(srv.host, srv.port, instrument="ok")
            try:
                assert c.welcome["instrument"] == "ok"
            finally:
                c.close()

    def test_connect_and_leave_allocates_nothing(self):
        with make_multi() as srv:
            sock = socket.create_connection((srv.host, srv.port),
                                            timeout=30.0)
            sock.close()
            import time
            time.sleep(0.3)
            assert srv.num_clients == 0
            assert srv._backends == {}  # no fleet was built for a probe


class TestValidation:
    def test_missing_spec_fields_rejected(self):
        with pytest.raises(ValueError, match="missing 'sample_rate'"):
            MultiInstrumentServer(
                {"x": {"make_parts": lambda: []}}, port=0)

    def test_bad_default_rejected(self):
        with pytest.raises(ValueError, match="default_instrument"):
            MultiInstrumentServer(
                {"x": {"make_parts": lambda: [], "sample_rate": SR}},
                default_instrument="y", port=0)
