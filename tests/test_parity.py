"""Device-vs-oracle parity: the golden fidelity tests.

Renders the same performance with (a) the oracle engine in parity mode
(sequential per-sample C++/NumPy, reference block/span/event driver) and
(b) the device engine (chunked scans, gather programs), and requires the final
mixes to agree below -90 dBFS RMS.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from zang_tpu.core.notes import SongEvent
from zang_tpu.core.timeline import compile_timelines
from zang_tpu.graph.fidelity import deviation_dbfs
from zang_tpu.graph.render import Performance, render_performance
from zang_tpu.oracle import engine as oracle_engine
from zang_tpu.oracle import instruments as oracle_instruments
from zang_tpu.host import instruments as dev_instruments

SR = 44100.0
F32 = np.float32


def make_song(seed=0, num_notes=12, base=220.0, dur=0.22, gap=0.18):
    """Overlapping melody exercising polyphony + release tails."""
    rng = np.random.default_rng(seed)
    song = []
    t = 0.0
    for i in range(num_notes):
        f = base * 2 ** (rng.integers(0, 13) / 12.0)
        nid = i + 1
        song.append(SongEvent({"freq": float(F32(f)), "note_on": True}, t=t, note_id=nid))
        song.append(
            SongEvent({"freq": float(F32(f)), "note_on": False}, t=t + dur, note_id=nid)
        )
        t += gap
    song.sort(key=lambda e: (e.t, e.note_id))
    return song


def oracle_render(song, polyphony, make_module, make_params, total, num_temps):
    voice = oracle_engine.Voice(song, polyphony, make_module, make_params)
    return oracle_engine.render_blocks(
        lambda span, o, t: voice.paint(span, SR, o, t),
        total_frames=total,
        num_temps=num_temps,
    )[0]


def dev_render(song, polyphony, instrument, total, chunk=8192):
    tls = compile_timelines(song, polyphony, SR, total, block_size=1024)
    perf = Performance([(instrument, tls)], SR)
    return render_performance(perf, total, chunk_size=chunk)[0]


def report(name, dev):
    print(f"\n{name}: rms {dev[0]:.1f} dBFS, peak {dev[1]:.1f} dBFS")


class TestPMOscParity:
    def test_pm_osc_instrument(self):
        song = make_song(seed=1)
        total = int(3.0 * SR)

        def make_module():
            return oracle_instruments.PMOscInstrument(0.4, mode="parity")

        def make_params(sr, p):
            return {"sample_rate": sr, "freq": p["freq"], "note_on": p["note_on"]}

        a = oracle_render(song, 3, make_module, make_params, total, num_temps=3)
        b = dev_render(song, 3, dev_instruments.PMOscInstrument(0.4), total)
        dev = deviation_dbfs(a, b)
        report("pm_osc", dev)
        assert dev[0] < -90.0, dev


class TestNiceParity:
    def test_nice_instrument(self):
        song = make_song(seed=2)
        total = int(3.0 * SR)

        def make_module():
            return oracle_instruments.NiceInstrument(0.25, mode="parity")

        def make_params(sr, p):
            return {"sample_rate": sr, "freq": p["freq"], "note_on": p["note_on"]}

        a = oracle_render(song, 4, make_module, make_params, total, num_temps=2)
        b = dev_render(song, 4, dev_instruments.NiceInstrument(0.25), total)
        dev = deviation_dbfs(a, b)
        report("nice", dev)
        assert dev[0] < -90.0, dev


class TestHardSquareParity:
    def test_hard_square_bit_exact(self):
        # pulse osc + gate involves no transcendentals: should be bit-exact
        song = make_song(seed=3, base=110.0)
        total = int(2.0 * SR)

        def make_module():
            return oracle_instruments.HardSquareInstrument(mode="parity")

        def make_params(sr, p):
            return {"sample_rate": sr, "freq": p["freq"], "note_on": p["note_on"]}

        a = oracle_render(song, 2, make_module, make_params, total, num_temps=2)
        b = dev_render(song, 2, dev_instruments.HardSquareInstrument(), total)
        dev = deviation_dbfs(a, b)
        report("hard_square", dev)
        assert dev[1] < -120.0, dev  # ulp-level: XLA f32 division differs by 1 ulp from IEEE


class TestChunkInvariance:
    def test_chunk_size_does_not_change_output(self):
        song = make_song(seed=4)
        total = int(1.5 * SR)
        inst = dev_instruments.NiceInstrument(0.25)
        a = dev_render(song, 2, inst, total, chunk=4096)
        b = dev_render(song, 2, dev_instruments.NiceInstrument(0.25), total, chunk=16384)
        # oscillators/envelopes are bit-invariant to chunking; the filter's
        # associative-scan tree shape depends on chunk length, so outputs may
        # differ by ~1 ulp there.
        dev = deviation_dbfs(a, b)
        report("chunk_invariance", dev)
        assert dev[1] < -120.0, dev
