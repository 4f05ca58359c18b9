"""The Bach Toccata & Fugue song: the framework's flagship render config.

Mirrors examples/example_song.zig: three instruments driven by the parsed
tracker text (zang_tpu/data/bach_toccata.npz, produced by
tools/import_song.py from the public-domain transcription):

  Pedal        = PMOscInstrument(release 0.4), freq * 0.5, polyphony 3
  RegularOrgan = NiceInstrument(color 0.25),               polyphony 10
  WeirdOrgan   = NiceInstrument(color 0.1),                polyphony 4

Offline render config (examples/write_wav.zig): 48 kHz, mono, 385 s,
mixdown volume 0.25, s16.
"""

import os
from typing import List

import numpy as np

from ..core.mixdown import mixdown_s16_np
from ..core.notes import SongEvent
from ..core.timeline import compile_timelines
from ..graph.render import Performance, render_performance
from . import instruments as ti

F32 = np.float32

SAMPLE_RATE = 48000.0
NUM_SECONDS = 6 * 60 + 25  # 385 (write_wav.zig:7)
MIX_VOLUME = 0.25

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "bach_toccata.npz")

PEDAL, REGULAR, WEIRD = 0, 1, 2
POLYPHONY = {PEDAL: 3, REGULAR: 10, WEIRD: 4}


def load_song() -> List[List[SongEvent]]:
    """Per-instrument chronological SongEvent lists."""
    z = np.load(_DATA)
    out = []
    for i in range(3):
        ev = [
            SongEvent(
                {"freq": float(f), "note_on": bool(on)}, t=float(t), note_id=int(nid)
            )
            for t, nid, f, on in zip(z[f"t_{i}"], z[f"id_{i}"], z[f"freq_{i}"], z[f"on_{i}"])
        ]
        out.append(ev)
    return out


def pedal_freq(p) -> F32:
    # example_song.zig:36: freq * 0.5 in f32
    return F32(F32(p["freq"]) * F32(0.5))


def build_performance(total_frames: int, song=None) -> Performance:
    song = song or load_song()
    tls = [
        compile_timelines(song[i], POLYPHONY[i], SAMPLE_RATE, total_frames)
        for i in range(3)
    ]
    # RegularOrgan (color 0.25) + WeirdOrgan (color 0.1) share the pulse ->
    # SVF -> ADSR topology, so they merge into ONE 14-voice part with a
    # per-voice color — one filter kernel invocation per chunk instead of
    # two (mix order changes, bounded by the -90 dBFS parity budget)
    organ_colors = np.array(
        [0.25] * POLYPHONY[REGULAR] + [0.1] * POLYPHONY[WEIRD], np.float32
    )
    return Performance(
        [
            (ti.PMOscInstrument(0.4, freq_fn=pedal_freq), tls[PEDAL]),
            (ti.NiceInstrument(organ_colors), tls[REGULAR] + tls[WEIRD]),
        ],
        SAMPLE_RATE,
    )


def render_song(seconds: float = NUM_SECONDS, chunk_size: int = 65536) -> np.ndarray:
    """Device render of the song -> f32 [total] mix (pre-mixdown)."""
    total = int(seconds * SAMPLE_RATE)
    perf = build_performance(total)
    return render_performance(perf, total, chunk_size=chunk_size)[0]


def render_song_s16(seconds: float = NUM_SECONDS, chunk_size: int = 65536) -> np.ndarray:
    return mixdown_s16_np(render_song(seconds, chunk_size), MIX_VOLUME)


# --------------------------------------------------------------------------
# Oracle twin (golden source) — reference block/span engine.


def build_oracle_voices(mode: str = "parity", song=None):
    from ..oracle import engine as oe
    from ..oracle import instruments as oi

    song = song or load_song()

    def mk_params_pedal(sr, p):
        return {"sample_rate": sr, "freq": pedal_freq(p), "note_on": p["note_on"]}

    def mk_params(sr, p):
        return {"sample_rate": sr, "freq": p["freq"], "note_on": p["note_on"]}

    return [
        oe.Voice(song[PEDAL], 3, lambda: oi.PMOscInstrument(0.4, mode=mode), mk_params_pedal),
        oe.Voice(song[REGULAR], 10, lambda: oi.NiceInstrument(0.25, mode=mode), mk_params),
        oe.Voice(song[WEIRD], 4, lambda: oi.NiceInstrument(0.1, mode=mode), mk_params),
    ]


def render_song_oracle(seconds: float = NUM_SECONDS, mode: str = "parity") -> np.ndarray:
    from ..oracle import engine as oe

    total = int(seconds * SAMPLE_RATE)
    voices = build_oracle_voices(mode)

    def paint(span, outputs, temps):
        for v in voices:
            v.paint(span, SAMPLE_RATE, outputs, temps)

    return oe.render_blocks(paint, total, num_outputs=1, num_temps=3)[0]
