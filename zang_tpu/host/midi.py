"""MIDI file input: Standard MIDI File -> SongEvent lists -> rendered WAV.

The reference's note-input surfaces are tracker text
(examples/common/songparse1.zig) and live keypresses (examples/common.zig
keyboard map); this module adds the de-facto interchange format on top of
the same event model. Stdlib-only SMF parser (format 0/1, running status,
merged tempo map), channel- or track-grouped note streams with the
framework's event semantics — note_id on/off pairing exactly like the
tracker parser's per-column pairing (host/songparse.py:197-224 /
songparse1.zig:29-63: a new note on an active key first releases the old
one), offs sorted before ons inside one tick — and a render CLI over the
stock serving instruments (serve/server.py builtin_instruments).

Timing: MIDI ticks convert to seconds in f64 through the tempo map (a new
surface, so no f32-accumulation contract to honor — the NoteTracker
quantizes the resulting times with its own reference-exact f32 block
arithmetic downstream, core/notes.py:101-157).

    python -m zang_tpu.host.midi song.mid out.wav --instrument nice
"""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..core.notes import SongEvent

__all__ = ["parse_smf", "midi_songs", "render_midi", "main"]

DEFAULT_USPQ = 500_000  # 120 bpm, the SMF default tempo


class MidiError(ValueError):
    pass


@dataclass
class Smf:
    """A parsed Standard MIDI File, note/tempo events only."""

    fmt: int
    division: int  # ticks per quarter note (SMPTE divisions rejected)
    # per input track: (abs_tick, channel, key, velocity) — velocity 0 = off
    notes: List[List[Tuple[int, int, int, int]]]
    tempos: List[Tuple[int, int]] = field(default_factory=list)  # (tick, uspq)
    # lazy cumulative tempo index: (seg_ticks, seg_seconds, seg_uspq, n)
    _cum: Optional[tuple] = field(
        default=None, repr=False, compare=False)

    def _tempo_index(self) -> tuple:
        """Cumulative seconds per tempo segment, built once — seconds() is
        called per note event, and a set-tempo-dense file would otherwise
        cost O(notes * tempos) rescans."""
        cache = self._cum
        if cache is None or cache[3] != len(self.tempos):
            ticks, secs, uspqs = [0], [0.0], [DEFAULT_USPQ]
            for tt, uu in self.tempos:
                if tt <= ticks[-1]:
                    # duplicate tick (or tick 0): the later tempo governs
                    uspqs[-1] = uu
                    continue
                secs.append(secs[-1]
                            + (tt - ticks[-1]) * uspqs[-1] * 1e-6
                            / self.division)
                ticks.append(tt)
                uspqs.append(uu)
            cache = (ticks, secs, uspqs, len(self.tempos))
            object.__setattr__(self, "_cum", cache)
        return cache

    def seconds(self, tick: int) -> float:
        """Absolute tick -> seconds through the merged tempo map
        (O(log tempos) via the cumulative index)."""
        import bisect

        ticks, secs, uspqs, _n = self._tempo_index()
        j = max(0, bisect.bisect_right(ticks, tick) - 1)
        return secs[j] + (tick - ticks[j]) * uspqs[j] * 1e-6 / self.division


def _varlen(data: bytes, i: int, end: Optional[int] = None) -> Tuple[int, int]:
    limit = len(data) if end is None else end
    v = 0
    for _ in range(4):
        if i >= limit:
            raise MidiError("truncated variable-length quantity")
        b = data[i]
        i += 1
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            return v, i
    raise MidiError("variable-length quantity longer than 4 bytes")


def parse_smf(data: bytes) -> Smf:
    """Parse an SMF (format 0 or 1). Keeps note on/off and set-tempo;
    skips every other channel/meta/sysex message by length. Running
    status honored; tempo events from ALL tracks merge into one map (the
    format-1 convention — the tempo track governs the whole file)."""
    if len(data) < 14 or data[:4] != b"MThd":
        raise MidiError("not a MIDI file (missing MThd)")
    hlen = int.from_bytes(data[4:8], "big")
    fmt = int.from_bytes(data[8:10], "big")
    ntrks = int.from_bytes(data[10:12], "big")
    division = int.from_bytes(data[12:14], "big")
    if fmt not in (0, 1):
        raise MidiError(f"unsupported SMF format {fmt} (only 0/1)")
    if division & 0x8000:
        raise MidiError("SMPTE time division is not supported")
    if division == 0:
        raise MidiError("zero ticks-per-quarter division")

    smf = Smf(fmt, division, [])
    i = 8 + hlen
    for _ in range(ntrks):
        if i + 8 > len(data):
            raise MidiError("truncated track header")
        if data[i:i + 4] != b"MTrk":
            raise MidiError(f"expected MTrk at byte {i}")
        tlen = int.from_bytes(data[i + 4:i + 8], "big")
        i += 8
        end = i + tlen
        if end > len(data):
            raise MidiError("track length past end of file")
        notes: List[Tuple[int, int, int, int]] = []
        tick = 0
        status = 0

        # every data-byte read is bounded by the track's declared `end`:
        # a truncated/crafted file must fail as MidiError (HTTP tier: 400),
        # never IndexError, and never silently read into the next track
        def need(pos: int, n: int) -> None:
            if pos + n > end:
                raise MidiError("truncated track")

        while i < end:
            dt, i = _varlen(data, i, end)
            tick += dt
            need(i, 1)
            b = data[i]
            if b & 0x80:
                status = b
                i += 1
            elif status == 0:
                raise MidiError(f"running status with no status byte at {i}")
            kind = status & 0xF0
            ch = status & 0x0F
            if kind in (0x80, 0x90):  # note off / note on
                need(i, 2)
                key, vel = data[i], data[i + 1]
                i += 2
                if kind == 0x80:
                    vel = 0  # note-off velocity is release info; drop it
                notes.append((tick, ch, key, vel))
            elif kind in (0xA0, 0xB0, 0xE0):  # 2-byte channel messages
                need(i, 2)
                i += 2
            elif kind in (0xC0, 0xD0):  # 1-byte channel messages
                need(i, 1)
                i += 1
            elif status == 0xFF:  # meta
                need(i, 1)
                mtype = data[i]
                mlen, i = _varlen(data, i + 1, end)
                need(i, mlen)
                if mtype == 0x51 and mlen == 3:
                    smf.tempos.append(
                        (tick, int.from_bytes(data[i:i + 3], "big")))
                i += mlen
                if mtype == 0x2F:  # end of track
                    break
            elif status in (0xF0, 0xF7):  # sysex
                slen, i = _varlen(data, i, end)
                need(i, slen)
                i += slen
            else:
                raise MidiError(f"unhandled status byte 0x{status:02x}")
        smf.notes.append(notes)
        i = end
    smf.tempos.sort(key=lambda p: p[0])
    return smf


def midi_songs(
    data: bytes,
    group: str = "channel",
    include_velocity: bool = False,
    transpose: int = 0,
    a4: float = 440.0,
    skip_channels: Tuple[int, ...] = (),
) -> List[Tuple[str, List[SongEvent], int]]:
    """SMF bytes -> [(label, chronological SongEvents, max_polyphony)].

    group="channel" makes one part per MIDI channel (the GM convention:
    a channel is an instrument); group="track" makes one per SMF track.
    Key -> frequency is equal temperament around a4 (A4 = key 69), the
    same tuning the 12-TET table encodes (core/twelve_tet.py). A note-on
    for a key already sounding releases the old note first (tracker-column
    semantics, host/songparse.py:213-219); inside one tick, offs sort
    before ons via note_id order (songparse.py:227-229). Velocity becomes
    a "velocity" param in [0, 1] when include_velocity (instruments that
    don't read it are unaffected; DSL synths can export it)."""
    smf = parse_smf(data)
    merged = []  # (tick, file order, track index, ch, key, vel)
    for ti, notes in enumerate(smf.notes):
        for oi, (tick, ch, key, vel) in enumerate(notes):
            if ch in skip_channels:
                continue
            merged.append((tick, ti, oi, ch, key, vel))
    merged.sort(key=lambda e: (e[0], e[1], e[2]))

    labels: List[str] = []
    songs: List[List[SongEvent]] = []
    index = {}  # group key -> part index
    active = {}  # (part, key) -> [(note_id, freq, velocity), ...] stack
    next_id = 1

    def part_of(ti: int, ch: int) -> int:
        gk = ch if group == "channel" else ti
        if gk not in index:
            index[gk] = len(songs)
            labels.append(f"{group} {gk}")
            songs.append([])
        return index[gk]

    def emit(part, tick, nid, freq, vel, on):
        params = {"freq": np.float32(freq), "note_on": bool(on)}
        if include_velocity:
            params["velocity"] = np.float32(vel)
        songs[part].append(
            SongEvent(params, t=smf.seconds(tick), note_id=nid))

    if group not in ("channel", "track"):
        raise MidiError(f"group must be 'channel' or 'track', not {group!r}")
    tick_start: List[int] = []
    last_tick = None
    for tick, ti, _oi, ch, key, vel in merged:
        if tick != last_tick:
            # close the previous tick group: offs before ons (stable by id)
            for p, s in enumerate(tick_start):
                songs[p][s:] = sorted(songs[p][s:], key=lambda e: e.note_id)
            last_tick = tick
            tick_start = [len(s) for s in songs]
        part = part_of(ti, ch)
        while len(tick_start) < len(songs):
            tick_start.append(len(songs[len(tick_start)]))
        stack = active.setdefault((part, key), [])
        if vel > 0:
            if stack:  # retrigger: release the sounding note first
                nid0, freq0, vel0 = stack.pop()
                emit(part, tick, nid0, freq0, vel0, False)
            freq = a4 * 2.0 ** ((key + transpose - 69) / 12.0)
            emit(part, tick, next_id, freq, vel / 127.0, True)
            stack.append((next_id, freq, vel / 127.0))
            next_id += 1
        elif stack:
            nid0, freq0, vel0 = stack.pop()
            emit(part, tick, nid0, freq0, vel0, False)
    for p, s in enumerate(tick_start):
        songs[p][s:] = sorted(songs[p][s:], key=lambda e: e.note_id)

    out = []
    for label, song in zip(labels, songs):
        depth = peak = 0
        for ev in song:
            depth += 1 if ev.params["note_on"] else -1
            peak = max(peak, depth)
        out.append((label, song, max(1, peak)))
    return out


def render_midi(
    data: bytes,
    make_instrument,
    sample_rate: float = 48000.0,
    seconds: Optional[float] = None,
    tail: float = 2.0,
    polyphony: Optional[int] = None,
    chunk_size: int = 16384,
    max_parts: Optional[int] = None,
    max_events: Optional[int] = None,
    **song_kwargs,
) -> np.ndarray:
    """Render SMF bytes to f32 audio [channels, frames].

    make_instrument(part_index, label) -> instrument; polyphony defaults
    to each part's measured peak concurrency (capped at 16). Length is
    the last event + `tail` seconds of release unless `seconds` caps it.

    max_parts / max_events bound the render's cost for untrusted input
    (the HTTP tier sets both): group='track' is otherwise uncapped — a
    small SMF of minimal tracks yields thousands of parts, each an
    instrument instance unrolled into the traced graph.
    """
    from ..core.timeline import compile_timelines
    from ..graph.render import Performance, render_performance

    parts = midi_songs(data, **song_kwargs)
    if not any(song for _l, song, _p in parts):
        raise MidiError("MIDI file contains no notes")
    nonempty = sum(1 for _l, song, _p in parts if song)
    if max_parts is not None and nonempty > max_parts:
        raise MidiError(
            f"MIDI file has {nonempty} non-empty parts; this renderer "
            f"accepts at most {max_parts} (try group='channel')")
    total_events = sum(len(song) for _l, song, _p in parts)
    if max_events is not None and total_events > max_events:
        raise MidiError(
            f"MIDI file has {total_events} note events; this renderer "
            f"accepts at most {max_events}")
    length = max(ev.t for _l, song, _p in parts for ev in song) + tail
    if seconds is not None:
        length = min(length, seconds)
    total = int(length * sample_rate)
    perf_parts = []
    for pi, (label, song, peak) in enumerate(parts):
        if not song:
            continue
        poly = polyphony if polyphony is not None else min(16, peak)
        tls = compile_timelines(song, poly, sample_rate, total)
        perf_parts.append((make_instrument(pi, label), tls))
    return render_performance(
        Performance(perf_parts, sample_rate), total,
        chunk_size=min(chunk_size, max(256, total)))


def stock_instruments() -> dict:
    """Name -> zero-arg factory for the stock example instruments (the
    same menu zang-serve offers, serve/server.py builtin_instruments)."""
    from . import instruments as ti

    return {
        "nice": lambda: ti.NiceInstrument(0.3),
        "pmosc": lambda: ti.PMOscInstrument(1.0),
        "hardsquare": lambda: ti.HardSquareInstrument(),
        "filteredsaw": lambda: ti.FilteredSawtoothInstrument(),
        "weirdsquare": lambda: ti.SquareWithEnvelope(weird=True),
    }


def _instrument_maker(name: str, allow_script: bool = True):
    """Instrument name -> zero-arg factory: a stock serving instrument or
    (allow_script, for trusted local callers only — it reads the named
    file) a zangscript FILE.txt[:Module]."""
    import os

    stock = stock_instruments()
    if name in stock:
        return stock[name]
    if not allow_script:
        raise MidiError(
            f"unknown instrument {name!r}; available: {sorted(stock)}")
    path, module = name, None
    if not os.path.exists(path) and ":" in path:
        path, _, module = path.rpartition(":")
    if os.path.exists(path):
        from ..script.compile import compile_script
        from ..script.jax_backend import ScriptInstrument

        with open(path) as f:
            cs = compile_script(f.read(), filename=path)
        names = [em.name for em in cs.exported_modules]
        if not names:
            raise MidiError(f"{path}: script exports no modules")
        mod = module or names[-1]
        if mod not in names:
            raise MidiError(f"{path}: no exported module {mod!r} "
                            f"(available: {names})")
        return lambda: ScriptInstrument(cs, mod)
    raise MidiError(
        f"unknown instrument {name!r}; stock: {sorted(stock)}, or a "
        f"zangscript FILE.txt[:Module]")


def replay_live(
    data: bytes,
    client,
    rate: float = 1.0,
    group: str = "channel",
    include_velocity: bool = False,
    transpose: int = 0,
    skip_channels: Tuple[int, ...] = (9,),
    now=None,
    sleep=None,
) -> int:
    """Replay an SMF in wall-clock time into a live server lane.

    Beyond the reference (whose only live input is the SDL keyboard):
    the file's note events go over the existing raw-event wire op
    ({"op": "event"} with explicit note_id pairing — serve/server.py),
    so velocity rides along as a note param when include_velocity and the
    lane hears the exact event stream the offline renderer would compile.
    Channel/track groups cycle over the lane instrument's parts (the
    welcome frame's num_parts). `rate` scales playback speed (tests replay
    fast); returns the number of events sent.
    """
    import time as _time

    now = now or _time.monotonic
    sleep = sleep or _time.sleep
    parts = midi_songs(data, group=group, include_velocity=include_velocity,
                       transpose=transpose, skip_channels=skip_channels)
    nparts = max(1, int(client.welcome.get("num_parts", 1)))
    stream = []
    for gi, (_label, song, _poly) in enumerate(parts):
        p = gi % nparts
        for ev in song:
            # JSON wire: numpy scalars -> plain floats
            params = {k: (bool(v) if isinstance(v, (bool, np.bool_)) else
                          float(v))
                      for k, v in ev.params.items()}
            stream.append((float(ev.t), ev.note_id, p, params))
    # merged parts stay chronological; same-instant events keep note_id
    # order, which puts each off (old, smaller id) before the on that
    # replaces it — the tracker-column pairing midi_songs encodes
    stream.sort(key=lambda e: (e[0], e[1]))
    t0 = now()
    for t, nid, p, params in stream:
        dt = t / rate - (now() - t0)
        if dt > 0:
            sleep(dt)
        client.send_event(p, params, note_id=nid)
    return len(stream)


def main(argv=None) -> int:
    """CLI: python -m zang_tpu.host.midi song.mid out.wav [options]"""
    import argparse

    from ..platform import enable_compile_cache

    enable_compile_cache()

    ap = argparse.ArgumentParser(
        prog="zang-midi",
        description="Render a Standard MIDI File to WAV with the stock "
                    "instruments (or a zangscript synth), or replay it "
                    "live into a running zang-serve server (--live).")
    ap.add_argument("midi")
    ap.add_argument("output", nargs="?",
                    help="output WAV (offline mode; omit with --live)")
    ap.add_argument("--instrument", default=None,
                    help="offline: instrument name, a comma list cycled "
                         "over parts, or SCRIPT.txt[:Module] (default "
                         "nice); live: the server-menu instrument to "
                         "attach to (default: the server's default)")
    ap.add_argument("--live", action="store_true",
                    help="replay into a live server in wall-clock time "
                         "instead of rendering offline")
    ap.add_argument("--host", default="127.0.0.1", help="live server host")
    ap.add_argument("--port", type=int, default=9800, help="live server port")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="live playback speed multiplier")
    ap.add_argument("--wav", help="live: capture the returned stream to WAV")
    ap.add_argument("--sink", metavar="CMD",
                    help="live: pipe audio into a player command's stdin "
                         "(see zang-play --sink)")
    ap.add_argument("--tail", type=float, default=1.5,
                    help="live: seconds to keep draining after the last "
                         "event (release tails)")
    ap.add_argument("--group", choices=["channel", "track"],
                    default="channel")
    ap.add_argument("--sample-rate", type=float, default=48000.0)
    ap.add_argument("--seconds", type=float, default=None,
                    help="cap the render length")
    ap.add_argument("--polyphony", type=int, default=None,
                    help="voice slots per part (default: measured peak)")
    ap.add_argument("--transpose", type=int, default=0, help="semitones")
    ap.add_argument("--velocity", action="store_true",
                    help="pass note velocity as a 'velocity' note param")
    ap.add_argument("--with-drums", action="store_true",
                    help="include MIDI channel 10 (skipped by default)")
    ap.add_argument("--volume", type=float, default=0.25)
    args = ap.parse_args(argv)

    with open(args.midi, "rb") as f:
        data = f.read()

    if args.live:
        return _main_live(args, data)
    if not args.output:
        ap.error("output WAV is required without --live")

    from ..core.mixdown import mixdown_s16_np
    from ..core.wav import write_wav_s16

    makers = [_instrument_maker(name.strip())
              for name in (args.instrument or "nice").split(",")]
    audio = render_midi(
        data, lambda pi, label: makers[pi % len(makers)](),
        sample_rate=args.sample_rate, seconds=args.seconds,
        polyphony=args.polyphony, group=args.group,
        include_velocity=args.velocity, transpose=args.transpose,
        skip_channels=() if args.with_drums else (9,))
    pcm = mixdown_s16_np(np.asarray(audio), args.volume)
    write_wav_s16(args.output, pcm.reshape(-1), int(args.sample_rate), 1)
    print(f"{args.output}: {audio.shape[-1] / args.sample_rate:.2f}s "
          f"at {int(args.sample_rate)} Hz")
    return 0


def _main_live(args, data: bytes) -> int:
    """--live: attach a lane, drain+capture its stream with TerminalPlayer,
    and pace the SMF's events into it (replay_live)."""
    import sys
    import time

    from ..serve.client import TerminalPlayer
    from ..serve.server import LiveClient

    client = LiveClient(args.host, args.port, instrument=args.instrument)
    w = client.welcome
    print(f"lane {w['lane']} @ {args.host}:{args.port}  "
          f"{w.get('num_parts', 1)} part(s), block {w['block_size']} / "
          f"{w['sample_rate']:.0f} Hz", file=sys.stderr)
    with TerminalPlayer(client, quiet=True, wav_path=args.wav,
                        sink_cmd=args.sink,
                        auto_resume=(args.host, args.port)) as player:
        # wait for the stream (a cold server's first-block jit compile can
        # take tens of seconds) so the first notes land in flowing audio
        deadline = time.monotonic() + 300
        while (player.blocks_received == 0
               and time.monotonic() < deadline):
            time.sleep(0.05)

        class _LockedSender:
            """Serialize event writes with the player's own socket writers
            (gate timers, recorder pump) and survive a mid-replay resume
            (player.client is swapped under the same lock)."""

            welcome = w

            @staticmethod
            def send_event(part, params, note_id=None):
                with player._lock:
                    player.client.send_event(part, params, note_id=note_id)

        n = replay_live(
            data, _LockedSender(), rate=args.rate, group=args.group,
            include_velocity=args.velocity, transpose=args.transpose,
            skip_channels=() if args.with_drums else (9,))
        time.sleep(max(0.0, args.tail))
    print(f"replayed {n} events "
          f"({player.blocks_received} blocks back"
          f"{', wav ' + args.wav if args.wav else ''})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
