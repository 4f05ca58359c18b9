"""Benchmark/example configs beyond the Bach song.

- sampler: drum loop playback + distortion + decimator chain
  (examples/example_sampler.zig + the Decimator from example_polyphony.zig)
- poly_echo: N-voice NiceInstrument texture through StereoEchoes — the
  "1024-voice batched stereo echo" capacity config (BASELINE.json config 5;
  example_polyphony2.zig + example_delay.zig's StereoEchoes(15000)).
"""

import os
from typing import List, Optional

import numpy as np

import jax.numpy as jnp

from ..core.notes import SongEvent
from ..core.timeline import SubvoiceTimeline, compile_timelines
from ..core.wav import read_wav
from ..graph.render import Performance
from ..ops import delay as d_ops
from ..ops import effects
from ..ops import sampler as sampler_ops
from ..ops.segprog import SegProgram, eval_chunk
from . import instruments as ti

F32 = np.float32

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
DRUMLOOP = os.path.join(DATA_DIR, "drumloop.wav")


# ---------------------------------------------------------------------------
# sampler config


class SamplerInstrument:
    """Looped WAV playback * 2.5 -> overdrive -> decimator.

    speed scales the sample's nominal rate (example_sampler.zig's random
    speed; negative plays in reverse). fake_sample_rate enables the
    decimator stage (None = bypass).
    """

    def __init__(
        self,
        wav_path: str = DRUMLOOP,
        loop: bool = True,
        speed: float = 1.0,
        distort: bool = True,
        fake_sample_rate: Optional[float] = None,
        channel: int = 0,
    ) -> None:
        self.wav = read_wav(wav_path)
        self.table = sampler_ops.decode_wav_channel(self.wav, channel)
        self.loop = loop
        self.speed = speed
        self.distort = distort
        self.fake_sample_rate = fake_sample_rate

    def effective_sample_rate(self) -> float:
        return float(F32(F32(self.table.sample_rate) * F32(self.speed)))

    def plan(self, timelines: List[SubvoiceTimeline], sample_rate: float):
        table = sampler_ops.SampleTable(
            data_f32=self.table.data_f32,
            num_samples=self.table.num_samples,
            byte_len=self.table.byte_len,
            sample_rate=self.effective_sample_rate(),
        )
        progs = [
            sampler_ops.plan_sampler(tl, table, sample_rate, self.loop)
            for tl in timelines
        ]
        # merge single-voice programs into one [V, K] SegProgram
        K = max(p.starts.shape[1] for p in progs)
        V = len(progs)
        total = timelines[0].total
        starts = np.full((V, K), total, dtype=np.int64)
        values = {
            k: np.zeros((V, K), dtype=v.dtype) for k, v in progs[0].values.items()
        }
        for v, p in enumerate(progs):
            k = p.starts.shape[1]
            starts[v, :k] = p.starts[0]
            for name in values:
                values[name][v, :k] = p.values[name][0]
                values[name][v, k:] = p.values[name][0, k - 1]
        self.ratio = float(F32(F32(self.effective_sample_rate()) / F32(sample_rate)))
        return {"sampler": SegProgram(starts=starts, values=values)}

    def init_state(self, num_voices: int):
        return {
            "dec_cnt": jnp.full((num_voices,), 0xFFFFFFFF, jnp.uint32),
            "dec_val": jnp.zeros((num_voices,), jnp.float32),
        }

    def render(self, state, prog, ctx):
        vals = eval_chunk(prog["sampler"], ctx.t_idx)
        out = sampler_ops.eval_sampler(
            vals, ctx.t_idx, jnp.asarray(self.table.data_f32),
            self.table.num_samples, self.ratio, self.loop,
        )
        out = out * jnp.float32(2.5)  # example_sampler.zig:106
        if self.distort:
            out = effects.distortion(out, "overdrive", 0.9, 0.5, 0.0)
        if self.fake_sample_rate is not None:
            cnt, val, out = effects.decimator(
                state["dec_cnt"], state["dec_val"], out,
                self.fake_sample_rate, ctx.sample_rate,
            )
            state = {"dec_cnt": cnt, "dec_val": val}
        return state, out


def build_sampler_performance(
    seconds: float = 10.0,
    sample_rate: float = 44100.0,
    speed: float = 1.0,
    distort: bool = True,
    fake_sample_rate: Optional[float] = 6000.0,
):
    total = int(seconds * sample_rate)
    song = [SongEvent({"note_on": True}, t=0.0, note_id=1)]
    tls = compile_timelines(song, 1, sample_rate, total)
    inst = SamplerInstrument(
        speed=speed, distort=distort, fake_sample_rate=fake_sample_rate
    )
    return Performance([(inst, tls)], sample_rate), total


# ---------------------------------------------------------------------------
# poly_echo config (the 1024-voice capacity benchmark)


def make_texture_song(num_voices: int, seconds: float, seed: int = 0):
    """Per-voice timelines: each voice plays continuous retriggered notes."""
    rng = np.random.default_rng(seed)
    note_len = 0.22
    gap = 0.25
    timelines = []
    total = None
    for v in range(num_voices):
        song = []
        t = rng.uniform(0.0, 0.1)
        nid = 1
        while t < seconds - 0.3:
            f = float(F32(110.0 * 2 ** (rng.integers(0, 37) / 12.0)))
            song.append(SongEvent({"freq": f, "note_on": True}, t=t, note_id=nid))
            song.append(SongEvent({"freq": f, "note_on": False}, t=t + note_len, note_id=nid))
            nid += 1
            t += gap
        timelines.append(song)
    return timelines


def build_poly_echo_performance(
    num_voices: int = 1024,
    seconds: float = 30.0,
    sample_rate: float = 44100.0,
    main_delay: int = 15000,
    seed: int = 0,
):
    """num_voices NiceInstrument voices -> mono mix -> StereoEchoes."""
    total = int(seconds * sample_rate)
    songs = make_texture_song(num_voices, seconds, seed)
    tls = [
        compile_timelines(song, 1, sample_rate, total)[0] for song in songs
    ]

    def post_fn(state, mix, ctx):
        scaled = mix * jnp.float32(1.0 / max(num_voices, 1))
        state, stereo = d_ops.stereo_echoes(state, scaled, 0.6, 0.7)
        return state, stereo

    def post_init():
        return d_ops.stereo_echoes_init(main_delay)

    perf = Performance(
        [(ti.NiceInstrument(0.3), tls)],
        sample_rate,
        num_channels=2,
        post_fn=post_fn,
        post_init_state=post_init,
    )
    return perf, total
