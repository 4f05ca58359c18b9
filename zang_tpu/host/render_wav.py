"""Offline WAV renderer CLI — the write_wav.zig equivalent.

    python -m zang_tpu.host.render_wav <config> out.wav [--seconds N]
                                                        [--engine device|oracle]
                                                        [--chunk N]
                                                        [--voices N]

Configs:
  song       full Bach Toccata & Fugue (48 kHz mono, 385 s by default)
  sampler    drum loop + distortion + decimator chain (44.1 kHz mono, 10 s)
  poly_echo  N-voice texture through stereo echoes (44.1 kHz stereo, 30 s)
"""

import argparse
import sys
import time

import numpy as np

from ..core.wav import write_wav_s16
from ..core.mixdown import mixdown_s16_np
from ..graph.render import render_performance
from . import song as song_mod


def main(argv=None):
    from ..platform import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="zang-render", description=__doc__)
    ap.add_argument("config", choices=["song", "sampler", "poly_echo"])
    ap.add_argument("output")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--engine", choices=["device", "oracle", "oracle-exact"], default="device")
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--voices", type=int, default=1024, help="poly_echo voice count")
    args = ap.parse_args(argv)

    t0 = time.time()
    if args.config == "song":
        seconds = args.seconds if args.seconds is not None else song_mod.NUM_SECONDS
        sr = int(song_mod.SAMPLE_RATE)
        if args.engine == "device":
            mix = song_mod.render_song(seconds, chunk_size=args.chunk)
        else:
            mode = "parity" if args.engine == "oracle" else "exact"
            mix = song_mod.render_song_oracle(seconds, mode=mode)
        pcm = mixdown_s16_np(mix, song_mod.MIX_VOLUME)
        channels = 1
    else:
        from . import configs

        if args.engine != "device":
            ap.error(f"--engine {args.engine} only supported for config 'song'")
        sr = 44100
        if args.config == "sampler":
            seconds = args.seconds if args.seconds is not None else 10.0
            perf, total = configs.build_sampler_performance(seconds=seconds)
            vol = 0.25
        else:
            seconds = args.seconds if args.seconds is not None else 30.0
            perf, total = configs.build_poly_echo_performance(
                num_voices=args.voices, seconds=seconds
            )
            vol = 0.25
        audio = render_performance(perf, total, chunk_size=args.chunk)
        pcm = mixdown_s16_np(audio, vol)
        mix = audio
        channels = pcm.shape[0]
    dt = time.time() - t0
    write_wav_s16(args.output, pcm if channels > 1 else pcm[0] if pcm.ndim > 1 else pcm,
                  sr, num_channels=channels)
    peak = float(np.abs(mix).max())
    print(
        f"rendered {seconds:.0f}s at {sr}Hz with engine={args.engine} in {dt:.2f}s "
        f"(RTF {seconds / dt:.1f}x incl. compile), peak {peak:.3f} -> {args.output}"
    )


if __name__ == "__main__":
    main()
