"""Profiling for the render pipeline (the Bach song config):

  python tools/profile.py [seconds] [chunk]            timing + cost analysis
  python tools/profile.py --trace DIR [seconds]        jax.profiler trace

- Cost analysis: XLA's own per-executable flops/bytes estimate
  (compiled.cost_analysis()) — attribution by the compiler.
- Trace: a real profiler capture (view with TensorBoard / xprof).

Every timed run ends in block_until_ready on the rendered audio.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(seconds, chunk):
    import jax

    from zang_tpu.graph.render import make_render_fn
    from zang_tpu.host import song as sm

    total = int(seconds * sm.SAMPLE_RATE)
    perf = sm.build_performance(total)
    run, args = make_render_fn(perf, total, chunk_size=min(chunk, total))
    return jax.jit(run), args


def steady_time(jrun, args, reps=3):
    import jax

    jax.block_until_ready(jrun(*args))  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(jrun(*args))
        times.append(time.perf_counter() - t0)
    return min(times)


def report_cost(jrun, args):
    lowered = jrun.lower(*args)
    cost = lowered.compile().cost_analysis()
    if not cost:
        print("cost analysis unavailable on this backend")
        return
    flops = cost.get("flops", 0.0)
    bytes_moved = cost.get("bytes accessed", 0.0)
    print(f"XLA cost analysis: {flops/1e9:.2f} GFLOP, "
          f"{bytes_moved/1e9:.3f} GB accessed"
          + (f", arithmetic intensity {flops/max(bytes_moved,1):.1f} flop/B"
             if bytes_moved else ""))
    for k in ("transcendentals", "optimal_seconds"):
        if cost.get(k):
            print(f"  {k}: {cost[k]:.3g}")


def main():
    argv = sys.argv[1:]
    trace_dir = None
    if argv and argv[0] == "--trace":
        trace_dir = argv[1]
        argv = argv[2:]
    seconds = float(argv[0]) if argv else 60.0
    chunk = int(argv[1]) if len(argv) > 1 else 65536

    from zang_tpu.platform import enable_compile_cache

    enable_compile_cache()
    jrun, args = build(seconds, chunk)
    if trace_dir:
        import jax

        jax.block_until_ready(jrun(*args))  # compile outside the trace
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(jrun(*args))
        print(f"trace written to {trace_dir} (view with tensorboard/xprof)")
        return

    dt = steady_time(jrun, args)
    print(f"steady-state: {dt*1000:.1f} ms for {seconds:.0f}s audio "
          f"= {seconds/dt:.0f}x realtime")
    report_cost(jrun, args)


if __name__ == "__main__":
    main()
