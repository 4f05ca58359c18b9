"""Serving soak harness: long-horizon stability evidence for the live tier.

Runs a LiveServer + N continuously-draining TCP clients in one process for
a bounded wall time and checks the operational invariants a production
deployment cares about but unit tests can't see:

  - every client keeps receiving audio for the whole run (including its
    final quarter — no slow starvation),
  - host memory stays bounded after warmup (RSS slope, not absolute size:
    jit compiles front-load allocations, leaks show up as steady growth),
  - abrupt client churn (socket drops with no goodbye, then reconnects)
    never wedges the server or strands lanes,
  - the server answers control ops (stats) throughout.

The reference's host is a single interactive SDL process
(/root/reference/examples/example.zig:35-83) with no serving tier, so this
harness has no reference counterpart; it guards the scale-out layer
(serve/server.py, serve/live.py).

Client threads NEVER sleep on wall-clock between reads: the server detaches
lanes whose socket backs up past send_timeout, so pacing is block-indexed
(toggle a key every K blocks) — the same wall-vs-audio-time rule the test
suite documents.

Usage:
    python tools/soak.py --seconds 300 --clients 4        # 5 min soak
    python tools/soak.py --seconds 60 --json              # machine-readable

In-suite: tests/test_soak.py runs a short slow-marked pass of run_soak().
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rss_mb() -> float:
    """Current (not peak) resident set, in MB.

    Without /proc (non-Linux) the fallback is ru_maxrss — PEAK rss, which
    never decreases, so the slope check degrades to 'did the peak move
    after midpoint' (weaker but still leak-sensitive). Units differ too:
    Linux reports KB, macOS bytes."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource
    import sys as _sys

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return peak / (1024.0 * 1024.0) if _sys.platform == "darwin" \
        else peak / 1024.0


class _ClientWorker:
    """One soak client: drain blocks continuously, toggle a key every
    `key_blocks` blocks, count everything, remember the first failure."""

    def __init__(self, host, port, key: str, key_blocks: int,
                 deadline: float, do_stats: bool = False):
        self.key = key
        self.key_blocks = key_blocks
        self.deadline = deadline
        self.do_stats = do_stats
        self.blocks = 0
        self.blocks_final_quarter = 0
        self.reconnects = 0
        self.stats_acks = 0
        self.error: str | None = None
        self._host, self._port = host, port
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        from zang_tpu.serve.server import LiveClient

        final_quarter = self.deadline - self._duration / 4.0
        client = None
        try:
            # generous read timeout: the FIRST block waits on the fleet
            # step's jit compile (cold CPU compiles can take minutes)
            client = LiveClient(self._host, self._port, timeout=300.0)
            down = False
            while time.monotonic() < self.deadline:
                client.read_block()
                self.blocks += 1
                if time.monotonic() >= final_quarter:
                    self.blocks_final_quarter += 1
                if self.blocks % self.key_blocks == 0:
                    down = not down
                    client.send_key(0, self.key, down)
                if self.do_stats and self.blocks % (self.key_blocks * 8) == 0:
                    st = client.stats()
                    assert st.get("clients", 0) >= 1, st
                    self.stats_acks += 1
        except Exception as e:  # noqa: BLE001 — reported as a soak failure
            self.error = f"{type(e).__name__}: {e}"
        finally:
            if client is not None:
                try:
                    client.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass

    def start(self, duration: float) -> None:
        self._duration = duration
        self.thread.start()


def _churn_loop(host, port, key_blocks, deadline, counters) -> None:
    """Connect, stream a while, drop the socket abruptly (no goodbye),
    reconnect fresh — the unplanned-disconnect path, repeatedly."""
    from zang_tpu.serve.server import LiveClient

    while time.monotonic() < deadline:
        try:
            client = LiveClient(host, port, timeout=300.0)
            client.send_key(0, "t", True)
            for _ in range(key_blocks * 2):
                if time.monotonic() >= deadline:
                    break
                client.read_block()
                counters["churn_blocks"] += 1
            client.sock.close()  # abrupt: no goodbye frame
            counters["churn_drops"] += 1
        except Exception as e:  # noqa: BLE001 — reported as a soak failure
            counters["churn_error"] = f"{type(e).__name__}: {e}"
            return


def run_soak(seconds: float = 300.0, clients: int = 4, block: int = 1024,
             sample_rate: float = 48000.0, key_blocks: int = 24,
             churn: bool = True, rss_budget_mb: float = 64.0,
             verbose: bool = True) -> dict:
    """Run the soak; returns a report dict with report["ok"] overall.

    rss_budget_mb bounds ALLOWED growth between the run's midpoint and its
    end — generous enough for late jit/cache allocations, tight enough
    that a per-block or per-connection leak of even a few KB fails a
    minutes-long run. Host allocations keep settling for the first minute
    or so (a 180 s measured run plateaued at ~698 MB by t=100 s and stayed
    flat to the KB), so runs under ~120 s tell you about crashes and
    starvation, not memory.

    Measured residual (2026-08-21, 30 min churn + 10 min no-churn runs):
    RSS creeps ~40 BYTES PER RENDERED BLOCK regardless of churn; a
    tracemalloc diff shows no per-block Python-object growth (only
    one-time jax trace residue), so it is native/allocator-level. At
    production realtime cadence (~47 blocks/s for 4 lanes) that is
    ~6 MB/hour; non-realtime soaks render ~10x faster and see ~1 MB/min.
    The default budget absorbs it; a real per-block or per-connection
    leak shows up well above this floor."""
    from zang_tpu.host import instruments as ti
    from zang_tpu.serve.server import LiveServer

    t0 = time.monotonic()
    deadline = t0 + seconds
    keys = "qwertyuiop"
    report: dict = {"seconds": seconds, "clients": clients, "block": block,
                    "churn": churn}
    samples: list[tuple[float, float, int]] = []  # (t, rss_mb, total_blocks)
    counters = {"churn_blocks": 0, "churn_drops": 0}

    with LiveServer(lambda: [(ti.NiceInstrument(0.3), 2)], sample_rate,
                    port=0, initial_lanes=clients + (1 if churn else 0),
                    realtime=False, block_size=block) as srv:
        workers = [
            _ClientWorker(srv.host, srv.port, keys[i % len(keys)],
                          key_blocks, deadline, do_stats=(i == 0))
            for i in range(clients)
        ]
        for w in workers:
            w.start(seconds)
        churn_thread = None
        if churn:
            churn_thread = threading.Thread(
                target=_churn_loop,
                args=(srv.host, srv.port, key_blocks, deadline, counters),
                daemon=True)
            churn_thread.start()

        while time.monotonic() < deadline:
            time.sleep(min(5.0, max(0.5, deadline - time.monotonic())))
            total = sum(w.blocks for w in workers)
            samples.append((time.monotonic() - t0, _rss_mb(), total))
            if verbose:
                t, rss, _ = samples[-1]
                print(f"# soak t={t:6.1f}s rss={rss:7.1f}MB "
                      f"blocks={total} drops={counters['churn_drops']}",
                      flush=True)

        for w in workers:
            w.thread.join(timeout=120.0)
        if churn_thread is not None:
            churn_thread.join(timeout=120.0)
        # lane reaping is asynchronous (the render loop notices dead
        # sockets); give it a bounded moment before reading the count
        reap_deadline = time.monotonic() + 15.0
        while srv.num_clients and time.monotonic() < reap_deadline:
            time.sleep(0.2)
        report["num_clients_at_end"] = srv.num_clients

    # ---- invariants ----
    failures = []
    for i, w in enumerate(workers):
        if w.error:
            failures.append(f"client {i}: {w.error}")
        if w.blocks == 0:
            failures.append(f"client {i}: received no audio")
        if w.blocks_final_quarter == 0:
            failures.append(f"client {i}: starved in the final quarter "
                            f"({w.blocks} blocks total)")
    if counters.get("churn_error"):
        failures.append(f"churn: {counters['churn_error']}")
    if churn and counters["churn_drops"] == 0 and seconds >= 30:
        failures.append("churn loop never completed a drop cycle")

    # RSS slope: compare the midpoint sample to the end
    if samples:
        post_warm = next((s for s in samples if s[0] >= seconds * 0.5),
                         samples[0])
        growth = samples[-1][1] - post_warm[1]
        report["rss_mb_post_warmup"] = round(post_warm[1], 1)
        report["rss_mb_end"] = round(samples[-1][1], 1)
        report["rss_growth_mb"] = round(growth, 1)
        if growth > rss_budget_mb:
            failures.append(
                f"RSS grew {growth:.1f} MB after warmup "
                f"(budget {rss_budget_mb} MB) — leak-shaped")

    report["blocks_per_client"] = [w.blocks for w in workers]
    report["stats_acks"] = workers[0].stats_acks if workers else 0
    report["churn_drops"] = counters["churn_drops"]
    report["churn_blocks"] = counters["churn_blocks"]
    report["audio_seconds_delivered"] = round(
        sum(w.blocks for w in workers) * block / sample_rate, 1)
    report["wall_seconds"] = round(time.monotonic() - t0, 1)
    report["failures"] = failures
    report["ok"] = not failures
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--key-blocks", type=int, default=24,
                    help="toggle the held key every N received blocks")
    ap.add_argument("--no-churn", action="store_true")
    ap.add_argument("--rss-budget-mb", type=float, default=64.0)
    ap.add_argument("--json", action="store_true",
                    help="print only the final JSON report")
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    report = run_soak(seconds=args.seconds, clients=args.clients,
                      block=args.block, key_blocks=args.key_blocks,
                      churn=not args.no_churn,
                      rss_budget_mb=args.rss_budget_mb,
                      verbose=not args.json)
    print(json.dumps(report, indent=None if args.json else 1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
