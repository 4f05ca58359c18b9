"""AOT executable disk cache (graph/aotcache.py).

On the CPU test backend the cache is deliberately unusable
(cache_usable() gates it off: XLA:CPU AOT reloads fail a strict
machine-feature check, and the 8-virtual-device config binds reloaded
executables to all devices) — so here we verify the gate itself, the
fall-through correctness, and the key/tag machinery. The disk round trip
needs a single GPU (TestAotOnDevice) or an explicit mesh (TestShardedCache,
on the 8 virtual CPU devices)."""

import os

import jax
import numpy as np
import pytest

from zang_tpu.core.notes import SongEvent
from zang_tpu.core.timeline import compile_timelines
from zang_tpu.graph import aotcache
from zang_tpu.graph.render import Performance, render_performance
from zang_tpu.host import instruments as ti

SR = 48000.0

on_cpu = jax.default_backend() == "cpu"


def _perf(total):
    song = [
        SongEvent(t=0.01, params={"freq": 330.0, "note_on": True}, note_id=1),
        SongEvent(t=0.30, params={"freq": 330.0, "note_on": False}, note_id=1),
    ]
    tls = compile_timelines(song, 2, SR, total)
    return Performance([(ti.NiceInstrument(0.25), tls)], SR)


class TestGateOnCpu:
    def test_cache_gated_off_but_renders_identically(self, tmp_path):
        """With ZANG_AOT_CACHE pointing at a directory, the CPU backend
        must fall through to a plain compile (no cache files) and produce
        exactly the uncached output."""
        assert not aotcache.cache_usable()  # 8-device CPU suite config
        total = 4096
        a = render_performance(_perf(total), total, chunk_size=2048,
                               aot_cache=str(tmp_path))
        assert not [f for f in os.listdir(tmp_path) if f.startswith("aot_")]
        b = render_performance(_perf(total), total, chunk_size=2048)
        assert np.array_equal(a, b)

    def test_live_and_fleet_paths_unaffected(self, tmp_path, monkeypatch):
        monkeypatch.setenv("ZANG_AOT_CACHE", str(tmp_path))
        from zang_tpu.host.live import LiveSession
        from zang_tpu.serve.live import LiveFleet

        sess = LiveSession([(ti.NiceInstrument(0.3), 2)], SR, 512)
        sess.push_event(0, {"freq": 440.0, "note_on": True})
        a = np.concatenate([sess.render_block() for _ in range(2)], axis=1)
        fleet = LiveFleet(lambda: [(ti.NiceInstrument(0.3), 2)], 2, SR,
                          block_size=512)
        fleet.push_event(0, 0, {"freq": 440.0, "note_on": True})
        b = fleet.render_block()
        assert np.isfinite(a).all() and np.abs(a).max() > 1e-4
        assert np.isfinite(b).all() and np.abs(b[0]).max() > 1e-4
        monkeypatch.delenv("ZANG_AOT_CACHE")
        sess2 = LiveSession([(ti.NiceInstrument(0.3), 2)], SR, 512)
        sess2.push_event(0, {"freq": 440.0, "note_on": True})
        a2 = np.concatenate([sess2.render_block() for _ in range(2)], axis=1)
        assert np.array_equal(a, a2)


class TestKeys:
    def test_equal_configs_equal_tags(self):
        assert (aotcache.stable_tag(ti.NiceInstrument(0.3))
                == aotcache.stable_tag(ti.NiceInstrument(0.3)))

    def test_config_changes_tag(self):
        assert (aotcache.stable_tag(ti.NiceInstrument(0.3))
                != aotcache.stable_tag(ti.NiceInstrument(0.4)))

    def test_callable_bytecode_keys_tag(self):
        def f1(p):
            return p["freq"]

        def f2(p):
            return p["freq"] * 2.0

        assert aotcache.stable_tag(f1) != aotcache.stable_tag(f2)
        assert aotcache.stable_tag(f1) == aotcache.stable_tag(f1)

    def test_constant_only_lambda_difference_keys_tag(self):
        # co_code alone is identical here; co_consts must disambiguate
        f1 = lambda p: 220.0  # noqa: E731
        f2 = lambda p: 440.0  # noqa: E731
        assert aotcache.stable_tag(f1) != aotcache.stable_tag(f2)

    def test_closure_capture_keys_tag(self):
        def make(base):
            return lambda p: base * 2.0

        assert aotcache.stable_tag(make(1.0)) != aotcache.stable_tag(
            make(2.0))
        assert aotcache.stable_tag(make(1.0)) == aotcache.stable_tag(
            make(1.0))

    def test_partial_bound_args_key_tag(self):
        # functools.partial has no __code__/__closure__; the bound args
        # must key the tag or two configs collide onto one disk entry
        import functools

        def fx(x, wet):
            return x * wet

        a = functools.partial(fx, wet=0.2)
        b = functools.partial(fx, wet=0.9)
        assert aotcache.stable_tag(a) != aotcache.stable_tag(b)
        assert aotcache.stable_tag(a) == aotcache.stable_tag(
            functools.partial(fx, wet=0.2))

    def test_bound_method_receiver_keys_tag(self):
        class Eff:
            def __init__(self, gain):
                self.gain = gain

            def apply(self, x):
                return x * self.gain

        assert aotcache.stable_tag(Eff(1.0).apply) != aotcache.stable_tag(
            Eff(2.0).apply)
        assert aotcache.stable_tag(Eff(1.5).apply) == aotcache.stable_tag(
            Eff(1.5).apply)

    def test_callable_instance_attrs_key_tag(self):
        class Gain:
            def __init__(self, g):
                self.g = g

            def __call__(self, x):
                return x * self.g

        assert aotcache.stable_tag(Gain(1.0)) != aotcache.stable_tag(
            Gain(2.0))
        assert aotcache.stable_tag(Gain(3.0)) == aotcache.stable_tag(
            Gain(3.0))

    def test_default_args_key_tag(self):
        def f(x, k=1.0):
            return x * k

        def g(x, k=2.0):
            return x * k

        # identical bytecode, different defaults
        assert aotcache.stable_tag(f) != aotcache.stable_tag(g)

    def test_unfingerprintable_receiver_is_uncacheable(self):
        # a receiver walk() cannot fingerprint must NOT degrade to a type
        # repr in strict mode: two differently-configured receivers of one
        # class would collide onto one disk key (stale-executable-as-hit).
        # Disk-key callers catch Uncacheable and fall back to plain jit.
        # (Vehicle: a mixed-key dict attr — sorted() raises TypeError.)
        class Weird:
            def __init__(self):
                self.bad = {1: "a", "b": 2}

            def apply(self, x):
                return x

        with pytest.raises(aotcache.Uncacheable):
            aotcache.stable_tag(Weird().apply)
        # snapshot fingerprints opt into the degraded (non-colliding-risk-
        # accepted) behavior explicitly
        assert isinstance(aotcache.stable_tag(Weird().apply, strict=False),
                          str)

    def test_unfingerprintable_closure_capture_is_uncacheable(self):
        class Weird:
            def __init__(self):
                self.bad = {1: "a", "b": 2}

        w = Weird()

        def f(x):
            return (x, w)

        with pytest.raises(aotcache.Uncacheable):
            aotcache.stable_tag(f)
        assert isinstance(aotcache.stable_tag(f, strict=False), str)

    def test_cyclic_attr_graph_fingerprints(self):
        # Cycles are structural, not unfingerprintable: a back-edge encodes
        # as ("cycle", distance-up-the-path), so isomorphic graphs tag
        # identically and differing configs still differ. Regression: the
        # walker recursed forever here, which broke LiveSession.__init__
        # (eager _spec_fingerprint) for ANY DSL script using delay/deftrack
        # — parse Scope.parent points back at the enclosing scope.
        class Node:
            def __init__(self, gain):
                self.gain = gain
                self.loop = self

        t1 = aotcache.stable_tag(Node(1.0))
        assert t1 == aotcache.stable_tag(Node(1.0))
        assert t1 != aotcache.stable_tag(Node(2.0))
        assert "('cycle'," in t1
        # bound methods on cyclic receivers fingerprint too (used to be
        # Uncacheable via RecursionError)
        class WithMethod(Node):
            def apply(self, x):
                return x * self.gain

        assert (aotcache.stable_tag(WithMethod(1.0).apply)
                != aotcache.stable_tag(WithMethod(2.0).apply))

    def test_dag_sharing_is_not_a_cycle(self):
        # shared acyclic substructure must walk fully on each path (a
        # path-based seen set, not a global memo) — a global memo would
        # make the tag depend on traversal order
        class O:
            pass

        shared = [1, 2]
        o = O()
        o.a = shared
        o.b = shared
        # both attrs walk to the full list value, no back-edge marker
        # (the test's own qualname contains "cycle", hence the tuple form)
        assert "('cycle'," not in aotcache.stable_tag(o)
        assert aotcache.stable_tag(o).count("('s', 'int', 1)") == 2

    def test_script_instrument_with_delay_fingerprints(self):
        # the live case behind the cycle handling: delay/deftrack scripts
        # carry Scope.parent back-edges through compiled.parse_result
        from zang_tpu.script.compile import compile_script
        from zang_tpu.script.jax_backend import ScriptInstrument

        src = """
Echoed = defmodule
    freq: constant,
    note_on: boolean,
begin
    osc = SineOsc(freq, phase=0) * Gate(note_on)
    out delay 4410 begin
        result = osc + feedback * 0.5
        out result
        feedback result
    end
end
"""
        t1 = aotcache.stable_tag(
            ScriptInstrument(compile_script(src, filename="<t>"), "Echoed"))
        t2 = aotcache.stable_tag(
            ScriptInstrument(compile_script(src, filename="<t>"), "Echoed"))
        assert t1 == t2
        src_b = src.replace("0.5", "0.25")
        t3 = aotcache.stable_tag(
            ScriptInstrument(compile_script(src_b, filename="<t>"),
                             "Echoed"))
        assert t1 != t3

    def test_cache_key_depends_on_arg_shapes(self):
        k1 = aotcache.cache_key("t", (np.zeros((4,), np.float32),))
        k2 = aotcache.cache_key("t", (np.zeros((8,), np.float32),))
        k3 = aotcache.cache_key("t", (np.zeros((4,), np.int32),))
        assert len({k1, k2, k3}) == 3

    def test_corrupt_entry_is_a_miss(self, tmp_path):
        os.makedirs(tmp_path, exist_ok=True)
        key = "deadbeef" * 4
        with open(tmp_path / f"aot_{key}.pkl", "wb") as fh:
            fh.write(b"not a pickle")
        assert aotcache.load(str(tmp_path), key) is None


@pytest.mark.skipif(on_cpu, reason="unsharded disk cache needs one GPU (cache_usable)")
class TestAotOnDevice:
    def test_miss_then_hit_bit_identical(self, tmp_path):
        total = 4096
        cache = str(tmp_path)
        a = render_performance(_perf(total), total, chunk_size=2048,
                               aot_cache=cache)
        files = [f for f in os.listdir(cache) if f.startswith("aot_")]
        assert len(files) == 1
        b = render_performance(_perf(total), total, chunk_size=2048,
                               aot_cache=cache)
        assert [f for f in os.listdir(cache)
                if f.startswith("aot_")] == files
        assert np.array_equal(a, b)
        c = render_performance(_perf(total), total, chunk_size=2048)
        assert np.array_equal(a, c)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestShardedCache:
    """Mesh-sharded executables ARE cacheable (graph/aotcache.py
    cache_usable(sharded=True)): the executable binds to the whole mesh
    on reload, which is exactly the sharded call's binding. Verified here
    on the 8-virtual-device CPU mesh: miss -> hit, bit-identical audio."""

    def _sharded_perf(self, total):
        from zang_tpu.parallel.mesh import pad_timelines

        song = [
            SongEvent(t=0.01, params={"freq": 220.0 * 2 ** (i / 12.0),
                                      "note_on": True}, note_id=i + 1)
            for i in range(4)
        ] + [
            SongEvent(t=0.25, params={"freq": 220.0 * 2 ** (i / 12.0),
                                      "note_on": False}, note_id=i + 1)
            for i in range(4)
        ]
        song.sort(key=lambda e: (e.t, e.note_id))
        tls = pad_timelines(compile_timelines(song, 4, SR, total), 8)
        return Performance([(ti.NiceInstrument(0.25), tls)], SR)

    def test_sharded_miss_then_hit_bit_identical(self, tmp_path):
        from zang_tpu.parallel.mesh import make_mesh, render_performance_sharded

        assert aotcache.cache_usable(sharded=True)
        mesh = make_mesh(8)
        total = 4096
        st1, st2 = [], []
        a = render_performance_sharded(
            self._sharded_perf(total), total, mesh, chunk_size=2048,
            aot_cache=str(tmp_path), _aot_status=st1)
        assert st1 == ["miss"]
        assert [f for f in os.listdir(tmp_path) if f.startswith("aot_")]
        b = render_performance_sharded(
            self._sharded_perf(total), total, mesh, chunk_size=2048,
            aot_cache=str(tmp_path), _aot_status=st2)
        assert st2 == ["hit"]
        assert np.array_equal(a, b)
        # and the cached executable's output equals a cold uncached compile
        c = render_performance_sharded(
            self._sharded_perf(total), total, mesh, chunk_size=2048)
        assert np.array_equal(a, c)

    def test_mesh_shape_in_key(self, tmp_path):
        """A 4-device mesh must not hit a key stored by the 8-device mesh
        (same arg shapes after padding to 8)."""
        from zang_tpu.parallel.mesh import make_mesh, render_performance_sharded

        total = 4096
        st8, st4 = [], []
        render_performance_sharded(
            self._sharded_perf(total), total, make_mesh(8), chunk_size=2048,
            aot_cache=str(tmp_path), _aot_status=st8)
        render_performance_sharded(
            self._sharded_perf(total), total, make_mesh(4), chunk_size=2048,
            aot_cache=str(tmp_path), _aot_status=st4)
        assert st8 == ["miss"] and st4 == ["miss"]


class TestSelfHealing:
    """Round-4 regression: a cache entry that deserializes but dies at
    execution (executables XLA served from its warm persistent compilation
    cache serialize INCOMPLETE — `NOT_FOUND: Buffer Definition Event` at
    the first buffer materialization) must not be
    a hard render failure. Two defenses, both covered here:

    - prevention: aot_compile's miss path compiles with the persistent
      compilation cache suppressed (aotcache._fresh_compile), so stored
      payloads are always complete;
    - healing: a reloaded hit is wrapped in _HealingExecutable — the
      first call materializes the result, and an execution-time
      JaxRuntimeError invalidates the entry, recompiles fresh, re-stores,
      and serves the call from the fresh executable."""

    def test_fresh_compile_suppresses_persistent_cache(self):
        import jax.numpy as jnp

        seen = []

        def make_jitted():
            # record the config as the compile path observes it
            seen.append(jax.config.jax_enable_compilation_cache)
            return jax.jit(lambda v: jnp.sum(v * 2.0))

        before = jax.config.jax_enable_compilation_cache
        compiled = aotcache._fresh_compile(
            make_jitted, (jnp.ones((8,), jnp.float32),))
        assert seen == [False]
        assert jax.config.jax_enable_compilation_cache == before  # restored
        assert float(compiled(jnp.ones((8,), jnp.float32))) == 16.0

    @staticmethod
    def _sharded_setup(fn):
        """Mesh-sharded compile + args: unsharded reloads mis-bind on the
        8-virtual-device CPU config (why cache_usable gates them off), so
        the healing tests mirror real usage — sharded executables only."""
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from zang_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(8)
        args = (jax.device_put(
            jnp.arange(8 * 4, dtype=jnp.float32).reshape(8, 4),
            NamedSharding(mesh, P("voices"))),)
        out_sh = NamedSharding(mesh, P())
        compile_now = lambda: (  # noqa: E731
            jax.jit(fn, out_shardings=out_sh).lower(*args).compile())
        return mesh, args, compile_now

    def test_broken_hit_heals_invalidates_and_restores(self, tmp_path):
        fn = lambda v: (v * 3.0).sum(axis=0)  # noqa: E731
        mesh, args, compile_now = self._sharded_setup(fn)
        expect = np.arange(8 * 4, dtype=np.float32).reshape(8, 4).sum(0) * 3
        key = "deadbeef" * 4
        with mesh:
            assert aotcache.store(str(tmp_path), key, compile_now())

        calls = {"broken": 0, "recompiled": 0}

        def broken(*a):
            calls["broken"] += 1
            raise jax.errors.JaxRuntimeError(
                "NOT_FOUND: Buffer Definition Event: Function "
                "wrapped_broadcast not found (type id: 1)")

        def recompile():
            calls["recompiled"] += 1
            return compile_now()

        healer = aotcache._HealingExecutable(
            broken, recompile, str(tmp_path), key)
        with mesh:
            out = healer(*args)
            assert np.array_equal(np.asarray(out), expect)
            assert healer.healed and calls == {"broken": 1, "recompiled": 1}
            # the disk entry was replaced by the fresh executable's payload
            reloaded = aotcache.load(str(tmp_path), key)
            assert reloaded is not None
            assert np.array_equal(np.asarray(reloaded(*args)), expect)
            # subsequent calls bypass the guard (no second broken attempt)
            out2 = healer(*args)
            assert np.array_equal(np.asarray(out2), expect)
            assert calls == {"broken": 1, "recompiled": 1}

    def test_healthy_hit_validates_once_and_stays(self, tmp_path):
        fn = lambda v: (v + 1.0).sum(axis=0)  # noqa: E731
        mesh, args, compile_now = self._sharded_setup(fn)
        key = "cafebabe" * 4
        with mesh:
            assert aotcache.store(str(tmp_path), key, compile_now())
            reloaded = aotcache.load(str(tmp_path), key)
            recompiles = []
            healer = aotcache._HealingExecutable(
                reloaded, lambda: recompiles.append(1), str(tmp_path), key)
            a = np.asarray(healer(*args))
            b = np.asarray(healer(*args))
            assert np.array_equal(a, b) and not healer.healed
            assert not recompiles
            assert os.path.exists(tmp_path / f"aot_{key}.pkl")
