"""Disk cache of compiled XLA executables: cold starts without the compile.

Opt-in (ZANG_AOT_CACHE or an explicit cache_dir). Where JAX's persistent
compilation cache (zang_tpu/platform.enable_compile_cache) still has to
trace and lower on a hit, `jax.experimental.serialize_executable` skips
tracing, lowering and compiling entirely: a reloaded executable gives
bit-identical output. Whether that still earns its code on the GPU, next
to JAX's own cache, is not measured yet.

`aot_compile(fn, args, tag)` is the primitive: lower+compile on miss and
write the pickled (payload, in_tree, out_tree) under a key derived from
the jax version, backend/device fingerprint, the caller's `tag`, and the
abstract signature (pytree structure + shapes + dtypes) of `args`; on hit,
deserialize and skip tracing, lowering, and compiling entirely. Any
load/store failure falls back to a plain compile — the cache is strictly
an accelerator, never a correctness dependency.

Enable by passing cache_dir or setting ZANG_AOT_CACHE=<dir> (used by
render_performance, the render_wav CLI, and serve.batch's shared graphs).
The `tag` must capture everything that affects the traced computation and
is NOT visible in the args' shapes/dtypes (instrument topology,
chunking) — same discipline as serve.batch's instrument keys. The kernel
choice follows the backend, which the key's device fingerprint carries.
When in doubt, include more.
"""

import hashlib
import os
import pickle
import threading
from typing import Optional, Tuple

import jax

_ENV = "ZANG_AOT_CACHE"


class Uncacheable(Exception):
    """stable_tag could not fingerprint part of the object (unhashable
    receiver/default/closure capture). A disk key built from a degraded
    repr could collide across distinct configs — the stale-executable-as-
    hit failure mode — so disk-cache callers must catch this and fall back
    to a plain jax.jit for the graph."""

def _code_fingerprint(code) -> str:
    """Process-stable hash of a code object's BEHAVIOR: bytecode, names,
    and constants (co_code alone misses constant-only edits — two lambdas
    differing only in a literal share opcode streams). Nested code objects
    (inner defs/lambdas/comprehensions) recurse — their default repr
    embeds a memory address and must not leak into the hash."""
    h = hashlib.sha1()
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    h.update(repr(code.co_varnames).encode())
    for c in code.co_consts:
        if hasattr(c, "co_code"):
            h.update(_code_fingerprint(c).encode())
        else:
            h.update(repr(c).encode())
    return h.hexdigest()


def stable_tag(obj, strict: bool = True) -> str:
    """A process-stable description of anything that shapes a traced graph
    (instrument configs, callables, chunk policy...). Unlike
    serve.batch._leaf_key, callables hash by (module, qualname, bytecode)
    instead of id() — required for a key that lives on disk. Opaque
    non-callable objects hash by repr of their public attrs.

    strict=True (the default, for disk keys): any value that cannot be
    walked raises Uncacheable instead of degrading to a type repr — two
    differently-configured receivers of one class must never collide onto
    one disk key. strict=False (snapshot fingerprints, where a refused
    restore is worse than a theoretical collision) keeps the degraded
    repr fallbacks.

    Cyclic object graphs are fingerprinted, not refused: a back-edge to an
    object already on the current descent path encodes as ("cycle", k)
    where k is the ancestor's distance up the path — structural, so two
    isomorphic graphs tag identically. (Script parse trees are the live
    case: Scope.parent points back at the enclosing scope, so any DSL
    module using delay/deftrack is cyclic; stable_tag used to recurse
    forever on those.) Shared acyclic substructure (a DAG diamond) is NOT
    on the path twice and still walks fully both times."""

    _onpath: dict = {}

    def walk(v):
        import numpy as np

        if isinstance(v, np.generic):
            return ("s", v.dtype.str, v.item())
        if isinstance(v, (bool, int, float, str, bytes, type(None))):
            return ("s", type(v).__name__, v)
        if isinstance(v, (np.ndarray, jax.Array)):
            a = np.asarray(v)
            return ("a", a.shape, str(a.dtype),
                    hashlib.sha1(np.ascontiguousarray(a).tobytes())
                    .hexdigest())
        # everything below can recurse — break cycles on the descent path
        vid = id(v)
        if vid in _onpath:
            return ("cycle", len(_onpath) - _onpath[vid])
        _onpath[vid] = len(_onpath)
        try:
            return walk_acyclic(v)
        finally:
            del _onpath[vid]

    def walk_acyclic(v):
        import numpy as np

        if isinstance(v, (list, tuple)):
            return ("l", tuple(walk(x) for x in v))
        if isinstance(v, dict):
            return ("d", tuple(sorted((k, walk(x)) for k, x in v.items())))
        if callable(v):
            import functools

            if isinstance(v, functools.partial):
                # partial has no __code__/__closure__; its identity is the
                # wrapped callable plus the bound args
                return ("p", walk(v.func), walk(list(v.args)),
                        walk(dict(v.keywords)))
            extras = []
            bound = getattr(v, "__self__", None)
            if bound is not None:  # bound method: instance state shapes it
                try:
                    extras.append(("self", walk(bound)))
                except Uncacheable:
                    raise
                except Exception as e:  # noqa: BLE001 — unhashable receiver
                    if strict:
                        raise Uncacheable(
                            f"bound-method receiver {type(bound)!r} cannot "
                            f"be fingerprinted") from e
                    extras.append(("self?", repr(type(bound))))
            for attr in ("__defaults__", "__kwdefaults__"):
                d = getattr(v, attr, None)
                if d:
                    try:
                        extras.append((attr, walk(list(d) if attr ==
                                                  "__defaults__" else d)))
                    except Uncacheable:
                        raise
                    except Exception as e:  # noqa: BLE001
                        if strict:
                            raise Uncacheable(
                                f"{attr} of {v!r} cannot be "
                                f"fingerprinted") from e
                        extras.append((attr + "?", repr(d)))
            code = getattr(v, "__code__", None)
            if code is None and not isinstance(v, type):
                # callable instance (__call__): its public attrs are the
                # config — without them two differently-configured
                # instances of one class would collide
                extras.append(("attrs", tuple(sorted(
                    (k, walk(x)) for k, x in getattr(v, "__dict__", {}).items()
                    if not k.startswith("_")))))
            body = _code_fingerprint(code) if code else ""
            cells = getattr(v, "__closure__", None) or ()
            captured = []
            for cell in cells:
                try:
                    captured.append(walk(cell.cell_contents))
                except Uncacheable:
                    raise
                except Exception as e:  # noqa: BLE001 — unhashable capture
                    if strict:
                        raise Uncacheable(
                            f"closure capture {type(cell.cell_contents)!r} "
                            f"cannot be fingerprinted") from e
                    captured.append(("?", repr(type(cell.cell_contents))))
            return ("f", getattr(v, "__module__", ""),
                    getattr(v, "__qualname__", type(v).__name__), body,
                    tuple(captured), tuple(extras))
        pub = tuple(sorted(
            (k, walk(x)) for k, x in getattr(v, "__dict__", {}).items()
            if not k.startswith("_")))
        return ("o", type(v).__module__, type(v).__qualname__, pub)

    return repr(walk(obj))


def performance_tag(perf, chunk_size: int) -> str:
    """Disk-stable tag for a Performance's traced render graph: instrument
    identities (class + public config + callable bytecode), channel/sr/
    chunk policy. Timeline CONTENT is
    deliberately absent — it flows through the executable's runtime args,
    which is what lets different songs share one compile (the same
    property serve.batch's shared graphs rely on)."""
    parts = tuple(
        (stable_tag(inst), len(tls)) for inst, tls in perf.parts)
    return repr((parts, stable_tag(perf.post_fn),
                 stable_tag(perf.post_init_state), perf.sample_rate,
                 perf.num_channels, chunk_size))


def default_cache_dir() -> Optional[str]:
    d = os.environ.get(_ENV, "").strip()
    return d or None


def cache_usable(sharded: bool = False) -> bool:
    """Whether the disk cache may serve this process's topology.

    Unsharded (default): a single GPU only. XLA:CPU AOT
    loads log machine-feature mismatches, and the test suite's
    8-virtual-device CPU config binds deserialized executables to all 8
    devices — an unsharded call would then be mis-bound.

    sharded=True: the executable was compiled against explicit mesh
    shardings, so multi-device binding is exactly right; any backend
    qualifies (CPU included — the reload executes correctly, verified on
    the 8-virtual-device mesh; the loader's feature warnings are benign
    same-machine). The cache key carries a host fingerprint so a copied
    cache directory from a different machine misses instead of risking
    SIGILL."""
    try:
        if sharded:
            return len(jax.devices()) >= 1
        return jax.default_backend() != "cpu" and len(jax.devices()) == 1
    except Exception:  # noqa: BLE001 — backend init failure = no cache
        return False


def _host_fingerprint() -> str:
    """CPU model identity: XLA:CPU AOT code is machine-feature-specific."""
    import platform

    model = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()}:{model}"


def _device_fingerprint() -> str:
    devs = jax.devices()
    fp = f"{jax.default_backend()}:{devs[0].device_kind}x{len(devs)}"
    if jax.default_backend() == "cpu":
        fp += ":" + _host_fingerprint()
    return fp


def _abstract_sig(args) -> str:
    leaves, treedef = jax.tree_util.tree_flatten(args)
    parts = [str(treedef)]
    for leaf in leaves:
        x = jax.numpy.asarray(leaf)
        parts.append(f"{x.dtype.str}{tuple(x.shape)}")
    return "|".join(parts)


# Bump whenever TRACED ARITHMETIC changes without a config/shape change —
# instrument tags hash configs, not the ops' code, so a warm cache dir
# would otherwise keep serving old-numerics executables as hits across an
# upgrade (e.g. the round-3 TriSawOsc controlled path, decimator host-side
# ratio + active gating, root out-expression masking; the GPU kernels).
NUMERICS_VERSION = 4


def cache_key(tag: str, args) -> str:
    raw = "\n".join([
        jax.__version__,
        f"numerics-v{NUMERICS_VERSION}",
        _device_fingerprint(),
        tag,
        _abstract_sig(args),
    ])
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


def _path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"aot_{key}.pkl")


def load(cache_dir: str, key: str):
    """Deserialized executable, or None (missing/stale/unloadable)."""
    from jax.experimental.serialize_executable import deserialize_and_load

    try:
        with open(_path(cache_dir, key), "rb") as fh:
            payload, in_tree, out_tree = pickle.load(fh)
        return deserialize_and_load(payload, in_tree, out_tree)
    except Exception:  # noqa: BLE001 — any failure means "treat as miss"
        return None


def store(cache_dir: str, key: str, compiled) -> bool:
    from jax.experimental.serialize_executable import serialize

    try:
        payload, in_tree, out_tree = serialize(compiled)
        os.makedirs(cache_dir, exist_ok=True)
        tmp = _path(cache_dir, key) + f".tmp{os.getpid()}"
        with open(tmp, "wb") as fh:
            pickle.dump((payload, in_tree, out_tree), fh)
        os.replace(tmp, _path(cache_dir, key))  # atomic: safe under races
        return True
    except Exception:  # noqa: BLE001 — the cache must never break a render
        return False


_FRESH_COMPILE_LOCK = threading.Lock()


def _fresh_compile(make_jitted, args):
    """Compile OUTSIDE jax's persistent compilation cache.

    An executable XLA serves from its persistent compilation cache
    (jax_compilation_cache_dir, enabled by platform.enable_compile_cache)
    serializes INCOMPLETE: the payload
    is smaller than a fresh compile's and, after a deserialize round-trip,
    dies at execution with `NOT_FOUND: Buffer Definition Event: Function
    ... not found` (round-4 MULTICHIP red; minimal repro in the round-5
    journal). Only executables this module intends to serialize+store
    compile with the cache suppressed — plain jit paths keep it. The
    toggle is process-global config, so toggle+compile holds a lock:
    without it, two concurrent miss compiles (e.g. MultiInstrumentServer
    cold-building two backends) could interleave so one compiles WITH the
    cache still on (storing an incomplete payload — the very bug this
    fixes) and the other's restore leaves the cache off process-wide.
    Serializing rare cold compiles is the cheap correct answer."""
    with _FRESH_COMPILE_LOCK:
        prev = jax.config.jax_enable_compilation_cache
        jax.config.update("jax_enable_compilation_cache", False)
        try:
            return make_jitted().lower(*args).compile()
        finally:
            jax.config.update("jax_enable_compilation_cache", prev)


class _HealingExecutable:
    """First-call guard around a deserialized cache hit: reloaded
    executables are only trusted after one successful materialized call.
    Any environment drift that breaks execution (the persistent-cache
    serialization hole above from entries stored before the fix, a cache
    dir copied across machines, loader feature mismatches that turn out
    real) would otherwise turn a cache hit into a hard render failure —
    here it invalidates the entry, recompiles fresh, re-stores, and
    serves the caller from the fresh executable instead."""

    def __init__(self, compiled, recompile, cache_dir: str, key: str):
        self._compiled = compiled
        self._recompile = recompile
        self._cache_dir = cache_dir
        self._key = key
        self._validated = False
        self.healed = False

    def __call__(self, *args):
        if self._validated:
            return self._compiled(*args)
        try:
            out = self._compiled(*args)
            # execution errors in deserialized executables surface lazily
            # (at buffer materialization) — force them here
            jax.block_until_ready(out)
            self._validated = True
            return out
        except jax.errors.JaxRuntimeError:
            pass  # corrupt-entry-shaped: heal below
        try:
            os.remove(_path(self._cache_dir, self._key))
        except OSError:
            pass
        self._compiled = self._recompile()
        store(self._cache_dir, self._key, self._compiled)
        self.healed = True
        out = self._compiled(*args)
        self._validated = True
        return out


class AotDispatch:
    """Drop-in for jax.jit(fn) that consults the disk cache per argument
    signature: the first call with a new signature loads (or compiles and
    stores) an executable; later calls dispatch straight to it. Use where
    a jitted function sees a few stable signatures (serving segment
    graphs, live block steps)."""

    def __init__(self, fn, tag: str, cache_dir: Optional[str] = None):
        self._fn = fn
        self._tag = tag
        self._cache_dir = cache_dir or default_cache_dir()
        self._mem = {}
        self.last_status: Optional[str] = None

    def __call__(self, *args):
        sig = _abstract_sig(args)
        compiled = self._mem.get(sig)
        if compiled is None:
            compiled, self.last_status = aot_compile(
                self._fn, args, self._tag, self._cache_dir)
            self._mem[sig] = compiled
        return compiled(*args)


def aot_compile(fn, args, tag: str,
                cache_dir: Optional[str] = None,
                out_shardings=None) -> Tuple[object, str]:
    """Compiled executable for fn at args' exact signature.

    Returns (compiled, status) with status in {"hit", "miss", "off"}.
    The executable is called with the same pytree args as fn. With no
    cache_dir (and no ZANG_AOT_CACHE), compiles without touching disk.

    out_shardings marks a mesh-sharded compile (parallel/mesh.py): the
    input shardings are inferred from the committed args, the executable
    binds to every mesh device on reload, and the caller's tag must
    describe the mesh (axes + shape) since arg shapes alone don't."""
    sharded = out_shardings is not None

    def make_jitted():
        return (jax.jit(fn, out_shardings=out_shardings) if sharded
                else jax.jit(fn))

    cache_dir = cache_dir or default_cache_dir()
    if cache_dir is None or not cache_usable(sharded=sharded):
        return make_jitted().lower(*args).compile(), "off"
    key = cache_key(tag, args)
    compiled = load(cache_dir, key)
    if compiled is not None:
        return _HealingExecutable(
            compiled, lambda: _fresh_compile(make_jitted, args),
            cache_dir, key), "hit"
    compiled = _fresh_compile(make_jitted, args)
    store(cache_dir, key, compiled)
    return compiled, "miss"
