"""Which implementation an op takes, and how a kernel runs under a mesh.

On a GPU the sequential recurrences run as Pallas (Triton) kernels
(ops/pallas_svf.py, ops/pallas_fm.py); on the CPU they take the plain XLA
paths (affine scan, lax.scan), which are also the references the kernels
are tested against. Tests run a kernel on the CPU by calling it with
interpret=True directly. Any other platform is an error: no code path
falls back silently.
"""

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P


def use_kernel(platform: Optional[str] = None, *, mix: bool = False,
               per_sample_res: bool = False) -> bool:
    """True when the op should run its GPU kernel, False for the plain XLA
    path. mix (a time-varying SVF output mix) and per_sample_res are the
    semantics the SVF kernel does not cover; they take the affine scan on
    every platform. Shapes never decide: the kernel wrappers pad."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return False
    if platform != "gpu":
        raise RuntimeError(
            f"no implementation for platform {platform!r}: zang_tpu runs on "
            "'gpu' (kernels) or 'cpu' (plain XLA)")
    return not (mix or per_sample_res)


def _auto_axes() -> tuple:
    """Mesh axes of the enclosing jax.set_mesh that are not already
    manual (inside a shard_map they are, and the kernel runs per shard)."""
    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty:
        return ()
    return tuple(name for name, t in zip(mesh.axis_names, mesh.axis_types)
                 if t != AxisType.Manual)


def voice_parallel(fn: Callable, voice_args: Sequence[jnp.ndarray],
                   shared_args: Sequence[jnp.ndarray] = ()):
    """Run fn(*voice_args, *shared_args) with every voice_arg split on its
    leading (voice) axis over the enclosing mesh.

    A pallas_call is opaque to GSPMD, which would gather every voice onto
    each device. Voices are independent, so a shard_map over the voice
    axis runs the kernel on each device's shard. Without a mesh this is
    fn(...). Every output must carry the voice axis first; voices are
    zero-padded to a multiple of the mesh size and cropped after."""
    axes = _auto_axes()
    if not axes:
        return fn(*voice_args, *shared_args)
    mesh = jax.sharding.get_abstract_mesh()
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    V = voice_args[0].shape[0]
    Vp = -(-V // size) * size
    if Vp != V:
        voice_args = [jnp.pad(a, [(0, Vp - V)] + [(0, 0)] * (a.ndim - 1))
                      for a in voice_args]
    spec = P(axes)
    out = jax.shard_map(
        fn, in_specs=(spec,) * len(voice_args) + (P(),) * len(shared_args),
        out_specs=spec, check_vma=False,
    )(*voice_args, *shared_args)
    if Vp != V:
        out = jax.tree_util.tree_map(lambda o: o[:V], out)
    return out
