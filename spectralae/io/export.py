"""Ahead-of-time model export for serving (jax.export / StableHLO).

The reference has no serving story — inference is welded to the interactive
OpenCV loop (source/autoencoder.cpp:121-151).  The equivalent for
production deployment is an *ahead-of-time compiled artifact*: the forward
(or encoder-only) pass is traced once, lowered to StableHLO with
``jax.export``, and written to disk together with a JSON manifest.  A
server process then loads and calls it without tracing, without the model
source, and — with multi-platform lowering — on a machine class
(CPU/CUDA) chosen at load time, not export time.

Artifact layout (a directory)::

    manifest.json      what/domain/shapes/platforms/spec, format version,
                       and the lowered function's signature
    <what>.mlir        the lowered StableHLO module (MLIR bytecode)

The module and its signature are stored directly rather than through
``Exported.serialize()``, which needs the optional ``flatbuffers``
package: an artifact is then written and loaded with nothing beyond JAX
and numpy.  A serving function takes one array and returns one, on one
device, so the signature is a few JSON fields.

Weights are baked into the artifact as constants (a serving snapshot, not a
training checkpoint — use ``spectralae.io.checkpoint`` for those).

The batch dimension can be exported symbolically (``batch=None``) so one
artifact serves any batch size, using jax.export shape polymorphism.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp
from jax import export as jax_export

from ..core.types import AEParams, NetSpec
from ..model import autoencoder as model

FORMAT_VERSION = 2

_WHAT = ("forward", "encode")


def _build_fn(params: AEParams, spec: NetSpec, what: str, domain: str,
              tap_mode: str):
    scales = spec.scales
    if what == "forward":
        if domain == "fft":
            return lambda x: model.forward_fft(params, x, scales)
        return lambda x: model.forward_coord(params, x, scales,
                                             tap_mode=tap_mode)[-1]
    if what == "encode":
        return lambda x: model.encode(params, x, scales, domain=domain,
                                      tap_mode=tap_mode)
    raise ValueError(f"what must be one of {_WHAT}, got {what!r}")


def export_model(params: AEParams, spec: NetSpec, path: str | Path, *,
                 what: str = "forward", domain: str = "fft",
                 batch: int | None = None, dtype=jnp.float32,
                 platforms: tuple[str, ...] | None = None,
                 tap_mode: str | None = None,
                 extra: dict | None = None) -> Path:
    """Export an AOT-compiled serving artifact.

    Args:
      what: ``"forward"`` (full reconstruction) or ``"encode"``
        (bottleneck features — the serving path).
      domain: ``"fft"`` or ``"coord"`` compute domain.
      batch: fixed batch size, or ``None`` for a symbolic batch dimension
        (one artifact serves any batch size).
      platforms: lowering platforms, e.g. ``("cpu", "cuda")`` for an
        artifact loadable on either; ``None`` = the ambient platform.
      tap_mode: coord-domain tap window.  ``None`` defaults to
        ``"ref_gpu"`` — the window the interactive engine trains with by
        default (gpu flag on), so an exported coord model computes the
        same convolution as the runtime that produced its weights.  Pass
        ``"ref_cpu"``/``"centered"`` for nets trained with those taps.
        Ignored for ``domain="fft"``.

    Returns the artifact directory path.
    """
    if tap_mode is None:
        tap_mode = "ref_gpu"
    fn = _build_fn(params, spec, what, domain, tap_mode)
    if batch is None:
        (b,) = jax_export.symbolic_shape("b")
        in_spec = jax.ShapeDtypeStruct((b, spec.d, spec.nx, spec.ny), dtype)
    else:
        in_spec = jax.ShapeDtypeStruct((batch, spec.d, spec.nx, spec.ny),
                                       dtype)
    kwargs = {} if platforms is None else {"platforms": list(platforms)}
    exported = jax_export.export(jax.jit(fn), **kwargs)(in_spec)
    manifest = {
        "format_version": FORMAT_VERSION,
        "what": what,
        "domain": domain,
        "tap_mode": tap_mode,
        "batch": batch,
        "dtype": str(np.dtype(dtype)),
        "input_shape": [spec.d, spec.nx, spec.ny],
        "platforms": list(exported.platforms),
        "spec": {
            "nx": spec.nx, "ny": spec.ny, "d": spec.d,
            "n_stages": len(spec.stages),
        },
        "signature": _signature(exported),
        "extra": extra or {},
    }
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"{what}.mlir").write_bytes(exported.mlir_module_serialized)
    (path / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return path


_ONE_ARG = jax.tree.structure(((0,), {}))
_ONE_OUT = jax.tree.structure(0)


def _signature(exported: jax_export.Exported) -> dict:
    """What :func:`_exported` needs besides the module, as JSON."""
    shardings = (*exported.in_shardings_hlo, *exported.out_shardings_hlo,
                 *exported._in_named_shardings,
                 *exported._out_named_shardings)
    if (exported.in_tree != _ONE_ARG or exported.out_tree != _ONE_OUT
            or exported.nr_devices != 1 or exported.ordered_effects
            or exported.unordered_effects or exported.disabled_safety_checks
            or any(s is not None for s in shardings)):
        raise ValueError("a serving artifact holds a function of one array "
                         "to one array on one device, without effects")

    def aval(a):
        return {"shape": [str(d) for d in a.shape], "dtype": str(a.dtype)}

    return {
        "fun_name": exported.fun_name,
        "in_aval": aval(exported.in_avals[0]),
        "out_aval": aval(exported.out_avals[0]),
        "platforms": list(exported.platforms),
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": exported.uses_global_constants,
    }


def _exported(sig: dict, module: bytes) -> jax_export.Exported:
    """The ``jax.export.Exported`` that :func:`_signature` described."""
    scope = jax_export.SymbolicScope()

    def aval(a):
        shape = jax_export.symbolic_shape(",".join(a["shape"]), scope=scope)
        return jax.core.ShapedArray(shape, jnp.dtype(a["dtype"]))

    return jax_export.Exported(
        fun_name=sig["fun_name"],
        in_tree=_ONE_ARG, in_avals=(aval(sig["in_aval"]),),
        out_tree=_ONE_OUT, out_avals=(aval(sig["out_aval"]),),
        _has_named_shardings=True,
        _in_named_shardings=(None,), _out_named_shardings=(None,),
        in_shardings_hlo=(None,), out_shardings_hlo=(None,),
        nr_devices=1, platforms=tuple(sig["platforms"]),
        ordered_effects=(), unordered_effects=(), disabled_safety_checks=(),
        mlir_module_serialized=module,
        calling_convention_version=sig["calling_convention_version"],
        module_kept_var_idx=tuple(sig["module_kept_var_idx"]),
        uses_global_constants=sig["uses_global_constants"],
        _get_vjp=None)


class ServingModel:
    """An AOT-lowered serving function, callable without the model source.

    ``ServingModel.load(path)`` reads the manifest + StableHLO module;
    ``__call__`` runs the compiled function on a ``[B, D, Nx, Ny]`` array
    (B must match the exported batch unless it was exported symbolically).
    """

    def __init__(self, exported, manifest: dict):
        self._exported = exported
        self.manifest = manifest
        self._call = jax.jit(exported.call)

    @classmethod
    def load(cls, path: str | Path) -> "ServingModel":
        path = Path(path)
        if not (path / "manifest.json").exists():
            # an `export --what both` root holds per-function subdirs;
            # prefer the forward artifact, else the single subdir present
            for sub in ("forward", "encode"):
                if (path / sub / "manifest.json").exists():
                    path = path / sub
                    break
        manifest = json.loads((path / "manifest.json").read_text())
        if manifest["format_version"] != FORMAT_VERSION:
            raise ValueError("unsupported export format version "
                             f"{manifest['format_version']}")
        module = (path / f"{manifest['what']}.mlir").read_bytes()
        exported = _exported(manifest["signature"], module)
        return cls(exported, manifest)

    @property
    def input_shape(self) -> tuple:
        return tuple(self.manifest["input_shape"])

    def __call__(self, x) -> jax.Array:
        d, nx, ny = self.input_shape
        if x.ndim != 4 or x.shape[1:] != (d, nx, ny):
            raise ValueError(
                f"expected input [B, {d}, {nx}, {ny}], got {x.shape}")
        want_b = self.manifest["batch"]
        if want_b is not None and x.shape[0] != want_b:
            raise ValueError(
                f"artifact was exported for batch={want_b}, got "
                f"{x.shape[0]} (re-export with batch=None for a "
                "batch-polymorphic artifact)")
        return self._call(jnp.asarray(x))
