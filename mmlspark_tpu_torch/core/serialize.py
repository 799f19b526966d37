"""Stage persistence (the port's copy of ``mmlspark_tpu/core/serialize.py``).

Parity surface: the reference's ``ComplexParamsWritable`` + custom
``Serializer`` (``org/apache/spark/ml/ComplexParamsSerializer.scala``,
``Serializer.scala``) which let whole pipelines — including fitted models and
non-JSON params — round-trip through disk. Layout here:

    <path>/metadata.json          class, uid, simple params
    <path>/complex/<param>/...    one subdir per complex param (typed payload)
    <path>/extra/...              stage-specific fitted state (_save_extra hook)

Complex values are saved by type tag: ndarray (npz), bytes (bin), pytree of
ndarrays (npz + treedef json), stage / list-of-stages (nested save), plain
JSON-able values (json). Callables are transient: skipped with a marker, and
must be re-attached after load.

A save records class paths and callables by module. The loader imports
only modules of this package (:func:`_port_module`): a stage saved by
the JAX package names ``mmlspark_tpu`` modules, and importing one would
load JAX into the port's process.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
from typing import Any, List

import numpy as np

from .params import ComplexParam
from .pipeline import PipelineStage

__all__ = ["save_stage", "load_stage", "save_value", "load_value",
           "to_jsonable"]


def to_jsonable(v):
    """Coerce numpy scalars/arrays to JSON-encodable python values."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v

_FORMAT_VERSION = 1


def _class_path(obj) -> str:
    cls = type(obj)
    if cls.__module__ == "__main__":
        import warnings
        warnings.warn(
            f"{cls.__qualname__} is defined in __main__; the saved stage will "
            "not be loadable from another process. Define stages in an "
            "importable module.", stacklevel=4)
    return f"{cls.__module__}:{cls.__qualname__}"


_PORT = __name__.split(".")[0]


def _port_module(module: str):
    """Import ``module`` if it belongs to this package; refuse otherwise."""
    if module != _PORT and not module.startswith(_PORT + "."):
        raise ValueError(
            f"refusing to load {module!r}: this loader imports only "
            f"{_PORT} modules (a stage saved by another package, or "
            f"defined outside this one, cannot be loaded here)")
    return importlib.import_module(module)


def _resolve_class(path: str):
    module, _, qualname = path.partition(":")
    mod = _port_module(module)
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _is_jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def save_value(value: Any, path: str) -> str:
    """Persist one complex value under ``path`` (a directory). Returns a tag."""
    os.makedirs(path, exist_ok=True)
    if isinstance(value, PipelineStage):
        save_stage(value, os.path.join(path, "stage"))
        return "stage"
    if isinstance(value, (list, tuple)) and value and all(
            isinstance(s, PipelineStage) for s in value):
        for i, s in enumerate(value):
            save_stage(s, os.path.join(path, f"stage_{i:04d}"))
        with open(os.path.join(path, "count.json"), "w") as f:
            json.dump(len(value), f)
        return "stage_list"
    if isinstance(value, np.ndarray):
        if value.dtype == object or value.dtype.kind in "US":
            # string/object columns (e.g. KNN values/labels) can't go through
            # savez without pickle (save would succeed, load would fail) —
            # store as shape-preserving JSON, or fail fast at save time
            with open(os.path.join(path, "objarray.json"), "w") as f:
                json.dump(_obj_array_to_json(value), f)
            return "objarray"
        np.savez(os.path.join(path, "array.npz"), value=value)
        return "ndarray"
    if isinstance(value, (bytes, bytearray)):
        with open(os.path.join(path, "value.bin"), "wb") as f:
            f.write(value)
        return "bytes"
    # pytree of arrays (dict/list nesting with ndarray/scalar leaves)
    flat = _try_flatten_tree(value)
    if flat is not None:
        leaves, treedef = flat
        np.savez(os.path.join(path, "tree.npz"),
                 **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})
        with open(os.path.join(path, "treedef.json"), "w") as f:
            json.dump(treedef, f)
        return "pytree"
    if _is_jsonable(value):
        with open(os.path.join(path, "value.json"), "w") as f:
            json.dump(value, f)
        return "json"
    if callable(value):
        # module-level functions persist by import path (the way the
        # reference persists model graphs by file reference); anything else
        # (lambdas, closures, bound methods) stays transient
        mod = getattr(value, "__module__", None)
        qual = getattr(value, "__qualname__", "")
        if mod and mod != "__main__" and "." not in qual and "<" not in qual:
            try:
                import importlib
                if getattr(importlib.import_module(mod), qual, None) is value:
                    with open(os.path.join(path, "callable_ref.json"), "w") as f:
                        json.dump({"module": mod, "qualname": qual}, f)
                    return "callable_ref"
            except ImportError:
                pass
        return "transient"
    raise TypeError(f"cannot serialize complex value of type {type(value).__name__}")


def load_value(tag: str, path: str) -> Any:
    if tag == "stage":
        return load_stage(os.path.join(path, "stage"))
    if tag == "stage_list":
        with open(os.path.join(path, "count.json")) as f:
            n = json.load(f)
        return [load_stage(os.path.join(path, f"stage_{i:04d}")) for i in range(n)]
    if tag == "ndarray":
        with np.load(os.path.join(path, "array.npz"), allow_pickle=False) as z:
            return z["value"]
    if tag == "objarray":
        with open(os.path.join(path, "objarray.json")) as f:
            return _obj_array_from_json(json.load(f))
    if tag == "bytes":
        with open(os.path.join(path, "value.bin"), "rb") as f:
            return f.read()
    if tag == "pytree":
        with np.load(os.path.join(path, "tree.npz"), allow_pickle=False) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
        with open(os.path.join(path, "treedef.json")) as f:
            treedef = json.load(f)
        return _unflatten_tree(treedef, leaves)
    if tag == "json":
        with open(os.path.join(path, "value.json")) as f:
            return json.load(f)
    if tag == "callable_ref":
        with open(os.path.join(path, "callable_ref.json")) as f:
            ref = json.load(f)
        fn = getattr(_port_module(ref["module"]), ref["qualname"], None)
        if fn is None:
            raise ImportError(
                f"callable {ref['module']}:{ref['qualname']} saved by "
                f"reference no longer exists")
        return fn
    if tag == "transient":
        return None
    raise ValueError(f"unknown complex-value tag {tag!r}")


# -- minimal pytree codec (dict/list nesting, ndarray/number leaves) --------

def _canon_scalar(v):
    from .schema import py_scalar
    return py_scalar(v)


def _obj_array_to_json(arr: np.ndarray) -> dict:
    """String/object ndarray → {"shape": [...], "values": flat list}.
    Raises TypeError when elements are not JSON-able (fail at SAVE, never
    at load)."""
    flat = [_canon_scalar(v) for v in arr.ravel()]
    payload = {"shape": list(arr.shape), "values": flat,
               "dtype": arr.dtype.str}
    json.dumps(payload)   # TypeError on non-JSON-able elements
    return payload


def _obj_array_from_json(payload: dict) -> np.ndarray:
    out = np.empty(len(payload["values"]), dtype=object)
    for i, v in enumerate(payload["values"]):
        out[i] = v
    out = out.reshape(payload["shape"])
    # restore string ('U'/'S') dtypes so loaded arrays match what was saved
    dt = payload.get("dtype")
    if dt and np.dtype(dt).kind in "US":
        out = out.astype(dt)
    return out


def _try_flatten_tree(value):
    leaves: List[np.ndarray] = []

    def rec(v):
        if isinstance(v, str):
            raise TypeError  # strings are not leaves; JSON path handles them
        if isinstance(v, np.ndarray):
            if v.dtype == object or v.dtype.kind in "US":
                # string/object leaves (e.g. BallTree labels) go inline as
                # JSON — savez would silently pickle them and fail on load
                return {"strs": _obj_array_to_json(v)}
            leaves.append(v)
            return {"leaf": len(leaves) - 1}
        if np.isscalar(v):
            leaves.append(np.asarray(v))
            return {"leaf": len(leaves) - 1, "scalar": True}
        # array-likes (CPU tensors) quack like ndarrays
        if hasattr(v, "__array__") and not isinstance(v, (list, tuple, dict, bytes)):
            leaves.append(np.asarray(v))
            return {"leaf": len(leaves) - 1}
        if isinstance(v, dict):
            if not all(isinstance(k, (str, int, float, bool)) for k in v):
                raise TypeError  # non-JSON-able keys cannot round-trip
            # keys stored as json list items so int keys survive round-trip
            return {"dict": [[k, rec(x)] for k, x in sorted(v.items(), key=repr)]}
        if isinstance(v, (list, tuple)):
            node = {"list": [rec(x) for x in v]}
            if isinstance(v, tuple):
                node["tuple"] = True
            return node
        raise TypeError

    try:
        treedef = rec(value)
    except TypeError:
        return None
    return leaves, treedef


def _unflatten_tree(treedef, leaves):
    if "strs" in treedef:
        return _obj_array_from_json(treedef["strs"])
    if "leaf" in treedef:
        arr = leaves[treedef["leaf"]]
        return arr.item() if treedef.get("scalar") else arr
    if "dict" in treedef:
        return {k: _unflatten_tree(v, leaves) for k, v in treedef["dict"]}
    if "list" in treedef:
        seq = [_unflatten_tree(v, leaves) for v in treedef["list"]]
        return tuple(seq) if treedef.get("tuple") else seq
    raise ValueError(f"bad treedef {treedef!r}")


# ---------------------------------------------------------------------------

def save_stage(stage: PipelineStage, path: str, overwrite: bool = True) -> None:
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    # Serialize into a sibling temp dir first so a mid-save failure cannot
    # destroy an existing good save; swap in atomically at the end.
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    import tempfile
    tmp = tempfile.mkdtemp(prefix=".save_", dir=parent)
    try:
        _save_stage_into(stage, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _save_stage_into(stage: PipelineStage, path: str) -> None:

    simple, complex_tags = {}, {}
    for name in stage._param_values:
        p = stage.param(name)
        v = stage._param_values[name]
        if isinstance(p, ComplexParam):
            tag = save_value(v, os.path.join(path, "complex", name))
            complex_tags[name] = tag
        else:
            simple[name] = p.json_value(v)

    meta = {
        "format_version": _FORMAT_VERSION,
        "class": _class_path(stage),
        "uid": stage.uid,
        "params": simple,
        "complex": complex_tags,
    }
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)

    extra_dir = os.path.join(path, "extra")
    os.makedirs(extra_dir, exist_ok=True)
    stage._save_extra(extra_dir)


def load_stage(path: str) -> PipelineStage:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = _resolve_class(meta["class"])
    stage = cls.__new__(cls)
    PipelineStage.__init__(stage)  # fresh uid + empty values
    stage.uid = meta["uid"]
    stage.set(**meta["params"])
    for name, tag in meta["complex"].items():
        if tag == "transient":
            continue  # callable param: must be re-attached by the caller
        stage._param_values[name] = load_value(tag, os.path.join(path, "complex", name))
    stage._load_extra(os.path.join(path, "extra"))
    return stage
