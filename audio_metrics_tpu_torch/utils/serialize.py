"""Pickle-free state persistence (the port's copy).

The port's own copy of ``audio_metrics_tpu/utils/serialize.py``, so that a
state file written by either package loads in the other without the port
importing the JAX package.  State is one ``.npz`` archive: arbitrarily
nested dicts of numpy arrays / scalars / strings are flattened to
``path/to/key`` npz entries, with a JSON manifest describing structure and
scalar types.  Loadable with zero trust assumptions (no pickled objects).
"""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np

__all__ = ["save_state_dict", "load_state_dict"]

_SEP = "/"


def _flatten(prefix: str, obj, arrays: dict, manifest: dict) -> None:
    if isinstance(obj, dict):
        manifest[prefix] = {"kind": "dict", "keys": list(obj.keys())}
        for k, v in obj.items():
            if _SEP in str(k):
                raise ValueError(f"state keys may not contain '{_SEP}': {k!r}")
            _flatten(f"{prefix}{_SEP}{k}" if prefix else str(k), v, arrays, manifest)
    elif obj is None:
        manifest[prefix] = {"kind": "none"}
    elif isinstance(obj, np.ndarray):
        manifest[prefix] = {"kind": "array"}
        arrays[prefix] = obj
    elif isinstance(obj, (bool, np.bool_)):
        manifest[prefix] = {"kind": "bool", "value": bool(obj)}
    elif isinstance(obj, (int, np.integer)):
        manifest[prefix] = {"kind": "int", "value": int(obj)}
    elif isinstance(obj, (float, np.floating)):
        manifest[prefix] = {"kind": "float", "value": float(obj)}
    elif isinstance(obj, str):
        manifest[prefix] = {"kind": "str", "value": obj}
    elif isinstance(obj, (list, tuple)):
        manifest[prefix] = {
            "kind": "list" if isinstance(obj, list) else "tuple",
            "len": len(obj),
        }
        for i, v in enumerate(obj):
            _flatten(f"{prefix}{_SEP}{i}", v, arrays, manifest)
    else:
        # last resort: things that quack like arrays
        arr = np.asarray(obj)
        manifest[prefix] = {"kind": "array"}
        arrays[prefix] = arr


def save_state_dict(state: dict, fp: str | Path) -> None:
    arrays: dict[str, np.ndarray] = {}
    manifest: dict[str, dict] = {}
    _flatten("", state, arrays, manifest)
    manifest_json = json.dumps(manifest)
    buf = io.BytesIO()
    np.savez_compressed(
        buf, __manifest__=np.frombuffer(manifest_json.encode(), dtype=np.uint8), **arrays
    )
    Path(fp).write_bytes(buf.getvalue())


def _rebuild(prefix: str, manifest: dict, arrays) -> object:
    entry = manifest[prefix]
    kind = entry["kind"]
    if kind == "dict":
        return {
            k: _rebuild(f"{prefix}{_SEP}{k}" if prefix else str(k), manifest, arrays)
            for k in entry["keys"]
        }
    if kind == "none":
        return None
    if kind == "array":
        return arrays[prefix]
    if kind in ("list", "tuple"):
        items = [
            _rebuild(f"{prefix}{_SEP}{i}", manifest, arrays)
            for i in range(entry["len"])
        ]
        return items if kind == "list" else tuple(items)
    return entry["value"]


def load_state_dict(fp: str | Path) -> dict:
    with np.load(Path(fp), allow_pickle=False) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    return _rebuild("", manifest, arrays)
