""".npz files of network weights as nested pytrees (port of
fourdgs/perception/weights_io.py, numpy only).

A pytree of dicts, lists and arrays is stored flat: each leaf under its
'/'-joined path, list items as '#i' segments, and an optional JSON `meta`
as the uint8 array `__meta_json__`. Files of either package read in the
other. Empty containers have no leaf, so a round trip drops them, as in
the reference.

A `None` leaf (GMA's `att/project`, which the public checkpoint does not
have) is where the two packages' writers differ. The reference's writer
stores it as a pickled object array, which its own reader then refuses
(numpy's `allow_pickle=False`); that is what
`scripts/convert_weights.py --gma` writes. This reader reads such a
member back as `None` from its header alone, without unpickling it, and
this writer leaves `None` leaves out, so that the reference reads its
files and the loaders treat a missing `project` as `None`.
"""

from __future__ import annotations

import json
import zipfile

import numpy as np

_META_KEY = "__meta_json__"


def _flatten(prefix: str, obj, out: dict) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}/{k}" if prefix else str(k), v, out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(f"{prefix}/#{i}", v, out)
    elif obj is not None:
        out[prefix] = np.asarray(obj)


def save_pytree_npz(path: str, params, meta: dict | None = None) -> None:
    """Save a nested dict/list/tuple-of-arrays pytree as a flat npz."""
    flat: dict[str, np.ndarray] = {}
    _flatten("", params, flat)
    if meta is not None:
        flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def _object_members(path: str) -> set[str]:
    """Names of the npz members whose header says dtype object."""
    names = set()
    with zipfile.ZipFile(path) as zf:
        for member in zf.namelist():
            with zf.open(member) as f:
                major, _ = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if major == 1
                        else np.lib.format.read_array_header_2_0)
                if read(f)[2].hasobject:
                    names.add(member.removesuffix(".npy"))
    return names


def load_pytree_npz(path: str):
    """Inverse of save_pytree_npz: (params, meta or None), with numpy
    leaves; '#i' nodes come back as lists ordered by index, and pickled
    object members as `None`."""
    objects = _object_members(path)
    with np.load(path, allow_pickle=False) as z:
        flat = {k: None if k in objects else z[k] for k in z.files}
    meta = None
    if _META_KEY in flat:
        meta = json.loads(bytes(flat.pop(_META_KEY).tobytes()).decode())

    root: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def _delistify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [_delistify(node[f"#{i}"]) for i in range(len(node))]
        return {k: _delistify(v) for k, v in node.items()}

    return _delistify(root), meta
