"""Checkpoints of the SLAM state (port of fourdgs/io/checkpoint.py).

`save_state` writes the Gaussian map, its Adam state and the keyframe
store to one compressed npz under the keys `gmap.<i>`, `adam.<i>` and
`store.<i>`, i being a leaf's position in the reference's flattening of
its named tuples (fields in order, nested tuples recursed into), plus the
host state as `<path>.meta.json`. A checkpoint of either package loads in
the other.

`save_deform` / `load_deform` keep the deformation field and its Adam
state under named paths (`.mlp.weights[0]`, ...), the reference's
`tree_to_named_arrays` names, and load shape-adaptively: a leaf saved at
another node count or capacity fills the overlap of the template's.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _named_leaves(tree, path: str = ""):
    """(path, leaf) pairs of nested named tuples and tuples, in the
    reference's leaf order and with its path names."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _named_leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, leaf in enumerate(tree):
            yield from _named_leaves(leaf, f"{path}[{i}]")
    else:
        yield path or ".", tree


def _rebuild(template, leaves):
    """`template` with its leaves replaced, in order, from the iterator
    `leaves`."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(t, leaves) for t in template)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.int32)   # the Adam step counts


def _like(saved: np.ndarray, template):
    """`saved` as the kind of `template`: a tensor of its dtype on its
    device, or an int."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.array(saved), device=template.device).to(template.dtype)
    return int(saved)


def _flatten(prefix: str, tree) -> dict:
    return {f"{prefix}.{i}": _to_numpy(leaf)
            for i, (_, leaf) in enumerate(_named_leaves(tree))}


def save_state(path: str, gmap, adam, store, host_state: dict) -> None:
    arrays = {}
    for prefix, tree in (("gmap", gmap), ("adam", adam), ("store", store)):
        arrays.update(_flatten(prefix, tree))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump(host_state, f)


def load_state(path: str, gmap_template, adam_template, store_template):
    """(gmap, adam, store, host state) of a checkpoint, each leaf made like
    the template's (dtype and device)."""
    data = np.load(path)

    def unflatten(prefix, template):
        tmpl = [leaf for _, leaf in _named_leaves(template)]
        return _rebuild(template, iter(_like(data[f"{prefix}.{i}"], t)
                                       for i, t in enumerate(tmpl)))

    out = (unflatten("gmap", gmap_template), unflatten("adam", adam_template),
           unflatten("store", store_template))
    with open(path + ".meta.json") as f:
        host_state = json.load(f)
    return (*out, host_state)


def tree_to_named_arrays(tree) -> dict:
    """{named path: numpy array} of a tree of named tuples."""
    return {name: _to_numpy(leaf) for name, leaf in _named_leaves(tree)}


def tree_from_named_arrays(data, template, shape_adaptive: bool = True):
    """`template` with each leaf replaced by the saved array of its name.
    A name not saved keeps the template's leaf; with `shape_adaptive`, a
    saved leaf of another shape (same rank) fills the overlapping region
    of the template's."""
    out = []
    for key, tmpl in _named_leaves(template):
        if key not in data:
            out.append(tmpl)
            continue
        saved = np.asarray(data[key])
        tmpl_np = _to_numpy(tmpl)
        if saved.shape == tmpl_np.shape:
            out.append(_like(saved.astype(tmpl_np.dtype, copy=False), tmpl))
        elif shape_adaptive and saved.ndim == tmpl_np.ndim:
            merged = tmpl_np.copy()
            region = tuple(slice(0, min(a, b)) for a, b in zip(saved.shape, merged.shape))
            merged[region] = saved[region]
            out.append(_like(merged, tmpl))
        else:
            raise ValueError(f"checkpoint leaf {key}: shape {saved.shape} incompatible "
                             f"with template {tmpl_np.shape}")
    return _rebuild(template, iter(out))


def save_deform(path: str, deform, deform_adam=None) -> None:
    """The deformation field under `deform<path>` and, when given, its Adam
    state under `adam<path>`."""
    arrays = {f"deform{k}": v for k, v in tree_to_named_arrays(deform).items()}
    if deform_adam is not None:
        arrays.update({f"adam{k}": v for k, v in tree_to_named_arrays(deform_adam).items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_deform(path: str, deform_template, adam_template=None):
    """(field, Adam state or None) of a `save_deform` file, shape-adaptive
    against the templates."""
    data = np.load(path)
    dd = {k[len("deform"):]: data[k] for k in data.files if k.startswith("deform")}
    deform = tree_from_named_arrays(dd, deform_template)
    adam = None
    if adam_template is not None:
        ad = {k[len("adam"):]: data[k] for k in data.files if k.startswith("adam")}
        if ad:
            adam = tree_from_named_arrays(ad, adam_template)
    return deform, adam
