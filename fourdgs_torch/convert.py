"""Carry SLAM state and network weights between the JAX package and the
port, through numpy.

The port imports nothing of `fourdgs`, so the converters read and write
plain numpy structures with the reference's field names: a `GaussianMap`,
`AdamState`, `KeyframeStore`, `ControlNodes` or `DeformAdam` of the
reference is read through its attributes (any object or mapping with those names whose leaves
`np.asarray` accepts), and `*_to_arrays` returns nested dicts of numpy
arrays that rebuild the reference's named tuples field by field. The
flow networks' weights go between the JAX parameter pytree of RAFT and
GMA and the port's state dict (`flow_state_dict`, `flow_params`), and
LPIPS's between the two packages' `LpipsWeights` (`lpips_from_arrays`).
"""

from __future__ import annotations

import numpy as np
import torch

from fourdgs_torch.models.deform import (
    HEADS,
    ControlNodeFloats,
    ControlNodes,
    MLPParams,
)
from fourdgs_torch.models.gaussian_map import AdamState, GaussianMap, GaussianParams
from fourdgs_torch.slam.keyframes import KeyframeStore
from fourdgs_torch.slam.mapping_dynamic import DeformAdam


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(a)), device=device)


def _params_from(obj, device) -> GaussianParams:
    return GaussianParams(*(_t(_get(obj, f), device) for f in GaussianParams._fields))


def _params_to(p: GaussianParams) -> dict:
    return {f: getattr(p, f).detach().cpu().numpy() for f in GaussianParams._fields}


def gaussian_map_from_arrays(obj, device) -> GaussianMap:
    fields = {f: _t(_get(obj, f), device) for f in GaussianMap._fields if f != "params"}
    return GaussianMap(params=_params_from(_get(obj, "params"), device), **fields)


def gaussian_map_to_arrays(gmap: GaussianMap) -> dict:
    out = {f: getattr(gmap, f).detach().cpu().numpy()
           for f in GaussianMap._fields if f != "params"}
    out["params"] = _params_to(gmap.params)
    return out


def adam_from_arrays(obj, device) -> AdamState:
    return AdamState(mu=_params_from(_get(obj, "mu"), device),
                     nu=_params_from(_get(obj, "nu"), device),
                     count=int(np.asarray(_get(obj, "count"))))


def adam_to_arrays(adam: AdamState) -> dict:
    return {"mu": _params_to(adam.mu), "nu": _params_to(adam.nu),
            "count": np.asarray(adam.count, np.int32)}


def store_from_arrays(obj, device) -> KeyframeStore:
    return KeyframeStore(*(_t(_get(obj, f), device) for f in KeyframeStore._fields))


def store_to_arrays(store: KeyframeStore) -> dict:
    return {f: getattr(store, f).cpu().numpy() for f in KeyframeStore._fields}


def pose_from_array(T, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T, np.float32), device=device)


def pose_to_array(T: torch.Tensor) -> np.ndarray:
    return T.detach().cpu().numpy()


def _mlp_from(obj, device) -> MLPParams:
    seq = lambda name: tuple(_t(a, device) for a in _get(obj, name))  # noqa: E731
    return MLPParams(weights=seq("weights"), biases=seq("biases"),
                     **{name: seq(name) for name, _, _ in HEADS})


def _mlp_to(mlp: MLPParams) -> dict:
    seq = lambda ts: [t.detach().cpu().numpy() for t in ts]  # noqa: E731
    return {f: seq(getattr(mlp, f)) for f in MLPParams._fields}


def _floats_from(obj, device) -> ControlNodeFloats:
    return ControlNodeFloats(*(_t(_get(obj, f), device) for f in ("nodes", "radius_raw",
                                                                  "weight_raw")),
                             mlp=_mlp_from(_get(obj, "mlp"), device))


def _floats_to(f) -> dict:
    out = {k: getattr(f, k).detach().cpu().numpy() for k in ("nodes", "radius_raw",
                                                            "weight_raw")}
    out["mlp"] = _mlp_to(f.mlp)
    return out


def control_nodes_from_arrays(obj, device) -> ControlNodes:
    f = _floats_from(obj, device)
    return ControlNodes(nodes=f.nodes, radius_raw=f.radius_raw, weight_raw=f.weight_raw,
                        valid=_t(_get(obj, "valid"), device), mlp=f.mlp)


def control_nodes_to_arrays(cn: ControlNodes) -> dict:
    out = _floats_to(cn)
    out["valid"] = cn.valid.cpu().numpy()
    return out


def deform_adam_from_arrays(obj, device) -> DeformAdam:
    return DeformAdam(mu=_floats_from(_get(obj, "mu"), device),
                      nu=_floats_from(_get(obj, "nu"), device),
                      count=int(np.asarray(_get(obj, "count"))))


def deform_adam_to_arrays(state: DeformAdam) -> dict:
    return {"mu": _floats_to(state.mu), "nu": _floats_to(state.nu),
            "count": np.asarray(state.count, np.int32)}


# ---------------------------------------------------------------------------
# Flow networks: the JAX package's RAFT/GMA parameter pytree (the `.npz`
# layout of `make_params`/`make_gma_params`) and the port's state dict
# (the names of the public `raft-things.pth`/`gma-things.pth`)
# ---------------------------------------------------------------------------

_UPDATE_NAMES = {
    "enc_convc1": "encoder.convc1", "enc_convc2": "encoder.convc2",
    "enc_convf1": "encoder.convf1", "enc_convf2": "encoder.convf2", "enc_conv": "encoder.conv",
    **{f"gru_conv{g}{i}": f"gru.conv{g}{i}" for g in "zrq" for i in "12"},
    "flow_conv1": "flow_head.conv1", "flow_conv2": "flow_head.conv2",
    "mask_conv1": "mask.0", "mask_conv2": "mask.2",
}
_UPDATE_PATHS = {v: k for k, v in _UPDATE_NAMES.items()}
_ATT_NAMES = {"to_qk": "att.to_qk", "to_v": "update_block.aggregator.to_v",
              "project": "update_block.aggregator.project"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_STAT_PATHS = {v: k for k, v in _STAT_NAMES.items()}


def _leaves(node, path=()):
    """(path, leaf) of every array leaf of a nested dict/list pytree."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    elif node is not None:
        yield path, node


def _torch_keys(path: tuple) -> list[str]:
    """The state-dict keys of a pytree leaf (a strided block's `norm3` is
    also `downsample.1`)."""
    head, *mods, leaf = path
    if head in ("fnet", "cnet"):
        leaf = _STAT_NAMES.get(leaf, leaf)
        mods = [str(m) for m in mods]
        if mods[-1] == "norm3":
            return [".".join([head, *mods, leaf]),
                    ".".join([head, *mods[:-1], "downsample.1", leaf])]
        if mods[-1] == "downsample":
            mods[-1] = "downsample.0"
        return [".".join([head, *mods, leaf])]
    if head == "update":
        return [f"update_block.{_UPDATE_NAMES[mods[0]]}.{leaf}"]
    if leaf == "gamma":
        return ["update_block.aggregator.gamma"]
    return [f"{_ATT_NAMES[mods[0]]}.{leaf}"]


def _pytree_path(key: str) -> tuple:
    """Inverse of `_torch_keys`: the pytree path of a state-dict key."""
    head, *mods, leaf = key.split(".")
    if head in ("fnet", "cnet"):
        path = [head]
        while mods:
            m = mods.pop(0)
            if m.startswith("layer"):
                path += [m, int(mods.pop(0))]
            elif m == "downsample":
                path.append("downsample" if mods.pop(0) == "0" else "norm3")
            else:
                path.append(m)
        return tuple(path) + (_STAT_PATHS.get(leaf, leaf),)
    if head == "update_block" and mods[0] == "aggregator":
        return ("att", "gamma") if leaf == "gamma" else ("att", mods[1], leaf)
    if head == "update_block":
        return ("update", _UPDATE_PATHS[".".join(mods)], leaf)
    return ("att", mods[0], leaf)


def flow_state_dict(params) -> dict[str, torch.Tensor]:
    """The port's RAFT or GMA state dict (on the CPU) of a JAX parameter
    pytree. The attention's convolutions have no bias in the original
    GMA, nor in the port: their zero biases in the pytree are dropped, and
    a nonzero one raises."""
    sd = {}
    for path, leaf in _leaves(params):
        arr = np.array(np.asarray(leaf), np.float32)
        if path[0] == "att" and path[-1] == "bias":
            if np.any(arr):
                raise ValueError(f"{'/'.join(map(str, path))} is not zero: the port's "
                                 "convolution has no bias")
            continue
        t = torch.from_numpy(arr.reshape(1) if path == ("att", "gamma") else arr)
        for key in _torch_keys(path):
            sd[key] = t
    return sd


def flow_params(model: torch.nn.Module) -> dict:
    """The JAX parameter pytree (numpy leaves) of the port's RAFT or GMA
    module: what `fourdgs.perception.raft.make_params` or
    `gma.make_gma_params` lay out, so `save_pytree_npz` of it is a weights
    file of either package."""
    flat = {}
    for key, t in model.state_dict().items():
        if ".downsample.1." not in key:
            arr = t.detach().cpu().numpy().copy()
            path = _pytree_path(key)
            flat[path] = arr.reshape(()) if path == ("att", "gamma") else arr
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d) and m.bias is None:
            flat[_pytree_path(f"{name}.weight")[:-1] + ("bias",)] = np.zeros(
                m.out_channels, np.float32)
    root: dict = {}
    for path, arr in flat.items():
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    if hasattr(model, "att") and model.update_block.aggregator.project is None:
        root["att"]["project"] = None

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [listify(node[i]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def lpips_from_arrays(obj, device):
    """The port's `LpipsWeights` of the JAX package's (`conv_w`, `conv_b`,
    `lin_w`, five arrays each)."""
    from fourdgs_torch.eval.lpips import LpipsWeights

    return LpipsWeights(*(tuple(_t(a, device) for a in _get(obj, f))
                          for f in LpipsWeights._fields))
