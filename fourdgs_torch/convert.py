"""Carry SLAM state between the JAX package and the port, through numpy.

The port imports nothing of `fourdgs`, so the converters read and write
plain numpy structures with the reference's field names: a `GaussianMap`,
`AdamState`, `KeyframeStore`, `ControlNodes` or `DeformAdam` of the
reference is read through its attributes (any object or mapping with those names whose leaves
`np.asarray` accepts), and `*_to_arrays` returns nested dicts of numpy
arrays that rebuild the reference's named tuples field by field.
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
