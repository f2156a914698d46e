"""Config system: the YAML loader with recursive `inherit_from`, a nested
dict with attribute access, and the deformation hyperparameter defaults
(port of fourdgs/utils/config.py)."""

from __future__ import annotations

import os
from typing import Any

import yaml


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def to_plain(self) -> dict:
        return ConfigDict.unwrap(self)

    @staticmethod
    def unwrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return {k: ConfigDict.unwrap(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [ConfigDict.unwrap(v) for v in obj]
        return obj

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigDict.wrap(v) for v in obj]
        return obj


def update_recursive(dict1: dict, dict2: dict) -> None:
    """Deep-merge dict2 into dict1 (child values win)."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {} if isinstance(v, dict) else v
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def load_config(path: str, default_path: str | None = None) -> ConfigDict:
    """Load a YAML config, recursively resolving its `inherit_from` key
    (child values win). A relative `inherit_from` is tried against the
    working directory first, then as a file beside the config, then
    against each of the config's four nearest parent directories, so
    configs load from any working directory."""
    with open(path, "r") as f:
        cfg_special = yaml.safe_load(f) or {}

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        here = os.path.dirname(os.path.abspath(path))
        candidates = [inherit_from, os.path.join(here, os.path.basename(inherit_from))]
        candidates += [os.path.join(os.path.abspath(os.path.join(here, *[".."] * up)),
                                    inherit_from) for up in range(1, 5)]
        inherit_from = next((c for c in candidates if os.path.exists(c)), inherit_from)
        cfg = dict(load_config(inherit_from, default_path))
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.safe_load(f) or {}
    else:
        cfg = {}

    update_recursive(cfg, cfg_special)
    return ConfigDict.wrap(cfg)


def hidden_params_defaults() -> ConfigDict:
    """Defaults of the deformation hyperparameter group (`ModelHiddenParams`
    of a config). The 4D runner reads `node_num`; the other keys are kept
    so that a config written for the reference merges unchanged."""
    return ConfigDict.wrap(
        {
            "net_width": 64,
            "defor_depth": 1,
            "timebase_pe": 4,
            "posebase_pe": 10,
            "bounds": 1.6,
            "plane_tv_weight": 0.0001,
            "time_smoothness_weight": 0.01,
            "l1_time_planes": 0.0001,
            "kplanes_config": {
                "grid_dimensions": 2,
                "input_coordinate_dim": 4,
                "output_coordinate_dim": 32,
                "resolution": [64, 64, 64, 25],
            },
            "multires": [1, 2, 4, 8],
            "no_dx": False,
            "no_grid": False,
            "no_ds": False,
            "no_dr": False,
            "no_do": True,
            "no_dshs": True,
            "K": 3,
            "deform_type": "node",
            "hyper_dim": 0,
            "node_num": 512,
            "pred_opacity": False,
            "pred_color": False,
            "use_hash": False,
            "d_rot_as_res": True,
            "local_frame": True,
            "node_enable_densify_prune": False,
            "no_arap_loss": False,
            "max_d_scale": -1.0,
            "is_scene_static": False,
            "position_lr_init": 0.00016,
            "position_lr_final": 0.0000016,
            "position_lr_delay_mult": 0.01,
            "position_lr_max_steps": 30_000,
            "deform_lr_max_steps": 40_000,
            "feature_lr": 0.0025,
            "opacity_lr": 0.05,
            "scaling_lr": 0.001,
            "rotation_lr": 0.001,
            "percent_dense": 0.01,
            "deform_lr_scale": 1.0,
            "node_max_num_ratio_during_init": 16,
        }
    )


def merge_hparams(config: dict) -> ConfigDict:
    """The config's `ModelHiddenParams` section laid over the defaults."""
    hp = hidden_params_defaults()
    update_recursive(hp, config.get("ModelHiddenParams", {}) or {})
    return ConfigDict.wrap(hp)
