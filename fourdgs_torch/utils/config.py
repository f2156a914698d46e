"""Nested config dict with attribute access and the deformation
hyperparameter defaults (port of fourdgs/utils/config.py without the YAML
loader)."""

from __future__ import annotations

from typing import Any


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

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
