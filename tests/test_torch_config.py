"""`fourdgs_torch.utils.config.load_config` against the JAX package's: every
YAML under configs/ loads to the same plain dict, `inherit_from` chains
resolved, from a working directory outside the repository (the candidate
search of fourdgs/utils/config.py:62-92)."""

import glob
import os

import pytest

from fourdgs.utils.config import load_config as j_load_config
from fourdgs_torch.utils.config import ConfigDict, load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT)
                 for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                                    recursive=True))


def test_configs_found():
    # 26 recorded-sequence configs (TUM 7, Bonn 11, CoFusion 8) and the
    # synthetic smoke config
    assert len(CONFIGS) == 27, CONFIGS


@pytest.mark.parametrize("rel", CONFIGS)
def test_config_loads_as_in_jax(rel, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = os.path.join(ROOT, rel)
    got = load_config(path)
    assert isinstance(got, ConfigDict)
    assert got.to_plain() == j_load_config(path).to_plain()
    assert got.Dataset.type == got["Dataset"]["type"]


def test_inherit_from_relative_to_working_directory(tmp_path, monkeypatch):
    # a child config outside the repository naming its parent relative to
    # the working directory, as chip_smoke.py's does: the child wins
    monkeypatch.chdir(ROOT)
    child = tmp_path / "child.yaml"
    child.write_text("inherit_from: configs/rgbd/tum/base_config.yaml\n"
                     "Dataset:\n  dataset_path: /data/seq\nTraining:\n  dystart: 8\n")
    got = load_config(str(child)).to_plain()
    assert got == j_load_config(str(child)).to_plain()
    assert got["Dataset"]["dataset_path"] == "/data/seq" and got["Dataset"]["type"] == "tum"
    assert got["Training"]["dystart"] == 8 and got["Training"]["tracking_itr_num"] == 100


@pytest.mark.parametrize("rel", [r for r in CONFIGS if "Calibration" in j_load_config(
    os.path.join(ROOT, r)).to_plain().get("Dataset", {})])
def test_intrinsics_from_config_as_in_jax(rel):
    from fourdgs.slam.camera import Intrinsics as JIntrinsics
    from fourdgs_torch.slam.camera import Intrinsics

    path = os.path.join(ROOT, rel)
    got = Intrinsics.from_config(load_config(path))
    want = JIntrinsics.from_config(j_load_config(path))
    assert tuple(got) == tuple(want)
    assert [type(v) for v in got] == [type(v) for v in want]
