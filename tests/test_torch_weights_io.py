"""The port's `.npz` pytree files (fourdgs_torch/perception/weights_io.py)
against the JAX package's (fourdgs/perception/weights_io.py): files
written by either package read back exactly in the other, empty
containers are dropped by both, and the one place they differ, a `None`
leaf (GMA's `att/project`): the reference's writer pickles it, its own
reader refuses the file, and the port's reader reads it back as `None`;
the port's writer leaves it out, and the reference's GMA reads the file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.perception import gma as jg
from fourdgs.perception import weights_io as jio
from fourdgs_torch import convert
from fourdgs_torch.perception import weights_io as tio


def _trees():
    rng = np.random.default_rng(0)
    nested = {
        "enc": {"conv1": {"w": rng.random((3, 3, 4, 8)).astype(np.float32),
                          "b": np.zeros(8, np.float32)},
                "blocks": [{"w": np.ones((2, 2), np.float32)},
                           {"w": np.full((2, 2), 2.0, np.float32)}]},
        "head.weight": np.arange(6, dtype=np.float32).reshape(2, 3),
        "scalar": np.float32(0.7),
        "ints": np.arange(5, dtype=np.int64),
    }
    flat_dotted = {"model.0.conv.weight": rng.random((4, 4)).astype(np.float32)}
    return {"nested": (nested, {"cfg": {"nc": 80, "scales": [1, 2]}}),
            "flat_dotted": (flat_dotted, {"cfg": {}}),
            "no_meta": (nested, None)}


def _assert_same(got, want, dtypes=True):
    """Same paths and values; and dtypes, unless read by the reference,
    whose jnp.asarray narrows 64-bit leaves without JAX's x64 mode."""
    got, want = dict(convert._leaves(got)), dict(convert._leaves(want))
    assert set(got) == set(want)
    for k, v in want.items():
        if dtypes:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v))


@pytest.mark.parametrize("name", ["nested", "flat_dotted", "no_meta"])
@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port"),
                                           ("port", "port")])
def test_round_trip_between_packages(tmp_path, name, writer, reader):
    tree, meta = _trees()[name]
    path = str(tmp_path / "w.npz")
    {"port": tio, "reference": jio}[writer].save_pytree_npz(path, tree, meta=meta)
    loaded, got_meta = {"port": tio, "reference": jio}[reader].load_pytree_npz(path)
    assert got_meta == meta
    _assert_same(loaded, tree, dtypes=reader == "port")
    if name != "flat_dotted":
        assert isinstance(loaded["enc"]["blocks"], list)
    if reader == "port":
        assert all(isinstance(v, np.ndarray) for _, v in convert._leaves(loaded))


@pytest.mark.parametrize("io", [tio, jio], ids=["port", "reference"])
def test_empty_containers_are_dropped(tmp_path, io):
    tree = {"a": {"w": np.ones(2, np.float32)}, "empty": {}, "none_list": [], "b": [{}]}
    path = str(tmp_path / "w.npz")
    io.save_pytree_npz(path, tree)
    loaded, meta = io.load_pytree_npz(path)
    assert meta is None
    assert set(loaded) == {"a"}


def test_gma_project_none(tmp_path):
    params = jg.make_gma_params(jax.random.key(0))
    assert params["att"]["project"] is None
    ref_file, port_file = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    # what scripts/convert_weights.py --gma writes: the None as a pickled
    # object member, which the reference's own reader refuses
    jio.save_pytree_npz(ref_file, params, meta={"source_sha256": "0"})
    with pytest.raises(ValueError, match="allow_pickle=False"):
        jio.load_pytree_npz(ref_file)
    loaded, meta = tio.load_pytree_npz(ref_file)
    assert meta == {"source_sha256": "0"}
    assert "project" in loaded["att"] and loaded["att"]["project"] is None
    _assert_same(loaded, params)
    # the port writes no member for it; the reference reads that file and
    # its GMA runs on it as on the original parameters
    tio.save_pytree_npz(port_file, loaded)
    back, _ = jio.load_pytree_npz(port_file)
    assert "project" not in back["att"]
    _assert_same(back, params)
    x = np.random.default_rng(0).uniform(0, 255, (2, 1, 3, 32, 48)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jg.gma_forward(back, jnp.asarray(x[0]), jnp.asarray(x[1]), iters=2)),
        np.asarray(jg.gma_forward(params, jnp.asarray(x[0]), jnp.asarray(x[1]), iters=2)))
