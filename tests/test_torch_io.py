"""The port's artifacts against the JAX package's: PLY files byte-equal
for one map and read back alike, checkpoints written by either package
loaded by the other with every array and the host state equal, and the
named, shape-adaptive deformation files (as tests/test_checkpoint_deform.py
holds them) across the two packages; and the trajectory artifacts
(`pose.txt`, `plot/*.json`) of one trajectory alike."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.io import checkpoint as jck
from fourdgs.io import ply as jply
from fourdgs.models import gaussian_map as jgm
from fourdgs.models.deform import init_nodes as j_init_nodes
from fourdgs.slam import keyframes as jkf
from fourdgs.slam.mapping_dynamic import init_deform_adam as j_init_deform_adam
from fourdgs_torch import convert
from fourdgs_torch.io import checkpoint as tck
from fourdgs_torch.io import ply as tply
from fourdgs_torch.models import gaussian_map as tgm
from fourdgs_torch.slam import keyframes as tkf
from tests.test_torch_mapping import H, W, _state

HOST = {"iteration_count": 123, "kf_total": 4, "kf_indices": [0, 5, 9, 14],
        "window": [14, 9, 0], "kf_slot": {"0": 0, "5": 1, "9": 2, "14": 3},
        "poses_est": {"0": np.eye(4).tolist()}, "exposures": {"0": [0.0, 0.0]},
        "initialized": True, "median_depth": 2.5, "deform_init": False}


@pytest.fixture(scope="module")
def jax_state():
    """The mapping tests' map and keyframes, with some Gaussians dynamic and
    Adam moments and counts that are not zero."""
    gmap, adam, store = _state()
    rng = np.random.default_rng(0)
    gmap = gmap._replace(dygs=jnp.asarray(rng.uniform(size=gmap.capacity) < 0.3),
                         n_obs=jnp.asarray(rng.integers(0, 5, gmap.capacity), jnp.int32),
                         grad_accum=jnp.asarray(rng.uniform(size=gmap.capacity), jnp.float32))
    moments = lambda p: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), p)
    adam = adam._replace(mu=moments(adam.mu), nu=moments(adam.nu), count=jnp.int32(17))
    return gmap, adam, store


def _assert_tree_equal(t_arrays, j_tree, name=""):
    """The nested dicts and lists of `convert.*_to_arrays` equal, with their
    dtypes, to the reference's named tuples."""
    if isinstance(t_arrays, dict):
        for k, v in t_arrays.items():
            _assert_tree_equal(v, getattr(j_tree, k), f"{name}.{k}")
    elif isinstance(t_arrays, list):
        assert len(t_arrays) == len(j_tree), name
        for i, (v, j) in enumerate(zip(t_arrays, j_tree)):
            _assert_tree_equal(v, j, f"{name}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(t_arrays), np.asarray(j_tree), err_msg=name)
        assert np.asarray(t_arrays).dtype == np.asarray(j_tree).dtype, name


def test_ply_byte_equal_and_read_back(jax_state, tmp_path):
    gmap = jax_state[0]
    jp, tp = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    n_j = jply.save_gaussians_ply(gmap, jp)
    n_t = tply.save_gaussians_ply(convert.gaussian_map_from_arrays(gmap, "cpu"), tp)
    assert n_t == n_j == int(gmap.num_alive) > 0
    assert open(tp, "rb").read() == open(jp, "rb").read()
    t_read, j_read = tply.load_gaussians_ply(jp), jply.load_gaussians_ply(tp)
    assert t_read.keys() == j_read.keys()
    for k in t_read:
        np.testing.assert_array_equal(t_read[k], j_read[k], err_msg=k)
    alive = np.asarray(gmap.alive)
    np.testing.assert_array_equal(t_read["xyz"], np.asarray(gmap.params.xyz)[alive])
    np.testing.assert_array_equal(t_read["dygs"], np.asarray(gmap.dygs)[alive])


def _port_templates(gmap, store):
    return (tgm.empty_map(gmap.capacity, "cpu"), tgm.init_adam(gmap.capacity, "cpu"),
            tkf.empty_store(store.capacity, H, W, "cpu"))


def test_checkpoint_written_by_jax_loads_in_port(jax_state, tmp_path):
    gmap, adam, store = jax_state
    path = str(tmp_path / "jax_ck.npz")
    jck.save_state(path, gmap, adam, store, HOST)
    tg, ta, ts, host = tck.load_state(path, *_port_templates(gmap, store))
    assert host == HOST
    _assert_tree_equal(convert.gaussian_map_to_arrays(tg), gmap)
    _assert_tree_equal(convert.adam_to_arrays(ta), adam)
    _assert_tree_equal(convert.store_to_arrays(ts), store)
    assert isinstance(ta.count, int) and ta.count == 17


def test_checkpoint_written_by_port_loads_in_jax(jax_state, tmp_path):
    gmap, adam, store = jax_state
    path = str(tmp_path / "port_ck.npz")
    tck.save_state(path, convert.gaussian_map_from_arrays(gmap, "cpu"),
                   convert.adam_from_arrays(adam, "cpu"),
                   convert.store_from_arrays(store, "cpu"), HOST)
    jg, ja, js, host = jck.load_state(path, jgm.empty_map(gmap.capacity),
                                      jgm.init_adam(gmap.capacity),
                                      jkf.empty_store(store.capacity, H, W))
    assert host == HOST
    for a, b in zip(jax.tree.leaves((jg, ja, js)), jax.tree.leaves((gmap, adam, store))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    # and the keys are the same positions as the reference's own file
    ref = str(tmp_path / "ref_ck.npz")
    jck.save_state(ref, gmap, adam, store, HOST)
    assert sorted(np.load(path).files) == sorted(np.load(ref).files)


def _jax_deform(cap, n, seed):
    cn = j_init_nodes(jax.random.key(seed), cap, jax.random.uniform(jax.random.key(seed), (64, 3)),
                      jnp.ones(64, bool), node_num=n)
    adam = j_init_deform_adam(cn)
    moments = jax.tree.map(lambda a: a + 0.5, adam.mu)
    return cn, adam._replace(mu=moments, count=jnp.int32(7))


def test_deform_named_across_packages(tmp_path):
    cn, adam = _jax_deform(32, 16, 0)
    jpath, tpath = str(tmp_path / "jax_deform.npz"), str(tmp_path / "port_deform.npz")
    jck.save_deform(jpath, cn, adam)
    # port reads the reference's file into templates of other values
    tmpl, tmpl_adam = _jax_deform(32, 16, 1)
    t_cn, t_adam = tck.load_deform(jpath, convert.control_nodes_from_arrays(tmpl, "cpu"),
                                   convert.deform_adam_from_arrays(tmpl_adam, "cpu"))
    _assert_tree_equal(convert.control_nodes_to_arrays(t_cn), cn)
    assert t_adam.count == 7
    _assert_tree_equal(convert.deform_adam_to_arrays(t_adam)["mu"], adam.mu)
    # and writes the same names, which the reference reads back
    tck.save_deform(tpath, t_cn, t_adam)
    assert sorted(np.load(tpath).files) == sorted(np.load(jpath).files)
    j_cn, j_adam = jck.load_deform(tpath, tmpl, tmpl_adam)
    for a, b in zip(jax.tree.leaves((j_cn, j_adam)), jax.tree.leaves((cn, adam))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_deform_load_shape_adaptive_across_packages(tmp_path):
    # saved at 16 nodes by the reference, loaded into a port template of 48
    small, _ = _jax_deform(16, 8, 0)
    path = str(tmp_path / "deform_small.npz")
    jck.save_deform(path, small)
    big_tmpl = convert.control_nodes_from_arrays(_jax_deform(48, 4, 2)[0], "cpu")
    big, adam = tck.load_deform(path, big_tmpl)
    assert adam is None
    np.testing.assert_array_equal(big.nodes[:16].numpy(), np.asarray(small.nodes))
    np.testing.assert_array_equal(big.nodes[16:].numpy(), big_tmpl.nodes[16:].numpy())
    np.testing.assert_array_equal(big.valid[:16].numpy(), np.asarray(small.valid))
    for a, b in zip(big.mlp.weights, small.mlp.weights):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a leaf of another rank does not load
    bad = {".nodes": np.zeros((16,), np.float32)}
    with pytest.raises(ValueError, match="incompatible"):
        tck.tree_from_named_arrays(bad, big_tmpl)


def test_trajectory_artifacts_match_jax(tmp_path):
    # pose.txt, ATE, evo-style APE statistics and trajectories of one
    # estimated trajectory, written by both packages
    from fourdgs.eval.ate import save_trajectory as j_save
    from fourdgs_torch.eval.ate import save_trajectory as t_save
    from fourdgs_torch.geometry.se3 import se3_exp

    rng = np.random.default_rng(3)
    gt = [se3_exp(torch.tensor(rng.normal(scale=0.3, size=6), dtype=torch.float32))
          .double().numpy() for _ in range(12)]
    est = [se3_exp(torch.tensor(rng.normal(scale=0.01, size=6), dtype=torch.float32))
           .double().numpy() @ T for T in gt]
    ids = list(range(0, 24, 2))
    t_stats = t_save(est, gt, ids, str(tmp_path / "port"), "final")
    j_stats = j_save(est, gt, ids, str(tmp_path / "jax"), "final")
    assert t_stats.keys() == j_stats.keys()
    for k in t_stats:
        np.testing.assert_allclose(t_stats[k], j_stats[k], rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port" / "pose.txt"),
                               np.loadtxt(tmp_path / "jax" / "pose.txt"), atol=1e-6, rtol=0)
    for name in ("ATE_final.json", "stats_final.json", "trj_final.json"):
        with open(tmp_path / "port" / "plot" / name) as f, \
                open(tmp_path / "jax" / "plot" / name) as g:
            assert json.load(f) == pytest.approx(json.load(g), rel=1e-12), name
