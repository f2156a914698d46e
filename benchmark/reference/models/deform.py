# Frozen copy of fourdgs_torch/models/deform.py (lines 1-394,
# commit c19f610): the port's plain path, kept as the benchmark's
# reference, unchanged but for its imports, which name these copies.
"""Control-node deformation field: the "4D" of 4DGS-SLAM (port of
fourdgs/models/deform.py).

  - a fixed-capacity set of control nodes (positions, a learnable
    Gaussian-kernel log-radius and node weight) with a validity mask,
  - an MLP (D=8, W=256, skip after layer 4) over positional encodings of
    (node, t) predicting per-node (d_xyz, d_rotation, d_scaling), its heads
    drawn near zero so that the field starts as the identity warp,
  - per-Gaussian deformation by K=3 Gaussian-kernel KNN blending of the
    node deltas,
  - ARAP: K=10 node connectivity and per-node best-fit rotations by
    batched 3x3 SVD between time samples, stretch energy on the edges,
  - elastic: variance of edge lengths over jittered time samples,
  - acceleration: the second difference of node positions at three times
    (`acc_loss`), and `extend_nodes`, which places new nodes in dead
    slots; the runner calls neither, as the reference's does not.

Every function takes a leading batch of times where the reference vmaps
over them: `node_deform` and `warp` take a scalar t or a (T,) vector, the
regularizers a (V,) vector of view times with their draws. Node positions
never receive a gradient (the reference detaches them everywhere), so the
learned state is the MLP, the radii and the node weights. Random numbers
arrive as arguments (see utils/draws.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ops.knn import farthest_point_sample, knn_indices

XYZ_MULTIRES = 10
T_MULTIRES = 10
MLP_DEPTH = 8
MLP_WIDTH = 256
SKIP_LAYER = MLP_DEPTH // 2
# the heads: name, outputs, standard deviation of the initial weights
HEADS = (("head_warp", 3, 1e-5), ("head_scaling", 3, 1e-8), ("head_rotation", 4, 1e-5))


def posenc(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """NeRF positional encoding with the identity: [x, sin(2^k x),
    cos(2^k x)]_k."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1).reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], dim=-1)


def _posenc_dim(d: int, num_freqs: int) -> int:
    return d * (1 + 2 * num_freqs)


def mlp_dims() -> list[tuple[int, int]]:
    """(d_in, d_out) of the hidden layers; the layer after the skip takes
    the input features too."""
    in_dim = _posenc_dim(3, XYZ_MULTIRES) + _posenc_dim(1, T_MULTIRES)
    return [(in_dim if i == 0 else MLP_WIDTH + in_dim if i == SKIP_LAYER + 1 else MLP_WIDTH,
             MLP_WIDTH) for i in range(MLP_DEPTH)]


class MLPParams(NamedTuple):
    weights: tuple        # (d_in, d_out) per hidden layer
    biases: tuple
    head_warp: tuple      # (W, b) -> 3
    head_scaling: tuple   # (W, b) -> 3
    head_rotation: tuple  # (W, b) -> 4


class ControlNodes(NamedTuple):
    nodes: torch.Tensor       # (M, 3)
    radius_raw: torch.Tensor  # (M,) log-radius
    weight_raw: torch.Tensor  # (M, 1) node weight
    valid: torch.Tensor       # (M,) bool
    mlp: MLPParams

    @property
    def node_radius(self) -> torch.Tensor:
        return torch.exp(self.radius_raw)

    @property
    def node_weight(self) -> torch.Tensor:
        # |w| with the reference's gradient at 0 (+1, where torch.abs gives
        # 0): the raw weights start at exactly 0
        w = self.weight_raw
        return torch.where(w >= 0, w, -w) + 1e-7


class ControlNodeFloats(NamedTuple):
    """The floating-point part of ControlNodes, which Adam steps."""

    nodes: torch.Tensor
    radius_raw: torch.Tensor
    weight_raw: torch.Tensor
    mlp: MLPParams


def cn_floats(cn: ControlNodes) -> ControlNodeFloats:
    return ControlNodeFloats(cn.nodes, cn.radius_raw, cn.weight_raw, cn.mlp)


def cn_merge(f: ControlNodeFloats, valid: torch.Tensor) -> ControlNodes:
    return ControlNodes(nodes=f.nodes, radius_raw=f.radius_raw, weight_raw=f.weight_raw,
                        valid=valid, mlp=f.mlp)


def leaves(f: ControlNodeFloats) -> list[torch.Tensor]:
    """The tensors of `f` in a fixed order."""
    m = f.mlp
    out = [f.nodes, f.radius_raw, f.weight_raw, *m.weights, *m.biases]
    for name, _, _ in HEADS:
        out += list(getattr(m, name))
    return out


def from_leaves(ts, like: ControlNodeFloats) -> ControlNodeFloats:
    """Inverse of `leaves`, shaped like `like`."""
    ts = list(ts)
    d = len(like.mlp.weights)
    heads = {name: (ts[3 + 2 * d + 2 * i], ts[4 + 2 * d + 2 * i])
             for i, (name, _, _) in enumerate(HEADS)}
    return ControlNodeFloats(ts[0], ts[1], ts[2], MLPParams(
        weights=tuple(ts[3:3 + d]), biases=tuple(ts[3 + d:3 + 2 * d]), **heads))


def flatten(f: ControlNodeFloats) -> torch.Tensor:
    """All of `f` as one flat float32 vector."""
    return torch.cat([t.reshape(-1) for t in leaves(f)])


def unflatten(flat: torch.Tensor, like: ControlNodeFloats) -> ControlNodeFloats:
    """Views into `flat` shaped like `like` (differentiable: gradients of
    the views sum into `flat`)."""
    out, at = [], 0
    for t in leaves(like):
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return from_leaves(out, like)


def init_mlp(layer_weights, head_normals) -> MLPParams:
    """The MLP from its initial draws: hidden weights (uniform in
    +-sqrt(6 / d_in), kaiming fan-in) and one standard-normal (W, d_out)
    draw per head, scaled by the head's deviation; biases zero."""
    dev = layer_weights[0].device
    heads = {name: (n * std, torch.zeros(d, device=dev))
             for (name, d, std), n in zip(HEADS, head_normals)}
    return MLPParams(weights=tuple(layer_weights),
                     biases=tuple(torch.zeros(w.shape[1], device=dev) for w in layer_weights),
                     **heads)


def init_nodes(capacity: int, init_points: torch.Tensor, points_valid: torch.Tensor,
               node_num: int, start, mlp: MLPParams) -> ControlNodes:
    """`node_num` control nodes farthest-point sampled from the valid points
    from index `start`, radii at 0.1x the scene range."""
    node_num = min(node_num, capacity)
    dev = init_points.device
    sel = farthest_point_sample(init_points, points_valid, node_num, start)
    nodes = torch.zeros((capacity, 3), device=dev)
    nodes[:node_num] = init_points[sel]
    valid = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    valid[:node_num] = True
    inf = torch.full_like(init_points, float("inf"))
    pmax = torch.max(torch.where(points_valid[:, None], init_points, -inf))
    pmin = torch.min(torch.where(points_valid[:, None], init_points, inf))
    radius = torch.log(0.1 * (pmax - pmin) + 1e-7)
    return ControlNodes(nodes=nodes, radius_raw=radius.expand(capacity).clone(),
                        weight_raw=torch.zeros((capacity, 1), device=dev), valid=valid,
                        mlp=mlp)


def extend_nodes(cn: ControlNodes, new_points: torch.Tensor, points_valid: torch.Tensor,
                 start, sample_number: int = 250) -> ControlNodes:
    """Control nodes for newly appearing dynamic regions, farthest-point
    sampled from the valid new points from index `start` into the dead
    slots (taken in stable order of `valid`, at most as many as are free),
    at weight 0 and the median log-radius of the nodes. The median is
    taken as the reference takes it, over every slot with the dead ones
    NaN: so it is NaN, and log(0.1) is used, whenever a slot is dead."""
    capacity = cn.nodes.shape[0]
    dev = cn.nodes.device
    free = torch.sum(~cn.valid)
    n_add = int(min(sample_number, capacity))
    sel = farthest_point_sample(new_points, points_valid, n_add, start)
    slots = torch.argsort(cn.valid.to(torch.uint8), stable=True)[:n_add]
    take = (~cn.valid[slots]) & (torch.arange(n_add, device=dev) < free)
    nan = torch.full_like(cn.radius_raw, float("nan"))
    med_r = torch.quantile(torch.where(cn.valid, cn.radius_raw, nan), 0.5)
    med_r = torch.where(torch.isnan(med_r), torch.log(torch.tensor(0.1, device=dev)), med_r)
    nodes, radius = cn.nodes.clone(), cn.radius_raw.clone()
    weight, valid = cn.weight_raw.clone(), cn.valid.clone()
    nodes[slots] = torch.where(take[:, None], new_points[sel], cn.nodes[slots])
    radius[slots] = torch.where(take, med_r, cn.radius_raw[slots])
    weight[slots] = torch.where(take[:, None], torch.zeros_like(cn.weight_raw[slots]),
                                cn.weight_raw[slots])
    valid[slots] = take | cn.valid[slots]
    return cn._replace(nodes=nodes, radius_raw=radius, weight_raw=weight, valid=valid)


def mlp_forward(mlp: MLPParams, x: torch.Tensor, t: torch.Tensor):
    """x (..., 3), t (..., 1) -> (d_xyz, d_rotation, d_scaling)."""
    inp = torch.cat([posenc(x, XYZ_MULTIRES), posenc(t, T_MULTIRES)], dim=-1)
    h = inp
    for i in range(MLP_DEPTH):
        h = torch.relu(h @ mlp.weights[i] + mlp.biases[i])
        if i == SKIP_LAYER:
            h = torch.cat([inp, h], dim=-1)
    d_xyz = h @ mlp.head_warp[0] + mlp.head_warp[1]
    d_scaling = h @ mlp.head_scaling[0] + mlp.head_scaling[1]
    d_rotation = h @ mlp.head_rotation[0] + mlp.head_rotation[1]
    return d_xyz, d_rotation, d_scaling


def node_deform(cn: ControlNodes, t: torch.Tensor):
    """Per-node deltas at time t: a scalar gives (M, .) outputs, a (T,)
    vector (T, M, .). Node positions are detached."""
    nodes = cn.nodes.detach()
    t = torch.as_tensor(t, dtype=nodes.dtype, device=nodes.device)
    lead = t.shape
    x = nodes.expand(lead + nodes.shape)
    tt = t.reshape(lead + (1, 1)).expand(lead + (nodes.shape[0], 1))
    return mlp_forward(cn.mlp, x, tt)


def knn_nodes(cn: ControlNodes, x: torch.Tensor, k: int = 3):
    """(sq_dists, indices) of the k nearest valid nodes of the points x,
    both detached: the part of the blend that does not depend on time."""
    return knn_indices(x.detach(), cn.nodes.detach(), k, ref_valid=cn.valid)


def blend_weights(cn: ControlNodes, d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """exp(-d^2 / (2 r^2)) * node_weight, normalized over the picks;
    differentiable in the radii and node weights."""
    r = cn.node_radius[idx]
    w = torch.exp(-d2 / (2.0 * r * r))
    w = w * cn.node_weight[idx, 0]
    w = w + 1e-7
    return w / torch.sum(w, dim=-1, keepdim=True)


def nn_weights(cn: ControlNodes, x: torch.Tensor, k: int = 3):
    """Gaussian-kernel KNN blend weights of the points x: (w, idx)."""
    d2, idx = knn_nodes(cn, x, k)
    return blend_weights(cn, d2, idx), idx


def warp(cn: ControlNodes, x: torch.Tensor, t, k: int = 3,
         motion_mask: torch.Tensor | None = None):
    """Deform points x (N, 3) at time t (a scalar, or (T,) for a batch of
    times): blended (d_xyz, d_rotation residual, d_scaling), each (N, .) or
    (T, N, .)."""
    w, idx = nn_weights(cn, x, k)
    return blend_deform(node_deform(cn, t), w, idx, motion_mask)


def blend_deform(nd, w: torch.Tensor, idx: torch.Tensor,
                 motion_mask: torch.Tensor | None = None):
    """Per-point deformation from per-node deltas nd = (d_xyz, d_rot,
    d_scale), each (..., M, .), and blend weights and indices (N, k):
    (d_xyz, d_rot, d_scale), each (..., N, .), zero where motion_mask is
    False."""
    nd = torch.cat(nd, dim=-1)                                  # (..., M, 10)
    d = torch.sum(nd[..., idx, :] * w[..., None], dim=-2)       # (..., N, 10)
    if motion_mask is not None:
        d = d * motion_mask.to(d.dtype)[:, None]
    return d[..., :3], d[..., 3:7], d[..., 7:]


# ---------------------------------------------------------------------------
# Regularizers
# ---------------------------------------------------------------------------


def _gather_nodes(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts (..., M, 3), idx (..., M, K) -> (..., M, K, 3)."""
    lead = idx.shape[:-2]
    flat = idx.reshape(lead + (-1,))
    out = torch.gather(pts, -2, flat[..., None].expand(flat.shape + (3,)))
    return out.reshape(idx.shape + (3,))


def _connectivity(points: torch.Tensor, valid: torch.Tensor, k: int = 10):
    """K-NN edges (self excluded) and adaptive weights of (..., M, 3)
    points."""
    d2, idx = knn_indices(points, points, k + 1, ref_valid=valid)
    d2, idx = d2[..., 1:], idx[..., 1:]
    weight = torch.exp(-d2 / torch.clamp(torch.mean(d2, dim=(-2, -1), keepdim=True), min=1e-9))
    weight = weight * valid[:, None] * valid[idx]
    return idx, weight


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _estimate_rotation(src_edges, tgt_edges, weight):
    """Per-node best-fit rotation by batched 3x3 SVD: R = V U^T, with the
    column of U of the smallest singular value flipped where det(R) <= 0."""
    S = torch.einsum("...nka,...nk,...nkb->...nab", src_edges, weight, tgt_edges)
    U, sig, Vh = torch.linalg.svd(S)
    W = Vh.transpose(-1, -2)
    R = W @ U.transpose(-1, -2)
    flip = _det3(R) <= 0
    col = torch.argmin(sig, dim=-1)
    sign = torch.where(flip[..., None] & (torch.arange(3, device=S.device) == col[..., None]),
                       -1.0, 1.0)
    Rfix = W @ (U * sign[..., None, :]).transpose(-1, -2)
    return torch.where(flip[..., None, None], Rfix, R)


def sample_times(u0: torch.Tensor, u_samp: torch.Tensor, t: torch.Tensor, delta_t: float):
    """The regularizers' jittered time samples around each view time t
    (V,): a centre t0 = t + delta_t (u0 - 0.5), then (V, T) samples
    u delta_t + t0 - delta_t / 2."""
    t0 = t + delta_t * (u0 - 0.5)
    return u_samp * delta_t + t0[:, None] - 0.5 * delta_t


def nodes_at(cn: ControlNodes, times: torch.Tensor) -> torch.Tensor:
    """Node positions at times (...,): (..., M, 3)."""
    d_xyz, _, _ = node_deform(cn, times.reshape(-1))
    return (cn.nodes.detach() + d_xyz).reshape(times.shape + cn.nodes.shape)


def arap_from_nodes(nodes_t: torch.Tensor, valid: torch.Tensor, k: int = 10) -> torch.Tensor:
    """ARAP energy of node positions (V, T, M, 3) between sample 0 and
    each later sample: (V,)."""
    idx, weight = _connectivity(nodes_t[:, 0].detach(), valid, k)
    src = nodes_t[:, 0]
    src_edges = _gather_nodes(src, idx) - src[..., None, :]
    err = nodes_t.new_zeros(nodes_t.shape[0])
    for j in range(1, nodes_t.shape[1]):
        tgt = nodes_t[:, j]
        tgt_edges = _gather_nodes(tgt, idx) - tgt[..., None, :]
        with torch.no_grad():
            R = _estimate_rotation(src_edges.detach(), tgt_edges.detach(), weight)
        rigid = torch.einsum("...nab,...nkb->...nka", R, src_edges)
        stretch = torch.sum((tgt_edges - rigid) ** 2, dim=-1)
        err = err + torch.sum(weight * stretch, dim=(-2, -1))
    return err


def elastic_from_nodes(nodes_t: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Normalized edge-length variance of node positions (V, T, M, 3) over
    the T samples, on the edges (idx, weights w) of `elastic_edges`: (V,)."""
    edge = torch.linalg.vector_norm(nodes_t[:, :, idx] - nodes_t[:, :, :, None], dim=-1)
    mean = torch.mean(edge, dim=1, keepdim=True)
    var = torch.mean((edge - mean) ** 2, dim=1)
    var = var / (var.detach() + 1e-5)
    return torch.mean(torch.sum(var * w, dim=-1) * valid.to(var.dtype), dim=-1)


def elastic_edges(cn: ControlNodes, k: int = 2):
    """The elastic term's k edges per node (self excluded) with their blend
    weights: (w (M, k), idx (M, k))."""
    w, idx = nn_weights(cn, cn.nodes.detach(), k + 1)
    return w[:, 1:], idx[:, 1:]


def arap_loss(cn: ControlNodes, u0: torch.Tensor, u_samp: torch.Tensor, t: torch.Tensor,
              delta_t: float, k: int = 10) -> torch.Tensor:
    """As-rigid-as-possible energy between time samples around each view
    time t (V,), from uniform draws u0 (V,) and u_samp (V, T): (V,)."""
    return arap_from_nodes(nodes_at(cn, sample_times(u0, u_samp, t, delta_t)), cn.valid, k)


def elastic_loss(cn: ControlNodes, u0: torch.Tensor, u_samp: torch.Tensor, t: torch.Tensor,
                 delta_t: float, k: int = 2) -> torch.Tensor:
    """Edge-length variance over jittered time samples around each view
    time t (V,), from uniform draws u0 (V,) and u_samp (V, T): (V,)."""
    w, idx = elastic_edges(cn, k)
    return elastic_from_nodes(nodes_at(cn, sample_times(u0, u_samp, t, delta_t)), w, idx,
                              cn.valid)


def acc_loss(cn: ControlNodes, u: torch.Tensor, t: torch.Tensor, delta_t: float) -> torch.Tensor:
    """Acceleration regularizer: the norm of the second difference of node
    positions at t0 - delta_t, t0 and t0 + delta_t, t0 = t + delta_t
    (u - 0.5) from a uniform draw u, each node's normalized by its own
    detached value, averaged over all slots with the dead ones 0. A
    scalar t (and u) gives a scalar, a (V,) vector (V,)."""
    t0 = t + delta_t * (u - 0.5)
    ts = torch.stack([t0 - delta_t, t0, t0 + delta_t], dim=-1)
    n = nodes_at(cn, ts)                                        # (..., 3, M, 3)
    acc = torch.linalg.vector_norm(n[..., 0, :, :] + n[..., 2, :, :] - 2 * n[..., 1, :, :],
                                   dim=-1)
    acc = acc / (acc.detach() + 1e-5)
    return torch.mean(acc * cn.valid.to(acc.dtype), dim=-1)
