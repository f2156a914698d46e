"""checks.FieldTap on a small deformation field of the frozen reference:
the field's gradient read through the flat vector its tensors are views
of (as the program and the reference lay a field out) equals autograd's,
and read through the MLP's own tensors where they are not views of one
vector; the warp's rows and the field after its step; and the gaps that
read them: 0 against themselves, 0.01 for a head scaled by 1.01."""

import torch

from benchmark import checks
from benchmark.reference.models import deform as RD


def small_field(seed=0, nodes=16):
    g = torch.Generator().manual_seed(seed)
    ws = [torch.rand(d_in, d_out, generator=g) * 0.2 - 0.1 for d_in, d_out in RD.mlp_dims()]
    heads = [torch.randn(RD.MLP_WIDTH, d, generator=g) for _, d, _ in RD.HEADS]
    pts = torch.rand(nodes, 3, generator=g)
    return RD.init_nodes(nodes, pts, torch.ones(nodes, dtype=torch.bool), nodes, 0,
                         RD.init_mlp(ws, heads))


def one_iteration(cn, flat_views: bool):
    """A loss over the warp at two times and a regularizer-like term on
    the radii, its gradient, then a plain step: (the tap, autograd's
    gradient by tensor, the stepped field)."""
    like = RD.cn_floats(cn)
    if flat_views:
        leaves = [RD.flatten(like).requires_grad_(True)]
        field = lambda ts: RD.unflatten(ts[0], like)  # noqa: E731
    else:
        leaves = [t.detach().clone().requires_grad_(True) for t in RD.leaves(like)]
        field = lambda ts: RD.from_leaves(ts, like)  # noqa: E731
    with checks.tapped(RD, cn) as tap:
        cn_p = RD.cn_merge(field(leaves), cn.valid)
        x = torch.rand(40, 3, generator=torch.Generator().manual_seed(1))
        d = RD.warp(cn_p, x, torch.tensor([0.1, 0.3]))
        loss = sum((v ** 2).sum() for v in d) + cn_p.node_radius.sum()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            cn_1 = RD.cn_merge(field([t - 1e-3 * g for t, g in zip(leaves, grads)]), cn.valid)
        RD.node_deform(cn_1, torch.tensor(0.2))   # the next evaluation sees the step
    want = checks.field_tensors(RD.cn_merge(field(grads), cn.valid))
    return tap, want, checks.field_tensors(cn_1)


def test_gradient_through_the_flat_vector_equals_autograd():
    tap, want, stepped = one_iteration(small_field(), flat_views=True)
    assert set(tap.grad) == set(want)
    for k, g in want.items():
        assert torch.equal(tap.grad[k], g), k
    assert tap.grad["radius_raw"].abs().max() > 0
    for k, v in tap.result(None)["step"].items():
        assert torch.equal(v, stepped[k]), k
    assert len(tap.warp) == 1 and tap.warp[0][0].shape == (2 * 16, 4)


def test_gradient_through_the_mlp_tensors_where_no_flat_vector():
    tap, want, _ = one_iteration(small_field(), flat_views=False)
    assert set(tap.grad) == set(checks.mlp_tensors(small_field().mlp))
    for k, g in tap.grad.items():
        assert torch.equal(g, want[k]), k
    # compared over the tensors both sides read
    full, _, _ = one_iteration(small_field(), flat_views=True)
    assert checks.field_grad_gap(tap.grad, full.grad) == 0.0


def test_gaps_read_zero_against_themselves_and_a_scaled_head():
    tap, _, _ = one_iteration(small_field(), flat_views=True)
    res = tap.result(None)
    assert checks.warp_gap(res["warp"], res["warp"]) == 0.0
    assert checks.field_grad_gap(res["grad"], res["grad"]) == 0.0
    assert checks.field_step_gap(res["step"], res["step"], res["grad"], 8e-4) == 0.0
    scaled = [(x, torch.cat([o[:, :3] * 1.01, o[:, 3:]], dim=1)) for x, o in res["warp"]]
    assert abs(checks.warp_gap(scaled, res["warp"]) - 0.01) < 1e-6
    # the same rows met twice count once; other inputs read inf
    assert checks.warp_gap(res["warp"] * 2, res["warp"]) == 0.0
    moved = [(x + 1.0, o) for x, o in res["warp"]]
    assert checks.warp_gap(moved, res["warp"]) == float("inf")
    assert checks.field_grad_gap(None, res["grad"]) == float("inf")
