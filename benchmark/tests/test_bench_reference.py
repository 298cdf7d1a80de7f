"""The plain reference is the definitions written anew, and it agrees with
seevcn_torch on the CPU: each independent form against the program's
operation it stands for, and each cell's comparison at the tiny size; and
each fault planted in the program's place makes ``correct`` false."""
import pytest
import torch

from benchmark.harness.main import cell_spec, run_cell
from benchmark.reference.seeref.models.modules import anchors as RA
from benchmark.reference.seeref.models.modules.box_coder import ResidualCoder
from benchmark.reference.seeref.ops import iou3d as RI
from benchmark.reference.seeref.ops import neighbours as RN
from benchmark.reference.seeref.ops import nms as RNMS
from benchmark.reference.seeref.ops import sparse as RS
from benchmark.reference.seeref.ops import voxelize as RV

CELLS = ("second_iou_f32.train", "second_iou.see_gt")


def _sparse_input(gen, shape=(9, 12, 10), batch=2, rows=120, cin=3):
    sites = torch.randperm(batch * shape[0] * shape[1] * shape[2], generator=gen)[:rows]
    sites = torch.sort(sites).values
    b, rest = sites // (shape[0] * shape[1] * shape[2]), sites % (shape[0] * shape[1] * shape[2])
    coords = torch.stack([b, rest // (shape[1] * shape[2]), rest // shape[2] % shape[1],
                          rest % shape[2]], 1).int()
    return torch.randn(rows, cin, generator=gen, dtype=torch.float64), coords


@pytest.mark.parametrize("subm,stride,pad,ks", [(True, 1, 1, 3), (False, 2, 1, 3),
                                                (False, 2, (0, 1, 1), 3),
                                                (False, (2, 1, 1), 0, (3, 1, 1))])
def test_dense_sparse_conv_matches_the_rulebook(subm, stride, pad, ks):
    from seevcn_torch.ops import sparse as PS
    gen = torch.Generator().manual_seed(3)
    feats, coords = _sparse_input(gen)
    kk = RS._as3(ks)
    w = torch.randn(kk[0] * kk[1] * kk[2], 3, 5, generator=gen, dtype=torch.float64)
    mask = torch.ones(feats.shape[0], dtype=torch.bool)
    out = {}
    for name, mod in (("ref", RS), ("prog", PS)):
        f, wt = feats.clone().requires_grad_(), w.clone().requires_grad_()
        st = mod.make_sparse_tensor(f, coords, mask, (9, 12, 10), 2)
        o = mod.subm_conv3d(st, wt, ks, pad) if subm else \
            mod.sparse_conv3d(st, wt, ks, stride, pad, out_capacity=mod.ALL)
        key = {tuple(c): r for c, r, m in zip(o.coords.tolist(), o.features, o.mask) if m}
        sq = sum((r ** 2 * (i + 1)).sum() for i, r in enumerate(key[k] for k in sorted(key)))
        sq.backward()
        out[name] = ({k: key[k].detach() for k in key}, f.grad, wt.grad)
    (rk, rf, rw), (pk, pf, pw) = out["ref"], out["prog"]
    assert sorted(rk) == sorted(pk) and len(rk) > 20
    assert max(float((rk[k] - pk[k]).abs().max()) for k in rk) < 1e-10
    assert float((rf - pf).abs().max()) < 1e-9
    # the program sums its weight gradient in float32 whatever the inputs' dtype
    assert float((rw - pw).abs().max()) < 1e-6 * float(rw.abs().max())


@pytest.mark.parametrize("cap", [10_000, 40])
def test_voxel_mean_matches_the_program(cap):
    from seevcn_torch.ops import voxelize as PV
    gen = torch.Generator().manual_seed(5)
    pts = torch.rand(3000, 3, generator=gen, dtype=torch.float64) * torch.tensor([4.0, 4, 2])
    valid = torch.rand(3000, generator=gen) > 0.1
    kw = dict(point_cloud_range=[0, 0, 0, 4, 4, 2], voxel_size=[0.5, 0.5, 0.5],
              max_voxels=cap, max_points_per_voxel=5)
    rf, rc = RV.voxelize(pts, valid, **kw)
    p = PV.voxelize(pts, valid, **kw)
    assert torch.equal(rc, p.coords[p.mask]) and rf.shape[0] == min(cap, 256)
    assert float((rf - p.features[p.mask]).abs().max()) < 1e-12


def _boxes(gen, n, spread=12.0):
    return torch.cat([torch.rand(n, 2, generator=gen) * spread, torch.rand(n, 1, generator=gen),
                      1 + 3 * torch.rand(n, 3, generator=gen),
                      torch.rand(n, 1, generator=gen) * 6.3], 1)


def test_clipped_iou_and_greedy_nms_match_the_program():
    from seevcn_torch.ops import iou3d as PI
    from seevcn_torch.ops import nms as PN
    gen = torch.Generator().manual_seed(7)
    b = _boxes(gen, 200)
    assert float((RI.boxes_iou_bev(b, b) - PI.boxes_iou_bev(b, b)).abs().max()) < 1e-3
    assert float((RI.boxes_iou3d(b, b) - PI.boxes_iou3d(b, b)).abs().max()) < 1e-3
    scores = torch.rand(200, generator=gen)
    for thresh in (0.1, 0.5, 0.8):
        ri, rk, _ = RNMS.nms_bev(b, scores, thresh, pre_maxsize=150, post_maxsize=40,
                                 score_thresh=0.05)
        pi, pk, _ = PN.nms_bev(b, scores, thresh, pre_maxsize=150, post_maxsize=40,
                               score_thresh=0.05)
        assert torch.equal(rk, pk) and torch.equal(ri[rk], pi[pk])


def test_target_assignment_matches_the_program():
    from seevcn_torch.models.modules import anchors as PA
    from seevcn_torch.models.modules.box_coder import ResidualCoder as PCoder
    cfg = [{"class_name": "Car", "anchor_sizes": [[3.9, 1.6, 1.56]], "anchor_rotations": [0, 1.57],
            "anchor_bottom_heights": [-1.78], "align_center": False, "feature_map_stride": 2,
            "matched_threshold": 0.6, "unmatched_threshold": 0.45}]
    anchors, _ = RA.generate_anchors(cfg, [40, 40, 10], [0, -10, -3, 20, 10, 1])
    a = torch.as_tensor(anchors).view(-1, 2, 7)
    gen = torch.Generator().manual_seed(11)
    gt = torch.zeros(2, 6, 8)
    gt[:, :4, :7] = _boxes(gen, 8, 18.0).view(2, 4, 7) + torch.tensor([0, -9.0, -1.5, 0, 0, 0, 0])
    gt[:, :4, 7] = 1
    r = RA.AxisAlignedTargetAssigner(cfg, ["Car"], ResidualCoder()).assign([a], gt)
    p = PA.AxisAlignedTargetAssigner(cfg, ["Car"], PCoder()).assign([a], gt)
    assert torch.equal(r["box_cls_labels"], p["box_cls_labels"])
    assert (r["box_cls_labels"] > 0).sum() >= 4
    assert float((r["box_reg_targets"] - p["box_reg_targets"]).abs().max()) < 1e-5


def test_dbscan_and_partial_mesh_match_the_program():
    from seevcn_torch.ops import clustering as PC
    from seevcn_torch.ops import sampling as PSm
    gen = torch.Generator().manual_seed(13)
    centres = torch.rand(5, 3, generator=gen, dtype=torch.float64) * 6
    pts = (centres.repeat_interleave(60, 0)
           + 0.25 * torch.randn(300, 3, generator=gen, dtype=torch.float64))
    pts = torch.cat([pts, torch.rand(40, 3, generator=gen, dtype=torch.float64) * 8])
    r = RN.dbscan(pts, 0.35, 3)
    p = PC.dbscan(pts, 0.35, min_points=3, n_iters=12)
    assert torch.equal(r, p.long()) and int((r >= 0).sum()) > 250
    assert torch.equal(RN.largest_cluster(r), PC.largest_cluster_mask(p))
    obs = pts[:100]
    assert torch.equal(RN.knn_union(obs, pts, 7), PSm.knn_union_mask(obs, pts, 7))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(tiny_bench, cell):
    r = run_cell(cell_spec(cell, tiny_bench), 2**31 + 3, 0.0, False, device="cpu")
    print(cell, {k: c["value"] for k, c in r["checks"].items()})
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("second_iou_f32.train", "unchanged"), ("second_iou_f32.train", "half_batch"),
    ("second_iou.see_gt", "alter_answer")])
def test_planted_fault_is_not_correct(tiny_bench, cell, fault):
    r = run_cell(cell_spec(cell, tiny_bench), 2**31 + 7, 0.0, False, device="cpu",
                 overrides={"fault": fault})
    print(cell, fault, {k: c["value"] for k, c in r["checks"].items()})
    assert not r["correct"]
