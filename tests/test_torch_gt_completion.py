"""The port's GT-box SEE completion (seevcn_torch.see.gt_completion) against
the JAX package's ``_complete_one_frame`` (seevcn_tpu/see/sharded.py),
jitted and not sharded, at a small size: two frames of P = 4096 points,
D = 5 ground-truth slots (four cars of chip_smoke.make_scene and one padding
row), instances resampled to 128 points, num_coarse = 128. VCN weights are
flax's, carried across. The JAX replacement runs the TPU's path, the pruned
Pallas kernel in interpret mode, as the SEE frame's test does.

Tolerances: the same instances are completed (equal ``inst_ok``); new_pts,
the completed clouds among them, agree to 1e-3 m (f32 sums in another
order); ``new_valid`` is equal, given that no scan point's distance to the
completed cloud lies within twice the clouds' difference of the 0.1 m
radius. The frames-over-ranks completion (``see.sharded``) at world 2, one
frame a rank over two spawned gloo ranks, is held to the same tolerances
against the same JAX frames.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import make_scene
from seevcn_tpu.models.vcn.nets import build_vcn as jax_build_vcn
from seevcn_tpu.ops.pallas.min_dist import min_sqdist as jax_min_sqdist
from seevcn_tpu.see import device_pipeline as JDP
from seevcn_tpu.see.sharded import _complete_one_frame
from seevcn_torch.models.vcn.inference import VCNInference
from seevcn_torch.see.gt_completion import complete_gt_frames, gt_membership
from seevcn_torch.testing import (assert_close, sharded_completion_worker, spawn_ranks,
                                  to_numpy, to_torch)
from seevcn_torch.utils.weights import vcn_state_dict_from_flax

F, P, D, OUT = 2, 4096, 5, 128


def _pallas_within_radius(a, b, radius, b_valid=None, chunk=8192):
    d = jax_min_sqdist(jnp.asarray(a, jnp.float32)[:, :3],
                       jnp.asarray(b, jnp.float32)[:, :3], b_valid=b_valid,
                       interpret=True, prune_radius=float(radius))
    return d <= radius * radius


def _frames():
    scenes = [make_scene(seed, P, D - 1, pts_per_car=300) for seed in (3, 4)]
    gt = np.zeros((F, D, 8), np.float32)
    for i, s in enumerate(scenes):
        gt[i, :D - 1] = s["gt_boxes"]
    return (np.stack([s["points"] for s in scenes]),
            np.stack([s["valid"] for s in scenes]), gt, gt[..., 3] > 0)


@pytest.fixture(scope="module")
def jax_vcn():
    """JAX's VCN_VC at num_coarse OUT and its variables."""
    model = jax_build_vcn("VCN_VC", num_coarse=OUT)
    return model, jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(1), {"input": jnp.zeros((D, OUT, 3))}))


@pytest.fixture(scope="module")
def runs(jax_vcn):
    mp = pytest.MonkeyPatch()
    mp.setattr(JDP, "within_radius_mask", _pallas_within_radius)
    pts, valid, gt, gt_mask = _frames()
    model, variables = jax_vcn
    one = jax.jit(lambda p, v, g, m: _complete_one_frame(
        model, variables, p, v, g, m, out_pts=OUT, sanity_max_dist=2.0))
    ref = [jax.tree.map(np.asarray, one(pts[i], valid[i], gt[i], gt_mask[i]))
           for i in range(F)]
    mp.undo()
    vcn = VCNInference("VCN_VC", vcn_state_dict_from_flax(variables, "VCN_VC"),
                       num_points=OUT, device="cpu")
    got = complete_gt_frames(vcn, to_torch(pts), to_torch(valid), to_torch(gt),
                             to_torch(gt_mask), device="cpu")
    return (pts, valid, gt, gt_mask), ref, got


def test_gt_membership_lifts_the_boxes():
    pts, valid, gt, gt_mask = _frames()
    member = to_numpy(gt_membership(to_torch(pts[0]), to_torch(valid[0]),
                                    to_torch(gt[0]), to_torch(gt_mask[0])))
    assert member[:D - 1].sum(1).min() > 50 and not member[D - 1].any()
    # the lift: a point 0.05 m above a box's floor is outside, 0.15 m inside
    box = gt[0, 0]
    probe = np.array([box[:3] - [0, 0, box[5] / 2 - d] for d in (0.05, 0.15)],
                     np.float32)
    inside = to_numpy(gt_membership(to_torch(probe), to_torch(np.ones(2, bool)),
                                    to_torch(box[None]), to_torch([True])))
    assert inside.tolist() == [[False, True]]


def _hold_against_jax(frames, ref, new_pts, new_valid, inst_ok):
    pts, valid, gt, gt_mask = frames
    assert new_pts.shape == (F, P + D * OUT, 3)
    for i, (r_pts, r_valid, r_ok) in enumerate(ref):
        assert_close(inst_ok[i], r_ok, name=f"inst_ok[{i}]")
        assert r_ok.any() and not r_ok[D - 1]          # a car completed, no pad
        assert_close(new_pts[i], r_pts, atol=1e-3, name=f"new_pts[{i}]")
        # precondition: no scan point's distance to the completed cloud lies
        # so near 0.1 m that the completions' difference could move it across
        shift = np.abs(to_numpy(new_pts[i]) - r_pts).max()
        flat = r_pts[P:][np.repeat(r_ok, OUT)].astype(np.float64)
        dist = np.sqrt(((pts[i][:, None] - flat[None]) ** 2).sum(-1)).min(1)
        assert not (np.abs(dist - 0.1) <= 2 * shift + 1e-6).any()
        assert_close(new_valid[i], r_valid, name=f"new_valid[{i}]")
        assert int((valid[i] & ~to_numpy(new_valid[i])[:P]).sum()) > 0


def test_gt_completion_matches_jax(runs):
    frames, ref, (new_pts, new_valid, stats) = runs
    _hold_against_jax(frames, ref, new_pts, new_valid, stats["inst_valid"])


def test_sharded_completion_at_world_2_matches_jax(runs, jax_vcn):
    """make_sharded_completion at world 2: each rank completes its frame;
    the ranks' blocks, in rank order, hold as the one-process batch does."""
    frames, ref, _ = runs
    sd = vcn_state_dict_from_flax(jax_vcn[1], "VCN_VC")
    got = spawn_ranks(sharded_completion_worker, 2, sd, frames, OUT)
    assert all(g[0].shape == (1, P + D * OUT, 3) for g in got)
    _hold_against_jax(frames, ref, *(torch.cat([g[i] for g in got]) for i in range(3)))
