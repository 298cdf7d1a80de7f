"""SEE completion of the source domain: each labelled car's points, found by
its ground-truth box, completed by VCN and spliced back into its frame.

Port of ``_complete_one_frame`` of seevcn_tpu/see/sharded.py (the
reference's config-1 GT path, SEE_VCN.py:46-56 ``get_pcd_gtboxes``), the
preprocessing that turns a labelled source scan into the completed cloud a
detector is then trained on. Per frame: the points inside each GT box, the
box lifted 0.05 m off the ground and 0.1 m shorter; then the SEE frame's own
stages (``see/frame.py``): isolation (DBSCAN, largest cluster, the first
2,048 points of each instance, tiled to the VCN's ``num_points``), VCN with partial-mesh selection (k = 30) and the largest
cluster (eps 0.4), the 2 m sanity guard, and the replacement, whose
within-radius test is the pruned min-distance kernel K1 on the card.

On one card the frames are a batch: isolation and replacement run frame
by frame, the VCN once on every frame's instances. ``see/sharded.py``
spreads the frames over the ranks of a data-parallel group, as the
reference spreads them over its mesh's dp axis.
"""
from __future__ import annotations

import torch

from .. import resolve_device, tf32_off
from ..geom.boxes import points_in_boxes
from . import device_pipeline as DP
from .frame import replace_stage, vcn_stage


def gt_membership(points: torch.Tensor, valid: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_mask: torch.Tensor) -> torch.Tensor:
    """(D, P) bool: the valid points inside each valid GT box (D, >=7),
    lifted off the ground (z + 0.05, dz - 0.1)."""
    lift = gt_boxes.new_tensor([0, 0, 0.05, 0, 0, -0.1, 0])
    member = points_in_boxes(points[:, :3], gt_boxes[:, :7] + lift)
    return member & gt_mask[:, None] & valid[None, :]


@torch.no_grad()
def complete_gt_frames(vcn, points: torch.Tensor, valid: torch.Tensor,
                       gt_boxes: torch.Tensor, gt_mask: torch.Tensor, *,
                       device="cuda", sanity_max_dist: float = 2.0):
    """GT-path completion of a batch of F frames on ``device``.

    points (F, P, 3), valid (F, P), gt_boxes (F, D, >=7), gt_mask (F, D);
    ``vcn`` a ``VCNInference`` on the same device, whose ``num_points`` (n)
    sets each instance's size (the first 2,048 points of an instance are
    resampled to n). Returns (new_pts (F, P + D*n, 3), new_valid, stats):
    each frame's scan with the points near a completed car dropped and the
    completed surfaces appended; stats holds, each (F, D, ...), the isolated
    and completed instances and their validity (``ok``, ``sane``,
    ``inst_valid = ok & sane``, the reference's returned ``ok``; ``sane``
    the guard at ``sanity_max_dist``). TF32 is off, as in
    ``complete_frame``."""
    dev = resolve_device(device)
    tf32_off()
    points, valid, gt_boxes, gt_mask = (t.to(dev) for t in (points, valid,
                                                            gt_boxes, gt_mask))
    f, d = gt_mask.shape
    iso, ok = zip(*(DP.isolate_and_resample(
        points[i], gt_membership(points[i], valid[i], gt_boxes[i], gt_mask[i]),
        out_pts=vcn.num_points) for i in range(f)))
    iso, ok = torch.stack(iso), torch.stack(ok)
    completed, sane = vcn_stage(vcn, iso.flatten(0, 1), sanity_max_dist)
    completed, sane = completed.view(iso.shape), sane.view(f, d)
    inst_valid = ok & sane
    new_pts, new_valid = zip(*(replace_stage(points[i], valid[i], completed[i],
                                             inst_valid[i]) for i in range(f)))
    stats = {"isolated": iso, "completed": completed, "ok": ok, "sane": sane,
             "inst_valid": inst_valid}
    return torch.stack(new_pts), torch.stack(new_valid), stats
