"""The SEE completion of the source domain with its frames spread over the
ranks of a data-parallel group (port of seevcn_tpu/see/sharded.py:51-71;
reference see/surface_completion/sc_multiproc.py:65-94, a worker pool over
the frame list).

JAX runs one program with the frames sharded over its mesh's dp axis and
no collective: each device completes its own frames. Here each rank
completes its contiguous block of F / W frames on its card through
``gt_completion.complete_gt_frames`` (K1 in its replacement stage) and
holds that block of the outputs, as each JAX process holds its addressable
shard.
"""
from __future__ import annotations

from ..parallel.mesh import shard_batch
from .gt_completion import complete_gt_frames


def make_sharded_completion(mesh, vcn, out_pts: int = 1024, sanity_max_dist: float = 2.0):
    """-> ``fn(points (F, P, 3), valid (F, P), gt_boxes (F, D, >=7), gt_mask
    (F, D)) -> (new_pts (F / W, P + D * out_pts, 3), new_valid, inst_ok (F /
    W, D))``: this rank's block of the global batch's frames, completed on
    the mesh's device by ``vcn`` (a ``VCNInference`` there, whose
    ``num_points`` must be ``out_pts``). Raises when F does not divide by
    the world size."""
    if vcn.num_points != out_pts:
        raise ValueError(f"out_pts {out_pts}: the VCN completes {vcn.num_points} points")

    def fn(points, valid, gt_boxes, gt_mask):
        pts, val, gt, gm = shard_batch(mesh, (points, valid, gt_boxes, gt_mask))
        new_pts, new_valid, stats = complete_gt_frames(
            vcn, pts, val, gt, gm, device=mesh.device or vcn.device,
            sanity_max_dist=sanity_max_dist)
        return new_pts, new_valid, stats["inst_valid"]

    return fn
