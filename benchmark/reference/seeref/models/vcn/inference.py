"""A VCN with its weights on one device, and SEE's completion step around
it: the net's points, those among the ``sel_k`` nearest of some observed
point (the partial mesh) tiled to ``num_points``, and their largest DBSCAN
cluster (eps ``cluster_eps``, 2 points) tiled again."""
from __future__ import annotations

import torch

from ... import resolve_device
from ...ops.neighbours import dbscan, knn_union, largest_cluster, tile
from .nets import build_vcn


class VCNInference:
    def __init__(self, model_name: str, state_dict: dict, *, num_points: int = 1024,
                 sel_k: int = 30, cluster_eps: float = 0.4, device="cuda"):
        self.device = resolve_device(device)
        self.num_points, self.sel_k, self.cluster_eps = num_points, sel_k, cluster_eps
        self.model = build_vcn(model_name, num_coarse=num_points)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, pc: torch.Tensor, gt: torch.Tensor | None = None) -> torch.Tensor:
        """(B, n, 3) observed objects -> (4, B, num_points, 3): [input, coarse,
        surface, clustered]."""
        coarse = self.model({"input": pc, "gt_boxes": gt})["coarse"]
        n = self.num_points
        surface, clustered = [], []
        for obs, pred in zip(pc, coarse):
            s = tile(pred, knn_union(obs, pred, self.sel_k), n)
            keep = largest_cluster(dbscan(s, self.cluster_eps, 2))
            surface.append(s)
            clustered.append(tile(s, keep if bool(keep.any()) else torch.ones_like(keep), n))
        return torch.stack([pc, coarse, torch.stack(surface), torch.stack(clustered)])
