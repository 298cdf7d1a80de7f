"""Batched VCN inference (port of seevcn_tpu/models/vcn/inference.py).

``forward_chain`` is the completion step of the SEE frame: the net, then
the predicted points near the observed ones (partial mesh, k-NN union),
then the largest cluster. ``VCNInference`` holds a net built from a state
dict on one device; ``VCNInference.from_cfg`` builds one from the SEE
config's VCN block and its reference checkpoint.
"""
from __future__ import annotations

import torch

from ... import resolve_device
from ...ops.clustering import largest_cluster_batch
from ...ops.sampling import partial_mesh_batch
from ...utils.ckpt import load_vcn_checkpoint
from .nets import build_vcn


@torch.no_grad()
def forward_chain(model, pc: torch.Tensor, gt: torch.Tensor | None = None, *,
                  sel_k: int = 30, eps: float = 0.4) -> torch.Tensor:
    """(B, n, 3) objects -> (4, B, n, 3): [input, coarse, surface,
    clustered], with n = the net's ``num_coarse`` for the last three."""
    in_dict = {"input": pc}
    if gt is not None:
        in_dict["gt_boxes"] = gt
    coarse = model(in_dict)["coarse"]
    surface = partial_mesh_batch(pc, coarse, k=sel_k,
                                 surface_pts=coarse.shape[1])
    clustered = largest_cluster_batch(surface, eps=eps, min_points=2,
                                      total_pts=coarse.shape[1])
    return torch.stack([pc, coarse, surface, clustered])


class VCNInference:
    """A VCN net (``VCN_VC``/``VCN_CN`` ...) with its weights on one device,
    plus the partial-mesh ``sel_k`` and cluster ``eps`` of the SEE config."""

    def __init__(self, model_name: str, state_dict: dict, *,
                 num_points: int = 1024, sel_k: int = 30,
                 cluster_eps: float = 0.4, device="cuda"):
        self.device = resolve_device(device)
        self.num_points = num_points
        self.sel_k = sel_k
        self.cluster_eps = cluster_eps
        self.model = build_vcn(model_name, num_coarse=num_points)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    @classmethod
    def from_cfg(cls, cfg, *, device="cuda"):
        """From the reference SEE config's VCN block (MODEL, CKPT_PATH,
        SEL_K_NEAREST, CLUSTER_EPS), reading the ``.pth`` at CKPT_PATH.
        The port runs every object in one batch, so BATCH_SIZE_LIMIT has
        nothing to bound; NORM_WITH_GT asks the caller for ``gt``."""
        return cls(cfg.MODEL, load_vcn_checkpoint(cfg.CKPT_PATH, cfg.MODEL),
                   sel_k=int(cfg.get("SEL_K_NEAREST", 30)),
                   cluster_eps=float(cfg.get("CLUSTER_EPS", 0.4)), device=device)

    def __call__(self, pc: torch.Tensor, gt: torch.Tensor | None = None):
        """(B, n, 3) -> (4, B, num_points, 3) [input, coarse, surface,
        clustered]."""
        return forward_chain(self.model, pc, gt, sel_k=self.sel_k,
                             eps=self.cluster_eps)
