"""Batched VCN inference (port of seevcn_tpu/models/vcn/inference.py).

``forward_chain`` is the completion step of the SEE frame: the net, then
the predicted points near the observed ones (partial mesh, k-NN union),
then the largest cluster. ``VCNInference`` holds a net built from a state
dict on one device; ``VCNInference.from_cfg`` builds one from the SEE
config's VCN block and its reference checkpoint. Called with a padded
tensor, it is the SEE frame's step; ``complete_list`` is the reference's
list form over host clouds, which the SEE host pipeline calls.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import resolve_device, tf32_off
from ...ops.clustering import largest_cluster_batch
from ...ops.sampling import partial_mesh_batch
from ...utils.ckpt import load_vcn_checkpoint
from .nets import build_vcn


def resample_to_fixed(pts_list, n: int = 1024) -> np.ndarray:
    """Host side: list of (Ni, 3+) arrays -> (B, n, 3) float32, each cloud
    cyclically tiled to n rows and permuted by a fresh
    ``default_rng(0)`` (the reference's ResamplePoints); an empty cloud
    stays zeros."""
    out = np.zeros((len(pts_list), n, 3), dtype=np.float32)
    for i, p in enumerate(pts_list):
        p = np.asarray(p, dtype=np.float32)[:, :3]
        if len(p) == 0:
            continue
        reps = int(np.ceil(n / len(p)))
        tiled = np.tile(p, (reps, 1))[:n]
        out[i] = np.random.default_rng(0).permutation(tiled, axis=0)
    return out


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
    plus the partial-mesh ``sel_k`` and cluster ``eps`` of the SEE config;
    ``norm_with_gt`` (the net normalises by a box) and ``batch_size`` (the
    objects a forward takes) serve the list form."""

    def __init__(self, model_name: str, state_dict: dict, *,
                 num_points: int = 1024, sel_k: int = 30,
                 cluster_eps: float = 0.4, norm_with_gt: bool = False,
                 batch_size: int = 32, device="cuda"):
        self.device = resolve_device(device)
        self.num_points = num_points
        self.sel_k = sel_k
        self.cluster_eps = cluster_eps
        self.norm_with_gt = norm_with_gt
        self.batch_size = batch_size
        self.model = build_vcn(model_name, num_coarse=num_points)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    @classmethod
    def from_cfg(cls, cfg, *, device="cuda"):
        """From the reference SEE config's VCN block (MODEL, CKPT_PATH,
        NORM_WITH_GT, SEL_K_NEAREST, CLUSTER_EPS, BATCH_SIZE_LIMIT), reading
        the ``.pth`` at CKPT_PATH. BATCH_SIZE_LIMIT bounds the list form's
        forwards; the padded form runs its batch whole. NORM_WITH_GT asks
        the caller for boxes."""
        return cls(cfg.MODEL, load_vcn_checkpoint(cfg.CKPT_PATH, cfg.MODEL),
                   sel_k=int(cfg.get("SEL_K_NEAREST", 30)),
                   cluster_eps=float(cfg.get("CLUSTER_EPS", 0.4)),
                   norm_with_gt=bool(cfg.get("NORM_WITH_GT", False)),
                   batch_size=int(cfg.get("BATCH_SIZE_LIMIT", 32) or 32), device=device)

    def __call__(self, pc: torch.Tensor, gt: torch.Tensor | None = None):
        """(B, n, 3) -> (4, B, num_points, 3) [input, coarse, surface,
        clustered]."""
        return forward_chain(self.model, pc, gt, sel_k=self.sel_k,
                             eps=self.cluster_eps)

    def complete_list(self, pts_list, gtboxes=None) -> dict:
        """The reference's list form: (Ni, 3) numpy clouds -> dict of
        'input', 'coarse', 'surface', 'clustered', each (B, num_points, 3)
        numpy. Each cloud is ``resample_to_fixed``; the batch is padded with
        zero clouds to a multiple of ``batch_size`` and runs
        ``batch_size`` objects a forward on the device, with TF32 off. A
        NORM_WITH_GT net takes ``gtboxes`` (B, >=7), its padding rows boxes
        of dimension 1, as the reference pads them. One read back at the
        end."""
        b = len(pts_list)
        inp = resample_to_fixed(pts_list, self.num_points)
        pad = (-b) % self.batch_size
        if pad:
            inp = np.concatenate([inp, np.zeros((pad, self.num_points, 3), np.float32)])
        gt = None
        if self.norm_with_gt:
            if gtboxes is None:
                raise ValueError("a NORM_WITH_GT VCN needs the objects' boxes")
            gt = np.zeros((len(inp), 7), dtype=np.float32)
            gt[:b] = np.stack([np.asarray(g, dtype=np.float32)[:7] for g in gtboxes])
            gt[b:, 3:6] = 1.0
        tf32_off()
        chunks = []
        for s in range(0, len(inp), self.batch_size):
            chunk = torch.from_numpy(inp[s:s + self.batch_size]).to(self.device)
            gchunk = None if gt is None else torch.from_numpy(
                gt[s:s + self.batch_size]).to(self.device)
            chunks.append(forward_chain(self.model, chunk, gchunk, sel_k=self.sel_k,
                                        eps=self.cluster_eps))
        stacked = torch.cat(chunks, dim=1).cpu().numpy()          # (4, B + pad, n, 3)
        return {k: stacked[i, :b]
                for i, k in enumerate(("input", "coarse", "surface", "clustered"))}
