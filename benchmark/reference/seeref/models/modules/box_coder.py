"""OpenPCDet's ResidualCoder (box_coder_utils.py): centre residuals over
the anchor's BEV diagonal (z over its height), log size ratios, the
heading residual."""
from __future__ import annotations

import torch


class ResidualCoder:
    """xyz / diagonal-normalised residuals, log size ratios, angle residual."""

    def __init__(self, code_size: int = 7, encode_angle_by_sincos: bool = False, **kw):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        """boxes (..., 7+C) ground truth, anchors (..., 7+C) -> (...,
        code_size); sizes clamped to >= 1e-5 first, as in the reference."""
        anchors = torch.cat([anchors[..., :3], anchors[..., 3:6].clamp_min(1e-5),
                             anchors[..., 6:]], dim=-1)
        boxes = torch.cat([boxes[..., :3], boxes[..., 3:6].clamp_min(1e-5),
                           boxes[..., 6:]], dim=-1)
        xa, ya, za, dxa, dya, dza, ra = (anchors[..., i] for i in range(7))
        xg, yg, zg, dxg, dyg, dzg, rg = (boxes[..., i] for i in range(7))
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        out = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
               torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)]
        if self.encode_angle_by_sincos:
            out += [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            out += [rg - ra]
        out += [boxes[..., 7 + i] - anchors[..., 7 + i]
                for i in range(boxes.shape[-1] - 7)]
        return torch.stack(out, dim=-1)

    def decode(self, encodings: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        xa, ya, za, dxa, dya, dza, ra = (anchors[..., i] for i in range(7))
        if self.encode_angle_by_sincos:
            xt, yt, zt, dxt, dyt, dzt, cost, sint = (encodings[..., i] for i in range(8))
        else:
            xt, yt, zt, dxt, dyt, dzt, rt = (encodings[..., i] for i in range(7))
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diag + xa
        yg = yt * diag + ya
        zg = zt * dza + za
        dxg = torch.exp(dxt) * dxa
        dyg = torch.exp(dyt) * dya
        dzg = torch.exp(dzt) * dza
        if self.encode_angle_by_sincos:
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
        else:
            rg = rt + ra
        rest = [encodings[..., self.code_size + i] + anchors[..., 7 + i]
                for i in range(anchors.shape[-1] - 7)]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg, *rest], dim=-1)


BOX_CODERS = {"ResidualCoder": ResidualCoder}


def build_box_coder(name: str, **kw):
    return BOX_CODERS[name](**kw)
