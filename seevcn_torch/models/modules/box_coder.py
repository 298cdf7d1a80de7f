"""ResidualCoder decode (port of seevcn_tpu/models/modules/box_coder.py;
reference box_coder_utils.py:5-79)."""
from __future__ import annotations

import torch


class ResidualCoder:
    """xyz / diagonal-normalised residuals, log size ratios, angle residual."""

    def __init__(self, code_size: int = 7, encode_angle_by_sincos: bool = False, **kw):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

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
