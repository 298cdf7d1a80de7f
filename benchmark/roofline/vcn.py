"""The operations of one VCN forward on ``objects`` objects of ``n``
points (pointwise Conv1d stacks and the FC decoders; an FMA as two), from
the published widths: PCN's encoder (3 -> 128 -> 256, the global feature
joined, 512 -> 512 -> 1024), the shape decoder (1024 -> 1024 -> 1024 ->
3 x num_coarse) and, in VCN_VC, the pose encoder (3 -> 64 -> 128 -> 1024)
and pose decoder (1024 -> 512 -> 9). f32."""
from __future__ import annotations

ENCODER = ((3, 128), (128, 256), (512, 512), (512, 1024))
POSE = ((3, 64), (64, 128), (128, 1024))


def forward_flops(model: str, objects: int, n: int, num_coarse: int) -> int:
    point = sum(a * b for a, b in ENCODER)
    dense = 1024 * 1024 + 1024 * 1024 + 1024 * 3 * num_coarse
    if model == "VCN_VC":
        point += sum(a * b for a, b in POSE)
        dense += 1024 * 512 + 512 * 9
    return 2 * objects * (n * point + dense)
