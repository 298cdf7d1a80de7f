"""The benchmark's own operation counts against counts by hand: sparse-conv
pairs against a dense 3x3x3 count over the occupancy grid, and a tiny
detector's forward against its layers summed by hand."""
import itertools

import torch
import torch.nn.functional as F

from benchmark.roofline import detector as DF
from benchmark.roofline import sparse_pairs as SPP
from benchmark.roofline import vcn as VF


def _sites(seed=0, n=300, shape=(6, 10, 12)):
    g = torch.Generator().manual_seed(seed)
    key = torch.unique(torch.randint(0, shape[0] * shape[1] * shape[2], (n,), generator=g))
    z, r = key // (shape[1] * shape[2]), key % (shape[1] * shape[2])
    return torch.stack([z, r // shape[2], r % shape[2]], -1), shape


def test_subm_pairs_match_a_dense_count():
    sites, shape = _sites()
    occ = torch.zeros(shape)
    occ[tuple(sites.T)] = 1
    dense = F.conv3d(occ[None, None], torch.ones(1, 1, 3, 3, 3), padding=1)[0, 0]
    pairs, out, _ = SPP.conv_sites(sites, shape, (3, 3, 3), (1, 1, 1), (1, 1, 1), True)
    assert pairs == int(dense[tuple(sites.T)].sum())
    assert torch.equal(out, sites)


def test_strided_pairs_match_a_loop():
    sites, shape = _sites(1)
    pairs, out, oshape = SPP.conv_sites(sites, shape, (3, 3, 3), (2, 2, 2), (0, 1, 1), False)
    want, outs = 0, set()
    for z, y, x in sites.tolist():
        for kz, ky, kx in itertools.product(range(3), repeat=3):
            nz, ny, nx = z + 0 - kz, y + 1 - ky, x + 1 - kx
            if nz % 2 or ny % 2 or nx % 2:
                continue
            o = (nz // 2, ny // 2, nx // 2)
            if all(0 <= v < s for v, s in zip(o, oshape)):
                want += 1
                outs.add(o)
    assert pairs == want and len(outs) == out.shape[0]


def test_detector_flops_by_hand():
    det = {"CLASS_NAMES": ["Car"],
           "DATA_CONFIG": {"POINT_CLOUD_RANGE": [0, 0, 0, 4, 4, 2.8],
                           "POINT_FEATURE_ENCODING": {"used_feature_list": ["x", "y", "z"]},
                           "DATA_PROCESSOR": [{"NAME": "transform_points_to_voxels",
                                               "VOXEL_SIZE": [0.5, 0.5, 0.1],
                                               "MAX_NUMBER_OF_VOXELS": {"train": 100, "test": 100}}]},
           "MODEL": {"BACKBONE_3D": {"NAME": "VoxelBackBone8x", "DTYPE": "bfloat16"},
                     "BACKBONE_2D": {"LAYER_NUMS": [1], "LAYER_STRIDES": [1], "NUM_FILTERS": [4],
                                     "UPSAMPLE_STRIDES": [1], "NUM_UPSAMPLE_FILTERS": [6]},
                     "DENSE_HEAD": {"NAME": "AnchorHeadSingle", "NUM_DIR_BINS": 2,
                                    "ANCHOR_GENERATOR_CONFIG": [{"anchor_rotations": [0, 1.57],
                                                                 "anchor_sizes": [[4, 2, 1.6]]}]}}}
    pts = torch.tensor([[0.25, 0.25, 0.05], [0.75, 0.25, 0.05], [2.2, 3.1, 1.0]])
    got = DF.forward_flops(pts, torch.ones(3, dtype=torch.bool), det, train=False)
    # one isolated site and one pair of neighbours: the first subm conv (3 -> 16)
    # pairs each site with itself and the two neighbours with each other: 5 pairs
    assert got["active"][0] == 3
    sites, _ = SPP.voxel_sites(pts, torch.ones(3, dtype=torch.bool), [0, 0, 0, 4, 4, 2.8],
                               [0.5, 0.5, 0.1], 100)
    assert SPP.conv_sites(sites, (29, 8, 8), (3, 3, 3), (1, 1, 1), (1, 1, 1), True)[0] == 5
    bb = DF.backbone3d(pts, torch.ones(3, dtype=torch.bool), det, False)
    c, h, w = bb["bev"]
    hand = 2 * 9 * c * 4 * h * w + 2 * 9 * 4 * 4 * h * w + 2 * 4 * 6 * h * w \
        + 2 * 6 * (2 + 14 + 4) * h * w
    assert got["flops"]["float32"] == hand
    assert got["flops"]["bfloat16"] == bb["flops"]


def test_vcn_flops_by_hand():
    n = 8
    point = 3 * 128 + 128 * 256 + 512 * 512 + 512 * 1024
    dense = 1024 * 1024 * 2 + 1024 * 3 * 16
    assert VF.forward_flops("VCN_CN", 2, n, 16) == 2 * 2 * (n * point + dense)


def test_k1_pairs_match_a_brute_force_count():
    from benchmark.roofline import k1
    g = torch.Generator().manual_seed(3)
    a = torch.rand(2000, 3, generator=g) * torch.tensor([4.0, 2.0, 1.0])
    a[:50] = 1e9                                  # padding rows far from everything
    b = torch.rand(700, 3, generator=g) * torch.tensor([3.0, 2.0, 1.0]) + 0.5
    valid = torch.rand(700, generator=g) < 0.8
    for r in (0.05, 0.1, 0.3):
        d2 = ((a[:, None, :] - b[valid][None, :, :]) ** 2).sum(-1)
        assert k1.pairs_within(a, b, r, valid) == int((d2 <= r * r).sum())
    assert k1.pairs_within(a, b, 0.1, torch.zeros(700, dtype=torch.bool)) == 0
