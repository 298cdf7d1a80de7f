"""The DA experiment's completion and evaluation on the card against the
port's CPU path (which tests/test_torch_da_experiment.py holds against the
JAX package). Every test here is marked ``cuda`` and skips without a card;
the file imports no JAX, so on a machine with a card and no JAX:
``python -m pytest tests/test_torch_da_card.py -m cuda --noconftest``.

- ``complete`` on a 2-frame 16-beam set (``generate_da_set(max_pts=4000)``)
  at seeded VCN_VC and VCN_CN weights, through the entry point on the card
  and with ``--cpu``: K1 launched once a frame on the card, ``valid`` equal,
  the scan rows equal, and each completed instance's unique rows within
  5e-5 m of the CPU's but for at most 2 rows a side within 0.1 m (the
  partial-mesh k-NN's f32 near ties, as against JAX).
- ``eval`` at ``--eval_batch`` 1 and 3 on the card (the tiny DA grid of the
  CPU test, seeded random weights): the same ``n_dets`` and APs.
"""
import numpy as np
import pytest
import torch

from chip_smoke import seeded_state_dict
from seevcn_torch.data.synth_da import generate_da_set
from seevcn_torch.experiments import da_experiment as DA
from seevcn_torch.ops import cuda as K
from seevcn_torch.testing import completed_rows_apart
from seevcn_torch.utils.ckpt import save_detector_checkpoint

COMPLETED_ATOL, STRAY_ROWS, STRAY_M = 5e-5, 2, 0.1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the replacement's kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["VCN_VC", "VCN_CN"])
def test_complete_on_card_matches_cpu(tmp_path, model, cuda_device):
    pts, val, gtb, gtm = generate_da_set(5, 2, 16, max_pts=4000)
    path = str(tmp_path / "set.npz")
    np.savez(path, points=pts, valid=val, gt_boxes=gtb, gt_mask=gtm)
    K.reset_launches()
    DA.main(["complete", "--set", path, "--model", model, "--out", str(tmp_path / "card.npz")])
    torch.cuda.synchronize()
    assert K.LAUNCHES["min_sqdist_pruned"] == 2
    DA.main(["complete", "--set", path, "--model", model, "--out", str(tmp_path / "cpu.npz"),
             "--cpu"])
    got, ref = np.load(tmp_path / "card.npz"), np.load(tmp_path / "cpu.npz")
    assert got["valid"][:, 4000:].any()
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["points"][:, :4000], ref["points"][:, :4000])
    rows = completed_rows_apart(*(x["points"][:, 4000:].reshape(2, 8, 1024, 3)
                                  for x in (got, ref)), COMPLETED_ATOL)
    assert rows["stray_rows_max"] <= STRAY_ROWS and rows["rows_apart_max"] <= STRAY_M, rows


@pytest.mark.cuda
def test_eval_batches_agree_on_card(tmp_path, monkeypatch, cuda_device):
    real = DA.da_detector_cfg

    def tiny(max_pts, mode="zfold"):
        c = real(max_pts, mode)
        c.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -6.4, -3, 12.8, 6.4, 1]
        c.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS = {"train": 2000, "test": 2000}
        return c

    monkeypatch.setattr(DA, "da_detector_cfg", tiny)
    rng = np.random.RandomState(7)
    n, p = 5, 800
    pts = np.stack([rng.uniform(0.5, 12.0, (n, p)), rng.uniform(-6.0, 6.0, (n, p)),
                    rng.uniform(-2.5, 0.5, (n, p))], -1).astype(np.float32)
    gtb = np.zeros((n, 2, 8), np.float32)
    gtb[..., 0], gtb[..., 1] = rng.uniform(3, 10, (n, 2)), rng.uniform(-4, 4, (n, 2))
    gtb[..., 2], gtb[..., 3:6], gtb[..., 7] = -1.0, [4.2, 1.9, 1.8], 1
    set_path = str(tmp_path / "set.npz")
    np.savez(set_path, points=pts, valid=np.ones((n, p), bool), gt_boxes=gtb,
             gt_mask=np.ones((n, 2), bool))
    model, _ = DA.build_detector(tiny(p), device="cpu")
    save_detector_checkpoint(str(tmp_path / "ckpt.pth"),
                             seeded_state_dict(0, model, random_stats=True))
    s = {b: DA.main(["eval", "--ckpt", str(tmp_path / "ckpt.pth"), "--set", set_path,
                     "--score_thresh", "0.0", "--eval_batch", str(b)]) for b in (1, 3)}
    assert s[1]["n_dets"] > 0 and s[1]["n_dets"] == s[3]["n_dets"]
    for k in ("ap_3d_07_r40", "ap_bev_07_r40"):
        assert s[1][k] == s[3][k]
