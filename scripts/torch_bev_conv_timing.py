#!/usr/bin/env python3
"""Time the port's BEV backbones on one NVIDIA card, whole and conv by conv,
and the 3x3 convs of their shapes alone in each route PyTorch offers.

    python3 scripts/torch_bev_conv_timing.py

For the multi-head SECONDNet (200 x 176 x 256 into BACKBONE_2D [5, 5] x
[128, 256]), the flagship SECOND-IoU (100 x 88 x 128) and PointPillar (496 x
432 x 64), at full width with weights from a seed: the backbone's eval
forward (CUDA events, median of 5) and each of its layers that takes over
0.5 ms; then single f32 3x3 convs (TF32 off) through cuDNN with an explicit
zero pad or conv padding, in NCHW and channels-last, through PyTorch's own
conv with cuDNN off, and through cuDNN with TF32 on (for reference only:
the port runs its convs in f32), each beside its bound at 67 TFLOP/s. It
needs a card; it prints the card's name and power limit first.
"""
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F


def time_cuda(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(times)


def backbones(dev) -> None:
    sys.path.insert(0, ".")
    from chip_smoke import seeded_state_dict
    from seevcn_torch.models.detectors import configs as DC
    from seevcn_torch.models.detectors.second import build_detector

    for name, cfg in (("multi-head SECONDNet", DC.second_multihead_detector_cfg()),
                      ("flagship SECOND-IoU", DC.flagship_detector_cfg()),
                      ("PointPillar", DC.pointpillar_detector_cfg())):
        model, dcfg = build_detector(cfg, device="cpu")
        model, dcfg = build_detector(cfg, seeded_state_dict(0, model), device=dev)
        bb = model.backbone_2d
        if hasattr(model, "backbone_3d"):
            nz, h, w = model.backbone_3d.encoded_shape(dcfg.sparse_shape)
            c = 128 * nz
        else:
            h, w, c = int(dcfg.grid_size[1]), int(dcfg.grid_size[0]), model.vfe.num_filters
        x = torch.randn(1, h, w, c, device=dev)
        with torch.no_grad():
            whole = time_cuda(lambda: bb(x))
            y, rows = x.permute(0, 3, 1, 2), []
            for bi, block in enumerate(bb.blocks):
                for li, layer in enumerate(block):
                    ms = time_cuda(lambda: layer(y), reps=3)
                    if ms > 0.5:
                        rows.append(f"blocks.{bi}.{li} ({type(layer).__name__}) {ms:.3f}")
                    y = layer(y)
        print(f"{name} BEV backbone at {h} x {w} x {c}: {whole:.3f} ms (CUDA events, "
              f"median of 5); layers over 0.5 ms: {', '.join(rows) or 'none'}", flush=True)


def convs(dev) -> None:
    for cin, cout, h, w in ((256, 128, 200, 176), (128, 128, 200, 176), (256, 128, 100, 88),
                            (512, 64, 200, 176), (384, 128, 200, 176)):
        x = torch.randn(1, cin, h, w, device=dev)
        wt = torch.randn(cout, cin, 3, 3, device=dev) * 0.05
        xl = x.contiguous(memory_format=torch.channels_last)
        xp = F.pad(x, (1, 1, 1, 1))
        with torch.no_grad():
            r = {"cuDNN, zero pad then conv": time_cuda(lambda: F.conv2d(xp, wt)),
                 "cuDNN, padding 1": time_cuda(lambda: F.conv2d(x, wt, padding=1)),
                 "cuDNN, channels-last": time_cuda(lambda: F.conv2d(xl, wt, padding=1))}
            torch.backends.cudnn.enabled = False
            r["cuDNN off"] = time_cuda(lambda: F.conv2d(x, wt, padding=1))
            torch.backends.cudnn.enabled = True
            torch.backends.cudnn.allow_tf32 = True
            r["cuDNN TF32 (reference only)"] = time_cuda(lambda: F.conv2d(x, wt, padding=1))
            torch.backends.cudnn.allow_tf32 = False
        flop = 2 * cin * cout * 9 * h * w
        print(f"f32 conv {cin}->{cout} 3x3 at {h} x {w} ({flop / 1e9:.1f} GFLOP, bound "
              f"{flop / 67e12 * 1e3:.3f} ms at 67 TFLOP/s), CUDA events, median of 5: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in r.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bev_conv_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          f"torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    backbones(dev)
    convs(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
