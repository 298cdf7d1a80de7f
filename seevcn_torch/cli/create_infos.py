"""Dataset bootstrap CLI: raw dataset tree -> infos pkls + gt-database (port
of seevcn_tpu/cli/create_infos.py).

Usage:
    python -m seevcn_torch.cli.create_infos --dataset kitti --root /data/kitti

The reference entry point it replaces for KITTI is
``python -m pcdet.datasets.kitti.kitti_dataset create_kitti_infos``
(kitti_dataset.py:430-521). The nuScenes, Lyft and Waymo branches keep
their flags and raise: their bootstraps are not ported yet (ROADMAP queue
1, item 4). Host numpy only; no device work.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True,
                    choices=["kitti", "nuscenes", "waymo", "lyft"])
    ap.add_argument("--root", required=True, help="dataset root path")
    ap.add_argument("--save_path", default=None, help="output dir (default: root)")
    ap.add_argument("--splits", nargs="+", default=["train", "val"])
    ap.add_argument("--with_test", action="store_true")
    ap.add_argument("--no_gt_database", action="store_true")
    ap.add_argument("--classes", nargs="+", default=None,
                    help="classes kept in the gt database")
    ap.add_argument("--workers", type=int, default=4)
    # nuscenes / lyft
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--max_sweeps", type=int, default=10)
    ap.add_argument("--val_scenes", default=None,
                    help="file with one val scene name per line")
    # waymo
    ap.add_argument("--raw_data_tag", default="raw_data")
    ap.add_argument("--processed_data_tag", default="waymo_processed_data")
    ap.add_argument("--sampled_interval", type=int, default=1)
    ap.add_argument("--db_sampled_interval", type=int, default=10)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """-> {split: infos path}, with "dbinfos" the gt database's pkl when
    one was written."""
    args = parse_args(argv)
    if args.dataset != "kitti":
        raise NotImplementedError(
            f"create_infos --dataset {args.dataset}: the {args.dataset} bootstrap is not "
            "ported yet (ROADMAP queue 1, item 4); the port has kitti")
    from ..data.kitti.bootstrap import create_groundtruth_database, create_kitti_infos

    paths = create_kitti_infos(args.root, save_path=args.save_path,
                               splits=tuple(args.splits), with_test=args.with_test,
                               num_workers=args.workers)
    if not args.no_gt_database and "train" in paths:
        paths["dbinfos"] = create_groundtruth_database(
            args.root, info_path=paths["train"], used_classes=args.classes, split="train")
    return paths


if __name__ == "__main__":
    main()
