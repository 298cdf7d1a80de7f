"""Dataset bootstrap CLI: raw dataset tree -> infos pkls + gt-database (port
of seevcn_tpu/cli/create_infos.py).

Usage:
    python -m seevcn_torch.cli.create_infos --dataset kitti --root /data/kitti
    python -m seevcn_torch.cli.create_infos --dataset nuscenes --root /data/nus \
        --version v1.0-trainval --max_sweeps 10 [--val_scenes scenes.txt]
    python -m seevcn_torch.cli.create_infos --dataset lyft --root /data/lyft
    python -m seevcn_torch.cli.create_infos --dataset waymo --root /data/waymo \
        [--raw_data_tag raw_data] [--processed_data_tag waymo_processed_data]

Reference entry points it replaces:
  kitti:    python -m pcdet.datasets.kitti.kitti_dataset create_kitti_infos
            (kitti_dataset.py:430-521)
  nuscenes: python -m pcdet.datasets.nuscenes.nuscenes_dataset
            (nuscenes_dataset.py __main__, nuscenes_utils.py)
  lyft:     python -m pcdet.datasets.lyft.lyft_dataset (create_lyft_info)
  waymo:    python -m pcdet.datasets.waymo.waymo_dataset
            (waymo_dataset.py:403-476)

Waymo's raw TFRecords decode through the ``waymo_open_dataset`` SDK, as the
reference's do: without it a segment that has no processed ``.pkl`` yet
raises ImportError; a processed tree (``process_single_sequence(frames=
...)``'s output) resumes without it. Host numpy only; no device work.
"""
from __future__ import annotations

import argparse
import os


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
    one was written; for waymo {"infos": the merged infos (a list), and
    "dbinfos"}."""
    args = parse_args(argv)
    if args.dataset == "kitti":
        from ..data.kitti.bootstrap import create_groundtruth_database, create_kitti_infos

        paths = create_kitti_infos(args.root, save_path=args.save_path,
                                   splits=tuple(args.splits), with_test=args.with_test,
                                   num_workers=args.workers)
        if not args.no_gt_database and "train" in paths:
            paths["dbinfos"] = create_groundtruth_database(
                args.root, info_path=paths["train"], used_classes=args.classes,
                split="train")
    elif args.dataset == "nuscenes":
        from ..data.nuscenes_bootstrap import (create_nuscenes_groundtruth_database,
                                               create_nuscenes_infos)

        val_names = None
        if args.val_scenes:
            with open(args.val_scenes) as f:
                val_names = [x.strip() for x in f if x.strip()]
        paths = create_nuscenes_infos(args.root, version=args.version,
                                      max_sweeps=args.max_sweeps,
                                      val_scene_names=val_names, save_path=args.save_path)
        if not args.no_gt_database and "train" in paths:
            paths["dbinfos"] = create_nuscenes_groundtruth_database(
                args.root, paths["train"], used_classes=args.classes,
                max_sweeps=args.max_sweeps)
    elif args.dataset == "lyft":
        from ..data.lyft_bootstrap import (create_lyft_groundtruth_database,
                                           create_lyft_infos)

        version = args.version if args.version != "v1.0-trainval" else "trainval"
        paths = create_lyft_infos(args.root, version=version, max_sweeps=args.max_sweeps,
                                  save_path=args.save_path)
        if not args.no_gt_database and "train" in paths:
            paths["dbinfos"] = create_lyft_groundtruth_database(
                args.root, version, paths["train"], used_classes=args.classes)
    else:  # waymo
        from ..data.waymo_bootstrap import (create_waymo_groundtruth_database,
                                            create_waymo_infos)

        processed = os.path.join(args.save_path or args.root, args.processed_data_tag)
        paths = {"infos": create_waymo_infos(os.path.join(args.root, args.raw_data_tag),
                                             processed,
                                             sampled_interval=args.sampled_interval,
                                             num_workers=args.workers)}
        if not args.no_gt_database:
            paths["dbinfos"] = create_waymo_groundtruth_database(
                processed, save_path=args.save_path or args.root,
                used_classes=tuple(args.classes) if args.classes else
                ("Vehicle", "Pedestrian", "Cyclist"),
                sampled_interval=args.db_sampled_interval,
                processed_data_tag=args.processed_data_tag)
    return paths


if __name__ == "__main__":
    main()
