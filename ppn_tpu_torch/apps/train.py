"""Training CLI (port of ``ppn_tpu/apps/train.py``): the same flags and
defaults, plus ``--device``.

Examples:
    python -m ppn_tpu_torch.apps.train --config tiny_test --steps 200 \
        --overfit 8 --device cpu
    python -m ppn_tpu_torch.apps.train --config mpii_r18_384 --steps 1000
    # data parallel on N cards of one host: one rank per card
    torchrun --nproc_per_node N -m ppn_tpu_torch.apps.train \
        --config mpii_r18_384 --steps 1000

Under a launcher (torchrun, or any that sets ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``) every rank joins the process
group (``parallel.multihost.initialize``: NCCL on cards, gloo with
``--device cpu``), takes ``cuda:LOCAL_RANK``, and trains its slice of each
global batch of ``--batch-size`` rows over the mesh ``train.mesh_shape``;
rank 0 writes the checkpoints and logs. A launcher's world that cannot be
joined raises. ``--ini`` applies a reference-style config.ini over
``--config``; the other flags, and ``--set`` last, apply over that.

``--data mpii|coco`` trains on a dataset tree under ``--data-root`` (else
``data.root``): the MPII JSON conversion (``data/mpii.py``) or COCO's
``person_keypoints_*.json`` (``data/coco.py``), JPEGs decoded natively
(``native/``) and other files through PIL (``data/imageio.py``). A set that
fits is held on the card (``DeviceCache``, sharded over the data group), a
larger one streams through ``data/pipeline.py``; ``eval:`` is printed only
when the tree has a validation split:

    python -m ppn_tpu_torch.apps.train --config mpii_r18_384 --data mpii \
        --data-root /data/mpii --init-npz artifacts/mpii_hero_r5_ema_f16.npz

``--steps-per-call K`` with the device cache runs K steps per call of
``train/steps.make_multi_train_step`` over index blocks (the tail below K
step by step).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ppn_tpu_torch.configs import resolve_config


def _persons_arg(s: str):
    """--num-persons value: int, or 'LO-HI' crowding range."""
    if "-" in s[1:]:
        lo, hi = s[1:].split("-", 1)
        return (int(s[0] + lo), int(hi))
    return int(s)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a Pose Proposal Network")
    p.add_argument("--config", default="mpii_r18_384")
    p.add_argument("--ini", default=None, metavar="PATH",
                   help="reference-style config.ini applied over --config")
    p.add_argument("--data", default="synthetic",
                   choices=["synthetic", "mpii", "coco"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--overfit", type=int, default=None, metavar="N",
                   help="restrict training to N fixed samples")
    p.add_argument("--num-persons", type=_persons_arg, default=None,
                   help="synthetic data: fixed persons per image, 0 for "
                        "random 1..max_persons, or 'LO-HI' for a uniform "
                        "crowding range (e.g. 3-8)")
    p.add_argument("--train-size", type=int, default=1024,
                   help="synthetic data: number of distinct training images")
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--ema-decay", type=float, default=None,
                   help="EMA of params for eval/inference (e.g. 0.999); "
                        "0 disables (default from config)")
    p.add_argument("--backbone", default=None,
                   choices=["resnet18", "resnet34", "resnet50", "hrnet_w32"],
                   help="override the config's backbone")
    p.add_argument("--pretrained", default=None, metavar="PATH",
                   help="torchvision-format ResNet .pth to initialize the "
                        "backbone from (weights and BatchNorm statistics)")
    p.add_argument("--init-npz", default=None, metavar="PATH",
                   help="fine-tune from a committed inference snapshot "
                        "(.npz): params+BN loaded, optimizer/schedule fresh")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="PATH=VALUE",
                   help="generic dotted-path config override, applied after "
                        "all other flags (e.g. --set data.rotate_deg=20); "
                        "repeatable")
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="SGD steps per call of the K-step loop over the "
                        "device cache (train/steps.make_multi_train_step)")
    p.add_argument("--device-cache", choices=["auto", "on", "off"],
                   default="auto",
                   help="hold the whole dataset in device memory and sample "
                        "batches there. auto: on when the dataset fits "
                        "comfortably")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda, or "
                        "cuda:LOCAL_RANK under a launcher)")
    return p


def make_datasets(cfg, args):
    """Returns (train_dataset, val_dataset); val is None for a file tree
    without a validation split."""
    if args.data == "synthetic":
        from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset

        n = args.overfit or args.train_size
        np_ = args.num_persons
        if np_ == 0:       # 0 = random 1..max_persons crowding
            np_ = None
        train = SyntheticPoseDataset(cfg, size=n, seed=cfg.train.seed,
                                     cache=True, num_persons=np_)
        val = (train if args.overfit
               else SyntheticPoseDataset(cfg, size=128, seed=10_000,
                                         cache=True, num_persons=np_))
        return train, val
    if args.data == "mpii":
        from ppn_tpu_torch.data.mpii import make_mpii_datasets

        return make_mpii_datasets(cfg, args.data_root or cfg.data.root,
                                  overfit=args.overfit)
    if args.data == "coco":
        from ppn_tpu_torch.data.coco import make_coco_datasets

        return make_coco_datasets(cfg, args.data_root or cfg.data.root,
                                  overfit=args.overfit)
    raise ValueError(args.data)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = resolve_config(args.config, args.ini)

    updates = {}
    if args.steps is not None:
        updates["num_steps"] = args.steps
    if args.batch_size is not None:
        updates["batch_size"] = args.batch_size
    if args.lr is not None:
        updates["learning_rate"] = args.lr
    if args.seed is not None:
        updates["seed"] = args.seed
    if args.ckpt_dir is not None:
        updates["checkpoint_dir"] = args.ckpt_dir
    if args.no_resume:
        updates["resume"] = False
    if args.eval_every is not None:
        updates["eval_every"] = args.eval_every
    if args.ema_decay is not None:
        updates["ema_decay"] = args.ema_decay
    if args.steps_per_call is not None:
        updates["steps_per_call"] = args.steps_per_call
    if updates:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **updates))
    if args.backbone is not None:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, backbone=args.backbone))
    if args.overrides:
        from ppn_tpu_torch.overrides import apply_overrides

        cfg = apply_overrides(cfg, args.overrides)

    import torch

    from ppn_tpu_torch import resolve_device
    from ppn_tpu_torch.data.pipeline import infinite_batches
    from ppn_tpu_torch.parallel import make_mesh, shard_batch
    from ppn_tpu_torch.parallel.multihost import initialize, is_primary
    from ppn_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        if device.index is None:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    initialize(backend="nccl" if device.type == "cuda" else "gloo")
    mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes, device)
    train_ds, val_ds = make_datasets(cfg, args)
    Hc, Wc = cfg.model.insize
    px_bytes = 1 if cfg.data.transfer_uint8 else 4  # uint8 vs float32 cache
    est_bytes = len(train_ds) * Hc * Wc * 3 * px_bytes  # images dominate
    use_cache = (args.device_cache == "on"
                 or (args.device_cache == "auto" and est_bytes < 2 << 30))
    cache = None
    if use_cache:
        from ppn_tpu_torch.data.device_cache import DeviceCache

        cache = DeviceCache(train_ds, image_uint8=cfg.data.transfer_uint8,
                            device=device, mesh=mesh)
        if is_primary():
            print(f"device cache: {len(train_ds)} samples, "
                  f"{cache.nbytes() / 1e6:.0f} MB on {device} (per rank)")
        batches = cache.infinite_batches(cfg.train.batch_size,
                                         seed=cfg.train.seed)
    else:
        batches = (shard_batch(mesh, b) for b in infinite_batches(
            train_ds, cfg.train.batch_size, seed=cfg.train.seed,
            image_uint8=cfg.data.transfer_uint8))
    # --overfit memorizes fixed samples; augmentation would defeat that.
    augment = False if args.overfit else None
    trainer = Trainer(cfg, batches, val_dataset=val_ds, logdir=args.log_dir,
                      augment=augment, pretrained=args.pretrained,
                      device_cache=cache, init_npz=args.init_npz,
                      device=device, mesh=mesh)
    try:
        final = trainer.run()
        if not is_primary():
            return
        print("final:", {k: round(v, 4) for k, v in final.items()})
        if val_ds is not None:
            print("eval:", {k: round(v, 4)
                            for k, v in trainer.evaluate().items()})
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
