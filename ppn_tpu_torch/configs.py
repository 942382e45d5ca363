"""Configuration tree for the PyTorch port (a copy of ``ppn_tpu/configs/base.py``).

The port keeps its own copy instead of importing the JAX package: the two
packages share the channel layout, the thresholds, the training and data
fields and the named configs, and the tests hold them equal.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Class index 0 is always the "instance" pseudo-class (whole-person box).
MPII_KEYPOINT_NAMES: Tuple[str, ...] = (
    "instance",
    "head_top",
    "upper_neck",
    "thorax",
    "r_shoulder",
    "r_elbow",
    "r_wrist",
    "l_shoulder",
    "l_elbow",
    "l_wrist",
    "pelvis",
    "r_hip",
    "r_knee",
    "r_ankle",
    "l_hip",
    "l_knee",
    "l_ankle",
)

# Directed limb tree rooted at `instance`, topologically ordered so greedy
# person assembly (ops/parse.py) can walk it front-to-back. L = 16.
MPII_EDGES: Tuple[Tuple[int, int], ...] = (
    (0, 3),   # instance    -> thorax
    (3, 2),   # thorax      -> upper_neck
    (2, 1),   # upper_neck  -> head_top
    (3, 4),   # thorax      -> r_shoulder
    (4, 5),   # r_shoulder  -> r_elbow
    (5, 6),   # r_elbow     -> r_wrist
    (3, 7),   # thorax      -> l_shoulder
    (7, 8),   # l_shoulder  -> l_elbow
    (8, 9),   # l_elbow     -> l_wrist
    (3, 10),  # thorax      -> pelvis
    (10, 11), # pelvis      -> r_hip
    (11, 12), # r_hip       -> r_knee
    (12, 13), # r_knee      -> r_ankle
    (10, 14), # pelvis      -> l_hip
    (14, 15), # l_hip       -> l_knee
    (15, 16), # l_knee      -> l_ankle
)

# Left/right class-index pairs swapped on horizontal flip.
MPII_FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (4, 7), (5, 8), (6, 9), (11, 14), (12, 15), (13, 16),
)

COCO_KEYPOINT_NAMES: Tuple[str, ...] = (
    "instance",
    "nose",
    "l_eye",
    "r_eye",
    "l_ear",
    "r_ear",
    "l_shoulder",
    "r_shoulder",
    "l_elbow",
    "r_elbow",
    "l_wrist",
    "r_wrist",
    "l_hip",
    "r_hip",
    "l_knee",
    "r_knee",
    "l_ankle",
    "r_ankle",
)

COCO_EDGES: Tuple[Tuple[int, int], ...] = (
    (0, 1),   # instance -> nose
    (1, 2),   # nose -> l_eye
    (1, 3),   # nose -> r_eye
    (2, 4),   # l_eye -> l_ear
    (3, 5),   # r_eye -> r_ear
    (0, 6),   # instance -> l_shoulder
    (6, 8),   # l_shoulder -> l_elbow
    (8, 10),  # l_elbow -> l_wrist
    (0, 7),   # instance -> r_shoulder
    (7, 9),   # r_shoulder -> r_elbow
    (9, 11),  # r_elbow -> r_wrist
    (0, 12),  # instance -> l_hip
    (12, 14), # l_hip -> l_knee
    (14, 16), # l_knee -> l_ankle
    (0, 13),  # instance -> r_hip
    (13, 15), # r_hip -> r_knee
    (15, 17), # r_knee -> r_ankle
)

COCO_FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (12, 13), (14, 15), (16, 17),
)


@dataclasses.dataclass(frozen=True)
class PPNConfig:
    """Model/problem config: geometry, loss weights and post-process
    thresholds."""

    keypoint_names: Tuple[str, ...] = MPII_KEYPOINT_NAMES
    edges: Tuple[Tuple[int, int], ...] = MPII_EDGES
    flip_pairs: Tuple[Tuple[int, int], ...] = MPII_FLIP_PAIRS

    # Image / grid geometry. insize must be divisible by the backbone stride.
    insize: Tuple[int, int] = (384, 384)       # (H, W) network input
    outsize: Tuple[int, int] = (12, 12)        # (H', W') proposal grid
    local_grid_size: Tuple[int, int] = (9, 9)  # (H_l, W_l) limb search window

    # Box construction.
    instance_scale: float = 1.0
    parts_scale: float = 0.2

    # Loss weights.
    lambda_resp: float = 0.25
    lambda_iou: float = 1.0
    lambda_coor: float = 5.0
    lambda_size: float = 5.0
    lambda_limb: float = 0.5

    # Post-processing thresholds.
    detection_thresh: float = 0.15
    nms_thresh: float = 0.3
    min_num_keypoints: int = 2
    max_instances: int = 32   # static top-P person slots

    # Size channels: "sigmoid" keeps w,h in (0,1) of image size; "exp" is
    # the YOLOv2-style alternative.
    size_activation: str = "sigmoid"

    # Limb-loss masking ("paired" or "all"), read by the training slice.
    limb_loss_mode: str = "paired"

    backbone: str = "resnet18"

    # ---- derived ----
    @property
    def num_keypoints(self) -> int:
        """K — true keypoints, excluding the instance pseudo-class."""
        return len(self.keypoint_names) - 1

    @property
    def num_classes(self) -> int:
        """K+1 — keypoints + instance."""
        return len(self.keypoint_names)

    @property
    def num_limbs(self) -> int:
        return len(self.edges)

    @property
    def stride(self) -> Tuple[float, float]:
        """(sy, sx) pixels per grid cell."""
        return (self.insize[0] / self.outsize[0],
                self.insize[1] / self.outsize[1])

    @property
    def num_box_channels(self) -> int:
        return 6 * self.num_classes

    @property
    def num_limb_channels(self) -> int:
        hl, wl = self.local_grid_size
        return self.num_limbs * hl * wl

    @property
    def num_channels(self) -> int:
        """Head output channels: 6(K+1) + H_l·W_l·L."""
        return self.num_box_channels + self.num_limb_channels

    def __post_init__(self):
        if self.keypoint_names[0] != "instance":
            raise ValueError("class 0 must be the 'instance' pseudo-class")
        hl, wl = self.local_grid_size
        if hl % 2 == 0 or wl % 2 == 0:
            raise ValueError("local_grid_size must be odd")
        seen = {0}
        k1 = self.num_classes
        for s, d in self.edges:
            if not (0 <= s < k1 and 0 < d < k1):
                raise ValueError(
                    f"edge ({s},{d}) out of range for {k1} classes — "
                    "when overriding keypoint_names, override edges (and "
                    "flip_pairs) consistently")
            if s not in seen:
                raise ValueError(
                    f"edges must be topologically ordered from instance; "
                    f"edge ({s},{d}) has unseen source")
            seen.add(d)
        for a, b in self.flip_pairs:
            if not (0 < a < k1 and 0 < b < k1):
                raise ValueError(f"flip pair ({a},{b}) out of range")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization config."""

    batch_size: int = 32              # also the default eval batch bound
    learning_rate: float = 0.007
    momentum: float = 0.9
    weight_decay: float = 5e-4
    num_steps: int = 50_000
    warmup_steps: int = 500
    lr_schedule: str = "cosine"       # "cosine" | "constant" | "step"
    # EMA of params, used for eval/inference when > 0.
    ema_decay: float = 0.0
    seed: int = 0
    log_every: int = 50
    checkpoint_every: int = 1000
    eval_every: int = 2000
    checkpoint_dir: str = "/tmp/ppn_tpu_ckpt"
    resume: bool = True
    dtype: str = "bfloat16"           # compute dtype; params stay float32
    # The data-parallel mesh over the ranks of the torch.distributed world
    # (parallel/mesh.make_mesh): -1 absorbs the world size.
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    # SGD steps per call of the device-resident K-step loop
    # (train/steps.make_multi_train_step; needs the trainer's DeviceCache).
    steps_per_call: int = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths and augmentation ranges."""

    name: str = "mpii"                 # "mpii" | "coco" | "synthetic"
    root: str = "/data/mpii"
    annotations: str = ""              # path to annotation json
    train_split: str = "train"
    val_split: str = "val"
    max_persons: int = 12              # static GT slots per image
    augment: bool = True
    rotate_deg: float = 40.0
    scale_min: float = 0.7
    scale_max: float = 1.3
    translate_frac: float = 0.1
    hflip_prob: float = 0.5
    color_jitter: float = 0.2
    # Person-centric crop/zoom: with prob crop_prob, recenter the affine on
    # a random annotated person and zoom so its box max-dim covers a
    # uniform [crop_frac_min, crop_frac_max] fraction of the output.
    crop_prob: float = 0.5
    crop_frac_min: float = 0.35
    crop_frac_max: float = 0.95
    # PIL-ImageEnhance-style factors drawn from 1 ± jitter; 0 disables.
    saturation_jitter: float = 0.3
    sharpness_jitter: float = 0.5
    num_workers: int = 8
    prefetch: int = 4
    # images travel and are cached as uint8, normalized on the device
    transfer_uint8: bool = True
    # image dtype through the on-device augmentation (warp, color suite)
    augment_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class Config:
    model: PPNConfig = PPNConfig()
    train: TrainConfig = TrainConfig()
    data: DataConfig = DataConfig()
    name: str = "mpii_r18_384"


# ---------------------------------------------------------------------------
# Named configs.
# ---------------------------------------------------------------------------

def mpii_r18_384() -> Config:
    """MPII, ResNet-18, 384×384, 12×12 grid."""
    return Config(name="mpii_r18_384")


def coco_r18_384() -> Config:
    """COCO multi-person (K=17, L=17)."""
    return Config(
        name="coco_r18_384",
        model=PPNConfig(
            keypoint_names=COCO_KEYPOINT_NAMES,
            edges=COCO_EDGES,
            flip_pairs=COCO_FLIP_PAIRS,
        ),
        data=DataConfig(name="coco", root="/data/coco"),
    )


def coco_r18_384_crowded() -> Config:
    """Crowded-scene operating point: nms 0.6, det 0.02. Model shapes are
    identical to coco_r18_384, so snapshots interchange."""
    base = coco_r18_384()
    return dataclasses.replace(
        base, name="coco_r18_384_crowded",
        model=dataclasses.replace(base.model, detection_thresh=0.02,
                                  nms_thresh=0.6))


def mpii_r50_384() -> Config:
    """ResNet-50 bottleneck variant (the reference lineage ships
    resnet18/34/50 backbones — SURVEY.md §2.1 Backbone row)."""
    return Config(
        name="mpii_r50_384",
        model=PPNConfig(backbone="resnet50"),
    )


def mpii_r18_224_fast() -> Config:
    """Low-latency variant for the streaming-video path (BASELINE config #5)."""
    return Config(
        name="mpii_r18_224_fast",
        model=PPNConfig(insize=(224, 224), outsize=(7, 7)),
    )


def tiny_test() -> Config:
    """Small config for unit tests / CPU: 64×64 input, 2×2 grid, 3×3 window."""
    return Config(
        name="tiny_test",
        model=PPNConfig(insize=(64, 64), outsize=(2, 2), local_grid_size=(3, 3),
                        max_instances=4),
        train=TrainConfig(batch_size=2, num_steps=10, checkpoint_every=5),
        data=DataConfig(name="synthetic", max_persons=3),
    )


_REGISTRY = {
    "mpii_r18_384": mpii_r18_384,
    "mpii_r50_384": mpii_r50_384,
    "coco_r18_384": coco_r18_384,
    "coco_r18_384_crowded": coco_r18_384_crowded,
    "mpii_r18_224_fast": mpii_r18_224_fast,
    "tiny_test": tiny_test,
}


def mpii_hrw32_384() -> Config:
    """The flagship's head, grid and geometry on the HRNet-W32 trunk
    (``nn/hrnet.py``; Sun et al. CVPR 2019, Wang et al. TPAMI 2020)."""
    return Config(
        name="mpii_hrw32_384",
        model=PPNConfig(backbone="hrnet_w32"),
    )


# Named configs of the port alone: the JAX package has no HRNet, and
# _REGISTRY stays the JAX package's own list.
_PORT_REGISTRY = {
    "mpii_hrw32_384": mpii_hrw32_384,
}


def get_config(name: str, **overrides) -> Config:
    """Look up a named config; `overrides` apply to the top-level Config."""
    table = {**_REGISTRY, **_PORT_REGISTRY}
    if name not in table:
        raise KeyError(f"unknown config {name!r}; have {sorted(table)}")
    cfg = table[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def resolve_config(name: str, ini: str | None = None) -> Config:
    """Registry config, optionally overlaid with a reference-style
    config.ini (``ini_compat``) — the shared ``--config [--ini]``
    resolution of every CLI app."""
    if ini:
        from ppn_tpu_torch.ini_compat import load_ini

        return load_ini(ini, base=name)
    return get_config(name)
