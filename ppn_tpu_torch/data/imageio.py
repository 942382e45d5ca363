"""Image file loading for the dataset classes and the video directory source
(port of ``ppn_tpu/data/imageio.py``).

Every file decodes through PIL, whatever its format. The JAX package sends
JPEGs to its native libjpeg pool and falls back to PIL when that library
does not build; here the pool is not ported (ROADMAP.md queue 1 item 13),
so asking for it raises and nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_resized(path: str, out_hw: Tuple[int, int],
                 native_jpeg: bool = False):
    """path → ((H, W, 3) float32 in [0, 1] at ``out_hw``, W0, H0 the
    original size): PIL decode, RGB, bilinear resize. ``native_jpeg=True``
    (the native decode pool) raises ``NotImplementedError``."""
    if native_jpeg:
        raise NotImplementedError(
            "native_jpeg=True: the native JPEG decode pool is not ported "
            "(ROADMAP.md queue 1 item 13); files decode through PIL with "
            "native_jpeg=False")
    from PIL import Image

    Ht, Wt = out_hw
    with Image.open(path) as f:
        img = f.convert("RGB")
    W0, H0 = img.size
    img = img.resize((Wt, Ht), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0, W0, H0
