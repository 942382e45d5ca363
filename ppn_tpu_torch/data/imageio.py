"""Image file loading for the dataset classes (port of
``ppn_tpu/data/imageio.py``).

JPEG files go through the native libjpeg decode+resize
(``ppn_tpu_torch/native``), other formats through PIL, as in the JAX
package. The two resizes differ: the native one is half-pixel bilinear,
PIL's BILINEAR area-filters on a downscale. ``native_jpeg=False`` asks
for PIL on JPEGs too. Unlike the JAX package, nothing falls back to PIL
when the native library cannot be built: the native path raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_resized(path: str, out_hw: Tuple[int, int],
                 native_jpeg: bool = True):
    """path → ((H, W, 3) float32 in [0, 1] at ``out_hw``, W0, H0 the
    original size). A ``.jpg``/``.jpeg`` with ``native_jpeg`` decodes
    natively (the header gives W0, H0); anything else through PIL: RGB,
    bilinear resize."""
    Ht, Wt = out_hw
    if native_jpeg and path.lower().endswith((".jpg", ".jpeg")):
        from ppn_tpu_torch.native import loader as nl

        with open(path, "rb") as f:
            data = f.read()
        W0, H0 = nl.jpeg_dims(data)
        return nl.decode_resize(data, (Ht, Wt)), W0, H0
    from PIL import Image

    with Image.open(path) as f:
        img = f.convert("RGB")
    W0, H0 = img.size
    img = img.resize((Wt, Ht), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0, W0, H0
