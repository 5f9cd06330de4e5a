"""Reading an image for the CLIs (``export_aot.py --image``,
``eval_coco.py``'s image directory).

``read_image(path)`` takes an ``.npy`` (H, W, 3) uint8 RGB array, or any
file OpenCV reads.  cv2 is imported only for the latter, through
``utils.visualize.import_cv2``: a machine without cv2 (and without PIL)
serves ``.npy`` images.
"""

from __future__ import annotations

import numpy as np

from codetr_torch.utils.visualize import import_cv2


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB from an ``.npy`` array or, through cv2, an image
    file."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        try:
            cv2 = import_cv2()
        except ImportError as e:
            raise ImportError(f"cannot read {path}: pass an .npy (H, W, 3) uint8 RGB array, or "
                              "install OpenCV (cv2) to read image files") from e
        bgr = cv2.imread(path)
        if bgr is None:
            raise ValueError(f"cv2 cannot read {path}")
        img = bgr[..., ::-1]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: expected an (H, W, 3) uint8 RGB image, got {img.shape} {img.dtype}")
    return np.ascontiguousarray(img)
