"""Detection drawing (a copy of the JAX package's ``utils/visualize.py``).

``draw_detections`` draws with OpenCV, imported when it is called: a
machine without ``cv2`` can serve and export, and only drawing raises
there.
"""

from __future__ import annotations

import colorsys

import numpy as np


def _palette(n: int):
    return [
        tuple(int(255 * c) for c in colorsys.hsv_to_rgb((i * 0.61803) % 1.0, 0.7, 0.95))
        for i in range(n)
    ]


def import_cv2():
    """``cv2``, or an ImportError that says what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("drawing detections and writing images need OpenCV (cv2), "
                          "which is not installed") from e
    return cv2


def draw_detections(image_rgb: np.ndarray, det, classes) -> np.ndarray:
    """A copy of ``image_rgb`` with each kept box, its class name and score."""
    cv2 = import_cv2()
    vis = np.ascontiguousarray(image_rgb).copy()
    colors = _palette(len(classes))
    for box, score, label, keep in zip(det.boxes, det.scores, det.labels, det.keep):
        if not keep:
            continue
        x1, y1, x2, y2 = (int(round(v)) for v in box)
        color = colors[int(label) % len(colors)]
        cv2.rectangle(vis, (x1, y1), (x2, y2), color, 2)
        name = classes[int(label)] if int(label) < len(classes) else str(int(label))
        text = f"{name} {float(score):.2f}"
        (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(vis, (x1, max(0, y1 - th - 4)), (x1 + tw, y1), color, -1)
        cv2.putText(vis, text, (x1, y1 - 3), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    return vis
