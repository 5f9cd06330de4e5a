"""The one traffic generator: a traffic file's parameters and a seed ->
the pool of images a run serves and the order it sends them in.

A traffic file (``perfbench/traffic/<name>.json``) holds:

- ``loop``: ``"closed"`` (each client sends its next request when the last
  one is answered); ``clients``: how many (1 today); ``batch``: images a
  request; ``canvas``: [height, width] the model serves at;
- ``pool``: images made a run; ``sizes``: their (height, width), either
  ``{"kind": "list", "hw": [[h, w], ...], "both_orientations": bool}``
  (each size, and its transpose, ``pool / len`` times) or ``{"kind":
  "long_side", "long": n, "aspect": [lo, hi]}`` (long side ``n``, aspect
  ratios at ``pool`` evenly spaced quantiles of a log-uniform law over
  [lo, hi], half of them landscape);
- ``trace_requests``: requests a ``--trace 1`` run profiles;
  ``check_requests``: requests the correctness check compares.

Every seed gets the same multiset of sizes, so the work of a run does not
depend on its seed; the seed draws the pixels and the order.  Pixels are
a blocky random field (16 px blocks) plus Gaussian noise, RGB uint8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class Pool:
    images: List[np.ndarray]  # (h, w, 3) RGB uint8
    order: np.ndarray  # image indices in sending order, one pass over the pool

    def request(self, k: int, batch: int) -> List[int]:
        """Pool indices of request ``k`` (cycling over ``order``)."""
        n = len(self.order)
        return [int(self.order[(k * batch + j) % n]) for j in range(batch)]

    def warmup(self, batch: int) -> List[int]:
        """The requests set-up sends: in sending order, those that bring an
        image size not sent before, and at least the first two (the first
        captures the postprocess graph, the second replays it)."""
        seen, out = set(), []
        for k in range(-(-len(self.order) // batch)):
            shapes = {self.images[i].shape for i in self.request(k, batch)}
            if len(out) < 2 or not shapes <= seen:
                out.append(k)
                seen |= shapes
        return out


def sizes(traffic: dict) -> List[Tuple[int, int]]:
    """The (height, width) of each of the pool's images, before shuffling."""
    spec, n = traffic["sizes"], traffic["pool"]
    if spec["kind"] == "list":
        hw = [tuple(s) for s in spec["hw"]]
        if spec.get("both_orientations"):
            hw += [(w, h) for h, w in hw]
        if n % len(hw):
            raise ValueError(f"a pool of {n} does not hold every one of {len(hw)} sizes alike")
        return hw * (n // len(hw))
    if spec["kind"] == "long_side":
        lo, hi = (np.log(a) for a in spec["aspect"])
        ratios = np.exp(lo + (hi - lo) * (np.arange(n) + 0.5) / n)  # width / height
        long = spec["long"]
        out = []
        for r in ratios:
            short = max(1, int(round(long / r if r >= 1 else long * r)))
            out.append((short, long) if r >= 1 else (long, short))
        return out
    raise ValueError(f"unknown sizes kind {spec['kind']!r}")


def make_pool(traffic: dict, seed: int) -> Pool:
    rng = np.random.default_rng(int(seed) & ((1 << 63) - 1))
    images = []
    for h, w in sizes(traffic):
        field = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float32)
        smooth = np.repeat(np.repeat(field, 16, 0), 16, 1)[:h, :w]
        noise = rng.normal(0.0, 24.0, (h, w, 3)).astype(np.float32)
        images.append(np.clip(smooth + noise, 0, 255).astype(np.uint8))
    return Pool(images, rng.permutation(len(images)))
