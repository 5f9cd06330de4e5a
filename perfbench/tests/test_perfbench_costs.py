"""Operations and bytes the roofline and MFU metrics divide by."""

import json
import os

from perfbench import costs
from tiny import ROOT


def config(name):
    with open(os.path.join(ROOT, "perfbench/configs", f"{name}.json")) as f:
        return json.load(f)


def test_k1_cost_at_swin_l_1280x1920_is_the_hand_count():
    cfg = config("swinl-bf16")
    levels = ((320, 480), (160, 240), (80, 120), (40, 60), (20, 30))  # strides 4..64
    assert costs.level_shapes(cfg, (1280, 1920)) == levels
    K = 153600 + 38400 + 9600 + 2400 + 600
    flops, nbytes = costs.k1_cost(cfg, (1280, 1920), 1)
    # per query: 8 heads x (5 levels x 4 points) taps x 4 corners x 32 channels x 2
    assert flops == K * 8 * 20 * 4 * 32 * 2 == 8_380_416_000
    # value and output bf16 (256 channels, 2 bytes), coordinates float32 [x | y | w] of 160 taps
    assert nbytes == K * 256 * 2 + K * 480 * 4 + K * 256 * 2 == 602_342_400
    assert costs.k1_cost(cfg, (1280, 1920), 4) == (4 * flops, 4 * nbytes)


def test_forward_flops_count_the_reference_not_the_program():
    import tiny

    cfg = tiny.config()
    total = costs.forward_flops(cfg, (64, 96))
    levels = costs.level_shapes(cfg, (64, 96))
    K = sum(h * w for h, w in levels)
    msda = 2 * costs.msda_flops(1, K, 4, 10, 8) + 2 * costs.msda_flops(1, 12, 4, 10, 8)
    assert total > msda > 0
    assert costs.forward_flops(cfg, (128, 192)) > 3 * total  # work grows with the canvas


def test_peaks_table():
    p = costs.peaks("NVIDIA H100 80GB HBM3")
    assert p["flops"]["bfloat16"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert costs.peaks("cpu") is None
