"""Whole runs of the tiny cell on the CPU (the harness's look for a card
skipped): a sound run is correct, and a run whose timed path is broken
underneath, or the lower-precision control in the program's place, is
not.  The faults a serving cell on one card can have: an answer altered
where it is produced (scores or boxes in the forward, on every detection
or on half of them; labels in the postprocess) and half of the batch left
out (the other half's answers given in its place)."""

import time

import pytest
import torch

import tiny
from perfbench import calibrate, check, harness

SEED = 2**31 + 3


def run(seed=SEED):
    return harness.run_cell(tiny.cell(metrics=False), seed, 0.5, False, "cpu", time.perf_counter())


@pytest.fixture
def broken_forward(monkeypatch):
    """Installs ``fault(boxes, scores, labels) -> same`` after the exported
    program."""
    from codetr_torch.runtime import aot

    def install(fault):
        real = aot.compile_forward

        def compile_forward(*args, **kwargs):
            program, example = real(*args, **kwargs)
            return (lambda *a: fault(*program(*a))), example

        monkeypatch.setattr(aot, "compile_forward", compile_forward)

    return install


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks" and set(r["checks"]) == set(tiny.LIMITS)


def test_an_answer_altered_in_the_forward_is_caught(broken_forward):
    broken_forward(lambda b, s, l: (b, torch.cat([s[:1] * 0.7, s[1:]]), l))
    r = run()
    assert not r["correct"] and r["checks"]["fwd.nlogit_gap_med"]["value"] > tiny.LIMITS["fwd.nlogit_gap_med"]


def test_half_the_detections_scores_altered_are_caught(broken_forward):
    def fault(b, s, l):
        s = s.clone()
        s[:, ::2] = s[:, ::2].float().logit(eps=1e-7).add(1.0).sigmoid().to(s.dtype)
        return b, s, l

    broken_forward(fault)
    r = run()
    assert not r["correct"] and r["checks"]["fwd.nlogit_gap_p90"]["value"] > tiny.LIMITS["fwd.nlogit_gap_p90"]


def test_boxes_scaled_in_the_forward_are_caught(broken_forward):
    broken_forward(lambda b, s, l: (b * 1.3, s, l))
    r = run()
    assert not r["correct"] and r["checks"]["fwd.unmatched_share"]["value"] > tiny.LIMITS["fwd.unmatched_share"]


def test_boxes_shifted_in_the_forward_are_caught(broken_forward):
    """Shifted by 0.15 of their width: each still overlaps its query, at
    IoU ~0.74, and is matched, so the box gap is what catches it."""
    def fault(b, s, l):
        w = (b[..., 2] - b[..., 0])[..., None]
        return b + 0.15 * w * b.new_tensor([1.0, 0.0, 1.0, 0.0]), s, l

    broken_forward(fault)
    r = run()
    assert not r["correct"] and r["checks"]["fwd.box_gap_p90"]["value"] > tiny.LIMITS["fwd.box_gap_p90"]
    assert r["checks"]["fwd.unmatched_share"]["value"] <= tiny.LIMITS["fwd.unmatched_share"]


def test_half_the_batch_left_out_is_caught(broken_forward):
    broken_forward(lambda b, s, l: tuple(t[:1].expand_as(t).contiguous() for t in (b, s, l)))
    r = run()
    assert not r["correct"] and r["checks"]["fwd.nlogit_gap_med"]["value"] > tiny.LIMITS["fwd.nlogit_gap_med"]


def test_an_answer_altered_in_the_postprocess_is_caught(monkeypatch):
    from codetr_torch.inferencer import Inferencer

    real = Inferencer.postprocess

    def postprocess(self, *args):
        b, s, l, keep = real(self, *args)
        return b, s, (l + 1) % self.cfg.head.num_classes, keep

    monkeypatch.setattr(Inferencer, "postprocess", postprocess)
    r = run()
    assert not r["correct"] and r["checks"]["post.score_gap"]["value"] > tiny.LIMITS["post.score_gap"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(seed):
    """The float32 reference with float8 e4m3 GEMM operands and a bfloat16
    soft-NMS in the program's place."""
    ok, checks = check.judge(calibrate.control_readings(tiny.cell(metrics=False), seed, "cpu"), tiny.LIMITS)
    assert not ok, checks


def test_a_failed_request_is_counted_and_fails_the_run(monkeypatch):
    from codetr_torch.inferencer import Inferencer

    real, calls = Inferencer.__call__, []

    def call(self, images):
        calls.append(1)
        if len(calls) == 8:  # the first request after the warm-up's 4
            raise RuntimeError("planted")
        return real(self, images)

    monkeypatch.setattr(Inferencer, "__call__", call)
    r = run()
    assert r["failed"] == 1 and not r["correct"]
