"""The plain float32 reference against the port, at the tiny size on the
CPU, through the benchmark's own weights (no JAX anywhere)."""

import numpy as np
import pytest
import torch

import tiny
from perfbench import check, harness, system, weights
from perfbench.reference import pipeline

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def models():
    from codetr_torch.models.codetr import CoDETR

    torch.manual_seed(0)
    cfg = tiny.config()
    sd = weights.make_state_dict(cfg, SEED, "cpu")
    port = CoDETR(system.port_config(cfg))
    port.load_state_dict(sd, strict=True)
    return cfg, port.eval(), harness.reference_model(cfg, SEED, "cpu")


def test_weights_are_one_state_dict_per_seed_that_both_sides_load():
    cfg = tiny.config()
    a, b, c = (weights.make_state_dict(cfg, s, "cpu") for s in (SEED, SEED, SEED + 1))
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.patch_embed.projection.weight"], c["backbone.patch_embed.projection.weight"])
    q = a["query_head.transformer.query_embed.weight"]
    assert torch.equal(q, q[:1].expand_as(q))  # one content query shared by all
    assert all(v.dtype == torch.float32 for v in a.values())


def test_reference_forward_matches_the_port_in_float32(models):
    cfg, port, ref = models
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 64, 96, 3)).astype(np.float32))
    m = torch.zeros(2, 64, 96)
    m[0, 40:] = 1
    m[1, :, 70:] = 1
    with torch.no_grad():
        pb, ps, pl = port(x, m)
        rb, rs, rl = ref(x, m)
    assert torch.equal(pl, rl)
    assert (ps - rs).abs().max() < 1e-5
    assert (pb - rb).abs().max() < 1e-3  # px, 96 wide


def test_reference_preprocess_and_postprocess_match_the_port(models):
    from codetr_torch.ops.nms import postprocess_detections
    from codetr_torch.utils.preprocess import preprocess

    cfg = tiny.config()
    img = np.random.default_rng(4).integers(0, 256, (70, 51, 3), np.uint8)
    px, pm, psf, _ = preprocess(img, 64, 96, system.port_config(cfg).preprocess, device="cpu")
    rx, rm, rsf = pipeline.preprocess(img, 64, 96, cfg["preprocess"]["mean"], cfg["preprocess"]["std"], "cpu")
    assert psf == rsf and torch.equal(px, rx[0]) and torch.equal(pm, rm[0])

    rng = np.random.default_rng(5)
    boxes = torch.from_numpy(np.sort(rng.uniform(0, 90, (8, 4)), -1).astype(np.float32)[:, [0, 1, 2, 3]])
    boxes = torch.cat([boxes[:, :2], boxes[:, :2] + torch.from_numpy(rng.uniform(5, 30, (8, 2)).astype(np.float32))], 1)
    scores = torch.from_numpy(rng.uniform(0, 1, 8).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 2, 8))
    head = cfg["head"]
    want = postprocess_detections(boxes[None], scores[None], labels[None], score_threshold=0.0,
                                  iou_threshold=head["nms_iou_threshold"], nms_type="soft_nms",
                                  nms_sigma=0.5, nms_min_score=head["nms_min_score"],
                                  scale_factor=torch.tensor([[[0.5, 0.25, 0.5, 0.25]]]))
    got = pipeline.postprocess(boxes, scores, labels, (0.5, 0.25), cfg)
    for w, g in zip(want, got):
        assert torch.equal(w[0], g)


def test_readings():
    rng = np.random.default_rng(6)
    xy = rng.uniform(0, 50, (6, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (6, 2)).astype(np.float32)], 1)
    scores = rng.uniform(0.05, 0.9, (6, 3)).astype(np.float32)  # 6 queries x 3 classes
    labels = np.array([0, 2, 1])
    prog = (boxes[[4, 1, 3]], scores[[4, 1, 3], labels], labels)
    assert check.forward_readings(prog, (boxes, scores)) == {
        "fwd.unmatched_share": 0.0, "fwd.nlogit_gap_med": 0.0, "fwd.nlogit_gap_p90": 0.0, "fwd.box_gap_p90": 0.0}
    spread = check.logit(scores).std()
    off = (prog[0], 1 / (1 + np.exp(-(check.logit(prog[1]) + 0.1))), labels)  # every logit 0.1 up
    got = check.forward_readings(off, (boxes, scores))
    assert got["fwd.nlogit_gap_med"] == pytest.approx(0.1 / spread) == got["fwd.nlogit_gap_p90"]
    far = (prog[0] + 500, prog[1], labels)  # no query overlaps
    assert check.forward_readings(far, (boxes, scores)) == {
        "fwd.unmatched_share": 1.0, "fwd.nlogit_gap_med": float("inf"), "fwd.nlogit_gap_p90": float("inf"),
        "fwd.box_gap_p90": 1.0}
    one_far = (prog[0] + np.array([[500.0], [0], [0]], np.float32), prog[1], labels)  # 1 of 3 unmatched
    got = check.forward_readings(one_far, (boxes, scores))
    assert got["fwd.unmatched_share"] == pytest.approx(1 / 3) and got["fwd.nlogit_gap_med"] == 0.0
    assert got["fwd.nlogit_gap_p90"] == float("inf")  # an unmatched detection is an infinite gap
    moved = prog[0] + np.array([1.0, 0, 1.0, 0], np.float32)  # every box 1 px right
    got = check.forward_readings((moved, prog[1], labels), (boxes, scores))
    widths = prog[0][:, 2] - prog[0][:, 0]
    assert got["fwd.box_gap_p90"] == pytest.approx((1 / widths).max()) and got["fwd.unmatched_share"] == 0.0

    b, s, l = boxes[:5], scores[:5, 0], np.array([0, 1, 1, 2, 0])
    keep = np.array([True, True, False, True, False])
    assert check.post_readings((b, s, l, keep), (b, s, l, keep)) == {"post.score_gap": 0.0, "post.box_gap": 0.0}
    l2 = l.copy()
    l2[0] = 2
    assert check.post_readings((b, s, l2, keep), (b, s, l, keep))["post.score_gap"] == pytest.approx(s[0])
    assert check.post_readings((b + 0.5, s, l, keep), (b, s, l, keep))["post.box_gap"] == pytest.approx(0.5)
