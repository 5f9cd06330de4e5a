"""The MSDA CUDA kernels (forward and backward, each through its packed,
reference-layout and q-minor entries) against their plain PyTorch versions,
and the tiny Swin and narrow R50 models against the CPU, on the card.

The kernels have no CPU mode, so these tests are marked ``gpu`` and skip
where there is no card.  This file imports neither JAX nor the JAX package
(the machine with the card has no JAX), so run it there without the suite's
JAX conftest, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

It also holds the input makers and tolerance checks that the CPU parity
tests (``test_torch_port_msda.py``) share.
"""

import contextlib

import numpy as np
import pytest
import torch

from codetr_torch.ops import msda as port_msda

from torch_eval_truth import EVAL_SIZES, ground_truth, write_annotations

# ceil-div, non-square pyramids with widths that are not multiples of 8
SHAPES = [
    ((19, 13), (10, 7), (5, 4)),
    ((6, 10), (3, 5)),
    ((9, 13), (5, 7), (3, 4), (2, 2), (1, 1)),
]


def make_inputs(rng, shapes, num_queries=None, h=4, d=8, P=3):
    """value (1, K, h, d); loc (1, Q, h, L, P, 2); w (1, Q, h, L, P), all
    float32.  Locations mix in-level jitter, far-out taps (up to two level
    widths beyond the border) and exact-integer pixel taps."""
    K = sum(hh * ww for hh, ww in shapes)
    Q = K if num_queries is None else num_queries
    L = len(shapes)
    value = rng.standard_normal((1, K, h, d)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (1, Q, h, L, P, 2))
    far = rng.random((1, Q, h, L, P)) < 0.1
    loc[far] = rng.uniform(-2.0, 3.0, (int(far.sum()), 2))
    exact = rng.random((1, Q, h, L, P)) < 0.2
    for lvl, (hh, ww) in enumerate(shapes):
        sel = exact[..., lvl, :]
        n = int(sel.sum())
        # pixel = loc * size - 0.5 lands exactly on an integer in [-1, size]
        loc[..., lvl, :, 0][sel] = (rng.integers(-1, ww + 1, n) + 0.5) / ww
        loc[..., lvl, :, 1][sel] = (rng.integers(-1, hh + 1, n) + 0.5) / hh
    w = rng.uniform(0, 1, (1, Q, h, L, P))
    w = w / w.sum(axis=(-1, -2), keepdims=True)
    return value, loc.astype(np.float32), w.astype(np.float32)


def pack(loc, w, pad_to=None):
    """(1, K, h, L, P, 2), (1, K, h, L, P) -> packed (1, K, C)."""
    bs, K = w.shape[:2]
    cpk = np.concatenate(
        [loc[..., 0].reshape(bs, K, -1), loc[..., 1].reshape(bs, K, -1), w.reshape(bs, K, -1)],
        axis=-1,
    )
    if pad_to is not None:
        cpk = np.pad(cpk, ((0, 0), (0, 0), (0, pad_to - cpk.shape[-1])))
    return np.ascontiguousarray(cpk, np.float32)


def assert_within_bf16_rounding(got: torch.Tensor, want: torch.Tensor) -> None:
    """A bf16 result accumulated in fp32 differs from the fp32 result of the
    same bf16 inputs only by its final rounding: half a bf16 ulp, at most
    2^-8 relative.  Allow one ulp (2^-7) for sums that straddle a rounding
    step, plus fp32 noise."""
    want = want.float()
    scale = max(want.abs().max().item(), 1.0)
    bound = want.abs() * 2.0**-7 + 1e-5 * scale
    excess = ((got.float() - want).abs() - bound).max().item()
    assert excess <= 0, f"bf16 result off by {excess:.2e} beyond its rounding bound"


def assert_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max() / scale
    assert err < rtol, f"max err {err:.2e} relative to scale {scale:.2e}"


@contextlib.contextmanager
def kept_tf32_flags():
    """The process's (matmul, cuDNN) TF32 flags as they were on entry, put
    back on exit whatever the body set."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        yield saved
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture
def cuda_device():
    """The card, with the process's TF32 flags left as the test found them:
    the port's fp32 entry points pin full fp32 themselves, and whatever a
    test sets is undone after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the MSDA kernel has no CPU mode")
    with kept_tf32_flags():
        yield torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    """Both entry points of the kernel against the plain version on the card,
    at the flagship's head width (h=8, d=32, P=4): fp32 to 1e-5 of the
    output's scale; bf16 values within the output's bf16 rounding."""
    for i, shapes in enumerate(SHAPES):
        value, loc, w = make_inputs(np.random.default_rng(20 + i), shapes, h=8, d=32, P=4)
        v = torch.from_numpy(value).to(cuda_device, dtype)
        loc_t, w_t = torch.from_numpy(loc).to(cuda_device), torch.from_numpy(w).to(cuda_device)
        cpk = torch.from_numpy(pack(loc, w)).to(cuda_device)
        before = port_msda.launches
        got_p = port_msda.msda_grid_packed(v, shapes, cpk, 4)
        got_r = port_msda.multi_scale_deformable_attention(v, shapes, loc_t, w_t)
        torch.cuda.synchronize()
        assert port_msda.launches == before + 2
        want = port_msda.multi_scale_deformable_attention_plain(v.float(), shapes, loc_t, w_t)
        for got in (got_p, got_r):
            assert got.dtype == dtype
            if dtype == torch.float32:
                assert_close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
            else:
                assert_within_bf16_rounding(got, want)


def assert_grads_match_plain(got, want, bf16_value: bool) -> None:
    """Kernel gradients (grad_value, grad_x, grad_y, grad_w) against the
    plain backward on the same values: coordinate and weight gradients to
    1e-5 of their scale (fp32 reassociation); grad_value to 1e-5 of its
    scale in fp32 (atomics add in another order), and for a bf16 value
    within its own bf16 rounding."""
    for name, g, w in zip(("grad_value", "grad_x", "grad_y", "grad_w"), got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert torch.isfinite(g).all(), name
        if name == "grad_value" and bf16_value:
            assert g.dtype == torch.bfloat16
            assert_within_bf16_rounding(g, w)
        else:
            err = (g.float() - w.float()).abs().max() / w.float().abs().max()
            assert err < 1e-5, f"{name}: max err {err:.2e} of its scale"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain(cuda_device, dtype):
    """The backward kernel through both entry points' autograd against the
    plain backward on the card, at the flagship's head width."""
    for i, shapes in enumerate(SHAPES):
        rng = np.random.default_rng(30 + i)
        value, loc, w = make_inputs(rng, shapes, h=8, d=32, P=4)
        g = torch.from_numpy(rng.standard_normal((1, loc.shape[1], 8 * 32)).astype(np.float32))
        g = g.to(cuda_device, dtype)
        v = torch.from_numpy(value).to(cuda_device, dtype)
        loc_t, w_t = torch.from_numpy(loc).to(cuda_device), torch.from_numpy(w).to(cuda_device)
        want = port_msda.msda_backward_plain(
            v.float(), shapes, loc_t[..., 0], loc_t[..., 1], w_t, g.float())

        before = port_msda.launches_bwd
        vp = v.clone().requires_grad_()
        cpk = torch.from_numpy(pack(loc, w)).to(cuda_device).requires_grad_()
        port_msda.msda_grid_packed(vp, shapes, cpk, 4).backward(g)
        HLP = w.size // w.shape[0] // w.shape[1]
        gx, gy, gw = (cpk.grad[..., j * HLP:(j + 1) * HLP].reshape(w_t.shape) for j in range(3))
        vr = v.clone().requires_grad_()
        lr, wr = loc_t.clone().requires_grad_(), w_t.clone().requires_grad_()
        port_msda.multi_scale_deformable_attention(vr, shapes, lr, wr).backward(g)
        torch.cuda.synchronize()
        assert port_msda.launches_bwd == before + 2
        bf16 = dtype == torch.bfloat16
        assert_grads_match_plain((vp.grad, gx, gy, gw), want, bf16)
        assert_grads_match_plain((vr.grad, lr.grad[..., 0], lr.grad[..., 1], wr.grad), want, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("grid_queries", [True, False])
def test_msda_module_gradient_reaches_the_kernel(cuda_device, grid_queries):
    """A CUDA module whose parameters need gradients launches the backward
    kernel once per call, and its parameter gradients match the same module
    on the CPU (1e-5 of each gradient's scale)."""
    from codetr_torch.config import MSDAConfig
    from codetr_torch.models.msda_module import MultiScaleDeformableAttention

    shapes = SHAPES[0]
    L, E = len(shapes), 64
    K = sum(hh * ww for hh, ww in shapes)
    torch.manual_seed(0)
    cpu = MultiScaleDeformableAttention(
        MSDAConfig(embed_dims=E, num_heads=2, num_levels=L, num_points=4), grid_queries)
    gpu = MultiScaleDeformableAttention(cpu.cfg, grid_queries).to(cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(7)
    nq = K if grid_queries else 29
    query = torch.from_numpy(rng.standard_normal((1, nq, E)).astype(np.float32))
    value = query if grid_queries else torch.from_numpy(rng.standard_normal((1, K, E)).astype(np.float32))
    ref = torch.from_numpy(rng.uniform(0.1, 0.9, (1, nq, L, 2 if grid_queries else 4)).astype(np.float32))
    mask = torch.zeros(1, K, dtype=torch.bool)
    mask[0, -5:] = True
    for mod, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        before = port_msda.launches_bwd
        out = mod(query.to(dev), value.to(dev), None, mask.to(dev), ref.to(dev), shapes)
        out.square().sum().backward()
        assert port_msda.launches_bwd - before == (0 if dev == "cpu" else 1)
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        assert_close(pg.grad.cpu().numpy(), pc.grad.numpy(), rtol=1e-5)


@pytest.mark.gpu
def test_tiny_model_on_card_matches_cpu(cuda_device):
    """The whole tiny model through the kernel on the card against the same
    weights through the plain version on the CPU (scores 2e-4, boxes 0.1 px
    at 128x128)."""
    from codetr_torch import build_codetr, tiny_test_config

    cfg = tiny_test_config()
    cpu = build_codetr(cfg, device="cpu", seed=3)
    gpu = build_codetr(cfg, device=cuda_device, seed=3)
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.standard_normal((1, 128, 128, 3)).astype(np.float32))
    mask = torch.zeros(1, 128, 128)
    mask[:, 100:] = 1.0
    before = port_msda.launches
    with torch.no_grad():
        c_boxes, c_scores, c_labels = cpu(img, mask)
        g_boxes, g_scores, g_labels = gpu(img.to(cuda_device), mask.to(cuda_device))
    assert port_msda.launches - before == 4  # 2 encoder + 2 decoder layers
    torch.testing.assert_close(g_scores.cpu(), c_scores, rtol=0, atol=2e-4)
    torch.testing.assert_close(g_boxes.cpu(), c_boxes, rtol=0, atol=0.1)
    assert torch.equal(g_labels.cpu(), c_labels)


def batch_of_two(seed, shapes):
    """``make_inputs`` at the flagship's head width, two draws stacked on
    the batch axis (so the kernels' batch strides are exercised)."""
    draws = [make_inputs(np.random.default_rng(seed + i), shapes, h=8, d=32, P=4) for i in range(2)]
    return tuple(np.concatenate(a, 0) for a in zip(*draws))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_qm_kernel_and_batch_strides_match_plain(cuda_device, dtype):
    """Batch 2 through all three forward entries (packed, reference layout,
    q-minor) and the q-minor backward, against the plain versions on the
    card: fp32 to 1e-5 of scale, bf16 within its rounding; the q-minor
    forward counts in ``launches_qm`` and not in ``launches``."""
    for i, shapes in enumerate(SHAPES):
        value, loc, w = batch_of_two(40 + 2 * i, shapes)
        v = torch.from_numpy(value).to(cuda_device, dtype)
        loc_t, w_t = torch.from_numpy(loc).to(cuda_device), torch.from_numpy(w).to(cuda_device)
        cpk = torch.from_numpy(pack(loc, w)).to(cuda_device)
        qm = [a.permute(0, 2, 3, 4, 1).contiguous() for a in (loc_t[..., 0], loc_t[..., 1], w_t)]
        before, before_qm = port_msda.launches, port_msda.launches_qm
        outs = (port_msda.msda_grid_packed(v, shapes, cpk, 4),
                port_msda.multi_scale_deformable_attention(v, shapes, loc_t, w_t),
                port_msda.msda_grid_qm(v, shapes, *qm),
                port_msda.multi_scale_deformable_attention(v, shapes, loc_t, w_t, grid_queries=True))
        torch.cuda.synchronize()
        assert (port_msda.launches - before, port_msda.launches_qm - before_qm) == (2, 2)
        want = port_msda.multi_scale_deformable_attention_plain(v.float(), shapes, loc_t, w_t)
        for got in outs:
            assert got.dtype == dtype
            if dtype == torch.float32:
                assert_close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
            else:
                assert_within_bf16_rounding(got, want)

        g = torch.from_numpy(np.random.default_rng(i).standard_normal(want.shape).astype(np.float32))
        g = g.to(cuda_device, dtype)
        plain = port_msda.msda_backward_plain(v.float(), shapes, loc_t[..., 0], loc_t[..., 1], w_t, g.float())
        plain_qm = (plain[0], *(a.permute(0, 2, 3, 4, 1) for a in plain[1:]))
        leaves = [v.clone().requires_grad_(), *(a.clone().requires_grad_() for a in qm)]
        before_bwd = port_msda.launches_bwd
        port_msda.msda_grid_qm(leaves[0], shapes, *leaves[1:]).backward(g)
        torch.cuda.synchronize()
        assert port_msda.launches_bwd == before_bwd + 1
        assert_grads_match_plain([t.grad for t in leaves], plain_qm, dtype == torch.bfloat16)


@pytest.mark.gpu
def test_cuda_qm_kernel_rejects_what_it_cannot_take(cuda_device):
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    shapes = SHAPES[0]
    value, loc, w = batch_of_two(50, shapes)
    v = torch.from_numpy(value).to(cuda_device)
    x = torch.from_numpy(loc[..., 0]).to(cuda_device).permute(0, 2, 3, 4, 1)  # not contiguous
    y, ww = (torch.from_numpy(a).to(cuda_device).permute(0, 2, 3, 4, 1).contiguous() for a in (loc[..., 1], w))
    with pytest.raises(ValueError, match="contiguous"):
        port_msda.msda_grid_qm(v, shapes, x, y, ww)


@pytest.mark.gpu
def test_narrow_r50_on_card_matches_cpu(cuda_device):
    """A full-depth R50 of widths 32..256 under the tiny head on the card
    against the same weights on the CPU (scores 2e-4, boxes 0.1 px at
    128x128); 4 forward launches (2 encoder + 2 decoder layers)."""
    from dataclasses import replace

    from codetr_torch import build_codetr, tiny_test_config
    from codetr_torch.config import NeckConfig, ResNetConfig

    cfg = replace(tiny_test_config(), backbone_type="resnet", swin=None,
                  resnet=ResNetConfig(stem_channels=8, base_channels=8),
                  neck=NeckConfig(in_channels=(32, 64, 128, 256), out_channels=32, num_outs=5))
    cpu = build_codetr(cfg, device="cpu", seed=4)
    gpu = build_codetr(cfg, device=cuda_device, seed=4)
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.standard_normal((1, 128, 128, 3)).astype(np.float32))
    mask = torch.zeros(1, 128, 128)
    mask[:, 100:] = 1.0
    before = port_msda.launches
    with torch.no_grad():
        c_boxes, c_scores, c_labels = cpu(img, mask)
        g_boxes, g_scores, g_labels = gpu(img.to(cuda_device), mask.to(cuda_device))
    assert port_msda.launches - before == 4
    torch.testing.assert_close(g_scores.cpu(), c_scores, rtol=0, atol=2e-4)
    torch.testing.assert_close(g_boxes.cpu(), c_boxes, rtol=0, atol=0.1)
    assert torch.equal(g_labels.cpu(), c_labels)


def grid_qm(value, loc, w, device, dtype=torch.float32):
    """``make_inputs`` draws (Q = K, grid queries) on the card: the value in
    ``dtype`` and q-minor x, y, w, each (bs, h, L, P, K) fp32 contiguous."""
    v = torch.from_numpy(value).to(device, dtype)
    loc_t, w_t = torch.from_numpy(loc).to(device), torch.from_numpy(w).to(device)
    return v, [a.permute(0, 2, 3, 4, 1).contiguous() for a in (loc_t[..., 0], loc_t[..., 1], w_t)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_shift_kernel_matches_plain(cuda_device, dtype):
    """The shift-window kernel (K4) against its plain version, the truncated
    function, on the card at the flagship's head width: idealised anchors
    (``max_window`` 31) and the coarse-pair escape (radius 1 with
    ``max_window`` 7: the cross-level pairs' W = 9 takes it); fp32 to 1e-5
    of scale, bf16 within its rounding; one ``launches_shift`` per call."""
    from codetr_torch.ops import msda_grid

    for i, shapes in enumerate(SHAPES):
        value, loc, w = batch_of_two(60 + 2 * i, shapes)
        v, qm = grid_qm(value, loc, w, cuda_device, dtype)
        for radius, max_window in ((2, 31), (1, 7)):
            before = port_msda.launches_shift
            got = msda_grid.msda_grid_shift_qm(v, shapes, *qm, radius=radius, max_window=max_window)
            torch.cuda.synchronize()
            assert port_msda.launches_shift == before + 1
            want = msda_grid.msda_shift_plain(v.float(), shapes, *qm, radius, max_window)
            assert got.dtype == dtype
            if dtype == torch.float32:
                assert_close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
            else:
                assert_within_bf16_rounding(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["grid", "grid_pallas"])
def test_cuda_corrected_dispatch_matches_exact(cuda_device, impl):
    """``msda_grid_qm(impl=...)`` on the card against the exact
    ``msda_reference_qm`` (1e-5 of scale): K4 on the taps inside the
    envelope, K3 on the rest (these draws leave taps on both sides); its
    gradient is the exact VJP, two backward launches, 1e-5 of scale."""
    for i, shapes in enumerate(SHAPES):
        value, loc, w = batch_of_two(70 + 2 * i, shapes)
        v, qm = grid_qm(value, loc, w, cuda_device)
        before = (port_msda.launches_shift, port_msda.launches_qm)
        got = port_msda.msda_grid_qm(v, shapes, *qm, impl=impl, radius=2)
        torch.cuda.synchronize()
        assert port_msda.last_out_of_envelope > 0
        assert (port_msda.launches_shift - before[0], port_msda.launches_qm - before[1]) == (1, 1)
        assert_close(got.cpu().numpy(), port_msda.msda_reference_qm(v, shapes, *qm).cpu().numpy(), rtol=1e-5)

        g = torch.from_numpy(np.random.default_rng(i).standard_normal(got.shape).astype(np.float32))
        g = g.to(cuda_device)
        leaves = [v.clone().requires_grad_(), *(a.clone().requires_grad_() for a in qm)]
        before_bwd = port_msda.launches_bwd
        port_msda.msda_grid_qm(leaves[0], shapes, *leaves[1:], impl=impl, radius=2).backward(g)
        torch.cuda.synchronize()
        assert port_msda.launches_bwd == before_bwd + 2
        plain = port_msda.msda_backward_plain(v, shapes, *(a.permute(0, 4, 1, 2, 3) for a in qm), g)
        plain_qm = (plain[0], *(a.permute(0, 2, 3, 4, 1) for a in plain[1:]))
        assert_grads_match_plain([t.grad for t in leaves], plain_qm, False)


@pytest.mark.gpu
def test_cuda_gatherbench_matches_plain(cuda_device):
    """Each K5 op at every size of the sweep against its plain version on the
    card: the gathers and idxadd bit for bit, fma1 and splat2 (fused or
    separately rounded products) within 1e-6 of the checksum's scale; one
    launch per call."""
    from codetr_torch.tools import gatherbench as gb

    for key, op, size, dtype in gb.cases():
        inputs = gb.make_inputs(op, size, dtype, device=cuda_device)
        before = gb.launches
        got = gb.KERNEL[op](*inputs)
        torch.cuda.synchronize()
        assert gb.launches == before + 1
        want = gb.PLAIN[op](*inputs)
        if op in ("fma1", "splat2"):
            assert (got - want).abs().max() <= 1e-6 * want.abs().max(), key
        else:
            assert torch.equal(got, want), key


def check_gatherbench_case(gb, op, size, dtype, device):
    inputs = gb.make_inputs(op, size, dtype, device=device)
    before = gb.launches
    got = gb.KERNEL[op](*inputs)
    torch.cuda.synchronize()
    assert gb.launches == before + 1
    want = gb.PLAIN[op](*inputs)
    if op in ("fma1", "splat2"):
        assert (got - want).abs().max() <= 1e-6 * want.abs().max(), (op, size)
    else:
        assert torch.equal(got, want), (op, size, dtype)


GB_TAILS = [("gather_sub", (8, 128), torch.float32), ("gather_sub", (8, 128), torch.bfloat16),
            ("gather_sub", (257, 130), torch.float32), ("gather_sub", (257, 130), torch.bfloat16),
            ("gather_sub", (1041, 300), torch.float32), ("gather_sub", (1041, 300), torch.bfloat16),
            ("gather_lane", (8, 128), torch.float32), ("gather_lane", (257, 130), torch.float32),
            ("gather_lane", (1041, 300), torch.float32), ("splat2", (7, 9, 130), torch.float32),
            ("idxadd", (9, 129), torch.int32), ("fma1", (9, 129), torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("op,size,dtype", GB_TAILS,
                         ids=lambda v: str(v).replace("torch.", "").replace(" ", ""))
def test_cuda_gatherbench_tails_match_plain(cuda_device, op, size, dtype):
    """Sizes the sweep never reaches (ragged stripes, rows and blocks, odd
    widths, n below R) against the plain version, as the sweep's sizes."""
    from codetr_torch.tools import gatherbench as gb

    assert (op, size, dtype) in gb.TAIL_CASES
    check_gatherbench_case(gb, op, size, dtype, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gather_sub_largest_n(cuda_device, dtype):
    """The largest n whose stripe fits a block's shared memory runs and
    matches the plain version bit for bit; one more raises on the card and
    launches nothing (no fallback to the plain version)."""
    from codetr_torch.tools import gatherbench as gb

    check_gatherbench_case(gb, "gather_sub", (gb.SUB_MAX_N, 160), dtype, cuda_device)
    x, idx = gb.make_inputs("gather_sub", (gb.SUB_MAX_N + 1, 160), dtype, device=cuda_device)
    before = gb.launches
    with pytest.raises(ValueError):
        gb.gather_sub(x, idx)
    assert gb.launches == before


@pytest.mark.gpu
def test_cuda_gatherbench_floor_and_limits(cuda_device):
    """The empty kernel launches at a case's geometry and counts; idxadd
    past its exact range raises on the card."""
    from codetr_torch.tools import gatherbench as gb

    x, idx = gb.make_inputs("gather_sub", (1040, 256), torch.float32, device=cuda_device)
    before = gb.launches
    gb.null(x, *gb.launch_geometry("gather_sub", (1040, 256), torch.float32))
    torch.cuda.synchronize()
    assert gb.launches == before + 1
    with pytest.raises(ValueError):
        gb.idxadd(idx, 2**24 // gb.R + 1)
    assert gb.launches == before + 1


# odd level sets for the tiled encoder kernels; the later levels are smaller
# than their query tiles (the 608x608 pyramid ends in a 10x10 level)
TILED_SHAPES = [
    ((37, 53), (19, 27), (10, 14), (5, 7)),
    ((20, 30), (10, 15), (5, 8), (3, 4), (2, 2)),
]


def tiled_inputs(rng, shapes, bs=2, h=4, d=32, P=4, halo=5):
    """Grid-query taps for the tiled encoder kernels: value (bs, K, h, d),
    loc (bs, K, h, L, P, 2), w (bs, K, h, L, P), float32.  Each tap is its
    query's reference point plus up to halo + 2 target pixels on each axis
    (inside its tile's window and just outside it); 10% are far taps
    (anywhere within a level size of the level) and 20% sit on exact pixel
    centres (grid lines)."""
    K, L = sum(hh * ww for hh, ww in shapes), len(shapes)
    refs = np.concatenate([
        np.stack(np.meshgrid((np.arange(ww) + 0.5) / ww, (np.arange(hh) + 0.5) / hh, indexing="xy"),
                 -1).reshape(-1, 2)
        for hh, ww in shapes
    ])  # (K, 2) xy
    size = np.asarray([[ww, hh] for hh, ww in shapes], np.float64)[:, None, :]  # (L, 1, xy)
    off = rng.uniform(-(halo + 2), halo + 2, (bs, K, h, L, P, 2))
    loc = refs[None, :, None, None, None, :] + off / size
    far = rng.random((bs, K, h, L, P)) < 0.1
    loc[far] = rng.uniform(-1.0, 2.0, (int(far.sum()), 2))
    exact = rng.random((bs, K, h, L, P)) < 0.2
    loc = np.where(exact[..., None], (np.round(loc * size - 0.5) + 0.5) / size, loc)
    value = rng.standard_normal((bs, K, h, d))
    w = rng.uniform(0, 1, (bs, K, h, L, P))
    w = w / w.sum(axis=(-1, -2), keepdims=True)
    return value.astype(np.float32), loc.astype(np.float32), w.astype(np.float32)


def check_tiled(device, dtype, shapes, value, loc, w):
    """The packed forward and backward (one launch each) against their plain
    versions: fp32 to 1e-5 of scale, bf16 within its rounding; pad columns
    of the packed gradient zero."""
    bs, K, h, L, P = w.shape
    d = value.shape[3]
    v = torch.from_numpy(value).to(device, dtype)
    loc_t, w_t = torch.from_numpy(loc).to(device), torch.from_numpy(w).to(device)
    cpk = torch.from_numpy(pack(loc, w, pad_to=3 * h * L * P + 5)).to(device)
    before = port_msda.launches
    got = port_msda.msda_grid_packed(v, shapes, cpk, P)
    torch.cuda.synchronize()
    assert port_msda.launches == before + 1 and got.dtype == dtype
    want = port_msda.multi_scale_deformable_attention_plain(v.float(), shapes, loc_t, w_t)
    if dtype == torch.float32:
        assert_close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
    else:
        assert_within_bf16_rounding(got, want)

    g = torch.from_numpy(np.random.default_rng(K).standard_normal((bs, K, h * d)).astype(np.float32))
    g = g.to(device, dtype)
    before = port_msda.launches_bwd
    grad_value, grad_cpk = port_msda._launch_packed_bwd(v, shapes, cpk, P, g)
    torch.cuda.synchronize()
    assert port_msda.launches_bwd == before + 1
    assert not grad_cpk[..., 3 * h * L * P:].any()
    plain = port_msda.msda_backward_plain(v.float(), shapes, loc_t[..., 0], loc_t[..., 1], w_t, g.float())
    assert_grads_match_plain((grad_value, *port_msda._unpack(grad_cpk, h, L, P)), plain,
                             dtype == torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [30, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tiled_packed_matches_plain(cuda_device, dtype, d):
    """The tiled encoder kernels (``msda_packed_fwd`` / ``msda_packed_bwd``)
    at small odd shapes, batch 2, taps in and just out of their windows,
    far and on grid lines, at one, two and four channel slices a lane, and
    at a head dim that is not a multiple of 4 (the window copies and the
    backward's per-pixel sums without vector accesses); some levels are
    smaller than their query tiles."""
    from codetr_torch.ops import msda_tiles

    for i, shapes in enumerate(TILED_SHAPES):
        plan = msda_tiles.encoder_tile_plan(shapes, dtype, head_dim=d)
        assert any(th > hh or tw > ww for (hh, ww), (th, tw) in zip(shapes, plan.tiles))
        check_tiled(cuda_device, dtype, shapes, *tiled_inputs(np.random.default_rng(80 + i), shapes, d=d))


# the 768x1152 serving pyramid (K = 73,656)
SERVING_SHAPES = ((192, 288), (96, 144), (48, 72), (24, 36), (12, 18))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tiled_packed_with_unstaged_pairs(cuda_device, dtype):
    """The 768x1152 plans stage some pairs and read others directly (the
    coarse query levels onto the finest target levels): the pairs read
    directly are planned reads of the same kernel, and the result is the
    same function."""
    from codetr_torch.ops import msda_tiles

    shapes = SERVING_SHAPES
    for backward in (False, True):
        staged = msda_tiles.encoder_tile_plan(shapes, dtype, head_dim=32, backward=backward).staged
        assert all(staged[0]) and not all(map(all, staged))
    check_tiled(cuda_device, dtype, shapes, *tiled_inputs(np.random.default_rng(90), shapes, h=2))


@pytest.mark.gpu
def test_cuda_device_fixture_restores_the_flags(cuda_device):
    """``kept_tf32_flags`` (the fixture's body) puts back whatever a test
    sets."""
    with kept_tf32_flags() as saved:
        torch.backends.cuda.matmul.allow_tf32 = not saved[0]
        torch.backends.cudnn.allow_tf32 = not saved[1]
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved


def to_qminor(device, loc, w):
    """numpy (bs, K, h, L, P, 2) / (bs, K, h, L, P) -> q-minor x, y, w on the
    card, each (bs, h, L, P, K) fp32 contiguous."""
    loc_t, w_t = torch.from_numpy(loc).to(device), torch.from_numpy(w).to(device)
    return [a.permute(0, 2, 3, 4, 1).contiguous() for a in (loc_t[..., 0], loc_t[..., 1], w_t)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tiled_qm_matches_plain(cuda_device, dtype):
    """The tiled q-minor kernel (K3, ``msda_qm_fwd`` on K1's plan) against
    ``msda_reference_qm`` on tile-adversarial taps (in and just out of the
    windows, far, on grid lines), batch 2, at odd small shapes and at the
    768x1152 pyramid (whose plan reads some pairs directly): fp32 to 1e-5 of
    scale, bf16 within 2^-7 of each element + 1e-5 of scale; one
    ``launches_qm`` a call."""
    cases = [(shapes, tiled_inputs(np.random.default_rng(100 + i), shapes)) for i, shapes in enumerate(TILED_SHAPES)]
    cases.append((SERVING_SHAPES, tiled_inputs(np.random.default_rng(110), SERVING_SHAPES, h=2)))
    for shapes, (value, loc, w) in cases:
        v = torch.from_numpy(value).to(cuda_device, dtype)
        qm = to_qminor(cuda_device, loc, w)
        before = port_msda.launches_qm
        got = port_msda.msda_grid_qm(v, shapes, *qm)
        torch.cuda.synchronize()
        assert port_msda.launches_qm == before + 1 and got.dtype == dtype
        want = port_msda.msda_reference_qm(v.float(), shapes, *qm)
        if dtype == torch.float32:
            assert_close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
        else:
            assert_within_bf16_rounding(got, want)


def shift_taps(rng, shapes, radius, max_window, bs=2, h=4, d=32, P=4):
    """Taps of the shift-window function for K4's tiles: each at its query's
    anchor on the target level plus up to R + 2 cells on each axis (so on
    and across the window's first and last cells), 10% far, 20% on exact
    pixel centres; value (bs, K, h, d), x, y, w (bs, h, L, P, K)."""
    from codetr_torch.ops import msda_grid

    ax, ay, r1 = (a.numpy() for a in msda_grid._query_anchors(
        msda_grid._key(shapes), radius, max_window, "cpu"))  # (K, L)
    K, L = ax.shape
    size = np.asarray([[ww, hh] for hh, ww in shapes], np.float64)  # (L, xy)
    anchor = np.broadcast_to(np.stack([ax.T, ay.T], -1)[None, None, :, None], (bs, h, L, P, K, 2))
    reach = (r1.T + 1)[None, None, :, None, :, None]
    pos = anchor + rng.uniform(-1, 1, (bs, h, L, P, K, 2)) * reach
    exact = rng.random((bs, h, L, P, K)) < 0.2
    pos = np.where(exact[..., None], np.round(pos), pos)
    loc = (pos + 0.5) / size[None, None, :, None, None, :]
    far = rng.random((bs, h, L, P, K)) < 0.1
    loc[far] = rng.uniform(-1.0, 2.0, (int(far.sum()), 2))
    w = rng.uniform(0, 1, (bs, h, L, P, K))
    value = rng.standard_normal((bs, K, h, d))
    return (value.astype(np.float32), *(np.ascontiguousarray(loc[..., i], np.float32) for i in (0, 1)),
            w.astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tiled_shift_matches_plain(cuda_device, dtype):
    """The tiled shift-window kernel (K4) against ``msda_shift_plain`` on
    taps on and across its windows' first and last cells, batch 2: the
    idealised anchors (radius 2, ``max_window`` 31), the coarse-pair escape
    on every cross-level pair (radius 2, ``max_window`` 9: W = 11), and the
    768x1152 pyramid at radius 5 (its plan reads some pairs directly); fp32
    to 1e-5 of scale, bf16 within its rounding."""
    from codetr_torch.ops import msda_grid

    cases = [(shapes, 2, mw) for shapes in TILED_SHAPES for mw in (31, 9)] + [(SERVING_SHAPES, 5, 31)]
    for i, (shapes, radius, max_window) in enumerate(cases):
        plans = msda_grid.pair_plans(shapes, radius, max_window)
        assert any(p.coarse for row in plans for p in row) == (max_window == 9)
        value, x, y, w = shift_taps(np.random.default_rng(120 + i), shapes, radius, max_window,
                                    h=2 if shapes is SERVING_SHAPES else 4)
        v = torch.from_numpy(value).to(cuda_device, dtype)
        qm = [torch.from_numpy(a).to(cuda_device) for a in (x, y, w)]
        before = port_msda.launches_shift
        got = msda_grid.msda_grid_shift_qm(v, shapes, *qm, radius=radius, max_window=max_window)
        torch.cuda.synchronize()
        assert port_msda.launches_shift == before + 1 and got.dtype == dtype
        want = msda_grid.msda_shift_plain(v.float(), shapes, *qm, radius, max_window)
        if dtype == torch.float32:
            assert_close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
        else:
            assert_within_bf16_rounding(got, want)


@pytest.mark.gpu
def test_r50_fp32_on_card_matches_cpu_under_default_flags(cuda_device):
    """The full-width R50 Co-DINO, fp32, on the card against the same weights
    on the CPU at 384x384, with PyTorch's TF32 flags at their defaults
    (cuDNN's on): the model pins full fp32 itself.  Features, encoder memory
    and class logits within 2e-4 of their scale, scores 1e-3, boxes 0.5 px
    set-wise (one unmatched box in a hundred allowed)."""
    from codetr_torch import build_codetr, co_dino_r50

    assert torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    cfg = co_dino_r50()
    cpu = build_codetr(cfg, device="cpu", seed=0)
    gpu = build_codetr(cfg, device=cuda_device, seed=0)
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.standard_normal((1, 384, 384, 3)).astype(np.float32))
    mask = torch.zeros(1, 384, 384)
    mask[:, 288:] = 1.0
    mask[:, :, 336:] = 1.0

    def run(model, x, m):
        feats = model.features(x)
        _, _, aux = model.query_head.run_transformer(feats, m)
        return feats, aux, model(x, m)

    with torch.no_grad():
        c_feats, c_aux, (c_boxes, c_scores, c_labels) = run(cpu, img, mask)
        g_feats, g_aux, (g_boxes, g_scores, g_labels) = run(gpu, img.to(cuda_device), mask.to(cuda_device))
    assert torch.backends.cudnn.allow_tf32  # the caller's flag is back

    def rel(g, c):
        return ((g.cpu().float() - c).abs().max() / c.abs().max()).item()

    assert max(rel(g, c) for g, c in zip(g_feats, c_feats)) < 2e-4
    assert rel(g_aux["memory"], c_aux["memory"]) < 2e-4
    assert rel(g_aux["enc_class"], c_aux["enc_class"]) < 2e-4
    assert (g_scores.cpu() - c_scores).abs().max().item() < 1e-3
    gb, gl = g_boxes.cpu()[0].numpy(), g_labels.cpu()[0].numpy()
    used = np.zeros(len(gb), bool)
    unmatched = 0
    for b, lab in zip(c_boxes[0].numpy(), c_labels[0].numpy()):
        cand = np.where((gl == lab) & ~used)[0]
        dist = np.abs(gb[cand] - b).max(axis=1) if len(cand) else np.array([np.inf])
        if dist.min() > 0.5:
            unmatched += 1
            continue
        used[cand[np.argmin(dist)]] = True
    assert unmatched <= len(gb) // 100


@pytest.fixture
def tiny_on_card(cuda_device):
    """The tiny model on the card and a seeded 128x128 input with padding."""
    from codetr_torch import build_codetr, tiny_test_config

    model = build_codetr(tiny_test_config(), device=cuda_device, seed=3)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 128, 128, 3)).astype(np.float32)).to(cuda_device)
    m = torch.zeros(1, 128, 128, device=cuda_device)
    m[:, 100:] = 1.0
    return model, (x, m)


@pytest.mark.gpu
def test_exported_program_reloads_on_card_through_the_kernel(tiny_on_card, tmp_path):
    """Exported on the card, saved, reloaded: the program launches the
    forward kernel once per MSDA layer (2 encoder + 2 decoder) and gives
    the in-process model's outputs exactly; one exported on the CPU and
    loaded onto the card does too."""
    from codetr_torch.runtime import aot

    model, (x, m) = tiny_on_card
    with torch.no_grad():
        want = model(x, m)
    for device in ("cuda", "cpu"):
        src = model if device == "cuda" else model.to("cpu")
        fn, example = aot.compile_forward(src, height=128, width=128)
        path = str(tmp_path / f"{device}.codetr.pt2")
        aot.save_executable(path, fn, example, meta={"dtype": "float32"})
        loaded = aot.load_executable(path, device="cuda")
        before = port_msda.launches
        got = loaded(x, m)
        assert port_msda.launches - before == 4
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        model.to(x.device)


@pytest.mark.gpu
def test_graph_timer_against_eager_on_one_program(tiny_on_card):
    """``make_loop_timer(graph=True)`` replays one capture (the kernels are
    counted once, at capture) and gives the eager call's outputs;
    ``graph=False`` times eager calls, each counted."""
    from codetr_torch.runtime import aot

    model, args = tiny_on_card
    fn, _ = aot.compile_forward(model, height=128, width=128)
    before = port_msda.launches
    run = aot.make_loop_timer(fn, args, graph=True, warmup=1)
    assert port_msda.launches - before == 8  # 1 warm-up call + the capture
    graph_ms = run(5)
    assert port_msda.launches - before == 8
    torch.cuda.synchronize()
    for g, e in zip(run.graph.outputs, fn(*args)):
        assert torch.equal(g, e)
    before = port_msda.launches
    eager_ms = aot.make_loop_timer(fn, args, graph=False, warmup=1)(5)
    assert port_msda.launches - before == 4 * 6
    assert 0 < graph_ms and 0 < eager_ms


@pytest.mark.gpu
def test_capture_failure_raises_naming_the_op(cuda_device):
    from codetr_torch.runtime import aot

    x = torch.ones(8, device=cuda_device)
    with pytest.raises(RuntimeError, match="capture failed at op aten._local_scalar_dense"):
        aot.make_loop_timer(lambda t: t * t.sum().item(), (x,), graph=True, warmup=1)


@pytest.mark.gpu
def test_program_never_runs_the_plain_msda_without_the_kernel_library(tiny_on_card, tmp_path, monkeypatch):
    """A kernel library that cannot be built or loaded makes
    ``load_executable`` on the card raise, and a loaded program's call
    raise: neither runs the plain version."""
    from codetr_torch.runtime import aot

    model, args = tiny_on_card
    fn, example = aot.compile_forward(model, height=128, width=128)
    path = str(tmp_path / "tiny.codetr.pt2")
    aot.save_executable(path, fn, example, meta={"dtype": "float32"})
    loaded = aot.load_executable(path, device="cuda")

    def no_library():
        raise OSError("libmsda_fwd.so: cannot open shared object file")

    monkeypatch.setattr(port_msda, "_fwd_lib", no_library)
    with pytest.raises(OSError, match="cannot open"):
        aot.load_executable(path, device="cuda")
    with pytest.raises(OSError, match="cannot open"):
        loaded(*args)


def assignment_cases(rng):
    """(name, cost (P, R, C) float32, row_valid (P, R)): the losses' shapes
    (max_gt 32 with 7 valid over the decoder's 900 queries and the encoder's
    30,785 and 73,656; 100 of 100 valid) and the hard cases: a mask with
    holes, no valid row, integer costs and duplicated columns (ties)."""
    def make(P, R, C, n_valid=None, kind="normal", holes=False):
        if kind == "integer":
            cost = rng.integers(0, 5, (P, R, C)).astype(np.float32)
        else:
            cost = (rng.standard_normal((P, R, C)) * 3).astype(np.float32)
        if kind == "duplicated":
            cost[..., 1::2] = cost[..., 0::2][..., :C // 2]
        valid = np.arange(R)[None].repeat(P, 0) < (R if n_valid is None else n_valid)
        if holes:
            valid &= rng.random((P, R)) < 0.6
        return cost, valid

    return [
        ("decoder 12x32x900", *make(12, 32, 900, 7)),
        ("coco max 2x100x900", *make(2, 100, 900)),
        ("encoder 2x32x30785", *make(2, 32, 30785, 7)),
        ("encoder 2x32x73656", *make(2, 32, 73656, 7)),
        ("holes 4x32x900", *make(4, 32, 900, holes=True)),
        ("no valid row 3x32x900", *make(3, 32, 900, 0)),
        ("integer 4x32x900", *make(4, 32, 900, 20, "integer")),
        ("duplicated 4x32x900", *make(4, 32, 900, 20, "duplicated")),
    ]


@pytest.mark.gpu
def test_cuda_assignment_matches_plain(cuda_device):
    """The Hungarian kernel against its plain version, assignment for
    assignment (the same float64 steps and tie rule), one launch a call;
    invalid rows get column 0."""
    from codetr_torch.ops import hungarian

    for name, cost, valid in assignment_cases(np.random.default_rng(0)):
        c, v = torch.from_numpy(cost).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
        before = hungarian.launches
        got = hungarian.linear_assignment(c, v)
        torch.cuda.synchronize()
        assert hungarian.launches - before == 1, name
        want = hungarian.linear_assignment_plain(c, v)
        assert torch.equal(got, want), name
        assert not got[~v].any(), name


@pytest.mark.gpu
def test_cuda_assignment_raises_without_its_library(cuda_device, monkeypatch):
    """A kernel library that cannot be built or loaded makes the card's
    ``linear_assignment`` raise; it never runs the plain version."""
    from codetr_torch.ops import hungarian

    def no_library():
        raise OSError("hungarian.so: cannot open shared object file")

    monkeypatch.setattr(hungarian, "_lib", no_library)
    monkeypatch.setattr(hungarian, "linear_assignment_plain", None)
    # made on the host: a failed graph capture earlier in the file leaves
    # the card's random generator unusable
    cost = torch.rand(2, 4, 9).to(cuda_device)
    with pytest.raises(OSError, match="cannot open"):
        hungarian.linear_assignment(cost, torch.ones(2, 4, dtype=torch.bool, device=cuda_device))


def tiny_train_batch(device, max_gt=8, n_valid=3):
    from codetr_torch import tiny_test_config

    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.standard_normal((1, 128, 128, 3)).astype(np.float32))
    mask = torch.zeros(1, 128, 128)
    mask[:, 96:] = 1.0
    boxes = torch.from_numpy(np.clip(rng.uniform(0.1, 0.9, (1, max_gt, 4)), 0.05, 0.3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, tiny_test_config().head.num_classes, (1, max_gt)))
    valid = torch.from_numpy(np.arange(max_gt)[None] < n_valid)
    return [t.to(device) for t in (img, mask, boxes, labels, valid)]


@pytest.mark.gpu
def test_cuda_detection_loss_never_syncs(cuda_device):
    """``dino_detection_loss`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: no host synchronisation,
    two matching launches (every decoder layer and image, then the encoder
    stage), and the CPU's losses (1e-5)."""
    from codetr_torch import build_codetr, tiny_test_config
    from codetr_torch.ops import hungarian
    from codetr_torch.parallel.losses import dino_detection_loss

    model = build_codetr(tiny_test_config(), device=cuda_device, seed=3)
    batch = tiny_train_batch(cuda_device)
    with torch.no_grad():
        outputs = model.train_outputs(*batch[:2])
    torch.cuda.synchronize()
    before = hungarian.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        total, logs = dino_detection_loss(outputs, *batch[2:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert hungarian.launches - before == 2
    want, want_logs = dino_detection_loss({k: v.cpu() for k, v in outputs.items()}, *(t.cpu() for t in batch[2:]))
    assert_close(total.item(), want.item())
    for k in want_logs:
        assert_close(logs[k].item(), want_logs[k].item())


@pytest.mark.gpu
def test_cuda_bf16_train_step_matches_cpu(cuda_device):
    """One bf16-compute step of the tiny model on the card (the MSDA and
    matching kernels) against the same fp32 weights stepped on the CPU.
    The matches first: the kernel and the plain version agree on each
    device's costs, and where the devices' matches differ the costs differ
    by rounding and the two assignments are a near-tie (within 2 x n x the
    largest cost difference).  Then the loss within 2e-2 relative; the
    card's parameters stay fp32 and every entry with a nonzero gradient
    moves."""
    import copy

    from codetr_torch import build_codetr, tiny_test_config
    from codetr_torch.ops import hungarian
    from codetr_torch.parallel import losses
    from codetr_torch.parallel.train import adamw, make_train_step, run_in_dtype

    cpu = build_codetr(tiny_test_config(), device="cpu", seed=3)
    gpu = copy.deepcopy(cpu).to(cuda_device)
    batches = {"cpu": tiny_train_batch("cpu"), "cuda": tiny_train_batch(cuda_device)}
    problems = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        b = batches[dev]
        with torch.no_grad():
            out = run_in_dtype(model, torch.bfloat16, lambda m, x, mk: m.train_outputs(x, mk), *b[:2])
        problems[dev] = [(c.cpu(), v.cpu()) for c, v in losses.matching_problems(out, *b[2:])]
    for (cg, v), (cc, _) in zip(problems["cuda"], problems["cpu"]):
        a_c = hungarian.linear_assignment_plain(cc, v)
        assert torch.equal(hungarian.linear_assignment(cc.to(cuda_device), v.to(cuda_device)).cpu(), a_c)
        a_g = hungarian.linear_assignment(cg.to(cuda_device), v.to(cuda_device)).cpu()
        for i in range(len(v)):
            if torch.equal(a_g[i][v[i]], a_c[i][v[i]]):
                continue
            rows = cc[i][v[i]]
            gap = (rows.gather(1, a_g[i][v[i]][:, None]).double().sum()
                   - rows.gather(1, a_c[i][v[i]][:, None]).double().sum()).item()
            delta = (cg[i][v[i]] - rows).abs().max().item()
            assert gap <= 2 * int(v[i].sum()) * delta, (i, gap, delta)
    start = {n: p.detach().clone() for n, p in gpu.named_parameters()}
    f0, b0, h0 = port_msda.launches, port_msda.launches_bwd, hungarian.launches
    loss_g = make_train_step(gpu, adamw(gpu), compute_dtype=torch.bfloat16)(*batches["cuda"]).item()
    torch.cuda.synchronize()
    assert (port_msda.launches - f0, port_msda.launches_bwd - b0, hungarian.launches - h0) == (4, 4, 2)
    loss_c = make_train_step(cpu, adamw(cpu), compute_dtype=torch.bfloat16)(*batches["cpu"]).item()
    assert abs(loss_g - loss_c) <= 2e-2 * abs(loss_c), (loss_g, loss_c)
    for n, p in gpu.named_parameters():
        assert p.dtype == torch.float32, n
        nz = p.grad != 0
        assert not (nz & (p.detach() == start[n])).any(), n


# ---- the matching with more padded gts than queries (R > C) ----


def tall_problems(rng, few_valid):
    """Seeded (cost (P, R, C) float32, row_valid) with more padded rows than
    columns: V <= C valid rows (holed), or V > C; continuous costs."""
    out = []
    for P, R, C in ((12, 32, 12), (3, 40, 7), (2, 100, 90), (4, 64, 33)):
        cost = (rng.standard_normal((P, R, C)) * 3).astype(np.float32)
        valid = np.zeros((P, R), bool)
        for v in valid:
            n = int(rng.integers(0, C + 1)) if few_valid else int(rng.integers(C + 1, R + 1))
            v[rng.permutation(R)[:n]] = True
        out.append((cost, valid))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("few_valid", [True, False], ids=["valid_le_columns", "valid_gt_columns"])
def test_cuda_assignment_of_tall_problems_matches_plain_and_scipy(cuda_device, few_valid):
    """R > C on the card, both branches: the kernel equals its plain version
    (one launch a call) and scipy (V <= C: the valid rows solved alone;
    V > C: the transposed problem, padding rows at ``INVALID_COST``)."""
    from scipy.optimize import linear_sum_assignment

    from codetr_torch.ops import hungarian

    for cost, valid in tall_problems(np.random.default_rng(8 + few_valid), few_valid):
        c, v = torch.from_numpy(cost).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
        before = hungarian.launches
        got = hungarian.linear_assignment(c, v).cpu()
        assert hungarian.launches - before == 1
        assert torch.equal(got, hungarian.linear_assignment_plain(torch.from_numpy(cost), torch.from_numpy(valid)))
        for cp, vp, g in zip(cost, valid, got.numpy()):
            want = np.zeros(len(vp), np.int64)
            if vp.sum() > cp.shape[1]:
                q, k = linear_sum_assignment(np.where(vp[:, None], cp, np.float32(hungarian.INVALID_COST)).T)
                want[k] = q
            else:
                rows = np.nonzero(vp)[0]
                r, k = linear_sum_assignment(cp[rows])
                want[rows[r]] = k
            np.testing.assert_array_equal(g, want)


# ---- COCO evaluation (codetr_torch/eval_coco.py) ----


@pytest.mark.gpu
def test_cuda_eval_coco_matches_cpu(cuda_device, tmp_path):
    """``eval_coco.main`` at the tiny config (fp32, batch 4 over 5 images, the
    ``.pth`` with numpy values in its ``meta``) on the card against the same
    call on the CPU: the ground truth is built from the CPU's detections
    (``ground_truth``), so the metrics agree to 1e-12; each served batch
    launches the forward kernel once per MSDA layer (2 + 2)."""
    from codetr_torch import build_codetr, eval_coco, tiny_test_config
    from codetr_torch.inferencer import Inferencer

    model = build_codetr(tiny_test_config(), device="cpu", seed=3)
    weights = str(tmp_path / "tiny.pth")
    torch.save({"state_dict": model.state_dict(), "meta": {"seed": np.int64(3), "iters": np.arange(3)}}, weights)
    rng = np.random.default_rng(9)
    names = [f"im{i}" for i in range(len(EVAL_SIZES))]
    for name, (h, w) in zip(names, EVAL_SIZES):
        np.save(tmp_path / f"{name}.npy", rng.integers(0, 256, (h, w, 3), np.uint8))
    preds = eval_coco.predict(Inferencer(model, height=128, width=128, batch_size=4, device="cpu"),
                              [str(tmp_path / f"{n}.npy") for n in names])
    anns, made = ground_truth(preds)
    assert made >= 5
    ann = write_annotations(tmp_path / "instances.json", names, ".npy", anns)
    args = ["--ann", ann, "--img-dir", str(tmp_path), "--config", "tiny", "--height", "128", "--width", "128",
            "--dtype", "float32", "--weights", weights]
    want = eval_coco.main(args + ["--device", "cpu"])
    before = port_msda.launches
    got = eval_coco.main(args)  # the card, by default
    assert port_msda.launches - before == 4 * 2  # 2 batches of 4
    assert want["mAP"] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


# ---- the postprocess (codetr_torch/ops/nms.py), captured on the card ----

SCORE_THRESHOLD = 0.1
NMS_TYPES = ["nms", "soft_nms", "soft_nms_gaussian"]


def postprocess_kwargs(nms_type, iou=None):
    """The keyword arguments of ``postprocess_detections`` for one case (iou
    0.5 for NMS, 0.8 for soft-NMS by default)."""
    if iou is None:
        iou = 0.5 if nms_type == "nms" else 0.8
    return dict(score_threshold=SCORE_THRESHOLD, iou_threshold=iou, nms_type=nms_type, nms_sigma=0.5,
                nms_min_score=1e-3)


def postprocess_inputs(seed=0, n=300, num_classes=80):
    """A served batch of 4 at Swin-L's ``max_per_img`` as float32 numpy
    (boxes (4, n, 4), scores (4, n), labels (4, n) int32, scale factors (4,
    1, 4)): boxes clustered and half the labels in 3 classes, so that
    boxes suppress one another.  Image 0: every score below
    SCORE_THRESHOLD.  Image 1: its last 40 rows -inf (padding).  Image 2:
    scores on a 1/32 grid (ties across classes) and 30 pairs of boxes with
    one label and one score each, 25 of them overlapping at IoU ~0.9 and 5
    identical (ties within a class).  Image 3: coordinates 13x the others'
    (1333 px), so a class offset taken over the batch would change the
    other images' IoUs."""
    rng = np.random.default_rng(seed)
    size = np.array([100.0, 100.0, 100.0, 1333.0])[:, None, None]
    centers = rng.uniform(0.1, 0.9, (4, 6, 2)) * size
    pick = rng.integers(0, 6, (4, n))
    c = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 0.01, (4, n, 2)) * size
    wh = rng.uniform(0.15, 0.25, (4, n, 2)) * size
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=-1)
    scores = rng.uniform(SCORE_THRESHOLD, 1.0, (4, n))
    labels = np.where(rng.random((4, n)) < 0.5, rng.integers(0, 3, (4, n)), rng.integers(0, num_classes, (4, n)))
    scores[0] = rng.uniform(0.0, 0.9 * SCORE_THRESHOLD, n)
    scores[1, -40:] = -np.inf
    boxes[1, -40:] = 0.0
    scores[2] = np.maximum(np.round(scores[2] * 32) / 32, SCORE_THRESHOLD)
    for k in range(30):
        a, b = 2 * k, 2 * k + 1
        labels[2, b], scores[2, b] = labels[2, a], scores[2, a]
        boxes[2, b] = boxes[2, a] + (0.0 if k < 5 else 0.5)
    sf = np.tile(rng.uniform(0.5, 2.0, (4, 1, 2)), (1, 1, 2))
    return (boxes.astype(np.float32), scores.astype(np.float32), labels.astype(np.int32),
            sf.astype(np.float32))


def tied_inputs(n=300, group=5):
    """Every score 0.5 in two images of n/group far-apart groups of ``group``
    nearly coincident boxes (IoU >= 0.8), one label a group; the second image
    is the first in a shuffled row order.  -> boxes, scores, labels (int32)
    and each image's first row of each group, the row that the first-index
    tie rule keeps (NMS) or leaves at 0.5 (soft-NMS)."""
    rng = np.random.default_rng(5)
    groups = n // group
    gid = np.repeat(np.arange(groups), group)
    origin = np.stack([gid % 10 * 100.0, gid // 10 * 100.0], axis=-1) + rng.uniform(0, 1, (n, 2))
    box = np.concatenate([origin, origin + 40.0], axis=-1)
    label = gid % 7
    perm = rng.permutation(n)
    boxes = np.stack([box, box[perm]]).astype(np.float32)
    labels = np.stack([label, label[perm]]).astype(np.int32)
    firsts = np.zeros((2, n), bool)
    for j, g in enumerate((gid, gid[perm])):
        _, first = np.unique(g, return_index=True)
        firsts[j, first] = True
    return boxes, np.full((2, n), 0.5, np.float32), labels, firsts


def postprocess_on(device, arrays, nms_type, iou=None):
    """``postprocess_detections`` of numpy ``arrays`` on ``device``."""
    from codetr_torch.ops.nms import postprocess_detections

    boxes, scores, labels, sf = (torch.from_numpy(a).to(device) for a in arrays)
    return postprocess_detections(boxes, scores, labels, scale_factor=sf, **postprocess_kwargs(nms_type, iou))


def assert_postprocess_close(got, want):
    """The parity ladder of the postprocess: keep masks and labels equal,
    scores and boxes within 1e-6."""
    (gb, gs, gl, gk), (wb, ws, wl, wk) = ([np.asarray(t.cpu() if torch.is_tensor(t) else t) for t in r]
                                          for r in (got, want))
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gb, wb, rtol=1e-6, atol=1e-6)


def captured_postprocess(args, nms_type):
    """The postprocess captured over on-card ``args`` (``aot.Replay``)."""
    from codetr_torch.ops.nms import postprocess_detections
    from codetr_torch.runtime.aot import Replay

    kw = postprocess_kwargs(nms_type)
    return Replay(lambda b, s, l, sf: postprocess_detections(b, s, l, scale_factor=sf, **kw), args)


@pytest.mark.gpu
@pytest.mark.parametrize("nms_type", NMS_TYPES)
def test_cuda_captured_postprocess_never_syncs(cuda_device, nms_type):
    """The postprocess at bs 4, N 300, eager and then captured and replayed,
    under ``torch.cuda.set_sync_debug_mode("error")``: no host read and no
    host-to-device copy; the replay's results equal the eager call's."""
    from codetr_torch.ops.nms import postprocess_detections

    args = tuple(torch.from_numpy(a).to(cuda_device) for a in postprocess_inputs())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = postprocess_detections(*args[:3], scale_factor=args[3], **postprocess_kwargs(nms_type))
        got = captured_postprocess(args, nms_type)(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, e in zip(got, eager):
        assert torch.equal(g, e)


@pytest.mark.gpu
@pytest.mark.parametrize("nms_type", NMS_TYPES)
def test_cuda_captured_postprocess_equals_eager(cuda_device, nms_type):
    """Replays of the captured postprocess equal the eager call bit for bit
    (the same kernels in the same order), twice on other inputs and once
    more on the first (the static buffers are refilled each call), and the
    CPU within the parity ladder."""
    arrays = postprocess_inputs()
    other = postprocess_inputs(seed=1)
    replay = captured_postprocess([torch.from_numpy(x).to(cuda_device) for x in arrays], nms_type)
    for a in (other, arrays, other):
        args = [torch.from_numpy(x).to(cuda_device) for x in a]
        got = replay(*args)
        eager = postprocess_on(cuda_device, a, nms_type)
        for g, e in zip(got, eager):
            assert torch.equal(g, e)
        assert_postprocess_close(got, postprocess_on("cpu", a, nms_type))
    assert replay.calls == 3


@pytest.mark.gpu
@pytest.mark.parametrize("nms_type", NMS_TYPES)
def test_cuda_tied_scores_take_the_first_index(cuda_device, nms_type):
    """Equal scores resolve to the first index on the card, eager and
    captured, as on the CPU (JAX's argsort and argmax): NMS keeps each
    group's first row, soft-NMS leaves it at 0.5 and decays the rest."""
    boxes, scores, labels, firsts = tied_inputs()
    sf = np.ones((2, 1, 4), np.float32)
    arrays = (boxes, scores, labels, sf)
    cpu = postprocess_on("cpu", arrays, nms_type)
    eager = postprocess_on(cuda_device, arrays, nms_type)
    args = [torch.from_numpy(x).to(cuda_device) for x in arrays]
    for got in (eager, captured_postprocess(args, nms_type)(*args)):
        assert_postprocess_close(got, cpu)
        keep, s = got[3].cpu().numpy(), got[1].cpu().numpy()
        if nms_type == "nms":
            np.testing.assert_array_equal(keep, firsts)
        else:
            assert np.all(s[firsts] == 0.5) and np.all(s[~firsts] < 0.5)


@pytest.mark.gpu
def test_cuda_inferencer_batches_keep_their_own_detections(cuda_device):
    """One ``Inferencer`` call over 9 images at batch 4 (three batches, the
    last padded) returns what three separate calls return: each replay's
    outputs are copied out before the next replay overwrites them.  One
    captured program serves all six batches."""
    from codetr_torch import build_codetr, tiny_test_config
    from codetr_torch.inferencer import Inferencer

    model = build_codetr(tiny_test_config(), device=cuda_device, seed=3)
    inf = Inferencer(model, height=128, width=128, batch_size=4, device=cuda_device)
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (int(rng.integers(64, 200)), int(rng.integers(64, 200)), 3), np.uint8)
              for _ in range(9)]
    together = inf(images)
    apart = inf(images[:4]) + inf(images[4:8]) + inf(images[8:])
    assert len(together) == len(apart) == 9
    for g, w in zip(together, apart):
        for f in ("boxes", "scores", "labels", "keep"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    assert not all(np.array_equal(together[0].scores, d.scores) for d in together[1:])
    (program,) = inf.postprocess_programs.values()
    assert program.calls == 6


def unmatched_boxes(got, want, box_tol=0.1):
    """Greedy set-wise match: each of ``want``'s (boxes, labels) to an unused
    one of ``got`` with its label within ``box_tol`` px -> unmatched count."""
    (gb, gl), (wb, wl) = got, want
    used = np.zeros(len(gb), bool)
    unmatched = 0
    for b, lab in zip(wb, wl):
        cand = np.nonzero((gl == lab) & ~used)[0]
        d = np.abs(gb[cand] - b).max(axis=1) if len(cand) else np.array([np.inf])
        if d.min() > box_tol:
            unmatched += 1
            continue
        used[cand[np.argmin(d)]] = True
    return unmatched


@pytest.mark.gpu
def test_cuda_rehearsal_tiny_fp32_matches_cpu(cuda_device, tmp_path):
    """The tiny rehearsal on the card in fp32 at 128x128: ``pass``, the
    forward kernel launched once per MSDA layer (2 + 2) and image, the
    exported forward timed; its reader's detections against the same
    reader on the CPU (scores 2e-4, boxes 0.1 px set-wise)."""
    from codetr_torch import build_codetr, tiny_test_config
    from codetr_torch.tools import rehearsal

    record, detail = rehearsal.rehearse(rehearsal.parse_args(
        ["--config", "tiny", "--dtype", "float32", "--height", "128", "--width", "128", "--trials", "2",
         "--out", str(tmp_path / "tiny.pth")]))
    assert record["pass"] and record["device"] == "cuda"
    assert (record["msda_launches"]["forward"], record["msda_launches"]["backward"]) == (4 * record["images"], 0)
    assert record["latency_ms"]["p50"] > 0
    cpu = build_codetr(tiny_test_config(), detail["pth"], device="cpu", seed=detail["reader_seed"])
    for (gb, gs, gl, _), (cb, cs, cl, _) in zip(detail["reader"],
                                          rehearsal.detections(cpu, detail["images"], torch.device("cpu"))):
        assert np.abs(gs - cs).max() < 2e-4
        assert unmatched_boxes((gb, gl), (cb, cl)) <= max(1, len(cb) // 100)


# ---- the train step as one captured program (parallel/train.py:capture_train_step) ----

CAPTURE_CASES = [(torch.float32, False), (torch.bfloat16, False), (torch.float32, True)]
CAPTURE_IDS = ["fp32", "bf16", "fp32_with_cp"]
# a replay's gradient against the eager step's from the same state: the
# largest |difference| over every leaf, relative to the largest |gradient|.
# Not zero: the MSDA backward kernels and PyTorch's scatter-adds (the bias
# tables' index backward) sum with float atomics in no fixed order, so the
# eager step differs from itself as much; leaves that are zero in exact
# arithmetic (the norm biases that a GroupNorm cancels, attention key
# biases) are pure rounding noise, so no per-leaf bound holds for them
CAPTURE_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def tiny_train_model(device, with_cp=False, seed=3):
    from dataclasses import replace

    from codetr_torch import build_codetr, tiny_test_config

    cfg = tiny_test_config()
    return build_codetr(replace(cfg, swin=replace(cfg.swin, with_cp=with_cp)), device=device, seed=seed)


def train_state(model, opt):
    """name -> tensor: every parameter, its gradient and its AdamW state."""
    names = {p: n for n, p in model.named_parameters()}
    out = {}
    for n, p in model.named_parameters():
        out[n], out[f"{n}.grad"] = p.detach(), p.grad
    for p, s in opt.state.items():
        out.update({f"{names[p]}.{k}": v for k, v in s.items()})
    return out


def state_gaps(got, want) -> dict:
    """name -> max |got - want| relative to the largest |want| of that tensor."""
    return {n: ((got[n].double() - w.double()).abs().max() / w.double().abs().max().clamp_min(1e-30)).item()
            for n, w in want.items()}


def gradient_gap(got, want) -> float:
    """The largest |got - want| over every leaf, relative to the largest |want|."""
    scale = max(w.abs().max().item() for w in want.values())
    return max((got[n] - w).abs().max().item() for n, w in want.items()) / scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,with_cp", CAPTURE_CASES, ids=CAPTURE_IDS)
def test_cuda_captured_train_step_equals_eager_twin(cuda_device, dtype, with_cp):
    """3 replays of the captured step against 3 eager steps of a twin with
    the same capturable AdamW.  The first replay is the first step (the
    capture's warm-up was undone).  Each step: the losses equal bit for bit;
    the gradients within ``CAPTURE_GRAD_TOL`` of the largest gradient (float
    atomics, see there); then the twin's AdamW steps on the replay's gradient and must land on
    the replay's parameters and moments bit for bit, so the next step starts
    from one state on both sides."""
    import copy

    from codetr_torch.parallel.train import adamw, capture_train_step, train_loss

    model = tiny_train_model(cuda_device, with_cp)
    twin = copy.deepcopy(model)
    batch = tiny_train_batch(cuda_device)
    opt, twin_opt = adamw(model, capturable=True), adamw(twin, capturable=True)
    step = capture_train_step(model, opt, batch, compute_dtype=dtype)
    for i in range(3):
        got = step(*batch)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        twin.zero_grad(set_to_none=True)
        want = train_loss(twin, batch, compute_dtype=dtype, backward=True)
        assert torch.equal(got, want), (i, got.item(), want.item())
        gap = gradient_gap(grads, {n: p.grad for n, p in twin.named_parameters()})
        assert gap <= CAPTURE_GRAD_TOL[dtype], (i, gap)
        for n, p in twin.named_parameters():
            p.grad = grads[n]
        twin_opt.step()
        after, twin_after = train_state(model, opt), train_state(twin, twin_opt)
        assert sorted(after) == sorted(twin_after)
        unequal = [n for n, t in twin_after.items() if not torch.equal(after[n], t)]
        assert not unequal, (i, unequal[:5])
    assert all(v.item() == 3 for k, v in train_state(model, opt).items() if k.endswith(".step"))


@pytest.mark.gpu
def test_cuda_captured_train_step_matches_cpu(cuda_device):
    """One replay of the captured fp32 step against the CPU's eager step of
    the same weights: the loss within 1e-4 relative, each gradient leaf
    within max(1e-4, 3 x its spread) of its scale, the spread measured as
    ``chip_smoke.py:compare_train_steps`` does (the median, over 3 seeded
    1e-7 moves of every weight, of how far the card's own gradient of the
    leaf moves)."""
    import copy
    import statistics

    from codetr_torch.parallel.train import adamw, capture_train_step, make_train_step

    cpu = tiny_train_model("cpu")
    start = copy.deepcopy(cpu)
    gpu = copy.deepcopy(cpu).to(cuda_device)
    batch = tiny_train_batch(cuda_device)
    step = capture_train_step(gpu, adamw(gpu, capturable=True), batch)
    loss_g = step(*batch).item()
    grads_g = {n: p.grad.cpu() for n, p in gpu.named_parameters()}
    loss_c = make_train_step(cpu, adamw(cpu))(*(t.cpu() for t in batch)).item()
    grads_c = {n: p.grad for n, p in cpu.named_parameters()}
    moved = {n: [] for n in grads_g}
    for i in range(3):
        m = copy.deepcopy(start).to(cuda_device)
        gen = torch.Generator().manual_seed(5 + i)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen).to(cuda_device))
        make_train_step(m, adamw(m))(*batch)
        for n, g in state_gaps({n: p.grad.cpu() for n, p in m.named_parameters()}, grads_g).items():
            moved[n].append(g)
    gaps = state_gaps(grads_g, grads_c)
    over = {n: (g, statistics.median(moved[n])) for n, g in gaps.items()
            if g > max(1e-4, 3 * statistics.median(moved[n]))}
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c), (loss_g, loss_c)
    assert not over, over


@pytest.mark.gpu
def test_cuda_captured_train_step_never_syncs(cuda_device):
    """A replay of the captured step (its copy-in and the loss's clone
    included) under ``torch.cuda.set_sync_debug_mode("error")``."""
    from codetr_torch.parallel.train import adamw, capture_train_step
    from codetr_torch.runtime.aot import pool_bytes

    model = tiny_train_model(cuda_device)
    batch = tiny_train_batch(cuda_device)
    step = capture_train_step(model, adamw(model, capturable=True), batch)
    assert pool_bytes(step.replay.graph) > 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step(*batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss).item()


@pytest.mark.gpu
def test_cuda_captured_train_step_launches_each_kernel_from_a_trace(cuda_device, tmp_path):
    """A traced replay launches the encoder MSDA forward and backward
    kernels (K1, K2) once per encoder layer, the decoder's once per decoder
    layer, and the matching kernel twice; the wrappers' host counters do
    not move (they count at capture)."""
    from codetr_torch.ops import hungarian
    from codetr_torch.parallel.train import adamw, capture_train_step
    from codetr_torch.utils.profiling import kernel_counts, trace

    model = tiny_train_model(cuda_device)
    tc = model.cfg.head.transformer
    batch = tiny_train_batch(cuda_device)
    step = capture_train_step(model, adamw(model, capturable=True), batch)
    step(*batch)
    torch.cuda.synchronize()
    before = (port_msda.launches, port_msda.launches_bwd, hungarian.launches)
    with trace(str(tmp_path)):
        step(*batch)
        torch.cuda.synchronize()
    assert (port_msda.launches, port_msda.launches_bwd, hungarian.launches) == before
    counts = kernel_counts(str(tmp_path))
    assert counts == {"msda_tile_fwd_kernel": tc.num_encoder_layers, "msda_fwd_kernel": tc.num_decoder_layers,
                      "msda_tile_bwd_kernel": tc.num_encoder_layers, "msda_bwd_kernel": tc.num_decoder_layers,
                      "hungarian_kernel": 2, "all": counts["all"]}, counts


@pytest.mark.gpu
def test_cuda_attribution_encoder_kernels_verified_timed_and_traced(cuda_device, tmp_path, capsys):
    """The attribution tool's encoder suite at 384x384 (Swin-L widths): the
    encoder MSDA module's and the decoder's kernels (K1's two entries) held
    against the plain version on the modules' own inputs, one launch each;
    each stage has a time, a floor at the ceilings measured in the run, and
    a traced replay that holds its kernel."""
    from codetr_torch.tools import attr

    result = attr.main(["encoder", "384", "384", "--only", "emsda", "dmsda", "--verify", "--trace", str(tmp_path),
                        "--iters", "2", "--trials", "2"])
    capsys.readouterr()
    assert result["summary"]["verify_ok"]
    assert [(v["verify"], v["launches"]) for v in result["verify"]] == [("emsda", 1), ("dmsda", 1)]
    for name, kernel in (("emsda", "msda_tile_fwd_kernel"), ("dmsda", "msda_fwd_kernel")):
        r = result["records"][name]
        assert r["best_sane_ms"] > 0 and r["floor_ms"] > 0 and r["x_over_floor"] > 0, r
        assert r["ceiling"]["source"] == "measured"
        assert r["traced"]["port_kernels"].get(kernel, 0) >= 1, r["traced"]
