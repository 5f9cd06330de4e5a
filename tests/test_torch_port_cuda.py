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

import numpy as np
import pytest
import torch

from codetr_torch.ops import msda as port_msda

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the MSDA kernel has no CPU mode")
    # a reference on the card is compared in full fp32 precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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
