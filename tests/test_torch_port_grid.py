"""The port's shift-window grid MSDA (kernel K4's counterpart,
``codetr_torch/ops/msda_grid.py``) and its dispatch, module and encoder
layer against the JAX package, on the CPU.

The JAX side runs its Pallas kernel ``msda_grid_pallas_qm`` in interpret
mode (twice: the function, and one ``impl="grid_pallas"`` dispatch, ~4 s
each on one CPU core) and holds everything else against its XLA twin
``msda_grid_shift_qm`` (``impl="grid"``), which computes the same function
without the coarse-pair escape.  Inputs are the JAX suite's
``grid_inputs`` (each tap at its query's anchor on the target level plus
uniform jitter) with a share of wild taps 8+ px away, made from numpy
seeds.  Tolerances: the function 2e-5 abs / 1e-5 rel, the JAX suite's
own; gradients 1e-5 of their scale; the module and encoder layer 1e-4
relative (the features ladder).
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.config import MSDAConfig as JaxMSDAConfig
from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.models.codetr import build_codetr as jax_build_codetr
from codetr_tpu.models.msda_module import MultiScaleDeformableAttention as JaxMSDA
from codetr_tpu.models.transformer import DetrTransformerEncoderLayer as JaxEncoderLayer
from codetr_tpu.ops import msda_pallas
from codetr_tpu.ops.msda import msda_grid_qm as jax_msda_grid_qm, msda_reference_qm
from codetr_tpu.ops.msda_grid import _AxisPlan, envelope_mask as jax_envelope_mask
from codetr_tpu.ops.msda_grid import msda_grid_shift_qm as jax_msda_grid_shift_qm
from codetr_torch.config import MSDAConfig, tiny_test_config
from codetr_torch.models.codetr import build_codetr
from codetr_torch.models.msda_module import MultiScaleDeformableAttention
from codetr_torch.models.transformer import DetrTransformerEncoderLayer, get_reference_points
from codetr_torch.ops import msda as port_msda
from codetr_torch.ops import msda_grid
from codetr_torch.utils.checkpoint import _Out

from test_msda_grid import grid_inputs
from test_torch_port_msda import assert_close_to_scale


def wild_inputs(seed, shapes, radius, jitter, h=2, P=2, d=8, wild=0.1):
    """``grid_inputs`` in q-minor layout, x, y, w each (1, h, L, P, K)
    fp32, with a share ``wild`` of the taps moved 8-12 px from their
    anchor (on the target level, in a random direction)."""
    rng = np.random.default_rng(seed)
    value, loc, w = grid_inputs(rng, shapes, num_heads=h, head_dims=d, P=P, radius=radius, jitter=jitter)
    size = np.asarray([[ww, hh] for hh, ww in shapes], np.float32)[:, None, :]  # (L, P, xy)
    far = rng.random(loc.shape[:-1]) < wild
    step = rng.uniform(8.0, 12.0, loc.shape) * rng.choice([-1.0, 1.0], loc.shape)
    loc = np.where(far[..., None], loc + step / size, loc).astype(np.float32)
    x, y, ww = (np.ascontiguousarray(np.moveaxis(a, 1, -1)) for a in (loc[..., 0], loc[..., 1], w))
    return value, x, y, ww


def off_grid_lines(coord, size):
    """``coord`` with each tap whose pixel ``coord * size - 0.5`` lies
    within 1e-3 px of a grid line moved 1e-2 px off it: there the one-sided
    derivative of the port (and of the JAX oracle) and the derivative of
    the JAX window sweep's hats differ, and the JAX package's XLA:CPU code
    fuses the multiply-add."""
    px = coord.astype(np.float64) * size - 0.5
    near = np.abs(px - np.round(px)) < 1e-3
    return np.where(near, coord + np.float32(1e-2) / size, coord).astype(np.float32)


def as_torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def as_jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def level_shapes(h, w, strides=(4, 8, 16, 32)):
    """Neck level sizes: ceil division at each stride, then the extra
    stride-2 conv."""
    shapes = [(-(-h // s), -(-w // s)) for s in strides]
    hh, ww = shapes[-1]
    return tuple(shapes + [((hh - 1) // 2 + 1, (ww - 1) // 2 + 1)])


@pytest.mark.parametrize("shapes", [
    level_shapes(768, 1152),
    level_shapes(608, 608),  # ceil-division tails 19 -> 10
    level_shapes(800, 1333),  # 25 -> 13, 42 -> 21
    ((320, 480), (160, 240), (80, 120), (40, 60), (20, 30)),  # the gate's 1280x1920, strides 4..64
], ids=["768x1152", "608x608", "800x1333", "1280x1920"])
def test_pair_anchors_match_jax_axis_plan(shapes):
    """Window cell c of query i is target row anchor(i) + c - (R + 1): the
    port's anchors and R against the JAX ``_AxisPlan`` (which verifies that
    map on its padded, nearest-repeated slab) on every pair and axis, at
    radius 4 and 5; with ``max_window=13`` the cross-level pairs take the
    coarse-pair escape, whose anchors are ``_coarse_pair_xla``'s."""
    for radius in (4, 5):
        for max_window, escape in ((31, False), (13, True)):
            plans = msda_grid.pair_plans(shapes, radius, max_window)
            for lq, (Hq, Wq) in enumerate(shapes):
                for lt, (Ht, Wt) in enumerate(shapes):
                    plan = plans[lq][lt]
                    coarse = escape and lq != lt
                    assert plan.coarse == coarse
                    assert plan.R == radius + (0 if lq == lt else 2)
                    for nq, nt, anchors in ((Hq, Ht, plan.anchor_y), (Wq, Wt, plan.anchor_x)):
                        i = np.arange(nq)
                        if coarse:
                            want = np.floor((i + 0.5) * (nt / nq) - 0.5).astype(np.int64)
                            np.testing.assert_array_equal(anchors, want)
                            continue
                        ap = _AxisPlan(nq, nt, plan.R)
                        for c in range(plan.W):
                            u = ap.sigma_i * i + ap.sigma_d * c + ap.s0
                            np.testing.assert_array_equal(u // ap.repeat - ap.pad, anchors + c - (plan.R + 1))


def test_shift_function_matches_pallas_kernel_in_interpret_mode():
    """The truncated function (no envelope correction, wild taps) against
    the JAX Pallas kernel in interpret mode, at ``max_window=5``: the
    same-level pairs (W = 5) run the ``pallas_call`` and the cross-level
    ones (W = 9) the coarse-pair escape ``_coarse_pair_xla``, so both
    anchor modes are checked."""
    shapes = ((8, 8), (4, 4))
    value, x, y, w = wild_inputs(0, shapes, radius=1, jitter=2.5)
    got = msda_grid.msda_grid_shift_qm(*as_torch(value), shapes, *as_torch(x, y, w), radius=1, max_window=5)
    want = msda_pallas.msda_grid_pallas_qm(*as_jax(value), shapes, *as_jax(x, y, w), radius=1,
                                           max_window=5, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    plans = msda_grid.pair_plans(shapes, 1, 5)
    assert [[p.coarse for p in row] for row in plans] == [[False, True], [True, False]]


TWIN_CASES = [
    (((8, 6), (4, 3), (2, 2)), 2),  # ceil-division pyramid
    (((6, 10), (3, 5)), 3),  # non-square
]


@pytest.mark.parametrize("shapes,radius", TWIN_CASES)
def test_shift_function_matches_xla_twin(shapes, radius):
    """``max_window=None`` against the JAX ``msda_grid_shift_qm``, with
    jitter past the window's edge (taps that straddle it keep their inside
    corners) and wild taps."""
    value, x, y, w = wild_inputs(1, shapes, radius, jitter=radius + 1.5)
    got = msda_grid.msda_grid_shift_qm(*as_torch(value), shapes, *as_torch(x, y, w),
                                       radius=radius, max_window=None)
    want = jax_msda_grid_shift_qm(*as_jax(value), shapes, *as_jax(x, y, w), radius=radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("max_window", [None, 31, 5])
def test_envelope_mask_matches_jax(max_window):
    shapes = ((8, 6), (4, 3), (2, 2))
    _, x, y, _ = wild_inputs(2, shapes, radius=2, jitter=3.5)
    got = msda_grid.envelope_mask(shapes, *as_torch(x, y), radius=2, max_window=max_window)
    want = jax_envelope_mask(shapes, *as_jax(x, y), radius=2, max_window=max_window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < (~got).sum() < got.numel()  # taps on both sides of the envelope


@pytest.mark.parametrize("shapes,radius", TWIN_CASES)
def test_corrected_dispatch_matches_jax_grid_and_oracle(shapes, radius):
    """``msda_grid_qm(impl="grid")`` and ``"grid_pallas"`` with wild taps
    against the JAX ``msda_grid_qm(impl="grid")`` and the exact oracle; the
    out-of-envelope count is kept."""
    value, x, y, w = wild_inputs(3, shapes, radius, jitter=radius + 1.0)
    want = jax_msda_grid_qm(*as_jax(value), shapes, *as_jax(x, y, w), impl="grid", radius=radius)
    oracle = msda_reference_qm(*as_jax(value), shapes, *as_jax(x, y, w))
    mask = jax_envelope_mask(shapes, *as_jax(x, y), radius=radius)
    for impl in ("grid", "grid_pallas"):
        got = port_msda.msda_grid_qm(*as_torch(value), shapes, *as_torch(x, y, w), impl=impl, radius=radius)
        assert port_msda.last_out_of_envelope == int((~np.asarray(mask)).sum()) > 0
        for ref in (want, oracle):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_grid_pallas_dispatch_matches_jax_interpret(monkeypatch):
    """The one JAX ``impl="grid_pallas"`` call (its Pallas kernel in
    interpret mode, as ``tests/test_msda_grid.py`` runs it), with wild
    taps, against the port's and the oracle."""
    shapes = ((8, 8),)
    value, x, y, w = wild_inputs(4, shapes, radius=1, jitter=2.0, wild=0.2)
    monkeypatch.setattr(msda_pallas, "msda_grid_pallas_qm",
                        functools.partial(msda_pallas.msda_grid_pallas_qm, interpret=True))
    want = jax_msda_grid_qm(*as_jax(value), shapes, *as_jax(x, y, w), impl="grid_pallas", radius=1)
    got = port_msda.msda_grid_qm(*as_torch(value), shapes, *as_torch(x, y, w), impl="grid_pallas", radius=1)
    assert port_msda.last_out_of_envelope > 0
    oracle = msda_reference_qm(*as_jax(value), shapes, *as_jax(x, y, w))
    for ref in (want, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["grid", "grid_pallas"])
def test_grid_gradients_match_jax_grid_vjp(impl):
    """The port's grid impls on the CPU (autograd through the plain window
    function and the exact correction) against ``jax.vjp`` of the JAX
    ``msda_grid_qm(impl="grid")`` (AD through its window sweep and its
    oracle correction), taps moved off grid lines.  The JAX
    ``"grid_pallas"`` takes the oracle's VJP for its window part instead;
    on in-envelope taps off grid lines the two derivatives agree, so this
    one reference stands for both."""
    shapes = ((8, 8), (4, 4))
    value, x, y, w = wild_inputs(5, shapes, radius=1, jitter=2.0)
    sx = np.asarray([ww for _, ww in shapes], np.float32)[None, None, :, None, None]
    sy = np.asarray([hh for hh, _ in shapes], np.float32)[None, None, :, None, None]
    x, y = off_grid_lines(x, sx), off_grid_lines(y, sy)
    g = np.random.default_rng(6).standard_normal((1, value.shape[1], value.shape[2] * value.shape[3]))
    g = g.astype(np.float32)
    leaves = [t.clone().requires_grad_() for t in as_torch(value, x, y, w)]
    port_msda.msda_grid_qm(leaves[0], shapes, *leaves[1:], impl=impl, radius=1).backward(torch.from_numpy(g))
    want = jax.vjp(lambda *a: jax_msda_grid_qm(a[0], shapes, *a[1:], impl="grid", radius=1),
                   *as_jax(value, x, y, w))[1](jnp.asarray(g))
    for t, wt in zip(leaves, want):
        assert_close_to_scale(t.grad.numpy(), wt)


def test_cuda_routes_launch_the_shift_kernel_and_its_correction(monkeypatch):
    """The CUDA route with plain launchers in place of the kernels: the
    corrected dispatch launches the shift kernel once and the q-minor
    kernel once for its correction when taps lie outside the envelope, and
    the shift kernel alone when none does; the shift kernel's gradient is
    the backward kernel's (the untruncated function's VJP), one launch."""
    def fake_shift(v, sh, xx, yy, ww, radius, max_window):
        port_msda.launches_shift += 1
        return msda_grid.msda_shift_plain(v, sh, xx, yy, ww, radius, max_window)

    def fake_qm(v, sh, xx, yy, ww):
        port_msda.launches_qm += 1
        return port_msda.msda_reference_qm(v, sh, xx, yy, ww)

    def fake_qm_bwd(v, sh, xx, yy, ww, g):
        port_msda.launches_bwd += 1
        grads = port_msda.msda_backward_plain(v, sh, *(a.permute(0, 4, 1, 2, 3) for a in (xx, yy, ww)), g)
        return (grads[0], *(a.permute(0, 2, 3, 4, 1) for a in grads[1:]))

    monkeypatch.setattr(port_msda, "_route", lambda t: "cuda")
    monkeypatch.setattr(msda_grid, "_launch_shift", fake_shift)
    monkeypatch.setattr(port_msda, "_launch_qm", fake_qm)
    monkeypatch.setattr(port_msda, "_launch_qm_bwd", fake_qm_bwd)
    shapes = ((8, 8), (4, 4))
    for wild, want_launches in ((0.1, (1, 1)), (0.0, (1, 0))):
        value, x, y, w = as_torch(*wild_inputs(7, shapes, radius=2, jitter=1.5, wild=wild))
        for name in ("launches_shift", "launches_qm", "launches_bwd"):
            monkeypatch.setattr(port_msda, name, 0)
        got = port_msda.msda_grid_qm(value, shapes, x, y, w, impl="grid_pallas", radius=2)
        assert (port_msda.launches_shift, port_msda.launches_qm) == want_launches
        assert (port_msda.last_out_of_envelope > 0) == (wild > 0)
        assert_close_to_scale(got.numpy(), port_msda.msda_reference_qm(value, shapes, x, y, w).numpy())

    leaves = [t.clone().requires_grad_() for t in (value, x, y, w)]
    out = msda_grid._ShiftMSDA.apply(*leaves, shapes, 2, 31)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(out.shape).astype(np.float32))
    out.backward(g)
    assert port_msda.launches_bwd == 1
    want = fake_qm_bwd(value, shapes, x, y, w, g)
    for leaf, wt in zip(leaves, want):
        assert_close_to_scale(leaf.grad.numpy(), wt.numpy(), rtol=1e-6)


def test_grid_impl_options_and_checks():
    """``"win"`` is the TPU kernel's own envelope: corrected it is
    ``"auto"``, unchecked it raises; unknown impls, a grid impl without
    grid queries (the op and the module) and bad envelopes raise."""
    shapes = ((8, 8), (4, 4))
    value, x, y, w = as_torch(*wild_inputs(9, shapes, radius=1, jitter=2.0))
    auto = port_msda.msda_grid_qm(value, shapes, x, y, w)
    torch.testing.assert_close(port_msda.msda_grid_qm(value, shapes, x, y, w, impl="win"), auto, rtol=0, atol=0)
    for kwargs in ({"impl": "win", "envelope": "unchecked"}, {"impl": "pallas"},
                   {"impl": "grid", "envelope": "none"}):
        with pytest.raises(ValueError):
            port_msda.msda_grid_qm(value, shapes, x, y, w, **kwargs)
    loc = torch.stack([x, y], -1).permute(0, 4, 1, 2, 3, 5)
    with pytest.raises(ValueError, match="requires grid queries"):
        port_msda.multi_scale_deformable_attention(value, shapes, loc, w.permute(0, 4, 1, 2, 3), impl="grid")
    with pytest.raises(ValueError, match="requires grid queries"):
        MultiScaleDeformableAttention(MSDAConfig(embed_dims=16, num_levels=2), impl="grid_pallas")


def test_build_codetr_with_grid_pallas_raises_in_both_packages(monkeypatch):
    """The decoder's cross-attention does not take a grid impl: the JAX
    ``build_codetr`` asserts while tracing it (``codetr_tpu/ops/msda.py``'s
    ``requires grid queries``), the port raises ``ValueError`` building it.
    The JAX encoder's Pallas kernel is traced before the decoder is reached;
    a zero stub of its output shape stands in for it (tracing it in
    interpret mode takes ~90 s here and decides nothing)."""
    with pytest.raises(ValueError, match="requires grid queries"):
        build_codetr(tiny_test_config(), device="cpu", msda_impl="grid_pallas")
    monkeypatch.setattr(msda_pallas, "msda_grid_pallas_qm", lambda v, s, x, y, w, radius: jnp.zeros(
        (v.shape[0], v.shape[1], v.shape[2] * v.shape[3]), v.dtype))
    with pytest.raises(AssertionError, match="requires grid queries"):
        jax_build_codetr(jax_tiny_test_config(), msda_impl="grid_pallas", input_shape=(64, 64))


E, HEADS, POINTS = 32, 4, 2
SHAPES = ((8, 8), (4, 4))
K = sum(a * b for a, b in SHAPES)


def encoder_inputs(seed):
    """Query, positions and a padding mask (bs 1, K keys) and the encoder's
    per-level reference points (1, K, L, 2) at valid ratios below 1."""
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((1, K, E)).astype(np.float32)
    pos = rng.standard_normal((1, K, E)).astype(np.float32)
    mask = np.zeros((1, K), bool)
    mask[0, rng.choice(K, K // 6, replace=False)] = True
    vr = torch.tensor([[[0.875, 0.75], [0.9, 0.8]]])  # (bs, L, 2) wh
    ref = get_reference_points(SHAPES, vr)[:, :, None, :] * vr[:, None]
    return query, pos, mask, np.ascontiguousarray(ref.numpy())


def perturbed(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + scale * rng.standard_normal(a.shape).astype(np.float32), params)


@pytest.mark.parametrize("grid_radius", [1, 2])
def test_grid_pallas_module_matches_jax(grid_radius):
    """The port's ``MultiScaleDeformableAttention(impl="grid_pallas",
    grid_queries=True)`` against the JAX module with ``impl="grid"`` (the
    same function: the coarse-pair escape needs radius 13 or more), weights
    carried, 1e-4 relative; and the port's ``"auto"`` module on the same
    weights within 1e-5 relative (the corrected dispatch is exact)."""
    jcfg = JaxMSDAConfig(embed_dims=E, num_heads=HEADS, num_levels=len(SHAPES), num_points=POINTS)
    query, pos, mask, ref = encoder_inputs(10 + grid_radius)
    jmod = JaxMSDA(cfg=jcfg, impl="grid", grid_queries=True, grid_radius=grid_radius)
    params = perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(query), reference_points=jnp.asarray(ref),
                                 spatial_shapes=SHAPES), grid_radius, 0.3)
    want = jmod.apply(params, jnp.asarray(query), query_pos=jnp.asarray(pos), key_padding_mask=jnp.asarray(mask),
                      reference_points=jnp.asarray(ref), spatial_shapes=SHAPES)
    out = _Out()
    out.msda("m", params["params"])
    sd = {k[2:]: torch.from_numpy(v) for k, v in out.sd.items()}
    cfg = MSDAConfig(embed_dims=E, num_heads=HEADS, num_levels=len(SHAPES), num_points=POINTS)
    args = (*as_torch(query, query, pos, mask, ref), SHAPES)
    outs = {}
    for impl in ("grid_pallas", "auto"):
        mod = MultiScaleDeformableAttention(cfg, grid_queries=True, impl=impl, grid_radius=grid_radius)
        mod.load_state_dict(sd)
        with torch.no_grad():
            outs[impl] = mod(*args).numpy()
    assert port_msda.last_out_of_envelope > 0  # the correction ran
    assert_close_to_scale(outs["grid_pallas"], want, rtol=1e-4)
    assert_close_to_scale(outs["grid_pallas"], outs["auto"], rtol=1e-5)


def test_grid_pallas_encoder_layer_matches_jax():
    """One ``DetrTransformerEncoderLayer(msda_impl="grid_pallas")`` against
    the JAX layer with ``msda_impl="grid"``, grid radius 1 (the tiny
    config's 2 levels), weights carried by the checkpoint helpers, 1e-4
    relative."""
    jcfg = jax_tiny_test_config(len(SHAPES)).head.transformer
    jcfg = replace(jcfg, encoder_layer=replace(jcfg.encoder_layer, attn=replace(jcfg.encoder_layer.attn, grid_radius=1)))
    query, pos, mask, ref = encoder_inputs(12)
    jlayer = JaxEncoderLayer(cfg=jcfg, spatial_shapes=SHAPES, msda_impl="grid")
    jargs = as_jax(query, pos, mask, ref)
    params = perturbed(jlayer.init(jax.random.PRNGKey(1), *jargs), 13, 0.3)
    want = jlayer.apply(params, *jargs)[0]
    p, out = params["params"], _Out()
    out.msda("attentions.0", p["self_attn"])
    out.norm("norms.0", p["norm1"])
    out.norm("norms.1", p["norm2"])
    out.ffn("ffns.0", p["ffn"])
    cfg = tiny_test_config(len(SHAPES)).head.transformer
    cfg = replace(cfg, encoder_layer=replace(cfg.encoder_layer, attn=replace(cfg.encoder_layer.attn, grid_radius=1)))
    layer = DetrTransformerEncoderLayer(cfg, msda_impl="grid_pallas")
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in out.sd.items()})
    with torch.no_grad():
        got = layer(*as_torch(query, pos, mask, ref), SHAPES)
    assert port_msda.last_out_of_envelope > 0
    assert_close_to_scale(got.numpy(), want, rtol=1e-4)
