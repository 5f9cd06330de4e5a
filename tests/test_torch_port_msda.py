"""The port's MSDA op, its gradients and the module against the JAX package.

On the CPU the port's entry points run their plain PyTorch version (its
gradient is autograd's); the JAX side runs its exact oracle
``msda_reference_qm``, its production encoder entry
``msda_grid_packed(impl="auto")`` (the Pallas kernel in interpret mode plus
its exactness correction, differentiated through kernel K2 and the
correction tiers), K2 itself (``msda_win_qm_packed_bwd`` in interpret mode)
and the decoder's ``msda_pair_gather``.  The same float32 inputs, made from
a seed with numpy, go to both; locations include far-out taps and taps on
grid lines (see ``agree_with_fused_rounding`` for the gradient tests).
Tolerance: 1e-5 relative to each output's scale (fp32 reassociation only).

The CUDA kernels themselves are held against the plain versions on the card
by ``test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.config import MSDAConfig as JaxMSDAConfig
from codetr_tpu.models.msda_module import MultiScaleDeformableAttention as JaxMSDA
from codetr_tpu.ops.msda import (
    msda_grid_packed as jax_msda_grid_packed,
    msda_pair_gather,
    msda_reference_qm,
)
from codetr_tpu.ops.msda_win import _tile_shape_for_level, pack_coords_qmajor, unpack_coords_qmajor
from codetr_tpu.ops.msda_win_bwd import msda_win_qm_packed_bwd
from codetr_torch.config import MSDAConfig
from codetr_torch.models.msda_module import MultiScaleDeformableAttention
from codetr_torch.ops import msda as port_msda
from codetr_torch.utils.checkpoint import _Out

from test_msda_win_bwd import SHAPES as WIN_SHAPES, _grid_coords
from test_torch_port_cuda import SHAPES, assert_close, assert_within_bf16_rounding, make_inputs, pack

def to_qm(loc, w):
    """Reference layout -> the JAX oracle's q-minor (bs, h, L, P, Q) arrays."""
    return (
        jnp.asarray(np.moveaxis(loc[..., 0], 1, -1)),
        jnp.asarray(np.moveaxis(loc[..., 1], 1, -1)),
        jnp.asarray(np.moveaxis(w, 1, -1)),
    )


@pytest.mark.parametrize("shapes", SHAPES)
def test_packed_matches_jax_oracle_and_win_kernel(shapes):
    rng = np.random.default_rng(len(shapes))
    value, loc, w = make_inputs(rng, shapes)
    P = loc.shape[4]
    HLP = int(np.prod(w.shape[2:]))
    cpk = pack(loc, w, pad_to=-(-3 * HLP // 128) * 128)
    got = port_msda.msda_grid_packed(torch.from_numpy(value), shapes, torch.from_numpy(cpk), P)

    oracle = msda_reference_qm(jnp.asarray(value), shapes, *to_qm(loc, w))
    assert_close(got.numpy(), oracle)
    if len(shapes) <= 3:  # the windowed Pallas kernel, in interpret mode
        win = jax_msda_grid_packed(jnp.asarray(value), shapes, jnp.asarray(cpk), P, impl="auto")
        assert_close(got.numpy(), win)


@pytest.mark.parametrize("shapes", SHAPES[:2])
def test_reference_layout_matches_pair_gather(shapes):
    rng = np.random.default_rng(10 + len(shapes))
    value, loc, w = make_inputs(rng, shapes, num_queries=37)
    got = port_msda.multi_scale_deformable_attention(
        torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(w)
    )
    want = msda_pair_gather(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w))
    assert_close(got.numpy(), want)


def assert_close_to_scale(got, want, rtol=1e-5):
    """Max error relative to the reference's own largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < rtol, f"max err {err:.2e} of scale {np.abs(want).max():.2e}"


def agree_with_fused_rounding(coord, size):
    """``coord`` with each entry whose pixel ``coord * size - 0.5`` floors
    differently when the multiply-add is fused moved to 0.5, the level's
    centre (a grid line for odd sizes, exact under both roundings).  The
    JAX package's XLA:CPU code fuses it; the port rounds the product first,
    as its kernels do.  The two roundings put a tap that sits within an ulp
    of a grid line on either side of it, where the one-sided derivative
    differs; taps that sit exactly on a grid line under both stay."""
    coord = np.array(coord, np.float32)
    size = np.asarray(size, np.float32)
    rounded = np.floor(coord * size - np.float32(0.5))
    fused = np.floor((coord.astype(np.float64) * size - 0.5).astype(np.float32))
    return np.where(rounded != fused, np.float32(0.5), coord)


def jax_safe_inputs(rng, shapes, num_queries=None):
    """``make_inputs`` with its locations passed through
    ``agree_with_fused_rounding``."""
    value, loc, w = make_inputs(rng, shapes, num_queries)
    size = np.asarray([[ww, hh] for hh, ww in shapes], np.float32)[:, None, :]  # (L, P, xy)
    return value, agree_with_fused_rounding(loc, size), w


def port_packed_vjp(value, shapes, cpk, P, g):
    """(grad_value, grad_cpk) of the port's packed entry, by autograd."""
    v, c = (torch.from_numpy(np.array(a)).requires_grad_() for a in (value, cpk))
    port_msda.msda_grid_packed(v, shapes, c, P).backward(torch.from_numpy(g))
    return v.grad.numpy(), c.grad.numpy()


@pytest.mark.parametrize("shapes", SHAPES)
def test_packed_grads_match_jax_oracle_and_production_vjp(shapes):
    rng = np.random.default_rng(40 + len(shapes))
    value, loc, w = jax_safe_inputs(rng, shapes)
    bs, K, h, d = value.shape
    L, P = len(shapes), loc.shape[4]
    HLP = h * L * P
    cpk = pack(loc, w, pad_to=-(-3 * HLP // 128) * 128)
    g = rng.standard_normal((bs, K, h * d)).astype(np.float32)
    got_v, got_c = port_packed_vjp(value, shapes, cpk, P, g)
    assert not got_c[..., 3 * HLP:].any()  # pad columns

    def oracle(v, c):
        return msda_reference_qm(v, shapes, *unpack_coords_qmajor(c, h, L, P))

    want_v, want_c = jax.vjp(oracle, jnp.asarray(value), jnp.asarray(cpk))[1](jnp.asarray(g))
    assert_close_to_scale(got_v, want_v)
    assert_close_to_scale(got_c, want_c)
    if len(shapes) == 2:  # the production dispatch: K2 + coarse + correction VJPs
        prod_v, prod_c = jax.vjp(
            lambda v, c: jax_msda_grid_packed(v, shapes, c, P, impl="auto"),
            jnp.asarray(value), jnp.asarray(cpk),
        )[1](jnp.asarray(g))
        assert_close_to_scale(got_v, prod_v)
        assert_close_to_scale(got_c, prod_c)


def test_packed_grads_match_win_backward_kernel():
    """K2 (``msda_win_qm_packed_bwd``, interpret mode) on in-envelope
    coordinates, a fifth of the taps snapped onto grid lines (those within
    an ulp of one moved as ``agree_with_fused_rounding`` says).  K2 leaves
    the coarse query levels to its caller, so those rows are masked out of
    the coordinate comparison and their upstream gradient is zeroed for the
    value comparison, as the JAX suite's own K2 test does."""
    h, P, d = 4, 2, 16
    shapes, L = WIN_SHAPES, len(WIN_SHAPES)
    K = sum(a * b for a, b in shapes)
    rng = np.random.default_rng(8)
    x, y, w = (np.array(a) for a in _grid_coords(h, P, jit_px=2.0, seed=8))
    size_x = np.asarray([ww for _, ww in shapes], np.float32)[None, None, :, None, None]
    size_y = np.asarray([hh for hh, _ in shapes], np.float32)[None, None, :, None, None]
    on_line = rng.random(x.shape) < 0.2
    x = np.where(on_line, (np.round(x * size_x - 0.5) + 0.5) / size_x, x).astype(np.float32)
    y = np.where(on_line, (np.round(y * size_y - 0.5) + 0.5) / size_y, y).astype(np.float32)
    x, y = agree_with_fused_rounding(x, size_x), agree_with_fused_rounding(y, size_y)
    cpk = np.asarray(pack_coords_qmajor(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), interpret=True))
    value = rng.standard_normal((1, K, h, d)).astype(np.float32)
    g = rng.standard_normal((1, K, h * d)).astype(np.float32)

    keep = np.zeros(K, bool)
    q0 = 0
    for lq, (Hq, Wq) in enumerate(shapes):
        th, tw = _tile_shape_for_level(lq, L)
        keep[q0:q0 + Hq * Wq] = th * tw >= 16
        q0 += Hq * Wq
    g_kept = np.where(keep[None, :, None], g, 0.0).astype(np.float32)
    k2_v, k2_c = msda_win_qm_packed_bwd(jnp.asarray(value), shapes, jnp.asarray(cpk),
                                        jnp.asarray(g_kept), P, radius=5, interpret=True)
    got_v, got_c = port_packed_vjp(value, shapes, cpk, P, g_kept)
    assert_close_to_scale(got_v, k2_v)
    assert_close_to_scale(got_c[0, keep], np.asarray(k2_c)[0, keep])


@pytest.mark.parametrize("shapes", SHAPES[:2])
def test_reference_layout_grads_match_pair_gather_and_oracle(shapes):
    rng = np.random.default_rng(50 + len(shapes))
    value, loc, w = jax_safe_inputs(rng, shapes, num_queries=37)
    g = rng.standard_normal((1, 37, value.shape[2] * value.shape[3])).astype(np.float32)
    got = port_msda.msda_backward_plain(
        torch.from_numpy(value), shapes, *(torch.from_numpy(a) for a in (loc[..., 0], loc[..., 1], w, g)))
    got_v, got_loc, got_w = got[0], torch.stack(got[1:3], -1), got[3]

    pair = jax.vjp(lambda v, lc, a: msda_pair_gather(v, shapes, lc, a),
                   *(jnp.asarray(a) for a in (value, loc, w)))[1](jnp.asarray(g))

    def oracle(v, lc, a):
        x, y, ww = (jnp.moveaxis(t, 1, -1) for t in (lc[..., 0], lc[..., 1], a))
        return msda_reference_qm(v, shapes, x, y, ww)

    exact = jax.vjp(oracle, *(jnp.asarray(a) for a in (value, loc, w)))[1](jnp.asarray(g))
    for want in (pair, exact):
        for t, wt in zip((got_v, got_loc, got_w), want):
            assert_close_to_scale(t.numpy(), wt)


def test_cuda_autograd_functions_route_gradients(monkeypatch):
    """The autograd Functions that wrap the kernels, run here with plain
    launchers in place of the CUDA ones: each input gets the gradient the
    backward launcher returns, and a backward launch is counted per call."""
    shapes = SHAPES[0]
    rng = np.random.default_rng(4)
    value, loc, w = (torch.from_numpy(a) for a in make_inputs(rng, shapes, num_queries=11))

    def fake_reference(v, sh, lc, a):
        return port_msda.multi_scale_deformable_attention_plain(v, sh, lc, a)

    def fake_reference_bwd(v, sh, lc, a, g):
        port_msda.launches_bwd += 1
        gv, gx, gy, gw = port_msda.msda_backward_plain(v, sh, lc[..., 0], lc[..., 1], a, g)
        return gv, torch.stack([gx, gy], -1), gw

    monkeypatch.setattr(port_msda, "_launch_reference", fake_reference)
    monkeypatch.setattr(port_msda, "_launch_reference_bwd", fake_reference_bwd)
    monkeypatch.setattr(port_msda, "launches_bwd", 0)
    leaves = [t.clone().requires_grad_() for t in (value, loc, w)]
    out = port_msda._ReferenceMSDA.apply(*leaves, shapes)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    out.backward(g)
    assert port_msda.launches_bwd == 1
    want = port_msda.msda_backward_plain(value, shapes, loc[..., 0], loc[..., 1], w, g)
    torch.testing.assert_close(leaves[0].grad, want[0], rtol=0, atol=0)
    torch.testing.assert_close(leaves[1].grad, torch.stack(want[1:3], -1), rtol=0, atol=0)
    torch.testing.assert_close(leaves[2].grad, want[3], rtol=0, atol=0)


def test_both_layouts_agree_and_bf16_value_accumulates_in_fp32():
    shapes = SHAPES[0]
    rng = np.random.default_rng(3)
    value, loc, w = make_inputs(rng, shapes)
    v = torch.from_numpy(value)
    packed = port_msda.msda_grid_packed(v, shapes, torch.from_numpy(pack(loc, w)), loc.shape[4])
    ref = port_msda.multi_scale_deformable_attention(
        v, shapes, torch.from_numpy(loc), torch.from_numpy(w)
    )
    torch.testing.assert_close(packed, ref, rtol=0, atol=0)
    vb = v.to(torch.bfloat16)
    got = port_msda.multi_scale_deformable_attention(
        vb, shapes, torch.from_numpy(loc), torch.from_numpy(w)
    )
    assert got.dtype == torch.bfloat16
    want = port_msda.multi_scale_deformable_attention(
        vb.float(), shapes, torch.from_numpy(loc), torch.from_numpy(w)
    )
    assert_within_bf16_rounding(got, want)


def test_wrapper_rejects_bad_inputs():
    shapes = ((4, 4),)
    v = torch.zeros(1, 16, 2, 8)
    cpk = torch.zeros(1, 16, 3 * 2 * 1 * 2)
    with pytest.raises(ValueError):
        port_msda.msda_grid_packed(v, shapes, cpk[..., :-1], 2)
    with pytest.raises(TypeError):
        port_msda.msda_grid_packed(v, shapes, cpk.double(), 2)
    with pytest.raises(ValueError):
        port_msda.msda_grid_packed(v, ((4, 5),), cpk, 2)


def _jax_module_params(cfg, rng, E):
    """The JAX module's own init, with every leaf perturbed by seeded noise
    (its init zeroes the offset and weight projections)."""
    mod = JaxMSDA(cfg=cfg, grid_queries=False, impl="reference")
    shapes = ((2, 2),) * cfg.num_levels
    params = mod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, E), jnp.float32),
        value=jnp.zeros((1, 4 * cfg.num_levels, E), jnp.float32),
        reference_points=jnp.full((1, 3, cfg.num_levels, 2), 0.5, jnp.float32),
        spatial_shapes=shapes,
    )
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params,
    )


@pytest.mark.parametrize("grid_queries", [True, False])
def test_msda_module_matches_jax(grid_queries):
    shapes = SHAPES[0]
    L = len(shapes)
    E, h, P = 32, 4, 2
    jcfg = JaxMSDAConfig(embed_dims=E, num_heads=h, num_levels=L, num_points=P)
    rng = np.random.default_rng(5 if grid_queries else 6)
    params = _jax_module_params(jcfg, rng, E)

    K = sum(hh * ww for hh, ww in shapes)
    nq = K if grid_queries else 23
    query = rng.standard_normal((1, nq, E)).astype(np.float32)
    pos = rng.standard_normal((1, nq, E)).astype(np.float32)
    value = query if grid_queries else rng.standard_normal((1, K, E)).astype(np.float32)
    mask = np.zeros((1, K), bool)
    mask[0, rng.choice(K, K // 5, replace=False)] = True
    if grid_queries:
        ref = rng.uniform(0.0, 1.0, (1, nq, L, 2)).astype(np.float32)
    else:
        ref = np.concatenate(
            [rng.uniform(0.1, 0.9, (1, nq, L, 2)), rng.uniform(0.05, 0.5, (1, nq, L, 2))], axis=-1
        ).astype(np.float32)

    jmod = JaxMSDA(cfg=jcfg, grid_queries=grid_queries, impl="auto")
    want = jmod.apply(
        params, jnp.asarray(query), value=jnp.asarray(value), query_pos=jnp.asarray(pos),
        key_padding_mask=jnp.asarray(mask), reference_points=jnp.asarray(ref),
        spatial_shapes=shapes,
    )

    out = _Out()
    out.msda("m", params["params"])
    mod = MultiScaleDeformableAttention(MSDAConfig(embed_dims=E, num_heads=h, num_levels=L,
                                                   num_points=P), grid_queries=grid_queries)
    mod.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in out.sd.items()})
    with torch.no_grad():
        got = mod(torch.from_numpy(query), torch.from_numpy(value), torch.from_numpy(pos),
                  torch.from_numpy(mask), torch.from_numpy(ref), shapes)
    assert_close(got.numpy(), want, rtol=1e-5)
