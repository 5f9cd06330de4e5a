"""The port's MSDA op, its gradients and the module against the JAX package.

On the CPU the port's entry points run their plain PyTorch version (its
gradient is autograd's); the JAX side runs its exact oracle
``msda_reference_qm``, its production encoder entry
``msda_grid_packed(impl="auto")`` (the Pallas kernel in interpret mode plus
its exactness correction, differentiated through kernel K2 and the
correction tiers), K2 itself (``msda_win_qm_packed_bwd`` in interpret mode),
the q-minor entry ``msda_grid_qm(impl="auto")`` (K3 in interpret mode plus
its correction, differentiated through the pair-gather VJP), K3 through
``msda_win_qm`` on in-envelope taps, and the decoder's ``msda_pair_gather``.  The same float32 inputs, made from
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
    msda_grid_qm as jax_msda_grid_qm,
    msda_pair_gather,
    msda_reference_qm,
    multi_scale_deformable_attention as jax_multi_scale_deformable_attention,
)
from codetr_tpu.ops.msda_win import (
    _tile_shape_for_level,
    msda_win_qm,
    pack_coords_qmajor,
    unpack_coords_qmajor,
    win_envelope_mask,
)
from codetr_tpu.ops.msda_win_bwd import msda_win_qm_packed_bwd
from codetr_torch import bench as port_bench
from codetr_torch.config import MSDAConfig
from codetr_torch.models.msda_module import MultiScaleDeformableAttention
from codetr_torch.ops import msda as port_msda
from codetr_torch.utils.checkpoint import _Out

from test_msda_grid import grid_inputs
from test_msda_win_bwd import SHAPES as WIN_SHAPES, _grid_coords
from test_torch_port_cuda import SHAPES, assert_close, assert_within_bf16_rounding, make_inputs, pack
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

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
    """The gradients registered on the ``codetr::`` custom ops, run here
    with the card's route taken and plain launchers in place of the CUDA
    ones: each input of the reference-layout and the packed op gets the
    gradient the backward launcher returns, and a backward launch is
    counted per call."""
    shapes = SHAPES[0]
    rng = np.random.default_rng(4)
    value, loc, w = (torch.from_numpy(a) for a in make_inputs(rng, shapes, num_queries=11))

    def fake_reference_bwd(v, sh, lc, a, g):
        port_msda.launches_bwd += 1
        gv, gx, gy, gw = port_msda.msda_backward_plain(v, sh, lc[..., 0], lc[..., 1], a, g)
        return gv, torch.stack([gx, gy], -1), gw

    def fake_packed_bwd(v, sh, cpk, P, g):
        port_msda.launches_bwd += 1
        grads = port_msda.msda_backward_plain(v, sh, *port_msda._unpack(cpk, v.shape[2], len(sh), P), g)
        gcpk = torch.cat([t.reshape(*cpk.shape[:2], -1) for t in grads[1:]], -1)
        return grads[0], torch.nn.functional.pad(gcpk, (0, cpk.shape[2] - gcpk.shape[2]))

    monkeypatch.setattr(port_msda, "_route", lambda t: "cuda")
    monkeypatch.setattr(port_msda, "_launch_reference_bwd", fake_reference_bwd)
    monkeypatch.setattr(port_msda, "_launch_packed_bwd", fake_packed_bwd)
    monkeypatch.setattr(port_msda, "launches_bwd", 0)
    leaves = [t.clone().requires_grad_() for t in (value, loc, w)]
    out = port_msda.multi_scale_deformable_attention(*leaves[:1], shapes, *leaves[1:])
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    out.backward(g)
    assert port_msda.launches_bwd == 1
    want = port_msda.msda_backward_plain(value, shapes, loc[..., 0], loc[..., 1], w, g)
    torch.testing.assert_close(leaves[0].grad, want[0], rtol=0, atol=0)
    torch.testing.assert_close(leaves[1].grad, torch.stack(want[1:3], -1), rtol=0, atol=0)
    torch.testing.assert_close(leaves[2].grad, want[3], rtol=0, atol=0)

    gvalue, gloc, gw = make_inputs(rng, shapes)
    P = gloc.shape[4]
    cpk = torch.from_numpy(pack(gloc, gw, pad_to=3 * gw[0, 0].size + 5)).requires_grad_()
    v = torch.from_numpy(gvalue).requires_grad_()
    out = port_msda.msda_grid_packed(v, shapes, cpk, P)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    out.backward(g)
    assert port_msda.launches_bwd == 2
    want_v, want_cpk = fake_packed_bwd(v.detach(), shapes, cpk.detach(), P, g)
    # the plain backward's accumulation into the value rows runs in parallel
    # on the CPU (its order, and the last bit, vary between two calls)
    torch.testing.assert_close(v.grad, want_v)
    torch.testing.assert_close(cpk.grad, want_cpk, rtol=0, atol=0)
    assert not cpk.grad[..., -5:].any()


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


def qm_arrays(loc, w):
    """Reference layout -> contiguous q-minor (bs, h, L, P, Q) numpy x, y, w."""
    return tuple(np.ascontiguousarray(np.moveaxis(a, 1, -1)) for a in (loc[..., 0], loc[..., 1], w))


def port_qm(value, shapes, x, y, w):
    return port_msda.msda_grid_qm(*(torch.from_numpy(np.asarray(a)) for a in (value,)), shapes,
                                  *(torch.from_numpy(np.asarray(a)) for a in (x, y, w)))


@pytest.mark.parametrize("shapes,radius,jitter", [
    (((8, 8), (4, 4), (2, 2)), 4, 3.0),
    (((6, 10), (3, 5)), 4, 3.0),
    (((19, 13), (10, 7), (5, 4)), 4, 3.0),
    (((8, 8),), 3, 2.0),
])
def test_qm_matches_win_kernel_in_envelope(shapes, radius, jitter):
    """K3 (``msda_win_qm``, interpret mode) on the taps inside its window
    envelope (the others' weights zeroed), the shapes of the JAX suite's
    own K3 test; the finest level's 16x16 query tiles run K3's
    ``pallas_call``, not the coarse-level gather fallback."""
    assert np.prod(_tile_shape_for_level(0, len(shapes))) >= 16
    rng = np.random.default_rng(0)
    value, loc, w = grid_inputs(rng, shapes, radius=radius, jitter=jitter)
    x, y, attw = qm_arrays(loc, w)
    mask = win_envelope_mask(shapes, jnp.asarray(x), jnp.asarray(y), radius=radius)
    w_in = np.where(np.asarray(mask), attw, 0).astype(np.float32)
    want = msda_win_qm(jnp.asarray(value), shapes, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w_in),
                       radius=radius, interpret=True)
    assert_close(port_qm(value, shapes, x, y, w_in).numpy(), want)
    ref = port_msda.msda_reference_qm(*(torch.from_numpy(a) for a in (value,)), shapes,
                                      *(torch.from_numpy(a) for a in (x, y, w_in)))
    assert_close(ref.numpy(), want)


@pytest.mark.parametrize("shapes", SHAPES[:2])
def test_qm_matches_jax_auto_dispatch(shapes):
    """Arbitrary offsets (far-out and grid-line taps): K3 plus its
    out-of-envelope correction on the JAX side."""
    rng = np.random.default_rng(60 + len(shapes))
    value, loc, w = make_inputs(rng, shapes)
    x, y, attw = qm_arrays(loc, w)
    want = jax_msda_grid_qm(jnp.asarray(value), shapes, *(jnp.asarray(a) for a in (x, y, attw)), impl="auto")
    assert_close(port_qm(value, shapes, x, y, attw).numpy(), want)
    ref = port_msda.msda_reference_qm(torch.from_numpy(value), shapes,
                                      *(torch.from_numpy(a) for a in (x, y, attw)))
    assert_close(ref.numpy(), want)


@pytest.mark.parametrize("shapes", SHAPES[:2])
def test_qm_grads_match_jax_auto_vjp(shapes):
    """The gradient in the value, x, y and w (q-minor) against ``jax.vjp``
    of ``msda_grid_qm(impl="auto")``; taps within an ulp of a grid line
    moved as ``agree_with_fused_rounding`` says."""
    rng = np.random.default_rng(70 + len(shapes))
    value, loc, w = jax_safe_inputs(rng, shapes)
    x, y, attw = qm_arrays(loc, w)
    g = rng.standard_normal((1, value.shape[1], value.shape[2] * value.shape[3])).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (value, x, y, attw)]
    port_msda.msda_grid_qm(leaves[0], shapes, *leaves[1:]).backward(torch.from_numpy(g))
    want = jax.vjp(lambda *a: jax_msda_grid_qm(a[0], shapes, *a[1:], impl="auto"),
                   *(jnp.asarray(a) for a in (value, x, y, attw)))[1](jnp.asarray(g))
    for t, wt in zip(leaves, want):
        assert_close_to_scale(t.grad.numpy(), wt)


def test_grid_queries_entry_matches_jax():
    """``multi_scale_deformable_attention(grid_queries=True)``, which moves
    the locations to q-minor for ``msda_grid_qm``, against the JAX entry;
    its gradient in the reference layout equals the plain path's."""
    shapes = SHAPES[0]
    rng = np.random.default_rng(80)
    value, loc, w = jax_safe_inputs(rng, shapes)
    want = jax_multi_scale_deformable_attention(
        *(jnp.asarray(a) for a in (value, )), shapes, jnp.asarray(loc), jnp.asarray(w), grid_queries=True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (value, loc, w)]
    got = port_msda.multi_scale_deformable_attention(leaves[0], shapes, *leaves[1:], grid_queries=True)
    assert_close(got.detach().numpy(), want)
    g = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    got.backward(g)
    plain = port_msda.msda_backward_plain(leaves[0].detach(), shapes, *(torch.from_numpy(a) for a in (
        loc[..., 0], loc[..., 1], w)), g)
    # the value gradient is a scatter-add, whose order varies between runs
    # on a multi-threaded CPU
    assert_close_to_scale(leaves[0].grad.numpy(), plain[0].numpy(), rtol=1e-6)
    torch.testing.assert_close(leaves[1].grad, torch.stack(plain[1:3], -1), rtol=0, atol=0)
    torch.testing.assert_close(leaves[2].grad, plain[3], rtol=0, atol=0)


def test_qm_autograd_function_routes_gradients(monkeypatch):
    """``_QmMSDA`` run with plain launchers in place of the CUDA ones: each
    input gets the q-minor gradient the backward launcher returns (the
    value gradient to 1e-6 of its scale: the plain backward's scatter-add
    order varies between runs on a multi-threaded CPU), and one backward
    launch is counted."""
    shapes = SHAPES[0]
    rng = np.random.default_rng(9)
    value, loc, w = make_inputs(rng, shapes)
    value = torch.from_numpy(value)
    x, y, attw = (torch.from_numpy(a) for a in qm_arrays(loc, w))

    def fake_qm_bwd(v, sh, xx, yy, ww, g):
        port_msda.launches_bwd += 1
        grads = port_msda.msda_backward_plain(v, sh, *(a.permute(0, 4, 1, 2, 3) for a in (xx, yy, ww)), g)
        return (grads[0], *(a.permute(0, 2, 3, 4, 1) for a in grads[1:]))

    monkeypatch.setattr(port_msda, "_launch_qm",
                        lambda v, sh, xx, yy, ww: port_msda.msda_reference_qm(v, sh, xx, yy, ww))
    monkeypatch.setattr(port_msda, "_launch_qm_bwd", fake_qm_bwd)
    monkeypatch.setattr(port_msda, "launches_bwd", 0)
    leaves = [t.clone().requires_grad_() for t in (value, x, y, attw)]
    out = port_msda._QmMSDA.apply(*leaves, shapes)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    out.backward(g)
    assert port_msda.launches_bwd == 1
    want = fake_qm_bwd(value, shapes, x, y, attw, g)
    assert_close_to_scale(leaves[0].grad.numpy(), want[0].numpy(), rtol=1e-6)
    for leaf, wt in zip(leaves[1:], want[1:]):
        torch.testing.assert_close(leaf.grad, wt, rtol=0, atol=0)


def test_qm_pack_and_wrapper_checks():
    """The q-minor <-> packed copies agree with the JAX package's (no pad
    columns), and the q-minor entry rejects what it does not take."""
    rng = np.random.default_rng(11)
    x, y, w = (rng.random((2, 4, 3, 2, 30)).astype(np.float32) for _ in range(3))
    cpk = port_msda.pack_coords_qmajor(*(torch.from_numpy(a) for a in (x, y, w)))
    want = pack_coords_qmajor(*(jnp.asarray(a) for a in (x, y, w)), interpret=True)
    np.testing.assert_array_equal(cpk.numpy(), np.asarray(want))
    for got, a in zip(port_msda.unpack_coords_qmajor(cpk, 4, 3, 2), (x, y, w)):
        np.testing.assert_array_equal(got.numpy(), a)

    shapes = ((5, 6),)
    v = torch.zeros(2, 30, 4, 8)
    xt = torch.zeros(2, 4, 1, 2, 30)
    with pytest.raises(ValueError):  # not grid queries: Q != K
        port_msda.msda_grid_qm(v, shapes, xt[..., :29], xt[..., :29], xt[..., :29])
    with pytest.raises(ValueError):
        port_msda.msda_grid_qm(v, shapes, xt, xt, xt[:, :, :, :1])
    with pytest.raises(TypeError):
        port_msda.msda_grid_qm(v, shapes, xt, xt.double(), xt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_gate_inputs_through_jax(dtype):
    """The on-card gate's inputs (``bench.verify_inputs``, here at 48x64 on
    the CPU) through the JAX oracle and the port's q-minor entry; the gate
    itself passes on the CPU's plain versions."""
    value, shapes, x, y, w = port_bench.verify_inputs(48, 64, torch.float32, device="cpu")
    assert shapes == ((12, 16), (6, 8), (3, 4), (2, 2), (1, 1))
    want = msda_reference_qm(jnp.asarray(value.numpy()), shapes, *(jnp.asarray(a.numpy()) for a in (x, y, w)))
    assert_close(port_msda.msda_grid_qm(value, shapes, x, y, w).numpy(), want)
    errs = port_bench.verify_msda_on_card(48, 64, dtype, device="cpu")
    assert errs["max_abs_err"] == errs["max_abs_err_packed"] == 0.0
    assert 0.01 < errs["mean_abs_out"] < 1.0
