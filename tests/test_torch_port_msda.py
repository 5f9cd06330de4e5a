"""The port's MSDA op and module against the JAX package.

On the CPU the port's entry points run their plain PyTorch version; the JAX
side runs its exact oracle ``msda_reference_qm``, its production encoder
entry ``msda_grid_packed(impl="auto")`` (the Pallas kernel in interpret mode
plus its exactness correction) and the decoder's ``msda_pair_gather``.  The
same float32 inputs, made from a seed with numpy, go to both.  Tolerance:
1e-5 relative to the output's scale (fp32 reassociation only).

The CUDA kernel itself is held against the plain version on the card by
``test_torch_port_cuda.py``.
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
from codetr_torch.config import MSDAConfig
from codetr_torch.models.msda_module import MultiScaleDeformableAttention
from codetr_torch.ops import msda as port_msda
from codetr_torch.utils.checkpoint import _Out

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
