"""The decoder's shared raw-memory corner table (``codetr_torch/ops/
msda_dectab.py``, the module's ``raw_table`` path and
``DinoTransformerDecoder(dectab=True)``) against the JAX package's
(``codetr_tpu/ops/msda_dectab.py`` and its callers), at the JAX test's
shapes (levels (8, 8), (4, 4), (2, 2); embed 32, 4 heads, 2 points):

- the table bit for bit (pure data movement), fp32 and bf16, also with
  levels of width or height 1 (the row-start clamp);
- ``msda_from_raw_table`` against the JAX one and against the plain
  version (the direct interpolation, heads folded into the queries) at
  rtol 1e-5, atol 1e-6, locations in [-0.05, 1.05];
- the module's table path against the JAX module's, the weights carried by
  the port's converter (``utils/checkpoint._Out``), with and without a
  non-rectangular key mask, 1e-5; and against the port's own gather path
  (linearity of the sampling);
- the tiny decoder with ``dectab=True`` against the JAX
  ``DinoTransformerDecoder(dectab=True)`` on the ladder (states and refined
  references 1e-4 relative), and against its own ``dectab=False`` run.

The JAX modules' params are seeded from their ``jax.eval_shape``d init
(``seeded_params``): compiling the scanned decoder's init alone takes ~10 s.
Their applies are jitted, one compile each (the module's shared by the mask
cases), which costs about half of running them op by op.
The port runs in one thread (``one_thread``): at these sizes its ops cost
more in thread synchronisation than they gain from more threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.config import MSDAConfig as JaxMSDAConfig
from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.models.msda_module import MultiScaleDeformableAttention as JaxMSDA
from codetr_tpu.models.transformer import DinoTransformerDecoder as JaxDecoder
from codetr_tpu.ops import msda_dectab as jax_dectab
from codetr_torch.config import MSDAConfig, tiny_test_config
from codetr_torch.models.layers import mlp
from codetr_torch.models.msda_module import MultiScaleDeformableAttention
from codetr_torch.models.transformer import DinoTransformerDecoder
from codetr_torch.ops import msda_dectab
from codetr_torch.utils import checkpoint

SHAPES = ((8, 8), (4, 4), (2, 2))
THIN = ((5, 1), (1, 4), (1, 1))  # a level one pixel wide, one high, and both
E, HEADS, POINTS = 32, 4, 2


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def keys(shapes):
    return sum(h * w for h, w in shapes)


def mem_aug_of(rng, shapes, bs=2, channels=E, mask=None):
    memory = rng.standard_normal((bs, keys(shapes), channels)).astype(np.float32)
    if mask is None:
        mask = np.zeros((bs, keys(shapes)), bool)
    unmask = 1.0 - mask.astype(np.float32)
    return np.concatenate([memory * unmask[..., None], unmask[..., None]], axis=-1)


def bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.view(torch.int32).numpy()


@pytest.mark.parametrize("shapes", [SHAPES, THIN], ids=["levels", "thin-levels"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_matches_jax_bit_for_bit(shapes, dtype):
    aug = mem_aug_of(np.random.default_rng(0), shapes)
    got = msda_dectab.build_raw_quad_table(torch.from_numpy(aug).to(getattr(torch, dtype)), shapes)
    want = jax_dectab.build_raw_quad_table(jnp.asarray(aug, getattr(jnp, dtype)), shapes)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    want_bits = np.asarray(want).view(np.int16 if dtype == "bfloat16" else np.int32)
    np.testing.assert_array_equal(bits(got), want_bits)


@pytest.mark.parametrize("shapes", [SHAPES, THIN], ids=["levels", "thin-levels"])
def test_from_raw_table_matches_jax_and_plain(shapes):
    rng = np.random.default_rng(1)
    bs, Q, L, Cm = 1, 7, len(shapes), 8
    aug = mem_aug_of(rng, shapes, bs=bs, channels=Cm)
    loc = rng.uniform(-0.05, 1.05, (bs, Q, 3, L, POINTS, 2)).astype(np.float32)
    attw = rng.uniform(0, 1, (bs, Q, 3, L, POINTS)).astype(np.float32)
    table = jax_dectab.build_raw_quad_table(jnp.asarray(aug), shapes)
    want = np.asarray(jax_dectab.msda_from_raw_table(table, shapes, jnp.asarray(loc), jnp.asarray(attw)))
    t_aug, t_loc, t_attw = (torch.from_numpy(a) for a in (aug, loc, attw))
    got = msda_dectab.msda_from_raw_table(msda_dectab.build_raw_quad_table(t_aug, shapes), shapes, t_loc, t_attw)
    plain = msda_dectab.msda_from_raw_table_plain(t_aug, shapes, t_loc, t_attw)
    assert got.dtype == torch.float32 and got.shape == (bs, Q, 3, Cm + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-6)


def module_inputs(rng, with_mask, bs=2, Q=11):
    query = rng.standard_normal((bs, Q, E)).astype(np.float32)
    memory = rng.standard_normal((bs, keys(SHAPES), E)).astype(np.float32)
    # non-rectangular: the indicator channel carries the bias at masked keys
    mask = rng.uniform(size=(bs, keys(SHAPES))) < 0.3 if with_mask else np.zeros((bs, keys(SHAPES)), bool)
    # 4-dim references (the decoder's boxes), some near the edges so corners drop
    ref = rng.uniform(0.0, 1.0, (bs, Q, len(SHAPES), 4)).astype(np.float32)
    return query, memory, mask, ref


def seeded_params(init, rng):
    """A flax module's params of the shapes ``init`` would make (traced by
    ``jax.eval_shape``, not compiled): kernels N(0, 1/fan_in), norm scales
    1 + N(0, 0.05^2), every other leaf N(0, 0.05^2); none at its zero init."""
    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return noise / np.float32(np.sqrt(s.shape[-2]))
        return np.float32(name == "scale") + np.float32(0.05) * noise

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))


def port_module(params):
    out = checkpoint._Out()
    out.msda("m", params["params"])
    mod = MultiScaleDeformableAttention(MSDAConfig(embed_dims=E, num_heads=HEADS, num_levels=len(SHAPES),
                                                   num_points=POINTS))
    mod.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in out.sd.items()})
    return mod


def jax_table(memory, mask):
    """The JAX decoder's table of (memory, key mask)."""
    unmask = 1.0 - jnp.asarray(mask, jnp.float32)
    return jax_dectab.build_raw_quad_table(
        jnp.concatenate([jnp.asarray(memory) * unmask[..., None], unmask[..., None]], -1), SHAPES)


@pytest.fixture(scope="module")
def jax_module():
    """The JAX module's seeded params and one jitted apply of its table
    path (the table built inside), shared by the mask cases: one compile."""
    jmod = JaxMSDA(cfg=JaxMSDAConfig(embed_dims=E, num_heads=HEADS, num_levels=len(SHAPES), num_points=POINTS),
                   impl="auto")
    rng = np.random.default_rng(2)
    query, memory, mask, ref = (jnp.asarray(a) for a in module_inputs(rng, True))
    params = seeded_params(
        lambda: jmod.init(jax.random.PRNGKey(0), query, memory, None, None, mask, ref, SHAPES,
                          jax_table(memory, mask)), rng)
    apply = jax.jit(lambda p, q, m, k, r: jmod.apply(p, q, m, None, None, k, r, SHAPES, jax_table(m, k)))
    return params, apply


@pytest.mark.parametrize("with_mask", [False, True])
def test_module_table_path_matches_jax(jax_module, with_mask):
    params, apply = jax_module
    query, memory, mask, ref = module_inputs(np.random.default_rng(2), with_mask)
    want = np.asarray(apply(params, *(jnp.asarray(a) for a in (query, memory, mask, ref))))

    mod = port_module(params)
    t_mem, t_mask = torch.from_numpy(memory), torch.from_numpy(mask)
    t_table = msda_dectab.build_raw_quad_table(msda_dectab.raw_memory_aug(t_mem, t_mask), SHAPES)
    np.testing.assert_array_equal(t_table.numpy(), np.asarray(jax_table(memory, mask)))
    with torch.no_grad():
        got = mod(torch.from_numpy(query), None, None, t_mask, torch.from_numpy(ref), SHAPES, raw_table=t_table)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_module_table_path_matches_its_gather_path():
    """Linearity: the table path and the per-layer projected gather give
    one function, masked keys and out-of-image corners included."""
    rng = np.random.default_rng(3)
    query, memory, mask, ref = (torch.from_numpy(a) for a in module_inputs(rng, True))
    mod = MultiScaleDeformableAttention(MSDAConfig(embed_dims=E, num_heads=HEADS, num_levels=len(SHAPES),
                                                   num_points=POINTS))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        table = msda_dectab.build_raw_quad_table(msda_dectab.raw_memory_aug(memory, mask), SHAPES)
        gather = mod(query, memory, None, mask, ref, SHAPES)
        tab = mod(query, memory, None, mask, ref, SHAPES, raw_table=table)
        # a reference-impl module ignores the table
        ref_mod = MultiScaleDeformableAttention(mod.cfg, impl="reference")
        ref_mod.load_state_dict(mod.state_dict())
        untouched = ref_mod(query, memory, None, mask, ref, SHAPES, raw_table=table)
    np.testing.assert_allclose(tab.numpy(), gather.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(untouched.numpy(), gather.numpy(), rtol=1e-6, atol=1e-6)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def test_decoder_dectab_matches_jax():
    """The tiny config's decoder (2 layers, 12 queries) with the table
    against the JAX decoder with the table, its params and the reg branches'
    bank seeded and carried by the converter."""
    jcfg = jax_tiny_test_config(num_levels=len(SHAPES)).head.transformer
    nd, nq, bs = jcfg.num_decoder_layers, jcfg.two_stage_num_proposals, 2
    rng = np.random.default_rng(4)
    query = rng.standard_normal((bs, nq, E)).astype(np.float32)
    memory = rng.standard_normal((bs, keys(SHAPES), E)).astype(np.float32)
    mask = rng.uniform(size=(bs, keys(SHAPES))) < 0.2
    refs = rng.normal(0.0, 1.0, (bs, nq, 4)).astype(np.float32)
    valid = rng.uniform(0.6, 1.0, (bs, len(SHAPES), 2)).astype(np.float32)
    n_lin = jax_tiny_test_config().head.num_reg_fcs + 1
    dims = [(E, E)] * (n_lin - 1) + [(E, 4)]
    reg = {f"layers_{i}": {"kernel": (0.2 * rng.standard_normal((nd, a, b))).astype(np.float32),
                           "bias": (0.1 * rng.standard_normal((nd, b))).astype(np.float32)}
           for i, (a, b) in enumerate(dims)}

    jdec = JaxDecoder(cfg=jcfg, msda_impl="auto", dectab=True)
    args = (jnp.asarray(query), jnp.asarray(memory), jnp.asarray(mask), jnp.asarray(refs), SHAPES,
            jnp.asarray(valid), reg)
    params = seeded_params(lambda: jdec.init(jax.random.PRNGKey(0), *args), rng)
    # jitted: one compile of the scanned decoder, ~2x cheaper than op by op
    apply = jax.jit(lambda p, q, m, k, r, v, g: jdec.apply(p, q, m, k, r, SHAPES, v, g))
    _, _, j_states, j_refs = apply(params, *args[:4], *args[5:])

    out = checkpoint._Out()
    checkpoint._decoder(out, params["params"], "d", nd)
    for i in range(nd):
        for li in range(n_lin):
            out.dense(f"r.{i}.{2 * li}", {k: v[i] for k, v in reg[f"layers_{li}"].items()})
    pcfg = tiny_test_config(num_levels=len(SHAPES)).head.transformer
    dec = DinoTransformerDecoder(pcfg, dectab=True)
    dec.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in out.sd.items() if k.startswith("d.")})
    branches = torch.nn.ModuleList(mlp(E, E, 4, n_lin) for _ in range(nd))
    branches.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in out.sd.items() if k.startswith("r.")})
    t_args = [torch.from_numpy(a) for a in (query, memory, mask, refs)]
    with torch.no_grad():
        states, inter_refs = dec(*t_args, SHAPES, torch.from_numpy(valid), branches)
        dec.dectab = False
        states_g, refs_g = dec(*t_args, SHAPES, torch.from_numpy(valid), branches)
    assert rel_err(states.numpy(), j_states) < 1e-4
    assert rel_err(inter_refs.numpy(), j_refs) < 1e-4
    # the same weights without the table: the gather path's function
    assert rel_err(states.numpy(), states_g.numpy()) < 1e-4
    assert rel_err(inter_refs.numpy(), refs_g.numpy()) < 1e-4
