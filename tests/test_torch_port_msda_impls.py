"""Every MSDA implementation the JAX package selects, in the port, against
the JAX package on the CPU.

- ``msda_impl="reference"``: the tiny model built with it against the JAX
  ``CoDETR(msda_impl="reference")`` on the ladder (features and states 1e-4
  relative, scores 2e-4, boxes 0.1 px set-wise), with the same weights: the
  port's seeded weights plus 0.05 N(0, 1) noise, relabelled to flax by the
  JAX ``convert_state_dict`` (no JAX init to compile) and carried back by
  ``state_dict_from_jax``; the module and both dispatchers take it for grid
  and non-grid queries without touching the ``codetr::`` ops; the
  exported tiny program holds no ``codetr::`` node, and ``bench``,
  ``eval_coco`` and ``export_aot`` build the reference model.
- ``msda_grid_shift`` (the reference-layout shift-window function) on
  ``tests/test_msda_grid.py``'s three cases (the exact result inside the
  envelope, zero padding at the edges, a far tap dropped) against the JAX
  reference those tests hold the JAX function to, and on the third against
  the JAX ``msda_grid_shift`` too, 2e-5 abs / 1e-5 rel, the JAX suite's own;
  Q != K raises.
- The corrected grid dispatch reads nothing on the host: on the CUDA route,
  with plain launchers in place of the kernels, a ``TorchDispatchMode``
  finds no host read (``aten._local_scalar_dense`` and kin) in the forward
  and backward of ``msda_grid_qm(impl="grid_pallas")`` with wild and with
  in-envelope taps, and the results equal the JAX ``msda_grid_qm(impl=
  "grid")`` and the oracle (forward 2e-5 / 1e-5; gradients the oracle's
  VJP, 1e-5 of scale).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.ops.msda import msda_grid_qm as jax_msda_grid_qm
from codetr_tpu.ops.msda import msda_reference_qm as jax_msda_reference_qm
from codetr_tpu.ops.msda import multi_scale_deformable_attention_reference as jax_msda_reference
from codetr_tpu.ops.msda_grid import msda_grid_shift as jax_msda_grid_shift
from codetr_tpu.utils.checkpoint import convert_state_dict
from codetr_torch import bench, eval_coco, export_aot
from codetr_torch.config import MSDAConfig, tiny_test_config
from codetr_torch.models.codetr import CoDETR, build_codetr, init_weights
from codetr_torch.models.msda_module import MultiScaleDeformableAttention
from codetr_torch.ops import msda as port_msda
from codetr_torch.ops import msda_grid
from codetr_torch.runtime.aot import compile_forward, msda_nodes

from test_msda_grid import grid_inputs
from test_torch_port_grid import as_jax, as_torch, off_grid_lines, wild_inputs
from test_torch_port_model import H, W, assert_model_matches_jax
from test_torch_port_msda import assert_close_to_scale
from test_torch_port_postprocess import HostOps
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)


def seeded_jax_params(seed=0):
    """The port's tiny seeded weights, every one + 0.05 N(0, 1), as the JAX
    package's flax params."""
    rng = np.random.default_rng(seed)
    sd = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in init_weights(CoDETR(tiny_test_config()), seed).state_dict().items()}
    return convert_state_dict(sd, jax_tiny_test_config())


def test_reference_model_matches_jax_reference():
    """The port's and the JAX package's ``msda_impl="reference"`` tiny
    models on one seeded 128x128 image with a padded mask, on the ladder."""
    assert_model_matches_jax(jax_tiny_test_config(), tiny_test_config(), seeded_jax_params(), H, W,
                             msda_impl="reference")


class Built(Exception):
    """Ends a CLI once its model is built."""


def test_reference_model_exports_without_custom_ops_and_clis_build_it(monkeypatch, tmp_path):
    """The tiny ``msda_impl="reference"`` model exports (``compile_forward``)
    with no ``codetr::`` node, and the program gives the eager model's
    outputs bit for bit; ``bench``, ``eval_coco`` and ``export_aot`` pass
    ``--msda-impl reference`` to ``build_codetr``, whose model (the tiny
    config in place of theirs) runs the plain versions in every MSDA
    layer."""
    model = init_weights(CoDETR(tiny_test_config(), "reference"), 0).eval()
    program, _ = compile_forward(model, height=H, width=W)
    assert msda_nodes(program.exported) == {}
    rng = np.random.default_rng(3)
    image = torch.from_numpy(rng.standard_normal((1, H, W, 3)).astype(np.float32))
    masks = torch.zeros(1, H, W)
    masks[:, 96:] = 1.0
    with torch.no_grad():
        for got, want in zip(program(image, masks), model(image, masks)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)

    argv = {bench: ["--single", "--device", "cpu"], eval_coco: ["--ann", "a.json", "--img-dir", "d", "--device", "cpu"],
            export_aot: ["--config", "tiny", "--device", "cpu", "--output", str(tmp_path / "export")]}
    for cli, args in argv.items():
        seen = []

        def build(cfg, *a, msda_impl="auto", **kw):
            built = build_codetr(tiny_test_config(), device="cpu", msda_impl=msda_impl)
            seen.extend(m.impl for m in built.modules() if isinstance(m, MultiScaleDeformableAttention))
            raise Built

        monkeypatch.setattr(cli, "build_codetr", build)
        with pytest.raises(Built):
            cli.main(args + ["--msda-impl", "reference"])
        assert seen == ["reference"] * 4, (cli.__name__, seen)


def test_reference_impl_takes_no_custom_op(monkeypatch):
    """``impl="reference"`` is accepted by the module for grid and non-grid
    queries and by ``msda_grid_packed`` and ``multi_scale_deformable_attention``
    (with and without grid queries), equal to the plain versions bit for bit,
    and never reaches the ``codetr::`` ops (they raise here); unknown impls
    raise."""
    rng = np.random.default_rng(3)

    def refuse(*_):
        raise AssertionError("the reference impl reached a codetr:: op")

    @contextlib.contextmanager
    def no_custom_ops():
        with monkeypatch.context() as m:
            m.setattr(port_msda, "_packed_op", refuse)
            m.setattr(port_msda, "_reference_op", refuse)
            yield

    shapes = ((8, 8), (4, 4))
    value, x, y, w = as_torch(*wild_inputs(21, shapes, radius=1, jitter=2.0))
    loc = torch.stack([x, y], -1).permute(0, 4, 1, 2, 3, 5).contiguous()  # (bs, K, h, L, P, 2)
    attn = w.permute(0, 4, 1, 2, 3).contiguous()
    cpk = port_msda.pack_coords_qmajor(x, y, w)
    with no_custom_ops():
        want = port_msda.multi_scale_deformable_attention_plain(value, shapes, loc, attn)
        for grid_queries in (False, True):
            got = port_msda.multi_scale_deformable_attention(value, shapes, loc, attn, grid_queries,
                                                             impl="reference")
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        got = port_msda.msda_grid_packed(value, shapes, cpk, x.shape[3], impl="reference")
        want = port_msda.msda_grid_packed_plain(value, shapes, cpk, x.shape[3])
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown"):
        port_msda.msda_grid_packed(value, shapes, cpk, x.shape[3], impl="grid")

    cfg = MSDAConfig(embed_dims=16, num_heads=2, num_levels=2, num_points=2)
    K = sum(a * b for a, b in shapes)
    query = torch.from_numpy(rng.standard_normal((1, K, 16)).astype(np.float32))
    for grid_queries, nq, ref in ((True, K, torch.rand(1, K, 2, 2)), (False, 5, torch.rand(1, 5, 2, 4))):
        mods = {impl: MultiScaleDeformableAttention(cfg, grid_queries=grid_queries, impl=impl)
                for impl in ("reference", "auto")}
        sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
              for k, v in mods["auto"].state_dict().items()}
        for mod in mods.values():
            mod.load_state_dict(sd)
        with torch.no_grad():
            with no_custom_ops():
                got = mods["reference"](query[:, :nq], query, None, None, ref, shapes)
            want = mods["auto"](query[:, :nq], query, None, None, ref, shapes)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown MSDA impl"):
        MultiScaleDeformableAttention(cfg, impl="pallas")


# tests/test_msda_grid.py's cases: (shapes, seed, radius, jitter).  The JAX
# msda_grid_shift at radius 3 over two levels compiles for ~12 s a shape on
# the CPU, so the first two cases hold the port to the JAX reference, as the
# JAX tests hold the JAX function (test_torch_port_grid.py holds the q-minor
# core to the JAX msda_grid_shift_qm); the third also to the JAX function
SHIFT_CASES = {
    # test_grid_shift_matches_reference, its two-level shapes
    "exact_in_envelope": (((6, 10), (3, 5)), 0, 3, None),
    # test_grid_shift_edge_positions_zero_padded
    "zero_padded_edges": (((6, 6), (3, 3)), 1, 3, 2.9),
    # test_grid_shift_far_taps_dropped_not_garbage
    "far_tap_dropped": (((8, 8),), 2, 2, 1.0),
}


@pytest.mark.parametrize("case", list(SHIFT_CASES))
def test_msda_grid_shift_matches_jax(case):
    """``msda_grid.msda_grid_shift`` (``max_window=None``) on the JAX
    suite's cases against the JAX reference, the far case with the far
    tap's weight zeroed, and there also against the JAX ``msda_grid_shift``;
    Q != K raises."""
    shapes, seed, radius, jitter = SHIFT_CASES[case]
    value, loc, w = grid_inputs(np.random.default_rng(seed), shapes, radius=radius, jitter=jitter)
    w_ref = w
    if case == "far_tap_dropped":
        loc = loc.copy()
        loc[0, 0, 0, 0, 0] = (0.95, 0.95)  # ~6 px from query 0's anchor
        w_ref = w.copy()
        w_ref[0, 0, 0, 0, 0] = 0.0
    got = msda_grid.msda_grid_shift(*as_torch(value), shapes, *as_torch(loc, w), radius=radius)
    refs = [jax_msda_reference(*as_jax(value), shapes, *as_jax(loc, w_ref))]
    if case == "far_tap_dropped":
        refs.append(jax_msda_grid_shift(*as_jax(value), shapes, *as_jax(loc, w), radius=radius))
        with pytest.raises(ValueError, match="grid queries"):
            msda_grid.msda_grid_shift(*as_torch(value), shapes, *as_torch(loc[:, :5], w[:, :5]), radius=radius)
    for r in refs:
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=2e-5, rtol=1e-5)


class HostReads(HostOps):
    """``HostOps`` (the ops that read a tensor back to the host or make one
    from host data, what a CUDA-graph capture refuses), with the plain
    stand-ins of the kernels run under ``exempt()``."""

    def __init__(self):
        super().__init__()
        self.paused = 0

    @contextlib.contextmanager
    def exempt(self):
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.paused:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


@pytest.mark.parametrize("wild", [0.1, 0.0], ids=["wild", "in_envelope"])
def test_corrected_dispatch_reads_nothing_on_the_host(monkeypatch, wild):
    """The CUDA route of ``msda_grid_qm(impl="grid_pallas")`` with plain
    launchers (K4, the correction entry, the q-minor backward) under
    ``HostReads``: forward and backward read nothing on the host and make
    no host tensor; the out-of-envelope count stays a tensor; the result
    equals the JAX ``impl="grid"`` dispatch and the oracle, and the
    gradients (the exact function's) ``jax.vjp`` of the oracle, taps moved
    off grid lines; ``test_torch_port_grid.py`` holds them against the JAX
    grid dispatch's VJP."""
    mode = HostReads()

    def fake_shift(v, sh, xx, yy, ww, radius, max_window):
        with mode.exempt():
            port_msda.launches_shift += 1
            return msda_grid.msda_shift_plain(v, sh, xx, yy, ww, radius, max_window)

    def fake_correction(v, sh, xx, yy, ww, count, out):
        with mode.exempt():
            port_msda.launches_correction += 1
            return out.add_(torch.where(count > 0, port_msda.msda_reference_qm(v, sh, xx, yy, ww), 0.0))

    def fake_qm_bwd(v, sh, xx, yy, ww, g):
        with mode.exempt():
            port_msda.launches_bwd += 1
            grads = port_msda.msda_backward_plain(v, sh, *(a.permute(0, 4, 1, 2, 3) for a in (xx, yy, ww)), g)
            return (grads[0], *(a.permute(0, 2, 3, 4, 1) for a in grads[1:]))

    monkeypatch.setattr(port_msda, "_route", lambda t: "cuda")
    monkeypatch.setattr(msda_grid, "_launch_shift", fake_shift)
    monkeypatch.setattr(port_msda, "_launch_correction", fake_correction)
    monkeypatch.setattr(port_msda, "_launch_qm_bwd", fake_qm_bwd)
    for name in ("launches_shift", "launches_correction", "launches_bwd"):
        monkeypatch.setattr(port_msda, name, 0)
    shapes = ((8, 8),)  # one level: the JAX grid dispatch compiles in ~1 s
    value, x, y, w = wild_inputs(31, shapes, radius=1, jitter=1.0, wild=wild)
    sx = np.asarray([ww for _, ww in shapes], np.float32)[None, None, :, None, None]
    sy = np.asarray([hh for hh, _ in shapes], np.float32)[None, None, :, None, None]
    x, y = off_grid_lines(x, sx), off_grid_lines(y, sy)
    g = np.random.default_rng(32).standard_normal((1, value.shape[1], value.shape[2] * value.shape[3]))
    g = g.astype(np.float32)
    leaves = [t.clone().requires_grad_() for t in as_torch(value, x, y, w)]
    grad_out = torch.from_numpy(g)
    # the anchor tables are made once per shape, before any capture
    msda_grid.envelope_mask(shapes, *as_torch(x, y), radius=1, max_window=31)
    with mode:
        out = port_msda.msda_grid_qm(leaves[0], shapes, *leaves[1:], impl="grid_pallas", radius=1)
        count = port_msda.last_out_of_envelope
        out.backward(grad_out)
    assert mode.found == [] and mode.ops > 0
    assert (port_msda.launches_shift, port_msda.launches_correction, port_msda.launches_bwd) == (1, 1, 1)
    assert isinstance(count, torch.Tensor) and count.dtype == torch.int64 and count.dim() == 0
    assert (int(count) > 0) == (wild > 0)

    jargs = as_jax(value, x, y, w)
    want = jax_msda_grid_qm(jargs[0], shapes, *jargs[1:], impl="grid", radius=1)
    oracle, vjp = jax.vjp(lambda *a: jax_msda_reference_qm(a[0], shapes, *a[1:]), *jargs)
    for ref in (want, oracle):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    for leaf, wt in zip(leaves, vjp(jnp.asarray(g))):
        assert_close_to_scale(leaf.grad.numpy(), wt)
