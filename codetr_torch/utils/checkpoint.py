"""Checkpoints -> this port's (mmdet-schema) state dict.

``load_torch_checkpoint(path, cfg)`` reads an mmdet ``.pth`` (the port's
module tree has mmdet's key schema, so the keys carry over as they are),
with ``swin_original_to_mmdet`` for original-Swin-repo checkpoints and
``resize_bias_table`` where the window size differs; ``get_dataset_meta``
reads its class names.  Copies of the JAX package's functions.

``state_dict_from_jax(params, cfg)`` takes the JAX package's flax params
tree (nested dicts of arrays, with or without the top ``"params"`` level)
and returns ``{mmdet key: numpy array}`` for ``CoDETR.load_state_dict``.
It is the inverse of the JAX package's ``convert_state_dict``:

- Dense kernels (in, out) -> Linear weights (out, in); conv HWIO -> OIHW;
  norm ``scale`` -> ``weight``; the ResNet's frozen BatchNorm ``scale``,
  ``bias``, ``mean``, ``var`` -> ``weight``, ``bias``, ``running_mean``,
  ``running_var``, and its ``layer{s}_{b}`` blocks -> ``layer{s}.{b}``;
- leaves stacked on a leading axis (the scanned Swin block pairs, encoder
  and decoder layers, and the decoder's cls/reg branch banks) are unstacked
  into per-index keys; branch 6 (the encoder stage) is separate already;
- the MSDA sampling-offset columns go from the JAX layout [x(HLP) | y(HLP)]
  back to mmdet's interleaved (h, L, P, 2);
- the decoder MHA's separate q/k/v projections are packed into
  ``in_proj_weight`` / ``in_proj_bias``;
- PatchMerging's LN and reduction rows go from the JAX concat order
  (position-major, pos * C + c) back to ``nn.Unfold``'s (c * 4 + pos).

Only numpy is used, so the port does not depend on the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from codetr_torch.config import CoDETRConfig


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _lin(k) -> np.ndarray:  # Dense kernel (in, out) -> Linear weight (out, in)
    return np.ascontiguousarray(_np(k).T)


def _conv(k) -> np.ndarray:  # HWIO -> OIHW
    return np.ascontiguousarray(np.transpose(_np(k), (3, 2, 0, 1)))


def _position_major_to_unfold(w: np.ndarray, c_in: int, axis: int = 0) -> np.ndarray:
    """Rows indexed pos * C + c along ``axis`` -> c * 4 + pos."""
    w = np.moveaxis(_np(w), axis, 0)
    rest = w.shape[1:]
    w = np.swapaxes(w.reshape(4, c_in, *rest), 0, 1).reshape(4 * c_in, *rest)
    return np.ascontiguousarray(np.moveaxis(w, 0, axis))


def _interleave_xy(a: np.ndarray, axis: int) -> np.ndarray:
    """[x(n) | y(n)] along ``axis`` -> (n, 2) interleaved."""
    a = np.moveaxis(_np(a), axis, -1)
    n = a.shape[-1] // 2
    out = np.stack([a[..., :n], a[..., n:]], axis=-1).reshape(*a.shape[:-1], 2 * n)
    return np.ascontiguousarray(np.moveaxis(out, -1, axis))


class _Out:
    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def dense(self, key: str, p, bias: bool = True):
        self.sd[f"{key}.weight"] = _lin(p["kernel"])
        if bias:
            self.sd[f"{key}.bias"] = _np(p["bias"])

    def norm(self, key: str, p):
        self.sd[f"{key}.weight"] = _np(p["scale"])
        self.sd[f"{key}.bias"] = _np(p["bias"])

    def ffn(self, key: str, p):
        self.dense(f"{key}.layers.0.0", p["fc1"])
        self.dense(f"{key}.layers.1", p["fc2"])

    def msda(self, key: str, p):
        for name in ("attention_weights", "value_proj", "output_proj"):
            self.dense(f"{key}.{name}", p[name])
        so = p["sampling_offsets"]
        self.sd[f"{key}.sampling_offsets.weight"] = _lin(_interleave_xy(so["kernel"], axis=1))
        self.sd[f"{key}.sampling_offsets.bias"] = _interleave_xy(so["bias"], axis=0)


def _index(tree, i):
    """Slice every leaf of a stacked subtree at index ``i``."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return _np(tree)[i]


def _swin(out: _Out, p, cfg: CoDETRConfig):
    sc = cfg.swin
    bb = p["backbone"]
    out.sd["backbone.patch_embed.projection.weight"] = _conv(bb["patch_embed"]["projection"]["kernel"])
    out.sd["backbone.patch_embed.projection.bias"] = _np(bb["patch_embed"]["projection"]["bias"])
    out.norm("backbone.patch_embed.norm", bb["patch_embed"]["norm"])
    dims = sc.embed_dims
    for i, depth in enumerate(sc.depths):
        stacked = bb[f"stages_{i}_blocks"]
        for j in range(depth // 2):
            pair = _index(stacked, j)
            for b, name in ((2 * j, "block0"), (2 * j + 1, "block1")):
                blk, key = pair[name], f"backbone.stages.{i}.blocks.{b}"
                out.norm(f"{key}.norm1", blk["norm1"])
                out.norm(f"{key}.norm2", blk["norm2"])
                w = blk["attn"]["w_msa"]
                out.sd[f"{key}.attn.w_msa.relative_position_bias_table"] = _np(
                    w["relative_position_bias_table"]
                )
                out.dense(f"{key}.attn.w_msa.qkv", w["qkv"], bias="bias" in w["qkv"])
                out.dense(f"{key}.attn.w_msa.proj", w["proj"])
                out.ffn(f"{key}.ffn", blk["ffn"])
        if i < len(sc.depths) - 1:
            ds, key = bb[f"stages_{i}_downsample"], f"backbone.stages.{i}.downsample"
            out.sd[f"{key}.norm.weight"] = _position_major_to_unfold(ds["norm"]["scale"], dims)
            out.sd[f"{key}.norm.bias"] = _position_major_to_unfold(ds["norm"]["bias"], dims)
            out.sd[f"{key}.reduction.weight"] = _position_major_to_unfold(
                _lin(ds["reduction"]["kernel"]), dims, axis=1
            )
            dims *= 2
    for i in sc.out_indices:
        out.norm(f"backbone.norm{i}", bb[f"norm{i}"])


def _resnet(out: _Out, p, cfg: CoDETRConfig):
    bb = p["backbone"]

    def bn(key, q):
        for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")):
            out.sd[f"{key}.{dst}"] = _np(q[src])

    out.sd["backbone.conv1.weight"] = _conv(bb["conv1"]["kernel"])
    bn("backbone.bn1", bb["bn1"])
    for stage, num_blocks in enumerate(cfg.resnet.stage_blocks):
        for b in range(num_blocks):
            blk, key = bb[f"layer{stage + 1}_{b}"], f"backbone.layer{stage + 1}.{b}"
            for j in (1, 2, 3):
                out.sd[f"{key}.conv{j}.weight"] = _conv(blk[f"conv{j}"]["kernel"])
                bn(f"{key}.bn{j}", blk[f"bn{j}"])
            if b == 0:
                out.sd[f"{key}.downsample.0.weight"] = _conv(blk["downsample_conv"]["kernel"])
                bn(f"{key}.downsample.1", blk["downsample_bn"])


def _neck(out: _Out, p, cfg: CoDETRConfig):
    neck = p["neck"]
    blocks = [(f"convs_{i}", f"convs.{i}") for i in range(len(cfg.neck.in_channels))]
    blocks += [
        (f"extra_convs_{j}", f"extra_convs.{j}")
        for j in range(cfg.neck.num_outs - len(cfg.neck.in_channels))
    ]
    for src, dst in blocks:
        out.sd[f"neck.{dst}.conv.weight"] = _conv(neck[f"{src}_conv"]["kernel"])
        out.sd[f"neck.{dst}.conv.bias"] = _np(neck[f"{src}_conv"]["bias"])
        out.norm(f"neck.{dst}.gn", neck[f"{src}_gn"])


def _head(out: _Out, p, cfg: CoDETRConfig):
    tc = cfg.head.transformer
    nd = tc.num_decoder_layers
    qh = p["query_head"]
    n_lin = cfg.head.num_reg_fcs + 1
    for i in range(nd):
        out.dense(f"query_head.cls_branches.{i}", _index(qh["cls_branches"], i))
        reg = _index(qh["reg_branches"], i)
        for li in range(n_lin):
            out.dense(f"query_head.reg_branches.{i}.{2 * li}", reg[f"layers_{li}"])
    out.dense(f"query_head.cls_branches.{nd}", qh[f"cls_branches_{nd}"])
    for li in range(n_lin):
        out.dense(f"query_head.reg_branches.{nd}.{2 * li}", qh[f"reg_branches_{nd}"][f"layers_{li}"])

    t, key = qh["transformer"], "query_head.transformer"
    out.sd[f"{key}.level_embeds"] = _np(t["level_embeds"])
    out.dense(f"{key}.enc_output", t["enc_output"])
    out.norm(f"{key}.enc_output_norm", t["enc_output_norm"])
    out.sd[f"{key}.query_embed.weight"] = _np(t["query_embed"])

    for layer in range(tc.num_encoder_layers):
        e, k = _index(t["encoder_layers"], layer), f"{key}.encoder.layers.{layer}"
        out.msda(f"{k}.attentions.0", e["self_attn"])
        out.norm(f"{k}.norms.0", e["norm1"])
        out.norm(f"{k}.norms.1", e["norm2"])
        out.ffn(f"{k}.ffns.0", e["ffn"])

    _decoder(out, t["decoder"], f"{key}.decoder", nd)


def _decoder(out: _Out, dec, key: str, nd: int):
    """A JAX ``DinoTransformerDecoder``'s params (its scanned layers, the
    ref-point head, the final norm) under the port's ``key`` prefix."""
    for layer in range(nd):
        d, k = _index(dec["layers"], layer), f"{key}.layers.{layer}"
        sa = d["self_attn"]
        names = ("q_proj", "k_proj", "v_proj")
        out.sd[f"{k}.attentions.0.attn.in_proj_weight"] = np.concatenate(
            [_lin(sa[n]["kernel"]) for n in names]
        )
        out.sd[f"{k}.attentions.0.attn.in_proj_bias"] = np.concatenate(
            [_np(sa[n]["bias"]) for n in names]
        )
        out.dense(f"{k}.attentions.0.attn.out_proj", sa["out_proj"])
        out.msda(f"{k}.attentions.1", d["cross_attn"])
        for n in range(3):
            out.norm(f"{k}.norms.{n}", d[f"norm{n + 1}"])
        out.ffn(f"{k}.ffns.0", d["ffn"])
    for li, ti in enumerate((0, 2)):
        out.dense(f"{key}.ref_point_head.{ti}", dec["ref_point_head"][f"layers_{li}"])
    out.norm(f"{key}.norm", dec["norm"])


def state_dict_from_jax(params, cfg: CoDETRConfig) -> Dict[str, np.ndarray]:
    """JAX-package params tree -> {mmdet key: numpy array}."""
    p = params["params"] if "params" in params else params
    backbones = {"swin": _swin, "resnet": _resnet}
    if cfg.backbone_type not in backbones:
        raise ValueError(f"unknown backbone {cfg.backbone_type!r}")
    out = _Out()
    backbones[cfg.backbone_type](out, p, cfg)
    _neck(out, p, cfg)
    _head(out, p, cfg)
    return out.sd


def resize_bias_table(table: np.ndarray, wh_new: int, ww_new: int) -> np.ndarray:
    """Bicubic-resize a ((2Wh-1)(2Ww-1), nH) relative-position-bias table to a
    new window size (square tables only)."""
    L1, nH = table.shape
    s1 = int(round(L1**0.5))
    if s1 * s1 != L1:
        raise ValueError(f"only square windows can be resized, got a table of {L1} rows")
    s2h, s2w = 2 * wh_new - 1, 2 * ww_new - 1
    if (s2h, s2w) == (s1, s1):
        return table
    t = torch.from_numpy(table.astype(np.float32)).permute(1, 0).reshape(1, nH, s1, s1)
    t = torch.nn.functional.interpolate(t, size=(s2h, s2w), mode="bicubic", align_corners=False)
    return t.reshape(nH, s2h * s2w).permute(1, 0).numpy()


def swin_original_to_mmdet(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Original-Swin-repo checkpoint keys -> the mmdet layout.  The original
    PatchMerging concatenates [x00, x10, x01, x11] where mmdet's unfold
    order is [x00, x01, x10, x11]: the 4-block permutation [0, 2, 1, 3]."""
    out = {}
    for k, v in sd.items():
        if k.startswith("head"):
            continue
        nk, nv = k, v
        if k.startswith("layers"):
            if "attn." in k:
                nk = k.replace("attn.", "attn.w_msa.")
            elif "mlp.fc1." in k:
                nk = k.replace("mlp.fc1.", "ffn.layers.0.0.")
            elif "mlp.fc2." in k:
                nk = k.replace("mlp.fc2.", "ffn.layers.1.")
            elif "downsample" in k:
                if "reduction." in k:
                    o, i = v.shape
                    nv = v.reshape(o, 4, i // 4)[:, [0, 2, 1, 3], :].transpose(0, 2, 1).reshape(o, i)
                elif "norm." in k:
                    i = v.shape[0]
                    nv = v.reshape(4, i // 4)[[0, 2, 1, 3], :].transpose(1, 0).reshape(i)
            nk = nk.replace("layers", "stages", 1)
        elif k.startswith("patch_embed") and "proj" in k:
            nk = k.replace("proj", "projection")
        out["backbone." + nk] = np.asarray(nv)
    return out


# mmdet checkpoints hold the auxiliary training heads, which the served
# model never builds
TRAIN_ONLY = ("rpn_head.", "roi_head.", "bbox_head.", "dn_", "label_emb")


def model_key_shapes(cfg: CoDETRConfig) -> Dict[str, Tuple[int, ...]]:
    """The port's state-dict keys and shapes for ``cfg`` (built on the meta
    device: no memory, no init)."""
    from codetr_torch.models.codetr import CoDETR

    with torch.device("meta"):
        model = CoDETR(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def numpy_safe_globals() -> list:
    """numpy's reconstructors, which a ``.pth`` needs where its ``meta``
    holds numpy scalars or arrays: ``scalar`` and ``_reconstruct`` under
    numpy 2's (``numpy._core``) and numpy 1's (``numpy.core``) module names,
    ``ndarray``, ``dtype`` and the dtype classes of booleans, numbers and
    strings (an unpickled dtype's state is set on an instance of its class).
    Object arrays stay refused."""
    try:
        from numpy._core import multiarray
    except ImportError:  # numpy 1
        from numpy.core import multiarray
    out: list = [np.ndarray, np.dtype]
    for name in ("scalar", "_reconstruct"):
        fn = getattr(multiarray, name)
        out += [(fn, f"numpy.core.multiarray.{name}"), (fn, f"numpy._core.multiarray.{name}")]
    codes = "?" + np.typecodes["AllInteger"] + np.typecodes["AllFloat"] + "SU"
    out += list(dict.fromkeys(type(np.dtype(c)) for c in codes))
    return out


def _read(path: str) -> dict:
    """``torch.load`` with ``weights_only=True``: tensors, containers and
    numpy's reconstructors (``numpy_safe_globals``); a file whose pickle
    names any other global raises ``pickle.UnpicklingError``."""
    with torch.serialization.safe_globals(numpy_safe_globals()):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_checkpoint(path: str, cfg: CoDETRConfig, *, convert_swin_original: bool = False
                          ) -> Dict[str, np.ndarray]:
    """An mmdet ``.pth`` -> ``{key: numpy array}`` for ``CoDETR.load_state_dict``.

    ``state_dict`` / ``model`` wrappers are unwrapped and a ``module.``
    prefix stripped; ``convert_swin_original`` remaps original-Swin-repo
    keys first.  The auxiliary training heads' keys (``TRAIN_ONLY``) are
    ignored and BatchNorm's ``num_batches_tracked`` dropped (the port's
    frozen BatchNorm has none); relative-position-bias tables are resized
    to the config's window.  The load report names missing and unexpected
    keys; then a key of the model (``model_key_shapes``) that the file lacks
    raises ``KeyError`` naming it, as the JAX package's conversion does, so
    the result holds exactly the model's keys."""
    from codetr_torch.utils.logging import log_load_report

    ckpt = _read(path)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    sd = {k[len("module."):] if k.startswith("module.") else k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
          for k, v in sd.items()}
    if convert_swin_original:
        sd = swin_original_to_mmdet(sd)
    expected = model_key_shapes(cfg)
    out: Dict[str, np.ndarray] = {}
    unexpected = []
    for k, v in sd.items():
        if k.endswith("num_batches_tracked") or k.startswith(TRAIN_ONLY):
            continue
        if k not in expected:
            unexpected.append(k)
            continue
        if k.endswith("relative_position_bias_table") and v.shape != expected[k]:
            v = resize_bias_table(v, cfg.swin.window_size, cfg.swin.window_size)
        out[k] = v
    missing = [k for k in expected if k not in out]
    log_load_report(len(out), missing, unexpected, path)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} of the model's keys: {', '.join(missing[:5])}"
                       + (" ..." if len(missing) > 5 else ""))
    return out


def get_dataset_meta(path: str) -> dict:
    """A checkpoint's dataset metadata (``meta.dataset_meta``, or
    ``meta.CLASSES``), with the COCO classes where it has none."""
    from codetr_torch.utils.coco import COCO_CLASSES

    meta = _read(path).get("meta", {})
    if "dataset_meta" in meta:
        dataset_meta = {k.lower(): v for k, v in meta["dataset_meta"].items()}
    elif "CLASSES" in meta:
        dataset_meta = {"classes": meta["CLASSES"]}
    else:
        dataset_meta = {"classes": COCO_CLASSES}
    dataset_meta["palette"] = "coco"
    return dataset_meta
