"""Reference PyTorch checkpoints ↔ flax-shaped parameter trees (port of
``megatts2_tpu/training/convert.py``, with its inverse).

Forward (``convert_*``, a copy of the JAX module's, which imports only
numpy; stacking goes through :func:`_stack` instead of
``jax.tree_util``): a reference Lightning state dict (keys prefixed ``G.``,
``plm.``, ``adm.``, ``D.``; the VQ EMA buffers; BatchNorm statistics;
HiFi-GAN's weight norm folded) → the flax tree that
``bridge.load_flax_params`` fills a port module from.

Inverse (``unconvert_*``): a flax tree (``bridge.export_flax_params`` of a
port module) → the reference state dict, so the port writes its
checkpoints in the reference's layout and the JAX package's
``load_torch_state_dict`` + ``convert_*`` read them.  Weight layouts:

* Linear   (out, in)      ↔ Dense kernel (in, out)
* Conv1d   (out, in, k)   ↔ Conv kernel (k, in, out)
* Conv2d   (out, in, kh, kw) ↔ (kh, kw, in, out)
* ConvTranspose1d (in, out, k) ↔ (k, in, out), flipped along k
* Embedding / LayerNorm / BatchNorm direct (LayerNorm weight ↔ ``scale``)
* VQ buffers (inited, cluster_size, embed, embed_avg) ↔ ``vq_stats``

Vocos has no reference checkpoint: its flax tree is stored flattened with
``.`` between the keys (:func:`flatten_tree`, :func:`unflatten_tree`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def load_torch_state_dict(path: str, prefix: str = "") -> Dict[str, np.ndarray]:
    """Load a torch .ckpt/.pt/.pth file → {name: np.ndarray}, stripping
    ``prefix`` (e.g. 'G.') and dropping non-matching keys."""
    from .checkpoints import read_checkpoint

    obj = read_checkpoint(path)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    out = {}
    for k, v in sd.items():
        if prefix:
            if not k.startswith(prefix):
                continue
            k = k[len(prefix):]
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def _stack(trees: list) -> Any:
    """Leaves of same-shaped trees stacked along a new leading axis (the
    scan-stacked layout)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees, axis=0)


def _linear(sd, name):
    p = {"kernel": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _conv1d(sd, name):
    p = {"kernel": sd[f"{name}.weight"].transpose(2, 1, 0)}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _conv2d(sd, name):
    p = {"kernel": sd[f"{name}.weight"].transpose(2, 3, 1, 0)}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _ln(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _embed(sd, name):
    return {"embedding": sd[f"{name}.weight"]}


def _conv_block(sd, name):
    return {"conv": _conv1d(sd, f"{name}.conv"), "norm": _ln(sd, f"{name}.norm")}


def _residual_stack(sd, name, n_stacks, n_blocks, scan_stacks: bool = False):
    per = []
    for i in range(n_stacks):
        stack = {}
        for j in range(n_blocks):
            stack[f"blocks_{j}"] = _conv_block(sd, f"{name}.conv_stacks.{i}.blocks.{j}")
        per.append(stack)
    if scan_stacks:
        return {"conv_stacks": _stack(per)}
    return {f"conv_stacks_{i}": p for i, p in enumerate(per)}


def _convnet(sd, name, n_stacks, n_blocks, scan_stacks: bool = False):
    return {
        "first_layer": _conv1d(sd, f"{name}.first_layer"),
        "conv_stack": _residual_stack(sd, f"{name}.conv_stack", n_stacks, n_blocks, scan_stacks),
        "last_layer": _conv1d(sd, f"{name}.last_layer"),
    }


def _convnet_double(sd, name, n_layers, n_stacks, n_blocks, conv_middle: bool,
                    scan_stacks: bool = False):
    out = {
        "first_layer": _conv1d(sd, f"{name}.first_layer"),
        "last_layer": _conv1d(sd, f"{name}.last_layer"),
    }
    for i in range(n_layers):
        out[f"layers_{i}"] = {
            "conv_stack1": _residual_stack(
                sd, f"{name}.layers.{i}.conv_stack1", n_stacks, n_blocks, scan_stacks),
            "conv_stack2": _residual_stack(
                sd, f"{name}.layers.{i}.conv_stack2", n_stacks, n_blocks, scan_stacks),
        }
    if conv_middle:
        # the torch middle layer is ONE shared Conv1d; it also appears under
        # layers.{i}.middle_layer — read the first occurrence
        out["middle_layer"] = {"conv": _conv1d(sd, f"{name}.layers.0.middle_layer")}
    return out


def _mha(sd, name):
    return {
        "w_q": _linear(sd, f"{name}.w_q"),
        "w_k": _linear(sd, f"{name}.w_k"),
        "w_v": _linear(sd, f"{name}.w_v"),
        "out_proj": _linear(sd, f"{name}.out_proj.0"),
    }


def _encoder_layer(sd, name, conv_ff: bool):
    out = {
        "norm1": _ln(sd, f"{name}.norm1"),
        "norm2": _ln(sd, f"{name}.norm2"),
        "attn": _mha(sd, f"{name}.attn"),
    }
    if conv_ff:
        out["ff_conv1"] = _conv1d(sd, f"{name}.ff.0")
        out["ff_conv2"] = _conv1d(sd, f"{name}.ff.2")
    else:
        out["ff_linear1"] = _linear(sd, f"{name}.ff.0")
        out["ff_linear2"] = _linear(sd, f"{name}.ff.3")
    return out


def _encoder(sd, name, n_layers, conv_ff, scan_layers: bool = True):
    """Per-layer torch weights → the encoder's params, stacked on a leading
    depth axis under one 'layers' subtree (the scanned encoder) by default."""
    per_layer = [_encoder_layer(sd, f"{name}.layers.{i}", conv_ff) for i in range(n_layers)]
    if not scan_layers:
        return {f"layers_{i}": p for i, p in enumerate(per_layer)}
    return {"layers": _stack(per_layer)}


def _vq_stats(sd, name, n_q=1):
    out = {}
    for i in range(n_q):
        # reference path: vqpe.vq (RVQ facade) .vq (RVQization) .layers.i
        cb = f"{name}.vq.vq.layers.{i}._codebook"
        out[f"layers_{i}"] = {
            "_codebook": {
                "inited": np.float32(sd[f"{cb}.inited"].reshape(())),
                "cluster_size": sd[f"{cb}.cluster_size"],
                "embed": sd[f"{cb}.embed"],
                "embed_avg": sd[f"{cb}.embed_avg"],
            }
        }
    return out


def convert_megag(sd: Mapping[str, np.ndarray], cfg, scan_stacks: bool | None = None) -> Dict[str, Any]:
    """Reference MegaG state_dict → {'params': ..., 'vq_stats': ...}; the
    param layout follows ``cfg.scan_stacks`` unless overridden."""
    if scan_stacks is None:
        scan_stacks = getattr(cfg, "scan_stacks", False)
    m, v = cfg.mrte, cfg.vqpe
    params = {
        "mrte": {
            "phone_embedding": {"word_embeddings": _embed(sd, "mrte.phone_embedding.word_embeddings")},
            "mel_encoder": _convnet_double(
                sd, "mrte.mel_encoder", m.mel_n_layer, m.mel_n_stack, m.mel_n_block, True,
                scan_stacks,
            ),
            "phone_encoder": _encoder(sd, "mrte.phone_encoder", m.content_n_layers, True),
            "mha": _mha(sd, "mrte.mha"),
            "norm": _ln(sd, "mrte.norm"),
        },
        "vqpe": {
            "convnet": _convnet_double(
                sd, "vqpe.convnet", v.n_layers, v.n_stacks, v.n_blocks, False, scan_stacks
            ),
        },
        "decoder": _convnet(sd, "decoder", cfg.decoder_n_stack, cfg.decoder_n_block, scan_stacks),
    }
    vq_stats = {"vqpe": {"vq": _vq_stats(sd, "vqpe")}}
    return {"params": params, "vq_stats": vq_stats}


def convert_plm(sd: Mapping[str, np.ndarray], cfg) -> Dict[str, Any]:
    return {
        "plm": _encoder(sd, "plm", cfg.n_layers, False),
        "predict_layer": {"kernel": sd["predict_layer.weight"].T},
        "pc_embedding": _embed(sd, "pc_embedding"),
    }


def convert_adm(sd: Mapping[str, np.ndarray], cfg) -> Dict[str, Any]:
    return {
        "adm": _encoder(sd, "adm", cfg.n_layers, False),
        "dt_linear_emb": {"kernel": sd["dt_linear_emb.weight"].T},
        "tc_linear_emb": {"kernel": sd["tc_linear_emb.weight"].T},
        "predict_layer": {"kernel": sd["predict_layer.weight"].T},
    }


def convert_discriminator(sd: Mapping[str, np.ndarray], cfg) -> Dict[str, Any]:
    """Reference Discriminator state_dict ('D.' stripped) → {'params',
    'batch_stats'}.  The torch adv_layer consumes an NCHW flatten (C, T',
    F'), the flax one a channels-last flatten (T', F', C): the Linear
    kernel is permuted accordingly."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    fp = (cfg.freq_length + 7) // 8
    for i, wl in enumerate(cfg.time_lengths):
        base = f"discriminator.discriminators.{i}"
        dp: Dict[str, Any] = {}
        ds: Dict[str, Any] = {}
        for j in range(3):
            dp[f"conv_{j}"] = _conv2d(sd, f"{base}.model.{j}.0")
            if j < 2:
                bn = f"{base}.model.{j}.3"
                dp[f"bn_{j}"] = {"scale": sd[f"{bn}.weight"], "bias": sd[f"{bn}.bias"]}
                ds[f"bn_{j}"] = {"mean": sd[f"{bn}.running_mean"], "var": sd[f"{bn}.running_var"]}
        w = sd[f"{base}.adv_layer.weight"]  # (1, C*T'*F')
        tp = wl // 8
        c = cfg.hidden_size
        kernel = w.reshape(c, tp, fp).transpose(1, 2, 0).reshape(tp * fp * c)[:, None]
        dp["adv_layer"] = {"kernel": kernel, "bias": sd[f"{base}.adv_layer.bias"]}
        params[f"disc_{i}"] = dp
        stats[f"disc_{i}"] = ds
    return {"params": params, "batch_stats": stats}


def _fold_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold torch weight_norm (weight_g / weight_v) pairs into plain weights
    (HiFi-GAN checkpoints ship weight-normalized)."""
    out = dict(sd)
    for k in list(sd):
        if k.endswith("weight_g"):
            base = k[: -len("weight_g")]
            g, v = sd[k], sd[base + "weight_v"]
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt((v**2).sum(axis=axes, keepdims=True))
            out[base + "weight"] = g * v / np.maximum(norm, 1e-12)
            del out[k], out[base + "weight_v"]
    return out


def convert_hifigan(sd: Mapping[str, np.ndarray], cfg) -> Dict[str, Any]:
    """HiFi-GAN V1 generator torch weights (jik876/speechbrain layout:
    conv_pre, ups.N, resblocks.N convs1/convs2, conv_post; weight norm
    folded) → flax params."""
    sd = _fold_weight_norm(dict(sd))
    params: Dict[str, Any] = {
        "conv_pre": _conv1d(sd, "conv_pre"),
        "conv_post": _conv1d(sd, "conv_post"),
    }
    for i in range(len(cfg.upsample_rates)):
        w = sd[f"ups.{i}.weight"]  # ConvTranspose1d (in, out, k)
        params[f"ups_{i}"] = {"kernel": w.transpose(2, 0, 1)[::-1].copy(), "bias": sd[f"ups.{i}.bias"]}
    n_k = len(cfg.resblock_kernel_sizes)
    for r in range(len(cfg.upsample_rates) * n_k):
        block = {}
        for j in range(len(cfg.resblock_dilation_sizes[r % n_k])):
            block[f"convs1_{j}"] = _conv1d(sd, f"resblocks.{r}.convs1.{j}")
            block[f"convs2_{j}"] = _conv1d(sd, f"resblocks.{r}.convs2.{j}")
        params[f"resblocks_{r}"] = block
    return params


# ---------------------------------------------------------------- inverse


def _unstacked(tree: dict, key: str) -> list:
    """The per-index subtrees ``key_0``, ``key_1``, ... (``bridge.
    export_flax_params`` writes every ``ModuleList`` unstacked)."""
    out, i = [], 0
    while f"{key}_{i}" in tree:
        out.append(tree[f"{key}_{i}"])
        i += 1
    return out


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _put_linear(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _put_conv1d(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(2, 1, 0)
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _put_ln(sd, name, p):
    sd[f"{name}.weight"], sd[f"{name}.bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])


def _put_residual_stack(sd, name, p):
    for i, stack in enumerate(_unstacked(p, "conv_stacks")):
        for j, block in enumerate(_unstacked(stack, "blocks")):
            _put_conv1d(sd, f"{name}.conv_stacks.{i}.blocks.{j}.conv", block["conv"])
            _put_ln(sd, f"{name}.conv_stacks.{i}.blocks.{j}.norm", block["norm"])


def _put_convnet(sd, name, p):
    _put_conv1d(sd, f"{name}.first_layer", p["first_layer"])
    _put_residual_stack(sd, f"{name}.conv_stack", p["conv_stack"])
    _put_conv1d(sd, f"{name}.last_layer", p["last_layer"])


def _put_convnet_double(sd, name, p):
    _put_conv1d(sd, f"{name}.first_layer", p["first_layer"])
    _put_conv1d(sd, f"{name}.last_layer", p["last_layer"])
    for i, layer in enumerate(_unstacked(p, "layers")):
        _put_residual_stack(sd, f"{name}.layers.{i}.conv_stack1", layer["conv_stack1"])
        _put_residual_stack(sd, f"{name}.layers.{i}.conv_stack2", layer["conv_stack2"])
        if "middle_layer" in p:  # one shared Conv1d, under every layer as in the reference
            _put_conv1d(sd, f"{name}.layers.{i}.middle_layer", p["middle_layer"]["conv"])


def _put_mha(sd, name, p):
    for part in ("w_q", "w_k", "w_v"):
        _put_linear(sd, f"{name}.{part}", p[part])
    _put_linear(sd, f"{name}.out_proj.0", p["out_proj"])


def _put_encoder(sd, name, p):
    for i, layer in enumerate(_unstacked(p, "layers")):
        base = f"{name}.layers.{i}"
        _put_ln(sd, f"{base}.norm1", layer["norm1"])
        _put_ln(sd, f"{base}.norm2", layer["norm2"])
        _put_mha(sd, f"{base}.attn", layer["attn"])
        if "ff_conv1" in layer:
            _put_conv1d(sd, f"{base}.ff.0", layer["ff_conv1"])
            _put_conv1d(sd, f"{base}.ff.2", layer["ff_conv2"])
        else:
            _put_linear(sd, f"{base}.ff.0", layer["ff_linear1"])
            _put_linear(sd, f"{base}.ff.3", layer["ff_linear2"])


def unconvert_megag(tree: dict) -> Dict[str, np.ndarray]:
    """{'params', 'vq_stats'} → the reference MegaG state dict (no prefix)."""
    sd: Dict[str, np.ndarray] = {}
    p = tree["params"]
    m = p["mrte"]
    sd["mrte.phone_embedding.word_embeddings.weight"] = np.asarray(
        m["phone_embedding"]["word_embeddings"]["embedding"])
    _put_convnet_double(sd, "mrte.mel_encoder", m["mel_encoder"])
    _put_encoder(sd, "mrte.phone_encoder", m["phone_encoder"])
    _put_mha(sd, "mrte.mha", m["mha"])
    _put_ln(sd, "mrte.norm", m["norm"])
    _put_convnet_double(sd, "vqpe.convnet", p["vqpe"]["convnet"])
    _put_convnet(sd, "decoder", p["decoder"])
    for i, layer in enumerate(_unstacked(tree["vq_stats"]["vqpe"]["vq"], "layers")):
        cb = f"vqpe.vq.vq.layers.{i}._codebook"
        stats = layer["_codebook"]
        sd[f"{cb}.inited"] = np.asarray(stats["inited"], np.float32).reshape(1)
        for k in ("cluster_size", "embed", "embed_avg"):
            sd[f"{cb}.{k}"] = np.asarray(stats[k])
    return sd


def unconvert_plm(tree: dict) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _put_encoder(sd, "plm", tree["plm"])
    sd["predict_layer.weight"] = np.asarray(tree["predict_layer"]["kernel"]).T
    sd["pc_embedding.weight"] = np.asarray(tree["pc_embedding"]["embedding"])
    return sd


def unconvert_adm(tree: dict) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _put_encoder(sd, "adm", tree["adm"])
    for name in ("dt_linear_emb", "tc_linear_emb", "predict_layer"):
        sd[f"{name}.weight"] = np.asarray(tree[name]["kernel"]).T
    return sd


def unconvert_discriminator(tree: dict, cfg) -> Dict[str, np.ndarray]:
    """{'params', 'batch_stats'} → the reference Discriminator state dict
    (no prefix), the adv_layer kernel permuted back to the NCHW flatten."""
    sd: Dict[str, np.ndarray] = {}
    fp = (cfg.freq_length + 7) // 8
    for i, wl in enumerate(cfg.time_lengths):
        base = f"discriminator.discriminators.{i}"
        dp, ds = tree["params"][f"disc_{i}"], tree["batch_stats"][f"disc_{i}"]
        for j in range(3):
            conv = dp[f"conv_{j}"]
            sd[f"{base}.model.{j}.0.weight"] = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{base}.model.{j}.0.bias"] = np.asarray(conv["bias"])
            if j < 2:
                bn = f"{base}.model.{j}.3"
                sd[f"{bn}.weight"] = np.asarray(dp[f"bn_{j}"]["scale"])
                sd[f"{bn}.bias"] = np.asarray(dp[f"bn_{j}"]["bias"])
                sd[f"{bn}.running_mean"] = np.asarray(ds[f"bn_{j}"]["mean"])
                sd[f"{bn}.running_var"] = np.asarray(ds[f"bn_{j}"]["var"])
        tp, c = wl // 8, cfg.hidden_size
        kernel = np.asarray(dp["adv_layer"]["kernel"])[:, 0]
        sd[f"{base}.adv_layer.weight"] = kernel.reshape(tp, fp, c).transpose(2, 0, 1).reshape(1, -1)
        sd[f"{base}.adv_layer.bias"] = np.asarray(dp["adv_layer"]["bias"])
    return sd


def unconvert_hifigan(tree: dict) -> Dict[str, np.ndarray]:
    """flax HiFi-GAN params → the jik876 layout (plain weights, no weight norm)."""
    sd: Dict[str, np.ndarray] = {}
    _put_conv1d(sd, "conv_pre", tree["conv_pre"])
    _put_conv1d(sd, "conv_post", tree["conv_post"])
    for i, up in enumerate(_unstacked(tree, "ups")):
        sd[f"ups.{i}.weight"] = np.ascontiguousarray(np.asarray(up["kernel"])[::-1].transpose(1, 2, 0))
        sd[f"ups.{i}.bias"] = np.asarray(up["bias"])
    for r, block in enumerate(_unstacked(tree, "resblocks")):
        for conv in ("convs1", "convs2"):
            for j, p in enumerate(_unstacked(block, conv)):
                _put_conv1d(sd, f"resblocks.{r}.{conv}.{j}", p)
    return sd


def flatten_tree(tree: dict) -> Dict[str, np.ndarray]:
    """A flax tree as one flat dict, keys joined with '.'."""
    return {k: np.asarray(v) for k, v in _flat(tree).items()}


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out
