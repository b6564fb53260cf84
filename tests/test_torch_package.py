"""Package-level checks of the port: its configs equal the JAX dataclasses
field for field, the weight bridge consumes every flax leaf (and refuses
what it cannot place), and importing any of its modules imports no JAX,
no flax and no PyYAML."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import megatts2_tpu_torch
from megatts2_tpu_torch import config as tcfg
from megatts2_tpu_torch.bridge import load_flax_params

KEY = jax.random.PRNGKey(0)
CONFIGS = ["MRTEConfig", "VQPEConfig", "MegaGConfig", "DiscriminatorConfig", "MegaPLMConfig",
           "MegaADMConfig", "HiFiGANConfig", "VocosConfig", "WaveDiscConfig",
           "VocoderTrainConfig", "TrainConfig"]


def _default(f):
    return f.default_factory() if f.default is dataclasses.MISSING else f.default


@pytest.mark.parametrize("name", CONFIGS)
def test_config_mirrors_jax_field_for_field(name):
    from megatts2_tpu import config as jcfg

    jcls, tcls = getattr(jcfg, name), getattr(tcfg, name)
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        da, db = _default(a), _default(b)
        if dataclasses.is_dataclass(db):
            assert dataclasses.asdict(da) == dataclasses.asdict(db), a.name
        else:
            assert da == db, a.name
    assert tcls.__dataclass_params__.frozen
    for prop in ("d_model", "bos_id", "eos_id"):
        if hasattr(jcls, prop):
            assert getattr(tcls(), prop) == getattr(jcls(), prop)


def _g_vars():
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import MegaG

    cfg = jcfg.MegaGConfig(
        mrte=jcfg.MRTEConfig(mel_n_layer=1, mel_n_stack=1, mel_n_block=1, content_ff_dim=8,
                             content_n_layers=1, hidden_size=8, phone_vocab_size=12),
        vqpe=jcfg.VQPEConfig(hidden_size=8, kernel_size=3, n_layers=1, n_stacks=1, n_blocks=1,
                             vq_bins=8, vq_dim=4),
        kernel_size=3, hidden_size=8, decoder_n_stack=1, decoder_n_block=1,
    )
    v = jax.jit(MegaG(cfg).init)(
        {"params": KEY, "vq": KEY}, jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.asarray([4]), jnp.zeros((1, 32, 80)), jnp.zeros((1, 16, 80)),
    )
    tree = jax.tree_util.tree_map(np.asarray, {"params": v["params"], "vq_stats": v["vq_stats"]})
    return cfg, tree


def _torch_g(cfg):
    from megatts2_tpu_torch.models import MegaG

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["mrte"] = tcfg.MRTEConfig(**dataclasses.asdict(cfg.mrte))
    kw["vqpe"] = tcfg.VQPEConfig(**dataclasses.asdict(cfg.vqpe))
    return MegaG(tcfg.MegaGConfig(**kw))


def test_bridge_consumes_every_leaf():
    """Every flax leaf lands somewhere (the VQPE encoder and its codebook
    included), every torch parameter and buffer is filled, values arrive
    with the layout change (Dense kernel → weight.T, Conv kernel (k, in,
    out) → weight (out, in, k))."""
    cfg, tree = _g_vars()
    g = load_flax_params(_torch_g(cfg), tree)
    k = tree["params"]["mrte"]["phone_encoder"]["layers"]["attn"]["w_q"]["kernel"][0]
    np.testing.assert_array_equal(
        g.mrte.phone_encoder.layers[0].attn.w_q.weight.detach().numpy(), k.T
    )
    np.testing.assert_array_equal(
        g.vqpe.vq.layers[0]._codebook.embed.numpy(),
        tree["vq_stats"]["vqpe"]["vq"]["layers_0"]["_codebook"]["embed"],
    )
    k = tree["params"]["vqpe"]["convnet"]["first_layer"]["kernel"]
    np.testing.assert_array_equal(
        g.vqpe.convnet.first_layer.weight.detach().numpy(), k.transpose(2, 1, 0))


def test_bridge_refuses_unknown_and_missing_leaves():
    cfg, tree = _g_vars()
    extra = {"params": {**tree["params"], "mrte": {**tree["params"]["mrte"],
                                                   "bogus": {"kernel": np.zeros((2, 2))}}},
             "vq_stats": tree["vq_stats"]}
    with pytest.raises(KeyError, match="bogus"):
        load_flax_params(_torch_g(cfg), extra)
    missing = {"params": {k: v for k, v in tree["params"].items() if k != "decoder"},
               "vq_stats": tree["vq_stats"]}
    with pytest.raises(KeyError, match="decoder"):
        load_flax_params(_torch_g(cfg), missing)
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["params"]["mrte"]["norm"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="norm/scale"):
        load_flax_params(_torch_g(cfg), bad)


def test_bridge_merges_qkv_for_the_decode_layers():
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import MegaPLM as JPLM
    from megatts2_tpu_torch.models import MegaPLM

    jc = jcfg.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=4, tc_latent_dim=4, vq_bins=8)
    p = jax.tree_util.tree_map(np.asarray, JPLM(jc).init(
        KEY, jnp.zeros((1, 3, 4)), jnp.zeros((1, 4), jnp.int32), jnp.asarray([3]))["params"])
    m = load_flax_params(MegaPLM(tcfg.MegaPLMConfig(**dataclasses.asdict(jc))), p)
    att = p["plm"]["layers"]["attn"]
    want = np.concatenate([att[n]["kernel"][1] for n in ("w_q", "w_k", "w_v")], axis=1).T
    np.testing.assert_array_equal(m.plm.layers[1].attn.qkv.weight.detach().numpy(), want)


# the serving slice's modules, each of which the walk below must import
SERVING_MODULES = ["megatts2_tpu_torch." + m for m in (
    "training.convert", "training.checkpoints", "models.pretrained", "models.streaming",
    "data.manifest", "data.datasets", "continuous", "serve", "infer")]
# the data pipeline and training front door, likewise
PIPELINE_MODULES = ["megatts2_tpu_torch." + m for m in (
    "data.features", "data.sampler", "data.loader", "data.native_loader", "prepare_ds", "cli",
    "utils.plotting", "utils.logging", "tools.synth_corpus")]
# the measurement tools and the FLOP counts they report MFU from, likewise
TOOLS_MODULES = ["megatts2_tpu_torch." + m for m in (
    "utils.flops", "tools.bench_train", "tools.profile_train", "tools.http_bench",
    "tools.bench_input_pipeline", "tools.long_train", "tools.long_run_summary")]
# the quality tools, likewise
QUALITY_MODULES = ["megatts2_tpu_torch.tools." + m for m in (
    "train_curve", "e2e_quality", "quality_table", "int8_margins", "at_scale_stack",
    "heldout_eval")]


def test_port_imports_no_jax_flax_or_yaml():
    """A fresh interpreter imports every module of the package; none of
    them may pull in JAX, flax, PyYAML or any module of the JAX package
    ``megatts2_tpu`` (the port keeps its own copies)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import megatts2_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'yaml', 'megatts2_tpu'))\n"
        "assert len(names) > 20, names\n"
        f"missing = sorted(set({SERVING_MODULES + PIPELINE_MODULES + TOOLS_MODULES + QUALITY_MODULES!r}) - set(names))\n"
        "assert not missing, missing\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(megatts2_tpu_torch.__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
