"""The port's YAML reader and config loaders (``megatts2_tpu_torch/config.py``)
against PyYAML and the JAX package's loaders: the reader gives what
``yaml.safe_load`` gives on every ``configs/*.yaml`` and on the subset's
corner cases, raises outside the subset, and the four loaders build the
JAX loaders' dataclasses field for field."""
import dataclasses
import glob
import os

import pytest
import yaml

from megatts2_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_safe_load_on_shipped_configs(path):
    text = open(path).read()
    assert tcfg.yaml_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1e-4\nb: 1.0e-4\nc: 3.0E+5\nd: .5\ne: 1.\nf: -2\ng: +7\nh: 1_000",
    "a: [1, [2, 3], x]\nb: []\nc: [ 4 ]",
    "a:\n  - 1\n  - x\n  - 2.5\nb: 3",
    "a:\n- 1\n- 2\nb:\n  c:\n    d: 1\n  e: 2\nf: 3",
    "a: \"x # y\"  # comment\nb: 'q'\n# whole line\n\nc: plain text",
    "a: yes\nb: Off\nc: ~\nd:\ne: null\nf: true",
    "---\na: 1",
])
def test_reader_equals_safe_load_on_the_subset(text):
    assert tcfg.yaml_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x", "a: {b: 1}",
    "a: 1\n---\nb: 2", "a:\n  - b: 1", "a:\n\t- 1", "a: 1\n  b: 2", "a: 1\na: 2",
])
def test_reader_raises_outside_the_subset(text):
    with pytest.raises(ValueError):
        tcfg.yaml_load(text)


def _same(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b):
            _same(a, b)
        else:
            assert a == b and type(a) is type(b), (f.name, a, b)


@pytest.mark.parametrize("loader,name", [
    ("load_gan_config", "config_gan.yaml"), ("load_plm_config", "config_plm.yaml"),
    ("load_adm_config", "config_adm.yaml"), ("load_vocoder_config", "config_vocoder.yaml"),
])
def test_loaders_equal_jax_field_for_field(loader, name):
    from megatts2_tpu import config as jcfg

    path = os.path.join(ROOT, "configs", name)
    got, want = getattr(tcfg, loader)(path), getattr(jcfg, loader)(path)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b)


def test_vocoder_loader_takes_hifigan_and_warns_on_typos(tmp_path):
    from megatts2_tpu import config as jcfg

    p = tmp_path / "voc.yaml"
    p.write_text("model:\n  vocoder:\n    family: hifigan\n    init_args:\n"
                 "      upsample_rates: [8, 8, 4]\n      lrelu_slop: 0.2\n")
    with pytest.warns(UserWarning, match="lrelu_slop"):
        got = tcfg.load_vocoder_config(str(p))
    with pytest.warns(UserWarning):
        want = jcfg.load_vocoder_config(str(p))
    for a, b in zip(got, want):
        _same(a, b)
    assert got[0].upsample_rates == (8, 8, 4)
