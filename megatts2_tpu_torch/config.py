"""Frozen dataclass configs of the synthesis, serving and training slices.

Same names, fields and defaults as ``megatts2_tpu/config.py``; a test holds
them field for field.  They are declared here rather than imported because
``megatts2_tpu.config`` imports PyYAML at module level, which the port does
not use (the card's machine has none).  The loaders ``load_gan_config``,
``load_plm_config``, ``load_adm_config`` and ``load_vocoder_config`` read
``configs/*.yaml`` with :func:`yaml_load`, a reader of the YAML subset those
files use, and build the same dataclasses as the JAX loaders.
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from dataclasses import dataclass, field
from typing import Any, Tuple

from . import HIFIGAN_HOP_LENGTH, HIFIGAN_MEL_CHANNELS, HIFIGAN_SR


@dataclass(frozen=True)
class MRTEConfig:
    mel_bins: int = HIFIGAN_MEL_CHANNELS
    mel_frames: int = HIFIGAN_HOP_LENGTH
    mel_activation: str = "ReLU"
    mel_kernel_size: int = 3
    mel_stride: int = 16
    mel_n_layer: int = 5
    mel_n_stack: int = 5
    mel_n_block: int = 2
    content_ff_dim: int = 1024
    content_n_heads: int = 2
    content_n_layers: int = 8
    hidden_size: int = 512
    duration_token_ms: float = HIFIGAN_HOP_LENGTH / HIFIGAN_SR * 1000
    phone_vocab_size: int = 320
    dropout: float = 0.1
    sample_rate: int = HIFIGAN_SR
    use_flash: bool = False  # masked flash attention in the phone encoder


@dataclass(frozen=True)
class VQPEConfig:
    mel_bins: int = 20
    stride: int = 8
    hidden_size: int = 384
    kernel_size: int = 5
    n_layers: int = 3
    n_stacks: int = 5
    n_blocks: int = 2
    vq_bins: int = 1024
    vq_dim: int = 256
    activation: str = "ReLU"


@dataclass(frozen=True)
class MegaGConfig:
    mrte: MRTEConfig = field(default_factory=MRTEConfig)
    vqpe: VQPEConfig = field(default_factory=VQPEConfig)
    kernel_size: int = 5
    activation: str = "ReLU"
    hidden_size: int = 512
    decoder_n_stack: int = 4
    decoder_n_block: int = 2
    scan_stacks: bool = False  # JAX compile-time option; no effect here


@dataclass(frozen=True)
class DiscriminatorConfig:
    time_lengths: Tuple[int, ...] = (32, 64, 128)
    freq_length: int = 80
    kernel: Tuple[int, int] = (3, 3)
    c_in: int = 1
    hidden_size: int = 192


@dataclass(frozen=True)
class MegaPLMConfig:
    n_layers: int = 12
    n_heads: int = 16
    vq_dim: int = 512
    tc_latent_dim: int = 512
    vq_bins: int = 1024
    dropout: float = 0.1
    use_flash: bool = True  # training path only; the decode never takes it

    @property
    def d_model(self) -> int:
        return self.vq_dim + self.tc_latent_dim

    @property
    def bos_id(self) -> int:
        return self.vq_bins

    @property
    def eos_id(self) -> int:
        return self.vq_bins + 1


@dataclass(frozen=True)
class MegaADMConfig:
    n_layers: int = 8
    n_heads: int = 8
    emb_dim: int = 256
    tc_latent_dim: int = 512
    tc_emb_dim: int = 256
    dropout: float = 0.1
    max_duration_token: int = 128
    use_flash: bool = False  # training path only; the decode never takes it

    @property
    def d_model(self) -> int:
        return self.emb_dim + self.tc_emb_dim


@dataclass(frozen=True)
class HiFiGANConfig:
    """HiFi-GAN V1 generator at 16 kHz / hop 256."""

    in_channels: int = HIFIGAN_MEL_CHANNELS
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    space_to_depth_ch: int = 32  # JAX layout option; no effect here


@dataclass(frozen=True)
class VocosConfig:
    in_channels: int = HIFIGAN_MEL_CHANNELS
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = HIFIGAN_HOP_LENGTH
    mag_clip: float = 100.0


@dataclass(frozen=True)
class WaveDiscConfig:
    """The vocoder's waveform discriminators: one per period (MPD) and
    ``msd_scales`` scales (MSD), HiFi-GAN's topology."""

    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    msd_scales: int = 3
    mpd_base_ch: int = 32
    msd_base_ch: int = 128
    max_ch: int = 1024
    lrelu_slope: float = 0.1


@dataclass(frozen=True)
class VocoderTrainConfig:
    """Vocoder GAN training knobs (HiFi-GAN's recipe).  ``train_dtype`` is
    the compute dtype over fp32 master weights and optimizer state."""

    initial_learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999  # continuous exponential decay over lr_decay_steps
    lr_decay_steps: int = 1000
    max_steps: int = 400_000
    segment_frames: int = 64  # training crop in mel frames (x hop samples)
    mel_loss_coeff: float = 45.0
    fm_loss_coeff: float = 2.0
    train_dtype: str = "bfloat16"
    log_every_n_steps: int = 100
    val_check_interval: int = 1500
    save_every_n_vals: int = 1
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """PLM, ADM and GAN training knobs.  ``train_dtype`` is the
    compute dtype over fp32 master weights and optimizer state."""

    initial_learning_rate: float = 3e-5
    warmup_steps: int = 200
    max_steps: int = 600_000
    G_commit_loss_coeff: float = 0.15
    G_vq_loss_coeff: float = 0.05
    G_adv_loss_coeff: float = 1.0
    g_ema_decay: float = 0.0  # GAN stage: EMA copy of the generator when > 0
    train_dtype: str = "bfloat16"
    log_every_n_steps: int = 100
    val_check_interval: int = 1500
    save_every_n_vals: int = 1
    seed: int = 0


# ---------------------------------------------------------------- YAML

# PyYAML's YAML 1.1 resolvers for the scalars the configs hold: a float
# needs a dot (``1.0e-4`` is a float, ``1e-4`` a string, as safe_load reads them)
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")


def _scalar(text: str, where: str) -> Any:
    if text[:1] in "&*!|>{%@`":
        raise ValueError(f"{where}: YAML feature outside the configs' subset: {text!r}")
    if text[:1] in "'\"":
        if len(text) < 2 or text[-1] != text[0]:
            raise ValueError(f"{where}: unterminated quoted string {text!r}")
        return text[1:-1]
    if text[:1] == "[":
        return _flow_list(text, where)
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    if ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: a mapping inside a value: {text!r}")
    return text


def _flow_list(text: str, where: str) -> list:
    """``[a, b, [c, d]]`` of scalars and nested flow lists."""
    if not text.endswith("]"):
        raise ValueError(f"{where}: unterminated flow list {text!r}")
    items, depth, cur = [], 0, ""
    for ch in text[1:-1]:
        if ch == "," and depth == 0:
            items.append(cur.strip())
            cur = ""
            continue
        depth += (ch == "[") - (ch == "]")
        cur += ch
    if cur.strip():
        items.append(cur.strip())
    elif items:
        raise ValueError(f"{where}: empty item in {text!r}")
    return [_scalar(item, where) for item in items]


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one at its start or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def yaml_load(text: str) -> Any:
    """The subset of YAML that ``configs/*.yaml`` use, read as
    ``yaml.safe_load`` reads it: nested block mappings by indentation,
    block lists (``- item``) of scalars, flow lists (``[1, 2]``), comments,
    ints, floats such as ``1.0e-4``, bools, nulls and plain or quoted
    strings.  Anything else (anchors, tags, multi-line strings, flow
    mappings, several documents, tabs in the indentation) raises."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if raw.strip() in ("---", "...") and not lines:
            if raw.strip() == "...":
                raise ValueError(f"line {n}: document end marker")
            continue
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        if line[indent] == "\t":
            raise ValueError(f"line {n}: tab in the indentation")
        if line.strip() in ("---", "..."):
            raise ValueError(f"line {n}: more than one YAML document")
        lines.append((n, indent, line.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][1])
    if end != len(lines):
        raise ValueError(f"line {lines[end][0]}: indentation does not match an enclosing block")
    return value


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, float):
        text = repr(v)
        # the reader, as PyYAML's resolver, takes a float only with a dot
        return text if "." in text else re.sub(r"^(-?\d+)", r"\1.0", text)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    return str(v)


def yaml_dump(d: dict, indent: int = 0) -> str:
    """Nested mappings of scalars and flow lists as block YAML, in the subset
    that :func:`yaml_load` reads back to the same values."""
    out = ""
    for k, v in d.items():
        if isinstance(v, dict):
            out += f"{' ' * indent}{k}:\n" + yaml_dump(v, indent + 2)
        else:
            out += f"{' ' * indent}{k}: {_yaml_scalar(v)}\n"
    return out


def _block(lines: list, i: int, indent: int):
    """The mapping or list whose entries start at ``lines[i]`` with this
    indentation; returns it and the index of the first line after it."""
    if lines[i][2].startswith("- ") or lines[i][2] == "-":
        out: list = []
        while i < len(lines) and lines[i][1] == indent and lines[i][2][:1] == "-":
            n, _, body = lines[i]
            item = body[1:].strip()
            if not item or (":" in item and not item.startswith(("'", '"', "["))):
                raise ValueError(f"line {n}: only scalar list items are read")
            out.append(_scalar(item, f"line {n}"))
            i += 1
        return out, i
    mapping: dict = {}
    while i < len(lines) and lines[i][1] == indent:
        n, _, body = lines[i]
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith(" ")) or not key or key[:1] in "-?[{'\"":
            raise ValueError(f"line {n}: expected 'key: value', got {body!r}")
        key = key.strip()
        if key in mapping:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        rest = rest.strip()
        i += 1
        if rest:
            mapping[key] = _scalar(rest, f"line {n}")
        elif i < len(lines) and (lines[i][1] > indent or
                                 (lines[i][1] == indent and lines[i][2][:1] == "-")):
            mapping[key], i = _block(lines, i, lines[i][1])
        else:
            mapping[key] = None
    if i < len(lines) and lines[i][1] > indent:
        raise ValueError(f"line {lines[i][0]}: unexpected indentation")
    return mapping, i


def _read_yaml(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return yaml_load(f.read())


# ---------------------------------------------------------------- loaders


def _build(cls, d: dict, strict_source: bool = False) -> Any:
    """A dataclass from a plain dict, as ``megatts2_tpu/config.py``'s
    ``_build``: the reference's ``{class_path, init_args}`` wrapper is
    accepted, lists become tuples (of tuples), unknown keys are ignored
    (with a warning when ``strict_source``, i.e. ``d`` holds only knobs of
    ``cls``)."""
    if isinstance(d, dict) and "init_args" in d:
        d = d["init_args"]
        strict_source = True
    known = {f.name for f in dataclasses.fields(cls)}
    if strict_source:
        for k in d:
            if k not in known and k != "class_path":
                warnings.warn(f"config key '{k}' is not a knob of {cls.__name__}; ignored (typo?)",
                              stacklevel=2)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, list):
            v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
        kwargs[f.name] = v
    return cls(**kwargs)


def load_gan_config(path: str) -> tuple[MegaGConfig, DiscriminatorConfig, TrainConfig]:
    cfg = _read_yaml(path)
    m = cfg["model"]
    g_args = dict(m["G"].get("init_args", m["G"]))
    g = MegaGConfig(
        mrte=_build(MRTEConfig, g_args["mrte"]),
        vqpe=_build(VQPEConfig, g_args["vqpe"]),
        **{k: v for k, v in g_args.items() if k not in ("mrte", "vqpe", "class_path")},
    )
    d = _build(DiscriminatorConfig, m.get("D", {}))
    t = _build(TrainConfig, {**m, **(cfg.get("trainer") or {})})
    return g, d, t


def load_vocoder_config(path: str):
    """Vocoder-training YAML → (voc_cfg, WaveDiscConfig, VocoderTrainConfig);
    ``model.vocoder.family`` picks ``vocos`` (default) or ``hifigan``."""
    cfg = _read_yaml(path)
    m = cfg["model"]
    v = dict(m.get("vocoder", {}))
    family = v.pop("family", "vocos")
    if family not in ("vocos", "hifigan"):
        raise ValueError(f"unknown vocoder family {family!r}")
    vcls = VocosConfig if family == "vocos" else HiFiGANConfig
    voc = _build(vcls, v.get("init_args", v), strict_source=True)
    d = _build(WaveDiscConfig, m.get("D", {}))
    t = _build(VocoderTrainConfig, {**m, **(cfg.get("trainer") or {})})
    return voc, d, t


def load_plm_config(path: str) -> tuple[MegaPLMConfig, TrainConfig]:
    cfg = _read_yaml(path)
    return (_build(MegaPLMConfig, cfg["model"]["plm"]),
            _build(TrainConfig, {**cfg["model"], **(cfg.get("trainer") or {})}))


def load_adm_config(path: str) -> tuple[MegaADMConfig, TrainConfig]:
    cfg = _read_yaml(path)
    return (_build(MegaADMConfig, cfg["model"]["adm"]),
            _build(TrainConfig, {**cfg["model"], **(cfg.get("trainer") or {})}))
