"""``from_pretrained``-style loaders (port of ``megatts2_tpu/models/pretrained.py``).

Each reads a torch checkpoint file (``.ckpt``, ``.pt``, ``.pth``): a
reference Lightning checkpoint or one the port wrote
(``training/checkpoints.py``), both in the reference's layout, prefixes
``G.``, ``D.``, ``plm.``, ``adm.``; or a directory of the port's
``step_*.ckpt`` files, whose latest is read.  The JAX trainers' orbax
directories are read by the JAX package only: the port raises on one.
Each returns ``(cfg, module)``, the module on the CPU in fp32.  A GAN
train state that holds an EMA generator (``g_ema``, trained with
``g_ema_decay`` > 0) gives that generator, as JAX's
``load_generator_from_orbax`` does.
"""
from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..config import (HiFiGANConfig, MegaADMConfig, MegaGConfig, MegaPLMConfig, VocosConfig,
                      load_adm_config, load_gan_config, load_plm_config, load_vocoder_config)
from ..training.checkpoints import latest_checkpoint, load_model_state_dict, read_checkpoint


def _is_torch(path: str) -> bool:
    return path.endswith((".ckpt", ".pt", ".pth"))


def _ckpt_file(path: str) -> str:
    """The torch checkpoint file ``path`` names: itself, or the latest
    ``step_*.ckpt`` of a directory of the port's checkpoints."""
    if os.path.isdir(path):
        latest = latest_checkpoint(path)
        if latest is not None:
            return latest
    elif _is_torch(path):
        return path
    raise ValueError(f"{path}: the port reads only torch checkpoints (.ckpt, .pt, .pth, or a "
                     "directory of step_*.ckpt); an orbax directory is read by the JAX package")


def _load(module: nn.Module, ckpt: str) -> nn.Module:
    obj = read_checkpoint(_ckpt_file(ckpt))
    return load_model_state_dict(module, obj.get("state_dict", obj)).eval()


def megag_from_pretrained(ckpt: str, config: str) -> Tuple[MegaGConfig, nn.Module]:
    """(cfg, MegaG) from ``state_dict``; when the checkpoint holds ``g_ema``
    (a GAN train state with ``g_ema_decay`` > 0), each parameter it names
    takes its EMA value, and the buffers (the codebook and its statistics)
    stay those of ``state_dict``, as JAX pairs ``g_ema`` with ``vq_stats``.
    Validation and top-k selection score those weights."""
    from .megag import MegaG

    g_cfg, _, _ = load_gan_config(config)
    obj = read_checkpoint(_ckpt_file(ckpt))
    g = load_model_state_dict(MegaG(g_cfg), obj.get("state_dict", obj)).eval()
    ema = obj.get("g_ema")
    if ema:
        params = dict(g.named_parameters())
        with torch.no_grad():
            for name, value in ema.items():
                params[name].copy_(value)
    return g_cfg, g


def discriminator_from_pretrained(ckpt: str, config: str):
    """(cfg, Discriminator) from a GAN checkpoint's ``D.`` keys."""
    from .dscrm import Discriminator

    _, d_cfg, _ = load_gan_config(config)
    return d_cfg, _load(Discriminator(d_cfg), ckpt)


def plm_from_pretrained(ckpt: str, config: str) -> Tuple[MegaPLMConfig, nn.Module]:
    from .plm import MegaPLM

    cfg, _ = load_plm_config(config)
    return cfg, _load(MegaPLM(cfg), ckpt)


def adm_from_pretrained(ckpt: str, config: str) -> Tuple[MegaADMConfig, nn.Module]:
    from .adm import MegaADM

    cfg, _ = load_adm_config(config)
    return cfg, _load(MegaADM(cfg), ckpt)


def hifigan_from_pretrained(ckpt: str, cfg: Optional[HiFiGANConfig] = None):
    """(cfg, HiFiGAN) from a jik876 / speechbrain layout checkpoint (weight
    norm folded), or one the port wrote."""
    from .hifigan import HiFiGAN

    cfg = cfg or HiFiGANConfig()
    return cfg, _load(HiFiGAN(cfg), ckpt)


def vocoder_from_pretrained(vocoder: str = "hifigan", vocoder_ckpt: Optional[str] = None,
                            hifigan_ckpt: Optional[str] = None,
                            vocoder_config: Optional[str] = None, seed: int = 0):
    """(cfg, vocoder module) for either family.  ``vocoder_ckpt`` is a
    checkpoint of the port's vocoder training stage (either family);
    ``hifigan_ckpt`` a HiFi-GAN torch checkpoint; neither: seeded random
    weights (mel-faithful smoke runs, the audio is noise).  The config is
    read from ``vocoder_config`` when it names this family, as in JAX."""
    from .hifigan import HiFiGAN
    from .megatts import init_random_
    from .vocos import Vocos

    cfg = None
    if vocoder_config and os.path.exists(vocoder_config):
        cfg, _, _ = load_vocoder_config(vocoder_config)
        if ("vocos" if isinstance(cfg, VocosConfig) else "hifigan") != vocoder:
            cfg = None  # the config is for the other family
    if vocoder == "vocos":
        cfg = cfg or VocosConfig()
        module = Vocos(cfg)
    else:
        cfg = cfg or HiFiGANConfig()
        module = HiFiGAN(cfg)
    if vocoder_ckpt:
        return cfg, _load(module, vocoder_ckpt)
    if hifigan_ckpt and vocoder == "hifigan":
        return cfg, _load(module, hifigan_ckpt)
    with torch.no_grad():
        return cfg, init_random_(module, torch.Generator().manual_seed(seed)).eval()


def megatts_from_pretrained(
    g_ckpt: str,
    g_config: str,
    plm_ckpt: str,
    plm_config: str,
    adm_ckpt: str,
    adm_config: str,
    symbol_table: str,
    hifigan_ckpt: Optional[str] = None,
    vocoder: str = "hifigan",
    vocoder_ckpt: Optional[str] = None,
    vocoder_config: Optional[str] = None,
    **kwargs: Any,
):
    """The reference's ``Megatts(...)`` constructor shape → a ready
    :class:`Megatts` (``kwargs`` go to it: ``device``, ``dtype``,
    ``max_frames``, ...).  Without a vocoder checkpoint the vocoder has
    random weights (mel-faithful, the audio is noise)."""
    from .megatts import Megatts

    _, g = megag_from_pretrained(g_ckpt, g_config)
    _, plm = plm_from_pretrained(plm_ckpt, plm_config)
    _, adm = adm_from_pretrained(adm_ckpt, adm_config)
    _, voc = vocoder_from_pretrained(vocoder, vocoder_ckpt, hifigan_ckpt, vocoder_config)
    return Megatts(g, plm, adm, voc, symbol_table, **kwargs)
