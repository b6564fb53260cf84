"""Checkpoints of the port (port of ``megatts2_tpu/training/checkpoints.py``).

A checkpoint is one file written by ``torch.save``::

    {"state_dict": {...}, "optimizer_states": [...], "lr_schedulers": [...],
     "generators": {...}, "global_step": N}

``state_dict`` holds the models in the reference's Lightning layout
(:func:`model_state_dict`): MegaG under ``G.``, the Discriminator under
``D.``, the PLM under ``plm.``, the ADM under ``adm.``, a HiFi-GAN
generator in the jik876 layout without a prefix; the models without a
reference layout (Vocos, the wave discriminator) as their flattened flax
tree under ``vocos.`` and ``wave_D.``.  So the JAX package's
``load_torch_state_dict`` + ``convert_*`` read what the port writes, and
the port's loaders (``models/pretrained.py``) read the reference's
checkpoints and its own alike.

A train state placed on a mesh (``parallel.place_train_state``) is
written in the same one-device layout: every rank takes part in a save
(the tensor-parallel slices and their AdamW moments are gathered over the
model group, a ZeRO-1 optimizer consolidated over the data group) and
global rank 0 writes.  A restore reads the one-device layout and keeps
each rank's slices, so a checkpoint written at any mesh resumes at any
other.

Retention follows the JAX trainers' policy: the top-``keep`` checkpoints by
the monitored validation metric (lower is better; unscored steps rank
last) plus the latest step, with the scores in a ``scores.json`` beside
them.  Files are ``step_<N>.ckpt``.  A writer copies the state to the host
first and only then takes the directory's exclusive ``fcntl`` lock
(``.save.lock``) to write, rename into place and prune; readers take the
shared lock, so a reader never sees a half-written or pruned file and a
second writer into the same directory waits for the first.
"""
from __future__ import annotations

import fcntl
import json
import logging
import os
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from . import convert

LOCK = ".save.lock"


# ------------------------------------------------------------- model layouts


def _layout(module: nn.Module):
    """(prefix, flax tree → reference state dict, reference state dict →
    flax tree) for ``module``'s type."""
    from ..models import MegaADM, MegaG, MegaPLM
    from ..models.dscrm import Discriminator
    from ..models.hifigan import HiFiGAN
    from ..models.vocos import Vocos
    from ..models.wave_dscrm import WaveDiscriminator

    cfg = getattr(module, "cfg", None)
    table = {
        MegaG: ("G.", convert.unconvert_megag, lambda sd: convert.convert_megag(sd, cfg)),
        Discriminator: ("D.", lambda t: convert.unconvert_discriminator(t, cfg),
                        lambda sd: convert.convert_discriminator(sd, cfg)),
        MegaPLM: ("plm.", convert.unconvert_plm, lambda sd: convert.convert_plm(sd, cfg)),
        MegaADM: ("adm.", convert.unconvert_adm, lambda sd: convert.convert_adm(sd, cfg)),
        HiFiGAN: ("", convert.unconvert_hifigan, lambda sd: convert.convert_hifigan(sd, cfg)),
        Vocos: ("vocos.", convert.flatten_tree, convert.unflatten_tree),
        WaveDiscriminator: ("wave_D.", convert.flatten_tree, convert.unflatten_tree),
    }
    if type(module) not in table:
        raise TypeError(f"no checkpoint layout for {type(module).__name__}")
    return table[type(module)]


def model_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s weights in the reference layout, prefixed, fp32 CPU tensors."""
    from ..bridge import export_flax_params

    prefix, to_ref, _ = _layout(module)
    sd = to_ref(export_flax_params(module))
    return {prefix + k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}


def load_model_state_dict(module: nn.Module, sd: Dict[str, Any]) -> nn.Module:
    """Fill ``module`` in place from a reference-layout state dict (keys of
    other models are ignored; any of this model's that are missing raise)."""
    from ..bridge import load_flax_params

    prefix, _, from_ref = _layout(module)
    own = {k[len(prefix):]: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
           for k, v in sd.items() if k.startswith(prefix)}
    return load_flax_params(module, from_ref(own))


# ------------------------------------------------------------ train states


def _parts(state) -> tuple[list, list, list, dict]:
    """(models, optimizers, schedulers, generators) of a train state."""
    from .gan_trainer import GANTrainState
    from .lm_trainers import TrainState
    from .vocoder_trainer import VocoderTrainState

    if isinstance(state, TrainState):
        return [state.model], [state.opt], [state.sched], {"dropout": state.generator}
    if isinstance(state, GANTrainState):
        return ([state.g, state.d], [state.g_opt, state.d_opt], [state.g_sched, state.d_sched],
                {"draws": state.draws.generator, "draws_host": state.draws.host_generator})
    if isinstance(state, VocoderTrainState):
        return [state.g, state.d], [state.g_opt, state.d_opt], [state.g_sched, state.d_sched], {}
    raise TypeError(f"no checkpoint layout for {type(state).__name__}")


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _is_main(state) -> bool:
    mesh = getattr(state, "mesh", None)
    return mesh is None or mesh.is_main


def train_state_dict(state) -> Optional[dict]:
    """The whole train state on the host: models in the reference layout,
    optimizer and scheduler states, generator states, the step.  On a mesh
    every rank calls it and rank 0 gets the dict, the others None."""
    from ..parallel import full_optimizer_state, full_weights
    from ..parallel.sharding import full_tensors

    mesh = getattr(state, "mesh", None)
    main = _is_main(state)
    models, opts, scheds, gens = _parts(state)
    sd: Dict[str, torch.Tensor] = {}
    for m in models:
        with full_weights(m, gather=True):
            if main:
                sd.update(model_state_dict(m))
    opt_states = [full_optimizer_state(o, m, mesh) for o, m in zip(opts, models)]
    g_ema = getattr(state, "g_ema", None)
    if g_ema is not None:
        g_ema = full_tensors(g_ema, models[0])
    if not main:
        return None
    out = {"state_dict": sd, "optimizer_states": [_to_host(o) for o in opt_states],
           "lr_schedulers": [s.state_dict() for s in scheds],
           "generators": {k: g.get_state() for k, g in gens.items()},
           "global_step": int(state.step)}
    if g_ema is not None:
        out["g_ema"] = _to_host(g_ema)
    return out


def load_train_state_dict(state, ckpt: dict):
    """Restore ``state`` in place from :func:`train_state_dict`'s dict (each
    rank of a placed state keeps its slices)."""
    from ..parallel import full_weights, load_full_optimizer_state
    from ..parallel.sharding import local_tensors

    models, opts, scheds, gens = _parts(state)
    for m in models:
        with full_weights(m, gather=False):
            load_model_state_dict(m, ckpt["state_dict"])
    for o, m, s in zip(opts, models, ckpt["optimizer_states"]):
        load_full_optimizer_state(o, m, s)
    for sch, s in zip(scheds, ckpt["lr_schedulers"]):
        sch.load_state_dict(s)
    for k, g in gens.items():
        g.set_state(ckpt["generators"][k])
    if "g_ema" in ckpt:
        dev = next(models[0].parameters()).device
        state.g_ema = local_tensors({k: v.to(dev) for k, v in ckpt["g_ema"].items()}, models[0])
    state.step = int(ckpt["global_step"])
    return state


# ------------------------------------------------------------ files


@contextmanager
def _locked(ckpt_dir: str, exclusive: bool):
    """The directory's ``.save.lock``, exclusive for a writer, shared for a reader."""
    f = open(os.path.join(ckpt_dir, LOCK), "a")
    try:
        mode = fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH
        try:
            fcntl.flock(f, mode | fcntl.LOCK_NB)
        except OSError:
            if exclusive:
                logging.getLogger("megatts2_tpu_torch.checkpoints").warning(
                    "another process is saving into %s; waiting for its save to finish", ckpt_dir)
            fcntl.flock(f, mode)
        yield
    finally:
        try:
            fcntl.flock(f, fcntl.LOCK_UN)
        finally:
            f.close()


def _scores_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "scores.json")


def _load_scores(ckpt_dir: str) -> Dict[str, float]:
    try:
        with open(_scores_path(ckpt_dir)) as f:
            return {k: float(v) for k, v in json.load(f).items()}
    except (OSError, ValueError):
        return {}


def _steps(ckpt_dir: str) -> list[tuple[int, str]]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for n in os.listdir(ckpt_dir):
        stem = n[len("step_"):-len(".ckpt")] if n.startswith("step_") and n.endswith(".ckpt") else ""
        if stem.isdigit():
            out.append((int(stem), n))
    return sorted(out)


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 5,
                    metric: Optional[float] = None) -> str:
    """Write ``state`` as ``step_{step}.ckpt`` and prune to the top-``keep``
    by ``metric`` (ascending) plus the latest step.  The state is copied to
    the host before the exclusive lock is taken.  On a mesh every rank
    calls it, rank 0 writes, and every rank returns once the file is there."""
    from ..parallel.collectives import barrier

    ckpt_dir = os.path.abspath(ckpt_dir)
    payload = train_state_dict(state)
    path = os.path.join(ckpt_dir, f"step_{step}.ckpt")
    if payload is not None:
        _write(ckpt_dir, path, payload, step, keep, metric)
    barrier(getattr(state, "mesh", None))
    return path


def _write(ckpt_dir: str, path: str, payload: dict, step: int, keep: int,
           metric: Optional[float]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    with _locked(ckpt_dir, exclusive=True):
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        scores = _load_scores(ckpt_dir)
        if metric is not None:
            scores[str(step)] = float(metric)
        _prune(ckpt_dir, keep, scores)


def _prune(ckpt_dir: str, keep: int, scores: Dict[str, float]) -> None:
    """Keep the ``keep`` best by score (unscored last) + the latest; remove
    the rest, and write the scores of what stays.  Runs under the lock."""
    steps = _steps(ckpt_dir)
    if steps:
        latest = steps[-1][0]
        by_score = sorted(steps, key=lambda sn: (scores.get(str(sn[0]), float("inf")), -sn[0]))
        keep_steps = {s for s, _ in by_score[:keep]} | {latest}
        for s, name in steps:
            if s not in keep_steps:
                os.remove(os.path.join(ckpt_dir, name))
                scores.pop(str(s), None)
    with open(_scores_path(ckpt_dir), "w") as f:
        json.dump(scores, f)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    steps = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, steps[-1][1]) if steps else None


def best_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The best-scored checkpoint (the latest when none is scored)."""
    live = {str(s): n for s, n in _steps(ckpt_dir)}
    scored = [(v, k) for k, v in _load_scores(ckpt_dir).items() if k in live]
    if not scored:
        return latest_checkpoint(ckpt_dir)
    return os.path.join(ckpt_dir, live[min(scored)[1]])


def read_checkpoint(path: str) -> Any:
    """``torch.load`` of a checkpoint file onto the CPU, under the shared
    lock of its directory when the directory has one (a reference
    checkpoint elsewhere is read as it is)."""
    lock_dir = os.path.dirname(os.path.abspath(path))
    if not os.path.exists(os.path.join(lock_dir, LOCK)):
        return torch.load(path, map_location="cpu", weights_only=False)
    with _locked(lock_dir, exclusive=False):
        return torch.load(path, map_location="cpu", weights_only=False)


def restore_checkpoint(path: str, state):
    """Restore ``state`` in place from a checkpoint file, or from the latest
    ``step_*.ckpt`` of a directory."""
    if os.path.isdir(path):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no step_*.ckpt checkpoints under {path}")
        path = latest
    return load_train_state_dict(state, read_checkpoint(path))
