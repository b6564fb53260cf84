"""Shared fixtures of the port's pipeline tests (no JAX): the tiny stage
configs, a G checkpoint with a live codebook, and the port's stages 0-2
over a synthetic corpus (2 speakers × 5 utterances of 2.5-3.0 s).  Used by
``test_torch_prepare_ds.py``, ``test_torch_cli.py`` and, on the card,
``test_torch_pipeline_cuda.py``."""
import os

import pytest
import torch

from megatts2_tpu_torch import prepare_ds
from megatts2_tpu_torch.tools.synth_corpus import build_corpus

N_SPK, N_UTT, DURS = 2, 5, (2.5, 3.0)  # ≤ 187 frames: stage 2's T of 192 at B 8
RATIO = "0.2"  # every 5th utterance to valid: 8 train cuts, 2 valid

GAN_YAML = """trainer:
  max_steps: {steps}
  log_every_n_steps: 1
  val_check_interval: {val}
model:
  G:
    mrte:
      mel_bins: 80
      mel_stride: 16
      mel_n_layer: 1
      mel_n_stack: 1
      mel_n_block: 1
      content_ff_dim: 32
      content_n_heads: 2
      content_n_layers: 1
      hidden_size: 16
      phone_vocab_size: 64
      dropout: 0.0
    vqpe:
      mel_bins: 20
      stride: 8
      hidden_size: 16
      kernel_size: 3
      n_layers: 1
      n_stacks: 1
      n_blocks: 1
      vq_bins: 32
      vq_dim: 8
    kernel_size: 3
    hidden_size: 16
    decoder_n_stack: 1
    decoder_n_block: 1
  D:
    time_lengths: [8, 16]
    freq_length: 80
    hidden_size: 8
  initial_learning_rate: 1.0e-4
  warmup_steps: 1
  train_dtype: float32
data:
  ds_path: {ds}/
  max_duration_batch: 30
  min_duration: 0.5
  max_duration: 30
  num_buckets: 1
"""


def write_g_ckpt(gan_yaml: str, path: str) -> None:
    """A reference-layout G ``.ckpt`` of seeded random weights with a live
    codebook (initialised, random entries)."""
    from megatts2_tpu_torch.config import load_gan_config
    from megatts2_tpu_torch.models import MegaG, init_random_
    from megatts2_tpu_torch.training.checkpoints import model_state_dict

    g_cfg, _, _ = load_gan_config(gan_yaml)
    gen = torch.Generator().manual_seed(1)
    g = init_random_(MegaG(g_cfg), gen)
    with torch.no_grad():
        for p in g.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
        cb = g.vqpe.vq.layers[0]._codebook
        cb.inited.fill_(1.0)
        cb.cluster_size.fill_(1.0)
        cb.embed_avg.copy_(cb.embed)
    torch.save({"state_dict": model_state_dict(g)}, path)


def stage1(root: str, ds: str, device: str = "cpu") -> dict:
    """The port's stages 0 and 1 on ``device`` over the corpus under ``root``."""
    wavs, tgs = os.path.join(root, "wavs"), os.path.join(root, "textgrids")
    prepare_ds.main(["--stage", "0", "--wavtxt_path", wavs, "--num_workers", "2"])
    return prepare_ds.main(["--stage", "1", "--wavtxt_path", wavs, "--text_grid_path", tgs,
                       "--ds_path", ds, "--test_set_ratio", RATIO, "--num_workers", "2",
                       "--device", device])


PLM_YAML = """trainer:
  max_steps: {steps}
  log_every_n_steps: 1
  val_check_interval: {val}
model:
  plm:
    n_layers: 2
    n_heads: 2
    vq_dim: 8
    tc_latent_dim: 16
    vq_bins: 32
    dropout: 0.0
  initial_learning_rate: 1.0e-3
  warmup_steps: 1
  train_dtype: float32
data:
  ds_path: {ds}/
  min_duration: 0.5
  max_duration: 30
  max_n_cuts: 8
"""
ADM_YAML = """trainer:
  max_steps: {steps}
  log_every_n_steps: 1
  val_check_interval: {val}
model:
  adm:
    n_layers: 2
    n_heads: 2
    emb_dim: 8
    tc_latent_dim: 16
    tc_emb_dim: 8
    dropout: 0.0
  initial_learning_rate: 1.0e-3
  warmup_steps: 1
  train_dtype: float32
data:
  ds_path: {ds}/
  max_duration_batch: 400
  min_duration: 0.5
  max_duration: 30
  num_buckets: 1
"""
VOC_YAML = """trainer:
  max_steps: {steps}
  log_every_n_steps: 1
  val_check_interval: {val}
model:
  vocoder:
    family: vocos
    init_args:
      dim: 16
      intermediate_dim: 32
      num_layers: 1
  D:
    periods: [2, 3]
    msd_scales: 2
    mpd_base_ch: 4
    msd_base_ch: 8
    max_ch: 16
  segment_frames: 8
  train_dtype: float32
data:
  ds_path: {ds}/
  batch_size: 4
  min_duration: 0.5
  max_duration: 30
"""
YAMLS = {"gan": GAN_YAML, "plm": PLM_YAML, "adm": ADM_YAML, "vocoder": VOC_YAML}




@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the torch work of each module that imports
    this fixture, restored after.  The
    suite runs files in parallel processes, and torch's threads in each
    oversubscribe the host's cores: with 7 busy processes on 8 cores, a
    tiny vocoder fit and resume took 31.4 s on 8 threads and 0.7 s on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(tmp, stage: str, ds: str, steps: int, val: int = 100) -> str:
    """A tiny config of ``stage`` over ``ds`` in ``tmp``; returns its path."""
    path = os.path.join(tmp, f"{stage}_{steps}.yaml")
    with open(path, "w") as f:
        f.write(YAMLS[stage].format(steps=steps, val=val, ds=ds))
    return path


def prepare_dataset(root: str, device: str) -> str:
    """The port's stages 0-2 on ``device`` over a corpus built under
    ``root`` (stage 2 from :func:`write_g_ckpt`'s G); returns the dataset path."""
    build_corpus(root, N_SPK, N_UTT, seed=0, dur_range=DURS)
    ds = os.path.join(root, "ds")
    stage1(root, ds, device)
    gan = config(root, "gan", ds, 1, 1)
    write_g_ckpt(gan, os.path.join(root, "g.ckpt"))
    prepare_ds.main(["--stage", "2", "--ds_path", ds, "--generator_ckpt",
                     os.path.join(root, "g.ckpt"), "--generator_config", gan, "--device", device])
    return ds
