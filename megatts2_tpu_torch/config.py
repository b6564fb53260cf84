"""Frozen dataclass configs of the synthesis, serving and training slices.

Same names, fields and defaults as ``megatts2_tpu/config.py``; a test holds
them field for field.  They are declared here rather than imported because
``megatts2_tpu.config`` imports PyYAML at module level, which the port does
not need.  The YAML loaders stay with the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

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
