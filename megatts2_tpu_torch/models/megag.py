"""MegaG — the VQ-GAN mel autoencoder, the generator (port of
``megatts2_tpu/models/megag.py``).

``forward`` composes the VQPE prosody latents with the MRTE's
length-regulated content latents and decodes them to an 80-bin mel with a
ConvNet: ``(mel_hat, commit_loss, vq_loss)``.  In train mode dropout
masks and codebook samples come from ``draws``, and the codebook takes its
EMA update.  ``s2_latent`` gives ``(tc_latent, codes)`` for the stage-2
latent extraction; ``decode_latents`` is the synthesis half, decoding
frame-rate latents with codes looked up in ``vqpe.vq``.

``dtype`` is the compute dtype: the parameters stay as they are (fp32
masters in training) and each layer casts them to it, as flax's
``dtype=``; the codebook works in fp32 throughout.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import MegaGConfig
from ..nn import ConvNet, Draws, train_draws
from .mrte import MRTE
from .vqpe import VQProsodyEncoder


class MegaG(nn.Module):
    def __init__(self, cfg: MegaGConfig = MegaGConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.mrte = MRTE(c.mrte)
        self.vqpe = VQProsodyEncoder(c.vqpe)
        self.decoder = ConvNet(
            in_channels=c.mrte.hidden_size + c.vqpe.vq_dim, out_channels=c.mrte.mel_bins,
            hidden_size=c.hidden_size, n_stacks=c.decoder_n_stack,
            n_blocks=c.decoder_n_block, kernel_size=c.kernel_size, activation=c.activation,
        )

    def forward(
        self,
        duration_tokens: torch.Tensor,  # (B, Tp)
        phone: torch.Tensor,  # (B, Tp)
        phone_lens: torch.Tensor,  # (B,)
        mel_mrte: torch.Tensor,  # (B, Tm_prompt, mel_bins)
        mel_vqpe: torch.Tensor,  # (B, Tm, mel_bins)
        train: bool = False,
        draws: Optional[Draws] = None,
        dtype: torch.dtype = torch.float32,
    ):
        """→ (mel_hat (B, Tm, mel_bins) in ``dtype``, commit_loss, vq_loss)."""
        draws = train_draws(train, draws)
        zq, commit_loss, vq_loss, _ = self.vqpe(mel_vqpe, train, draws, dtype)
        x = self.mrte(duration_tokens, phone, phone_lens, mel_mrte, mel_vqpe.shape[1],
                      train, draws, dtype)
        mel_hat = self.decoder(torch.cat([x, zq], dim=-1), draws)
        return mel_hat, commit_loss, vq_loss

    def s2_latent(
        self,
        phone: torch.Tensor,
        phone_lens: Optional[torch.Tensor],
        mel_mrte: torch.Tensor,
        mel_vqpe: torch.Tensor,
    ):
        """→ (tc_latent (B, Tp, hidden), codes (1, B, ceil(Tm / 8))), eval mode."""
        _, _, _, codes = self.vqpe(mel_vqpe)
        return self.mrte.tc_latent(phone, mel_mrte, phone_lens), codes

    def decode_latents(self, tc_latent_expand: torch.Tensor, zq: torch.Tensor) -> torch.Tensor:
        """Concat frame-rate latents (B, Tf, H) and prosody latents
        (B, >=Tf, vq_dim), then decode → mel (B, Tf, mel_bins)."""
        T = tc_latent_expand.shape[1]
        x = torch.cat([tc_latent_expand, zq[:, :T].to(tc_latent_expand.dtype)], dim=-1)
        return self.decoder(x)
