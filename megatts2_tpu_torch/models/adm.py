"""MegaADM — autoregressive duration model (port of
``megatts2_tpu/models/adm.py``).

An 8-layer causal transformer regressing per-phone frame counts: the
previous raw duration is embedded by Linear(1, emb_dim, no bias), the
tc_latent by Linear(tc_latent_dim, tc_emb_dim, no bias), and a bias-free
scalar head predicts the next duration.  ``forward`` is the teacher-forced
training forward (causal, masked by ``lens``); ``adm_infer`` is the
KV-cached greedy decode.  Both run on the same parameters.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import MegaADMConfig
from ..nn.dropout import Draws
from ..nn.embedding import sinusoidal_table
from .fast_decode import DecoderStack, adm_fast_decode, dense


class MegaADM(nn.Module):
    def __init__(self, cfg: MegaADMConfig = MegaADMConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.adm = DecoderStack(c.d_model, c.emb_dim * 4, c.n_layers, c.n_heads,
                                dropout=c.dropout, use_flash=c.use_flash)
        self.dt_linear_emb = nn.Linear(1, c.emb_dim, bias=False)
        self.tc_linear_emb = nn.Linear(c.tc_latent_dim, c.tc_emb_dim, bias=False)
        self.predict_layer = nn.Linear(c.d_model, 1, bias=False)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(8192, c.d_model)), persistent=False
        )

    def forward(
        self,
        tc_latents: torch.Tensor,  # (B, T, D)
        duration_tokens: torch.Tensor,  # (B, T+1, 1) float, leading 0 = BOS
        lens: torch.Tensor,  # (B,)
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
        draws: Optional[Draws] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced predictions (B, T) in ``dtype`` and the target
        durations ``duration_tokens[:, 1:, 0]``."""
        dt_emb = dense(self.dt_linear_emb, duration_tokens[:, :-1].to(dtype))
        tc_emb = dense(self.tc_linear_emb, tc_latents.to(dtype))
        x = torch.cat([tc_emb, dt_emb], dim=-1)
        x = x + self.pe[: x.shape[1]].to(dtype)
        x = self.adm(x, x_lens=lens, causal=True, train=train, generator=generator,
                     draws=draws)
        return dense(self.predict_layer, x)[..., 0], duration_tokens[:, 1:, 0]


def adm_infer(model: MegaADM, tc_latents: torch.Tensor) -> torch.Tensor:
    """Greedy batched duration decode: (B, T, D) → (B, T) int64 in
    [1, max_duration_token]."""
    return adm_fast_decode(model, tc_latents)
