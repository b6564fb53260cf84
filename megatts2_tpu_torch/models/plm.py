"""MegaPLM — prosody-code language model (port of
``megatts2_tpu/models/plm.py``).

A 12-layer / 16-head decoder-only transformer over 1024-way VQ prosody
codes, d_model = vq_dim + tc_latent_dim; input token t is
concat(tc_latent_t, embed(code_{t-1})) plus the sinusoidal position;
the head is Linear(d_model, vq_bins) without bias; BOS is vq_bins.
``forward`` is the teacher-forced training forward (causal, masked by
``lens``, flash attention under ``use_flash``); ``plm_infer`` is the greedy
KV-cached decode from BOS.  Both run on the same parameters.  Sampling,
int8 weights and the prompt prefill wait for later slices.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import MegaPLMConfig
from ..nn.embedding import sinusoidal_table
from .fast_decode import DecoderStack, dense, plm_fast_decode


class MegaPLM(nn.Module):
    def __init__(self, cfg: MegaPLMConfig = MegaPLMConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.plm = DecoderStack(c.d_model, c.d_model * 4, c.n_layers, c.n_heads,
                                dropout=c.dropout, use_flash=c.use_flash)
        self.predict_layer = nn.Linear(c.d_model, c.vq_bins, bias=False)
        self.pc_embedding = nn.Embedding(c.vq_bins + 2, c.vq_dim)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(8192, c.d_model)), persistent=False
        )

    def forward(
        self,
        tc_latent: torch.Tensor,  # (B, T, D_tc)
        p_codes: torch.Tensor,  # (B, T+1) with BOS prepended
        lens: torch.Tensor,  # (B,)
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits (B, T, vq_bins) in ``dtype`` and the target
        codes ``p_codes[:, 1:]``.  The positional table is added without
        dropout, as the PLM's ``SinePositionalEmbedding`` has none."""
        pc_emb = self.pc_embedding(p_codes[:, :-1]).to(dtype)
        x = torch.cat([tc_latent.to(dtype), pc_emb], dim=-1)
        x = x + self.pe[: x.shape[1]].to(dtype)
        x = self.plm(x, x_lens=lens, causal=True, train=train, generator=generator)
        return dense(self.predict_layer, x), p_codes[:, 1:]


def plm_infer(model: MegaPLM, tc_latent: torch.Tensor) -> torch.Tensor:
    """Greedy batched prosody codes: (B, T, D_tc) → (B, T) int64."""
    return plm_fast_decode(model, tc_latent)
