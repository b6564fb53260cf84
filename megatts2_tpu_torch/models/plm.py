"""MegaPLM — prosody-code language model (port of
``megatts2_tpu/models/plm.py``).

A 12-layer / 16-head decoder-only transformer over 1024-way VQ prosody
codes, d_model = vq_dim + tc_latent_dim; input token t is
concat(tc_latent_t, embed(code_{t-1})) plus the sinusoidal position;
the head is Linear(d_model, vq_bins) without bias; BOS is vq_bins.
``forward`` is the teacher-forced training forward (causal, masked by
``lens``, flash attention under ``use_flash``); ``prefill`` writes a
prompt into the KV caches in one causal pass (kernel B on the card under
``use_flash``); ``plm_infer`` is the KV-cached decode, greedy or sampled,
from BOS or after a prefilled prompt.  All run on the same parameters,
float or quantized (``quantization.weight_only.quantize_``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import MegaPLMConfig
from ..nn.dropout import Draws
from ..nn.embedding import sinusoidal_table
from ..quantization.weight_only import QuantLinear, is_int4
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
        draws: Optional[Draws] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits (B, T, vq_bins) in ``dtype`` and the target
        codes ``p_codes[:, 1:]``.  The positional table is added without
        dropout, as the PLM's ``SinePositionalEmbedding`` has none."""
        pc_emb = self.pc_embedding(p_codes[:, :-1]).to(dtype)
        x = torch.cat([tc_latent.to(dtype), pc_emb], dim=-1)
        x = x + self.pe[: x.shape[1]].to(dtype)
        x = self.plm(x, x_lens=lens, causal=True, train=train, generator=generator,
                     draws=draws)
        return dense(self.predict_layer, x), p_codes[:, 1:]


    def prefill(
        self,
        tc: torch.Tensor,  # (B, P, D_tc) prompt content latents, code rate
        prev_codes: torch.Tensor,  # (B, P): BOS ++ prompt_codes[:, :-1]
        caches: list[torch.Tensor],  # per layer (B, >= P, 2D), from plm.new_cache
    ) -> torch.Tensor:
        """Write a P-token prompt's k and v into ``caches[:, :P]`` in one
        pass and return the logits (B, vq_bins) fp32 after its last token.
        The JAX prefill attends block-causally over the padded cache; causal
        attention over the P prompt tokens is the same function, so it takes
        the flash path (kernel B on the card) under ``use_flash``."""
        dtype = self.plm.dtype
        x = torch.cat([tc.to(dtype), self.pc_embedding(prev_codes).to(dtype)], dim=-1)
        x = x + self.pe[: x.shape[1]].to(dtype)  # the prompt holds positions [0, P)
        x = self.plm(x, causal=True, caches=caches)
        return dense(self.predict_layer, x[:, -1]).float()


def is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, QuantLinear) for m in model.modules())


@torch.inference_mode()
def plm_infer(
    model: MegaPLM,
    tc_latent: torch.Tensor,  # (B, T, D_tc)
    quant: bool = False,
    temperature: float = 0.0,
    top_k: int = 0,
    generator: Optional[torch.Generator] = None,
    prompt_tc: Optional[torch.Tensor] = None,  # (B, P, D_tc), code rate
    prompt_codes: Optional[torch.Tensor] = None,  # (B, P) int
    gumbel: Optional[torch.Tensor] = None,  # (T, B, vq_bins) injected noise
) -> torch.Tensor:
    """Batched prosody codes (B, T) int64.

    * ``quant`` states that the model's Linear layers are quantized
      (``quantize_``), as JAX's flag states that its tree is; the two must
      agree.  Packed int4 runs only without a prompt, as in JAX.
    * ``temperature > 0`` samples from softmax(logits / temperature),
      truncated to the ``top_k`` most likely codes when ``top_k > 0``, with
      noise from ``generator`` (or ``gumbel``); otherwise greedy.
    * ``prompt_tc``/``prompt_codes``: an in-context prosody prompt of one
      length P, prefilled into the caches; decoding starts at position P
      from the prompt's last code."""
    if quant != is_quantized(model):
        raise ValueError(f"plm_infer: quant={quant}, but the model is "
                         f"{'quantized' if is_quantized(model) else 'float'}")
    if prompt_tc is None:
        return plm_fast_decode(model, tc_latent, temperature, top_k, generator, gumbel)
    if is_int4(model):
        raise NotImplementedError(
            "int4-packed weights run only on the fast decode without a prompt prefill, "
            "as in the JAX package; quantize with bits=8 to use a prompt")
    B, T, _ = tc_latent.shape
    P = prompt_tc.shape[1]
    caches = model.plm.new_cache(B, P + T, tc_latent.to(model.plm.dtype))
    bos = torch.full((B, 1), model.cfg.bos_id, dtype=torch.long, device=tc_latent.device)
    model.prefill(prompt_tc, torch.cat([bos, prompt_codes[:, :-1].long()], dim=1), caches)
    return plm_fast_decode(model, tc_latent, temperature, top_k, generator, gumbel,
                           init_cache=caches, start_pos=P, prev0=prompt_codes[:, -1].long())
