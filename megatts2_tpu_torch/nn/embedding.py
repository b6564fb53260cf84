"""Token and sinusoidal positional embeddings (port of
``megatts2_tpu/nn/embedding.py``), each followed by train-mode dropout at
its ``dropout`` rate (masks from ``draws``, ``nn/dropout.py``)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .dropout import Draws, dropout


def sinusoidal_table(max_len: int, dim: int) -> np.ndarray:
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class TokenEmbedding(nn.Module):
    def __init__(self, dim_model: int, vocab_size: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.word_embeddings = nn.Embedding(vocab_size, dim_model)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Rows of the table for ids ``x``, in ``dtype`` (default the table's)."""
        emb = self.word_embeddings(x)
        return dropout(emb if dtype is None else emb.to(dtype), self.dropout, draws)


class SinePositionalEmbedding(nn.Module):
    """``x + pe[offset : offset + T]``: the JAX module with scale and alpha
    off, as every model on the synthesis path uses it.  The table is a
    non-persistent buffer, so it follows the module's dtype and device."""

    def __init__(self, dim_model: int, dropout: float = 0.0, max_len: int = 8192):
        super().__init__()
        self.dropout = dropout
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(max_len, dim_model)), persistent=False
        )

    def forward(self, x: torch.Tensor, offset: int = 0,
                draws: Optional[Draws] = None) -> torch.Tensor:
        return dropout(x + self.pe[offset : offset + x.shape[-2]].to(x.dtype), self.dropout, draws)
