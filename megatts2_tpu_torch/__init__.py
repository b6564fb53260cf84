"""megatts2_tpu_torch — the PyTorch / CUDA port of ``megatts2_tpu``.

The JAX package beside it stays the reference.  Each module here sits at
the same relative path as its JAX counterpart and keeps its public
layouts: (B, T, C) channels-last activations and (B, T, H, Dh) attention
tensors, so tests compare like with like.

The slices ported so far are zero-shot synthesis (``models.megatts``: the
prompt front-end, MRTE, the KV-cached ADM and PLM decodes, the MegaG
decoder and the Vocos vocoder) and PLM / ADM training (``training``: the
teacher-forced forwards, the losses, AdamW with its schedule and the
train loop).  Three hand-written CUDA kernels carry them on an NVIDIA
Hopper card (``csrc/``): the log-mel front-end and the masked attention
forward and backward.  On CPU tensors every op takes its plain PyTorch
version; on CUDA tensors it launches the kernel or raises.

This package imports no JAX.  It shares the text front-end, the scipy wav
helpers and the audio constants with ``megatts2_tpu``, none of which
import JAX either.
"""
from megatts2_tpu import (
    HIFIGAN_HOP_LENGTH,
    HIFIGAN_MAX_FREQ,
    HIFIGAN_MEL_CHANNELS,
    HIFIGAN_NFFT,
    HIFIGAN_SR,
    HIFIGAN_WIN_LENGTH,
)

__all__ = [
    "HIFIGAN_HOP_LENGTH",
    "HIFIGAN_MAX_FREQ",
    "HIFIGAN_MEL_CHANNELS",
    "HIFIGAN_NFFT",
    "HIFIGAN_SR",
    "HIFIGAN_WIN_LENGTH",
]
