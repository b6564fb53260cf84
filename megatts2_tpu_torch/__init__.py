"""megatts2_tpu_torch — the PyTorch / CUDA port of ``megatts2_tpu``.

The JAX package beside it stays the reference.  Each module here sits at
the same relative path as its JAX counterpart and keeps its public
layouts: (B, T, C) channels-last activations and (B, T, H, Dh) attention
tensors, so tests compare like with like.

The slices ported so far are zero-shot synthesis (``models.megatts``: the
prompt front-end, MRTE, the KV-cached ADM and PLM decodes, the MegaG
decoder, the HiFi-GAN and Vocos vocoders), its serving options (the int8
/ int4 weight-only PLM of ``quantization.weight_only``, temperature /
top-k sampling, the prompt prefill), PLM / ADM training (``training``:
the teacher-forced forwards, the losses, AdamW with its schedule and the
train loop), the VQ-GAN and vocoder training stages, the bandwidth tool
(``tools.bw_ceiling``), and serving: reference-layout checkpoints
(``training.checkpoints``, ``models.pretrained``), streaming
(``models.streaming``), the continuous slot engine (``continuous``) and
the ``serve`` and ``infer`` entry points.  Four
hand-written CUDA kernels carry them on an NVIDIA Hopper card
(``csrc/``): the log-mel front-end, the masked attention forward and
backward, and the device-memory copy pump.  On CPU tensors every op takes
its plain PyTorch version; on CUDA tensors it launches the kernel or
raises.

This package imports no JAX and nothing of ``megatts2_tpu``: it keeps its
own copies of the text front-end (``text/``), the scipy wav helpers
(``utils/audio.py``) and the audio constants below.
"""
HIFIGAN_SR = 16000
HIFIGAN_HOP_LENGTH = 256
HIFIGAN_WIN_LENGTH = 1024
HIFIGAN_MEL_CHANNELS = 80
HIFIGAN_NFFT = 1024
HIFIGAN_MAX_FREQ = 8000

__all__ = [
    "HIFIGAN_HOP_LENGTH",
    "HIFIGAN_MAX_FREQ",
    "HIFIGAN_MEL_CHANNELS",
    "HIFIGAN_NFFT",
    "HIFIGAN_SR",
    "HIFIGAN_WIN_LENGTH",
]
