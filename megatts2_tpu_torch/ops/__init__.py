from .attention import flash_attention, flash_attention_cuda, flash_attention_plain
from .istft import istft
from .length_regulator import regulate_length
from .masks import NEG_INF, causal_mask, make_attn_mask, make_pad_mask
from .mel import (mel_filterbank, mel_spectrogram, mel_spectrogram_cuda,
                  mel_spectrogram_plain, num_frames)
from .pump import pump_cuda, pump_plain
