from .adm import MegaADM, adm_infer
from .dscrm import Discriminator, SingleWindowDisc
from .hifigan import HiFiGAN
from .megag import MegaG
from .megatts import Megatts, init_random_, synthesize, vocode
from .mrte import MRTE
from .plm import MegaPLM, plm_infer
from .vocos import Vocos
from .vqpe import VQProsodyEncoder
from .wave_dscrm import PeriodDiscriminator, ScaleDiscriminator, WaveDiscriminator

# last: the loaders import training, whose trainers import the models above
from .pretrained import (adm_from_pretrained, discriminator_from_pretrained,
                         hifigan_from_pretrained, megag_from_pretrained, megatts_from_pretrained,
                         plm_from_pretrained, vocoder_from_pretrained)
