from .datasets import (ADMBatchBuilder, GANBatchBuilder, LatentReader, PLMBatchBuilder,
                       TokensCollector, VocoderBatchBuilder, expand_by_durations, fit_prompt,
                       load_prompt_manifest, max_pool_1d_ceil, prompt_features, resolve_prompt)
from .features import FeatureReader, FeatureWriter
from .loader import DataLoader
from .manifest import Cut, CutManifest
from .sampler import DurationBucketSampler, round_up
