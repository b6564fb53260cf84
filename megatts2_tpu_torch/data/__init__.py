from .datasets import (LatentReader, expand_by_durations, fit_prompt, load_prompt_manifest,
                       max_pool_1d_ceil, prompt_features, resolve_prompt)
from .manifest import Cut, CutManifest
