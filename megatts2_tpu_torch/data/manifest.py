"""Cut manifests: gzipped JSONL, one record per utterance (port of
``megatts2_tpu/data/manifest.py``)::

    {"id", "speaker", "duration", "num_frames", "text",
     "phone_tokens": [str], "duration_tokens": [int],
     "feats_path", "feats_offset", "wav_path"}

Stage-2 latents live in ``{ds_path}/latents/{speaker}/{id}.npy``.
"""
from __future__ import annotations

import gzip
import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterator, List, Optional


@dataclass
class Cut:
    id: str
    speaker: str
    duration: float
    num_frames: int
    phone_tokens: List[str] = field(default_factory=list)
    duration_tokens: List[int] = field(default_factory=list)
    text: str = ""
    feats_path: str = ""
    feats_offset: int = 0
    wav_path: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "Cut":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


class CutManifest:
    def __init__(self, cuts: Optional[List[Cut]] = None):
        self.cuts: List[Cut] = cuts or []

    @classmethod
    def load(cls, path: str) -> "CutManifest":
        cuts = []
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    cuts.append(Cut.from_dict(json.loads(line)))
        return cls(cuts)

    def save(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt", encoding="utf-8") as f:
            for c in self.cuts:
                f.write(json.dumps(asdict(c), ensure_ascii=False) + "\n")

    def filter_duration(self, min_duration: float, max_duration: float) -> "CutManifest":
        return CutManifest([c for c in self.cuts if min_duration <= c.duration <= max_duration])

    def speaker_index(self) -> Dict[str, List[int]]:
        """speaker → cut indices."""
        idx: Dict[str, List[int]] = {}
        for i, c in enumerate(self.cuts):
            idx.setdefault(c.speaker, []).append(i)
        return idx

    def __len__(self) -> int:
        return len(self.cuts)

    def __iter__(self) -> Iterator[Cut]:
        return iter(self.cuts)

    def __getitem__(self, i: int) -> Cut:
        return self.cuts[i]
