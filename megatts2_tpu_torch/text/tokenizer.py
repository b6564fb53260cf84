"""Mixed Chinese/English text front-end (G2P).

Parity target: reference ``modules/tokenizer.py:27-98``:
* punctuation stripped, text lowercased, CN/EN segments split;
* Chinese → pinyin TONE3 with neutral tone '5' (via pypinyin when available);
* pinyin syllables → MFA phones through the 4,147-entry
  ``mandarin_pinyin_to_mfa_lty.dict`` mapping;
* English words pass through as whole-word tokens;
* separators: word '_', syllable '-', phone '|'.

The pinyin→MFA dictionary is loaded from a configurable path
(``MEGATTS2_TPU_PINYIN_DICT`` env var or explicit argument) since it is an
external data asset; pypinyin is optional — ASCII input (English words or
already-romanized TONE3 pinyin) needs neither.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

try:  # optional dependency for hanzi → pinyin
    from pypinyin import Style, pinyin as _pinyin  # type: ignore

    _HAS_PYPINYIN = True
except Exception:  # pragma: no cover
    _HAS_PYPINYIN = False

_CJK = re.compile(r"[一-鿿]")

WORD_SEP = "_"
SYLLABLE_SEP = "-"
PHONE_SEP = "|"


def load_pinyin_dict(path: Optional[str] = None) -> Dict[str, List[str]]:
    """Parse a tab-separated ``pinyin\\tphone phone ...`` dictionary
    (the MFA 'lty' mandarin dict format the reference ships).  Resolution
    order: explicit ``path`` → ``MEGATTS2_TPU_PINYIN_DICT`` env var → the
    bundled generated dictionary (``pinyin_dict.py``, phone-identical to
    the reference asset on every shared syllable)."""
    if not path:
        path = os.environ.get("MEGATTS2_TPU_PINYIN_DICT", "")
    if not path:
        from .pinyin_dict import default_dict_path

        path = default_dict_path()
    mapping: Dict[str, List[str]] = {}
    if not path or not os.path.exists(path):
        return mapping
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = re.split(r"\t", line)
            if len(parts) < 2:
                continue
            phones = re.split(r"[ ]+", parts[-1].strip())
            mapping[parts[0]] = phones
    return mapping


class TextTokenizer:
    def __init__(self, pinyin_dict_path: Optional[str] = None) -> None:
        self.pinyin2lty = load_pinyin_dict(pinyin_dict_path)

    def _hanzi_to_pinyin(self, text: str) -> List[str]:
        if _HAS_PYPINYIN:
            out = []
            for py in _pinyin(text, style=Style.TONE3, neutral_tone_with_five=True):
                if not py[0][-1].isalnum():
                    raise ValueError(f"unexpected pinyin: {py[0]!r}")
                out.append(py[0])
            return out
        # vendored per-character fallback (common single-reading chars;
        # same TONE3/neutral-5 convention) — keeps the hanzi pipeline
        # usable and CI-testable without the optional dependency
        from .hanzi_fallback import HANZI_TONE3

        out = []
        for ch in text:
            py = HANZI_TONE3.get(ch)
            if py is None:
                raise RuntimeError(
                    f"pypinyin is not installed and {ch!r} is not in the "
                    "vendored fallback table; pass romanized TONE3 pinyin "
                    "(e.g. 'ni3 hao3') or install pypinyin for full hanzi "
                    "coverage."
                )
            out.append(py)
        return out

    def phonemize(self, text: str) -> str:
        text = re.sub(r"[^\w\s]+", " ", text)  # strip punctuation
        text = re.sub(r"[ ]+", " ", text)
        text = text.lower()

        phonemized: List[str] = []
        for seg in re.split(r"[^\w\s']+", text):
            for sub in re.split(r"([a-z0-9 ]+)", seg):
                sub = sub.strip()
                if sub in ("", "'"):
                    continue
                if re.match(r"[a-z0-9 ']+", sub):
                    for word in re.split(r"[ ]+", sub):
                        phonemized.append(word)
                else:
                    syls = self._hanzi_to_pinyin(sub)
                    phonemized.append(PHONE_SEP.join(syls))
        return WORD_SEP.join(phonemized)

    def tokenize(self, text: str) -> List[str]:
        phones = []
        for word in re.split(r"([_-])", self.phonemize(text.strip())):
            if len(word):
                for phone in re.split(r"\|", word):
                    if len(phone):
                        phones.append(phone)
        return phones

    def tokenize_lty(self, tokens: List[str]) -> List[str]:
        """Map pinyin syllables to MFA phone sequences; unknown tokens
        (e.g. English words) pass through."""
        out: List[str] = []
        for token in tokens:
            if token in self.pinyin2lty:
                out.extend(self.pinyin2lty[token])
            else:
                out.append(token)
        return out
