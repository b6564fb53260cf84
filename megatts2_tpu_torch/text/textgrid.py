"""Minimal Praat TextGrid reader.

Parity target: reference ``utils/textgrid.py:13-109`` — yields
``(start, stop, name, tier)`` entries for interval tiers (the prepare_ds
pipeline only consumes the 'phones' tier).  Fresh implementation of the
standard long TextGrid format.
"""
from __future__ import annotations

import codecs
import re
from typing import List, NamedTuple


class Entry(NamedTuple):
    start: float
    stop: float
    name: str
    tier: str


def read_textgrid(filename: str) -> List[Entry]:
    with codecs.open(filename, "r", encoding="utf-8", errors="replace") as f:
        content = f.read()

    entries: List[Entry] = []
    # Split into item blocks: item [N]: ... holds one tier
    tier_blocks = re.split(r"item\s*\[\d+\]\s*:", content)[1:]
    for block in tier_blocks:
        name_m = re.search(r'name\s*=\s*"([^"]*)"', block)
        tier_name = name_m.group(1) if name_m else ""
        for m in re.finditer(
            r"intervals\s*\[\d+\]\s*:?\s*"
            r"xmin\s*=\s*([\d.eE+-]+)\s*"
            r"xmax\s*=\s*([\d.eE+-]+)\s*"
            r'text\s*=\s*"([^"]*)"',
            block,
        ):
            entries.append(
                Entry(float(m.group(1)), float(m.group(2)), m.group(3).strip(), tier_name)
            )
        for m in re.finditer(
            r"points\s*\[\d+\]\s*:?\s*"
            r"(?:number|time)\s*=\s*([\d.eE+-]+)\s*"
            r'mark\s*=\s*"([^"]*)"',
            block,
        ):
            t = float(m.group(1))
            entries.append(Entry(t, t, m.group(2).strip(), tier_name))
    return entries
