"""Mandarin pinyin → MFA-phone dictionary, generated from phonology tables.

The reference ships a 4,147-line data asset
(``utils/mandarin_pinyin_to_mfa_lty.dict``, reference README.md:24) that
maps every toned pinyin syllable to an IPA-ish MFA phone sequence with
Chao tone letters on the nucleus.  Rather than vendoring that file, this
module *generates* a compatible dictionary from first principles — the
standard pinyin initial/final tables and the dict's observed phonetic
conventions (e.g. ``e``→``o``, ``ai``→``aj``, apical vowels ``ʐ̩``/``z̩``,
glottal ``ʔ`` on vowel-initial syllables, tone letters on the nucleus).
The bundled ``mandarin_pinyin_to_mfa.dict`` next to this file is the
generator's checked-in output; ``load_pinyin_dict`` (tokenizer.py) falls
back to it when no explicit path / env var is given.

Format (same as the reference asset): ``syllable+tone\\t1.0\\tphones``.
Tones 1–5 are emitted (pypinyin TONE3 with ``neutral_tone_with_five``
produces exactly these); the reference's extra 5/6/7/8 neutral-tone
variants map to alignment-model internals we don't need.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Tuple

# ---------------------------------------------------------------------------
# phonology tables (standard Mandarin pinyin, public data)
# ---------------------------------------------------------------------------

INITIALS: Dict[str, List[str]] = {
    "b": ["p"], "p": ["pʰ"], "m": ["m"], "f": ["f"],
    "d": ["t"], "t": ["tʰ"], "n": ["n"], "l": ["l"],
    "g": ["k"], "k": ["kʰ"], "h": ["x"],
    "j": ["tɕ"], "q": ["tɕʰ"], "x": ["ɕ"],
    "zh": ["ʈʂ"], "ch": ["ʈʂʰ"], "sh": ["ʂ"], "r": ["ʐ"],
    "z": ["ts"], "c": ["tsʰ"], "s": ["s"],
}

# final → (onglide phones, nucleus phone, coda phones); ü is written v.
# Conventions matched to the MFA 'lty' mandarin style: e→o, eng→oŋ,
# ai→aj, ei→ej, ao→aw, ou→ow, ian→jen, ong→uŋ, er→oɻ, ui→wej, iu→jow,
# un→wən, üan→ɥen, ün→yn.
FINALS: Dict[str, Tuple[List[str], str, List[str]]] = {
    "a": ([], "a", []),
    "o": ([], "o", []),
    "e": ([], "o", []),
    "i": ([], "i", []),
    "u": ([], "u", []),
    "v": ([], "y", []),
    "ai": ([], "aj", []),
    "ei": ([], "ej", []),
    "ao": ([], "aw", []),
    "ou": ([], "ow", []),
    "an": ([], "a", ["n"]),
    "en": ([], "ə", ["n"]),
    "ang": ([], "a", ["ŋ"]),
    "eng": ([], "o", ["ŋ"]),
    "ong": ([], "u", ["ŋ"]),
    "er": ([], "o", ["ɻ"]),
    "ia": (["j"], "a", []),
    "ie": (["j"], "e", []),
    "iao": (["j"], "aw", []),
    "iu": (["j"], "ow", []),
    "ian": (["j"], "e", ["n"]),
    "in": ([], "i", ["n"]),
    "iang": (["j"], "a", ["ŋ"]),
    "ing": ([], "i", ["ŋ"]),
    "iong": (["j"], "u", ["ŋ"]),
    "ua": (["w"], "a", []),
    "uo": (["w"], "o", []),
    "uai": (["w"], "aj", []),
    "ui": (["w"], "ej", []),
    "uan": (["w"], "a", ["n"]),
    "un": (["w"], "ə", ["n"]),
    "uang": (["w"], "a", ["ŋ"]),
    "ueng": (["w"], "ə", ["ŋ"]),
    "ve": (["ɥ"], "e", []),
    "van": (["ɥ"], "e", ["n"]),
    "vn": ([], "y", ["n"]),
}

# which finals each initial combines with (standard syllable inventory)
_LABIAL = "a o ai ei ao ou an en ang eng i ie iao ian in ing u"
_VELAR = "a e ai ei ao ou an en ang eng ong u ua uo uai ui uan un uang"
_PALATAL = "i ia ie iao iu ian in iang ing iong v ve van vn"
_RETRO = "i a e ai ei ao ou an en ang eng ong u ua uo uai ui uan un uang"
_SIBIL = "i a e ai ei ao ou an en ang eng ong u uo ui uan un"
FINALS_BY_INITIAL: Dict[str, List[str]] = {
    "b": _LABIAL.split(),
    "p": _LABIAL.split(),
    "m": (_LABIAL + " e iu").split(),
    "f": "a o ei ou an en ang eng u".split(),
    "d": "a e ai ei ao ou an en ang eng ong i ia ie iao iu ian ing u uo ui uan un".split(),
    "t": "a e ai ao ou an ang eng ong i ie iao ian ing u uo ui uan un".split(),
    "n": "a e ai ei ao ou an en ang eng ong i ie iao iu ian in iang ing u uo uan v ve".split(),
    "l": "a e ai ei ao ou an ang eng ong i ia ie iao iu ian in iang ing u uo uan un v ve".split(),
    "g": _VELAR.split(),
    "k": _VELAR.split(),
    "h": _VELAR.split(),
    "j": _PALATAL.split(),
    "q": _PALATAL.split(),
    "x": _PALATAL.split(),
    "zh": _RETRO.split(),
    "ch": [f for f in _RETRO.split() if f not in ("ei",)],
    "sh": [f for f in _RETRO.split() if f not in ("ong",)],
    "r": "i e ao ou an en ang eng ong u ua uo ui uan un".split(),
    "z": _SIBIL.split(),
    "c": [f for f in _SIBIL.split() if f != "ei"],
    "s": (_SIBIL + " ei").split(),
    # null initial: every standalone final (orthography handled below)
    "": "a o e ai ei ao ou an en ang eng er i ia ie iao iu ian in iang "
        "ing iong u ua uo uai ui uan un uang ueng v ve van vn".split(),
}

# standard but table-defying syllables
EXTRAS: List[Tuple[str, str]] = [  # (initial, final)
    ("d", "en"), ("d", "ia"), ("n", "en"), ("n", "ou"),
    ("zh", "ei"), ("sh", "ei"), ("z", "ei"), ("l", "o"),
]

TONE_LETTERS = {1: "˥˥", 2: "˧˥", 3: "˨˩˦", 4: "˥˩", 5: "˨"}

_APICAL_RETRO = {"zh", "ch", "sh", "r"}
_APICAL_SIBIL = {"z", "c", "s"}


def written_form(initial: str, final: str) -> str:
    """Pinyin orthography for (initial, final) — ü as v (reference style)."""
    if initial in ("j", "q", "x"):
        # ü-finals are written with bare u after palatals
        return initial + {"v": "u", "ve": "ue", "van": "uan", "vn": "un"}.get(
            final, final
        )
    if initial:
        return initial + final
    # null initial: y/w orthography
    if final.startswith("i"):
        if final in ("i", "in", "ing"):
            return "y" + final
        if final == "iu":
            return "you"
        return "y" + final[1:]
    if final.startswith("u"):
        if final == "u":
            return "wu"
        if final == "ui":
            return "wei"
        if final == "un":
            return "wen"
        return "w" + final[1:]
    if final.startswith("v"):
        return "y" + {"v": "u", "ve": "ue", "van": "uan", "vn": "un"}[final]
    return final


def syllable_phones(initial: str, final: str) -> Tuple[List[str], int]:
    """(initial, final) → (untoned phone list, nucleus index)."""
    if initial == "m" and final == "e":
        return ["m", "ə"], 1  # the particle 'me' keeps the schwa
    if not initial and final == "eng":
        return ["o", "ŋ"], 0  # bare 'eng' interjection: no glottal onset
    if final == "i" and initial in _APICAL_RETRO:
        # apical vowel; 'ri' is the bare syllabic ʐ̩ (its initial IS it)
        phones = ([] if initial == "r" else INITIALS[initial][:]) + ["ʐ̩"]
        return phones, len(phones) - 1
    if final == "i" and initial in _APICAL_SIBIL:
        phones = INITIALS[initial][:] + ["z̩"]
        return phones, len(phones) - 1
    pre, nuc, post = FINALS[final]
    pre = list(pre)
    if initial in ("b", "p", "m", "f") and final == "o":
        pre = ["w"]  # bo/po/mo/fo carry the rounded glide
    if initial:
        phones = INITIALS[initial] + pre
    elif final[0] in "aeo":
        phones = ["ʔ"] + pre  # glottal onset on vowel-initial syllables
    elif final in ("i", "in", "ing", "u", "v", "vn"):
        phones = []  # yi/yin/ying/wu/yu/yun: bare high vowel
    else:
        phones = pre  # glide is the onset (ya → j a, wa → w a, yue → ɥ e)
    nucleus_idx = len(phones)
    return phones + [nuc] + list(post), nucleus_idx


# interjections / alternate spellings outside the initial×final grid:
# written form → (phones, nucleus index; None = no tone letter applied)
IRREGULAR: Dict[str, Tuple[List[str], object]] = {
    # syllabic nasal interjections (嗯): fixed rising contour in MFA
    "n": (["ŋ̍˧˥"], None),
    "ng": (["ŋ̍˧˥"], None),
    "r": (["ɻ"], None),  # erhua suffix syllable (no tone letter)
    "yo": (["j", "o"], 1),
    "tei": (["tʰ", "ej"], 1),
    "lue": (["l", "ɥ", "e"], 2),  # alternate spelling of lve
    "nue": (["n", "ɥ", "e"], 2),
}


def iter_syllables() -> Iterator[Tuple[str, List[str], int]]:
    """All (written syllable, untoned phones, nucleus index), deduped."""
    seen = set()
    pairs = [
        (ini, fin)
        for ini, finals in FINALS_BY_INITIAL.items()
        for fin in finals
    ] + [(i, f) for i, f in EXTRAS if f in FINALS]
    for ini, fin in pairs:
        w = written_form(ini, fin)
        if w in seen:
            continue
        seen.add(w)
        phones, nuc = syllable_phones(ini, fin)
        yield w, phones, nuc
    for w, (phones, nuc) in IRREGULAR.items():
        if w not in seen:
            yield w, phones, nuc


def generate_entries(tones=(1, 2, 3, 4, 5)) -> Iterator[Tuple[str, List[str]]]:
    for w, phones, nuc in sorted(iter_syllables()):
        for t in tones:
            toned = list(phones)
            if nuc is not None:
                toned[nuc] = toned[nuc] + TONE_LETTERS[t]
            yield f"{w}{t}", toned


def write_dict(path: str) -> int:
    """Write the generated dictionary; returns the entry count."""
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for key, phones in generate_entries():
            f.write(f"{key}\t1.0\t{' '.join(phones)}\n")
            n += 1
    return n


def default_dict_path() -> str:
    """The bundled generated dictionary shipped with the package."""
    return os.path.join(os.path.dirname(__file__), "mandarin_pinyin_to_mfa.dict")


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else default_dict_path()
    print(f"wrote {write_dict(out)} entries to {out}")
