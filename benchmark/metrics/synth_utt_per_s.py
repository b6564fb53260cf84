"""Utterances synthesised in the window (waveforms on the host, trimmed)
over the window's seconds."""


def read(rec):
    return rec["utterances"] / rec["window_s"] if "utterances" in rec else None
