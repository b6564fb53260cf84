"""Render ``e2e_quality`` JSON records (a float and an int8 run) as
markdown tables (port of ``tools/quality_table.py``: the same tables for
the same files).

    python -m megatts2_tpu_torch.tools.quality_table fp32.json int8.json

Pure Python: it reads files and touches no device.
"""
import json
import sys


def main(argv=None) -> None:
    runs = []
    for path in sys.argv[1:] if argv is None else argv:
        with open(path) as f:
            runs.append(json.load(f))
    if not runs:
        raise SystemExit("usage: quality_table report.json [report2.json ...]")

    spks = sorted(runs[0]["speakers"])
    print("| speaker | f0 band (Hz) |",
          " | ".join(f"{r['plm_decode']}: env-class / MCD dB / dur-MAE / "
                     "prompted-f0-in-band" for r in runs), "|")
    print("|---|---|" + "---|" * len(runs))
    for s in spks:
        cells = []
        for r in runs:
            d = r["speakers"][s]
            ok = "✓" if d["classified_as"] == s else f"✗({d['classified_as']})"
            pb = "✓" if d["prompted_in_band"] else "✗"
            cells.append(f"{ok} / {d['mcd_db']} / {d['duration_mae_frames']} / "
                         f"{pb} ({d['prompted_f0_hz']} Hz)")
        band = runs[0]["speakers"][s]["band_hz"]
        print(f"| {s} | {band[0]}–{band[1]} | " + " | ".join(cells) + " |")
    print()
    print("| aggregate | " + " | ".join(r["plm_decode"] for r in runs) + " |")
    print("|---|" + "---|" * len(runs))
    for key, label in [
        ("timbre_classification_acc", "envelope speaker-classification acc"),
        ("mcd_db_mean", "DTW mel-cepstral distortion (dB, mean)"),
        ("duration_mae_frames_mean", "ADM duration MAE (frames, mean)"),
        ("prompted_in_band_frac", "prompted decode f0 in speaker band"),
        ("prompted_differs_frac", "prompted decode differs from BOS"),
    ]:
        print(f"| {label} | " + " | ".join(str(r[key]) for r in runs) + " |")


if __name__ == "__main__":
    main()
