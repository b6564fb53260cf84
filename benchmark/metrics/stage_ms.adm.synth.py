"""Mean ms a batch in the ADM stage of ``synthesize``: its own stage clock
(``stage_times``, synchronised at each stage's end), in the traced run."""


def read(rec):
    times = rec.get("stage_times", {}).get("adm")
    return 1000.0 * sum(times) / len(times) if times else None
