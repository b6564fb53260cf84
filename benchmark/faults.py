"""Faults planted under the timed path, to show that the check catches
them: the tests run each at test size, and ``calibrate.py --fault`` reads
them on the chip at a cell's own size.

* ``altered_code`` (synthesis): every prosody code ``plm_infer`` returns
  is moved to the next one.
* ``state_unchanged`` (training): a step computes and applies its update,
  then puts the weights back.
* ``half_batch`` (training): a step leaves out the second half of the
  batch's rows (their targets set to EOS, which the loss skips), its loss
  the sum over the rest.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name: str, vq_bins: int = 1024):
    import torch

    from megatts2_tpu_torch import training
    from megatts2_tpu_torch.models import megatts

    saved = []

    def swap(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "altered_code":
        plm_infer = megatts.plm_infer
        swap(megatts, "plm_infer", lambda *a, **k: (plm_infer(*a, **k) + 1) % vq_bins)
    elif name in ("state_unchanged", "half_batch"):
        make = training.make_plm_train_step

        def unchanged(real):
            def step(state, batch):
                kept = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
                metrics = real(state, batch)
                with torch.no_grad():
                    state.model.load_state_dict(kept)
                return metrics
            return step

        def half(real):
            def step(state, batch):  # the second half's targets set to EOS, which the loss skips
                codes = batch["p_codes"].copy()
                codes[len(codes) // 2:, 1:] = vq_bins + 1
                return real(state, dict(batch, p_codes=codes))
            return step

        wrap = unchanged if name == "state_unchanged" else half
        swap(training, "make_plm_train_step", lambda *a, **k: (wrap(make(*a, **k)[0]), None))
    else:
        raise ValueError(f"no fault named {name!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
