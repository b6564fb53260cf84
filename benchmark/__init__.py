"""The benchmark of ``megatts2_tpu_torch`` on one NVIDIA H100 (see ``harness.py``)."""
