"""The benchmark of ``pde_tpu_torch`` on one NVIDIA H100 (``run.py``)."""
