"""The benchmark of gpmp2_tpu_torch on one NVIDIA GPU (see run.py)."""
