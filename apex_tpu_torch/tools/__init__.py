"""Probes of the card for the port's kernels: ``kprobe`` (the optimizer
engine's bandwidth ladder, counterpart of ``tools/tpu_kprobe.py``) and
``launch_probe`` (the launch shapes sm_90 takes, counterpart of
``tools/mosaic_probe.py``). Run each with ``python -m`` on a CUDA
device. Beside them, ``tree_compare`` runs the LayerNorm and fp32 flash
forwards of two checkouts side by side on the card (outputs bitwise,
device ms)."""
