"""Drivers of the Hopper probes (``kernels/probes.py``): the counterparts of
the JAX package's experiment scripts of the same names, each run as
``python -m omniquant_tpu_torch.scripts.<name>`` on the card."""
