"""Measurement harnesses of the port: counterparts of scripts in
``docs/experiments/``, and measurements of its kernels' build choices; run
with ``python -m``."""
