"""Measurement harnesses of the port, each a counterpart of a script in
``docs/experiments/``; run with ``python -m``."""
