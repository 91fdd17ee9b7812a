"""PyTorch + CUDA port of ``ai_music_generation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's path (``models/gpt.py``, ``decode/generate.py``,
``ops/gqa_decode.py``). Importing the package imports nothing heavy: no jax,
no triton, and no kernel is built until a kernel is first launched.
"""
