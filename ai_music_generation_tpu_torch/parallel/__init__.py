"""Training over a (data, model) mesh of cards: the port of
``ai_music_generation_tpu/parallel/`` (process groups, mesh rules, the
multi-process smoke). Importing it starts no process group."""
