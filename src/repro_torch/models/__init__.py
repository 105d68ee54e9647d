"""LM-scale models: the dense GQA decoder (``nn``, ``attention``, ``lm``)."""
