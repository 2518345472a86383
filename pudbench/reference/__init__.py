"""Plain PyTorch references that judge what the served path produced.

They import nothing of the program (``repro_torch``) and take nothing it
made: each works from the benchmark's own weights and prompts, re-derives
the 4-bit packs with its own copy of the quantizer (``quant.py``), and
reads the served tokens only to judge them.  ``precision="bf16"`` is the
configuration's precision; ``"fp8"`` is the control (every bf16 product's
operands rounded to float8 e4m3 first), which must come out not correct.
"""
