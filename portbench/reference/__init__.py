"""The plain reference: each configuration's equations written out again
in plain PyTorch at float64 (``<configuration>.py``, found by the
configuration's name), and the checks that judge a solver's answers by
them (``judge.py``).  Nothing here imports JAX, the JAX package or the
port."""
