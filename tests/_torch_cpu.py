"""PyTorch on one intra-op thread for the port's tests.

The tests' tensors are small, and the suite runs under several pytest
workers at once: PyTorch's default of one intra-op thread per core then
puts many times more threads than cores on the machine, and the port's
tests spend most of their wall waiting for each other (on an 8-core
machine, 4,938 s of test time in a six-worker run of the suite, 933 s on
one thread each).
Every ``tests/test_torch_*.py`` imports this module; results do not
depend on the thread count (the port's CPU paths are held bit for bit
against each other and the reference either way).
"""
import torch

torch.set_num_threads(1)
