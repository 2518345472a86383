"""PyTorch/CUDA port of the PUDTune system (the JAX package ``repro`` is the
reference it is held against).

The port mirrors ``repro``'s module paths.  Plain tensor code is PyTorch;
every Pallas kernel on the serving path is a hand-written CUDA kernel for
Hopper (``csrc/*.cu``), built with ``nvcc`` on first use and loaded with
``ctypes`` (``kernels/build.py``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a GPU they raise instead of
falling back.
"""
