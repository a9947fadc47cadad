"""Hand-written Hopper kernels of the map-major conv and matmul families.

Each family has a wrapper module (``<name>/<name>.py``) holding the kernel's
ctypes wrapper, its plain PyTorch version and its launch counter; an
``ops.py`` holding the NCHW boundary and the registry hooks; and a ``ref.py``
holding the layout helpers.  The CUDA sources live in ``csrc/`` and build at
first use (``_build.py``).
"""
