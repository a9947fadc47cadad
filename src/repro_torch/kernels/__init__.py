"""Hand-written Hopper kernels: the map-major conv and matmul families and
the channel LayerNorm.

Each family has a wrapper module (``<name>/<name>.py``) holding its kernels'
ctypes wrappers (a float and an int8 x int8 -> int32 kernel), their plain
PyTorch versions and their launch counters; an ``ops.py`` holding the NCHW
boundary, the int8 quantization glue and the registry hooks; and a
``ref.py`` holding the layout helpers.  ``layernorm/`` holds the channel
LayerNorm kernel's wrapper and plain version (ConvNeXt's; it replaces no TPU
kernel).  The CUDA sources live in ``csrc/`` and build at first use
(``_build.py``).
"""
