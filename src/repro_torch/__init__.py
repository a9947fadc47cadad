"""Cappuccino inference synthesis on PyTorch and CUDA (Hopper).

The port of the JAX package ``repro``, slice by slice; the JAX package stays
the reference.  Subpackages:

- ``repro_torch.core``     synthesis: plans, planner, graph passes, modes,
                           ``synthesize()``;
- ``repro_torch.cnn``      AlexNet, GoogLeNet, SqueezeNet descriptions and
                           their weights;
- ``repro_torch.device``   device profiles (``h100``, ``cpu``);
- ``repro_torch.kernels``  the hand-written map-major conv and matmul kernels;
- ``repro_torch.data``     synthetic ImageNet-like data;
- ``repro_torch.serving``  the CNN serving tier: batcher, program cache (one
                           CUDA graph per batch bucket), replicas, dispatch
                           policies, load generator;
- ``repro_torch.obs``      metrics registry, trace spans, Prometheus/JSON
                           export;
- ``repro_torch.launch``   command-line entry points (``serve_cnn``).

Entry points that make tensors take a ``device`` and run on ``cuda`` unless
the caller asks for ``"cpu"``.
"""
