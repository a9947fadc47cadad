"""The channel LayerNorm kernel (``kernels/csrc/layernorm_nchw.cu``): its
wrapper, its plain version and its launch counter."""
from .layernorm import (THREADS, layernorm_nchw, layernorm_nchw_plain,
                        tile_pixels)

__all__ = ["THREADS", "layernorm_nchw", "layernorm_nchw_plain", "tile_pixels"]
