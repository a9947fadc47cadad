from .pipeline import DataPipeline
from .synthetic import imagenet_like, lm_batches, token_stream

__all__ = ["imagenet_like", "lm_batches", "token_stream", "DataPipeline"]
