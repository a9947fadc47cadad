from .synthetic import imagenet_like

__all__ = ["imagenet_like"]
