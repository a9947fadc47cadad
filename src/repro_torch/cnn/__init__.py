"""The paper's CNN workloads as plain-data network descriptions."""
from .alexnet import alexnet
from .googlenet import googlenet
from .params import infer_shapes, init_network_params, params_from_numpy
from .squeezenet import squeezenet

__all__ = ["alexnet", "squeezenet", "googlenet", "infer_shapes",
           "init_network_params", "params_from_numpy"]
