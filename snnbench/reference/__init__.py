"""The plain reference of the benchmark: a LIF-graph simulator in plain
PyTorch over the CSR synapses the benchmark generated.  It imports
nothing of the program, of the JAX package or of JAX."""
from .lif_graph import Simulator, graph_order

__all__ = ["Simulator", "graph_order"]
