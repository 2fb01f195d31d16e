"""Property graphs (GraphX): the port of ``cycloneml_tpu/graph/``."""
from cycloneml_tpu_torch.graph.graph import Graph
from cycloneml_tpu_torch.graph.pregel import pregel

__all__ = ["Graph", "pregel"]
