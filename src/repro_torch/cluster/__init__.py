from repro_torch.cluster.topology import Node, Topology, paper_topology
from repro_torch.cluster.simulator import (ClusterSim, SimConfig, Task, PodState,
                                     AutoscalerBinding)
