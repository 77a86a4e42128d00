"""Cluster topology — nodes and zones per paper Table 2.

| Role    | Tier  | CPU/millicores | RAM/GB | Number |
|---------|-------|----------------|--------|--------|
| Control | Cloud | 4000           | 4      | 1      |
| Worker  | Cloud | 3000           | 3      | 2      |
| Worker  | Edge  | 2000           | 2      | 2/zone |

Two edge zones (paper Fig. 2/5).  The control node hosts the Prometheus
stack and the autoscalers (paper §3.2.3) and takes no worker pods.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Node:
    name: str
    zone: str           # 'cloud' | 'edge-0' | 'edge-1'
    cpu_m: int          # millicores
    ram_mb: int
    schedulable: bool = True
    failed: bool = False
    # straggler: multiplier < 1.0 slows every pod on the node
    speed_factor: float = 1.0

    def __post_init__(self):
        self.alloc_m = 0  # scheduled millicores

    @property
    def free_m(self) -> int:
        return 0 if self.failed else self.cpu_m - self.alloc_m


@dataclasses.dataclass
class Topology:
    nodes: list[Node]

    def zone_nodes(self, zone: str) -> list[Node]:
        return [n for n in self.nodes
                if n.zone == zone and n.schedulable and not n.failed]

    def zone_capacity_m(self, zone: str) -> int:
        return sum(n.cpu_m for n in self.zone_nodes(zone))

    def max_replicas(self, zone: str, pod_cpu_m: int) -> int:
        """'Calculate max_replicas limited by system resources' (Alg. 1)."""
        return sum(n.cpu_m // pod_cpu_m for n in self.zone_nodes(zone))


def paper_topology(n_edge_zones: int = 2) -> Topology:
    nodes = [Node("control", "control", 4000, 4096, schedulable=False)]
    nodes += [Node(f"cloud-{i}", "cloud", 3000, 3072) for i in range(2)]
    for z in range(n_edge_zones):
        nodes += [Node(f"edge{z}-{i}", f"edge-{z}", 2000, 2048)
                  for i in range(2)]
    return Topology(nodes)


def fleet_topology(pods_per_zone: int, zones: list[str] | None = None,
                   pods_per_node: int = 64, pod_cpu_m: int = 500) -> Topology:
    """Fleet-scale topology: enough homogeneous worker nodes per zone to
    host ``pods_per_zone`` pods of ``pod_cpu_m`` each (DESIGN.md §3,
    "Fleet scale" — the 10⁴–10⁵-pod bench substrate).  Node size is
    expressed in pods (64 x 500m = a 32-core worker)."""
    zones = zones or ["fleet-0"]
    node_cpu_m = pods_per_node * pod_cpu_m
    n_nodes = -(-pods_per_zone // pods_per_node)    # ceil
    nodes = []
    for z in zones:
        nodes += [Node(f"{z}-n{i}", z, node_cpu_m, node_cpu_m // 2)
                  for i in range(n_nodes)]
    return Topology(nodes)
