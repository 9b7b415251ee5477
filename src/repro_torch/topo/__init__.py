from repro_torch.topo.graph import (ConstellationGraph, grid_graph,
                                    path_graph, random_geometric,
                                    star_graph, walker_delta, walker_star)
from repro_torch.topo.routing import (NestedTopology, cluster_routed,
                                      extract_tree, healed_chain_tree,
                                      partition_clusters, route_tree,
                                      shortest_path_tree, widest_path_tree)
from repro_torch.topo.tree import (PS, AggTree, TreeResult, TreeSchedule,
                                   build_schedule, path_tree, round_latency_s,
                                   run_tree, star_tree)

__all__ = ["ConstellationGraph", "path_graph", "star_graph", "grid_graph",
           "random_geometric", "walker_delta", "walker_star",
           "shortest_path_tree", "widest_path_tree", "route_tree",
           "healed_chain_tree", "extract_tree", "NestedTopology",
           "cluster_routed", "partition_clusters",
           "PS", "AggTree", "TreeResult", "TreeSchedule", "build_schedule",
           "path_tree", "round_latency_s", "run_tree", "star_tree"]
