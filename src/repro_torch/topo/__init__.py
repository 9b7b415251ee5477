from repro_torch.topo.tree import (PS, AggTree, TreeResult, TreeSchedule,
                                   build_schedule, path_tree, round_latency_s,
                                   run_tree, star_tree)

__all__ = ["PS", "AggTree", "TreeResult", "TreeSchedule", "build_schedule",
           "path_tree", "round_latency_s", "run_tree", "star_tree"]
