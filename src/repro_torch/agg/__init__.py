from repro_torch.agg.aggregator import (AggState, Aggregator, RoundOut,
                                        flat_dim)
from repro_torch.agg.batching import CohortRound, RoundScheduler
from repro_torch.agg.device import (ClientMesh, client_mesh,
                                    execute_nested_sharded, execute_sharded,
                                    execute_sharded_batched, ring_chain_plan,
                                    run_nested_segments_local,
                                    run_plan_clients_batched,
                                    run_plan_clients_local,
                                    run_plan_segments_batched,
                                    run_plan_segments_local)
from repro_torch.agg.nested import (NestedPlan, NestedResult, as_nested,
                                    compile_nested, execute_nested,
                                    pod_ring_nested, zero_stage_ef)
from repro_torch.agg.plan import (AggPlan, RoundResult, as_tree,
                                  bandwidth_budgets, compile_plan, execute,
                                  execute_batched, stack_plans)
from repro_torch.agg.schedule import TopologySchedule, common_shape

__all__ = ["AggPlan", "RoundResult", "as_tree", "bandwidth_budgets",
           "compile_plan", "execute", "execute_batched", "stack_plans",
           "NestedPlan", "NestedResult", "compile_nested", "execute_nested",
           "as_nested", "pod_ring_nested", "zero_stage_ef",
           "CohortRound", "RoundScheduler", "TopologySchedule",
           "common_shape", "Aggregator", "AggState", "RoundOut", "flat_dim",
           "ClientMesh", "client_mesh", "execute_sharded",
           "execute_sharded_batched", "execute_nested_sharded",
           "run_plan_clients_local", "run_plan_clients_batched",
           "ring_chain_plan", "run_plan_segments_local",
           "run_plan_segments_batched", "run_nested_segments_local"]
