from repro_torch.agg.plan import (AggPlan, RoundResult, as_tree,
                                  compile_plan, execute)

__all__ = ["AggPlan", "RoundResult", "as_tree", "compile_plan", "execute"]
