from repro_torch.optim.optimizers import (FlatOptState, OptConfig,
                                          TreeOptState, apply_flat,
                                          apply_tree, init_flat, init_tree)
from repro_torch.optim.schedule import lr_schedule

__all__ = ["FlatOptState", "OptConfig", "TreeOptState", "apply_flat",
           "apply_tree", "init_flat", "init_tree", "lr_schedule"]
