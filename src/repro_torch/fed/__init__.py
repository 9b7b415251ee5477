from repro_torch.fed.simulator import (LogisticRegression, RoundLog,
                                       SimState, Simulator)
from repro_torch.fed.topology import (ChainTopology, FailureSchedule,
                                      LatencyModel, TreeTopology)

__all__ = ["LogisticRegression", "RoundLog", "SimState", "Simulator",
           "ChainTopology", "FailureSchedule", "LatencyModel",
           "TreeTopology"]
