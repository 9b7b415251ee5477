from repro_torch.fed.simulator import (LogisticRegression, RoundLog,
                                       SimState, Simulator)

__all__ = ["LogisticRegression", "RoundLog", "SimState", "Simulator"]
