"""The paper's own experimental setup (§VI): logistic regression on
(synthetic-)MNIST, d = 7850 trainable parameters, SGD batch 20, lr 0.1,
Q = 78 (1% of d), Q_L = 8, Q_G = 70, K = 28 clients.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    input_dim: int = 784
    num_classes: int = 10
    d: int = 7850                    # 784·10 + 10
    num_clients: int = 28
    batch_size: int = 20
    lr: float = 0.1
    q: int = 78                      # 1% of d
    q_local: int = 8                 # 10% of Q (paper follows [10])
    q_global: int = 70               # Q − Q_L
    omega: int = 32


PAPER = PaperConfig()
