from repro_torch.data.federated import (FederatedData, client_minibatch,
                                        minibatch_indices, partition_dirichlet,
                                        partition_iid)
from repro_torch.data.synthetic import Dataset, make_synthetic_mnist

__all__ = ["Dataset", "FederatedData", "client_minibatch",
           "make_synthetic_mnist", "minibatch_indices", "partition_dirichlet",
           "partition_iid"]
