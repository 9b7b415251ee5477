from repro_torch.data.federated import (FederatedData, client_minibatch,
                                        minibatch_indices, partition_dirichlet,
                                        partition_iid)
from repro_torch.data.synthetic import (BigramLM, Dataset, lm_batch,
                                        make_bigram_lm, make_synthetic_mnist,
                                        sample_bigram)

__all__ = ["BigramLM", "Dataset", "FederatedData", "client_minibatch",
           "lm_batch", "make_bigram_lm", "make_synthetic_mnist",
           "minibatch_indices", "partition_dirichlet", "partition_iid",
           "sample_bigram"]
