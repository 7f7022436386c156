"""Synthetic federated datasets (no download)."""

from repro_torch.data.synthetic import (FederatedDataset, make_cifar10_like,
                                        make_femnist_like, make_lm_federated,
                                        make_token_stream)

__all__ = ["FederatedDataset", "make_cifar10_like", "make_femnist_like",
           "make_lm_federated", "make_token_stream"]
