"""Models: the paper's CNN (federated) and the model zoo's Mamba-2 LM."""
