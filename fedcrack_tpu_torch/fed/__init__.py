"""Federated aggregation: FedAvg, FedProx and the ordered fold."""
