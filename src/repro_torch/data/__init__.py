"""Datasets and federated partitioning of the port."""
