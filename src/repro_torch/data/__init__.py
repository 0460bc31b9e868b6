"""Numpy data generation, partitioning and federated assembly."""
