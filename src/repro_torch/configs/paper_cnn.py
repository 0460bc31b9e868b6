"""The paper's own model (§IV.D): MNIST CNN for the federated experiments."""
from repro_torch.models.cnn import CNNConfig

CONFIG = CNNConfig()
