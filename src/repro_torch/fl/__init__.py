"""Federated-learning data plane on tensors: small models, the round engine."""
