"""The plain reference that a run's outputs are held to: ``sim`` (the
model, the env and the rollout in plain PyTorch), ``check`` (the
comparisons) and ``weights`` (the seeded weights both sides load)."""
