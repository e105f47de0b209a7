"""The closed-loop streaming rollout of the port."""
