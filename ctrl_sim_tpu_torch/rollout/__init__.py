"""The closed-loop rollouts of the port: exact (re-decoding the window) and
streaming (KV-cached)."""
