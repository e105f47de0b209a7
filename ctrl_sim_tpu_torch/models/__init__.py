"""The CtRL-Sim transformer of the port (streaming interface)."""
