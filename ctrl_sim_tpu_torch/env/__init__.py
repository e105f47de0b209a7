"""The batched driving environment of the port."""
