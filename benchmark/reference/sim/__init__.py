"""A frozen copy of the plain PyTorch parts of ``ctrl_sim_tpu_torch``, taken
at commit 8ca5a01: the config, the model (encoder, map encoder, decoder,
heads, losses), the env (dynamics, collisions, contact solver, rewards),
the data pipeline (synthetic scenes, replay, training batches) and the
streaming rollout, with every hand-written kernel replaced by its plain
version (``ops/attention.py``, ``ops/flash_attention.py``).

The benchmark runs it in float32 as the reference of the port: it imports
nothing of the port, so a later change to the port cannot move the
yardstick. It is not edited to follow the port; where the port's
semantics change on purpose, a benchmark change replaces it."""
