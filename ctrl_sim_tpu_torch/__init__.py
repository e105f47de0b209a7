"""PyTorch port of ctrl_sim_tpu for NVIDIA Hopper GPUs.

The JAX package ``ctrl_sim_tpu`` stays the reference; this package imports
nothing of it. Its entry points run on the card unless the caller passes
``device="cpu"``. Ported so far, for the default CtRL-Sim family with
contacts off: the 2-pass streaming closed-loop rollout
(``rollout.streaming``), with the decode attention over the KV cache as a
hand-written CUDA kernel (``ops.attention``, source
``csrc/decode_attention.cu``), and offline-RL training (``train``,
``training``, ``data.store``), with the decoder's flash attention forward
and backward as hand-written CUDA kernels (``ops.flash_attention``, source
``csrc/flash_attention.cu``).
"""
