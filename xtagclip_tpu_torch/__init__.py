"""PyTorch + CUDA port of xtagclip_tpu for NVIDIA Hopper (H100).

The JAX package ``xtagclip_tpu`` is the reference; this package mirrors its
layout and names and never imports it (nor jax/flax). Entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
The two fused block halves run as hand-written sm_90a CUDA kernels
(``csrc/``, built on first use into ``_build/``).
"""
