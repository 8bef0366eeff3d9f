"""PyTorch/CUDA port of the DANA asynchronous parameter server.

The port runs beside the JAX package ``repro`` and imports nothing of it
(nor JAX).  Module names follow ``repro``'s, so each module's counterpart
is found by name.  Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"``.
"""
