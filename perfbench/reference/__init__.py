"""The plain reference that decides ``correct``.

Plain PyTorch in float32 with TF32 off.  It imports nothing of the port
(``amq_tpu_torch``), of the JAX package or of the rest of the
repository: it reads only what the benchmark made (packed words, scale,
zero, embedding, norms, biases, the served tokens) and works out
everything else itself.
"""
