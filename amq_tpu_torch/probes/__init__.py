"""Decode-GEMV probes on the card: the port's counterparts of the JAX
package's ``scripts/kernel_attrib.py`` (an attribution of the decode
GEMV bodies, ``kernel_attrib``), ``scripts/pipelined_gemv.py`` (an
extract-ahead GEMV on warpgroup MMA, ``pipelined_gemv``) and
``scripts/kernel_roofline.py`` (the dequant matmul per width and
container, ``kernel_roofline``), with
the chain timer they share (``chain``), and a ring-shape sweep of the
grouped GEMV per code width (``grouped_ring``) and a decode A/B across
checkouts (``decode_ab``), the port's own.  Each is a module with a CLI:
``python -m amq_tpu_torch.probes.<name> ...``.
"""
