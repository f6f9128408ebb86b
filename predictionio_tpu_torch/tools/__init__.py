"""Operator tooling: the ``pio`` console (``python -m
predictionio_tpu_torch.tools.console``, or the ``pio-torch`` script).

The port's copy of ``predictionio_tpu/tools/``: every verb of the JAX
package's console.
"""
