"""Operator tooling: the ``pio`` console (``python -m
predictionio_tpu_torch.tools.console``, or the ``pio-torch`` script).

The port's copy of ``predictionio_tpu/tools/``, the verbs of the quick
start; the others raise and name the ROADMAP item that ports them.
"""
