"""``python -m predictionio_tpu_torch.tools.console`` — the ``pio`` console.

Alias module matching the reference's entry-point name
(``tools/.../console/Console.scala``); the implementation lives in
:mod:`predictionio_tpu_torch.tools.cli`.

The port's copy of ``predictionio_tpu/tools/console.py``.
"""

from predictionio_tpu_torch.tools.cli import build_parser, main  # noqa: F401

if __name__ == "__main__":
    raise SystemExit(main())
