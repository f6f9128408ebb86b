"""PyTorch/CUDA port of predictionio-tpu.

A second package beside the JAX one (``predictionio_tpu``), which stays
as the reference. Module names mirror the JAX package's so each
counterpart is easy to find; this package imports ``torch`` and numpy,
never ``jax`` and nothing of ``predictionio_tpu``.

Ported so far: the recommendation template's query path —
``workflow.create_server.QueryServer`` → ``serve_query`` →
``templates.recommendation.engine.ALSAlgorithm.predict`` →
``ops.serving.DeviceTopK`` → ``ops.als_cuda.fused_gather_score_topk``
(a hand-written CUDA kernel for Hopper, ``ops/csrc/fused_topk.cu``).
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
