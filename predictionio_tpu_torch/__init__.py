"""PyTorch/CUDA port of predictionio-tpu.

A second package beside the JAX one (``predictionio_tpu``), which stays
as the reference. Module names mirror the JAX package's so each
counterpart is easy to find; this package imports ``torch`` and numpy,
never ``jax`` and nothing of ``predictionio_tpu``.

Ported so far: the recommendation template's training path —
``controller.engine.Engine.train`` → ``train_pipeline`` →
``RatingsPreparator`` → ``ALSAlgorithm.train`` →
``parallel.als_sharding.train_als_auto`` → ``ops.als._solve_rows`` →
``ops.als_cuda.assemble_normal_equations`` and ``spd_solve``
(``ops/csrc/als_solve.cu``) — and its query path —
``workflow.create_server.QueryServer`` → ``serve_query`` →
``ALSAlgorithm.predict`` → ``ops.serving.DeviceTopK`` →
``ops.als_cuda.fused_gather_score_topk`` (``ops/csrc/fused_topk.cu``).
The kernels are hand-written CUDA for Hopper. Entry points run on the
GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
