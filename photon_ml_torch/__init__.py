"""photon_ml_torch: the PyTorch/CUDA counterpart of ``photon_ml_tpu``.

The package mirrors ``photon_ml_tpu``'s layout module for module
(``photon_ml_torch/serving/engine.py`` is the counterpart of
``photon_ml_tpu/serving/engine.py``) and keeps its on-disk formats, so a
model directory or an entity-store spill dir written by one package is
read by the other.  It imports ``torch`` and numpy only — never ``jax``
and nothing of ``photon_ml_tpu``.

What is here so far is the online serving path:

    python -m photon_ml_torch.serving --config serve.json
      → serving.server.ModelServer → serving.batcher.MicroBatcher
      → serving.engine.ScoringEngine.score_batch
      → estimators.streaming_scorer.run_chunk
      → ops.kernels.gather_rowsum (CUDA C++, csrc/gather_rowsum.cu)

Every entry point runs on the GPU unless the caller passes
``device="cpu"`` (see ``device.resolve_device``).
"""

from photon_ml_torch.device import resolve_device

__all__ = ["resolve_device"]
