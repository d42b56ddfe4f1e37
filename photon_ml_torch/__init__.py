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

and the fixed-effect GLM training path:

    io.libsvm.read_libsvm → data.batch.make_sparse_batch(grr=True)
      (data.grr.build_grr_pair: the C++ plan builder in native/)
      → ops.objective.GLMObjective → optim.problem.OptimizationProblem.run
      (L-BFGS / OWL-QN) → models.glm.GeneralizedLinearModel
      → evaluation.evaluators.auc
    with X·w and Xᵀr through ops.grr_kernel.grr_contract_dense /
    grr_contract (CUDA C++, csrc/grr_contract.cu); on the transposed
    ELL through gather_rowsum both ways; or on the plain-ELL layout
    through gather_rowsum and, for Xᵀr, ops.kernels.sorted_colsum
    (CUDA C++, csrc/sorted_colsum.cu) over the batch's column-sorted
    copy (data.colsorted), a float64 index_add_ where a batch has none
    (host and streamed chunks, the down-sampled view, λ lanes).

Every entry point runs on the GPU unless the caller passes
``device="cpu"`` (see ``device.resolve_device``).
"""

from photon_ml_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
