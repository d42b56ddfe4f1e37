"""GameEstimator: configuration + data → trained, evaluated GAME models.

Counterpart of the resident part of
``photon_ml_tpu/estimators/game_estimator.py``: build the datasets once
(intercept column, layout, normalization, down-sampling), then for each
point of the regularization grid build the coordinates, run coordinate
descent, export the model in raw feature space and evaluate it on the
validation data (once a sweep when ``validate_per_iteration``).  A grid
over the one trainable L-BFGS/OWL-QN fixed effect trains as ONE swept
solve (``_fit_grid_swept``: L coefficient lanes share every objective
evaluation), and ``fit_tuned`` runs the hyperparameter tuner, a swept
solve a proposal round where the same holds.

Everything runs on ``TrainingConfig.device`` (default CUDA; the entry
raises without it unless "cpu" is asked for).  ``sparse_layout`` AUTO
resolves to plain ELL, as in the JAX package off the TPU; COLMAJOR puts
``Xᵀr`` on B1 over the transposed ELL, GRR on the B2/B3 plan.  With
``chunk_rows`` the fixed effect is a ``ChunkedBatch`` (ELL chunks,
spilled to ``spill_dir`` when one is given) streamed to the card on
every evaluation.  With ``re_chunk_entities`` each random effect is a
``StreamedRandomEffectCoordinate`` (entity chunks spilled to
``spill_dir``, converged entities retired between sweeps); with
``cd_fused`` a fit is one ``game.fused_sweep`` pass a cycle over the
chunked fixed effect and every random effect.  With ``checkpoint_dir``
the coordinate descent, the swept fit's lanes and the tuner's rounds
snapshot, and ``resume`` restores them.  A mesh is ROADMAP A7.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import time

import numpy as np
import torch

from photon_ml_torch.config import (
    CoordinateConfig,
    CoordinateKind,
    OptimizerSettings,
    TrainingConfig,
)
from photon_ml_torch.data.batch import make_dense_batch, make_sparse_batch
from photon_ml_torch.data.normalization import (
    NormalizationContext,
    NormalizationType,
    compute_normalization,
)
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.data.statistics import compute_statistics
from photon_ml_torch.device import resolve_device
from photon_ml_torch.estimators.game_transformer import GameTransformer
from photon_ml_torch.evaluation.evaluators import better_than, evaluate
from photon_ml_torch.game.coordinate_descent import (
    _revive_validation,
    _serialize_validation,
    run_coordinate_descent,
)
from photon_ml_torch.game.coordinates import (
    ChunkedFixedEffectCoordinate,
    FixedEffectCoordinate,
    build_random_effect_coordinate,
    build_random_effect_coordinate_sparse,
    build_streamed_random_effect_coordinate,
)
from photon_ml_torch.game.dataset import GameDataset, sorted_key_join
from photon_ml_torch.game.sampling import binary_classification_down_sample
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.prior import GaussianPrior
from photon_ml_torch.ops.regularization import (
    RegularizationContext,
    RegularizationType,
    SweptRegularization,
    exclude_intercept_mask,
)
from photon_ml_torch.optim.base import OptimizerConfig, OptimizerType
from photon_ml_torch.optim.problem import OptimizationProblem
from photon_ml_torch.optim.variance import VarianceComputationType
from photon_ml_torch.reliability import checkpoint as _ckpt

logger = logging.getLogger(__name__)

Tensor = torch.Tensor


@dataclasses.dataclass
class FitResult:
    """(model, evaluations, grid point), plus the per-sweep validation
    metrics and the coordinate-descent result behind the model."""

    model: GameModel
    evaluations: dict            # EvaluatorType → float (validation)
    reg_weights: dict            # coordinate name → λ used
    validation_history: list = dataclasses.field(default_factory=list)
    descent: object = None       # game.coordinate_descent result


def _reg_context(settings: OptimizerSettings, weight: float, dim: int,
                 intercept_index: int | None, device
                 ) -> RegularizationContext:
    mask = exclude_intercept_mask(dim, intercept_index, device=device)
    if settings.regularization == RegularizationType.NONE or weight == 0.0:
        return RegularizationContext.none()
    return RegularizationContext.of(settings.regularization, weight,
                                    settings.elastic_net_alpha, mask)


def _optimizer_config(settings: OptimizerSettings) -> OptimizerConfig:
    return OptimizerConfig(max_iters=settings.max_iters,
                           tolerance=settings.tolerance,
                           track_states=settings.track_states)


def _cpu(t: Tensor) -> Tensor:
    return t.detach().cpu()


class GameEstimator:
    """Build the datasets once; fit once a grid point."""

    def __init__(self, config: TrainingConfig):
        config.validate()
        self.config = config
        self.device = resolve_device(config.device)
        self.task = config.task_type
        self.loss = self.task.loss
        self._warm_model = None
        # The host residency group of the store-backed coordinates (set
        # by _share_chunk_window, or by the fused engine's build).
        self._chunk_window_group = None
        if config.warm_start_model_dir:
            from photon_ml_torch.io.model_io import load_game_model

            self._warm_model, warm_task = load_game_model(
                config.warm_start_model_dir)
            if warm_task != self.task:
                raise ValueError(
                    f"warm-start model task {warm_task} != {self.task}")

    # -- dataset preparation (once) ----------------------------------------

    def _prepare(self, train: GameDataset) -> dict:
        return {c.name: self._prepare_fixed(train, c)
                for c in self.config.coordinates
                if c.kind == CoordinateKind.FIXED_EFFECT}

    def _layout(self) -> str:
        layout = self.config.sparse_layout
        return "ELL" if layout == "AUTO" else layout

    def _prepare_fixed(self, train: GameDataset,
                       coord_cfg: CoordinateConfig) -> dict:
        cfg = self.config
        dev = self.device
        feats = train.features[coord_cfg.feature_shard]
        labels = train.labels.astype(np.float32)
        weights = train.weight_array()
        intercept_index = None
        if isinstance(feats, np.ndarray):
            if cfg.chunk_rows is not None:
                raise ValueError(
                    "chunk_rows supports sparse feature shards only; "
                    f"fixed-effect shard '{coord_cfg.feature_shard}' is "
                    "a dense array (a resident DenseBatch would defeat "
                    "the beyond-HBM purpose of chunking)")
            x = np.asarray(feats, np.float32)
            if cfg.intercept:
                x = np.concatenate([x, np.ones((len(x), 1), np.float32)], 1)
                intercept_index = x.shape[1] - 1
            batch = make_dense_batch(x, labels, weights=weights, device=dev)
            dim = x.shape[1]
        else:
            dim = train.feature_dim(coord_cfg.feature_shard)
            rows = SparseRows.from_rows(feats)
            if cfg.intercept:
                rows = rows.with_constant_col(dim)
                intercept_index = dim
                dim += 1
            if cfg.chunk_rows is not None:
                return self._prepare_chunked(rows, dim, labels, weights,
                                             intercept_index)
            layout = self._layout()
            # The ELL arrays serve normalization statistics and the
            # down-sampled view; a GRR batch that needs neither skips them.
            keep_ell = (cfg.normalization != NormalizationType.NONE
                        or coord_cfg.down_sampling_rate is not None)
            batch = make_sparse_batch(
                rows, dim, labels, weights=weights, grr=(layout == "GRR"),
                col_major=(layout == "COLMAJOR"), keep_ell=keep_ell,
                cache_dir=cfg.plan_cache_dir, device=dev)

        norm = NormalizationContext.identity()
        if cfg.normalization != NormalizationType.NONE:
            if (cfg.normalization == NormalizationType.STANDARDIZATION
                    and intercept_index is None):
                raise ValueError(
                    "STANDARDIZATION requires intercept=True (the margin "
                    "shift folds into the intercept at export)")
            stats = compute_statistics(batch)
            norm = compute_normalization(
                stats.mean, stats.std, stats.max_abs, cfg.normalization,
                intercept_index=intercept_index)

        train_idx = train_weights = None
        if coord_cfg.down_sampling_rate is not None:
            idx, new_w = binary_classification_down_sample(
                labels, weights, coord_cfg.down_sampling_rate, seed=cfg.seed)
            train_idx = torch.from_numpy(idx.astype(np.int64)).to(dev)
            train_weights = torch.from_numpy(new_w).to(dev)
        return {"batch": batch, "norm": norm, "dim": dim,
                "intercept_index": intercept_index, "train_idx": train_idx,
                "train_weights": train_weights}

    def _prepare_chunked(self, rows, dim: int, labels, weights,
                         intercept_index) -> dict:
        """The chunk-streamed fixed effect: ELL chunks on the host, spilled
        to ``spill_dir`` (or ``$PHOTON_ML_TPU_SPILL_DIR``: the environment
        default applies at this layer only).  AUTO resolves to ELL on
        CUDA, as the reference's AUTO does off the TPU."""
        from photon_ml_torch.data.chunk_store import resolve_spill_dir
        from photon_ml_torch.data.chunked_batch import build_chunked_batch

        cfg = self.config
        layout = "ELL" if cfg.chunk_layout == "AUTO" else cfg.chunk_layout
        chunked = build_chunked_batch(
            rows, dim, labels, weights=weights, chunk_rows=cfg.chunk_rows,
            layout=layout.lower(), cache_dir=cfg.plan_cache_dir,
            spill_dir=resolve_spill_dir(cfg.spill_dir),
            host_max_resident=cfg.host_max_resident)
        return {"chunked": chunked, "batch": None,
                "norm": NormalizationContext.identity(), "dim": dim,
                "intercept_index": intercept_index, "train_idx": None,
                "train_weights": None}

    # -- warm start (a saved raw-space model → training space) -------------

    def _import_fixed(self, comp: FixedEffectModel, p: dict):
        """Invert ``_export_fixed``: raw-space means (and variances) →
        model-space tensors on the device."""
        w_raw = np.asarray(_cpu(comp.coefficients.means), np.float64)
        dim, ii = p["dim"], p["intercept_index"]
        if len(w_raw) != dim:
            raise ValueError(
                f"warm-start fixed-effect dim {len(w_raw)} != {dim} "
                "(feature space changed; rebuild index maps)")
        norm = p["norm"]
        f = (_cpu(norm.factors).double().numpy()
             if norm.factors is not None else np.ones(dim))
        wm = w_raw / f
        if norm.shifts is not None and ii is not None:
            s = _cpu(norm.shifts).double().numpy()
            wm[ii] = w_raw[ii] + float(np.dot(s * f, wm))
        variances = None
        if comp.coefficients.variances is not None:
            variances = np.asarray(_cpu(comp.coefficients.variances),
                                   np.float64) / (f * f)

        def dev(a):
            return torch.from_numpy(a.astype(np.float32)).to(self.device)
        return dev(wm), None if variances is None else dev(variances)

    def _import_random(self, comp: RandomEffectModel, coord) -> list:
        """A saved random effect mapped onto this run's grouping by
        entity id (vectorized: one sorted join, then block gathers a
        (new bucket, old bucket) pair); unseen entities start at 0."""
        w0s = [np.zeros(shape, np.float32)
               for shape in coord.coefficient_shapes]
        g, gs = coord.grouping, comp.grouping
        if g.n_total_entities and gs.n_total_entities:
            saved_pos = gs.join_ids(np.asarray(g.entity_ids))
            found = saved_pos >= 0
            pos_c = np.maximum(saved_pos, 0)
            old_bucket = np.asarray(gs.entity_bucket)[pos_c]
            old_slot = np.asarray(gs.entity_slot)[pos_c]
            new_bucket = np.asarray(g.entity_bucket)
            new_slot = np.asarray(g.entity_slot)
            old_blocks = [_cpu(blk).numpy() for blk in comp.coefficient_blocks]
            for b in range(len(w0s)):
                for ob in range(len(old_blocks)):
                    sel = found & (new_bucket == b) & (old_bucket == ob)
                    if sel.any():
                        self._import_cells(
                            w0s[b], old_blocks[ob], new_slot[sel],
                            old_slot[sel], coord.projection,
                            comp.projection, b, ob)
        return [torch.from_numpy(w).to(self.device) for w in w0s]

    @staticmethod
    def _import_cells(w0, blk_old_all, ns, os_, proj_new, proj_old, b, ob):
        blk_old = blk_old_all[os_]                       # [m, p_old]
        if proj_new is None and proj_old is None:
            if blk_old.shape[1] == w0.shape[1]:          # else stays at 0
                w0[ns] = blk_old
        elif proj_new is None:
            # Saved projected, target dense: scatter to global columns.
            if proj_old.global_dim == w0.shape[1]:
                fids = proj_old.feature_ids[ob][os_]
                rr, cc = np.nonzero(fids >= 0)
                w0[ns[rr], fids[rr, cc]] = blk_old[rr, cc]
        elif proj_old is None:
            # Saved dense, target projected: gather its subspace columns.
            fids = proj_new.feature_ids[b][ns]
            rr, cc = np.nonzero((fids >= 0) & (fids < blk_old.shape[1]))
            w0[ns[rr], cc] = blk_old[rr, fids[rr, cc]]
        else:
            # Both projected: merge-join on (entity, global col) keys.
            G = np.int64(proj_old.global_dim)
            f_old = proj_old.feature_ids[ob][os_]
            ro, co = np.nonzero(f_old >= 0)
            key_old = ro.astype(np.int64) * G + f_old[ro, co]
            f_new = proj_new.feature_ids[b][ns]
            rn, cn = np.nonzero((f_new >= 0) & (f_new < G))
            key_new = rn.astype(np.int64) * G + f_new[rn, cn]
            w_at, hit = sorted_key_join(key_old, blk_old[ro, co], key_new)
            w0[ns[rn[hit]], cn[hit]] = w_at[hit]

    def _warm_coefficients(self, coords: dict, prep: dict) -> dict:
        out = {}
        if self._warm_model is None:
            return out
        by_name = {c.name: c for c in self.config.coordinates}
        for name, comp in self._warm_model.models.items():
            if name not in coords:
                continue
            if by_name[name].kind == CoordinateKind.FIXED_EFFECT:
                out[name], _ = self._import_fixed(comp, prep[name])
            else:
                out[name] = self._import_random(comp, coords[name])
        return out

    # -- coordinates (a grid point) -----------------------------------------

    def _build_coordinates(self, train: GameDataset, prep: dict,
                           reg_weights: dict) -> dict:
        cfg = self.config
        coords = {}
        for cc in cfg.coordinates:
            weight = reg_weights.get(cc.name, cc.optimizer.reg_weight)
            ocfg = _optimizer_config(cc.optimizer)
            if cc.kind == CoordinateKind.FIXED_EFFECT:
                p = prep[cc.name]
                prior = None
                if (cfg.use_warm_start_as_prior
                        and self._warm_model is not None
                        and cc.name in self._warm_model.models):
                    means, variances = self._import_fixed(
                        self._warm_model.models[cc.name], p)
                    if variances is not None:
                        prior = GaussianPrior.from_model(
                            means, variances, cfg.prior_weight)
                objective = GLMObjective(
                    loss=self.loss,
                    reg=_reg_context(cc.optimizer, weight, p["dim"],
                                     p["intercept_index"], self.device),
                    norm=p["norm"], prior=prior)
                if p.get("chunked") is not None:
                    coords[cc.name] = ChunkedFixedEffectCoordinate(
                        name=cc.name, chunked=p["chunked"],
                        objective=objective,
                        optimizer=cc.optimizer.optimizer, config=ocfg,
                        max_resident=cfg.chunk_max_resident,
                        prefetch_depth=cfg.prefetch_depth,
                        device=self.device)
                    continue
                coords[cc.name] = FixedEffectCoordinate(
                    name=cc.name, batch=p["batch"],
                    problem=OptimizationProblem(
                        objective=objective,
                        optimizer=cc.optimizer.optimizer, config=ocfg),
                    train_idx=p["train_idx"],
                    train_weights=p["train_weights"])
                continue
            objective = GLMObjective(
                loss=self.loss,
                reg=_reg_context(cc.optimizer, weight, 1, None, self.device),
                norm=NormalizationContext.identity())
            if cfg.re_chunk_entities is not None:
                from photon_ml_torch.data.chunk_store import (
                    resolve_spill_dir,
                )

                # The environment default applies at this layer only.
                spill = resolve_spill_dir(cfg.spill_dir)
                if spill is None:
                    raise ValueError(
                        "re_chunk_entities requires spill_dir (or "
                        "$PHOTON_ML_TPU_SPILL_DIR)")
                coord = build_streamed_random_effect_coordinate(
                    cc.entity_key, train, cc.feature_shard, objective,
                    spill_dir=spill, chunk_entities=cfg.re_chunk_entities,
                    config=ocfg, optimizer=cc.optimizer.optimizer,
                    host_max_resident=cfg.host_max_resident,
                    prefetch_depth=cfg.prefetch_depth,
                    retirement=cfg.re_retirement, device=self.device)
            elif isinstance(train.features[cc.feature_shard], np.ndarray):
                coord = build_random_effect_coordinate(
                    cc.entity_key, train, cc.feature_shard, objective,
                    config=ocfg, optimizer=cc.optimizer.optimizer,
                    device=self.device)
            else:
                coord = build_random_effect_coordinate_sparse(
                    cc.entity_key, train, cc.feature_shard, objective,
                    global_dim=train.feature_dim(cc.feature_shard),
                    config=ocfg, optimizer=cc.optimizer.optimizer,
                    device=self.device)
            # Built under its entity key; known by the coordinate name.
            coord.name = cc.name
            coords[cc.name] = coord
        self._share_chunk_window(coords)
        return coords

    def _share_chunk_window(self, coords: dict) -> None:
        """One host residency budget (``host_max_resident``) over every
        store-backed coordinate (a chunked fixed effect's, a streamed
        random effect's), when there is more than one."""
        from photon_ml_torch.data.chunk_store import SharedChunkWindow

        self._chunk_window_group = None
        stores = [c.chunked.store for c in coords.values()
                  if getattr(c, "chunked", None) is not None
                  and c.chunked.store is not None]
        stores += [c.store for c in coords.values()
                   if getattr(c, "store", None) is not None]
        if len(stores) < 2:
            return
        group = SharedChunkWindow(self.config.host_max_resident)
        for store in stores:
            store.join_window_group(group)
        self._chunk_window_group = group

    def _fused_engine(self, train: GameDataset, coords: dict):
        """The fused cycle over the built coordinates (the config checked
        its shape).  The sidecars share the fixed effect's host window:
        a pass holds fixed-effect chunk i and sidecar i together."""
        from photon_ml_torch.data.chunk_store import (
            SharedChunkWindow,
            resolve_spill_dir,
        )
        from photon_ml_torch.game.fused_sweep import build_fused_cycle_engine

        cfg = self.config
        spill = resolve_spill_dir(cfg.spill_dir)
        group = self._chunk_window_group
        if group is None and spill is not None:
            fe_store = next(
                (c.chunked.store for c in coords.values()
                 if getattr(c, "chunked", None) is not None
                 and c.chunked.store is not None), None)
            if fe_store is not None:
                group = SharedChunkWindow(cfg.host_max_resident)
                fe_store.join_window_group(group)
                self._chunk_window_group = group
        return build_fused_cycle_engine(
            train, coords, cfg.update_sequence,
            re_shards={c.name: c.feature_shard for c in cfg.coordinates},
            spill_dir=spill, host_max_resident=cfg.host_max_resident,
            prefetch_depth=cfg.prefetch_depth,
            retirement=cfg.re_retirement, window_group=group)

    # -- export -------------------------------------------------------------

    def _export_fixed(self, coord: FixedEffectCoordinate, w: Tensor,
                      coord_cfg: CoordinateConfig,
                      variances=None) -> FixedEffectModel:
        """Raw feature space: scaled by the normalization factors, the
        margin shift folded into the intercept, so a saved model scores
        raw features with a plain dot product."""
        norm = coord.problem.objective.norm
        w_raw = _cpu(norm.model_to_raw(w)).clone()
        if norm.shifts is not None:
            w_raw[-1] -= float(norm.margin_correction(w))
        var_raw = None
        if variances is not None:
            f = (_cpu(norm.factors) if norm.factors is not None
                 else torch.ones_like(w_raw))
            var_raw = _cpu(variances) * f * f
        return FixedEffectModel(
            coefficients=Coefficients(means=w_raw, variances=var_raw),
            feature_shard=coord_cfg.feature_shard,
            intercept=self.config.intercept)

    def _random_model(self, coord, w, coord_cfg) -> RandomEffectModel:
        model = coord.as_model([_cpu(b) for b in w])
        model.feature_shard = coord_cfg.feature_shard
        model.entity_key = coord_cfg.entity_key
        return model

    def _model_snapshot(self, coords: dict, coefficients: dict) -> GameModel:
        """Current coefficients as a model without variances (what the
        per-sweep validation scores)."""
        by_name = {c.name: c for c in self.config.coordinates}
        models = {}
        for name, w in coefficients.items():
            cc = by_name[name]
            models[name] = (
                self._export_fixed(coords[name], w, cc)
                if cc.kind == CoordinateKind.FIXED_EFFECT
                else self._random_model(coords[name], w, cc))
        return GameModel(models=models)

    def _to_game_model(self, coords: dict, cd) -> GameModel:
        by_name = {c.name: c for c in self.config.coordinates}
        models = {}
        for name, w in cd.coefficients.items():
            cc = by_name[name]
            coord = coords[name]
            vtype = cc.optimizer.variance_type
            offsets = cd.total_scores - cd.scores[name]
            if cc.kind == CoordinateKind.FIXED_EFFECT:
                variances = (None if vtype == VarianceComputationType.NONE
                             else coord.compute_variances(w, offsets, vtype))
                models[name] = self._export_fixed(coord, w, cc, variances)
            else:
                models[name] = self._random_model(coord, w, cc)
                if vtype != VarianceComputationType.NONE:
                    # Per-entity variances are SIMPLE by design.
                    models[name].variance_blocks = [
                        _cpu(v) for v in coord.compute_variance_blocks(
                            w, offsets)]
        return GameModel(models=models)

    # -- fit ----------------------------------------------------------------

    def _grid_points(self) -> list[dict]:
        grid = self.config.reg_weight_grid
        if not grid:
            return [{}]
        names = sorted(grid)
        return [dict(zip(names, vals))
                for vals in itertools.product(*(grid[n] for n in names))]

    def _swept_coordinate_name(self) -> str | None:
        """The single trainable fixed effect eligible for swept-λ
        training, or None: exactly one trainable (non-locked) coordinate
        in the update sequence, a fixed effect, L-BFGS/OWL-QN (TRON fits
        stay point by point), and no locked coordinate asking for
        variances.  Locked coordinates fold into the lane-shared
        offsets."""
        cfg = self.config
        trainable = [n for n in dict.fromkeys(cfg.update_sequence)
                     if n not in cfg.locked_coordinates]
        if len(trainable) != 1:
            return None
        cc = {c.name: c for c in cfg.coordinates}.get(trainable[0])
        if (cc is None or cc.kind != CoordinateKind.FIXED_EFFECT
                or cc.optimizer.optimizer == OptimizerType.TRON):
            return None
        for c in cfg.coordinates:
            if (c.name in cfg.locked_coordinates
                    and c.optimizer.variance_type
                    != VarianceComputationType.NONE):
                return None
        return trainable[0]

    # -- the swept λ grid (one data stream for the whole grid) -------------

    def _locked_offsets(self, coords: dict, locked: dict, n: int) -> Tensor:
        """The offsets the one trainable coordinate sees: the locked
        coordinates' scores summed."""
        total = torch.zeros(n, dtype=torch.float32, device=self.device)
        for name, w in locked.items():
            total = total + coords[name].score(w)
        return total

    def _lane_coordinate(self, coord: FixedEffectCoordinate,
                         coord_cfg: CoordinateConfig, lam: float):
        """The fixed effect with one lane's λ installed (a lane's
        variances: the Hessian includes λ₂)."""
        opt = coord_cfg.optimizer
        obj = coord.problem.objective
        obj_l = dataclasses.replace(obj, reg=RegularizationContext.of(
            opt.regularization, lam, opt.elastic_net_alpha,
            obj.reg.reg_mask))
        if isinstance(coord, ChunkedFixedEffectCoordinate):
            return dataclasses.replace(coord, objective=obj_l)
        return dataclasses.replace(coord, problem=dataclasses.replace(
            coord.problem, objective=obj_l))

    def _swept_lane_model(self, coords: dict, name: str, w_j: Tensor,
                          locked: dict, offsets: Tensor, lam: float,
                          with_variances: bool = True) -> GameModel:
        """One lane's GameModel: the snapshot (the fixed effect at this
        λ and the locked coordinates), its fixed effect exported with
        the lane's variances when they are asked for."""
        model = self._model_snapshot(coords, {**locked, name: w_j})
        cc = {c.name: c for c in self.config.coordinates}[name]
        vtype = cc.optimizer.variance_type
        if with_variances and vtype != VarianceComputationType.NONE:
            variances = self._lane_coordinate(
                coords[name], cc, lam).compute_variances(w_j, offsets, vtype)
            model.models[name] = self._export_fixed(coords[name], w_j, cc,
                                                    variances)
        return model

    def _train_swept_lanes(self, coords: dict, name: str, lams,
                           offsets: Tensor, locked: dict, validation,
                           run_logger, warm_W: Tensor | None = None,
                           base_w0: Tensor | None = None,
                           checkpointer=None, resume: bool = False,
                           stage: str = "swept"):
        """Train λ lanes as ONE batched solve a sweep; returns
        (FitResults in the order of ``lams``, W [L, dim] in that order).

        The lanes run λ-descending inside the solve (strongly
        regularized lanes converge first and coast while the weak ones
        refine); results come back in the caller's order.  With
        ``validate_per_iteration`` every lane is evaluated after every
        sweep, as ``_fit_point`` does.  With a ``checkpointer`` the lane
        matrix, the sweep index and the lanes' validation history
        snapshot to stage ``stage`` at the sweep cadence, the swept
        solver snapshots mid-solve under a per-sweep scope, and
        ``resume`` restores both."""
        cfg = self.config
        cc = {c.name: c for c in cfg.coordinates}[name]
        coord = coords[name]
        lams_arr = np.asarray(lams, np.float32)
        order = np.argsort(-lams_arr, kind="stable")
        inv = torch.from_numpy(np.argsort(order)).to(self.device)
        reg = SweptRegularization.from_grid(
            cc.optimizer.regularization, lams_arr[order],
            cc.optimizer.elastic_net_alpha)
        L = len(lams)
        W = None
        if warm_W is not None:
            W = warm_W[torch.from_numpy(order).to(warm_W.device)]
        elif base_w0 is not None:
            W = base_w0[None, :].expand(L, -1).clone()
        validate = validation is not None and cfg.validate_per_iteration
        lane_history: list[list] = [[] for _ in range(L)]
        start_sweep = 0
        res_summary = None
        if checkpointer is not None and resume:
            st = checkpointer.load_stage(stage)
            if (st is not None and [float(x) for x in st["lams"]]
                    == [float(x) for x in lams]):
                start_sweep = int(st["sweep"])
                if st.get("W") is not None:
                    W = torch.as_tensor(np.asarray(st["W"])).to(
                        device=self.device, dtype=torch.float32)
                lane_history = [_revive_validation(h)
                                for h in st.get("lane_history") or []]
                lane_history += [[] for _ in range(L - len(lane_history))]
                res_summary = st.get("res_summary")
                logger.info("swept fit '%s': resumed at sweep %d/%d",
                            name, start_sweep, cfg.n_iterations)
        t0 = time.perf_counter()
        res = None
        with _ckpt.session(checkpointer):
            for i in range(start_sweep, cfg.n_iterations):
                scope = (checkpointer.scope(f"{stage}_s{i + 1}")
                         if checkpointer is not None
                         else contextlib.nullcontext())
                with scope:
                    W, res = coord.train_swept(offsets, reg, warm_start=W)
                if validate:
                    W_now = W[inv]
                    for j in range(L):
                        snap = self._swept_lane_model(
                            coords, name, W_now[j], locked, offsets,
                            float(lams[j]), with_variances=False)
                        lane_history[j].append(
                            self._evaluate(snap, validation))
                if checkpointer is not None and (
                        (i + 1) == cfg.n_iterations
                        or (i + 1) % checkpointer.every_sweeps == 0):
                    res_summary = {
                        "lanes_converged": int(res.converged.sum()),
                        "max_solver_iterations": int(res.iterations.max())}
                    checkpointer.save_stage(stage, {
                        "lams": [float(x) for x in lams],
                        "sweep": i + 1,
                        "W": W,   # λ-descending lane order
                        "lane_history": [_serialize_validation(h)
                                         for h in lane_history],
                        "res_summary": res_summary,
                    })
        elapsed = time.perf_counter() - t0
        logger.info("swept fit: %d λ-lanes of '%s' in %.2fs", L, name,
                    elapsed)
        if res is not None:
            res_summary = {
                "lanes_converged": int(res.converged.sum()),
                "max_solver_iterations": int(res.iterations.max())}
        if run_logger is not None:
            run_logger.event("swept_fit", coordinate=name, lanes=L,
                             duration_s=round(elapsed, 4),
                             **(res_summary or {}))
        W_out = W[inv]
        results = []
        for j in range(L):
            # The caller's λ, not its float32 round trip.
            lam = float(lams[j])
            model = self._swept_lane_model(coords, name, W_out[j], locked,
                                           offsets, lam)
            if lane_history[j]:
                # The last sweep's snapshot scores as the final model.
                evals = dict(lane_history[j][-1])
            else:
                evals = (self._evaluate(model, validation)
                         if validation is not None else {})
            results.append(FitResult(
                model=model, evaluations=evals,
                reg_weights={c.name: (lam if c.name == name
                                      else c.optimizer.reg_weight)
                             for c in cfg.coordinates},
                validation_history=lane_history[j]))
        return results, W_out

    def _swept_setup(self, train: GameDataset, prep: dict, name: str,
                     lam_build: float):
        """The swept fit's preamble: coordinates built once (at the
        largest λ, so the reg context carries the intercept mask), warm
        coefficients, the locked coordinates and the lane-shared
        offsets.  Returns (coords, locked, offsets, base_w0)."""
        cfg = self.config
        coords = self._build_coordinates(train, prep, {name: lam_build})
        warm = self._warm_coefficients(coords, prep)
        locked = {n: warm[n] for n in cfg.locked_coordinates if n in warm}
        missing = set(cfg.locked_coordinates) - set(locked)
        if missing:
            raise ValueError(f"locked coordinates {sorted(missing)} absent "
                             "from the warm-start model")
        offsets = self._locked_offsets(coords, locked, train.n)
        return coords, locked, offsets, warm.get(name)

    def _fit_grid_swept(self, train: GameDataset, prep: dict, name: str,
                        grid_points: list[dict], validation,
                        run_logger) -> list[FitResult]:
        """The whole ``reg_weight_grid`` as ONE swept solve; results in
        grid order, each with its per-sweep validation history."""
        lams = [gp[name] for gp in grid_points]
        coords, locked, offsets, base_w0 = self._swept_setup(
            train, prep, name, max(lams))
        logger.info("fit: swept λ grid over '%s' (%d lanes)", name,
                    len(lams))
        results, _ = self._train_swept_lanes(
            coords, name, lams, offsets, locked, validation, run_logger,
            base_w0=base_w0,
            checkpointer=self._checkpointer(self.config.checkpoint_dir,
                                            run_logger),
            resume=self.config.resume)
        return results

    def _checkpointer(self, ckpt_dir: str | None, run_logger):
        """A ``RunCheckpointer`` for ``ckpt_dir`` with the config's
        cadence, or None when checkpointing is off."""
        if not ckpt_dir:
            return None
        cfg = self.config
        return _ckpt.RunCheckpointer(
            ckpt_dir, every_sweeps=cfg.checkpoint_every_sweeps,
            every_solver_iters=cfg.checkpoint_every_solver_iters,
            run_logger=run_logger, resume=cfg.resume)

    def _evaluate(self, model: GameModel, validation: GameDataset) -> dict:
        margins = torch.from_numpy(GameTransformer(
            model=model, task=self.task,
            device=str(self.device)).transform(validation))
        labels = torch.from_numpy(validation.labels.astype(np.float32))
        weights = torch.from_numpy(validation.weight_array())
        out = {}
        for ev in self.config.evaluators:
            # RMSE and squared loss in mean space, the others on margins.
            scores = margins
            if ev.value in ("RMSE", "SQUARED_LOSS"):
                scores = self.task.loss.mean(margins)
            out[ev] = float(evaluate(ev, scores, labels, weights))
        return out

    def _fit_point(self, train: GameDataset, prep: dict, reg_weights: dict,
                   validation: GameDataset | None, run_logger,
                   ckpt_tag: str | None = None,
                   checkpointing: bool = True) -> FitResult:
        """One coordinate-descent fit at fixed λ a coordinate.
        ``ckpt_tag`` puts its checkpoints in a subdirectory (a grid point
        of a point-by-point grid); ``checkpointing=False`` runs without
        them (the non-swept tuned path, whose trials would overwrite
        each other)."""
        cfg = self.config
        coords = self._build_coordinates(train, prep, reg_weights)
        logger.info("fit: point %s", reg_weights or "(default)")
        warm = self._warm_coefficients(coords, prep)
        locked = {name: warm[name] for name in cfg.locked_coordinates
                  if name in warm}
        missing = set(cfg.locked_coordinates) - set(locked)
        if missing:
            raise ValueError(f"locked coordinates {sorted(missing)} absent "
                             "from the warm-start model")
        initial = {n: w for n, w in warm.items() if n not in locked}
        validator = None
        if validation is not None and cfg.validate_per_iteration:
            def validator(coefficients, _total_scores):
                return self._evaluate(
                    self._model_snapshot(coords, coefficients), validation)

        ckpt_dir = cfg.checkpoint_dir if checkpointing else None
        if ckpt_dir and ckpt_tag:
            ckpt_dir = f"{ckpt_dir}/{ckpt_tag}"
        cd = run_coordinate_descent(
            coordinates=coords, update_sequence=cfg.update_sequence,
            n_iterations=cfg.n_iterations, validator=validator,
            locked_coordinates=locked, initial_coefficients=initial,
            checkpoint_dir=ckpt_dir, resume=cfg.resume and checkpointing,
            run_logger=run_logger,
            checkpointer=self._checkpointer(ckpt_dir, run_logger),
            fused_engine=(self._fused_engine(train, coords)
                          if cfg.cd_fused else None))
        model = self._to_game_model(coords, cd)
        if cd.validation_history:
            # The last sweep's snapshot scores as the final model does.
            evals = dict(cd.validation_history[-1])
        else:
            evals = (self._evaluate(model, validation)
                     if validation is not None else {})
        return FitResult(
            model=model, evaluations=evals,
            reg_weights={c.name: reg_weights.get(c.name,
                                                 c.optimizer.reg_weight)
                         for c in cfg.coordinates},
            validation_history=cd.validation_history, descent=cd)

    def fit(self, train: GameDataset, validation: GameDataset | None = None,
            run_logger=None) -> list[FitResult]:
        """Train the λ grid; results in grid order.  An eligible
        fixed-effect grid (``_swept_coordinate_name``) trains as ONE
        swept solve; other grids fit point by point."""
        prep = self._prepare(train)
        grid_points = self._grid_points()
        name = self._swept_coordinate_name()
        # cd_fused trains grid points as separate fused fits: the swept
        # lanes solve coordinate by coordinate.
        if (len(grid_points) > 1 and name is not None
                and set(self.config.reg_weight_grid) == {name}
                and not self.config.cd_fused):
            return self._fit_grid_swept(train, prep, name, grid_points,
                                        validation, run_logger)
        return [self._fit_point(
                    train, prep, rw, validation, run_logger,
                    ckpt_tag=f"grid_{gi}" if len(grid_points) > 1 else None)
                for gi, rw in enumerate(grid_points)]

    def fit_tuned(self, train: GameDataset, validation: GameDataset,
                  run_logger=None) -> list[FitResult]:
        """Bayesian or random tuning of per-coordinate reg weights
        (``config.tuning``); one FitResult a trial, in trial order."""
        cfg = self.config
        if cfg.tuning is None:
            raise ValueError("fit_tuned requires config.tuning")
        if not cfg.evaluators:
            raise ValueError("tuning needs at least one evaluator")
        return self._fit_tuned_inner(train, validation, run_logger,
                                     cfg.evaluators[0], cfg.tuning)

    def _fit_tuned_inner(self, train, validation, run_logger, ev,
                         tuning) -> list[FitResult]:
        from photon_ml_torch.hyperparameter import (
            HyperparameterTuner,
            ParamRange,
            ParamScale,
            SearchSpace,
            TunerMode,
        )

        space = SearchSpace([
            ParamRange(name, r["low"], r["high"],
                       ParamScale(r.get("scale", "LOG")))
            for name, r in sorted(tuning.reg_weight_ranges.items())])
        prep = self._prepare(train)
        tuner = HyperparameterTuner(
            space, mode=TunerMode(tuning.mode),
            larger_is_better=ev.larger_is_better, seed=tuning.seed)
        swept_name = self._swept_coordinate_name()
        if (swept_name is not None
                and set(tuning.reg_weight_ranges) == {swept_name}):
            return self._fit_tuned_swept(train, prep, swept_name, tuner,
                                         validation, run_logger, ev)

        if self.config.checkpoint_dir:
            # Tuner checkpoints ride the swept evaluator; per-point tuned
            # fits run without them rather than overwrite each other.
            logger.warning(
                "checkpoint_dir is set but this tuning shape is not "
                "swept-eligible; running WITHOUT tuner checkpoints")

        def evaluate_fn(point: dict):
            result = self._fit_point(train, prep, dict(point), validation,
                                     run_logger, checkpointing=False)
            return result.evaluations[ev], result

        trials = tuner.run(evaluate_fn, tuning.n_trials,
                           run_logger=run_logger)
        return [t.payload for t in trials]

    def _fit_tuned_swept(self, train: GameDataset, prep: dict, name: str,
                         tuner, validation: GameDataset, run_logger,
                         ev) -> list[FitResult]:
        """Batched trials: each tuner round proposes a batch of λ points
        and the batch trains as one swept solve.  Each new lane starts
        from the previous round's solution at the nearest log-λ."""
        cfg = self.config
        tuning = cfg.tuning
        hi = float(tuning.reg_weight_ranges[name]["high"])
        coords, locked, offsets, base_w0 = self._swept_setup(
            train, prep, name, hi)
        prev: dict = {"lams": None, "W": None}
        ck = self._checkpointer(cfg.checkpoint_dir, run_logger)
        rounds: list = []
        restored: list = []
        if ck is not None and cfg.resume:
            # One stage file a round (``tuner_hist_<r>``): completed
            # rounds feed the search as observations, and their results
            # are rebuilt from the saved lane matrices, not retrained.
            while True:
                st = ck.load_stage(f"tuner_hist_{len(rounds)}")
                if st is None:
                    break
                rounds.append(st)
            for r in rounds:
                W_r = torch.as_tensor(np.asarray(r["W"])).to(
                    device=self.device, dtype=torch.float32)
                hists = r.get("histories") or []
                for j, lam in enumerate(r["lams"]):
                    lam = float(lam)
                    model = self._swept_lane_model(
                        coords, name, W_r[j], locked, offsets, lam)
                    evals = _revive_validation([r["evals"][j]])[0]
                    fr = FitResult(
                        model=model, evaluations=evals,
                        reg_weights={c.name: (lam if c.name == name
                                              else c.optimizer.reg_weight)
                                     for c in cfg.coordinates},
                        validation_history=_revive_validation(
                            hists[j] if j < len(hists) else []))
                    restored.append(({name: lam}, float(r["values"][j]),
                                     fr))
                prev["lams"] = [float(x) for x in r["lams"]]
                prev["W"] = W_r
            if rounds:
                logger.info("tuned fit: restored %d trials from %d "
                            "checkpointed rounds", len(restored),
                            len(rounds))

        def evaluate_batch(configs: list[dict]):
            lams = [float(c[name]) for c in configs]
            warm_W = None
            if prev["W"] is not None:
                log_prev = np.log(np.maximum(
                    np.asarray(prev["lams"], np.float64), 1e-30))
                idx = [int(np.argmin(np.abs(
                    np.log(max(lam, 1e-30)) - log_prev))) for lam in lams]
                warm_W = prev["W"][torch.as_tensor(idx)
                                   .to(prev["W"].device)]
            results, W_out = self._train_swept_lanes(
                coords, name, lams, offsets, locked, validation,
                run_logger, warm_W=warm_W, base_w0=base_w0,
                checkpointer=ck, resume=cfg.resume,
                stage=f"tuner_round_{len(rounds)}")
            prev["lams"], prev["W"] = lams, W_out
            if ck is not None:
                rd = {"lams": lams,
                      "values": [float(r.evaluations[ev]) for r in results],
                      "W": W_out,
                      "evals": _serialize_validation(
                          [r.evaluations for r in results]),
                      "histories": [_serialize_validation(
                          r.validation_history) for r in results]}
                rounds.append(rd)
                ck.save_stage(f"tuner_hist_{len(rounds) - 1}", rd)
            return [(r.evaluations[ev], r) for r in results]

        trials = tuner.run_batched(evaluate_batch, tuning.n_trials,
                                   batch_size=tuning.trial_batch,
                                   run_logger=run_logger,
                                   restored=restored)
        return [t.payload for t in trials]

    def best(self, results: list[FitResult]) -> FitResult:
        """Model selection by the first evaluator."""
        if not self.config.evaluators or not results[0].evaluations:
            return results[0]
        ev = self.config.evaluators[0]
        best = results[0]
        for r in results[1:]:
            if better_than(ev, r.evaluations[ev], best.evaluations[ev]):
                best = r
        return best
