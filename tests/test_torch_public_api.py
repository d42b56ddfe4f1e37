"""Public methods of ported classes against the JAX package's (ROADMAP C8).

An AST comparison of the public names of every module pair found these
missing from classes the port has; each is here with the reference's
semantics, and one parametrised case a name holds it against the JAX
package on the same numpy-made inputs (values at 1e-6, shapes and
integers exactly).  ``ChunkedBatch.owned_chunk_ids`` and
``chunk_schedule`` (A7a) are held in ``tests/test_torch_fleet.py``.

The package re-exports (ROADMAP C10): every name a reference package
``__init__.py`` imports from its modules or defines, read by AST (so
``photon_ml_tpu`` is not imported), must be an attribute of the port's
package of the same path, one case a package; a mutation check removes
one re-export and the comparison must name it.  The only exclusion:
``analysis.tracer_leak_guard`` (eager PyTorch has no tracers to leak).
"""

from __future__ import annotations

import ast
import importlib
import os
import types

import numpy as np
import pytest
import torch

from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

RNG = np.random.default_rng(23)
D, N, K = 12, 9, 3
W = RNG.normal(0, 1, D).astype(np.float32)
FACTORS = RNG.uniform(0.5, 2.0, D).astype(np.float32)
COLS = np.stack([np.sort(RNG.choice(D, K, replace=False))
                 for _ in range(N)]).astype(np.int32)
VALS = RNG.normal(0, 1, (N, K)).astype(np.float32)
X = RNG.normal(0, 1, (N, D)).astype(np.float32)
Y = (RNG.random(N) < 0.5).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rows():
    return [(COLS[i], VALS[i]) for i in range(N)]


def _case_raw_to_model(pkg):
    from importlib import import_module

    norm = import_module(f"{pkg}.data.normalization")
    f = _t(FACTORS) if pkg == "photon_ml_torch" else FACTORS
    w = _t(W) if pkg == "photon_ml_torch" else W
    ctx = norm.NormalizationContext(factors=f)
    return [ctx.raw_to_model(w), ctx.raw_to_model(ctx.model_to_raw(w)),
            norm.NormalizationContext.identity().raw_to_model(w)]


def _case_compute_mean(pkg):
    from importlib import import_module

    coef = import_module(f"{pkg}.models.coefficients")
    glm = import_module(f"{pkg}.models.glm")
    batch_mod = import_module(f"{pkg}.data.batch")
    kw = {"device": "cpu"} if pkg == "photon_ml_torch" else {}
    batch = batch_mod.make_sparse_batch(_rows(), D, Y, **kw)
    w = _t(W) if pkg == "photon_ml_torch" else W
    out = []
    for task in (glm.TaskType.LOGISTIC_REGRESSION,
                 glm.TaskType.POISSON_REGRESSION,
                 glm.TaskType.LINEAR_REGRESSION):
        out.append(glm.GeneralizedLinearModel(
            coefficients=coef.Coefficients(means=w),
            task=task).compute_mean(batch))
    return out


def _case_l1_value(pkg):
    from importlib import import_module

    reg = import_module(f"{pkg}.ops.regularization")
    w = _t(W) if pkg == "photon_ml_torch" else W
    mask = np.ones(D, np.float32)
    mask[-1] = 0.0
    m = _t(mask) if pkg == "photon_ml_torch" else mask
    if pkg == "photon_ml_torch":
        ctxs = [reg.RegularizationContext.of(reg.RegularizationType.L1, 0.7),
                reg.RegularizationContext.of(
                    reg.RegularizationType.ELASTIC_NET, 0.7, 0.3,
                    reg_mask=m),
                reg.RegularizationContext.l2(0.7)]
    else:
        ctxs = [reg.RegularizationContext.l1(0.7),
                reg.RegularizationContext.elastic_net(0.7, 0.3, reg_mask=m),
                reg.RegularizationContext.l2(0.7)]
    return [c.l1_value(w) for c in ctxs]


def _case_coefficients(pkg):
    from importlib import import_module

    coef = import_module(f"{pkg}.models.coefficients")
    w = _t(W) if pkg == "photon_ml_torch" else W
    z = coef.Coefficients.zeros(D)
    c = coef.Coefficients(means=w)
    return [z.means, z.dim, c.dim, c.norm(), z.norm()]


def _case_fixed_effect_model_dim(pkg):
    from importlib import import_module

    coef = import_module(f"{pkg}.models.coefficients")
    game = import_module(f"{pkg}.models.game")
    w = _t(W) if pkg == "photon_ml_torch" else W
    return [game.FixedEffectModel(coefficients=coef.Coefficients(
        means=w)).dim]


def _case_game_model_names(pkg):
    from importlib import import_module

    coef = import_module(f"{pkg}.models.coefficients")
    game = import_module(f"{pkg}.models.game")
    w = _t(W) if pkg == "photon_ml_torch" else W
    fe = game.FixedEffectModel(coefficients=coef.Coefficients(means=w))
    model = game.GameModel(models={"global": fe, "per_user": fe})
    return [model.coordinate_names, "global" in model,
            "per_item" in model]


def _case_feature_statistics_dim(pkg):
    from importlib import import_module

    stats = import_module(f"{pkg}.data.statistics")
    batch_mod = import_module(f"{pkg}.data.batch")
    kw = {"device": "cpu"} if pkg == "photon_ml_torch" else {}
    return [stats.compute_statistics(batch_mod.make_dense_batch(
        X, Y, **kw)).dim, stats.compute_statistics(
        batch_mod.make_sparse_batch(_rows(), D, Y, **kw)).dim]


def _case_subspace_projection(pkg):
    from importlib import import_module

    proj = import_module(f"{pkg}.game.projector")
    fids = [np.array([[0, 3, -1], [5, -1, -1]], np.int32),
            np.array([[1, 2, 4, 7]], np.int32)]
    p = proj.SubspaceProjection(feature_ids=fids, global_dim=D)
    rng = np.random.default_rng(3)
    w0 = rng.normal(0, 1, (2, 3)).astype(np.float32)
    w1 = rng.normal(0, 1, (1, 4)).astype(np.float32)
    out = [p.local_dim(0), p.local_dim(1)]
    for b, w in ((0, w0), (1, w1)):
        for cols, vals in p.project_back(b, w):
            out += [cols, vals]
    return out


def _case_fixed_effect_as_model(pkg):
    from importlib import import_module

    coords = import_module(f"{pkg}.game.coordinates")
    w = _t(W) if pkg == "photon_ml_torch" else W
    m = coords.FixedEffectCoordinate.as_model(
        types.SimpleNamespace(name="global"), w)
    return [m.coefficients.means, m.feature_shard, m.dim]


def _case_n_padded(pkg):
    from importlib import import_module

    batch_mod = import_module(f"{pkg}.data.batch")
    kw = {"device": "cpu"} if pkg == "photon_ml_torch" else {}
    return [batch_mod.make_dense_batch(X, Y, **kw).n_padded,
            batch_mod.make_sparse_batch(_rows(), D, Y, pad_to=16,
                                        **kw).n_padded]


def _grr_pair(pkg):
    from importlib import import_module

    grr = import_module(f"{pkg}.data.grr")
    rng = np.random.default_rng(5)
    n, d, k = 700, 400, 5
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    kw = {"device": "cpu"} if pkg == "photon_ml_torch" else {}
    return grr, grr.build_grr_pair(cols, vals, d, cap=4, **kw), (cols,
                                                                 vals, d)


def _case_grr_pair_shape(pkg):
    _, pair, _ = _grr_pair(pkg)
    return [pair.n_rows, pair.dim]


def _case_grr_range_split_n_spill(pkg):
    grr, pair, _ = _grr_pair(pkg)
    d = pair.col_dir
    split = grr.GrrRangeSplit(parts=(d, d), bounds=(0, 0, d.table_len),
                              table_len=d.table_len,
                              n_segments=d.n_segments)
    return [split.n_spill, 2 * d.n_spill]


def _case_pair_cache_path_for(pkg):
    grr, _, (cols, vals, d) = _grr_pair(pkg)
    return [grr.pair_cache_path_for(cols, vals, d, "/cache"),
            grr.pair_cache_path_for(cols, vals, d, "/cache", cap=8)]


def _case_version(pkg):
    from importlib import import_module

    return [import_module(pkg).__version__]


CASES = {
    "NormalizationContext.raw_to_model": _case_raw_to_model,
    "GeneralizedLinearModel.compute_mean": _case_compute_mean,
    "RegularizationContext.l1_value": _case_l1_value,
    "Coefficients.zeros/dim/norm": _case_coefficients,
    "FixedEffectModel.dim": _case_fixed_effect_model_dim,
    "GameModel.__contains__/coordinate_names": _case_game_model_names,
    "FeatureStatistics.dim": _case_feature_statistics_dim,
    "SubspaceProjection.local_dim/project_back": _case_subspace_projection,
    "FixedEffectCoordinate.as_model": _case_fixed_effect_as_model,
    "DenseBatch/SparseBatch.n_padded": _case_n_padded,
    "GrrPair.n_rows/dim": _case_grr_pair_shape,
    "GrrRangeSplit.n_spill": _case_grr_range_split_n_spill,
    "pair_cache_path_for": _case_pair_cache_path_for,
    "__version__": _case_version,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_added_public_name_matches_reference(name):
    port = CASES[name]("photon_ml_torch")
    ref = CASES[name]("photon_ml_tpu")
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        if isinstance(p, (str, bool, int, list)) and not isinstance(
                p, np.ndarray):
            assert p == (r if not isinstance(r, np.integer) else int(r))
            continue
        p, r = _np(p), _np(r)
        assert p.shape == r.shape
        np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-6)


# -- package re-exports (C10) ------------------------------------------------

_REF_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "photon_ml_tpu")
# (package, name or None for the whole package): the reason each stays out.
_EXCLUDED = {
    ("analysis", "tracer_leak_guard"):
        "eager PyTorch has no tracers to leak",
}


def _ref_packages() -> list[str]:
    """Every reference package, by dotted path below ``photon_ml_tpu``
    ("" for the top package)."""
    out = []
    for dirpath, _dirs, files in os.walk(_REF_ROOT):
        if "__init__.py" in files:
            rel = os.path.relpath(dirpath, _REF_ROOT)
            out.append("" if rel == "." else rel.replace(os.sep, "."))
    return sorted(out)


def _exported(pkg: str) -> set[str]:
    """The public names the reference package's ``__init__.py`` imports
    from its modules (``from ... import``) or defines at top level."""
    path = os.path.join(_REF_ROOT, *([pkg] if pkg else []), "__init__.py")
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            out.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                           ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def _missing(pkg: str) -> list[str]:
    mod = importlib.import_module(
        "photon_ml_torch" + (f".{pkg}" if pkg else ""))
    return sorted(n for n in _exported(pkg)
                  if not hasattr(mod, n) and (pkg, n) not in _EXCLUDED)


@pytest.mark.parametrize("pkg", [p for p in _ref_packages()
                                 if (p, None) not in _EXCLUDED],
                         ids=lambda p: p or "photon_ml_tpu")
def test_package_reexports_match_reference(pkg):
    assert _missing(pkg) == []


def test_package_reexport_check_catches_a_removed_name(monkeypatch):
    """Mutation check: with one re-export removed from the port's
    package the comparison names it (and only it)."""
    import photon_ml_torch.optim as topt

    assert "lbfgs_solve" in _exported("optim")
    monkeypatch.delattr(topt, "lbfgs_solve")
    assert _missing("optim") == ["lbfgs_solve"]
    assert _missing("analysis") == []       # the named exclusion holds
    assert "tracer_leak_guard" in _exported("analysis")
