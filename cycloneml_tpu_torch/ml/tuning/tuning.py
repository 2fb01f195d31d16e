"""Model selection: ParamGridBuilder, CrossValidator, TrainValidationSplit.

The port's counterpart of ``cycloneml_tpu/ml/tuning/tuning.py`` (ref
ml/tuning: ParamGridBuilder, CrossValidator.scala:80, TrainValidationSplit).
``parallelism > 1`` trains the whole grid of one fold as ONE stacked fit
when the param maps differ only in ``regParam`` and the estimator supports
``fit_stacked`` (binary labels): every evaluation covers all grid points in
one aggregation, kernel K1s on the card. Anything else runs the grid points
one after another.

The reference runs each grid point's work as a straggler lane
(``elastic.speculation``, ``observe.skew``); those lanes are ROADMAP slices
8 and 10, and the port calls the work directly, which is what the
reference does when speculation is not armed. Persistence is ROADMAP
slice 9.
"""

from __future__ import annotations

from itertools import product
from typing import List, Optional

import numpy as np

from cycloneml_tpu_torch.mesh import safe_fit_parallelism
from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.param import Param, ParamMap, \
    ParamValidators as V
from cycloneml_tpu_torch.ml.shared import HasSeed


class ParamGridBuilder:
    """(ref ParamGridBuilder in tuning/ParamGridBuilder.scala)."""

    def __init__(self):
        self._grid = {}

    def add_grid(self, param: Param, values) -> "ParamGridBuilder":
        self._grid[param] = list(values)
        return self

    def base_on(self, param_map: ParamMap) -> "ParamGridBuilder":
        for p, v in param_map.items():
            self._grid[p] = [v]
        return self

    def build(self) -> List[ParamMap]:
        if not self._grid:
            return [ParamMap()]
        keys = list(self._grid)
        out = []
        for combo in product(*(self._grid[k] for k in keys)):
            pm = ParamMap()
            for k, v in zip(keys, combo):
                pm.put(k, v)
            out.append(pm)
        return out


class _ValidatorParams(HasSeed):
    def _p_validator(self):
        self._p_seed(42)
        self.parallelism = self._param("parallelism",
                                       "concurrent fits (>= 1)", V.gt_eq(1),
                                       default=1)

    def set_estimator(self, est: Estimator):
        self._estimator = est
        return self

    def set_estimator_param_maps(self, maps: List[ParamMap]):
        self._param_maps = list(maps)
        return self

    def set_evaluator(self, ev):
        self._evaluator = ev
        return self

    def _fit_score_one(self, pm: ParamMap, train, valid) -> float:
        """One grid point's fit and score."""
        model = self._estimator.fit(train, pm)
        return float(self._evaluator.evaluate(model.transform(valid)))

    def _best_index(self, metrics: np.ndarray) -> int:
        return int(np.argmax(metrics) if self._evaluator.is_larger_better
                   else np.argmin(metrics))

    # -- stacked (model-axis) grid evaluation --------------------------------
    def _stack_plan(self, frame):
        """``(base_estimator, reg_vector)`` when the whole grid can train
        as ONE stacked fit per fold: every param map sets the same params,
        only ``regParam`` varies, the estimator supports stacked fits in
        its configured state, and the labels are binary. None otherwise:
        the grid then runs serially."""
        maps = getattr(self, "_param_maps", None)
        est = getattr(self, "_estimator", None)
        if (not maps or len(maps) < 2 or est is None
                or not hasattr(est, "fit_stacked")):
            return None
        keys = set(maps[0])
        if any(set(pm) != keys for pm in maps[1:]):
            return None
        reg_param = next((p for p in keys if p.name == "regParam"), None)
        if reg_param is None:
            return None

        def differs(a, b):
            # array-valued params compare elementwise; any doubt means
            # "not provably constant", so the grid runs serially
            try:
                return bool(np.any(np.asarray(a != b)))
            except Exception:
                return True

        for p in keys:
            if p is reg_param:
                continue
            v0 = maps[0].get(p)
            if any(differs(pm.get(p), v0) for pm in maps[1:]):
                return None
        base = est.copy(maps[0])
        if not (hasattr(base, "can_fit_stacked") and base.can_fit_stacked()):
            return None
        try:
            y = np.asarray(frame[base.get("labelCol")])
        except Exception:
            return None
        if not np.isin(y, (0.0, 1.0)).all():
            return None  # stacked fits are binomial
        return base, np.array([float(pm.get(reg_param)) for pm in maps])

    def _fit_score_stacked(self, base, reg_vec, train, valid) -> np.ndarray:
        models = base.fit_stacked(train, reg_params=reg_vec)
        return np.array([float(self._evaluator.evaluate(m.transform(valid)))
                         for m in models])


class CrossValidator(Estimator, _ValidatorParams):
    """(ref CrossValidator.scala:80)."""

    def __init__(self, uid=None, estimator=None, estimator_param_maps=None,
                 evaluator=None, **kw):
        super().__init__(uid)
        self._p_validator()
        self.numFolds = self._param("numFolds", "folds (>= 2)", V.gt_eq(2),
                                    default=3)
        self.foldCol = self._param("foldCol", "user-supplied fold column",
                                   default="")
        if estimator is not None:
            self.set_estimator(estimator)
        if estimator_param_maps is not None:
            self.set_estimator_param_maps(estimator_param_maps)
        if evaluator is not None:
            self.set_evaluator(evaluator)
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "CrossValidatorModel":
        n_folds = self.get("numFolds")
        fold_col = self.get("foldCol")
        if fold_col:
            folds = np.asarray(frame[fold_col]).astype(int)
        else:
            rng = np.random.RandomState(self.get("seed"))
            folds = rng.randint(0, n_folds, frame.n_rows)
        maps = self._param_maps
        metrics = np.zeros(len(maps))
        requested = self.get("parallelism")
        plan = self._stack_plan(frame) if requested > 1 else None
        if plan is not None:
            base, reg_vec = plan
            safe_fit_parallelism(requested, stacked_width=len(maps))
        else:
            safe_fit_parallelism(requested)
        for f in range(n_folds):
            train = frame.filter_rows(folds != f)
            valid = frame.filter_rows(folds == f)
            if plan is not None:
                metrics += self._fit_score_stacked(base, reg_vec, train,
                                                   valid)
            else:
                for mi, pm in enumerate(maps):
                    metrics[mi] += self._fit_score_one(pm, train, valid)
        metrics /= n_folds
        best = self._estimator.fit(frame, maps[self._best_index(metrics)])
        model = CrossValidatorModel(best, metrics.tolist(), uid=self.uid)
        self._copy_values(model)
        return model._set_parent(self)


class CrossValidatorModel(Model, _ValidatorParams):
    def __init__(self, best_model: Optional[Model] = None,
                 avg_metrics: Optional[List[float]] = None, uid=None):
        super().__init__(uid)
        self._p_validator()
        self.numFolds = self._param("numFolds", "folds", default=3)
        self.foldCol = self._param("foldCol", "fold column", default="")
        self.best_model = best_model
        self.avg_metrics = list(avg_metrics or [])

    def _transform(self, frame):
        return self.best_model.transform(frame)


class TrainValidationSplit(Estimator, _ValidatorParams):
    """(ref TrainValidationSplit.scala)."""

    def __init__(self, uid=None, estimator=None, estimator_param_maps=None,
                 evaluator=None, **kw):
        super().__init__(uid)
        self._p_validator()
        self.trainRatio = self._param("trainRatio", "train fraction",
                                      V.in_range(0, 1, False, False),
                                      default=0.75)
        if estimator is not None:
            self.set_estimator(estimator)
        if estimator_param_maps is not None:
            self.set_estimator_param_maps(estimator_param_maps)
        if evaluator is not None:
            self.set_evaluator(evaluator)
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "TrainValidationSplitModel":
        rng = np.random.RandomState(self.get("seed"))
        mask = rng.rand(frame.n_rows) < self.get("trainRatio")
        train, valid = frame.filter_rows(mask), frame.filter_rows(~mask)
        maps = self._param_maps
        requested = self.get("parallelism")
        plan = self._stack_plan(frame) if requested > 1 else None
        if plan is not None:
            base, reg_vec = plan
            safe_fit_parallelism(requested, stacked_width=len(maps))
            metrics = self._fit_score_stacked(base, reg_vec, train, valid)
        else:
            safe_fit_parallelism(requested)
            metrics = np.asarray([self._fit_score_one(pm, train, valid)
                                  for pm in maps])
        best = self._estimator.fit(frame, maps[self._best_index(metrics)])
        model = TrainValidationSplitModel(best, metrics.tolist(),
                                          uid=self.uid)
        self._copy_values(model)
        return model._set_parent(self)


class TrainValidationSplitModel(CrossValidatorModel):
    def __init__(self, best_model=None, validation_metrics=None, uid=None):
        super().__init__(best_model, validation_metrics, uid=uid)
        self.trainRatio = self._param("trainRatio", "train fraction",
                                      default=0.75)

    @property
    def validation_metrics(self):
        return self.avg_metrics
