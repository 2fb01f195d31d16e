"""Shared param mixins — the port's copy of ``cycloneml_tpu/ml/shared.py``
(ref: ml/param/shared/sharedParams.scala). Each mixin declares its param in
a ``_p_*`` method that subclasses call in ``__init__``.
"""

from __future__ import annotations

from cycloneml_tpu_torch.ml.param import Params, ParamValidators as V


class HasFeaturesCol(Params):
    def _p_features_col(self):
        self.featuresCol = self._param("featuresCol", "features column name",
                                       default="features")


class HasLabelCol(Params):
    def _p_label_col(self):
        self.labelCol = self._param("labelCol", "label column name", default="label")


class HasWeightCol(Params):
    def _p_weight_col(self):
        self.weightCol = self._param("weightCol", "instance weight column", default="")


class HasPredictionCol(Params):
    def _p_prediction_col(self):
        self.predictionCol = self._param("predictionCol", "prediction column name",
                                         default="prediction")


class HasProbabilityCol(Params):
    def _p_probability_col(self):
        self.probabilityCol = self._param("probabilityCol",
                                          "class probabilities column",
                                          default="probability")


class HasRawPredictionCol(Params):
    def _p_raw_prediction_col(self):
        self.rawPredictionCol = self._param("rawPredictionCol",
                                            "raw prediction (margin) column",
                                            default="rawPrediction")


class HasMaxIter(Params):
    def _p_max_iter(self, default=100):
        self.maxIter = self._param("maxIter", "maximum iterations (>= 0)",
                                   V.gt_eq(0), default=default)


class HasRegParam(Params):
    def _p_reg_param(self, default=0.0):
        self.regParam = self._param("regParam", "regularization parameter (>= 0)",
                                    V.gt_eq(0.0), default=default)


class HasElasticNetParam(Params):
    def _p_elastic_net(self, default=0.0):
        self.elasticNetParam = self._param(
            "elasticNetParam", "ElasticNet mixing in [0,1]: 0=L2, 1=L1",
            V.in_range(0.0, 1.0), default=default)


class HasTol(Params):
    def _p_tol(self, default=1e-6):
        self.tol = self._param("tol", "convergence tolerance (>= 0)",
                               V.gt_eq(0.0), default=default)


class HasFitIntercept(Params):
    def _p_fit_intercept(self, default=True):
        self.fitIntercept = self._param("fitIntercept", "whether to fit intercept",
                                        default=default)


class HasStandardization(Params):
    def _p_standardization(self, default=True):
        self.standardization = self._param(
            "standardization", "standardize features before fitting",
            default=default)


class HasThreshold(Params):
    def _p_threshold(self, default=0.5):
        self.threshold = self._param("threshold", "binary prediction threshold",
                                     V.in_range(0.0, 1.0), default=default)



class HasSeed(Params):
    def _p_seed(self, default=17):
        self.seed = self._param("seed", "random seed", default=default)


class HasSolver(Params):
    def _p_solver(self, allowed, default):
        self.solver = self._param("solver", f"solver, one of {allowed}",
                                  V.in_array(allowed), default=default)


class HasAggregationDepth(Params):
    def _p_aggregation_depth(self, default=2):
        self.aggregationDepth = self._param(
            "aggregationDepth", "treeAggregate depth (>= 1); on the mesh this "
            "selects hierarchical ICI/DCN reduction and is honoured for API "
            "parity", V.gt_eq(1), default=default)



class HasMaxBlockSizeInMB(Params):
    def _p_max_block_size(self, default=0.0):
        self.maxBlockSizeInMB = self._param(
            "maxBlockSizeInMB", "max block memory in MB (0 = auto); on the "
            "mesh the shard layout supersedes this, kept for API parity",
            V.gt_eq(0.0), default=default)
