"""PCA — the port's counterpart of ``cycloneml_tpu/ml/feature/pca.py`` (ref
ml/feature/PCA.scala): it delegates to ``RowMatrix.
compute_principal_components_and_variance``, whose Gramian is kernel K4 on
the card."""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.linalg.distributed import RowMatrix
from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.param import Params
from cycloneml_tpu_torch.ml.param import ParamValidators as V


class _InOutCol(Params):
    """Input and output column params (the port's copy of the mixin in
    ``cycloneml_tpu/ml/feature/scalers.py``)."""

    def _p_in_out(self, in_default="features", out_default="scaled"):
        self.inputCol = self._param("inputCol", "input column",
                                    default=in_default)
        self.outputCol = self._param("outputCol", "output column",
                                     default=out_default)

    def set_input_col(self, v):
        return self.set("inputCol", v)

    def set_output_col(self, v):
        return self.set("outputCol", v)

    def _in(self, frame) -> np.ndarray:
        x = frame[self.get("inputCol")]
        return x[:, None] if x.ndim == 1 else x


class PCA(Estimator, _InOutCol):
    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(out_default="pca")
        self.k = self._param("k", "number of components (> 0)", V.gt(0))
        for key, v in kw.items():
            self.set(key, v)

    def set_k(self, v):
        return self.set("k", v)

    def _fit(self, frame) -> "PCAModel":
        ds = frame.to_instance_dataset(self.get("inputCol"), label_col=None)
        pcs, var = RowMatrix(ds).compute_principal_components_and_variance(
            self.get("k"))
        m = PCAModel(pcs.to_array(), var.to_array(), uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class PCAModel(Model, _InOutCol):
    def __init__(self, pc: Optional[np.ndarray] = None,
                 explained_variance: Optional[np.ndarray] = None, uid=None):
        super().__init__(uid)
        self._p_in_out(out_default="pca")
        self.k = self._param("k", "number of components", default=1)
        self.pc = np.asarray(pc) if pc is not None else None
        self.explained_variance = (np.asarray(explained_variance)
                                   if explained_variance is not None
                                   else None)

    def _transform(self, frame):
        return frame.with_column(self.get("outputCol"),
                                 self._in(frame) @ self.pc)
