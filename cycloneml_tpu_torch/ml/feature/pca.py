"""PCA — the port's counterpart of ``cycloneml_tpu/ml/feature/pca.py`` (ref
ml/feature/PCA.scala): it delegates to ``RowMatrix.
compute_principal_components_and_variance``, whose Gramian is kernel K4 on
the card."""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.linalg.distributed import RowMatrix
from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.feature.scalers import _InOutCol
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays


class PCA(Estimator, _InOutCol, MLWritable, MLReadable):
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


class PCAModel(Model, _InOutCol, MLWritable, MLReadable):
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

    def _save_data(self, path):
        save_arrays(path, pc=self.pc, ev=self.explained_variance)

    def _load_data(self, path, meta):
        a = load_arrays(path)
        self.pc, self.explained_variance = a["pc"], a["ev"]
