"""Alternating least squares matrix factorization.

The port's counterpart of ``cycloneml_tpu/ml/recommendation/als.py``:
explicit ALS-WR (A_u = sum v v^T + reg n_u I, b_u = sum r v) and implicit
feedback (A_u = Y^T Y + sum alpha |r| v v^T + reg n_u I, b_u = sum (1 +
alpha |r|) [r > 0] v), users then items each iteration, every entity of a
half-step solved at once; ``nonnegative=True`` replaces the solve by the
reference's batched projected Newton steps. The ids are compacted on the
host by ``np.unique`` and the initial factors drawn from
``np.random.RandomState(seed)``, users first, exactly as the reference
draws them.

Each half-step builds every destination entity's normal equations in one
fixed order (``ops/kernels.als_normal``: the ratings sorted stably by
destination once a fit, then ``csrc/als_normal.cu`` on the card, with the
solve's reg max(n, 1) I and Y^T Y added in the kernel), so two fits of the
same ratings give bitwise-equal factors. ``cyclone.ml.usePallasKernels=
false`` or factors on the CPU take the plain twin (``als_normal_plain``,
chunked ``index_add_`` under ``aggregationChunkBytes``). Y^T Y is
``torch.mm`` at the compute dtype with TF32 off (the reference's
``Precision.HIGHEST``), and the solves are ``torch.linalg.solve_ex`` on
the card (the reference's ``jnp.linalg.solve``; no error check, so the
loop never reads the card back: the factors come back once, at the end,
and at each checkpoint).

``shardFactors`` keeps the reference's values. The reference's factor-
sharded trainer (``_train_blocked``) places entity e at row (e % D) n_loc
+ e // D of D data shards and sums each destination's ratings in input
order; on the port's one device (D = 1) that layout is the identity and
its arithmetic is this loop's, so "never", "auto" and "always" all run it
and give the same bits. The blocked layout across devices is ROADMAP
Queue 1 item 9.

With ``checkpointDir`` set, both factor matrices are saved (in entity
order, at the compute dtype, ``util/checkpoint.TrainingCheckpointer``)
every ``checkpointInterval`` iterations but after the last, bound to the
ratings and the parameters by the reference's fingerprint; a fit over a
directory that holds a checkpoint resumes from its newest step (the
reference's ``_checkpoint_setup``, :129-165), so that either package
resumes the other's directory. ``ALS`` and
``ALSModel`` persist in the reference's layout (``ml/util_io.py``; the
model's four arrays under their reference names).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.dataset.instance import compute_dtype
from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
from cycloneml_tpu_torch.ml.shared import (HasMaxIter, HasPredictionCol,
                                           HasRegParam, HasSeed)
from cycloneml_tpu_torch.ops import kernels
from cycloneml_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

PNEWTON_STEPS = 40    # projected Newton steps of the nonnegative solve
PNEWTON_DAMPING = 0.7


class _ALSParams(HasMaxIter, HasRegParam, HasPredictionCol, HasSeed):
    def _declare_als_params(self):
        self._p_max_iter(10)
        self._p_reg_param(0.1)
        self._p_prediction_col()
        self._p_seed(0)
        self.rankParam = self._param("rank", "factor dimension (> 0)", V.gt(0),
                                     default=10)
        self.userCol = self._param("userCol", "user id column", default="user")
        self.itemCol = self._param("itemCol", "item id column", default="item")
        self.ratingCol = self._param("ratingCol", "rating column",
                                     default="rating")
        self.implicitPrefs = self._param("implicitPrefs",
                                         "implicit preference mode",
                                         default=False)
        self.alpha = self._param("alpha", "implicit confidence scale (>= 0)",
                                 V.gt_eq(0.0), default=1.0)
        self.nonnegative = self._param("nonnegative",
                                       "constrain factors >= 0", default=False)
        self.coldStartStrategy = self._param(
            "coldStartStrategy", "nan or drop for unseen ids",
            V.in_array(["nan", "drop"]), default="nan")
        self.checkpointDir = self._param(
            "checkpointDir", "directory for mid-training factor checkpoints",
            default="")
        self.checkpointInterval = self._param(
            "checkpointInterval", "iterations between checkpoints",
            V.gt(0), default=10)
        # the plain twin's budget for its (chunk, rank, rank) outer
        # products; the kernel keeps each destination's sum on chip
        self.aggregationChunkBytes = self._param(
            "aggregationChunkBytes",
            "byte budget for the per-chunk outer-product intermediate",
            V.gt(0), default=256 << 20)
        self.shardFactors = self._param(
            "shardFactors", "auto | never | always",
            V.in_array(["auto", "never", "always"]), default="auto")
        self.factorShardingThresholdBytes = self._param(
            "factorShardingThresholdBytes",
            "replicated-accumulator size above which auto mode shards",
            V.gt(0), default=1 << 30)


def compact_ids(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The sorted distinct ids and each entry's index among them (the
    reference's host ``np.unique``)."""
    return np.unique(raw, return_inverse=True)


def build_orders(users: np.ndarray, items: np.ndarray, ratings: np.ndarray,
                 n_users: int, n_items: int, dtype: torch.dtype,
                 device) -> Tuple[kernels.AlsOrder, kernels.AlsOrder]:
    """The two half-steps' orders on ``device`` (users <- items, items <-
    users): the compact ids as int32 and the ratings at ``dtype``, one
    copy each to the device, then :func:`kernels.als_order`."""
    u = torch.from_numpy(np.ascontiguousarray(users, np.int32)).to(device)
    i = torch.from_numpy(np.ascontiguousarray(items, np.int32)).to(device)
    r = torch.from_numpy(np.ascontiguousarray(ratings, np.float64)) \
        .to(dtype).to(device)
    return (kernels.als_order(u, i, r, n_users, n_items),
            kernels.als_order(i, u, r, n_items, n_users))


def normal_equations(src: torch.Tensor, order: kernels.AlsOrder,
                     implicit: bool, alpha: float, reg: float,
                     yty: Optional[torch.Tensor], budget: int, plain: bool):
    """One half-step's ``(A, b, n)`` with the solve's terms in A: the
    plain twin when ``plain`` (``usePallasKernels=false``), else
    :func:`kernels.als_normal` (the kernel on the card, the plain twin on
    the CPU)."""
    fn = kernels.als_normal_plain if plain else kernels.als_normal
    return fn(src, order, implicit, alpha, reg, yty, chunk_bytes=budget)


@contextlib.contextmanager
def _tf32_off():
    """Float32 products at full precision inside (Y^T Y, the solves'
    products): TF32 keeps about three digits."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def gram(f: torch.Tensor) -> torch.Tensor:
    """Y^T Y of the source factors at their dtype."""
    return torch.mm(f.T, f)


def solve(a: torch.Tensor, b: torch.Tensor, nonneg: bool) -> torch.Tensor:
    """Every entity's factor row from its normal equations: one batched
    LU solve, or :func:`batched_pnewton` when ``nonneg``."""
    if nonneg:
        return batched_pnewton(a, b)
    return torch.linalg.solve_ex(a, b.unsqueeze(-1)).result.squeeze(-1)


def batched_pnewton(a: torch.Tensor, b: torch.Tensor,
                    iters: int = PNEWTON_STEPS) -> torch.Tensor:
    """Batched projected-Newton NNLS, the reference's ``_batched_pnewton``:
    x0 = max(A^-1 b, 0), then ``iters`` steps x <- max(x - 0.7 A^-1 (A x -
    b), 0). A is factored once (LU) and the 41 solves reuse the factors."""
    lu, piv, _ = torch.linalg.lu_factor_ex(a)

    def lu_solve(rhs):
        return torch.linalg.lu_solve(lu, piv, rhs.unsqueeze(-1)).squeeze(-1)

    x = lu_solve(b).clamp(min=0.0)
    for _ in range(iters):
        grad = torch.bmm(a, x.unsqueeze(-1)).squeeze(-1) - b
        x = (x - PNEWTON_DAMPING * lu_solve(grad)).clamp(min=0.0)
    return x


class ALS(Estimator, _ALSParams, MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_als_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def set_rank(self, v):
        return self.set("rank", v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_reg_param(self, v):
        return self.set("regParam", v)

    def set_implicit_prefs(self, v):
        return self.set("implicitPrefs", v)

    def _fit(self, frame: MLFrame) -> "ALSModel":
        users_raw = np.asarray(frame[self.get("userCol")]).astype(np.int64)
        items_raw = np.asarray(frame[self.get("itemCol")]).astype(np.int64)
        ratings = np.asarray(frame[self.get("ratingCol")]).astype(np.float64)

        user_ids, users = compact_ids(users_raw)
        item_ids, items = compact_ids(items_raw)
        u_fac, i_fac = self._train(users, items, ratings, len(user_ids),
                                   len(item_ids), self.get("rank"),
                                   frame.ctx)
        model = ALSModel(user_ids, item_ids, u_fac, i_fac, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        return model

    def _checkpoint_setup(self, rank, n_users, n_items, ratings):
        """``(checkpointer, fingerprint, start_iteration, u, i)``: the
        factors of the newest checkpoint in entity order, or None for both
        when the fit starts afresh at iteration 0 (without
        ``checkpointDir`` the checkpointer and fingerprint are None too).
        A directory of another fit (its fingerprint differs) or one past
        ``maxIter`` raises ``ValueError``."""
        if not self.get("checkpointDir"):
            return None, None, 0, None, None
        import hashlib
        from cycloneml_tpu_torch.util.checkpoint import TrainingCheckpointer
        ck = TrainingCheckpointer(self.get("checkpointDir"))
        ck_fp = hashlib.sha1(repr((
            rank, n_users, n_items, len(ratings),
            float(np.sum(ratings)), self.get("implicitPrefs"),
            self.get("regParam"), self.get("alpha"),
            self.get("nonnegative"), self.get("seed"),
        )).encode()).hexdigest()[:16]
        latest = ck.latest_step()
        if latest is None:
            return ck, ck_fp, 0, None, None
        saved_fp = ck.metadata(latest).get("fingerprint")
        if saved_fp != ck_fp:
            raise ValueError(
                f"checkpoint dir {ck.directory!r} holds factors for "
                f"a DIFFERENT ALS run (fingerprint {saved_fp} != "
                f"{ck_fp}); clear the directory or use a new one")
        saved = ck.restore(latest)
        start = int(saved["iteration"])
        if start > self.get("maxIter"):
            # equal is fine: the checkpoint is the requested model
            raise ValueError(
                f"checkpoint is at iteration {start} but "
                f"maxIter={self.get('maxIter')}; returning it as-is "
                "would be an over-trained model — raise maxIter or "
                "clear the checkpoint directory")
        logger.info("ALS resuming from checkpoint iteration %d", start)
        return ck, ck_fp, start, saved["u_fac"], saved["i_fac"]

    def _train(self, users, items, ratings, n_users: int, n_items: int,
               rank: int, ctx) -> Tuple[np.ndarray, np.ndarray]:
        """Users then items, ``maxIter`` times, on the context's device;
        returns both factor matrices as float64 numpy (one readback)."""
        from cycloneml_tpu_torch.conf import USE_PALLAS_KERNELS
        conf = getattr(ctx, "conf", None)
        dtype = compute_dtype(conf)
        dev = ctx.device
        implicit = bool(self.get("implicitPrefs"))
        alpha = float(self.get("alpha")) if implicit else 0.0
        reg = float(self.get("regParam"))
        nonneg = bool(self.get("nonnegative"))
        budget = int(self.get("aggregationChunkBytes"))
        plain = conf is not None and \
            str(conf.get(USE_PALLAS_KERNELS)).lower() == "false"

        ord_u, ord_i = build_orders(users, items, ratings, n_users, n_items,
                                    dtype, dev)
        rng = np.random.RandomState(self.get("seed"))
        u0 = np.abs(rng.normal(size=(n_users, rank))) / np.sqrt(rank)
        i0 = np.abs(rng.normal(size=(n_items, rank))) / np.sqrt(rank)
        ck, ck_fp, start, saved_u, saved_i = self._checkpoint_setup(
            rank, n_users, n_items, ratings)
        if saved_u is not None:
            u0, i0 = saved_u, saved_i
        u_fac = torch.from_numpy(np.asarray(u0)).to(dtype).to(dev)
        i_fac = torch.from_numpy(np.asarray(i0)).to(dtype).to(dev)
        interval = self.get("checkpointInterval")
        max_iter = self.get("maxIter")

        def half_step(src, order):
            yty = gram(src) if implicit else None
            a, b, _ = normal_equations(src, order, implicit, alpha, reg,
                                       yty, budget, plain)
            return solve(a, b, nonneg)

        with _tf32_off():
            for it in range(start, max_iter):
                u_fac = half_step(i_fac, ord_u)
                i_fac = half_step(u_fac, ord_i)
                if ck is not None and (it + 1) % interval == 0 \
                        and it + 1 < max_iter:
                    ck.save(it + 1, {"u_fac": u_fac, "i_fac": i_fac,
                                     "iteration": it + 1},
                            metadata={"fingerprint": ck_fp})
        both = torch.cat([u_fac.reshape(-1), i_fac.reshape(-1)]) \
            .to("cpu", torch.float64).numpy()
        split = n_users * rank
        return (both[:split].reshape(n_users, rank),
                both[split:].reshape(n_items, rank))


class ALSModel(Model, _ALSParams, MLWritable, MLReadable):
    def __init__(self, user_ids: Optional[np.ndarray] = None,
                 item_ids: Optional[np.ndarray] = None,
                 user_factors: Optional[np.ndarray] = None,
                 item_factors: Optional[np.ndarray] = None, uid=None):
        super().__init__(uid)
        self._declare_als_params()
        self.user_ids = user_ids
        self.item_ids = item_ids
        self.user_factors = user_factors
        self.item_factors = item_factors

    @property
    def rank(self) -> int:
        return self.user_factors.shape[1]

    def _lookup(self, raw_ids: np.ndarray, ids: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(ids, raw_ids)
        pos = np.clip(pos, 0, len(ids) - 1)
        ok = ids[pos] == raw_ids
        return np.where(ok, pos, -1)

    def _transform(self, frame: MLFrame) -> MLFrame:
        users = np.asarray(frame[self.get("userCol")]).astype(np.int64)
        items = np.asarray(frame[self.get("itemCol")]).astype(np.int64)
        up = self._lookup(users, self.user_ids)
        ip = self._lookup(items, self.item_ids)
        known = (up >= 0) & (ip >= 0)
        pred = np.full(len(users), np.nan)
        pred[known] = np.einsum("bi,bi->b", self.user_factors[up[known]],
                                self.item_factors[ip[known]])
        out = frame.with_column(self.get("predictionCol"), pred)
        if self.get("coldStartStrategy") == "drop":
            out = out.filter_rows(~np.isnan(pred))
        return out

    def recommend_for_all_users(self, num_items: int) -> MLFrame:
        """Top-N items per user by one product of the factor matrices (the
        reference's, on the host)."""
        from cycloneml_tpu_torch.context import CycloneContext
        scores = self.user_factors @ self.item_factors.T
        top = np.argsort(-scores, axis=1)[:, :num_items]
        return MLFrame(CycloneContext.get_or_create(), {
            "user": np.repeat(self.user_ids, num_items),
            "item": self.item_ids[top.ravel()],
            "rating": np.take_along_axis(scores, top, axis=1).ravel()})

    def recommend_for_all_items(self, num_users: int) -> MLFrame:
        from cycloneml_tpu_torch.context import CycloneContext
        scores = self.item_factors @ self.user_factors.T
        top = np.argsort(-scores, axis=1)[:, :num_users]
        return MLFrame(CycloneContext.get_or_create(), {
            "item": np.repeat(self.item_ids, num_users),
            "user": self.user_ids[top.ravel()],
            "rating": np.take_along_axis(scores, top, axis=1).ravel()})

    def _save_data(self, path: str) -> None:
        save_arrays(path, user_ids=self.user_ids, item_ids=self.item_ids,
                    user_factors=self.user_factors,
                    item_factors=self.item_factors)

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self.user_ids = arrs["user_ids"]
        self.item_ids = arrs["item_ids"]
        self.user_factors = arrs["user_factors"]
        self.item_factors = arrs["item_factors"]
