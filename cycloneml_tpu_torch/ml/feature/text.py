"""Text feature transformers — the port's counterpart of
``cycloneml_tpu/ml/feature/text.py``, host Python and numpy as there.

Parity with ref ml/feature: Tokenizer.scala, RegexTokenizer.scala,
StopWordsRemover.scala, NGram.scala, HashingTF.scala, IDF.scala,
CountVectorizer.scala, FeatureHasher.scala. Text columns are object arrays of
python lists/strings; term-frequency outputs are dense (n, numFeatures) —
sparse rows densify at the frame boundary by design (SURVEY §7 sparse note).
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from cycloneml_tpu_torch.ml.base import Estimator, Model, Transformer
from cycloneml_tpu_torch.ml.feature.scalers import _InOutCol
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays

# the reference's default english stop words (ref StopWordsRemover loads
# from its resource file; this is the standard english list)
ENGLISH_STOP_WORDS = frozenset("""a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could couldn't did didn't do does
doesn't doing don't down during each few for from further had hadn't has hasn't have haven't having he
he'd he'll he's her here here's hers herself him himself his how how's i i'd i'll i'm i've if in into
is isn't it it's its itself let's me more most mustn't my myself no nor not of off on once only or
other ought our ours ourselves out over own same shan't she she'd she'll she's should shouldn't so
some such than that that's the their theirs them themselves then there there's these they they'd
they'll they're they've this those through to too under until up very was wasn't we we'd we'll we're
we've were weren't what what's when when's where where's which while who who's whom why why's with
won't would wouldn't you you'd you'll you're you've your yours yourself yourselves""".split())


def _hash_token(token: str, num_features: int) -> int:
    """Deterministic non-cryptographic hash (murmur-style mixing of utf-8
    bytes; the reference uses murmur3_32 — deterministic across runs is the
    contract that matters)."""
    h = 0
    for b in token.encode("utf-8"):
        h = (h * 31 + b) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    return h % num_features


class Tokenizer(Transformer, _InOutCol, MLWritable, MLReadable):
    """Lowercase whitespace tokenizer (ref Tokenizer.scala)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(in_default="text", out_default="tokens")
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        col = frame[self.get("inputCol")]
        toks = np.empty(len(col), dtype=object)
        for i, s in enumerate(col):
            toks[i] = str(s).lower().split()
        return frame.with_column(self.get("outputCol"), toks)


class RegexTokenizer(Transformer, _InOutCol, MLWritable, MLReadable):
    """Regex tokenizer (ref RegexTokenizer.scala): pattern is the split
    regex when gaps=True (default), else the match regex."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(in_default="text", out_default="tokens")
        self.pattern = self._param("pattern", "regex pattern", default=r"\s+")
        self.gaps = self._param("gaps", "pattern matches gaps vs tokens",
                                default=True)
        self.minTokenLength = self._param("minTokenLength",
                                          "minimum token length", V.gt_eq(0),
                                          default=1)
        self.toLowercase = self._param("toLowercase", "lowercase first",
                                       default=True)
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        pat = re.compile(self.get("pattern"))
        gaps = self.get("gaps")
        min_len = self.get("minTokenLength")
        lower = self.get("toLowercase")
        col = frame[self.get("inputCol")]
        toks = np.empty(len(col), dtype=object)
        for i, s in enumerate(col):
            s = str(s).lower() if lower else str(s)
            parts = pat.split(s) if gaps else pat.findall(s)
            toks[i] = [t for t in parts if len(t) >= min_len]
        return frame.with_column(self.get("outputCol"), toks)


class StopWordsRemover(Transformer, _InOutCol, MLWritable, MLReadable):
    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(in_default="tokens", out_default="filtered")
        self.stopWords = self._param("stopWords", "words to remove",
                                     default=sorted(ENGLISH_STOP_WORDS))
        self.caseSensitive = self._param("caseSensitive", "case sensitive match",
                                         default=False)
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        cs = self.get("caseSensitive")
        stops = set(self.get("stopWords")) if cs else \
            {w.lower() for w in self.get("stopWords")}
        col = frame[self.get("inputCol")]
        out = np.empty(len(col), dtype=object)
        for i, toks in enumerate(col):
            out[i] = [t for t in toks
                      if (t if cs else t.lower()) not in stops]
        return frame.with_column(self.get("outputCol"), out)


class NGram(Transformer, _InOutCol, MLWritable, MLReadable):
    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(in_default="tokens", out_default="ngrams")
        self.n = self._param("n", "ngram length (> 0)", V.gt(0), default=2)
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        n = self.get("n")
        col = frame[self.get("inputCol")]
        out = np.empty(len(col), dtype=object)
        for i, toks in enumerate(col):
            out[i] = [" ".join(toks[j:j + n]) for j in range(len(toks) - n + 1)]
        return frame.with_column(self.get("outputCol"), out)


class HashingTF(Transformer, _InOutCol, MLWritable, MLReadable):
    """Hashed term frequencies (ref HashingTF.scala)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(in_default="tokens", out_default="tf")
        # the reference defaults to 2^18 with SPARSE output; ours is dense,
        # so the default is 2^10 — set numFeatures explicitly for big vocabs
        self.numFeatures = self._param("numFeatures", "hash buckets (> 0)",
                                       V.gt(0), default=1 << 10)
        self.binary = self._param("binary", "binary term counts", default=False)
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        nf = self.get("numFeatures")
        binary = self.get("binary")
        col = frame[self.get("inputCol")]
        out = np.zeros((len(col), nf))
        for i, toks in enumerate(col):
            for t in toks:
                j = _hash_token(str(t), nf)
                if binary:
                    out[i, j] = 1.0
                else:
                    out[i, j] += 1.0
        return frame.with_column(self.get("outputCol"), out)


class IDF(Estimator, _InOutCol, MLWritable, MLReadable):
    """Inverse document frequency (ref IDF.scala): idf = log((m+1)/(df+1))."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(in_default="tf", out_default="tfidf")
        self.minDocFreq = self._param("minDocFreq", "minimum document frequency",
                                      V.gt_eq(0), default=0)
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "IDFModel":
        x = self._in(frame)
        m = x.shape[0]
        df = (x > 0).sum(axis=0).astype(np.float64)
        idf = np.log((m + 1.0) / (df + 1.0))
        idf[df < self.get("minDocFreq")] = 0.0
        model = IDFModel(idf, df, m, uid=self.uid)
        self._copy_values(model)
        return model._set_parent(self)


class IDFModel(Model, _InOutCol, MLWritable, MLReadable):
    def __init__(self, idf=None, doc_freq=None, num_docs=0, uid=None):
        super().__init__(uid)
        self._p_in_out(in_default="tf", out_default="tfidf")
        self.minDocFreq = self._param("minDocFreq", "minimum document frequency",
                                      default=0)
        self.idf = np.asarray(idf) if idf is not None else None
        self.doc_freq = np.asarray(doc_freq) if doc_freq is not None else None
        self.num_docs = num_docs

    def _transform(self, frame):
        return frame.with_column(self.get("outputCol"),
                                 self._in(frame) * self.idf[None, :])

    def _save_data(self, path):
        save_arrays(path, idf=self.idf, df=self.doc_freq,
                    nd=np.array(self.num_docs))

    def _load_data(self, path, meta):
        a = load_arrays(path)
        self.idf, self.doc_freq, self.num_docs = a["idf"], a["df"], int(a["nd"])


class CountVectorizer(Estimator, _InOutCol, MLWritable, MLReadable):
    """Vocabulary-based term counts (ref CountVectorizer.scala): vocab ordered
    by descending corpus frequency, capped at vocabSize, filtered by minDF."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(in_default="tokens", out_default="counts")
        self.vocabSize = self._param("vocabSize", "max vocabulary size (> 0)",
                                     V.gt(0), default=1 << 18)
        self.minDF = self._param("minDF", "min documents a term appears in",
                                 V.gt_eq(0.0), default=1.0)
        self.minTF = self._param("minTF", "min in-document frequency",
                                 V.gt_eq(0.0), default=1.0)
        self.binary = self._param("binary", "binary counts", default=False)
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "CountVectorizerModel":
        col = frame[self.get("inputCol")]
        n_docs = len(col)
        min_df = self.get("minDF")
        if min_df < 1.0:
            min_df = min_df * n_docs
        df: dict = {}
        tf: dict = {}
        for toks in col:
            seen = set()
            for t in toks:
                t = str(t)
                tf[t] = tf.get(t, 0) + 1
                if t not in seen:
                    seen.add(t)
                    df[t] = df.get(t, 0) + 1
        terms = [t for t in tf if df[t] >= min_df]
        terms.sort(key=lambda t: (-tf[t], t))
        vocab = terms[: self.get("vocabSize")]
        m = CountVectorizerModel(vocab, uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class CountVectorizerModel(Model, _InOutCol, MLWritable, MLReadable):
    def __init__(self, vocabulary: Optional[List[str]] = None, uid=None):
        super().__init__(uid)
        self._p_in_out(in_default="tokens", out_default="counts")
        self.vocabSize = self._param("vocabSize", "max vocabulary size",
                                     default=1 << 18)
        self.minDF = self._param("minDF", "min document frequency", default=1.0)
        self.minTF = self._param("minTF", "min in-document term frequency",
                                 default=1.0)
        self.binary = self._param("binary", "binary counts", default=False)
        self.vocabulary = list(vocabulary or [])
        self._index = {t: i for i, t in enumerate(self.vocabulary)}

    def _transform(self, frame):
        col = frame[self.get("inputCol")]
        out = np.zeros((len(col), len(self.vocabulary)))
        min_tf = self.get("minTF")
        binary = self.get("binary")
        for i, toks in enumerate(col):
            counts: dict = {}
            for t in toks:
                j = self._index.get(str(t))
                if j is not None:
                    counts[j] = counts.get(j, 0) + 1
            thresh = min_tf if min_tf >= 1.0 else min_tf * len(toks)
            for j, c in counts.items():
                if c >= thresh:
                    out[i, j] = 1.0 if binary else c
        return frame.with_column(self.get("outputCol"), out)

    def _save_data(self, path):
        import json
        import os
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocabulary.json"), "w") as fh:
            json.dump(list(self.vocabulary), fh)

    def _load_data(self, path, meta):
        import json
        import os
        with open(os.path.join(path, "vocabulary.json")) as fh:
            self.vocabulary = json.load(fh)
        self._index = {t: i for i, t in enumerate(self.vocabulary)}


class FeatureHasher(Transformer, MLWritable, MLReadable):
    """Hash arbitrary columns into one feature vector (ref FeatureHasher.scala):
    numeric columns hash their NAME with the value as weight; string columns
    hash name=value with weight 1."""

    def __init__(self, uid=None, input_cols=None, **kw):
        super().__init__(uid)
        self.inputCols = self._param("inputCols", "columns to hash")
        self.outputCol = self._param("outputCol", "output column",
                                     default="features")
        self.numFeatures = self._param("numFeatures", "hash buckets (> 0)",
                                       V.gt(0), default=1 << 10)  # dense output
        if input_cols is not None:
            self.set("inputCols", list(input_cols))
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        nf = self.get("numFeatures")
        cols = self.get("inputCols")
        out = np.zeros((frame.n_rows, nf))
        for c in cols:
            col = frame[c]
            numeric = np.issubdtype(np.asarray(col).dtype, np.number)
            if numeric:
                j = _hash_token(c, nf)
                out[:, j] += np.asarray(col, dtype=np.float64)
            else:
                for i, v in enumerate(col):
                    out[i, _hash_token(f"{c}={v}", nf)] += 1.0
        return frame.with_column(self.get("outputCol"), out)
